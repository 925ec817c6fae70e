"""The multifrontal slice as a whole on the CPU: ``SupernodalLuFactorization``,
``factorize``'s chain falling through from band, ``solve_refined`` matched and
unmatched, the GMRES-IR escalation, the transpose solve and condition
estimate, against respatpu's result (one small matrix through its CPU JAX
path), scipy's ``spsolve`` and the host oracle. Sizes follow
``tests/test_frontal.py``'s shapes, cut down."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from respatpu import solve as jsolve
from respatpu.bench.synth import circuit_like, laplacian_2d, mesh_fem_3d

from respatpu_torch import analysis, cli, solve
from respatpu_torch.bench import runner
from respatpu_torch.interop import csr_from_respatpu
from respatpu_torch.io import write_mtx
from respatpu_torch.kernels import bandlu, snlu_device
from respatpu_torch.kernels import spmv as spmv_kernels

# (name, matrix, matching as factorize's "auto" decides it)
CASES = {
    "fem": (lambda: mesh_fem_3d(420, avg_degree=10.0, seed=3), False),
    "circuit_dominant": (lambda: circuit_like(500, 5, seed=4, diag="dominant"), True),
    "circuit_weak_matched": (lambda: circuit_like(500, 5, seed=4), True),
}


def _scipy(a):
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)


@pytest.fixture(scope="module")
def systems():
    out = {}
    for name, (make, matched) in CASES.items():
        a = csr_from_respatpu(make())
        b, x_true = solve.make_rhs_for_known_x(a)
        out[name] = (a, b, x_true, matched)
    return out


@pytest.mark.parametrize("policy", ["fp32", "fp32_ftz", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_refined_solve_reaches_the_reference_gate(systems, name, policy):
    """fp32 pool + fp64 refinement to a host-oracle residual <= 1e-10 on the
    FEM, dominant-circuit and matched weak-diagonal circuit cases; the
    solution is scipy's."""
    a, b, x_true, matched = systems[name]
    fac = solve.factorize(a, policy, method="snlu", device="cpu")
    assert fac.matched == matched and fac.report.notes.startswith("method=snlu")
    assert ("matching+ruiz" in fac.report.notes) == matched
    assert fac.report.notes.endswith("apply=frontal_fp32")
    assert fac._frontal.pool.dtype == torch.float32
    x, rep = solve.solve_refined(a, b, fac=fac)
    assert rep.converged and rep.residual <= 1e-10 and rep.policy == f"{policy}+ir_fp64"
    ref = spla.spsolve(_scipy(a).tocsc(), b)
    assert np.abs(x - ref).max() <= 1e-8 * np.abs(ref).max()
    assert rep.t_analyze > 0 and rep.t_factorize > 0 and rep.t_solve > 0
    assert fac.report.factor_bytes == fac._plan.pool_size * 4
    assert set(fac.phases) == {"matching", "symbolic", "plan"}


@pytest.mark.parametrize("name", list(CASES))
def test_fp64_policy_factors_in_a_native_fp64_pool(systems, name):
    a, b, x_true, matched = systems[name]
    fac = solve.factorize(a, "df64", method="multifrontal", device="cpu")  # the alias of fp64
    x = fac.solve(b)
    assert fac.policy.name == "fp64" and fac._frontal.pool.dtype == torch.float64
    assert fac.report.notes.endswith("apply=frontal_fp64") and fac.report.residual <= 1e-10
    assert solve.inf_norm_error(x, x_true) <= 1e-7
    assert fac.report.factor_bytes == fac._plan.pool_size * 8


def test_weak_diagonal_circuit_without_matching_is_unstable_by_design(systems):
    """Static pivoting without the matching meets tiny pivots on a weak
    diagonal: growth is orders above the matched factorization's. Only the
    matched case is held to the residual gate."""
    a, b, _, _ = systems["circuit_weak_matched"]
    plain = solve.factorize(a, "fp32", method="snlu", matching=False, device="cpu")
    matched = solve.factorize(a, "fp32", method="snlu", matching=True, device="cpu")
    assert not plain.matched and "matching" not in plain.report.notes
    assert plain.report.pivot_growth > 10 * matched.report.pivot_growth
    assert np.isfinite(plain.solve(b)).all()


@pytest.fixture(scope="module")
def both_packages():
    """One matrix of <= 200 rows through both packages' multifrontal
    factorizations (respatpu's leaves thousands of memory mappings in the
    process, so it runs once)."""
    a = circuit_like(180, 5, seed=9, diag="dominant")
    t = csr_from_respatpu(a)
    b, _ = solve.make_rhs_for_known_x(t)
    jfac = jsolve.factorize(a, "fp32", method="snlu")
    tfac = solve.factorize(t, "fp32", method="snlu", device="cpu")
    return a, t, b, jfac, tfac


def test_factorization_matches_respatpus(both_packages):
    a, t, b, jfac, tfac = both_packages
    assert jfac.report.notes == tfac.report.notes
    assert jfac.matched and tfac.matched
    np.testing.assert_array_equal(jfac.perm, tfac.perm)
    np.testing.assert_array_equal(jfac._cperm, tfac._cperm)
    assert jfac._dr.tobytes() == tfac._dr.tobytes() and jfac._dc.tobytes() == tfac._dc.tobytes()
    assert jfac.report.n_pivot_perturbed == tfac.report.n_pivot_perturbed
    assert jfac.report.factor_bytes == tfac.report.factor_bytes
    assert tfac.report.pivot_growth == pytest.approx(jfac.report.pivot_growth, rel=1e-3)
    vj, vt = jfac.factor_values(), tfac.factor_values()
    # fp32 factors in another rounding order, times the growth of this matrix
    assert np.abs(vt - vj).max() <= 2e-5 * max(jfac.report.pivot_growth, 1.0) * np.abs(vj).max()


def test_solves_match_respatpus(both_packages):
    a, t, b, jfac, tfac = both_packages
    xj, xt = jfac.solve(b), tfac.solve(b)
    assert np.abs(xt - xj).max() <= 1e-3 * np.abs(xj).max()  # two fp32 solves
    assert tfac.report.residual < 1e-3 and jfac.report.residual < 1e-3
    rj, rt = jsolve.solve_refined(a, b, fac=jfac), solve.solve_refined(t, b, fac=tfac)
    assert rj[1].converged and rt[1].converged and rt[1].residual <= 1e-10
    assert abs(rt[1].iterations - rj[1].iterations) <= 1
    assert np.abs(rt[0] - rj[0]).max() <= 1e-8 * np.abs(rj[0]).max()
    assert rt[1].policy == "fp32+ir_fp64" and rj[1].policy == "fp32+ir_df64"
    zj, zt = jfac.solve_transpose(b), tfac.solve_transpose(b)
    assert np.abs(zt - zj).max() <= 1e-3 * np.abs(zj).max()
    cj, ct = jfac.condest(), tfac.condest()
    assert cj / 2 <= ct <= cj * 2


def test_auto_falls_through_from_band_to_snlu(systems):
    a, b, _, matched = systems["circuit_dominant"]
    fac = solve.factorize(a, "fp32", method="auto", max_band_bytes=1 << 10, device="cpu")
    assert isinstance(fac, solve.SupernodalLuFactorization)
    assert fac.report.notes.startswith("method=snlu,matching+ruiz") and fac.matched
    # band serves what fits, and takes no matching
    lap = csr_from_respatpu(laplacian_2d(9, 8))
    assert solve.factorize(lap, method="auto", device="cpu").report.notes == "method=band"
    with pytest.raises(MemoryError) as err:
        solve.factorize(a, method="auto", max_band_bytes=1 << 10, max_pool_bytes=1 << 10,
                        max_schedule_bytes=1 << 10, device="cpu")
    text = str(err.value)
    assert text.startswith("every direct method refused: band: band storage would need")
    assert "; snlu: front pool would need" in text
    assert "; sparse: scheduled-LU pair lists would need" in text
    with pytest.raises(MemoryError, match="front pool would need"):
        solve.factorize(a, method="snlu", max_pool_bytes=1 << 10, device="cpu")
    # the third step: what band and snlu refuse, the scheduled sparse LU serves
    third = solve.factorize(a, method="auto", max_band_bytes=1 << 10, max_pool_bytes=1 << 10,
                            device="cpu")
    assert isinstance(third, solve.SparseLuFactorization)
    assert third.report.notes.startswith("method=sparse")
    with pytest.raises(ValueError, match="square"):
        from respatpu_torch.formats import COOMatrix, coo_to_csr
        solve.SupernodalLuFactorization(coo_to_csr(COOMatrix(
            (2, 3), np.array([0, 1], np.int32), np.array([0, 2], np.int32), np.ones(2))),
            device="cpu")


@pytest.mark.parametrize("matching", [True, False])
def test_refinement_runs_in_the_original_system_on_the_port_kernels(systems, matching,
                                                                    monkeypatch):
    """Matched or not, a multifrontal factorization is refined in the
    original system: every residual is the fp64 CSR SpMV of the unpermuted
    matrix, every correction one ``solve_original_device``."""
    a, b, _, _ = systems["circuit_dominant"]
    fac = solve.factorize(a, "fp32", method="snlu", matching=matching, device="cpu")
    calls = {"spmv": 0, "solve": 0}
    real_spmv, real_solve = solve.spmv, fac.solve_original_device

    def counting_spmv(dev, x):
        assert dev.policy.name == "fp64" and x.dtype == torch.float64
        assert np.array_equal(dev.indices.numpy(), a.indices)  # not permuted
        calls["spmv"] += 1
        return real_spmv(dev, x)

    def counting_solve(r):
        assert r.dtype == torch.float64
        calls["solve"] += 1
        return real_solve(r)

    monkeypatch.setattr(solve, "spmv", counting_spmv)
    monkeypatch.setattr(fac, "solve_original_device", counting_solve)
    _, rep = solve.solve_refined(a, b, fac=fac)
    assert rep.converged and calls == {"spmv": rep.iterations, "solve": rep.iterations - 1}
    assert set(snlu_device.LAUNCHES.values()) == {0} and set(bandlu.LAUNCHES.values()) == {0}
    assert spmv_kernels.LAUNCHES["fp64"] == 0


def _ill_conditioned(n=150):
    """A circuit with its columns scaled over six decades, factored without
    the matching that would undo the scaling: an fp32 factorization's plain
    refinement stalls on it."""
    base = csr_from_respatpu(circuit_like(n, 5, seed=21, diag="dominant"))
    scale = np.logspace(0, -6, n)
    base.data = base.data * scale[base.indices]
    return base


def test_stalled_refinement_escalates_to_gmres_ir_on_the_device():
    a = _ill_conditioned()
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize(a, "fp32", method="snlu", matching=False, device="cpu")
    x, rep = solve.solve_refined(a, b, fac=fac, max_iters=3)
    assert "gmres_ir=" in rep.notes and rep.iterations > 3
    assert rep.residual <= 1e-10 and rep.converged
    assert np.isfinite(x).all()


@pytest.mark.parametrize("method", ["band", "snlu"])
def test_gmres_ir_matches_a_host_arnoldi(method):
    """The device-resident GMRES-IR against the same algorithm written with
    numpy on the host (respatpu's form): the same iterate to rounding."""
    a = csr_from_respatpu(laplacian_2d(9, 7))
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize(a, "fp32", method=method, device="cpu")
    x0 = np.zeros(a.nrows)
    x, inner = solve._gmres_ir(a, b, fac, x0, tol=1e-13, max_outer=2, m=6)
    dense = a.toarray()
    ref, total = x0.copy(), 0
    for _ in range(2):
        r = b - dense @ ref
        beta = np.linalg.norm(r)
        if beta / np.linalg.norm(b) <= 1e-13:
            break
        V, Z, H = np.zeros((7, a.nrows)), np.zeros((6, a.nrows)), np.zeros((7, 6))
        V[0] = r / beta
        for j in range(6):
            Z[j] = fac.solve(V[j])
            w = dense @ Z[j]
            for i in range(j + 1):
                H[i, j] = w @ V[i]
                w = w - H[i, j] * V[i]
            H[j + 1, j] = np.linalg.norm(w)
            V[j + 1] = w / H[j + 1, j]
            total += 1
        e1 = np.zeros(7)
        e1[0] = beta
        ref = ref + Z.T @ np.linalg.lstsq(H, e1, rcond=None)[0]
    assert inner == total
    assert np.abs(x - ref).max() <= 1e-9 * np.abs(ref).max()
    assert solve.relative_residual(a, x, b) <= 1e-10


def test_band_solve_original_device_unwinds_the_permutation():
    lap = csr_from_respatpu(laplacian_2d(12, 10))
    a = analysis.permute_csr(lap, np.random.default_rng(2).permutation(lap.nrows))
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize_band(a, device="cpu")
    assert not np.array_equal(fac.perm, np.arange(a.nrows))  # RCM moved rows
    x = fac.solve_original_device(torch.from_numpy(b))
    assert x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), fac.solve(b), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fem", "circuit_weak_matched"])
def test_transpose_solve_and_condest(systems, name):
    a, b, _, _ = systems[name]
    fac = solve.factorize(a, "fp64", method="snlu", device="cpu")
    dense = a.toarray()
    z = fac.solve_transpose(b)
    ref = np.linalg.solve(dense.T, b)
    assert np.abs(z - ref).max() <= 1e-8 * np.abs(ref).max()
    rcond = fac.condest()
    exact = 1.0 / np.linalg.cond(dense, 1)
    assert exact / 10 <= rcond <= exact * 10 and fac.report.rcond_est == rcond


def test_refactorize_timed_refreshes_the_pool(systems):
    a, b, _, _ = systems["fem"]
    fac = solve.factorize(a, "fp32", method="snlu", device="cpu")
    before = fac._frontal.pool.clone()
    values = fac.factor_values()
    fac._frontal.pool.zero_()
    assert fac.refactorize_timed() > 0
    assert torch.equal(fac._frontal.pool, before)
    np.testing.assert_array_equal(fac.factor_values(), values)
    assert values.shape == (fac.part.filled.nnz,) and fac.report.n_pivot_perturbed == 0
    assert fac.report.pivot_growth == pytest.approx(float(before.abs().max())
                                                    / np.abs(a.data).max())


def test_pivot_perturbation_is_counted_and_reported():
    """A zero on the diagonal that no matching is asked to move: perturbed to
    eps, counted, and refinement still recovers the solution of the
    perturbed-free system when the pivot is structurally harmless."""
    a = csr_from_respatpu(laplacian_2d(6, 6))
    a.data[a.indices == np.repeat(np.arange(36), a.row_lengths())] = 4.0
    diag0 = int(np.flatnonzero((a.indices == 0) & (np.repeat(np.arange(36), a.row_lengths()) == 0))[0])
    a.data[diag0] = 0.0
    fac = solve.factorize(a, "fp64", method="snlu", matching=False, order="natural",
                          device="cpu")
    assert fac.report.n_pivot_perturbed == 1
    assert fac._pivot_eps == pytest.approx(1e-13 * 4.0)
    fac32 = solve.factorize(a, "fp32", method="snlu", matching=False, order="natural",
                            pivot_eps=1e-3, device="cpu")
    assert fac32._pivot_eps == 1e-3 and fac32.report.n_pivot_perturbed == 1


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("snlu") / "circuit.mtx")
    write_mtx(path, csr_from_respatpu(circuit_like(300, 5, seed=4)))
    return path


@pytest.mark.parametrize("method", ["snlu"])
def test_cli_lu_method_snlu(mtx, capsys, method):
    cli.main(["lu", mtx, "--device", "cpu", "--method", method, "--refine"])
    out = capsys.readouterr().out
    assert "[method=snlu,matching+ruiz scaling" in out and "policy=fp32+ir_fp64" in out
    assert float(out.split("rel_residual=")[1].split()[0]) <= 1e-10


def test_cli_lu_matching_on_and_off(mtx, capsys):
    """``--matching on`` puts GESP matching and Ruiz scaling on the
    multifrontal LU of the circuit (the notes say so), ``--matching off``
    takes them off, and on the band LU, which takes none, the notes say it
    is unavailable; each refines to the gate."""
    for flags, note in ((["--method", "snlu", "--matching", "on"], "snlu,matching+ruiz scaling"),
                        (["--method", "snlu", "--matching", "off"], "snlu,apply="),
                        (["--matching", "on"], "band,matching=unavailable]")):
        cli.main(["lu", mtx, "--device", "cpu", "--refine"] + flags)
        out = capsys.readouterr().out
        assert f"[method={note}" in out and float(out.split("rel_residual=")[1].split()[0]) <= 1e-10


def test_sweep_lu_serves_the_circuit_row_by_snlu(tmp_path):
    rows = runner.sweep_lu(["dc1"], csv_path=str(tmp_path / "lu.csv"), max_synth_nnz=20_000,
                           max_band_bytes=8 << 20, verbose=False, device="cpu")
    (row,) = rows
    assert row["status"] == "ok" and row["method"].startswith("method=snlu,matching+ruiz")
    assert float(row["rel_residual"]) <= 1e-10 and float(row["t_factor_warm_s"]) > 0
