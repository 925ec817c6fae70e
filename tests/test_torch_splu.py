"""The scheduled sparse LU on the CPU against respatpu on the same inputs:
the entry levels, the exact factorization (exact ILU(0) on A's pattern, the
exact LU on the filled pattern) through the plain version of K8, the
perturbed-pivot count, ``SparseLuFactorization`` with its solves, refinement
and condition estimate, the ``auto`` chain's third step,
``Ilu0Preconditioner(method="scheduled")``, the ragged memory guard, the CLI
and ``sweep_lu``. respatpu runs on its CPU JAX path. The kernel itself is held
to the plain version on a card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 factors within 1e-5 of the largest value (the two packages
sum each entry's pairs in other orders); fp64 against respatpu's double-float
within 1e-12; both against the host fp64 oracle (dense LU without pivoting,
or ILU(0) by IKJ) within 1e-5 (fp32), 1e-12 (fp64) and 2^-6 (bf16)."""
import jax
import numpy as np
import pytest
import torch

from respatpu import analysis as janalysis
from respatpu import solve as jsolve
from respatpu.bench.synth import circuit_like, laplacian_2d, powerlaw, random_banded
from respatpu.formats import COOMatrix as JCOO
from respatpu.formats import coo_to_csr as jcoo_to_csr
from respatpu.kernels import splu as jsplu
from respatpu.precision import df_from_f64, df_to_f64

from respatpu_torch import analysis, cli, solve
from respatpu_torch.bench import runner
from respatpu_torch.formats import CSRMatrix
from respatpu_torch.interop import csr_from_respatpu, splu_plan_from_respatpu
from respatpu_torch.io import write_mtx
from respatpu_torch.kernels import splu as SP
from respatpu_torch.kernels.ilu0 import ilu0_host_reference
from respatpu_torch.precision import FP32_MIN_NORMAL


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _dense_lu(a):
    lu = a.toarray().astype(np.float64)
    for k in range(lu.shape[0]):
        lu[k + 1:, k] /= lu[k, k]
        lu[k + 1:, k + 1:] -= np.outer(lu[k + 1:, k], lu[k, k + 1:])
    return lu


def _on_pattern(f, dense):
    rows = np.repeat(np.arange(f.nrows), np.diff(f.indptr))
    return dense[rows, f.indices]


# (respatpu pattern F, host fp64 oracle of the factor on it): the shapes of
# tests/test_splu.py, a band's fill whose entries reach 40 pairs (the warp's
# path), and a circuit's ILU(0) with hub rows
def _ilu_banded():
    f = random_banded(150, 8, 5, seed=31)
    return f, ilu0_host_reference(csr_from_respatpu(f))


def _lu_laplacian():
    a = laplacian_2d(9, 8)
    f = janalysis.symbolic_fill_lu(a)
    return f, _on_pattern(f, _dense_lu(a))


def _lu_banded():
    a = random_banded(100, 40, 12, seed=5)
    f = janalysis.symbolic_fill_lu(a)
    return f, _on_pattern(f, _dense_lu(a))


def _ilu_circuit():
    f = circuit_like(600, 5, seed=3, diag="dominant", hub_degree=80)
    return f, ilu0_host_reference(csr_from_respatpu(f))


CASES = {"ilu0_banded": _ilu_banded, "lu_laplacian": _lu_laplacian, "lu_banded": _lu_banded,
         "ilu0_circuit": _ilu_circuit}


@pytest.mark.parametrize("case", list(CASES))
def test_entry_levels_match_respatpu(case, monkeypatch):
    f, _ = CASES[case]()
    js = janalysis.chow_patel_schedule(f)
    ts = analysis.chow_patel_schedule(csr_from_respatpu(f))
    want = jsplu._entry_levels(js)
    native = SP.entry_levels(ts)
    assert native.dtype == np.int32 and np.array_equal(native, want)
    monkeypatch.setattr(analysis, "_USE_NATIVE", False)  # the numpy fallback
    assert np.array_equal(SP.entry_levels(ts), want)
    # the plan: positions by level, short entries before long ones, every
    # dependency in an earlier level, tasks covering every position once:
    # up to TASK_ENTRIES short entries of one level, or a run of one level's
    # long entries cut where their pairs pass a multiple of long_pairs
    for long_pairs in (1, 100, SP.LONG_PAIRS):
        plan = SP._plan_cut(f.nrows, ts, long_pairs)
        lev = plan.levels[plan.perm]
        assert np.all(np.diff(lev) >= 0) and plan.level_ptr[-1] == f.nnz
        lens = np.diff(ts.ptr)[plan.perm]
        for v in range(plan.nlevels):
            q = slice(plan.level_ptr[v], plan.level_ptr[v + 1])
            assert np.all(np.diff((lens[q] > SP.SHORT).astype(int)) >= 0)
        t = plan.tasks
        covered = np.concatenate([np.arange(q0, q1) for q0, q1, _, _ in t])
        assert np.array_equal(covered, np.arange(f.nnz))
        assert np.all(lev[t[:, 0]] == t[:, 2]) and np.all(lev[t[:, 1] - 1] == t[:, 2])
        short = t[:, 3] == t[:, 2]
        assert np.all(short | (t[:, 3] == -1))
        assert np.all(t[short, 1] - t[short, 0] <= SP.TASK_ENTRIES)
        # the cut: a long entry's place is the pairs of its level's long
        # entries before it // long_pairs, one place a run, a new place a new run
        place = {}
        for v in range(plan.nlevels):
            q = np.arange(plan.level_ptr[v], plan.level_ptr[v + 1])
            q = q[lens[q] > SP.SHORT]
            place.update(zip(q.tolist(), ((np.cumsum(lens[q]) - lens[q]) // long_pairs).tolist()))
        last = None
        for q0, q1, v, w in t:
            assert np.all((lens[q0:q1] > SP.SHORT) == (w == -1))
            if w == -1:
                assert len({place[q] for q in range(q0, q1)}) == 1
                assert last is None or last[0] != v or last[1] != place[q0]
                last = (v, place[q0])
        if long_pairs == 1:
            assert np.all(t[~short, 1] - t[~short, 0] == 1)
    for p in range(f.nnz):
        deps = np.r_[ts.pairs_a[ts.ptr[p]:ts.ptr[p + 1]], ts.pairs_b[ts.ptr[p]:ts.ptr[p + 1]]]
        if ts.is_lower[p] and ts.diag_pos_col[p] >= 0:
            deps = np.r_[deps, ts.diag_pos_col[p]]
        assert np.all(plan.levels[deps] < plan.levels[p])
    if case == "lu_banded":
        assert (np.diff(ts.ptr) > SP.SHORT).any()  # the warp's path is reached
        assert (t[:, 1] - t[:, 0] > 1)[t[:, 3] == -1].any()  # and a run of several


@pytest.mark.parametrize("policy", ["fp32", "fp64", "bf16"])
def test_scheduled_factor_matches_respatpu(policy):
    for case, make in CASES.items():
        f, oracle = make()
        jplan = jsplu.build_scheduled_lu(f)
        tplan = splu_plan_from_respatpu(jplan)
        t, _ = SP.scheduled_lu_factor(csr_from_respatpu(f), plan=tplan, policy=policy,
                                      device="cpu")
        got = t.values.double().numpy()
        if policy == "fp64":
            j, _ = jsplu.scheduled_lu_factor(f, plan=jplan, policy="df64")
            assert _rel(got, df_to_f64(j.values)) <= 1e-12, case
            assert _rel(got, oracle) <= 1e-12, case
        elif policy == "fp32":
            j, _ = jsplu.scheduled_lu_factor(f, plan=jplan, policy="fp32")
            assert _rel(got, np.asarray(j.values)) <= 1e-5, case
            assert t.n_pivot_perturbed == int(j.n_pivot_perturbed) == 0, case
            assert _rel(got, oracle) <= 1e-5, case
        else:  # bf16 values, sums in fp32: the oracle within a few bf16 steps
            assert _rel(got, oracle) <= 2.0 ** -6, case
        # the port's own plan factors to the same bits as the converted one
        own, _ = SP.scheduled_lu_factor(csr_from_respatpu(f), policy=policy, device="cpu")
        assert torch.equal(own.values, t.values), case


def _with_planted_pivots():
    """A 5 x 5 arrow and one more row: u_00 = 0 (column 0 has L entries: a
    perturbed pivot used by them) and a last diagonal of 1e-20 that no L
    entry divides by."""
    rows = np.r_[np.arange(6), np.arange(1, 5), np.zeros(4, int)]
    cols = np.r_[np.arange(6), np.zeros(4, int), np.arange(1, 5)]
    vals = np.r_[[0.0, 4.0, 4.0, 4.0, 4.0, 1e-20], np.full(4, 1.0), np.full(4, 0.5)]
    return jcoo_to_csr(JCOO((6, 6), rows.astype(np.int32), cols.astype(np.int32), vals))


def test_perturbed_pivots_and_d3():
    """fp32: both packages count a clamp once per diagonal position, where
    an L entry divided by it. fp64: the port keeps that rule; respatpu's
    df64 path counts every small diagonal after the fact (D3), so the last
    row's unused 1e-20 counts there only. eps = 2^-10 is exact in fp32, in
    which respatpu's df64 path holds it."""
    ja = _with_planted_pivots()
    a = csr_from_respatpu(ja)
    eps = 2.0 ** -10
    j32, _ = jsplu.scheduled_lu_factor(ja, policy="fp32", pivot_eps=eps)
    t32, _ = SP.scheduled_lu_factor(a, policy="fp32", pivot_eps=eps, device="cpu")
    assert t32.n_pivot_perturbed == int(j32.n_pivot_perturbed) == 1
    assert _rel(t32.values.numpy(), np.asarray(j32.values)) <= 1e-6
    j64, _ = jsplu.scheduled_lu_factor(ja, policy="df64", pivot_eps=eps)
    t64, _ = SP.scheduled_lu_factor(a, policy="fp64", pivot_eps=eps, device="cpu")
    assert int(j64.n_pivot_perturbed) == 2 and t64.n_pivot_perturbed == 1  # D3
    assert _rel(t64.values.numpy(), df_to_f64(j64.values)) <= 1e-12
    # the clamped divisor: l_i0 = a_i0 / +eps; u_00 stays as computed (0)
    rows = np.repeat(np.arange(6), np.diff(a.indptr))
    assert float(t64.values[0]) == 0.0
    assert np.array_equal(t64.values.numpy()[(a.indices == 0) & (rows > 0)], np.full(4, 1024.0))


def test_subnormal_pivot_under_ftz():
    """u_00 = 1e-39 (subnormal in fp32) with eps below it: fp32 divides by
    it, fp32_ftz flushes it to 0 and clamps to +eps, and counts it."""
    a = CSRMatrix((2, 2), np.array([0, 1, 3]), np.array([0, 0, 1], np.int32),
                        np.array([1e-39, 1e-10, 1.0]))
    r32, _ = SP.scheduled_lu_factor(a, policy="fp32", pivot_eps=1e-44, device="cpu")
    rftz, _ = SP.scheduled_lu_factor(a, policy="fp32_ftz", pivot_eps=1e-44, device="cpu")
    assert 0 < float(r32.values[0]) < FP32_MIN_NORMAL and r32.n_pivot_perturbed == 0
    assert float(rftz.values[0]) == 0.0 and rftz.n_pivot_perturbed == 1
    assert float(r32.values[1]) == pytest.approx(1e-10 / float(np.float32(1e-39)), rel=1e-6)
    assert float(rftz.values[1]) == pytest.approx(1e-10 / float(np.float32(1e-44)), rel=1e-6)


@pytest.mark.parametrize("policy", ["fp32", "fp64"])
def test_sparse_lu_factorization_matches_respatpu(policy):
    ja = powerlaw(200, 5, seed=17)
    a = csr_from_respatpu(ja)
    b, x_true = solve.make_rhs_for_known_x(a)
    jpol = "df64" if policy == "fp64" else policy
    jfac = jsolve.SparseLuFactorization(ja, policy=jpol)
    tfac = solve.SparseLuFactorization(a, policy=policy, device="cpu")
    assert np.array_equal(tfac.perm, jfac.perm)
    assert tfac._filled.nnz == jfac._filled.nnz and tfac.plan.t_max == jfac._plan.t_max
    assert tfac.report.n_pivot_perturbed == int(jfac.report.n_pivot_perturbed) == 0
    xj, xt = jfac.solve(b), tfac.solve(b)
    tol = 1e-12 if policy == "fp64" else 1e-4
    assert tfac.report.residual <= (1e-12 if policy == "fp64" else 1e-5)
    assert _rel(xt, xj) <= tol and _rel(xt, x_true) <= tol
    xr, rep = solve.solve_refined(a, b, fac=tfac, tol=1e-12)
    assert rep.converged and rep.residual <= 1e-12
    if policy == "fp32":
        _, jrep = jsolve.solve_refined(ja, b, fac=jfac, tol=1e-12)
        assert abs(rep.iterations - jrep.iterations) <= 1
        cj, ct = jfac.condest(), tfac.condest()
        assert cj / 2 <= ct <= 2 * cj
        zj, zt = jfac.solve_transpose(b), tfac.solve_transpose(b)
        assert _rel(zt, zj) <= 1e-4
        dense = a.toarray()
        assert np.linalg.norm(dense.T @ zt - b) <= 1e-4 * np.linalg.norm(b)


def test_factorize_dispatch_reaches_sparse():
    """``auto`` tries band, snlu, sparse in respatpu's order; the third step
    serves a matrix the first two refuse, in both packages."""
    n = 600
    rng = np.random.default_rng(0)
    rows = np.arange(n, dtype=np.int32)
    cols = rng.permutation(n).astype(np.int32)
    ja = jcoo_to_csr(JCOO((n, n), np.r_[rows, rows], np.r_[cols, rows],
                          np.r_[rng.standard_normal(n), np.full(n, 50.0)]))
    a = csr_from_respatpu(ja)
    fac = solve.factorize(a, "fp32", method="auto", order="natural", max_band_bytes=1 << 16,
                          max_pool_bytes=1 << 10, device="cpu")
    assert isinstance(fac, solve.SparseLuFactorization)
    assert fac.report.notes.startswith("method=sparse")
    jfac = jsolve.factorize(ja, "fp32", method="sparse")
    assert isinstance(jfac, jsolve.SparseLuFactorization)
    b, _ = solve.make_rhs_for_known_x(a)
    assert _rel(fac.solve(b), jfac.solve(b)) <= 1e-5
    served = solve.factorize(a, "fp64", method="sparse", device="cpu")
    served.solve(b)
    assert served.report.notes.startswith("method=sparse") and served.report.residual <= 1e-14


def test_ilu0_scheduled_matches_respatpu():
    """Exact ILU(0) through the scheduled LU: the factor values of both
    packages and the host oracle, the notes, the exact fp64 applies."""
    ja = circuit_like(800, 5, seed=3, diag="dominant")
    a = csr_from_respatpu(ja)
    oracle = ilu0_host_reference(a)
    r = np.random.default_rng(2).standard_normal(a.nrows)
    for policy, jpol, tol in (("fp32", "fp32", 1e-5), ("fp64", "df64", 1e-12)):
        jp = jsolve.Ilu0Preconditioner(ja, policy=jpol, method="scheduled")
        tp = solve.Ilu0Preconditioner(a, policy=policy, method="scheduled", device="cpu")
        assert tp.report.notes == jp.report.notes
        assert tp.report.notes.startswith("exact_scheduled")
        assert tp.report.n_pivot_perturbed == int(jp.report.n_pivot_perturbed) == 0
        res, _ = SP.scheduled_lu_factor(a, policy=policy, device="cpu")
        assert _rel(res.values.double().numpy(), oracle) <= tol
        if policy == "fp64":  # the exact applies: M^-1 r against respatpu's
            jz = df_to_f64(jp.apply(df_from_f64(r)))
            tz = tp.apply(torch.from_numpy(r)).numpy()
            assert _rel(tz, jz) <= 1e-12


def test_ragged_guard_admits_what_the_padded_one_refuses():
    """D4: respatpu's guard counts the pair lists padded to t_max; the
    port's counts them as it stores them (ragged). A circuit's hub rows make
    the padded lists many times the ragged ones."""
    ja = circuit_like(1500, 5, seed=4, diag="dominant", hub_degree=300, hub_fraction=2e-3)
    a = csr_from_respatpu(ja)
    jfilled = janalysis.symbolic_fill_lu(janalysis.permute_csr(
        ja, janalysis.ordering(ja, "fillauto")))
    padded = 2 * jsplu.build_scheduled_lu(jfilled).sched.pairs_a.size * 4
    sched = analysis.chow_patel_schedule(analysis.symbolic_fill_lu(
        analysis.permute_csr(a, analysis.ordering(a, "fillauto"))))
    ragged = sched.layout_bytes()["ragged"]
    assert padded == sched.layout_bytes()["padded"] and padded > 2 * ragged
    cap = (padded + ragged) // 2
    with pytest.raises(MemoryError, match="pair lists would need"):
        jsolve.SparseLuFactorization(ja, policy="fp32", max_schedule_bytes=cap)
    fac = solve.SparseLuFactorization(a, "fp32", max_schedule_bytes=cap, device="cpu")
    fac.solve(solve.make_rhs_for_known_x(a)[0])
    assert fac.report.residual <= 1e-5
    with pytest.raises(MemoryError, match="ragged"):
        solve.SparseLuFactorization(a, "fp32", max_schedule_bytes=ragged - 1, device="cpu")


def test_cli_and_sweep_lu_serve_the_scheduled_lu(tmp_path, capsys):
    mtx = str(tmp_path / "pl.mtx")
    write_mtx(mtx, csr_from_respatpu(powerlaw(300, 5, seed=5)))
    cli.main(["lu", mtx, "--device", "cpu", "--method", "sparse"])
    out = capsys.readouterr().out
    assert "[method=sparse" in out and float(out.split("rel_residual=")[1].split()[0]) < 1e-10
    row, = runner.sweep_lu(["2cubes_sphere"], max_synth_nnz=6000, method="sparse",
                           verbose=False, device="cpu")
    assert row["status"] == "ok" and row["method"] == "method=sparse"
    assert float(row["rel_residual"]) < 1e-10 and float(row["t_factor_warm_s"]) > 0
