"""The direct-solve slice end to end on the CPU: ``factorize`` ->
``BandLuFactorization`` -> ``solve_refined`` of the port against respatpu's
on the same matrices, the auto chain's refusals, the sweep and the CLI. The
chain's second method has its own file, tests/test_torch_snlu.py."""
import csv

import numpy as np
import pytest
import torch

import respatpu.analysis as janalysis
import respatpu.bench.runner as jrunner
from respatpu import solve as jsolve
from respatpu.bench.synth import laplacian_2d, random_banded
from respatpu.formats import COOMatrix as JCOO
from respatpu.formats import coo_to_csr as jcoo_to_csr

from respatpu_torch import analysis, cli, solve
from respatpu_torch.bench import runner
from respatpu_torch.interop import csr_from_respatpu
from respatpu_torch.io import write_mtx
from respatpu_torch.kernels import bandlu
from respatpu_torch.kernels import spmv as spmv_kernels

from test_torch_slice import _respatpu_header


@pytest.fixture(autouse=True)
def same_ordering(monkeypatch):
    """Both packages order with their Python breadth-first search (see
    tests/test_torch_analysis.py), so both factor the same permuted matrix."""
    monkeypatch.setattr(janalysis, "_USE_NATIVE", False)
    monkeypatch.setattr(analysis, "_USE_NATIVE", False)


def test_fp32_factor_then_refined_matches_respatpu():
    a = laplacian_2d(20, 15)
    t = csr_from_respatpu(a)
    b, x_true = solve.make_rhs_for_known_x(t)
    jfac = jsolve.factorize_band(a, policy="fp32")
    tfac = solve.factorize_band(t, policy="fp32", device="cpu")
    np.testing.assert_array_equal(jfac.perm, tfac.perm)
    xj1, xt1 = jfac.solve(b), tfac.solve(b)
    assert tfac.report.residual < 1e-4 and jfac.report.residual < 1e-4
    assert np.abs(xt1 - xj1).max() <= 1e-4 * np.abs(xj1).max()  # fp32 solves, another order
    xj, rj = jsolve.solve_refined(a, b, fac=jfac, tol=1e-12)
    xt, rt = solve.solve_refined(t, b, fac=tfac, tol=1e-12)
    assert rj.converged and rt.converged
    assert rt.residual < 1e-10 and rj.residual < 1e-10
    assert abs(rt.iterations - rj.iterations) <= 1 and rt.iterations <= 15
    assert np.abs(xt - xj).max() <= 1e-9  # both at reference accuracy
    assert solve.inf_norm_error(xt, x_true) < 1e-8
    assert rt.policy == "fp32+ir_fp64" and rj.policy == "fp32+ir_df64"
    assert rt.n_pivot_perturbed == rj.n_pivot_perturbed == 0
    assert rt.t_analyze > 0 and rt.t_factorize > 0 and rt.t_solve > 0
    # the port's report carries what respatpu's does
    assert tfac.report.factor_bytes == tfac._lu.data.numel() * 4 == jfac.report.factor_bytes
    assert tfac.report.pivot_growth == pytest.approx(jfac.report.pivot_growth, rel=1e-5)


def test_fp64_direct():
    a = csr_from_respatpu(random_banded(180, 7, 5, seed=9))
    b, x_true = solve.make_rhs_for_known_x(a)
    fac = solve.factorize_band(a, policy="df64", device="cpu")  # the alias of fp64
    x = fac.solve(b)
    assert fac.policy.name == "fp64" and fac.report.residual < 1e-12
    assert solve.inf_norm_error(x, x_true) < 1e-8


def test_bf16_with_refinement():
    a = csr_from_respatpu(laplacian_2d(12, 12))
    b, _ = solve.make_rhs_for_known_x(a)
    _, rep = solve.solve_refined(a, b, policy="bf16", tol=1e-12, max_iters=60, device="cpu")
    assert rep.residual < 1e-8, rep
    assert rep.policy == "bf16+ir_fp64"


def test_fp32_ftz_with_subnormal_entries():
    """A subnormal matrix entry and right-hand-side entry: flushed, and the
    refined solution is that of the matrix with zeros in their place."""
    a = csr_from_respatpu(random_banded(120, 6, 4, seed=3))
    off = int(np.flatnonzero(a.indices != np.repeat(np.arange(120), a.row_lengths()))[0])
    a.data[off] = 1e-41
    b, _ = solve.make_rhs_for_known_x(a)
    b[11] = 1e-42
    x, rep = solve.solve_refined(a, b, policy="fp32_ftz", device="cpu")
    assert rep.converged and rep.residual < 1e-10 and rep.policy == "fp32_ftz+ir_fp64"
    ref = np.linalg.solve(a.toarray(), b)
    assert np.abs(x - ref).max() <= 1e-9 * np.abs(ref).max()


def _scrambled(n=3000):
    rng = np.random.default_rng(0)
    rows = np.arange(n, dtype=np.int32)
    cols = rng.permutation(n).astype(np.int32)
    return jcoo_to_csr(JCOO((n, n), np.concatenate([rows, rows]), np.concatenate([cols, rows]),
                            np.concatenate([rng.standard_normal(n), np.full(n, 10.0)])))


def test_band_memory_guard():
    a = _scrambled()
    with pytest.raises(MemoryError) as jerr:
        jsolve.factorize_band(a, policy="fp32", order="natural", max_band_bytes=1 << 20)
    with pytest.raises(MemoryError) as terr:
        solve.factorize_band(csr_from_respatpu(a), policy="fp32", order="natural",
                             max_band_bytes=1 << 20, device="cpu")
    assert str(terr.value) == str(jerr.value)  # the same need, the same bandwidths
    with pytest.raises(ValueError):
        solve.factorize_band(csr_from_respatpu(a), order="amd", device="cpu")


def test_factorize_auto_chain(monkeypatch):
    a = csr_from_respatpu(laplacian_2d(10, 9))
    fac = solve.factorize(a, "fp32", method="auto", device="cpu")
    assert isinstance(fac, solve.BandLuFactorization) and fac.report.notes == "method=band"
    assert solve.factorize(a, method="band", device="cpu").report.notes == "method=band"
    forced = solve.factorize(a, method="auto", matching=True, device="cpu")
    assert forced.report.notes == "method=band,matching=unavailable"
    # the multifrontal analysis goes through the native host library again
    monkeypatch.setattr(analysis, "_USE_NATIVE", True)
    with pytest.raises(MemoryError) as err:
        solve.factorize(csr_from_respatpu(_scrambled()), method="auto", order="natural",
                        max_band_bytes=1 << 20, max_pool_bytes=1 << 10,
                        max_schedule_bytes=1 << 10, device="cpu")
    text = str(err.value)
    assert text.startswith("every direct method refused: band: band storage would need")
    assert "; snlu: front pool would need" in text
    assert "; sparse: scheduled-LU pair lists would need" in text
    # the third step of the chain serves what band and snlu refuse
    third = solve.factorize(csr_from_respatpu(_scrambled()), method="auto", order="natural",
                            max_band_bytes=1 << 20, max_pool_bytes=1 << 10, device="cpu")
    assert isinstance(third, solve.SparseLuFactorization)
    assert third.report.notes.startswith("method=sparse")
    for method in ("snlu", "multifrontal"):
        served = solve.factorize(a, method=method, device="cpu")
        assert isinstance(served, solve.SupernodalLuFactorization)
        assert served.report.notes == "method=snlu,apply=frontal_fp32"
    served = solve.factorize(a, method="sparse", device="cpu")
    assert isinstance(served, solve.SparseLuFactorization)
    assert served.report.notes == "method=sparse"
    with pytest.raises(ValueError):
        solve.factorize(a, method="cholesky", device="cpu")
    # an error that is not about memory passes through the chain unchanged
    with pytest.raises(ValueError, match="square"):
        solve.factorize(csr_from_respatpu(jcoo_to_csr(JCOO(
            (3, 4), np.array([0, 1, 2], np.int32), np.array([0, 1, 3], np.int32), np.ones(3)))),
            method="auto", device="cpu")


@pytest.mark.parametrize("exc", [MemoryError("x"), torch.cuda.OutOfMemoryError("CUDA out of memory"),
                                 RuntimeError("RESOURCE_EXHAUSTED: Out of memory")])
def test_memlike_errors_become_the_refusal(exc, monkeypatch):
    def boom(self, *args, **kw):
        raise exc
    monkeypatch.setattr(solve.BandLuFactorization, "__init__", boom)
    monkeypatch.setattr(solve.SupernodalLuFactorization, "__init__", boom)
    monkeypatch.setattr(solve.SparseLuFactorization, "__init__", boom)
    a = csr_from_respatpu(laplacian_2d(4, 4))
    with pytest.raises(MemoryError,
                       match="every direct method refused: band: .*; snlu: .*; sparse: "):
        solve.factorize(a, method="auto", device="cpu")
    with pytest.raises(type(exc)):
        solve.factorize(a, method="band", device="cpu")


def test_matched_factorization_is_refined(monkeypatch):
    """Until the multifrontal slice a matched factorization was refused by
    ``solve_refined``; now it is refined in the original system, with the
    matching's scaling and column permutation unwound in the correction."""
    monkeypatch.setattr(analysis, "_USE_NATIVE", True)
    a = csr_from_respatpu(laplacian_2d(5, 5))
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize(a, method="snlu", matching=True, device="cpu")
    assert fac.matched
    _, rep = solve.solve_refined(a, b, fac=fac)
    assert rep.converged and rep.residual <= 1e-10 and "matching+ruiz" in rep.notes


def test_stalled_refinement_escalates_to_gmres_ir():
    """An ill-conditioned banded matrix (cond ~ 1e8 through a geometric row
    scaling of the solution space): plain refinement on the fp32 factor
    stalls, and both packages escalate to GMRES-IR."""
    n = 120
    base = random_banded(n, 5, 4, seed=21)
    dense = base.toarray() @ np.diag(np.logspace(0, -9, n))
    rows, cols = np.nonzero(dense)
    a = jcoo_to_csr(JCOO((n, n), rows.astype(np.int32), cols.astype(np.int32),
                         dense[rows, cols]))
    t = csr_from_respatpu(a)
    b, _ = solve.make_rhs_for_known_x(t)
    jfac = jsolve.factorize_band(a, policy="fp32")
    tfac = solve.factorize_band(t, policy="fp32", device="cpu")
    _, rj = jsolve.solve_refined(a, b, fac=jfac, max_iters=6)
    _, rt = solve.solve_refined(t, b, fac=tfac, max_iters=6)
    assert "gmres_ir=" in rj.notes and "gmres_ir=" in rt.notes
    assert rt.iterations > 6 and rt.residual < 1e-6
    assert rt.converged == (rt.residual < 1e-10)


def test_condest_matches_respatpu_and_numpy():
    a = random_banded(140, 8, 5, seed=31)
    t = csr_from_respatpu(a)
    rj = jsolve.factorize_band(a, policy="fp32").condest()
    tfac = solve.factorize_band(t, policy="fp32", device="cpu")
    rt = tfac.condest()
    exact = 1.0 / np.linalg.cond(t.toarray(), 1)
    # the same Hager iteration on fp32 factors: the estimates may stop on
    # different columns (1.5x); the estimator is a lower bound within 10x
    assert rj / 1.5 <= rt <= rj * 1.5
    assert exact / 10 <= rt <= exact * 10 and tfac.report.rcond_est == rt
    z = tfac.solve_transpose(np.ones(140))
    np.testing.assert_allclose(z, np.linalg.solve(t.toarray().T, np.ones(140)), rtol=1e-3,
                               atol=1e-4)


def test_refinement_runs_on_the_port_spmv_and_sweeps(monkeypatch):
    """Every residual goes through kernels.spmv.spmv on an fp64 upload and
    every correction through BandLuFactorization.solve_device."""
    calls = {"spmv": 0, "solve": 0}
    real_spmv, real_solve = solve.spmv, solve.BandLuFactorization.solve_device

    def counting_spmv(dev, x):
        assert dev.policy.name == "fp64" and x.dtype == torch.float64
        calls["spmv"] += 1
        return real_spmv(dev, x)

    def counting_solve(self, r):
        assert r.dtype == torch.float32
        calls["solve"] += 1
        return real_solve(self, r)

    monkeypatch.setattr(solve, "spmv", counting_spmv)
    monkeypatch.setattr(solve.BandLuFactorization, "solve_device", counting_solve)
    a = csr_from_respatpu(laplacian_2d(9, 9))
    b, _ = solve.make_rhs_for_known_x(a)
    _, rep = solve.solve_refined(a, b, device="cpu")
    assert calls == {"spmv": rep.iterations, "solve": rep.iterations - 1}
    assert set(bandlu.LAUNCHES.values()) == {0} and spmv_kernels.LAUNCHES["fp64"] == 0


def test_refactorize_timed_refreshes_the_factor():
    a = csr_from_respatpu(laplacian_2d(9, 8))
    fac = solve.factorize_band(a, device="cpu")
    before = fac._lu.data.clone()
    fac._lu.data.zero_()
    assert fac.refactorize_timed() > 0
    assert torch.equal(fac._lu.data, before)


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("direct") / "lap.mtx")
    write_mtx(path, csr_from_respatpu(laplacian_2d(14, 11)))
    return path


@pytest.mark.parametrize("flags", [[], ["--refine"], ["--no-refine"],
                                   ["--refine", "--matching", "off"]])
def test_cli_lu(mtx, capsys, flags):
    """respatpu's flags: one direct solve unless ``--refine`` (``--no-refine``
    says so too), and ``--matching``; no warning when a refined residual
    meets the gate."""
    cli.main(["lu", mtx, "--device", "cpu"] + flags)
    out, err = capsys.readouterr()
    refine = "--refine" in flags
    assert "[method=band]" in out and "device=cpu" in out and "WARNING" not in err
    assert ("policy=fp32+ir_fp64" in out) == refine
    resid = float(out.split("rel_residual=")[1].split()[0])
    assert resid < (1e-10 if refine else 1e-4)


def test_cli_lu_refuses_without_a_card_and_unported_methods(mtx, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["lu", mtx])
    # the scheduled sparse LU, once unported, now serves
    cli.main(["lu", mtx, "--device", "cpu", "--method", "sparse", "--refine"])
    out = capsys.readouterr().out
    assert "[method=sparse]" in out and float(out.split("rel_residual=")[1].split()[0]) < 1e-10


def _sweep_lu_header():
    import ast
    import inspect
    for node in ast.walk(ast.parse(inspect.getsource(jrunner.sweep_lu))):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "header":
            return ast.literal_eval(node.value)
    raise AssertionError("no header in respatpu.bench.runner.sweep_lu")


def test_sweep_lu_rows_and_header(tmp_path, monkeypatch):
    assert _respatpu_header()  # the helper this file borrows reads respatpu's source
    monkeypatch.setattr(analysis, "_USE_NATIVE", True)  # the circuit row's analysis
    path = str(tmp_path / "lu.csv")
    rows = runner.sweep_lu(["2cubes_sphere", "dc1"], csv_path=path, max_synth_nnz=30_000,
                           max_band_bytes=64 << 20, verbose=False, device="cpu")
    with open(path) as f:
        table = list(csv.reader(f))
    assert table[0] == runner.LU_HEADER == _sweep_lu_header()
    assert [r[1] for r in table[1:]] == ["2cubes_sphere", "dc1"]
    ok, circuit = rows
    assert ok["status"] == "ok" and ok["method"] == "method=band" and ok["policy"] == "fp32+ir_fp64"
    assert float(ok["rel_residual"]) < 1e-10 and float(ok["t_factor_warm_s"]) > 0
    # the circuit row, whose band does not fit, is served by the multifrontal LU
    assert circuit["status"] == "ok" and circuit["policy"] == "fp32+ir_fp64"
    assert circuit["method"].startswith("method=snlu,matching+ruiz")
    assert float(circuit["rel_residual"]) < 1e-10


def test_cli_sweep_lu(capsys):
    cli.main(["sweep", "lu", "--group", "moderate", "--max-synth-nnz", "1500", "--device", "cpu",
              "--no-refine"])
    out = capsys.readouterr().out
    assert out.count("[lu]") == 21 and "error" not in out
