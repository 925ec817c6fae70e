"""The ILU(0) slice on the CPU against respatpu on the same inputs: the level
and Chow-Patel schedules, the ILU(0) sweeps (the plain version of the sweep
kernel), the exact triangular solve (the plain version of the one-launch
solve kernel, level by level), the Jacobi and ISAI applies, and then
``Ilu0Preconditioner`` with ``gmres``, ``cg`` and ``bicgstab``, one
``sweep_ilu0`` row and the CLI. respatpu runs on its CPU JAX path; each
function loops over its cases, and the module's fixture drops JAX's compiled
executables when the module ends (as respatpu's ``sweep_ilu0`` does on the
CPU). The kernels themselves are held to the plain versions on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from respatpu import analysis as janalysis
from respatpu import solve as jsolve
from respatpu.bench import runner as jrunner
from respatpu.bench.synth import circuit_like, laplacian_2d, random_banded
from respatpu.formats import COOMatrix as JCOO
from respatpu.formats import coo_to_csr as jcoo_to_csr
from respatpu.formats import split_triangular as jsplit
from respatpu.kernels import ilu0 as jilu
from respatpu.kernels import sptrsv as jtri
from respatpu.precision import df_from_f64, df_to_f64

from respatpu_torch import analysis, cli, solve
from respatpu_torch.bench import corpus, runner
from respatpu_torch.formats import CSRMatrix, split_triangular
from respatpu_torch.interop import (csr_from_respatpu, df_to_numpy, ilu_schedule_from_respatpu,
                                    tri_from_respatpu)
from respatpu_torch.io import write_mtx
from respatpu_torch.kernels import ilu0 as tilu
from respatpu_torch.kernels import sptrsv as ttri
from respatpu_torch.precision import FP32_MIN_NORMAL


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _matrices():
    """A grid, an unsymmetric band and a circuit with a hub row of 50 entries."""
    return {"laplacian": laplacian_2d(9, 7), "banded": random_banded(120, 9, 6, seed=11),
            "circuit": circuit_like(800, 5, seed=3, diag="dominant")}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _unit_lower(ja, values):
    """respatpu's L of an ILU factor with its unit diagonal stored."""
    n = ja.nrows
    L, _, _ = jsplit(type(ja)(ja.shape, ja.indptr, ja.indices, values))
    coo, dn = L.tocoo(), np.arange(n, dtype=np.int32)
    return jcoo_to_csr(JCOO((n, n), np.concatenate([coo.row, dn]), np.concatenate([coo.col, dn]),
                            np.concatenate([coo.val, np.ones(n)])))


def _with_diag(T, d):
    n = T.nrows
    coo, dn = T.tocoo(), np.arange(n, dtype=np.int32)
    return jcoo_to_csr(JCOO((n, n), np.concatenate([coo.row, dn]), np.concatenate([coo.col, dn]),
                            np.concatenate([coo.val, d])))


def _solve_both(T, lower, unit, b, policy):
    """(port, respatpu) exact solves of the same triangle."""
    y = ttri.sptrsv(tri_from_respatpu(T, lower=lower, unit_diag=unit, policy=policy,
                                      device="cpu"),
                    torch.from_numpy(b)).double().numpy()
    jd = jtri.tri_to_device(T, lower=lower, unit_diag=unit, policy=policy, c=64)
    if policy == "df64":
        jy = df_to_f64(jtri.sptrsv(jd, df_from_f64(b)))
    else:
        jy = np.asarray(jtri.sptrsv(jd, jnp.asarray(b, jnp.float32)), np.float64)
    return y, jy


def test_ilu_modules_match_respatpu():
    rng = np.random.default_rng(0)
    for name, ja in _matrices().items():
        a = csr_from_respatpu(ja)
        n = a.nrows
        # level schedules of the matrix's triangles, and the Chow-Patel pairs
        for upper in (False, True):
            assert np.array_equal(analysis.level_schedule(a, upper),
                                  janalysis.level_schedule(ja, upper)), (name, upper)
        js = janalysis.chow_patel_schedule(ja)
        ts = analysis.chow_patel_schedule(a)
        conv = ilu_schedule_from_respatpu(js)
        assert ts.t_max == js.t_max and ts.npairs == conv.npairs, name
        for field in ("ptr", "pairs_a", "pairs_b", "is_lower", "diag_pos_col", "diag_pos"):
            assert np.array_equal(getattr(ts, field), getattr(conv, field)), (name, field)

        # ILU(0) by sweeps: fp32 against fp32, fp64 against double-float
        ref = tilu.ilu0_host_reference(a)
        assert _rel(ref, jilu.ilu0_host_reference(ja)) == 0.0
        for sweeps in (8, 30):
            r32, _ = tilu.ilu0_factor(a, sched=ts, policy="fp32", sweeps=sweeps, device="cpu")
            j32, _ = jilu.ilu0_factor(ja, sched=js, policy="fp32", sweeps=sweeps)
            assert _rel(r32.values.numpy(), j32.values) <= 1e-5, (name, sweeps)
            r64, _ = tilu.ilu0_factor(a, sched=ts, policy="fp64", sweeps=sweeps, device="cpu")
            j64, _ = jilu.ilu0_factor(ja, sched=js, policy="df64", sweeps=sweeps)
            j64v = df_to_numpy(j64.values.hi, j64.values.lo)
            assert _rel(r64.values.numpy(), j64v) <= 1e-10, (name, sweeps)
            assert r32.n_pivot_perturbed == int(j32.n_pivot_perturbed) == 0
            if sweeps == 8:  # bf16: sums in fp32, each result rounded once; one bf16 step apart
                r16, _ = tilu.ilu0_factor(a, sched=ts, policy="bf16", sweeps=8, device="cpu")
                j16, _ = jilu.ilu0_factor(ja, sched=js, policy="bf16", sweeps=8)
                assert _rel(r16.values.float().numpy(), np.asarray(j16.values, np.float32)) \
                    <= 2.0 ** -8, name
            assert np.isclose(r32.residual, float(j32.residual), rtol=1e-3, atol=1e-9)
            if sweeps == 30:  # converged: both are ILU(0)
                assert _rel(r64.values.numpy(), ref) <= 1e-10 and _rel(j64v, ref) <= 1e-10
                assert _rel(r32.values.numpy(), ref) <= 1e-5 and _rel(j32.values, ref) <= 1e-5

        # the exact solve, on the converged factor's triangles and on A's own
        lf = _unit_lower(ja, ref)
        _, d, uf = jsplit(type(ja)(ja.shape, ja.indptr, ja.indices, ref))
        b = rng.standard_normal(n)
        cases = [(lf, True, True), (uf, False, False)]
        if name == "banded":
            la, da, ua = jsplit(ja)
            cases += [(_with_diag(la, da), True, False), (ua, False, True)]
        for T, lower, unit in cases:
            host = ttri.sptrsv_host_reference(csr_from_respatpu(T), b, lower, unit)
            for policy, tol in (("df64", 1e-12), ("fp32", 1e-5)):
                if policy == "fp32" and name != "banded":
                    continue
                y, jy = _solve_both(T, lower, unit, b, policy)
                assert _rel(y, jy) <= tol and _rel(y, host) <= tol, (name, lower, unit, policy)

        # the approximate applies, fp32: Jacobi sweeps and ISAI
        if name != "laplacian":
            for T, lower, unit in ((lf, True, True), (uf, False, False)):
                t = csr_from_respatpu(T)
                for port, ref_op in ((ttri.jacobi_tri(t, lower, unit, sweeps=6, device="cpu"),
                                      jtri.jacobi_tri(T, lower=lower, unit_diag=unit, sweeps=6)),
                                     (ttri.isai_tri(t, lower, unit, device="cpu"),
                                      jtri.isai_tri(T, lower=lower, unit_diag=unit))):
                    y = ttri.sptrsv(port, torch.from_numpy(b).float()).double().numpy()
                    jy = np.asarray(jtri.sptrsv(ref_op, jnp.asarray(b, jnp.float32)), np.float64)
                    assert _rel(y, jy) <= 1e-5, (name, lower, port.isai)

    # a bidiagonal chain: n levels
    n = 300
    rows = np.r_[np.arange(n), np.arange(1, n)].astype(np.int32)
    cols = np.r_[np.arange(n), np.arange(n - 1)].astype(np.int32)
    chain = jcoo_to_csr(JCOO((n, n), rows, cols, np.r_[np.full(n, 2.0), np.full(n - 1, -0.9)]))
    assert analysis.level_schedule(csr_from_respatpu(chain)).max() == n - 1
    b = rng.standard_normal(n)
    host = ttri.sptrsv_host_reference(csr_from_respatpu(chain), b)
    for policy, tol in (("df64", 1e-12), ("fp32", 1e-5)):
        y, jy = _solve_both(chain, True, False, b, policy)
        assert _rel(y, jy) <= tol and _rel(y, host) <= tol, policy
    tasks = tri_from_respatpu(chain, device="cpu").tasks.numpy()  # runs of thin levels, none longer than 128
    assert (tasks[:, 3] > tasks[:, 2]).all() and (tasks[:, 1] - tasks[:, 0]).max() == 128

    # the kernel's row classes: rows with no strict entry, short rows, rows
    # longer than a short row (40 entries) and than a warp's step (120), and
    # a zero diagonal (read as 1 by both packages and here by the oracle)
    n = 200
    r, c = rng.integers(0, n, 5 * n), rng.integers(0, n, 5 * n)
    rows = np.r_[np.maximum(r, c), np.full(40, 150), np.full(120, n - 1), np.arange(n)]
    cols = np.r_[np.minimum(r, c), rng.choice(150, 40, replace=False),
                 rng.choice(n - 1, 120, replace=False), np.arange(n)]
    keep = (rows % 9 != 4) | (rows == cols)
    rows, cols = rows[keep].astype(np.int32), cols[keep].astype(np.int32)
    vals = rng.uniform(0.5, 1.5, keep.sum()) * rng.choice((-1.0, 1.0), keep.sum())
    vals[rows == cols] += 3.0
    vals[(rows == 7) & (cols == 7)] = 0.0
    for lower in (True, False):  # the upper triangle: the lower one turned by 180 degrees
        T = jcoo_to_csr(JCOO((n, n), rows, cols, vals) if lower else
                        JCOO((n, n), n - 1 - rows, n - 1 - cols, vals))
        one = csr_from_respatpu(T)
        one.data[one.data == 0.0] = 1.0
        d = tri_from_respatpu(T, lower=lower, device="cpu")
        assert (d.tasks[:, 3] == -1).sum() == 2 and (np.diff(d.ptr.numpy()) == 0).any()
        for unit in (False, True):
            host = ttri.sptrsv_host_reference(one, b[:n], lower, unit)
            for policy, tol in (("df64", 1e-12), ("fp32", 1e-5)):
                y, jy = _solve_both(T, lower, unit, b[:n], policy)
                assert _rel(y, jy) <= tol and _rel(y, host) <= tol, (lower, unit, policy)

    # a planted zero pivot is perturbed and counted once, as respatpu counts it
    ja = laplacian_2d(5, 5)
    ja.data[ja.indptr[3]:ja.indptr[4]][ja.indices[ja.indptr[3]:ja.indptr[4]] == 3] = 0.0
    r, _ = tilu.ilu0_factor(csr_from_respatpu(ja), policy="fp32", device="cpu")
    j, _ = jilu.ilu0_factor(ja, policy="fp32")
    assert r.n_pivot_perturbed == int(j.n_pivot_perturbed) == 1
    assert _rel(r.values.numpy(), j.values) <= 1e-5

    # fp32_ftz flushes a subnormal partial that fp32 keeps: the sweep's
    # u11 = 0 - l10 u01 = -1e-39, and the solve's y1 = 0 - n10 y0 = -1e-39
    a2 = CSRMatrix((2, 2), np.array([0, 2, 4]), np.array([0, 1, 0, 1], np.int32),
                   np.array([1.0, 1e-20, 1e-19, 0.0]))
    s2 = tilu.ilu_schedule_to_device(analysis.chow_patel_schedule(a2), "cpu")
    old = torch.tensor([1.0, 1e-20, 1e-19, 0.0])
    got = {fl: tilu.ilu0_sweep(s2, old, old, 1e-30, False, fl)[0][3].item() for fl in (0, 1)}
    assert 0 < -got[0] < FP32_MIN_NORMAL and got[1] == 0.0
    l2 = CSRMatrix((2, 2), np.array([0, 1, 3]), np.array([0, 0, 1], np.int32),
                   np.array([1.0, 1e-20, 1.0]))
    b2 = torch.tensor([1e-19, 0.0])
    y32 = ttri.sptrsv(ttri.tri_to_device(l2, policy="fp32", device="cpu"), b2)
    yftz = ttri.sptrsv(ttri.tri_to_device(l2, policy="fp32_ftz", device="cpu"), b2)
    assert 0 < -float(y32[1]) < FP32_MIN_NORMAL and float(yftz[1]) == 0.0


def _rel2(x, xr):
    return float(np.linalg.norm(x - xr) / np.linalg.norm(xr))


def test_ilu_slice_matches_respatpu(tmp_path, monkeypatch, capsys):
    lap, circ = laplacian_2d(30, 30), circuit_like(800, 5, seed=3, diag="dominant")
    # (matrix, policy, apply_mode, solvers with their tolerance). On the grid
    # the solutions agree to 1e-6 once both have run past the iteration where
    # a 1e-7 test may stop one of them a step earlier than the other
    runs = [(lap, "fp32", "auto", {"cg": 5e-8, "bicgstab": 5e-8, "gmres": 1e-6}),
            (lap, "fp32", "scheduled", {"bicgstab": 5e-8}),
            (lap, "fp32", "isai", {"cg": 5e-8}),
            (lap, "fp64", "auto", {"gmres": 1e-6}),
            (circ, "fp32", "jacobi", {"gmres": 1e-6, "bicgstab": 1e-7}),
            (circ, "fp32", "isai", {"bicgstab": 1e-7})]
    rng = np.random.default_rng(5)
    for ja, policy, mode, solvers in runs:
        a = csr_from_respatpu(ja)
        b = rng.standard_normal(a.nrows)
        jpol = "df64" if policy == "fp64" else policy
        jp = jsolve.Ilu0Preconditioner(ja, policy=jpol, apply_mode=mode)
        tp = solve.Ilu0Preconditioner(a, policy=policy, apply_mode=mode, device="cpu")
        assert tp.report.notes.split(",")[1:] == jp.report.notes.split(",")[1:]
        assert tp.report.n_pivot_perturbed == jp.report.n_pivot_perturbed
        for name, tol in solvers.items():
            jx, jr = getattr(jsolve, name)(ja, b, precond=jp, policy=jpol, tol=tol)
            tx, tr = getattr(solve, name)(a, b, precond=tp, policy=policy, tol=tol)
            case = (a.nrows, policy, mode, name)
            assert jr.converged and tr.converged, case
            assert abs(tr.iterations - jr.iterations) <= 2, (case, tr.iterations, jr.iterations)
            assert _rel2(tx, jx) <= 1e-6, (case, _rel2(tx, jx))
    # exact ILU(0) by the scheduled LU, once unported: both packages' notes
    # and pivots, and the same GMRES iterations within one
    jp = jsolve.Ilu0Preconditioner(lap, policy="fp32", method="scheduled")
    tp = solve.Ilu0Preconditioner(csr_from_respatpu(lap), "fp32", method="scheduled",
                                  device="cpu")
    assert tp.report.notes == jp.report.notes == "exact_scheduled,apply=jacobi6"
    assert tp.report.n_pivot_perturbed == int(jp.report.n_pivot_perturbed) == 0
    b = rng.standard_normal(lap.nrows)
    jx, jr = jsolve.gmres(lap, b, precond=jp, tol=1e-6)
    tx, tr = solve.gmres(csr_from_respatpu(lap), b, precond=tp, tol=1e-6)
    assert jr.converged and tr.converged and abs(tr.iterations - jr.iterations) <= 1

    # one sweep_ilu0 row of each package
    jrow = jrunner.sweep_ilu0(["ct20stif"], max_synth_nnz=1500, verbose=False)[0]
    trow = runner.sweep_ilu0(["ct20stif"], csv_path=str(tmp_path / "ilu.csv"),
                             max_synth_nnz=1500, verbose=False, device="cpu")[0]
    assert jrow["status"] == trow["status"] == "ok"
    assert list(trow) == runner.ILU0_HEADER == list(jrow)
    assert float(trow["krylov_residual"]) <= 1e-10 and trow["cp_residual"].endswith("jacobi6")
    assert (tmp_path / "ilu.csv").read_text().splitlines()[0] == ",".join(runner.ILU0_HEADER)

    # the CLI: ilu0 on a file, sweep ilu0 over a group (cut to one entry here)
    mtx = str(tmp_path / "lap.mtx")
    write_mtx(mtx, csr_from_respatpu(laplacian_2d(12, 12)))
    cli.main(["ilu0", mtx, "--device", "cpu", "--policy", "fp64"])
    monkeypatch.setattr(corpus, "MODERATE", corpus.MODERATE[:1])
    cli.main(["sweep", "ilu0", "--group", "moderate", "--max-synth-nnz", "1500",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "lap.mtx: analyze=" in out and "pivots_perturbed=0 cp_residual=" in out
    assert out.count("[ilu0] 2cubes_sphere") == 1 and " ok (synthetic)" in out
