"""User-facing solver API: SpMV front end, the banded and the multifrontal
direct solver, the automatic method choice, mixed-precision iterative
refinement, and the verification idioms (SURVEY.md §4).

The counterpart of ``respatpu/solve.py``:

* ``spmv_timed``           — test_spmv.c / GPU/spmv.cu
* ``BandLuFactorization``  — test_pardiso.c / test_superLU_MT.c /
                             test_mumps.c (direct LU factorize + solve)
* ``SupernodalLuFactorization`` — the same slot for patterns whose band does
                             not fit: multifrontal LU with GESP matching
* ``SparseLuFactorization`` — the exact scheduled sparse LU on the filled
                             pattern (one launch of K8) and its triangular
                             solves (K7)
* ``factorize``            — the method chain: band, then multifrontal, then
                             the scheduled sparse LU
* ``solve_refined``        — factor in fp32/bf16, residual in fp64: the
                             study's headline pipeline
* ``Ilu0Preconditioner``   — GPU/ilu0.cu: ILU(0) by Chow-Patel sweeps, or
                             exactly by the scheduled LU, and its triangular
                             applies (exact, Jacobi sweeps or ISAI)
* ``cg``, ``gmres``, ``bicgstab`` — preconditioned Krylov solvers, their
                             vectors on the device
* residual / error verification — the reference's three idioms.

Phase timing (analyze / factorize / solve) mirrors PARDISO phases 11/22/33
(test_pardiso.c:185-244); each phase ends after a device synchronize.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .analysis import (apply_matching_scaling, chow_patel_schedule, ordering, permute_csr,
                       rcm_ordering, structural_symmetry, symbolic_fill_lu,
                       weighted_matching_scaling)
from .formats import COOMatrix, CSRMatrix, coo_to_csr, csr_transpose, split_triangular
from .kernels import bandlu, snlu_device
from .kernels import splu as _splu
from .kernels.ilu0 import ilu0_factor
from .kernels.snlu import analyze_supernodes
from .kernels.spmv import spmv, spmv_sol_bytes, to_device
from .kernels.sptrsv import isai_tri, jacobi_tri, sptrsv, tri_to_device
from .precision import Policy, get_policy
from .timing import OpTiming, check_plausible, count, device_bandwidth, span, time_op

__all__ = ["SolveReport", "spmv_timed", "condition_estimate",
           "BandLuFactorization", "band_ordering", "factorize_band",
           "SupernodalLuFactorization", "SparseLuFactorization", "factorize",
           "solve_refined", "relative_residual", "inf_norm_error",
           "make_rhs_for_known_x", "Ilu0Preconditioner", "ilu0", "cg", "gmres",
           "bicgstab"]

WARMUP = 3  # untimed SpMVs before the timed repetitions


def _to_host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _wait(t: torch.Tensor) -> float:
    """A device scalar on the host: a wait on the device, counted as a ``sync``."""
    count("sync")
    return float(t)


def _pull(x: torch.Tensor) -> np.ndarray:
    """:func:`_to_host_f64` of a device tensor, counted as a ``sync``."""
    count("sync")
    return _to_host_f64(x)


def _host_csr(a: CSRMatrix):
    """A ``scipy.sparse`` CSR over ``a``'s own arrays (no copy of the
    entries): its product sums each row in order, as a scatter would."""
    import scipy.sparse as sp
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape, copy=False)


def _host_relative_residual(a_host, x, b) -> float:
    xh = _to_host_f64(x)
    bh = _to_host_f64(b)
    r = a_host @ xh - bh
    nb = np.linalg.norm(bh)
    return float(np.linalg.norm(r) / (nb if nb > 0 else 1.0))


def relative_residual(a: CSRMatrix, x, b) -> float:
    """||A x - b||_2 / ||b||_2 computed in host fp64 with an independent SpMV
    (the test_pardiso.c:258-275 gate): one compiled CSR product on the
    host."""
    return _host_relative_residual(_host_csr(a), x, b)


def inf_norm_error(x, x_true: np.ndarray) -> float:
    """Relative infinity-norm error vs known solution
    (dinf_norm_error equivalent, test_superILU.c:128-133)."""
    xh = _to_host_f64(x)
    scale = np.abs(x_true).max()
    return float(np.abs(xh - x_true).max() / (scale if scale > 0 else 1.0))


def make_rhs_for_known_x(a: CSRMatrix, x_true: Optional[np.ndarray] = None):
    """b = A x_true for a known solution (GenXtrue/FillRHS equivalent,
    test_superLU_MT.c:118-132). Default x_true = all ones."""
    if x_true is None:
        x_true = np.ones(a.ncols)
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    b = np.zeros(a.nrows)
    np.add.at(b, rows, a.data * x_true[a.indices])
    return b, x_true


def spmv_timed(a: CSRMatrix, x: np.ndarray, policy: Union[str, Policy] = "fp32",
               device: Union[str, torch.device] = "cuda", reps: int = 5,
               fmt: str = "auto"):
    """SpMV result and its timing (test_spmv.c:168-180 protocol).

    Uploads ``a`` under ``policy`` and x (host fp64) in the policy's x type,
    computes y once, then times ``WARMUP`` untimed and ``reps`` timed SpMVs
    with :func:`respatpu_torch.timing.time_op`. The timing must pass the
    plausibility gate against the byte model of the format uploaded
    (``kernels.spmv.spmv_sol_bytes``: CSR, or the DIA path's diagonals and
    remainder) at the device's measured copy bandwidth (probed once per
    device), or this raises. Returns ``(y, OpTiming)``; y stays on
    ``device``.
    """
    policy = get_policy(policy)
    dev = to_device(a, policy, device, fmt=fmt)
    xd = torch.from_numpy(np.asarray(x, np.float64)).to(policy.accum_dtype).to(dev.device)
    y = spmv(dev, xd)
    t: OpTiming = time_op(lambda: spmv(dev, xd), dev.device, warmup=WARMUP, reps=reps)
    check_plausible(t, spmv_sol_bytes(dev, xd.element_size()), device_bandwidth(dev.device))
    return y, t


# ---------------------------------------------------------------------------
# Banded direct LU
# ---------------------------------------------------------------------------


@dataclass
class SolveReport:
    """Diagnostics mirroring the reference CSV rows (precision, phase times,
    residual; test_pardiso.c:290-291) plus the expert-routine extras the
    superILU path reports (pivot growth / rcond, test_superILU.c:117-152)."""

    policy: str = ""
    t_analyze: float = 0.0
    t_factorize: float = 0.0
    t_solve: float = 0.0
    iterations: int = 0
    residual: float = float("nan")
    n_pivot_perturbed: int = 0
    converged: bool = True
    pivot_growth: float = float("nan")  # max|U| / max|A|
    rcond_est: float = float("nan")  # 1 / (||A||_1 * est ||A^-1||_1)
    factor_bytes: int = 0  # L/U memory (dQuerySpace equivalent)
    notes: str = ""


def condition_estimate(a: CSRMatrix, solve_fn, iters: int = 5,
                       solve_t_fn=None) -> float:
    """Hager/Higham 1-norm estimate of ||A^-1||_1 via repeated solves
    (the rcond machinery behind gsisx's expert routine). ``solve_fn`` maps a
    host vector b to A^-1 b; ``solve_t_fn`` maps s to A^-T s (the true
    Hager iteration). Without it the A^-1 s substitute gives only an
    order-of-magnitude lower bound."""
    n = a.nrows
    x = np.ones(n) / n
    est = 0.0
    for _ in range(iters):
        y = solve_fn(x)
        est = np.abs(y).sum()
        s = np.sign(y)
        s[s == 0] = 1.0
        z = solve_t_fn(s) if solve_t_fn is not None else solve_fn(s)
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= float(z @ x):
            break
        x = np.zeros(n)
        x[j] = 1.0
    return float(est)


def _norm1(a: CSRMatrix) -> float:
    col_abs = np.zeros(a.ncols)
    np.add.at(col_abs, a.indices, np.abs(a.data))
    return float(col_abs.max()) if a.ncols else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def band_ordering(a: CSRMatrix, order: str = "rcm") -> Tuple[np.ndarray, int, int]:
    """``(perm, bl, bu)``: the band path's symmetric permutation and the
    scalar lower and upper bandwidths under it. ``order="rcm"`` keeps
    whichever of the natural order and RCM gives the narrower band (RCM can
    widen an already banded matrix); ``"natural"`` keeps the natural order."""
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())

    def _bandwidth(perm):
        # bandwidth under a symmetric permutation, from the edge list alone
        # (no permuted-CSR materialization)
        pos = np.empty(a.nrows, dtype=np.int64)
        pos[perm] = np.arange(a.nrows)
        d = pos[a.indices] - pos[rows]
        return (int(max(0, -d.min())), int(max(0, d.max()))) if d.size else (0, 0)

    perm = np.arange(a.nrows, dtype=np.int32)
    bl, bu = _bandwidth(perm)
    if order == "rcm":
        rperm = rcm_ordering(a)
        rbl, rbu = _bandwidth(rperm)
        if rbl + rbu < bl + bu:
            perm, bl, bu = rperm, rbl, rbu
    elif order != "natural":
        raise ValueError(f"unknown order {order!r}")
    return perm, bl, bu


class BandLuFactorization:
    """RCM + blocked band LU: the direct solver (PARDISO-equivalent pipeline).

    Phases: analyze (ordering on the host, band packing on the device) /
    factorize (the block-row loop of ``kernels.bandlu.band_lu``) / solve
    (the two sweep kernels), each timed like phases 11/22/33 and each ended
    by a device synchronize. ``condest`` runs the true Hager iteration, with
    A^-T solves read straight from the band factors
    (``kernels.bandlu.band_solve_transpose``).

    The uploaded band is kept beside its factors (twice the band's bytes on
    the device) so that :meth:`refactorize_timed` can factor it again.
    """

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "rcm", p: int = 128,
                 max_band_bytes: int = 8 << 30,
                 device: Union[str, torch.device] = "cuda"):
        policy = get_policy(policy)
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"band LU requires a square matrix, got {a.shape}")
        self.policy = policy
        self.a = a
        self.device = torch.device(device)
        self.report = SolveReport(policy=policy.name)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the band "
                               "factorization needs full fp32 products")

        t0 = time.perf_counter()
        self.perm, bl, bu = band_ordering(a, order)
        need = bandlu.band_memory_bytes(a.nrows, bl, bu, p,
                                        policy.dtype == torch.float64)
        if need > max_band_bytes:
            raise MemoryError(
                f"band storage would need {need/2**30:.1f} GiB "
                f"(bandwidth {bl}+{bu} after RCM); use ILU+Krylov instead")
        # the permuted matrix; solve_refined's residuals use it too
        natural = bool((self.perm == np.arange(a.nrows)).all())
        self._ap = a if natural else permute_csr(a, self.perm)
        self._dev = bandlu.csr_to_device_band(self._ap, policy, self.device, p=p)
        _sync(self.device)
        self.report.t_analyze = time.perf_counter() - t0

        self.report.t_factorize = self.refactorize_timed()
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        # aminmax allocates nothing of the factor's size; abs().max() would
        lo, hi = torch.aminmax(self._lu.data)
        umax = max(abs(float(lo)), abs(float(hi)))
        self.report.pivot_growth = umax / max(amax, 1e-300)
        self.report.factor_bytes = self._lu.data.numel() * self._lu.data.element_size()

    def refactorize_timed(self) -> float:
        """Numeric factorization wall time, to the device synchronize; the
        port compiles nothing at the first call, so this is simply a second
        timed run. Refreshes the stored factor."""
        self._lu = None  # free the old factor before the new one is allocated
        t0 = time.perf_counter()
        res = bandlu.band_lu(self._dev)
        _sync(self.device)
        dt = time.perf_counter() - t0
        self._lu = res.lu
        self.report.n_pivot_perturbed = res.n_pivot_perturbed
        return dt

    def solve_device(self, bp_dev: torch.Tensor) -> torch.Tensor:
        """Device-side solve in permuted coordinates (for refinement loops):
        a tensor in, the solution in the factor's accumulator type out."""
        return bandlu.band_solve(self._lu, bp_dev)

    def solve_original_device(self, r: torch.Tensor) -> torch.Tensor:
        """Solve A x = r in the original coordinates, fp64 tensors on the
        factor's device in and out (GMRES-IR's preconditioner apply)."""
        if getattr(self, "_perm_dev", None) is None:
            self._perm_dev = torch.from_numpy(self.perm.astype(np.int64)).to(self.device)
        x = torch.empty_like(r)
        x[self._perm_dev] = self.solve_device(
            r[self._perm_dev].to(self.policy.accum_dtype)).double()
        return x

    def _solve_host(self, b: np.ndarray, solver) -> np.ndarray:
        bp = np.asarray(b, np.float64)[self.perm]
        xs = solver(self._lu, torch.from_numpy(bp).to(self.device).to(self.policy.accum_dtype))
        xh = _to_host_f64(xs)
        x = np.empty_like(xh)
        x[self.perm] = xh
        return x

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (host in/out), applying the RCM permutation."""
        t0 = time.perf_counter()
        x = self._solve_host(b, bandlu.band_solve)
        self.report.t_solve = time.perf_counter() - t0
        self.report.residual = relative_residual(self.a, x, np.asarray(b, np.float64))
        return x

    def solve_transpose(self, s: np.ndarray) -> np.ndarray:
        """Solve A^T z = s (host in/out) from the same factors."""
        return self._solve_host(s, bandlu.band_solve_transpose)

    def condest(self, iters: int = 5) -> float:
        inv_norm = condition_estimate(self.a, self.solve, iters=iters,
                                      solve_t_fn=self.solve_transpose)
        self.report.rcond_est = 1.0 / max(_norm1(self.a) * inv_norm, 1e-300)
        return self.report.rcond_est


def factorize_band(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                   **kw) -> BandLuFactorization:
    return BandLuFactorization(a, policy=policy, **kw)


# ---------------------------------------------------------------------------
# Solves in the original coordinates of a sparse factorization
# ---------------------------------------------------------------------------


class _OriginalSolves:
    """The solves of a sparse factorization of P A' P^T, A' = A itself or,
    matched, ``Dr A Dc`` with its columns permuted by the matching: every
    permutation and the scaling unwound around the holder's
    ``solve_device`` (a solve in the permuted system) and
    ``_solve_t_permuted`` (its transpose). The holder sets ``policy``,
    ``a``, ``device``, ``report``, ``perm`` and ``_perm_dev``; a matched one
    sets ``matched`` with ``_cperm``, ``_dr``, ``_dc`` on the host and their
    device copies ``_cperm_dev``, ``_dr_dev``, ``_dc_dev``."""

    matched = False

    def solve_original_device(self, r: torch.Tensor) -> torch.Tensor:
        """Solve A x = r in the original coordinates, fp64 tensors on the
        factor's device in and out: the scaling, the matching's column
        permutation and the fill-reducing permutation all unwound on the
        device (the refinement loops' correction solve)."""
        bw = self._dr_dev * r if self.matched else r      # A' x' = Dr b
        x = torch.empty_like(r)
        x[self._perm_dev] = self.solve_device(
            bw[self._perm_dev].to(self.policy.accum_dtype)).double()
        if self.matched:
            xo = torch.empty_like(x)
            xo[self._cperm_dev] = self._dc_dev * x        # x[cperm[j]] = dc[j] * x'[j]
            x = xo
        return x

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (host in/out)."""
        t0 = time.perf_counter()
        bb = np.asarray(b, np.float64)
        x = _to_host_f64(self.solve_original_device(torch.from_numpy(bb).to(self.device)))
        self.report.t_solve = time.perf_counter() - t0
        self.report.residual = relative_residual(self.a, x, bb)
        return x

    def solve_transpose(self, s: np.ndarray) -> np.ndarray:
        """Solve A^T z = s (host in/out) from the same factors: the true
        Hager iteration's transpose solve."""
        sw = np.asarray(s, np.float64)
        if self.matched:
            sw = self._dc * sw[self._cperm]   # A^T = Pc Dc^-1 A'^T Dr^-1
        zh = _to_host_f64(self._solve_t_permuted(torch.from_numpy(sw[self.perm]).to(self.device)))
        z = np.empty_like(zh)
        z[self.perm] = zh
        if self.matched:
            z = self._dr * z
        return z

    def condest(self, iters: int = 5) -> float:
        inv_norm = condition_estimate(self.a, self.solve, iters=iters,
                                      solve_t_fn=self.solve_transpose)
        self.report.rcond_est = 1.0 / max(_norm1(self.a) * inv_norm, 1e-300)
        return self.report.rcond_est


def _with_unit_diagonal(strict: CSRMatrix) -> CSRMatrix:
    """A strict triangle with its unit diagonal stored."""
    n = strict.nrows
    coo, dn = strict.tocoo(), np.arange(n, dtype=np.int32)
    return coo_to_csr(COOMatrix((n, n), np.concatenate([coo.row, dn]),
                                np.concatenate([coo.col, dn]),
                                np.concatenate([coo.val, np.ones(n)])))


def _lu_triangles(pattern: CSRMatrix, vals: np.ndarray):
    """(L with its unit diagonal stored, U) of factor values on a pattern."""
    L, _, U = split_triangular(CSRMatrix(pattern.shape, pattern.indptr, pattern.indices, vals))
    return _with_unit_diagonal(L), U


def lu_triangles_to_device(filled: CSRMatrix, vals: np.ndarray, policy: Union[str, Policy],
                           device: Union[str, torch.device]):
    """K7's two factors, unit-lower L and U, of factor values (host fp64)
    on their filled pattern, each scheduled once on the host: the solves of
    the scheduled sparse LU and of a factor read from a file."""
    lfull, U = _lu_triangles(filled, vals)
    return (tri_to_device(lfull, lower=True, unit_diag=True, policy=policy, device=device),
            tri_to_device(U, lower=False, policy=policy, device=device))


class _TriangleSolves(_OriginalSolves):
    """Solves from the exact factor's two triangles on the device, one
    launch of K7 each (:func:`lu_triangles_to_device`); the transposed ones,
    U^T then L^T, made at the first call. The holder sets ``_l``, ``_u``,
    ``_filled`` and ``_fill_vals`` (the factor on the filled pattern, host
    fp64) and ``_lt = None``; the transposes take ``_l``'s policy."""

    def factor_values(self) -> np.ndarray:
        """Factored entries in the filled pattern's layout (host fp64)."""
        return self._fill_vals

    def solve_device(self, bp_dev: torch.Tensor) -> torch.Tensor:
        """Device-side solve in the permuted system's coordinates; the
        solution comes back in the policy's accumulator type. Recorded as
        the span ``tri_solve`` with ``lower`` and ``upper`` around the two
        launches, and the counter ``tri_levels`` raised by the levels the
        two walk."""
        with span("tri_solve"):
            count("tri_levels", self._l.levels + self._u.levels)
            with span("lower"):
                y = sptrsv(self._l, bp_dev)
            with span("upper"):
                return sptrsv(self._u, y)

    def _solve_t_permuted(self, sp: torch.Tensor) -> torch.Tensor:
        """A^T = U^T L^T: U^T lower triangular with its diagonal and L^T unit
        upper, their solves made at the first call."""
        if self._lt is None:
            L, _, U = split_triangular(CSRMatrix(self._filled.shape, self._filled.indptr,
                                                 self._filled.indices, self._fill_vals))
            policy = self._l.policy
            self._ut = tri_to_device(csr_transpose(U), lower=True, policy=policy,
                                     device=self.device)
            self._lt = tri_to_device(_with_unit_diagonal(csr_transpose(L)), lower=False,
                                     unit_diag=True, policy=policy, device=self.device)
        return sptrsv(self._lt, sptrsv(self._ut, sp))


# ---------------------------------------------------------------------------
# Multifrontal direct LU
# ---------------------------------------------------------------------------


class SupernodalLuFactorization(_OriginalSolves):
    """Supernodal multifrontal LU with the numeric phase on the device.

    The PARDISO-class pipeline (phases 11/22/33, test_pardiso.c:185-244) for
    patterns whose dense band does not fit in memory (3-D FEM at catalogue
    size, the circuit class): symbolic multifrontal analysis on the host
    (kernels/snlu.py), numeric factorization as batched dense frontal partial
    LUs in one device-resident pool, and solves straight from that pool
    (kernels/snlu_device.py). The fp32, fp32_ftz and bf16 policies factor and
    solve in an fp32 pool (reference accuracy is recovered with
    :func:`solve_refined`, the study's recipe; ``notes`` says
    ``apply=frontal_fp32``); fp64 takes a native fp64 pool.

    ``matching`` turns on the GESP static-pivoting pre-step: MC64-style
    weighted matching and Ruiz scaling, so that the max-product entries sit
    on the diagonal at magnitude ~1, static perturbation rarely triggers and
    refinement converges on circuit-class unsymmetric matrices. The scaling
    and both permutations are unwound inside :meth:`solve`.

    ``max_pool_bytes`` caps the front pool; by default it is nine tenths of
    the device's free memory (4 GiB on the CPU). A pool past it is refused
    with ``MemoryError`` before anything is allocated.
    """

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "fillauto", amalg: int = 32,
                 pivot_eps: Optional[float] = None, matching: bool = False,
                 device: Union[str, torch.device] = "cuda",
                 max_pool_bytes: Optional[int] = None):
        policy = get_policy(policy)
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"multifrontal LU requires a square matrix, got {a.shape}")
        self.policy = policy
        self.a = a
        self.device = torch.device(device)
        self.report = SolveReport(policy=policy.name)
        self.matched = bool(matching)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the front "
                               "factorization needs full fp32 products")
        self._dtype = policy.accum_dtype  # bf16 values are factored in fp32

        t0 = time.perf_counter()
        a_work = a
        # seconds of the analysis' parts (all inside report.t_analyze)
        self.phases = {"matching": 0.0}
        if matching:
            self._cperm, self._dr, self._dc, matched_ok = weighted_matching_scaling(a)
            a_work = apply_matching_scaling(a, self._cperm, self._dr, self._dc)
            self.phases["matching"] = time.perf_counter() - t0
            self.report.notes = ("matching+ruiz scaling (GESP static pivoting)"
                                 if matched_ok else
                                 "MATCHING FAILED (structurally singular): "
                                 "identity matching + ruiz scaling only")
        t1 = time.perf_counter()
        part = analyze_supernodes(a_work, order=order, amalg=amalg)
        self.phases["symbolic"] = time.perf_counter() - t1
        self._order, self._amalg = order, amalg  # persisted: a reload re-runs the analysis
        self.part = part
        self.perm = part.perm
        if max_pool_bytes is None:
            max_pool_bytes = (int(0.9 * torch.cuda.mem_get_info(self.device)[0])
                              if self.device.type == "cuda" else 4 << 30)
        t1 = time.perf_counter()
        self._plan = snlu_device.build_frontal_plan(
            part, itemsize=torch.finfo(self._dtype).bits // 8, max_pool_bytes=max_pool_bytes)
        self.phases["plan"] = time.perf_counter() - t1
        self._plan.on_device(self.device)

        def to_dev(v):
            return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

        self._perm_dev = to_dev(part.perm.astype(np.int64))
        if matching:
            self._cperm_dev = to_dev(self._cperm)
            self._dr_dev, self._dc_dev = to_dev(self._dr), to_dev(self._dc)
        _sync(self.device)
        self.report.t_analyze = time.perf_counter() - t0

        amax = float(np.abs(part.filled.data).max()) if part.filled.nnz else 1.0
        self._pivot_eps = (snlu_device.default_pivot_eps(amax, self._dtype)
                           if pivot_eps is None else float(pivot_eps))
        self._frontal = None
        self.report.t_factorize = self.refactorize_timed()
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        # element growth over the whole pool: includes intermediate Schur
        # values, the textbook growth factor of Gaussian elimination
        lo, hi = torch.aminmax(self._frontal.pool)
        self.report.pivot_growth = max(abs(float(lo)), abs(float(hi))) / max(amax, 1e-300)
        self.report.factor_bytes = self._plan.pool_size * self._frontal.pool.element_size()
        self.report.notes = ((self.report.notes + "," if self.report.notes else "")
                             + f"apply=frontal_{'fp64' if self._dtype == torch.float64 else 'fp32'}")

    def refactorize_timed(self) -> float:
        """Numeric phase wall time (PARDISO phase 22), to the device
        synchronize: assembly of the pool from the filled pattern's values
        and the group-by-group factorization. Refreshes the stored factor."""
        self._frontal = None  # free the old pool before the new one is allocated
        t0 = time.perf_counter()
        pool, nbad = snlu_device.frontal_factor_pool(
            self._plan, self._dtype, self.device, pivot_eps=self._pivot_eps,
            flush=self.policy.flush_to_zero)
        _sync(self.device)
        dt = time.perf_counter() - t0
        self._frontal = snlu_device.FrontalSolver(self._plan, pool,
                                                  flush=self.policy.flush_to_zero)
        self.report.n_pivot_perturbed = nbad
        return dt

    def factor_values(self) -> np.ndarray:
        """Factored entries in ``part.filled.data`` layout (host fp64, the
        pool's accuracy): diagnostics; one pull of the whole pool."""
        return snlu_device.values_from_pool(self._plan, self._frontal.pool)

    def solve_device(self, bp_dev: torch.Tensor) -> torch.Tensor:
        """Device-side solve in the permuted (and, if matched, scaled)
        system's coordinates; the solution comes back in the pool's type."""
        return self._frontal.solve_device(bp_dev)

    def _solve_t_permuted(self, sp: torch.Tensor) -> torch.Tensor:
        """(L U)^T w = sp straight from the pool: U^T forward, then L^T
        backward."""
        return self._frontal.solve_t_device(sp.to(self._dtype))


class SparseLuFactorization(_TriangleSolves):
    """Exact sparse LU by symbolic fill and a level-scheduled elimination.

    The direct solver for patterns whose band does not fit and which the
    multifrontal path refuses, last in the ``auto`` chain: a fill-reducing
    ordering, the symbolic fill (PARDISO phase-11 analogue), the Chow-Patel
    pair lists of the filled pattern and K8's plan on the host
    (``kernels/splu.py``), then the exact numeric factorization in one
    launch of K8 and the exact triangular solves of its L and U (K7), with
    U^T and L^T for ``solve_transpose`` and ``condest``. The factor is in the
    policy's value type (bf16 values sum in fp32); reference accuracy comes
    from :func:`solve_refined`.

    ``max_schedule_bytes`` caps the pair lists as the port stores them on
    the device (ragged int32 positions and an int64 offset an entry,
    ``IluSchedule.layout_bytes()["ragged"]``); past it this raises
    ``MemoryError``. respatpu's guard counts its lists padded to t_max and
    refuses patterns this one admits (divergence D4).

    An open :func:`~respatpu_torch.timing.recording` sees the set-up as the
    spans ``schedule`` (ordering, fill, pair lists and K8's plan, on the
    device), ``factor`` (each K8 launch to its synchronize) and
    ``triangles`` (K7's two triangles scheduled and uploaded)."""

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "fillauto", pivot_eps: Optional[float] = None,
                 max_schedule_bytes: int = 4 << 30,
                 device: Union[str, torch.device] = "cuda"):
        policy = get_policy(policy)
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"sparse LU requires a square matrix, got {a.shape}")
        self.policy = policy
        self.a = a
        self.device = torch.device(device)
        self.report = SolveReport(policy=policy.name)

        t0 = time.perf_counter()
        self._order, self._amalg = order, None  # persisted; no supernodes to amalgamate
        with span("schedule"):
            self.perm = ordering(a, order)
            filled = symbolic_fill_lu(permute_csr(a, self.perm))
            sched = chow_patel_schedule(filled)
            need = _splu.estimate_schedule_bytes(sched)
            if need > max_schedule_bytes:
                raise MemoryError(
                    f"scheduled-LU pair lists would need {need / 2**30:.1f} GiB ragged "
                    f"(fill nnz={filled.nnz}, {sched.npairs} pairs, t_max={sched.t_max})")
            self._filled = filled
            self.plan = _splu.build_scheduled_lu(filled, sched)
            self._dev = _splu.splu_to_device(self.plan, self.device)
            self._perm_dev = torch.from_numpy(self.perm.astype(np.int64)).to(self.device)
            _sync(self.device)
        self.report.t_analyze = time.perf_counter() - t0
        amax = float(np.abs(filled.data).max()) if filled.nnz else 1.0
        self._pivot_eps = (pivot_eps if pivot_eps is not None else
                           (1e-13 if policy.dtype == torch.float64 else 1e-4) * amax)

        self.report.t_factorize = self.refactorize_timed()
        # the triangles' schedules are made once on the host, from the first
        # factorization's values (a refactorization gives the same bits)
        t0 = time.perf_counter()
        with span("triangles"):
            self._fill_vals = _to_host_f64(self.values)
            self._l, self._u = lu_triangles_to_device(filled, self._fill_vals, policy,
                                                      self.device)
            self._lt = None
            _sync(self.device)
        self.report.t_analyze += time.perf_counter() - t0
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        self.report.pivot_growth = float(np.abs(self._fill_vals).max()) / max(amax, 1e-300)
        self.report.factor_bytes = self.values.numel() * self.values.element_size()

    def refactorize_timed(self) -> float:
        """Numeric phase wall time (PARDISO phase 22), to the device
        synchronize: one launch of K8 on the filled pattern and the count of
        perturbed pivots. Refreshes the stored factor values."""
        t0 = time.perf_counter()
        with span("factor"):
            res, _ = _splu.scheduled_lu_factor(self._filled, plan=self.plan, policy=self.policy,
                                               pivot_eps=self._pivot_eps, device=self.device,
                                               dev_plan=self._dev)
            _sync(self.device)
        self.values = res.values
        self.report.n_pivot_perturbed = res.n_pivot_perturbed
        return time.perf_counter() - t0


def _memlike(e: Exception) -> bool:
    """A refusal for lack of memory: the host-side guard's MemoryError, the
    device allocator's OutOfMemoryError, or a message that says so."""
    s = str(e)
    return (isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError))
            or "RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def factorize(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
              method: str = "auto", matching: Union[bool, str] = "auto",
              **kw):
    """Direct factorization with automatic method choice — the PARDISO-parity
    entry point every command routes through (test_pardiso.c:185-244).

    * method="band":  dense band LU after RCM (BandLuFactorization)
    * method="snlu" / "multifrontal":  supernodal multifrontal LU
      (SupernodalLuFactorization)
    * method="sparse": the exact scheduled sparse LU (SparseLuFactorization)
    * method="auto":  band when the band fits the memory budget, else
      multifrontal, else the scheduled sparse LU: respatpu's order, each
      falling through only on a refusal for lack of memory. When all three
      refuse this raises ``MemoryError`` naming each method's refusal; there
      is no retry on the CPU and no quiet change of method.

    ``matching``: True/False forces GESP weighted matching + Ruiz scaling on
    the methods that support it; "auto" is computed as respatpu does (on
    when the pattern is structurally unsymmetric, < 90 % mirrored positions:
    the circuit class). The band class takes no matching, so an explicit
    ``matching=True`` lands in its ``report.notes`` as
    ``matching=unavailable``. The chosen method lands there as ``method=...``
    so sweep rows are auditable. ``device`` (in ``kw``) defaults to "cuda";
    of the other keywords each class takes the ones it knows.
    """
    if matching == "auto":
        matching = a.nrows == a.ncols and structural_symmetry(a) < 0.9
    if method not in ("band", "snlu", "multifrontal", "sparse", "auto"):
        raise ValueError(f"unknown method {method!r}")

    def _mk(cls, tag):
        params = inspect.signature(cls.__init__).parameters
        got = {k: v for k, v in kw.items() if k in params}
        if "matching" in params:
            got["matching"] = matching
        fac = cls(a, policy=policy, **got)
        fac.report.notes = (f"method={tag}" +
                            (f",{fac.report.notes}" if fac.report.notes else ""))
        if matching is True and "matching" not in params:
            # an explicitly requested GESP matching that the serving method
            # cannot honor must stay auditable in the row
            fac.report.notes += ",matching=unavailable"
        return fac

    if method == "band":
        return _mk(BandLuFactorization, "band")
    if method in ("snlu", "multifrontal"):
        return _mk(SupernodalLuFactorization, "snlu")
    if method == "sparse":
        return _mk(SparseLuFactorization, "sparse")
    errs = []
    for cls, tag in ((BandLuFactorization, "band"), (SupernodalLuFactorization, "snlu"),
                     (SparseLuFactorization, "sparse")):
        try:
            return _mk(cls, tag)
        except Exception as e:
            if not _memlike(e):
                raise
            errs.append(f"{tag}: {e}")
    raise MemoryError("every direct method refused: " + "; ".join(errs))


# ---------------------------------------------------------------------------
# Mixed-precision iterative refinement
# ---------------------------------------------------------------------------


class _ResidualOperator:
    """A's fp64 residual operator on one device, in two forms, each made at
    its first use: the device form (:func:`to_device`'s DIA or CSR, the
    refinement's residuals) and the host form (:func:`_host_csr`, the gate
    of :func:`relative_residual`). ``a`` is the host matrix both are made
    from."""

    def __init__(self, a: CSRMatrix, device: torch.device):
        self.a, self.device = a, device
        self._dev = self._host = None

    def on_device(self):
        if self._dev is None:
            count("a_upload")
            self._dev = to_device(self.a, "fp64", self.device)
        else:
            count("a_reuse")
        return self._dev

    def on_host(self):
        if self._host is None:
            self._host = _host_csr(self.a)
        return self._host


def _residual_operator(fac, a: CSRMatrix) -> _ResidualOperator:
    """The residual operator of ``a`` on ``fac.device``. Held by ``fac`` when
    ``a`` is one of its own matrices (``fac.a``, or a band's permuted
    ``fac._ap``) and made anew once that attribute holds another matrix;
    any other matrix gets an operator of its own, made for this call."""
    ops = getattr(fac, "_residual_ops", None)
    if ops is None:
        ops = fac._residual_ops = {}
    for own in ("a", "_ap"):
        if getattr(fac, own, None) is a:
            op = ops.get(own)
            if op is None or op.a is not a:
                op = ops[own] = _ResidualOperator(a, fac.device)
            return op
    return _ResidualOperator(a, fac.device)


def _gmres_ir(a: CSRMatrix, b: np.ndarray, fac, x0: np.ndarray,
              tol: float, max_outer: int = 4, m: int = 40):
    """GMRES-based iterative refinement (Carson & Higham 2017/18): when
    plain IR stalls (cond(A) * u_factor >~ 1), right-preconditioned GMRES
    on the fp32 factorization still contracts — cond(A M^-1) ~ 1 +
    cond(A) * u_factor — and fp64 outer residuals drive the composite to
    reference accuracy. Everything of size n lives on the factor's device
    in fp64: the products with A are the CSR SpMV kernel, the preconditioner
    applies are the factor solves, the Arnoldi basis is orthogonalised there
    by modified Gram-Schmidt. One host sync an inner iteration (the
    breakdown test); the small least-squares problem is solved on the host."""
    dev = fac.device
    with span("gmres"):
        with span("upload"):
            a64 = _residual_operator(fac, a).on_device()
            bb = torch.from_numpy(np.asarray(b, np.float64)).to(dev)
            x = torch.from_numpy(np.array(x0, dtype=np.float64)).to(dev)
        nb = _wait(torch.linalg.vector_norm(bb))
        nb = nb if nb > 0 else 1.0
        total_inner = 0
        for _ in range(max_outer):
            r = bb - spmv(a64, x)
            beta = _wait(torch.linalg.vector_norm(r))
            if beta / nb <= tol:
                break
            V = torch.zeros((m + 1, a.nrows), dtype=torch.float64, device=dev)
            Z = torch.zeros((m, a.nrows), dtype=torch.float64, device=dev)
            H = torch.zeros((m + 1, m), dtype=torch.float64, device=dev)
            V[0] = r / beta
            k = m
            for j in range(m):
                with span("apply"):
                    Z[j] = fac.solve_original_device(V[j])
                with span("orthogonalize"):
                    w = spmv(a64, Z[j])
                    for i in range(j + 1):          # MGS in fp64
                        H[i, j] = torch.dot(w, V[i])
                        w -= H[i, j] * V[i]
                    H[j + 1, j] = torch.linalg.vector_norm(w)
                    total_inner += 1
                    if _wait(H[j + 1, j]) < 1e-300:
                        k = j + 1
                        break
                    V[j + 1] = w / H[j + 1, j]
            with span("lstsq"):
                e1 = np.zeros(k + 1)
                e1[0] = beta
                y, *_ = np.linalg.lstsq(_pull(H[:k + 1, :k]), e1, rcond=None)
                x = x + Z[:k].T @ torch.from_numpy(y).to(dev)
        with span("to_host"):
            return _pull(x), total_inner


def solve_refined(a: CSRMatrix, b: np.ndarray,
                  fac=None,
                  policy: Union[str, Policy] = "fp32",
                  tol: float = 1e-12, max_iters: int = 40,
                  device: Union[str, torch.device] = "cuda",
                  ) -> Tuple[np.ndarray, SolveReport]:
    """Low-precision factorization + fp64 iterative refinement.

    x_{k+1} = x_k + M^-1 (b - A x_k), all on the factor's device: the
    residual in fp64 on the CSR SpMV kernel, the correction solve in the
    factorization's precision, one host sync an iteration (the residual
    norm). Achieves reference-fp64 residuals from an fp32/bf16
    factorization (the study's headline result). A band factorization is
    refined in its permuted system; a multifrontal one, matched or not, in
    the original system, its scaling and permutations unwound on the device
    inside the correction solve. A solve that stalls escalates to GMRES-IR.
    ``device`` is used only when ``fac`` is None.

    A factorization holds its own matrix's residual operator for its life,
    as it holds its factor: the fp64 copy on its device that the residuals
    run on, and the host CSR of the final residual, each made at the first
    refined solve that needs it (no factorization API gives its matrix new
    values). ``a`` is the factorization's own when it is the very object
    ``fac.a`` holds; any other matrix is uploaded for this call alone.
    ``report.policy`` is ``"<policy>+ir_fp64"``; respatpu, whose fp64 is a
    pair of fp32 words, writes ``+ir_df64``.
    """
    if fac is None:
        fac = BandLuFactorization(a, policy=policy, device=device)
    with span("solve_refined"):
        report = SolveReport(policy=f"{fac.policy.name}+ir_fp64",
                             t_analyze=fac.report.t_analyze,
                             t_factorize=fac.report.t_factorize,
                             n_pivot_perturbed=fac.report.n_pivot_perturbed,
                             notes=fac.report.notes)
        t0 = time.perf_counter()
        dev = fac.device
        bb = np.asarray(b, np.float64)
        if isinstance(fac, BandLuFactorization):
            acc = fac.policy.accum_dtype
            perm, a_res = fac.perm, fac._ap

            def correct(r):
                return fac.solve_device(r.to(acc)).double()
        else:
            perm, a_res, correct = None, a, fac.solve_original_device
        bp = bb if perm is None else bb[perm]
        with span("upload"):
            a64 = _residual_operator(fac, a_res).on_device()
            b64 = torch.from_numpy(bp).to(dev)
            x = torch.zeros(a.nrows, dtype=torch.float64, device=dev)
        nb = float(np.linalg.norm(bp))
        nb = nb if nb > 0 else 1.0
        res_hist = []
        with span("ir"):
            for _ in range(max_iters):
                with span("residual"):
                    r = b64 - spmv(a64, x)
                    rnorm = _wait(torch.linalg.vector_norm(r)) / nb
                res_hist.append(rnorm)
                if rnorm < tol:
                    break
                if len(res_hist) > 3 and rnorm > 0.9 * res_hist[-2]:
                    break  # stagnated
                with span("apply"):
                    x += correct(r)
        with span("to_host"):
            out = _pull(x)
            if perm is not None:
                xh = out
                out = np.empty_like(xh)
                out[perm] = xh
        report.t_solve = time.perf_counter() - t0
        report.iterations = len(res_hist)
        with span("host_residual"):
            report.residual = _host_relative_residual(_residual_operator(fac, a).on_host(),
                                                      out, bb)
        report.converged = report.residual < max(tol * 100, 1e-10)
        if not report.converged:
            out, report = _refine_gmres_fallback(a, b, fac, out, tol, report, t0)
        return out, report


def _refine_gmres_fallback(a, b, fac, x, tol, report, t0):
    """Escalate a stalled plain-IR solve to GMRES-IR (see _gmres_ir)."""
    x2, inner = _gmres_ir(a, b, fac, x, tol=max(tol, 1e-12))
    report.t_solve = time.perf_counter() - t0
    report.iterations += inner
    with span("host_residual"):
        report.residual = _host_relative_residual(_residual_operator(fac, a).on_host(),
                                                  x2, np.asarray(b, np.float64))
    report.converged = report.residual < max(tol * 100, 1e-10)
    report.notes = ((report.notes + "," if report.notes else "")
                    + f"gmres_ir={inner}it")
    return x2, report


# ---------------------------------------------------------------------------
# ILU(0) preconditioner
# ---------------------------------------------------------------------------


class Ilu0Preconditioner:
    """ILU(0) factors + triangular applies on the device (GPU/ilu0.cu flow,
    with the L-then-U intent of its descriptors -- not its L^T bug, SURVEY
    §3.4).

    ``method``: "chow_patel" (fixed-point sweeps, ``kernels.ilu0``) or
    "scheduled" (exact ILU(0) by the scheduled LU on A's own pattern,
    ``kernels.splu``, one launch of K8; no sweep count; ``notes`` says
    ``exact_scheduled``).

    ``apply_mode``: "scheduled" (the exact one-launch triangular solves),
    "jacobi" (``apply_sweeps`` fixed-point sweeps on the CSR SpMV kernel, an
    approximate inverse), "isai" (one SpMV with each triangle's incomplete
    sparse approximate inverse) or "auto" = jacobi for single-word
    policies, scheduled for fp64 (the reference-accuracy path stays exact).
    Everything of size n stays on ``device``; the factor values come to the
    host once, to split them into L and U."""

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 sweeps: int = 8, method: str = "chow_patel",
                 apply_mode: str = "auto", apply_sweeps: int = 6,
                 device: Union[str, torch.device] = "cuda"):
        policy = get_policy(policy)
        self.policy = policy
        self.device = torch.device(device)
        self.report = SolveReport(policy=policy.name)
        if method not in ("chow_patel", "scheduled"):
            raise ValueError(f"unknown method {method!r}")
        if apply_mode not in ("auto", "scheduled", "jacobi", "isai"):
            raise ValueError(f"unknown apply_mode {apply_mode!r}")
        t0 = time.perf_counter()
        if method == "scheduled":
            res, plan = _splu.scheduled_lu_factor(a, policy=policy, device=self.device)
            self.schedule = plan.sched
            self.report.notes = "exact_scheduled"
        else:
            res, self.schedule = ilu0_factor(a, policy=policy, sweeps=sweeps, device=self.device)
            self.report.notes = f"cp_residual={res.residual:.2e}"
        vals = _to_host_f64(res.values)
        self.report.t_factorize = time.perf_counter() - t0
        self.report.n_pivot_perturbed = res.n_pivot_perturbed
        self.report.factor_bytes = vals.size * res.values.element_size()

        t0 = time.perf_counter()
        lfull, U = _lu_triangles(a, vals)
        if apply_mode == "auto":
            apply_mode = "scheduled" if policy.dtype == torch.float64 else "jacobi"
        self.apply_mode = apply_mode
        if apply_mode == "isai":
            self._l = isai_tri(lfull, lower=True, unit_diag=True, policy=policy,
                               device=self.device)
            self._u = isai_tri(U, lower=False, policy=policy, device=self.device)
            self.report.notes += ",apply=isai"
        elif apply_mode == "jacobi":
            self._l = jacobi_tri(lfull, lower=True, unit_diag=True, sweeps=apply_sweeps,
                                 policy=policy, device=self.device)
            self._u = jacobi_tri(U, lower=False, sweeps=apply_sweeps, policy=policy,
                                 device=self.device)
            self.report.notes += f",apply=jacobi{apply_sweeps}"
        else:
            self._l = tri_to_device(lfull, lower=True, unit_diag=True, policy=policy,
                                    device=self.device)
            self._u = tri_to_device(U, lower=False, policy=policy, device=self.device)
        _sync(self.device)
        self.report.t_analyze = time.perf_counter() - t0

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """M^-1 r = U^-1 (L^-1 r), in the policy's accumulator type."""
        return sptrsv(self._u, sptrsv(self._l, r))


def ilu0(a: CSRMatrix, policy: Union[str, Policy] = "fp32", sweeps: int = 8,
         device: Union[str, torch.device] = "cuda") -> Ilu0Preconditioner:
    return Ilu0Preconditioner(a, policy=policy, sweeps=sweeps, device=device)


# ---------------------------------------------------------------------------
# Krylov solvers (preconditioned)
# ---------------------------------------------------------------------------
# Each loop keeps its vectors on the device and makes the host wait once per
# convergence test: once an iteration for CG and BiCGSTAB, once a restart
# cycle for GMRES. That is where respatpu's lax.while_loop tests its
# condition, so both take the same number of iterations.


def _krylov_dtype(policy: Policy) -> torch.dtype:
    """Krylov vector dtype under the policy (dots always accumulate fp32)."""
    return torch.bfloat16 if policy.dtype == torch.bfloat16 else torch.float32


def _hdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.float(), v.float())


def _krylov_device(precond, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return precond.device if precond is not None else torch.device("cuda")


def cg(a: CSRMatrix, b: np.ndarray, precond: Optional[Ilu0Preconditioner] = None,
       policy: Union[str, Policy] = "fp32", tol: float = 1e-8, max_iters: int = 500,
       device: Union[str, torch.device, None] = None) -> Tuple[np.ndarray, SolveReport]:
    """Preconditioned conjugate gradient (SPD matrices).

    The vector dtype honors the policy (bf16 runs bf16 vectors with fp32 dot
    accumulation); under fp64 the products are fp64 SpMVs rounded to fp32.
    ``device`` defaults to the preconditioner's (else "cuda")."""
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    device = _krylov_device(precond, device)
    dev = to_device(a, policy, device)
    dt = _krylov_dtype(policy)

    def mv(v):
        return spmv(dev, v.to(policy.accum_dtype)).to(dt)

    def pc(v):
        return v if precond is None else precond.apply(v.float()).to(dt)

    bj = torch.from_numpy(np.asarray(b, np.float64)).to(dt).to(device)
    nb2 = _hdot(bj, bj)
    nb2 = torch.where(nb2 > 0, nb2, torch.ones_like(nb2))
    tol2 = torch.tensor(tol, dtype=torch.float32, device=device) ** 2 * nb2
    x = torch.zeros_like(bj)
    r = bj
    z = pc(bj)
    p = z
    rz = _hdot(bj, z)
    rn2 = _hdot(bj, bj)
    it = 0
    while it < max_iters and bool(rn2 > tol2):
        ap = mv(p)
        alpha = (rz / _hdot(p, ap)).to(dt)
        x = x + alpha * p
        r = r - alpha * ap
        z = pc(r)
        rz_new = _hdot(r, z)
        p = z + (rz_new / rz).to(dt) * p
        rz, it, rn2 = rz_new, it + 1, _hdot(r, r)
    xh = _to_host_f64(x)
    report.t_solve = time.perf_counter() - t0
    report.iterations = it
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = report.residual < tol * 100
    return xh, report


def gmres(a: CSRMatrix, b: np.ndarray, precond: Optional[Ilu0Preconditioner] = None,
          policy: Union[str, Policy] = "fp32", tol: float = 1e-8, restart: int = 40,
          max_restarts: int = 20,
          device: Union[str, torch.device, None] = None) -> Tuple[np.ndarray, SolveReport]:
    """Restarted GMRES(m) with right preconditioning (general matrices).

    fp32 vectors and products (the fp32 SpMV under fp64 too). Each cycle runs
    a classical Gram-Schmidt Arnoldi with one reorthogonalization (CGS2; its
    products with the basis are dense fp32 products with TF32 off) and
    solves the small (m+1, m) Hessenberg least-squares problem on the device
    by QR, with respatpu's 1e-20 guard on R's diagonal; the host waits once
    a cycle, for the residual norm."""
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    device = _krylov_device(precond, device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; GMRES's basis "
                           "products need full fp32")
    dev = to_device(a, "fp32" if policy.dtype == torch.float64 else policy, device)
    n, m = a.nrows, restart

    def mv(v):
        return spmv(dev, v)

    def pc(v):
        return v if precond is None else precond.apply(v).float()

    bj = torch.from_numpy(np.asarray(b, np.float64)).float().to(device)
    nb = torch.linalg.vector_norm(bj)
    nb = torch.where(nb > 0, nb, torch.ones_like(nb))
    x = torch.zeros_like(bj)
    it = 0
    relres = torch.linalg.vector_norm(bj) / nb
    while it < m * max_restarts and bool(relres > tol):
        r = bj - mv(x)
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=torch.float32, device=device)
        Z = torch.zeros((m, n), dtype=torch.float32, device=device)
        H = torch.zeros((m + 1, m), dtype=torch.float32, device=device)
        V[0] = r / beta.clamp(min=1e-30)
        for j in range(m):
            z = pc(V[j])
            Z[j] = z
            w = mv(z)
            h = V @ w  # CGS projections (rows > j are zero)
            w = w - V.T @ h
            h2 = V @ w  # one reorthogonalization pass (CGS2)
            w = w - V.T @ h2
            hn = torch.linalg.vector_norm(w)
            V[j + 1] = w / hn.clamp(min=1e-30)
            H[:, j] = h + h2
            H[j + 1, j] += hn
        # least squares min ||H y - beta e1||; breakdown columns (hn ~ 0) make
        # H rank-deficient: R's diagonal is kept off zero, and the y entries
        # it touches multiply near-zero basis vectors
        e1 = torch.zeros(m + 1, dtype=torch.float32, device=device)
        e1[0] = beta
        q, r_ = torch.linalg.qr(H)
        diag = r_.diagonal()
        r_.diagonal().copy_(torch.where(diag.abs() < 1e-20, torch.full_like(diag, 1e-20), diag))
        y = torch.linalg.solve_triangular(r_, (q.T @ e1)[:, None], upper=True)[:, 0]
        x = x + Z.T @ y
        it += m
        relres = torch.linalg.vector_norm(bj - mv(x)) / nb
    xh = _to_host_f64(x)
    report.t_solve = time.perf_counter() - t0
    report.iterations = it
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = bool(relres <= tol) or report.residual < tol * 100
    return xh, report


def bicgstab(a: CSRMatrix, b: np.ndarray, precond: Optional[Ilu0Preconditioner] = None,
             policy: Union[str, Policy] = "fp32", tol: float = 1e-8, max_iters: int = 500,
             device: Union[str, torch.device, None] = None) -> Tuple[np.ndarray, SolveReport]:
    """Preconditioned BiCGSTAB (general matrices); vector dtype as for
    :func:`cg`, the fp32 SpMV under fp64."""
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    device = _krylov_device(precond, device)
    dev = to_device(a, "fp32" if policy.dtype == torch.float64 else policy, device)
    dt = _krylov_dtype(policy)

    def mv(v):
        return spmv(dev, v.float()).to(dt)

    def pc(v):
        return v if precond is None else precond.apply(v).to(dt)

    bj = torch.from_numpy(np.asarray(b, np.float64)).to(dt).to(device)
    nb2 = _hdot(bj, bj)
    nb2 = torch.where(nb2 > 0, nb2, torch.ones_like(nb2))
    tol2 = torch.tensor(tol, dtype=torch.float32, device=device) ** 2 * nb2
    one = torch.ones((), dtype=torch.float32, device=device)
    x, r = torch.zeros_like(bj), bj
    p, v = torch.zeros_like(bj), torch.zeros_like(bj)
    rho = alpha = omega = one
    rn2 = _hdot(bj, bj)
    it = 0
    while it < max_iters and bool(rn2 > tol2):
        rho_new = _hdot(bj, r)  # rhat = b (initial residual for x0=0)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta.to(dt) * (p - omega.to(dt) * v)
        ph = pc(p)
        v = mv(ph)
        alpha = rho_new / _hdot(bj, v)
        s = r - alpha.to(dt) * v
        x = x + alpha.to(dt) * ph
        sn2 = _hdot(s, s)
        sh = pc(s)
        t = mv(sh)
        omega = _hdot(t, s) / _hdot(t, t)
        x2 = x + omega.to(dt) * sh
        r2 = s - omega.to(dt) * t
        # half-step early exit: if s already converged keep (x, s)
        done = sn2 <= tol2
        x = torch.where(done, x, x2)
        r = torch.where(done, s, r2)
        rn2 = torch.where(done, sn2, _hdot(r2, r2))
        rho, it = rho_new, it + 1
    xh = _to_host_f64(x)
    rel2 = float(rn2 / nb2)
    report.t_solve = time.perf_counter() - t0
    report.iterations = it
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = rel2 < (tol * 10) ** 2 or report.residual < tol * 100
    return xh, report
