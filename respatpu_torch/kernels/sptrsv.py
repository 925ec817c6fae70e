"""Sparse triangular solves on the card: the exact solve and the approximate
applies of the ILU(0) preconditioner.

The counterpart of ``respatpu/kernels/sptrsv.py``; it replaces
``cusparseXcsrsv2_solve`` (GPU/ilu0.cu:284-310).

* The exact solve, ``y = T^-1 b``, is one launch of a hand-written CUDA
  kernel (``csrc/sptrsv.cu``, K7) with no level loop on the host. Its
  schedule is made once a factor, at upload (:func:`tri_schedule`): the rows
  in level order (a *position* a row), the strict triangle stored in that
  order with its columns as positions, and tasks in level order (up to 32
  short rows of one level, a lane a row; one long row, a warp over its
  entries; or a run of thin levels, one warp walking them), which warps take
  from an atomic ticket, each waiting once on a completion counter of the
  level before; counters and ticket are zeroed for every launch on its
  stream. respatpu's
  chunked schedule and 8 x 8 blocklets (``build_tri_chunks``,
  ``_pack_blocklets``) exist for a chip without gathers and are not ported.
  Its plain PyTorch version, :func:`tri_solve_plain`, reads the same
  schedule and goes level by level, each row summed in the kernel's order,
  so the two agree bit for bit. :func:`link_latency` measures the card's
  one-way hand-over through L2, which times the levels gives the solve's
  chain bound.
* ``jacobi_tri``: ``sweeps`` rounds of ``y <- dinv (b - N y)`` over the
  strict triangle N, each product with N on the CSR SpMV kernel; exact after
  depth(T) sweeps, and for a fixed count a linear operator (an
  approximate-inverse preconditioner).
* ``isai_tri``: the incomplete sparse approximate inverse M of T, built on
  the host; its apply is one product with M on the CSR SpMV kernel.

:func:`tri_solve` launches K7 for CUDA tensors and runs the plain version for
CPU tensors; nothing else chooses. K7 has fp32, fp32_ftz (b, every product,
partial sum and result flushed), bf16 (bf16 values and dinv, b and y fp32,
each y_i rounded to bf16 once) and fp64 instances.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..analysis import level_schedule
from ..formats import COOMatrix, CSRMatrix, coo_to_csr
from ..precision import Policy, ftz, get_policy
from .spmv import DeviceCsr, spmv, to_device

__all__ = ["DeviceTri", "JacobiTri", "tri_schedule", "tri_to_device", "tri_solve",
           "tri_solve_plain", "link_latency", "jacobi_tri", "isai_tri", "sptrsv",
           "sptrsv_host_reference", "LAUNCHES"]

_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}

# Kernel launches per entry point, raised by ``tri_solve`` right after each
# launch succeeds and nowhere else.
LAUNCHES = {f"respa_tri_solve_{d}_{i}": 0 for d in ("lower", "upper") for i in _INST.values()}

# The schedule's sizes, as csrc/sptrsv.cu was built with them (checked at the
# first launch): a short row holds at most SHORT strict entries; a task takes
# up to TASK_ROWS short rows of one level; a run of thin levels (at most
# TASK_ROWS rows each, all short) holds at most RUN_ROWS rows and RUN_ENTRIES
# entries, staged in shared memory.
SHORT, RUN_ROWS, RUN_ENTRIES, TASK_ROWS = 16, 128, 512, 32

# K7's other way to wait (mode 1 of csrc/sptrsv.cu, :func:`_tri_solve_flags`):
# a ready flag a row carried by the value itself, the values starting as a
# signalling NaN that no result can be.
_PENDING = {torch.float32: 0x7F800001, torch.float64: 0x7FF0000000000001}
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}
# warps taking K7's tasks: LOOKAHEAD levels' worth of them on the average, at
# least 32 (more warps would only poll)
LOOKAHEAD = 4


@dataclasses.dataclass
class TriSchedule:
    """The level-ordered layout of a strict triangle, on the host (see
    :func:`tri_schedule`)."""

    perm: np.ndarray  # int64[n]: the row at each position
    level_ptr: np.ndarray  # int64[levels + 1]: each level's first position
    ptr: np.ndarray  # int64[n + 1]: the rows' entries in position order
    cols: np.ndarray  # int64[nnz]: their columns, as positions
    src: np.ndarray  # int64[nnz]: each entry's place in the CSR it came from
    tasks: np.ndarray  # int32[ntasks, 4]: (q0, q1, v0, v1)
    warps: int  # warps to take the tasks


def tri_schedule(strict: CSRMatrix, lower: bool) -> TriSchedule:
    """K7's schedule of a strict triangle N (CSR, rows in any order of
    their dependencies): positions by level (:func:`level_schedule`), short
    rows (at most SHORT entries) before long ones in a level, rows ascending
    within each; each row's entries in CSR order; and tasks in level order,
    ``(q0, q1, v0, v1)`` for the positions ``q0 .. q1 - 1``: ``v1 == v0``, up
    to TASK_ROWS short rows of level v0; ``v1 == -1``, one long row of level
    v0; ``v1 > v0``, a run of the consecutive thin levels v0 .. v1; and how
    many warps take them (LOOKAHEAD levels' worth on the average)."""
    n = strict.nrows
    indptr = np.asarray(strict.indptr, np.int64)
    lens = np.diff(indptr)
    level = level_schedule(strict, upper=not lower).astype(np.int64) if n else lens
    nlev = int(level.max()) + 1 if n else 0
    long = lens > SHORT
    perm = np.lexsort((long, level))
    size = np.bincount(level, minlength=nlev)
    level_ptr = np.zeros(nlev + 1, np.int64)
    np.cumsum(size, out=level_ptr[1:])
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(n)
    plens = lens[perm]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(plens, out=ptr[1:])
    src = np.repeat(indptr[:-1][perm] - ptr[:-1], plens) + np.arange(ptr[-1])
    nlong = np.bincount(level[long], minlength=nlev).tolist()
    ents = np.bincount(level, weights=lens, minlength=nlev).astype(np.int64).tolist()
    thin = ((size <= TASK_ROWS) & (np.asarray(nlong) == 0)).tolist()
    size, lp = size.tolist(), level_ptr.tolist()
    tasks = []
    v = 0
    while v < nlev:
        w, rows, held = v, 0, 0
        while w < nlev and thin[w] and rows + size[w] <= RUN_ROWS and held + ents[w] <= RUN_ENTRIES:
            rows, held, w = rows + size[w], held + ents[w], w + 1
        if w - v >= 2:
            tasks.append((lp[v], lp[w], v, w - 1))
            v = w
            continue
        q0, q1 = lp[v], lp[v + 1]
        qs = q1 - nlong[v]
        tasks += [(q, min(q + TASK_ROWS, qs), v, v) for q in range(q0, qs, TASK_ROWS)]
        tasks += [(q, q + 1, v, -1) for q in range(qs, q1)]
        v += 1
    return TriSchedule(perm=perm, level_ptr=level_ptr, ptr=ptr,
                       cols=pos[strict.indices[src]], src=src,
                       tasks=np.asarray(tasks, np.int32).reshape(-1, 4),
                       warps=max(32, -(-LOOKAHEAD * len(tasks) // max(nlev, 1))))


@dataclasses.dataclass
class DeviceTri:
    """A triangular factor T = D + N on one device, as K7 and its plain
    version read it: N in position order (:func:`tri_schedule`) with its
    tasks, and the reciprocal diagonal by row (the policy's value type; ones
    for a unit diagonal, 1 where the diagonal is 0)."""

    n: int
    lower: bool
    policy: Policy
    dinv: torch.Tensor  # V[n], by row
    perm: torch.Tensor  # int32[n]: the row at each position
    level_ptr: torch.Tensor  # int32[levels + 1]
    ptr: torch.Tensor  # int64[n + 1]
    cols: torch.Tensor  # int32[nnz], positions
    vals: torch.Tensor  # V[nnz]
    tasks: torch.Tensor  # int32[ntasks, 4]
    warps: int  # warps taking the tasks
    _plain: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.dinv.device

    @property
    def nnz(self) -> int:
        return self.cols.numel()

    @property
    def levels(self) -> int:
        return self.level_ptr.numel() - 1

    def strict_csr(self) -> CSRMatrix:
        """N by row on the host, with fp64 values."""
        perm = self.perm.cpu().numpy().astype(np.int64)
        rows = np.repeat(perm, np.diff(self.ptr.cpu().numpy()))
        cols = perm[self.cols.cpu().numpy()]
        return coo_to_csr(COOMatrix((self.n, self.n), rows.astype(np.int32), cols.astype(np.int32),
                                    self.vals.cpu().double().numpy()), sum_duplicates=False)


def _strict_and_diag(t_csr: CSRMatrix, lower: bool, unit_diag: bool, values=None):
    """(strict triangle as CSR, diagonal as fp64 vector) of a triangular CSR;
    raises if an off-diagonal entry lies on the other side."""
    n = t_csr.nrows
    data = t_csr.data if values is None else np.asarray(values, np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), t_csr.row_lengths())
    cols = t_csr.indices.astype(np.int64)
    offd = cols != rows
    if np.any((cols > rows) if lower else (cols < rows)):
        raise ValueError(f"the matrix is not {'lower' if lower else 'upper'} triangular")
    diag = np.ones(n, np.float64)
    if not unit_diag:
        diag[rows[~offd]] = data[~offd]
    strict = coo_to_csr(COOMatrix((n, n), rows[offd].astype(np.int32),
                                  cols[offd].astype(np.int32), data[offd].copy()),
                        sum_duplicates=False)
    return strict, diag


def tri_to_device(t_csr: CSRMatrix, lower: bool = True, unit_diag: bool = False,
                  policy: Union[str, Policy] = "fp32", values: Optional[np.ndarray] = None,
                  device: Union[str, torch.device] = "cuda") -> DeviceTri:
    """Upload a host triangular CSR for the exact solve: its strict triangle
    in K7's level order (:func:`tri_schedule`, made here once) and
    ``dinv``, the reciprocal of the diagonal formed in fp64 on the host (a
    zero diagonal read as 1; ones with ``unit_diag``), both under
    ``policy``. ``values`` overrides ``t_csr.data`` (same pattern)."""
    policy = get_policy(policy)
    if t_csr.nrows >= 2 ** 31:
        raise ValueError("positions are int32: the triangle must have < 2^31 rows")
    strict, diag = _strict_and_diag(t_csr, lower, unit_diag, values)
    dinv = 1.0 / np.where(diag == 0.0, 1.0, diag)
    s = tri_schedule(strict, lower)
    device = torch.device(device)

    def put(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    return DeviceTri(n=t_csr.nrows, lower=lower, policy=policy,
                     dinv=policy.cast_host(dinv).to(device), perm=put(s.perm, np.int32),
                     level_ptr=put(s.level_ptr, np.int32), ptr=put(s.ptr, np.int64),
                     cols=put(s.cols, np.int32),
                     vals=policy.cast_host(strict.data[s.src]).to(device),
                     tasks=put(s.tasks, np.int32), warps=s.warps)


def _plain_layout(t: DeviceTri):
    """The plain solve's gathers, made once a factor: a level's short rows
    as one dense [rows, most] block of entry indices (``most``: the level's
    longest short row), its long rows as [rows, steps, 32] (lane l's step k
    takes entry 32 k + l), the empty places pointing at the zero entry (index
    nnz, column n). Returns ``(lay, levels)``, ``levels`` holding ``(q0, ns,
    most, nl, steps, at_short, at_long)`` a level."""
    if t._plain is None:
        ptr = t.ptr.cpu().numpy()
        lp = t.level_ptr.cpu().numpy().astype(np.int64)
        n, nnz, nlev = t.n, t.nnz, t.levels
        lens = np.diff(ptr)
        level = np.repeat(np.arange(nlev), np.diff(lp))
        short = lens <= SHORT
        ns = np.bincount(level[short], minlength=nlev)
        most = np.zeros(nlev, np.int64)
        np.maximum.at(most, level[short], lens[short])
        steps = np.zeros(nlev, np.int64)
        np.maximum.at(steps, level[~short], (lens[~short] + 31) // 32)
        width = np.where(short, most[level], 32 * steps[level])  # a row's places
        at = np.zeros(n + 1, np.int64)
        np.cumsum(width, out=at[1:])
        lay = np.full(int(at[-1]), nnz, np.int64)
        ent_row = np.repeat(np.arange(n), lens)
        lay[at[ent_row] + np.arange(nnz) - ptr[ent_row]] = np.arange(nnz)
        at_short = at[lp[:-1]]
        levels = list(zip(lp[:-1].tolist(), ns.tolist(), most.tolist(),
                          (np.diff(lp) - ns).tolist(), steps.tolist(), at_short.tolist(),
                          (at_short + ns * most).tolist()))
        t._plain = (torch.from_numpy(lay).to(t.device), levels)
    return t._plain


def _tree(s: torch.Tensor, fl: bool) -> torch.Tensor:
    """Lane 0's sum of a warp's 32 partials [rows, 32], as the kernel's
    shuffles take it: a halving tree."""
    off = 16
    while off:
        s = ftz(s[:, :off] + s[:, off:2 * off], fl)
        off //= 2
    return s[:, 0]


def tri_solve_plain(t: DeviceTri, b: torch.Tensor) -> torch.Tensor:
    """The solve kernel's function in plain torch ops, on any device, from
    the same schedule: level by level, a short row's products summed one
    after the other in CSR order from +0, a long row's as the kernel's warp
    sums them (a partial a lane over the entries l, l + 32, ... in order,
    then a halving tree over the 32 partials), every product and sum rounded
    on its own and flushed under fp32_ftz, then ``y_i = (b_i - sum) *
    dinv_i`` (rounded to bf16 once under bf16). An empty place adds +0 (its
    value 0 times y[n] = 0), which leaves a sum that started from +0 as it
    is."""
    p = t.policy
    acc, fl = p.accum_dtype, p.flush_to_zero
    lay, levels = _plain_layout(t)
    zero = torch.zeros(1, dtype=acc, device=t.device)
    vl = torch.cat([t.vals.to(acc), zero])[lay]
    cl = torch.cat([t.cols.long(), torch.full((1,), t.n, device=t.device)])[lay]
    perm = t.perm.long()
    bp = ftz(b.to(acc), fl)[perm]
    dp = t.dinv.to(acc)[perm]
    yp = torch.zeros(t.n + 1, dtype=acc, device=t.device)  # yp[n] = 0: the zero entry's column
    for q0, ns, most, nl, steps, at_s, at_l in levels:
        sums = []
        if ns:
            s = torch.zeros(ns, dtype=acc, device=t.device)
            if most:
                e = slice(at_s, at_s + ns * most)
                pr = ftz(vl[e] * yp[cl[e]], fl).view(ns, most)
                for m in range(most):
                    s = ftz(s + pr[:, m], fl)
            sums.append(s)
        if nl:
            e = slice(at_l, at_l + nl * steps * 32)
            pr = ftz(vl[e] * yp[cl[e]], fl).view(nl, steps, 32)
            part = torch.zeros(nl, 32, dtype=acc, device=t.device)
            for k in range(steps):
                part = ftz(part + pr[:, k], fl)
            sums.append(_tree(part, fl))
        q = slice(q0, q0 + ns + nl)
        s = sums[0] if len(sums) == 1 else torch.cat(sums)
        v = ftz(ftz(bp[q] - s, fl) * dp[q], fl)
        yp[q] = v.to(p.dtype).to(acc) if p.dtype == torch.bfloat16 else v
    y = torch.empty(t.n, dtype=acc, device=t.device)
    y[perm] = yp[:t.n]
    return y


_lib = None


def _library():
    """The built kernel library, once its schedule sizes are known to match
    ours."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load()
        ours = (SHORT, RUN_ROWS, RUN_ENTRIES, TASK_ROWS)
        sizes = tuple(lib.respa_tri_solve_limit(i) for i in range(len(ours)))
        if sizes != ours:
            raise RuntimeError(f"csrc/sptrsv.cu was built with the sizes {sizes}, the schedule "
                               f"makes {ours}")
        _lib = lib
    return _lib


def _check(t: DeviceTri, b: torch.Tensor) -> None:
    acc = t.policy.accum_dtype
    if b.dtype != acc or b.device != t.device or b.shape != (t.n,) or not b.is_contiguous():
        raise ValueError(f"b must be contiguous {acc} of shape ({t.n},) on {t.device}")
    if (t.dinv.dtype != t.policy.dtype or t.dinv.shape != (t.n,)
            or t.vals.dtype != t.policy.dtype or t.perm.shape != (t.n,)
            or t.ptr.shape != (t.n + 1,)
            or any(v.device != t.device for v in (t.perm, t.level_ptr, t.ptr, t.cols, t.vals,
                                                   t.tasks))):
        raise ValueError("DeviceTri arrays do not match its policy, size and device")


def _launch(t: DeviceTri, b: torch.Tensor, out: torch.Tensor, mode: int) -> None:
    """One launch of K7 on the current stream, with its control words (and,
    under mode 1, the pending values) set for it on that stream."""
    acc = t.policy.accum_dtype
    if mode == 1:
        nctl = 1
        yp = torch.full((t.n,), _PENDING[acc], dtype=_BITS[acc], device=t.device).view(acc)
    else:
        nctl = t.levels + 1
        yp = torch.empty(t.n, dtype=acc, device=t.device)
    ctl = torch.zeros(nctl, dtype=torch.int32, device=t.device)
    name = f"respa_tri_solve_{'lower' if t.lower else 'upper'}_{_INST[t.policy.name]}"
    rc = getattr(_library(), name)(
        t.device.index, t.tasks.shape[0], t.warps, t.tasks.data_ptr(), t.level_ptr.data_ptr(),
        t.perm.data_ptr(), t.ptr.data_ptr(), t.cols.data_ptr(), t.vals.data_ptr(),
        t.dinv.data_ptr(), b.data_ptr(), out.data_ptr(), yp.data_ptr(), ctl.data_ptr(), nctl,
        mode, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def tri_solve(t: DeviceTri, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = T^-1 b exactly, b and y in the policy's accumulator type on the
    factor's device (``out``, if given: at least n long, only its first n
    written); see :func:`tri_solve_plain`.

    On a CUDA device this is one launch of the solve kernel on the current
    stream, its tasks waiting on level counters that are zeroed for it, with
    its ticket, on that stream. It raises if the inputs do not fit the kernel
    or the launch fails. On the CPU it runs the plain version."""
    _check(t, b)
    acc = t.policy.accum_dtype
    if t.device.type == "cpu":
        y = tri_solve_plain(t, b)
        if out is not None:
            out[:t.n] = y
            y = out
        return y
    if t.device.type != "cuda":
        raise ValueError(f"no triangular solve for device {t.device}")
    if out is None:
        out = torch.empty_like(b)
    elif out.dtype != acc or out.device != t.device or out.dim() != 1 or out.numel() < t.n \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {acc} vector of at least {t.n} on {t.device}")
    if t.n:
        _launch(t, b, out, 0)
    return out


def _tri_solve_flags(t: DeviceTri, b: torch.Tensor) -> torch.Tensor:
    """The same solve on a CUDA device with each row waiting on its columns'
    ready values instead of a level's counter (mode 1). Measured slower on
    the card (PERF.md), so the package never calls it; ``chip_smoke.py``
    times it beside :func:`tri_solve`."""
    _check(t, b)
    if t.device.type != "cuda":
        raise ValueError("the ready-value wait runs on a CUDA device only")
    out = torch.empty_like(b)
    if t.n:
        _launch(t, b, out, 1)
    return out


def link_latency(device: Union[str, torch.device] = "cuda",
                 rounds: int = 20000) -> Tuple[float, int, int]:
    """The card's one-way hand-over through L2, in seconds: two single-thread
    blocks on two SMs bounce a flag ``rounds`` times by release and acquire
    (``respa_link_probe``), timed by the card's global timer, halved. Also
    the two SM ids. A measurement: it waits for the card."""
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    if flag.device.type != "cuda":
        raise ValueError("the link probe runs on a CUDA device only")
    out = torch.zeros(3, dtype=torch.int64, device=flag.device)
    rc = _library().respa_link_probe(flag.device.index, rounds, flag.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream(flag.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"respa_link_probe launch failed: cudaError {rc}")
    ns, sm_a, sm_b = out.tolist()
    return ns * 1e-9 / (2 * rounds), int(sm_a), int(sm_b)


@dataclasses.dataclass
class JacobiTri:
    """Triangular apply by fixed-point (Jacobi) sweeps over the strict
    triangle, or (``isai``) one product with an approximate inverse.

    With T = D + N (N strictly triangular), iterate y <- D^-1 (b - N y). N is
    nilpotent, so the iteration is exact after depth(T) sweeps and a fixed
    ``sweeps`` count is a *linear* operator -- a valid (approximate-inverse)
    preconditioner. Each sweep is one CSR SpMV. With ``isai`` the operator
    ``strict`` is the approximate inverse M itself and ``dinv`` is ones.
    """

    n: int
    sweeps: int
    strict: Optional[DeviceCsr]  # None when the triangle is diagonal
    dinv: torch.Tensor  # [n] reciprocal diagonal, the policy's value type
    policy: Policy
    isai: bool = False


def _single_word(policy: Policy, what: str) -> None:
    if policy.dtype == torch.float64:
        raise ValueError(f"{what} is a single-word fast path")


def jacobi_tri(t_csr: CSRMatrix, lower: bool = True, unit_diag: bool = False,
               sweeps: int = 6, policy: Union[str, Policy] = "fp32",
               device: Union[str, torch.device] = "cuda") -> JacobiTri:
    """Build the sweep-apply operator from a triangular CSR factor."""
    policy = get_policy(policy)
    _single_word(policy, "JacobiTri")
    strict, diag = _strict_and_diag(t_csr, lower, unit_diag)
    safe = np.where(diag == 0.0, 1.0, diag)
    dv = policy.cast_host(1.0 / safe).to(torch.device(device))
    dev = to_device(strict, policy, device, fmt="csr") if strict.nnz else None
    return JacobiTri(n=t_csr.nrows, sweeps=sweeps, strict=dev, dinv=dv, policy=policy)


def _jacobi_apply(t: JacobiTri, b: torch.Tensor) -> torch.Tensor:
    acc, fl = t.policy.accum_dtype, t.policy.flush_to_zero
    dv = t.dinv.to(acc)
    bd = ftz(ftz(b.to(acc), fl) * dv, fl)
    if t.strict is None:
        return bd
    y = bd
    for _ in range(t.sweeps):
        y = ftz(bd - ftz(dv * spmv(t.strict, y), fl), fl)
    return y


def isai_tri(t_csr: CSRMatrix, lower: bool = True, unit_diag: bool = False,
             policy: Union[str, Policy] = "fp32",
             device: Union[str, torch.device] = "cuda") -> JacobiTri:
    """Incomplete Sparse Approximate Inverse of a triangular factor.

    Builds M with sparsity(M) = sparsity(T) such that (M T)|_S = I on the
    pattern: per row i, solve the small dense system T[S_i,S_i]^T m = e_i
    (host, once). The apply is then a single SpMV (Anzt et al.). Returned as
    a JacobiTri with sweeps=0 whose ``strict`` operator is M itself and
    dinv = 1.
    """
    policy = get_policy(policy)
    _single_word(policy, "ISAI")
    n = t_csr.nrows
    indptr, indices, data = t_csr.indptr, t_csr.indices, t_csr.data
    mvals = np.zeros_like(data, dtype=np.float64)
    # rows batched by equal length; dense T[S,S] lookups through one
    # searchsorted into the globally sorted (row, col) key array
    indptr64 = indptr.astype(np.int64)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr64))
    gkeys = rows_all * np.int64(n + 1) + indices.astype(np.int64)
    lens = np.diff(indptr64)
    for k in np.unique(lens):
        k = int(k)
        if k == 0:
            continue
        R = np.flatnonzero(lens == k)
        for c0 in range(0, R.size, 16384):
            Rc = R[c0:c0 + 16384]
            offs = indptr64[Rc][:, None] + np.arange(k)[None, :]
            S = indices[offs].astype(np.int64)            # (b, k)
            qk = (S[:, :, None] * np.int64(n + 1)
                  + S[:, None, :])                         # (b, t, j)
            pos = np.searchsorted(gkeys, qk.reshape(-1))
            pos = np.minimum(pos, gkeys.size - 1)
            hit = gkeys[pos] == qk.reshape(-1)
            sub = np.where(hit, data[pos], 0.0).reshape(-1, k, k)
            if unit_diag:
                sub[:, np.arange(k), np.arange(k)] = 1.0
            dpos = (S == Rc[:, None]).argmax(axis=1)
            ei = np.zeros((Rc.size, k))
            ei[np.arange(Rc.size), dpos] = 1.0
            try:
                m = np.linalg.solve(sub.transpose(0, 2, 1), ei[..., None])[..., 0]
            except np.linalg.LinAlgError:
                # singular submatrix somewhere in the batch: row by row
                m = np.empty((Rc.size, k))
                for r in range(Rc.size):
                    try:
                        m[r] = np.linalg.solve(sub[r].T, ei[r])
                    except np.linalg.LinAlgError:
                        m[r] = ei[r]
            mvals[offs.reshape(-1)] = m.reshape(-1)
    mcsr = CSRMatrix(t_csr.shape, indptr, indices, mvals)
    dev = to_device(mcsr, policy, device, fmt="csr")
    return JacobiTri(n=n, sweeps=0, strict=dev, dinv=policy.cast_host(np.ones(n)).to(dev.device),
                     policy=policy, isai=True)


def sptrsv(t, b: torch.Tensor) -> torch.Tensor:
    """Solve T y = b under the factor's precision policy: exactly for a
    :class:`DeviceTri` (:func:`tri_solve`), by the sweeps or the approximate
    inverse of a :class:`JacobiTri`. b is taken in the accumulator type; y
    comes back in it."""
    if isinstance(t, JacobiTri):
        if t.isai:
            return spmv(t.strict, b.to(t.policy.accum_dtype).contiguous())
        return _jacobi_apply(t, b)
    return tri_solve(t, b.to(t.policy.accum_dtype).contiguous())


def sptrsv_host_reference(l_csr: CSRMatrix, b: np.ndarray, lower: bool = True,
                          unit_diag: bool = False) -> np.ndarray:
    """Host fp64 oracle: plain forward/backward substitution."""
    n = l_csr.nrows
    y = np.zeros(n, dtype=np.float64)
    rows = range(n) if lower else range(n - 1, -1, -1)
    for i in rows:
        s, e = l_csr.indptr[i], l_csr.indptr[i + 1]
        cols = l_csr.indices[s:e]
        vals = l_csr.data[s:e]
        acc = b[i]
        diag = 1.0
        for c_, v in zip(cols, vals):
            if c_ == i:
                diag = v
            else:
                acc -= v * y[c_]
        y[i] = acc / (1.0 if unit_diag else diag)
    return y
