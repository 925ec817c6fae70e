"""Sparse triangular solves on the card: the exact solve and the approximate
applies of the ILU(0) preconditioner.

The counterpart of ``respatpu/kernels/sptrsv.py``; it replaces
``cusparseXcsrsv2_solve`` (GPU/ilu0.cu:284-310).

* The exact solve, ``y = T^-1 b``, is one launch of a hand-written CUDA
  kernel (``csrc/sptrsv.cu``, K7) with no level loop: warps take rows from an
  atomic ticket in dependency order and wait on per-row ready flags, which
  are zeroed for every launch on its stream. It reads the strict triangle as
  CSR and the reciprocal diagonal ``dinv`` made on the host; respatpu's
  chunked schedule and 8 x 8 blocklets (``build_tri_chunks``,
  ``_pack_blocklets``) exist for a chip without gathers and are not ported.
  Its plain PyTorch version, :func:`tri_solve_plain`, goes level by level
  (one step a level of :func:`respatpu_torch.analysis.level_schedule`) and
  sums each row in the kernel's order, so the two agree bit for bit.
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
from typing import Optional, Union

import numpy as np
import torch

from ..analysis import level_schedule
from ..formats import COOMatrix, CSRMatrix, coo_to_csr
from ..precision import Policy, ftz, get_policy
from .spmv import DeviceCsr, spmv, to_device

__all__ = ["DeviceTri", "JacobiTri", "tri_to_device", "tri_solve", "tri_solve_plain",
           "jacobi_tri", "isai_tri", "sptrsv", "sptrsv_host_reference", "LAUNCHES"]

_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}

# Kernel launches per entry point, raised by ``tri_solve`` right after each
# launch succeeds and nowhere else.
LAUNCHES = {f"respa_tri_solve_{d}_{i}": 0 for d in ("lower", "upper") for i in _INST.values()}


@dataclasses.dataclass
class DeviceTri:
    """A triangular factor T = D + N on one device: the strict triangle N as
    a CSR matrix (the SpMV kernel's upload, which K7 reads too) and the
    reciprocal diagonal (the policy's value type; ones for a unit diagonal,
    1 where the diagonal is 0)."""

    n: int
    lower: bool
    strict: DeviceCsr
    dinv: torch.Tensor
    _levels: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def policy(self) -> Policy:
        return self.strict.policy

    @property
    def device(self) -> torch.device:
        return self.strict.device


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
    and ``dinv``, the reciprocal of the diagonal formed in fp64 on the host
    (a zero diagonal read as 1; ones with ``unit_diag``), both under
    ``policy``. ``values`` overrides ``t_csr.data`` (same pattern)."""
    policy = get_policy(policy)
    strict, diag = _strict_and_diag(t_csr, lower, unit_diag, values)
    dinv = 1.0 / np.where(diag == 0.0, 1.0, diag)
    dev = to_device(strict, policy, device)
    return DeviceTri(n=t_csr.nrows, lower=lower, strict=dev,
                     dinv=policy.cast_host(dinv).to(dev.device))


def _levels(t: DeviceTri):
    """The plain solve's schedule, made once a factor. Rows go by level. A
    level whose rows hold at most 32 strict entries each (a lane an entry, as
    the kernel's warp takes them) gets a dense [rows, 32] gather of its
    entries, the empty lanes pointing at a zero entry; any other level keeps
    its entries by step (the kernel's lane l takes a row's entries l, l + 32,
    ...: step = position // 32), each with the slot ``32 * (row's rank in
    its level) + lane`` of its partial sum. Returns ``(rows, levels, lay,
    order, slot)``, ``levels`` holding ``(r0, r1, dense, where, most)`` a
    level: its rows ``rows[r0:r1]``, the most strict entries one of them
    holds, and its entries: dense, ``lay[where : where + 32 * (r1 - r0)]``;
    else ``where`` lists the ``(e0, e1)`` runs of ``order`` and ``slot``, one
    a step."""
    if t._levels is None:
        indptr = t.strict.indptr.cpu().numpy()
        indices = t.strict.indices.cpu().numpy()
        n = t.n
        nnz = indices.size
        level = level_schedule(CSRMatrix((n, n), indptr, indices, np.zeros(nnz)),
                               upper=not t.lower).astype(np.int64)
        rows = np.argsort(level, kind="stable")
        nlev = int(level.max()) + 1 if n else 0
        level_ptr = np.zeros(nlev + 1, np.int64)
        np.cumsum(np.bincount(level, minlength=nlev), out=level_ptr[1:])
        rank = np.empty(n, np.int64)
        rank[rows] = np.arange(n) - level_ptr[level[rows]]
        lens = np.diff(indptr)
        most = np.zeros(nlev, np.int64)
        np.maximum.at(most, level, lens)
        dense = most <= 32
        ent_row = np.repeat(np.arange(n, dtype=np.int64), lens)
        pos = np.arange(nnz, dtype=np.int64) - indptr[ent_row]
        ent_level = level[ent_row]
        # dense levels: entry e of row r at lay[base[level] + 32 * rank[r] + lane]
        size = np.where(dense, 32 * np.diff(level_ptr), 0)
        base = np.zeros(nlev + 1, np.int64)
        np.cumsum(size, out=base[1:])
        lay = np.full(int(base[-1]), nnz, np.int64)  # nnz: the zero entry
        dn = dense[ent_level]
        lay[base[ent_level[dn]] + 32 * rank[ent_row[dn]] + pos[dn]] = np.flatnonzero(dn)
        # the other levels: entries by (level, step), each with its slot
        sp = np.flatnonzero(~dn)
        order = sp[np.lexsort((pos[sp], ent_row[sp], pos[sp] // 32, ent_level[sp]))]
        slot = rank[ent_row[order]] * 32 + pos[order] % 32
        key = ent_level[order] * (nnz + 1) + pos[order] // 32
        starts = np.flatnonzero(np.r_[True, np.diff(key) != 0]) if key.size else np.zeros(0, int)
        ends = np.r_[starts[1:], key.size].astype(np.int64)
        runs = [[] for _ in range(nlev)]
        for s0, s1 in zip(starts.tolist(), ends.tolist()):
            runs[int(ent_level[order[s0]])].append((s0, s1))
        levels = [(int(level_ptr[v]), int(level_ptr[v + 1]), bool(dense[v]),
                   int(base[v]) if dense[v] else runs[v], int(most[v]))
                  for v in range(nlev)]
        dev = t.device

        def put(v):
            return torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(dev)

        t._levels = (put(rows), levels, put(lay), put(order), put(slot))
    return t._levels


def _tree(s: torch.Tensor, fl: bool) -> torch.Tensor:
    """Lane 0's sum of a warp's 32 partials [rows, 32], as the kernel's
    shuffles take it: a halving tree."""
    off = 16
    while off:
        s = ftz(s[:, :off] + s[:, off:2 * off], fl)
        off //= 2
    return s[:, 0]


def tri_solve_plain(t: DeviceTri, b: torch.Tensor) -> torch.Tensor:
    """The solve kernel's function in plain torch ops, on any device: level
    by level, each row's products summed as the kernel's warp sums them (a
    partial a lane over the entries l, l + 32, ... in order, starting from
    +0, then a halving tree over the 32 partials), every product and sum
    rounded on its own and flushed under fp32_ftz, then ``y_i = (b_i - sum)
    * dinv_i`` (rounded to bf16 once under bf16). A row with one entry sums
    to its product + 0, which the tree's further + 0 leave as it is."""
    p = t.policy
    acc, fl = p.accum_dtype, p.flush_to_zero
    rows, levels, lay, order, slot = _levels(t)
    zero = torch.zeros(1, dtype=acc, device=t.device)
    vals = torch.cat([t.strict.vals.to(acc), zero])  # entry nnz: the zero entry
    cols = torch.cat([t.strict.indices.long(), torch.full((1,), t.n, device=t.device)])
    svals, scols = vals[order], cols[order]
    dinv = t.dinv.to(acc)
    bf = ftz(b.to(acc), fl)
    y = torch.zeros(t.n + 1, dtype=acc, device=t.device)  # y[n] = 0: the zero entry's column
    for r0, r1, dense, where, most in levels:
        r = rows[r0:r1]
        if dense:
            e = lay[where:where + 32 * (r1 - r0)]
            part = ftz(ftz(vals[e] * y[cols[e]], fl) + 0.0, fl).view(-1, 32)
            v = ftz(bf[r] - (part[:, 0] if most == 1 else _tree(part, fl)), fl)
        else:
            part = torch.zeros((r1 - r0) * 32, dtype=acc, device=t.device)
            for e0, e1 in where:
                sl = slot[e0:e1]
                part[sl] = ftz(part[sl] + ftz(svals[e0:e1] * y[scols[e0:e1]], fl), fl)
            v = ftz(bf[r] - _tree(part.view(-1, 32), fl), fl)
        v = ftz(v * dinv[r], fl)
        y[r] = v.to(p.dtype).to(acc) if p.dtype == torch.bfloat16 else v
    return y[:t.n]


def tri_solve(t: DeviceTri, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = T^-1 b exactly, b and y in the policy's accumulator type on the
    factor's device (``out``, if given: at least n long, only its first n
    written); see :func:`tri_solve_plain`.

    On a CUDA device this is one launch of the solve kernel on the current
    stream, with ready flags and ticket zeroed for it on that stream; it
    raises if the inputs do not fit the kernel or the launch fails. On the
    CPU it runs the plain version."""
    p = t.policy
    acc = p.accum_dtype
    if b.dtype != acc or b.device != t.device or b.shape != (t.n,) or not b.is_contiguous():
        raise ValueError(f"b must be contiguous {acc} of shape ({t.n},) on {t.device}")
    if (t.dinv.dtype != p.dtype or t.dinv.shape != (t.n,) or t.dinv.device != t.device
            or t.strict.shape != (t.n, t.n)):
        raise ValueError("DeviceTri arrays do not match its policy, size and device")
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
    if t.n == 0:
        return out
    flags = torch.zeros(t.n + 1, dtype=torch.int32, device=t.device)
    from . import _build
    name = f"respa_tri_solve_{'lower' if t.lower else 'upper'}_{_INST[p.name]}"
    s = t.strict
    rc = getattr(_build.load(), name)(
        t.device.index, t.n, s.indptr.data_ptr(), s.indices.data_ptr(), s.vals.data_ptr(),
        t.dinv.data_ptr(), b.data_ptr(), out.data_ptr(), flags.data_ptr(),
        torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


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
    dev = to_device(strict, policy, device) if strict.nnz else None
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
    dev = to_device(mcsr, policy, device)
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
