"""Diagonal-format (DIA) SpMV on the card, the stencil path.

The counterpart of ``respatpu/kernels/dia.py``. Stencil and near-stencil
matrices (5-, 7- and 27-point Laplacians: ecology2, atmosmodd, tmt_unsym,
parabolic_fem class) keep their dense diagonals as ``[ndiag, n]`` values,

    y_i = sum_k d[k, i] * x[i + off_k]  (+ r_i)

with no index stream at all: below the CSR byte model. ``build_dia`` picks the
diagonals worth densifying (occupancy >= ``min_fill``); the entries on no
stored diagonal form a remainder (respatpu gives it its ELL path), which goes
to the card as compact CSR over the rows that have entries
(:class:`DiaRemainder`) and is summed by the same kernel: r_i, row i's
remainder products one after the other in CSR order from +0 (the CSR kernel
K0's order for a row among short rows), added last.

:func:`dia_spmv` is one launch of a hand-written CUDA kernel
(``csrc/dia.cu``, K9): a thread a row, the diagonals in ascending offset order
from +0, x read as 0 outside its columns, every product and sum rounded on its
own, then the remainder. Its plain PyTorch version, :func:`dia_spmv_plain`,
sums in the same order, so the two agree bit for bit. ``dia_spmv`` launches
the kernel for CUDA tensors and runs the plain version for CPU tensors;
nothing else chooses.

Instances as the CSR kernel's: fp32, fp32_ftz (x, every product, partial sum
and the result flushed), bf16 (bf16 values, x and the sums in fp32: the
port's policy; respatpu's DIA rounds x to bf16 and sums in bf16, reference
fault R10) and fp64.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..formats import COOMatrix, CSRMatrix, coo_to_csr
from ..precision import Policy, ftz, get_policy

__all__ = ["DiaMatrix", "diagonals", "dia_coverage", "build_dia", "DiaRemainder", "DeviceDia",
           "dia_to_device", "dia_spmv", "dia_spmv_plain", "LAUNCHES", "MAX_DIAGS", "TILE"]

_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}

# Kernel launches per entry point, raised by ``dia_spmv`` right after each
# launch succeeds and nowhere else.
LAUNCHES = {f"respa_dia_spmv_{i}": 0 for i in _INST.values()}

MAX_DIAGS = 512  # the most diagonals build_dia keeps (and csrc/dia.cu takes)
TILE = 256  # rows a thread block of csrc/dia.cu takes; the remainder's tile_ptr is cut for it


@dataclasses.dataclass
class DiaMatrix:
    """Host DIA + CSR remainder."""

    n: int
    ncols: int
    offsets: np.ndarray  # int64[ndiag], ascending
    diags: np.ndarray  # float64[ndiag, n]; diags[k, i] = A[i, i + off_k]
    remainder: Optional[CSRMatrix]  # entries on no stored diagonal
    nnz_dia: int


class Diagonals(NamedTuple):
    rows: np.ndarray  # int64[nnz]: each entry's row
    key: np.ndarray  # int64[nnz]: each entry's column - row + nrows - 1 (>= 0)
    uniq: np.ndarray  # int64: the offsets that hold entries, ascending
    counts: np.ndarray  # int64: their entries


def diagonals(a: CSRMatrix) -> Diagonals:
    """Each entry's row and diagonal (as its offset + nrows - 1), and the
    offsets in use with their counts: one pass over the entries and a count
    over the nrows + ncols - 1 possible offsets (no sort)."""
    shift = max(a.nrows - 1, 0)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())
    key = np.subtract(a.indices, rows, dtype=np.int64)
    key += shift
    counts = np.bincount(key, minlength=max(a.nrows + a.shape[1] - 1, 0))
    uniq = np.flatnonzero(counts)
    return Diagonals(rows, key, uniq - shift, counts[uniq])


def dia_coverage(a: CSRMatrix, min_fill: float = 0.25, diag: Optional[Diagonals] = None):
    """Which diagonals are worth densifying (occupancy >= ``min_fill`` of the
    rows), and the share of the entries they hold. ``diag``: ``a``'s
    :func:`diagonals`, if already made."""
    d = diagonals(a) if diag is None else diag
    keep = d.counts >= max(1, int(min_fill * a.nrows))
    return d.uniq[keep], d.counts[keep].sum() / max(a.nnz, 1)


def build_dia(a: CSRMatrix, min_fill: float = 0.25, max_diags: int = MAX_DIAGS,
              diag: Optional[Diagonals] = None) -> DiaMatrix:
    """The DIA form of ``a``: up to ``max_diags`` of its most populous
    diagonals with occupancy >= ``min_fill``, ascending, and the rest as a
    CSR remainder (None when every entry lies on a stored diagonal).
    ``diag``: ``a``'s :func:`diagonals`, if already made."""
    n, ncols = a.shape
    rows, key, uniq, counts = diagonals(a) if diag is None else diag
    order = np.argsort(-counts)[:max_diags]
    keep = np.sort(uniq[order][counts[order] >= max(1, int(min_fill * n))])
    slot = np.full(max(n + ncols - 1, 0), -1, dtype=np.int64)  # stored diagonal of each offset
    slot[keep + max(n - 1, 0)] = np.arange(keep.size)
    k = slot[key]
    on_dia = k >= 0
    n_rem = int(a.nnz - np.count_nonzero(on_dia))
    diags = np.zeros((keep.size, n), dtype=np.float64)
    flat = k * n + rows
    if n_rem:
        diags.reshape(-1)[flat[on_dia]] = a.data[on_dia]
    else:
        diags.reshape(-1)[flat] = a.data
    rem = None
    if n_rem:
        off = ~on_dia
        rem = coo_to_csr(COOMatrix(a.shape, rows[off].astype(np.int32), a.indices[off].copy(),
                                   a.data[off].copy()))
    return DiaMatrix(n=n, ncols=ncols, offsets=keep, diags=diags, remainder=rem,
                     nnz_dia=int(a.nnz - n_rem))


@dataclasses.dataclass
class DiaRemainder:
    """The entries on no stored diagonal, on the device as K9 reads them:
    compact CSR over the rows that have any, and for each tile of TILE rows
    the first of those rows at or after it."""

    rows: torch.Tensor  # int32[nr]: the rows, ascending
    ptr: torch.Tensor  # int64[nr + 1]: row r's entries
    cols: torch.Tensor  # int32[nnz]
    vals: torch.Tensor  # policy.dtype[nnz]
    tile_ptr: torch.Tensor  # int32[ceil(n / TILE) + 1]

    @property
    def nnz(self) -> int:
        return int(self.cols.numel())

    @property
    def nrows(self) -> int:
        return int(self.rows.numel())


@dataclasses.dataclass
class DeviceDia:
    """The stored diagonals on one device, under a precision policy."""

    n: int
    ncols: int
    offsets: torch.Tensor  # int64[ndiag], ascending
    diags: torch.Tensor  # policy.dtype[ndiag, n]
    policy: Policy
    rem: Optional[DiaRemainder] = None

    @property
    def device(self) -> torch.device:
        return self.diags.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.ncols)

    @property
    def ndiag(self) -> int:
        return int(self.offsets.numel())


def dia_to_device(d: DiaMatrix, policy: Union[str, Policy] = "fp32",
                  device: Union[str, torch.device] = "cuda") -> DeviceDia:
    policy = get_policy(policy)
    if d.offsets.size > MAX_DIAGS:
        raise ValueError(f"at most {MAX_DIAGS} diagonals, got {d.offsets.size}")
    if max(d.n, d.ncols) >= 2 ** 31:
        raise ValueError("the remainder's rows and columns are int32: n and ncols must be < 2^31")
    device = torch.device(device)
    diags = policy.cast_host(np.ascontiguousarray(d.diags).reshape(-1)).reshape(d.diags.shape)
    rem = None
    if d.remainder is not None:
        r = d.remainder
        rows = np.flatnonzero(np.diff(r.indptr)).astype(np.int32)
        ptr = np.r_[r.indptr[rows], r.indptr[-1]].astype(np.int64)
        tiles = np.searchsorted(rows, np.arange(-(-d.n // TILE) + 1, dtype=np.int64) * TILE)
        rem = DiaRemainder(rows=torch.from_numpy(rows).to(device),
                           ptr=torch.from_numpy(ptr).to(device),
                           cols=torch.from_numpy(np.ascontiguousarray(r.indices, np.int32)).to(device),
                           vals=policy.cast_host(r.data).to(device),
                           tile_ptr=torch.from_numpy(tiles.astype(np.int32)).to(device))
    return DeviceDia(n=d.n, ncols=d.ncols,
                     offsets=torch.from_numpy(np.ascontiguousarray(d.offsets, np.int64)).to(device),
                     diags=diags.to(device).contiguous(), policy=policy, rem=rem)


def dia_spmv_plain(d: DeviceDia, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device: the
    diagonals' products added one after the other in ascending offset order
    from +0 (x read as 0 outside its columns), then on each remainder row its
    products one after the other in CSR order from +0, added last; every
    product and sum rounded on its own and flushed under fp32_ftz."""
    p = d.policy
    acc, fl = p.accum_dtype, p.flush_to_zero
    xv = ftz(x.to(acc), fl)
    zero = torch.zeros((), dtype=acc, device=d.device)
    rows = torch.arange(d.n, device=d.device)
    y = torch.zeros(d.n, dtype=acc, device=d.device)
    for k, off in enumerate(d.offsets.tolist()):
        c = rows + off
        inside = (c >= 0) & (c < d.ncols)
        xs = (torch.where(inside, xv[c.clamp(0, d.ncols - 1)], zero) if d.ncols
              else torch.zeros(d.n, dtype=acc, device=d.device))
        y = ftz(y + ftz(d.diags[k].to(acc) * xs, fl), fl)
    r = d.rem
    if r is not None and r.nrows:
        start, lens = r.ptr[:-1], torch.diff(r.ptr)
        rs = torch.zeros(r.nrows, dtype=acc, device=d.device)
        for m in range(int(lens.max())):
            live = lens > m
            e = torch.where(live, start + m, torch.zeros_like(start))
            rs = torch.where(live, ftz(rs + ftz(r.vals[e].to(acc) * xv[r.cols[e].long()], fl), fl),
                             rs)
        rr = r.rows.long()
        y[rr] = ftz(y[rr] + rs, fl)
    return y


def dia_spmv(d: DeviceDia, x: torch.Tensor) -> torch.Tensor:
    """y = D x under the matrix's policy, the remainder included; x and y in
    the policy's accumulator type.

    On a CUDA device this is one launch of the DIA kernel on the current
    stream; it raises if the inputs do not fit the kernel or the launch
    fails. On the CPU it runs :func:`dia_spmv_plain`."""
    p = d.policy
    acc = p.accum_dtype
    if x.dtype != acc:
        raise TypeError(f"{p.name} DIA SpMV takes x as {acc}, got {x.dtype}")
    if x.device != d.device or x.shape != (d.ncols,) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {acc} of shape ({d.ncols},) on {d.device}")
    arrays = (d.offsets, d.diags)
    r = d.rem
    if r is not None:
        arrays += (r.rows, r.ptr, r.cols, r.vals, r.tile_ptr)
        if (r.rows.dtype != torch.int32 or r.ptr.dtype != torch.int64
                or r.cols.dtype != torch.int32 or r.vals.dtype != p.dtype
                or r.tile_ptr.dtype != torch.int32 or r.ptr.shape != (r.nrows + 1,)
                or r.vals.shape != r.cols.shape or r.tile_ptr.shape != (-(-d.n // TILE) + 1,)):
            raise ValueError("DiaRemainder arrays do not match its policy and shape")
    if (d.diags.dtype != p.dtype or d.diags.shape != (d.ndiag, d.n)
            or d.offsets.dtype != torch.int64
            or any(t.device != d.device or not t.is_contiguous() for t in arrays)):
        raise ValueError("DeviceDia arrays do not match its policy, shape and device")
    if d.device.type == "cpu":
        return dia_spmv_plain(d, x)
    if d.device.type != "cuda":
        raise ValueError(f"no DIA SpMV for device {d.device}")
    y = torch.empty(d.n, dtype=acc, device=d.device)
    if d.n == 0:
        return y
    from . import _build
    name = f"respa_dia_spmv_{_INST[p.name]}"
    rem = ((None,) * 5 if r is None else
           (r.tile_ptr.data_ptr(), r.rows.data_ptr(), r.ptr.data_ptr(), r.cols.data_ptr(),
            r.vals.data_ptr()))
    rc = getattr(_build.load(), name)(
        d.device.index, d.n, d.ncols, d.ndiag, d.offsets.data_ptr(), d.diags.data_ptr(),
        x.data_ptr(), TILE, *rem, y.data_ptr(), torch.cuda.current_stream(d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return y
