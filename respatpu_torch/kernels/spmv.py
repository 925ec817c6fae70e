"""CSR SpMV on the card: upload under a precision policy, the kernel's
wrapper, and its plain PyTorch version.

The counterpart of ``respatpu/kernels/spmv.py``, ``gsell.py`` and
``gsell_df.py``. One hand-written CUDA kernel (``csrc/spmv_csr.cu``, row-block
streaming) replaces both GSELL Pallas kernels, in four instances:

========  ===========  ======  ===========  ==========================
policy    values       x       accumulator  flush
========  ===========  ======  ===========  ==========================
fp32      f32          f32     f32          none
fp32_ftz  f32          f32     f32          x, products, partial sums
bf16      bf16         f32     f32          none
fp64      f64          f64     f64          none
========  ===========  ======  ===========  ==========================

``spmv`` launches the kernel for a matrix on a CUDA device and runs
``spmv_plain`` for one on the CPU; nothing else chooses between them.

Stencil matrices may take the DIA kernel instead (``kernels/dia.py``, K9):
``to_device(fmt="dia")`` gives a :class:`~respatpu_torch.kernels.dia.DeviceDia`,
the stored diagonals and the remainder that the DIA kernel sums too, and
``fmt="auto"`` picks it by respatpu's rule (diagonals of occupancy >= 0.25
cover >= 90% of the entries, with at most 3x padding); ``spmv`` dispatches on
the type.

The kernel gives one thread block to each group of consecutive rows that
``row_blocks`` cuts from the row pointer at upload: at most ``CAP`` entries
and ``MAX_ROWS`` rows a group, a longer row alone in its group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..formats import CSRMatrix
from ..precision import Policy, ftz, get_policy
from ..timing import spmv_csr_sol_bytes
from .dia import DeviceDia, build_dia, dia_coverage, dia_spmv, dia_to_device, diagonals

__all__ = ["DeviceCsr", "DeviceDia", "to_device", "row_blocks", "spmv", "spmv_plain",
           "spmv_sol_bytes", "spmv_csr_reference", "LAUNCHES", "CAP", "MAX_ROWS"]

# The kernel's compile-time sizes (kCap and kMaxRows of csrc/spmv_csr.cu):
# the entries a block streams through shared memory, and the rows it reduces.
# ``spmv`` checks them against the built library.
CAP = 2048
MAX_ROWS = 256

# Kernel launches per instance, raised by ``spmv`` right after each launch
# succeeds and nowhere else; read (and reset) by callers that must show
# which instances ran.
LAUNCHES = {"fp32": 0, "fp32_ftz": 0, "bf16": 0, "fp64": 0}

_ENTRY = {"fp32": "respa_spmv_csr_f32", "fp32_ftz": "respa_spmv_csr_f32_ftz",
          "bf16": "respa_spmv_csr_bf16", "fp64": "respa_spmv_csr_f64"}

_TPU_ONLY = ("gsell", "bell", "rgell", "ell")


@dataclasses.dataclass
class DeviceCsr:
    """A CSR matrix on one device, stored under a precision policy."""

    indptr: torch.Tensor  # int64[m+1]
    indices: torch.Tensor  # int32[nnz]
    vals: torch.Tensor  # policy.dtype[nnz]
    row_blocks: torch.Tensor  # int32[blocks+1], see :func:`row_blocks`
    policy: Policy
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def row_blocks(indptr: np.ndarray, cap: int = CAP, max_rows: int = MAX_ROWS) -> np.ndarray:
    """Cut the rows of a CSR row pointer into the kernel's blocks.

    Returns int32 ``b`` with ``b[0] = 0`` and ``b[-1] = m``: block ``i`` is
    rows ``b[i]:b[i+1]``. Rows are taken greedily in order while the block
    holds at most ``cap`` entries and ``max_rows`` rows; a row longer than
    ``cap`` is a block of its own (the kernel's long-row path). A function
    of ``indptr`` alone.
    """
    indptr = np.asarray(indptr, np.int64)
    m = indptr.size - 1
    bounds = [0]
    r0 = 0
    while r0 < m:
        # the last row boundary within cap entries of this block's first
        r1 = int(np.searchsorted(indptr, indptr[r0] + cap, side="right")) - 1
        r0 = max(min(r1, r0 + max_rows, m), r0 + 1)
        bounds.append(r0)
    return np.asarray(bounds, np.int32)


def to_device(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
              device: Union[str, torch.device] = "cuda",
              fmt: str = "auto") -> Union[DeviceCsr, DeviceDia]:
    """Upload host CSR to ``device`` under ``policy``.

    ``fmt``: "csr" gives CSR; "dia" the stencil path (:class:`DeviceDia`,
    with its remainder); "auto" (the default) DIA when diagonals of
    occupancy >= 0.25 cover at least 90% of the entries and store at most 3
    values an entry, as respatpu chooses (``respatpu/kernels/spmv.py``), and
    CSR otherwise. GSELL, BELL, RG-ELL and the padded ELL are TPU-only
    layouts that the port replaces with CSR, since the card gathers in
    hardware.
    """
    policy = get_policy(policy)
    if fmt in _TPU_ONLY:
        raise ValueError(f"fmt={fmt!r} is a TPU-only layout and is not ported; "
                         "use fmt='csr'")
    if fmt not in ("auto", "csr", "dia"):
        raise ValueError(f"unknown fmt {fmt!r}")
    diag = diagonals(a) if fmt != "csr" else None
    if fmt == "auto":
        offs, cov = dia_coverage(a, diag=diag)
        waste = len(offs) * a.shape[0] / max(a.nnz, 1)
        fmt = "dia" if cov >= 0.90 and waste <= 3.0 else "csr"
    if fmt == "dia":
        return dia_to_device(build_dia(a, diag=diag), policy, device)
    m, n = a.shape
    if a.nnz >= 2 ** 31 or n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError("column and row-block indices are int32: nnz, nrows "
                         "and ncols must be < 2^31")
    device = torch.device(device)
    return DeviceCsr(
        indptr=torch.from_numpy(np.ascontiguousarray(a.indptr, np.int64)).to(device),
        indices=torch.from_numpy(np.ascontiguousarray(a.indices, np.int32)).to(device),
        vals=policy.cast_host(a.data).to(device),
        row_blocks=torch.from_numpy(row_blocks(a.indptr)).to(device),
        policy=policy, shape=(m, n))


_lib = None


def _library():
    """The built kernel library, once its sizes are known to match ours."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load()
        sizes = (lib.respa_spmv_csr_cap(), lib.respa_spmv_csr_max_rows())
        if sizes != (CAP, MAX_ROWS):
            raise RuntimeError(f"spmv_csr.cu was built for (cap, max rows) = {sizes}, "
                               f"row_blocks cuts for {(CAP, MAX_ROWS)}")
        _lib = lib
    return _lib


def spmv(dev: Union[DeviceCsr, DeviceDia], x: torch.Tensor) -> torch.Tensor:
    """y = A x under the matrix's policy; y has the policy's accumulator type.

    On a CUDA device this launches the CSR kernel on the current stream and
    raises if the inputs do not fit it or the launch fails. On the CPU it
    runs :func:`spmv_plain`. A :class:`DeviceDia` goes to the DIA kernel
    (:func:`~respatpu_torch.kernels.dia.dia_spmv`).
    """
    if isinstance(dev, DeviceDia):
        return dia_spmv(dev, x)
    if dev.device.type == "cpu":
        return spmv_plain(dev, x)
    if dev.device.type != "cuda":
        raise ValueError(f"no SpMV for device {dev.device}")
    p = dev.policy
    m, n = dev.shape
    if x.dtype != p.accum_dtype:
        raise TypeError(f"{p.name} SpMV takes x as {p.accum_dtype}, got {x.dtype}")
    if x.device != dev.device:
        raise ValueError(f"x is on {x.device}, the matrix on {dev.device}")
    if x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous of shape ({n},), got {tuple(x.shape)}")
    arrays = (dev.indptr, dev.indices, dev.vals, dev.row_blocks)
    if (dev.indptr.dtype != torch.int64 or dev.indices.dtype != torch.int32
            or dev.vals.dtype != p.dtype or dev.indptr.shape != (m + 1,)
            or dev.vals.shape != dev.indices.shape
            or dev.row_blocks.dtype != torch.int32 or dev.row_blocks.dim() != 1
            or any(t.device != dev.device or not t.is_contiguous() for t in arrays)):
        raise ValueError("DeviceCsr arrays do not match its policy, shape and device")
    y = torch.empty(m, dtype=p.accum_dtype, device=dev.device)
    if m == 0:
        return y
    fn = getattr(_library(), _ENTRY[p.name])
    rc = fn(dev.device.index, dev.row_blocks.numel() - 1, dev.row_blocks.data_ptr(),
            dev.indptr.data_ptr(), dev.indices.data_ptr(), dev.vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_ENTRY[p.name]} launch failed: cudaError {rc}")
    LAUNCHES[p.name] += 1
    return y


def spmv_plain(dev: DeviceCsr, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device: a gather,
    products in the accumulator type and an ``index_add_`` per row. Under
    fp32_ftz it flushes x, each product and the result (the kernel also
    flushes each partial sum; with normal products and results the two
    agree). Summation order differs from the kernel's."""
    p = dev.policy
    acc = p.accum_dtype
    m, _ = dev.shape
    xv = ftz(x.to(acc), p.flush_to_zero)
    prod = ftz(dev.vals.to(acc) * torch.index_select(xv, 0, dev.indices),
               p.flush_to_zero)
    rows = torch.repeat_interleave(torch.arange(m, device=dev.device),
                                   torch.diff(dev.indptr), output_size=dev.nnz)
    y = torch.zeros(m, dtype=acc, device=dev.device).index_add_(0, rows, prod)
    return ftz(y, p.flush_to_zero)


def spmv_sol_bytes(dev: Union[DeviceCsr, DeviceDia], vec_bytes: int) -> int:
    """Least bytes one SpMV of the upload moves: the CSR byte model, or for
    the DIA path the ndiag x n values, x and y once each, and the
    remainder's rows (int32), row pointer (int64), columns and values."""
    m, n = dev.shape
    if isinstance(dev, DeviceCsr):
        return spmv_csr_sol_bytes(m, n, dev.nnz, dev.vals.element_size(), vec_bytes)
    nbytes = dev.diags.numel() * dev.diags.element_size() + (m + n) * vec_bytes
    r = dev.rem
    if r is not None:
        nbytes += r.nrows * 4 + (r.nrows + 1) * 8 + r.nnz * (4 + r.vals.element_size())
    return nbytes


def spmv_csr_reference(a: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Host fp64 oracle (row-wise dot), used by tests and residual gates."""
    m, _ = a.shape
    y = np.zeros(m, dtype=np.float64)
    for i in range(m):
        s, e = a.indptr[i], a.indptr[i + 1]
        y[i] = np.dot(a.data[s:e], x[a.indices[s:e]])
    return y
