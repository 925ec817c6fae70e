"""ILU(0) on the card by fine-grained fixed-point sweeps.

The counterpart of ``respatpu/kernels/ilu0.py``; it replaces
``cusparseXcsrilu02`` (GPU/ilu0.cu:197-275). Algorithm: Chow & Patel,
"Fine-grained parallel incomplete LU factorization" (SIAM J. Sci. Comput.,
2015): every stored entry is updated from the previous iterate alone,

    s      = a_ij - sum_k l_ik * u_kj        (k < min(i,j), k in both patterns)
    val_ij = s / u_jj   if i > j   else   s

over the pair lists of :func:`respatpu_torch.analysis.chow_patel_schedule`.
The fixed point is exactly ILU(0). One sweep is one launch of a hand-written
CUDA kernel (``csrc/ilu0.cu``, K6): a thread an entry, its pairs in list
order, the read-once streams evict-first for the single-word instances, the
new values into a second buffer, the pivot fix of the diagonal fused in, and
an optional largest change folded in by an atomic max a warp. Its
plain PyTorch version, :func:`ilu0_sweep_plain`, sums in the same order, so
the two agree bit for bit. :func:`ilu0_sweep` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; nothing else chooses.

As in respatpu: the pivot fix (a diagonal entry at most eps in size becomes
+-eps, PARDISO's static perturbation, test_pardiso.c:144-148: eps = 1e-4
single, 1e-13 double, times max|a|) is applied to A's values and counted, and
then after every sweep but the last without being counted; the last sweep is
unfixed and gives the residual max|final - vals| / max|a|. A sweep depends on
the whole previous one, so a factorization is ``sweeps + 1`` launches.

Instances: fp32, fp32_ftz (every value read, product, partial sum and
result flushed to zero), bf16 (bf16 values, sums in fp32, each result rounded to bf16 once),
fp64 (respatpu's double-float ``_ilu0_df`` becomes native fp64).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..analysis import IluSchedule, chow_patel_schedule
from ..formats import CSRMatrix
from ..precision import Policy, ftz, get_policy

__all__ = ["DeviceIluSchedule", "ilu_schedule_to_device", "ilu0_factor", "Ilu0Result",
           "ilu0_host_reference", "ilu0_sweep", "ilu0_sweep_plain", "LAUNCHES"]

_INST = {(torch.float32, False): "f32", (torch.float32, True): "f32_ftz",
         (torch.bfloat16, False): "bf16", (torch.float64, False): "f64"}

# Kernel launches per entry point, raised by ``ilu0_sweep`` right after each
# launch succeeds and nowhere else.
LAUNCHES = {f"respa_ilu0_sweep_{i}": 0 for i in ("f32", "f32_ftz", "bf16", "f64")}

UPPER, LOWER, DIAG = 0, 1, 2  # an entry's kind, as the kernel reads it


@dataclasses.dataclass
class DeviceIluSchedule:
    """A Chow-Patel schedule on one device, as the sweep kernel reads it."""

    nnz: int
    t_max: int
    ptr: torch.Tensor  # int64[nnz+1]
    pairs_a: torch.Tensor  # int32[npairs]
    pairs_b: torch.Tensor  # int32[npairs]
    kind: torch.Tensor  # int8[nnz]: UPPER, LOWER or DIAG
    diag_pos_col: torch.Tensor  # int32[nnz]: position of u_jj, -1 where missing
    diag_pos: torch.Tensor  # int64[ndiag]: positions of the diagonal entries present
    _plain: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.ptr.device


def ilu_schedule_to_device(sched: IluSchedule,
                           device: Union[str, torch.device] = "cuda") -> DeviceIluSchedule:
    if sched.nnz >= 2 ** 31:
        raise ValueError("entry positions are int32: nnz must be < 2^31")
    kind = sched.is_lower.astype(np.int8)
    present = sched.diag_pos[sched.diag_pos >= 0]
    kind[present] = DIAG
    device = torch.device(device)

    def put(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    return DeviceIluSchedule(
        nnz=sched.nnz, t_max=sched.t_max, ptr=put(sched.ptr, np.int64),
        pairs_a=put(sched.pairs_a, np.int32), pairs_b=put(sched.pairs_b, np.int32),
        kind=put(kind, np.int8), diag_pos_col=put(sched.diag_pos_col, np.int32),
        diag_pos=put(present, np.int64))


class Ilu0Result(NamedTuple):
    values: torch.Tensor  # factor values on A's pattern, the policy's type, on the device
    n_pivot_perturbed: int
    residual: float  # max|final - vals| / max|a| of the last sweep


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _eps(eps: float, dtype: torch.dtype) -> torch.Tensor:
    """eps as the kernel has it: rounded to the value type (through fp32 for
    the single-word types), in the accumulator type."""
    t = torch.tensor(float(eps), dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    return t.to(dtype).to(_acc(dtype))


def _plain_order(s: DeviceIluSchedule):
    """Entries by pair count, most first, and how many have more than t pairs
    for every t: the plain sweep then adds pair t of exactly those entries."""
    if s._plain is None:
        cnt = torch.diff(s.ptr)
        order = torch.sort(cnt, descending=True, stable=True).indices
        desc = cnt[order].cpu().numpy()
        most = int(desc[0]) if desc.size else 0
        # live[t] = number of entries with more than t pairs
        live = (desc.size - np.searchsorted(desc[::-1], np.arange(most), side="right")).tolist()
        s._plain = (order, s.ptr[order], live)
    return s._plain


def ilu0_sweep_plain(s: DeviceIluSchedule, a: torch.Tensor, old: torch.Tensor, eps: float,
                     fix: bool, flush: bool = False,
                     residual: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The sweep kernel's function in plain torch ops, on any device, in the
    kernel's order: each entry's products added one after the other in list
    order, every product and sum rounded on its own (under ``flush`` every
    value read, product, sum and result flushed to zero), the result rounded
    to the value type once. Returns the new
    values and, with ``residual``, max |new - old| (a one-element tensor in
    the accumulator type)."""
    acc = _acc(a.dtype)
    order, start, live = _plain_order(s)
    oldf = ftz(old.to(acc), flush)
    part = torch.zeros(s.nnz, dtype=acc, device=a.device)
    for t, k in enumerate(live):
        pos = start[:k] + t
        prod = ftz(oldf[s.pairs_a[pos].long()] * oldf[s.pairs_b[pos].long()], flush)
        part[:k] = ftz(part[:k] + prod, flush)
    acc_sum = torch.empty_like(part)
    acc_sum[order] = part
    v = ftz(ftz(a.to(acc), flush) - acc_sum, flush)
    dc = s.diag_pos_col.long()
    d = torch.where(dc >= 0, oldf[dc.clamp(min=0)], torch.ones((), dtype=acc, device=a.device))
    d = torch.where(d == 0, torch.ones_like(d), d)
    v = torch.where(s.kind == LOWER, ftz(v / d, flush), v)
    new = v.to(a.dtype)
    if fix:
        e = _eps(eps, a.dtype).to(a.device)
        nv = new.to(acc)
        fixed = torch.where(nv < 0, -e, e).to(a.dtype)
        new = torch.where((s.kind == DIAG) & (nv.abs() <= e), fixed, new)
    res = None
    if residual:
        res = ftz(new.to(acc) - oldf, flush).abs().max().reshape(1)
    return new, res


def ilu0_sweep(s: DeviceIluSchedule, a: torch.Tensor, old: torch.Tensor, eps: float, fix: bool,
               flush: bool = False, residual: bool = False,
               out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One Chow-Patel sweep: ``a`` are A's values and ``old`` the previous
    iterate, both of the value type on the schedule's device; returns the new
    values (``out``, if given: at least nnz long, only its first nnz written)
    and, with ``residual``, max |new - old|; see :func:`ilu0_sweep_plain`.

    On a CUDA device this is one launch of the sweep kernel on the current
    stream; it raises if the inputs do not fit the kernel or the launch
    fails. On the CPU it runs the plain version."""
    key = (a.dtype, bool(flush))
    if key not in _INST:
        raise TypeError(f"no ILU(0) sweep for {a.dtype}{' with flush-to-zero' if flush else ''}")
    for name, t in (("a", a), ("old", old)):
        if t.dtype != a.dtype or t.device != s.device or t.shape != (s.nnz,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {a.dtype} of shape ({s.nnz},) "
                             f"on {s.device}")
    if s.device.type == "cpu":
        new, res = ilu0_sweep_plain(s, a, old, eps, fix, flush, residual)
        if out is not None:
            out[:s.nnz] = new
            new = out
        return new, res
    if s.device.type != "cuda":
        raise ValueError(f"no ILU(0) sweep for device {s.device}")
    if out is None:
        out = torch.empty_like(a)
    elif (out.dtype != a.dtype or out.device != s.device or out.dim() != 1
          or out.numel() < s.nnz or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {a.dtype} vector of at least {s.nnz} "
                         f"on {s.device}")
    res = torch.zeros(1, dtype=_acc(a.dtype), device=s.device) if residual else None
    if s.nnz == 0:
        return out, res
    from . import _build
    name = f"respa_ilu0_sweep_{_INST[key]}"
    rc = getattr(_build.load(), name)(
        s.device.index, s.nnz, a.data_ptr(), old.data_ptr(), out.data_ptr(), s.ptr.data_ptr(),
        s.pairs_a.data_ptr(), s.pairs_b.data_ptr(), s.kind.data_ptr(),
        s.diag_pos_col.data_ptr(), float(eps), int(bool(fix)),
        res.data_ptr() if residual else None,
        torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out, res


def ilu0_factor(a: CSRMatrix, sched: Optional[IluSchedule] = None,
                policy: Union[str, Policy] = "fp32", sweeps: int = 8,
                pivot_eps: Optional[float] = None, values: Optional[np.ndarray] = None,
                device: Union[str, torch.device] = "cuda") -> Tuple[Ilu0Result, IluSchedule]:
    """Factor A ~= L*U on A's own pattern (values in-place layout, like csrilu02).

    Returns the factor values on A's CSR pattern (L strict-lower with unit
    diagonal implied; U upper including diagonal), on ``device`` in the
    policy's value type, plus breakdown diagnostics; the host waits once, at
    the end, for the count and the residual.
    """
    policy = get_policy(policy)
    if sched is None:
        sched = chow_patel_schedule(a)
    device = torch.device(device)
    dev = ilu_schedule_to_device(sched, device)
    data = a.data if values is None else np.asarray(values, np.float64)
    if pivot_eps is None:
        # PARDISO defaults: 1e-4 single, 1e-13 double (test_pardiso.c:144-148)
        eps_rel = 1e-13 if policy.dtype == torch.float64 else 1e-4
        pivot_eps = eps_rel * float(np.abs(data).max() if data.size else 1.0)
    flush = policy.flush_to_zero
    av = policy.cast_host(data).to(device)
    vals = av.clone()
    # the initial fix, counted
    d = vals[dev.diag_pos].to(_acc(av.dtype))
    e = _eps(pivot_eps, av.dtype).to(device)
    bad = d.abs() <= e
    vals[dev.diag_pos] = torch.where(bad, torch.where(d < 0, -e, e), d).to(av.dtype)
    nbad = bad.sum()
    for _ in range(sweeps):
        vals, _ = ilu0_sweep(dev, av, vals, pivot_eps, True, flush)
    final, res = ilu0_sweep(dev, av, vals, pivot_eps, False, flush, residual=True)
    amax = av.abs().max().to(torch.float32) if av.numel() else torch.zeros((), device=device)
    resid = (res[0].to(torch.float32) / (amax + 1e-30)) if res is not None else amax
    return Ilu0Result(final, int(nbad), float(resid)), sched


def ilu0_host_reference(a: CSRMatrix) -> np.ndarray:
    """Host fp64 oracle: standard IKJ in-place ILU(0) (same layout as device)."""
    n = a.nrows
    indptr, indices = a.indptr, a.indices
    vals = a.data.astype(np.float64).copy()
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        row_cols = indices[s:e]
        for ki, k in enumerate(row_cols):
            if k >= i:
                break
            ks, ke = indptr[k], indptr[k + 1]
            kcols = indices[ks:ke]
            dpos = np.searchsorted(kcols, k)
            if dpos >= kcols.size or kcols[dpos] != k or vals[ks + dpos] == 0:
                continue
            lik = vals[s + ki] / vals[ks + dpos]
            vals[s + ki] = lik
            # update a_ij for j > k in row i where u_kj exists
            upper = kcols > k
            for jp, j in zip(np.flatnonzero(upper), kcols[upper]):
                pos = np.searchsorted(row_cols, j)
                if pos < row_cols.size and row_cols[pos] == j:
                    vals[s + pos] -= lik * vals[ks + jp]
    return vals
