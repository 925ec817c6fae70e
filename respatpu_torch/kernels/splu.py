"""Exact sparse LU, or exact ILU(0), on the card by a level-scheduled
elimination in one launch.

The counterpart of ``respatpu/kernels/splu.py``. On a pattern F every stored
entry p = (i, j) satisfies

    val[p] = a[p] - sum_k l_ik * u_kj        (k < min(i, j), both in F)   U entry
    val[p] = (same) / u_jj                                                 L entry

over the Chow-Patel pair lists of :func:`respatpu_torch.analysis.chow_patel_schedule`
(ragged). Run on F = A's own pattern this is exact ILU(0); on F =
``symbolic_fill_lu(A)`` it is the exact LU factorization without pivoting.

Every pair entry and the diagonal an L entry divides by precede the entry in
CSR order, so one forward pass gives each entry its *level*
(:func:`entry_levels`, in the port's native host library): the entry can be
computed once every entry of the levels before it is. The plan
(:func:`build_scheduled_lu`, made once on the host) holds the entries in
level order, short entries (at most ``SHORT`` pairs) before long ones in a
level, the level offsets, and the cut into tasks: up to ``TASK_ENTRIES``
short entries of one level (a lane an entry) or a run of long entries of
one level of about ``LONG_PAIRS`` pairs in all (a warp over each entry's
pairs in turn). The factorization is one launch of a hand-written CUDA kernel
(``csrc/splu.cu``, K8): warps take tasks by an atomic ticket in level order
and wait once a task on a completion counter of the level before, as the
exact triangular solve K7 does. respatpu's level-aligned chunks with
``depth`` repeated sweeps (``chunk_nnz``, ``depth``) exist because the TPU
has no fine-grained synchronisation; they are not ported.

A divisor with |u_jj| <= eps is replaced by -eps if it is negative and +eps
otherwise (+eps for -0.0, and for a structurally missing diagonal); eps is
1e-13 max|a| under fp64 and 1e-4 max|a| otherwise. A perturbed pivot counts
once per diagonal position, and only where some L entry divides by it
(respatpu's in-kernel rule for fp32; its df64 path counts every small
diagonal after the fact, divergence D3). The stored u_jj itself is not
changed.

Instances, as the Chow-Patel sweep K6 has them: fp32, fp32_ftz (every value
read, product, partial sum and result flushed to zero), bf16 (values stored
in bf16, sums in fp32, each result rounded to bf16 once) and fp64. The plain
PyTorch version, :func:`splu_factor_plain`, reads the same plan level by
level and sums in the kernel's order (a short entry's pairs one after the
other in list order from +0; a long entry's as a partial a lane over the
pairs l, l + 32, ... and then a halving tree over the 32 partials), so the
two agree bit for bit. :func:`splu_factor` launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; nothing else chooses.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..analysis import IluSchedule, chow_patel_schedule
from ..formats import CSRMatrix
from ..precision import Policy, ftz, get_policy

__all__ = ["ScheduledLuPlan", "build_scheduled_lu", "plan_from_schedule",
           "estimate_schedule_bytes", "entry_levels",
           "DeviceScheduledLu", "splu_to_device", "splu_factor", "splu_factor_plain",
           "perturbed_pivots", "ScheduledLuResult", "scheduled_lu_factor", "LAUNCHES"]

_INST = {(torch.float32, False): "f32", (torch.float32, True): "f32_ftz",
         (torch.bfloat16, False): "bf16", (torch.float64, False): "f64"}

# Kernel launches per entry point, raised by ``splu_factor`` right after each
# launch succeeds and nowhere else.
LAUNCHES = {f"respa_splu_factor_{i}": 0 for i in ("f32", "f32_ftz", "bf16", "f64")}

# The plan's sizes, as csrc/splu.cu was built with them (checked at the first
# launch): a short entry has at most SHORT pairs; a task takes up to
# TASK_ENTRIES short entries of one level.
SHORT, TASK_ENTRIES = 32, 32
# warps taking K8's tasks: LOOKAHEAD levels' worth of them on the average, at
# least 32
LOOKAHEAD = 4
# a run of long entries of one level is cut where its pairs pass a multiple
# of LONG_PAIRS (1: an entry a run); 256 was the fastest of 1, 64, 256 and
# 1024 on laplacian_2d(300, 300)'s fill (chip_smoke.py --splu-times, PERF.md)
LONG_PAIRS = 256
# the numpy fallback of entry_levels is a Python loop over the entries
_FALLBACK_MAX = 1 << 18


def estimate_schedule_bytes(sched: IluSchedule) -> int:
    """Device bytes of the pair lists as the port stores them (ragged, int32
    positions, an int64 offset an entry): the memory guard's input."""
    return sched.layout_bytes()["ragged"]


def entry_levels(sched: IluSchedule) -> np.ndarray:
    """The level of every entry of an exact elimination (int32[nnz]): one more
    than the largest level among its pair entries and, for an L entry, its
    column's diagonal; 0 for an entry with neither. From the native host
    library; without it a Python loop, which refuses more than 2^18 entries."""
    from ..analysis import _native_ok
    if _native_ok():
        from ..io import native
        return native.entry_levels(sched.ptr, sched.pairs_a, sched.pairs_b,
                                   sched.diag_pos_col, sched.is_lower)
    if sched.nnz > _FALLBACK_MAX:
        raise RuntimeError(f"entry levels of {sched.nnz} entries need the native host "
                           "library (io/csrc/ilu_schedule.cpp); no C++ compiler was found")
    level = np.zeros(sched.nnz, dtype=np.int32)
    ptr, pa, pb = sched.ptr, sched.pairs_a, sched.pairs_b
    dpc, low = sched.diag_pos_col, sched.is_lower
    for p in range(sched.nnz):
        s, e = ptr[p], ptr[p + 1]
        lv = int(max(level[pa[s:e]].max(), level[pb[s:e]].max())) + 1 if e > s else 0
        if low[p] and dpc[p] >= 0:
            lv = max(lv, int(level[dpc[p]]) + 1)
        level[p] = lv
    return level


@dataclasses.dataclass
class ScheduledLuPlan:
    """The host plan of an exact elimination on a pattern F (see
    :func:`build_scheduled_lu`)."""

    n: int
    nnz: int
    t_max: int
    sched: IluSchedule  # the ragged pair lists
    levels: np.ndarray  # int32[nnz]: each entry's level
    perm: np.ndarray  # int64[nnz]: the entry at each position
    level_ptr: np.ndarray  # int64[nlevels + 1]: each level's first position
    tasks: np.ndarray  # int32[ntasks, 4]: (q0, q1, v, w)
    warps: int  # warps to take the tasks
    clamp_pos: np.ndarray  # int64: the diagonal positions some L entry divides by

    @property
    def nlevels(self) -> int:
        return self.level_ptr.size - 1


def build_scheduled_lu(f: CSRMatrix, sched: Optional[IluSchedule] = None) -> ScheduledLuPlan:
    """K8's plan of pattern F, made once on the host: the pair lists (made
    here unless ``sched`` is given), each entry's level, the positions by
    level (short entries before long ones, entries ascending within each),
    and the tasks in level order, ``(q0, q1, v, w)`` for the positions q0 ..
    q1 - 1 of level v: ``w == v``, up to TASK_ENTRIES short entries, a lane
    an entry; ``w == -1``, a run of long entries, a warp over each one's
    pairs in turn, cut where the level's long entries' pairs pass a multiple
    of LONG_PAIRS."""
    return plan_from_schedule(f.nrows, chow_patel_schedule(f) if sched is None else sched)


def plan_from_schedule(n: int, sched: IluSchedule) -> ScheduledLuPlan:
    """K8's plan of an n-row pattern from its ragged pair lists alone (see
    :func:`build_scheduled_lu`)."""
    return _plan_cut(n, sched, LONG_PAIRS)


def _plan_cut(n: int, sched: IluSchedule, long_pairs: int) -> ScheduledLuPlan:
    """:func:`plan_from_schedule` with the long entries' runs cut at
    ``long_pairs``: other cuts only to time them (``chip_smoke.py
    --splu-times``) and test them."""
    level = entry_levels(sched).astype(np.int64)
    nnz = sched.nnz
    nlev = int(level.max()) + 1 if nnz else 0
    lens = np.diff(sched.ptr)
    long = lens > SHORT
    perm = np.lexsort((long, level))
    size = np.bincount(level, minlength=nlev)
    level_ptr = np.zeros(nlev + 1, np.int64)
    np.cumsum(size, out=level_ptr[1:])
    ns = np.bincount(level[~long], minlength=nlev)
    # short tasks: ceil(ns / TASK_ENTRIES) a level, each from its level's start
    k = -(-ns // TASK_ENTRIES)
    lev_s = np.repeat(np.arange(nlev), k)
    first = np.zeros(nlev + 1, np.int64)
    np.cumsum(k, out=first[1:])
    q0s = level_ptr[lev_s] + TASK_ENTRIES * (np.arange(lev_s.size) - first[lev_s])
    q1s = np.minimum(q0s + TASK_ENTRIES, level_ptr[lev_s] + ns[lev_s])
    # long tasks: runs of a level's long entries (which follow its short
    # ones), cut where their pairs before the entry pass a multiple of long_pairs
    q_long = np.flatnonzero(long[perm])
    lev_l = level[perm[q_long]]
    c = lens[perm[q_long]]
    before = np.cumsum(c) - c
    before -= before[np.searchsorted(lev_l, lev_l)]  # within the level
    cut = before // long_pairs
    starts = np.flatnonzero(np.r_[q_long.size > 0, (np.diff(lev_l) != 0) | (np.diff(cut) != 0)])
    ends = np.r_[starts[1:], q_long.size][:starts.size] - 1
    tasks = np.concatenate([np.stack([q0s, q1s, lev_s, lev_s], 1),
                            np.stack([q_long[starts], q_long[ends] + 1, lev_l[starts],
                                      np.full(starts.size, -1)], 1)])
    tasks = tasks[np.argsort(tasks[:, 0], kind="stable")].astype(np.int32)
    low = sched.is_lower & (sched.diag_pos_col >= 0)
    return ScheduledLuPlan(
        n=n, nnz=nnz, t_max=sched.t_max, sched=sched, levels=level.astype(np.int32),
        perm=perm, level_ptr=level_ptr, tasks=tasks.reshape(-1, 4),
        warps=max(32, -(-LOOKAHEAD * len(tasks) // max(nlev, 1))),
        clamp_pos=np.unique(sched.diag_pos_col[low]))


@dataclasses.dataclass
class DeviceScheduledLu:
    """K8's plan on one device, as the kernel and its plain version read it."""

    nnz: int
    perm: torch.Tensor  # int32[nnz]: the entry at each position
    level_ptr: torch.Tensor  # int32[nlevels + 1]
    tasks: torch.Tensor  # int32[ntasks, 4]
    warps: int
    ptr: torch.Tensor  # int64[nnz + 1]: entry p's pairs
    pairs_a: torch.Tensor  # int32[npairs]: positions of l_ik
    pairs_b: torch.Tensor  # int32[npairs]: positions of u_kj
    is_lower: torch.Tensor  # int8[nnz]
    diag_pos_col: torch.Tensor  # int32[nnz]: position of u_jj, -1 where missing
    clamp_pos: torch.Tensor  # int64: diagonal positions some L entry divides by
    _plain: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.ptr.device

    @property
    def levels(self) -> int:
        return self.level_ptr.numel() - 1


def splu_to_device(plan: ScheduledLuPlan,
                   device: Union[str, torch.device] = "cuda") -> DeviceScheduledLu:
    s = plan.sched
    if s.nnz >= 2 ** 31 or s.npairs >= 2 ** 31:
        raise ValueError("entry and pair positions are int32: nnz and the pairs must be < 2^31")
    device = torch.device(device)

    def put(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    return DeviceScheduledLu(
        nnz=s.nnz, perm=put(plan.perm, np.int32), level_ptr=put(plan.level_ptr, np.int32),
        tasks=put(plan.tasks, np.int32), warps=plan.warps, ptr=put(s.ptr, np.int64),
        pairs_a=put(s.pairs_a, np.int32), pairs_b=put(s.pairs_b, np.int32),
        is_lower=put(s.is_lower, np.int8), diag_pos_col=put(s.diag_pos_col, np.int32),
        clamp_pos=put(plan.clamp_pos, np.int64))


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _eps(eps: float, dtype: torch.dtype) -> torch.Tensor:
    """eps as the kernel has it: rounded to the value type (through fp32 for
    the single-word types), in the accumulator type."""
    t = torch.tensor(float(eps), dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    return t.to(dtype).to(_acc(dtype))


def _plain_levels(d: DeviceScheduledLu):
    """Per level ``(q0, ns, most, nl, steps)``: its first position, its short
    entries and the longest of their lists, its long entries and the warp
    steps of the longest (32 pairs a step); made once a plan."""
    if d._plain is None:
        lp = d.level_ptr.cpu().numpy().astype(np.int64)
        lens = np.diff(d.ptr.cpu().numpy())[d.perm.cpu().numpy()]  # by position
        nlev = lp.size - 1
        level = np.repeat(np.arange(nlev), np.diff(lp))
        short = lens <= SHORT
        ns = np.bincount(level[short], minlength=nlev)
        most = np.zeros(nlev, np.int64)
        np.maximum.at(most, level[short], lens[short])
        steps = np.zeros(nlev, np.int64)
        np.maximum.at(steps, level[~short], (lens[~short] + 31) // 32)
        d._plain = list(zip(lp[:-1].tolist(), ns.tolist(), most.tolist(),
                            (np.diff(lp) - ns).tolist(), steps.tolist()))
    return d._plain


def _tree(s: torch.Tensor, fl: bool) -> torch.Tensor:
    """Lane 0's sum of a warp's 32 partials [rows, 32], as the kernel's
    shuffles take it: a halving tree."""
    off = 16
    while off:
        s = ftz(s[:, :off] + s[:, off:2 * off], fl)
        off //= 2
    return s[:, 0]


def splu_factor_plain(d: DeviceScheduledLu, a: torch.Tensor, eps: float,
                      flush: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device, from the same
    plan, level by level: each entry's products in the kernel's order (an
    empty place of the padded gather reads the zero slot past the values, a
    product 0 * 0 = +0 that leaves a sum started from +0 as it is), every
    product and sum rounded on its own and flushed under ``flush``, then
    ``v = a - sum``, divided by the clamped u_jj for an L entry, rounded to
    the value type once. Returns the factor values, of ``a``'s type."""
    acc = _acc(a.dtype)
    dev = a.device
    nnz = d.nnz
    e = _eps(eps, a.dtype).to(dev)
    ve = torch.zeros(nnz + 1, dtype=acc, device=dev)  # ve[nnz] = 0: the empty places
    av = ftz(a.to(acc), flush)
    perm = d.perm.long()
    pa_all = torch.cat([d.pairs_a.long(), torch.full((1,), nnz, device=dev)])
    pb_all = torch.cat([d.pairs_b.long(), torch.full((1,), nnz, device=dev)])
    npairs = d.pairs_a.numel()
    dpc = d.diag_pos_col.long()
    low = d.is_lower.bool()

    def products(ents, width):
        """[entries, width] products of each entry's pairs 0 .. width - 1."""
        start = d.ptr[ents]
        t = start[:, None] + torch.arange(width, device=dev)
        t = torch.where(t < d.ptr[ents + 1][:, None], t, torch.full_like(t, npairs))
        return ftz(ftz(ve[pa_all[t]], flush) * ftz(ve[pb_all[t]], flush), flush)

    for q0, ns, most, nl, steps in _plain_levels(d):
        sums = []
        if ns:
            s = torch.zeros(ns, dtype=acc, device=dev)
            if most:
                pr = products(perm[q0:q0 + ns], most)
                for m in range(most):
                    s = ftz(s + pr[:, m], flush)
            sums.append(s)
        if nl:
            pr = products(perm[q0 + ns:q0 + ns + nl], 32 * steps).view(nl, steps, 32)
            part = torch.zeros(nl, 32, dtype=acc, device=dev)
            for k in range(steps):
                part = ftz(part + pr[:, k], flush)
            sums.append(_tree(part, flush))
        ents = perm[q0:q0 + ns + nl]
        s = sums[0] if len(sums) == 1 else torch.cat(sums)
        v = ftz(av[ents] - s, flush)
        dc = dpc[ents]
        dj = torch.where(dc >= 0, ftz(ve[dc.clamp(min=0)], flush), torch.zeros_like(v))
        dj = torch.where((dc < 0) | (dj.abs() <= e), torch.where(dj < 0, -e, e), dj)
        v = torch.where(low[ents], ftz(v / dj, flush), v)
        ve[ents] = v.to(a.dtype).to(acc)
    return ve[:nnz].to(a.dtype)


def perturbed_pivots(d: DeviceScheduledLu, vals: torch.Tensor, eps: float,
                     flush: bool = False) -> torch.Tensor:
    """How many diagonal positions some L entry divided by were clamped: the
    final u_jj (as the kernel reads it) at most eps in size. A one-element
    int64 tensor on the plan's device."""
    e = _eps(eps, vals.dtype).to(vals.device)
    u = ftz(vals[d.clamp_pos].to(_acc(vals.dtype)), flush)
    return (u.abs() <= e).sum().reshape(1)


_lib = None


def _library():
    """The built kernel library, once its plan sizes are known to match ours."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load()
        sizes = (lib.respa_splu_limit(0), lib.respa_splu_limit(1))
        if sizes != (SHORT, TASK_ENTRIES):
            raise RuntimeError(f"csrc/splu.cu was built with the sizes {sizes}, the plan "
                               f"makes {(SHORT, TASK_ENTRIES)}")
        _lib = lib
    return _lib


def splu_factor(d: DeviceScheduledLu, a: torch.Tensor, eps: float, flush: bool = False,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The factor values on F from A's values ``a`` (scattered onto F, of the
    value type, on the plan's device); ``out``, if given, at least nnz long,
    only its first nnz written. See :func:`splu_factor_plain`.

    On a CUDA device this is one launch of K8 on the current stream, its
    tasks waiting on level counters that are zeroed for it, with its ticket,
    on that stream. It raises if the inputs do not fit the kernel or the
    launch fails. On the CPU it runs the plain version."""
    key = (a.dtype, bool(flush))
    if key not in _INST:
        raise TypeError(f"no scheduled LU for {a.dtype}{' with flush-to-zero' if flush else ''}")
    if a.device != d.device or a.shape != (d.nnz,) or not a.is_contiguous():
        raise ValueError(f"a must be contiguous of shape ({d.nnz},) on {d.device}")
    if d.device.type == "cpu":
        vals = splu_factor_plain(d, a, eps, flush)
        if out is not None:
            out[:d.nnz] = vals
            vals = out
        return vals
    if d.device.type != "cuda":
        raise ValueError(f"no scheduled LU for device {d.device}")
    if out is None:
        out = torch.empty_like(a)
    elif (out.dtype != a.dtype or out.device != d.device or out.dim() != 1
          or out.numel() < d.nnz or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {a.dtype} vector of at least {d.nnz} "
                         f"on {d.device}")
    arrays = (d.perm, d.level_ptr, d.tasks, d.ptr, d.pairs_a, d.pairs_b, d.is_lower,
              d.diag_pos_col)
    if (d.perm.dtype != torch.int32 or d.ptr.dtype != torch.int64 or d.tasks.dim() != 2
            or d.ptr.shape != (d.nnz + 1,) or d.perm.shape != (d.nnz,)
            or any(t.device != d.device or not t.is_contiguous() for t in arrays)):
        raise ValueError("DeviceScheduledLu arrays do not match its size and device")
    if d.nnz == 0:
        return out
    nctl = d.levels + 1
    ctl = torch.zeros(nctl, dtype=torch.int32, device=d.device)  # counters, then the ticket
    name = f"respa_splu_factor_{_INST[key]}"
    rc = getattr(_library(), name)(
        d.device.index, d.tasks.shape[0], d.warps, d.tasks.data_ptr(), d.level_ptr.data_ptr(),
        d.perm.data_ptr(), d.ptr.data_ptr(), d.pairs_a.data_ptr(), d.pairs_b.data_ptr(),
        d.is_lower.data_ptr(), d.diag_pos_col.data_ptr(), a.data_ptr(), out.data_ptr(),
        float(eps), ctl.data_ptr(), nctl, torch.cuda.current_stream(d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


class ScheduledLuResult(NamedTuple):
    values: torch.Tensor  # factor values on F, the policy's type, on the device
    n_pivot_perturbed: int


def scheduled_lu_factor(f: CSRMatrix, plan: Optional[ScheduledLuPlan] = None,
                        policy: Union[str, Policy] = "fp32", pivot_eps: Optional[float] = None,
                        values: Optional[np.ndarray] = None,
                        device: Union[str, torch.device] = "cuda",
                        dev_plan: Optional[DeviceScheduledLu] = None
                        ) -> Tuple[ScheduledLuResult, ScheduledLuPlan]:
    """Exact LU / ILU(0) numeric factorization on pattern F (values in F's
    CSR layout: L strictly below the diagonal with its unit diagonal
    implied, U on and above it), on ``device`` in the policy's value type;
    the host waits once, at the end, for the count of perturbed pivots.
    ``dev_plan`` is the plan already on ``device`` (made from ``plan``)."""
    policy = get_policy(policy)
    if plan is None:
        plan = build_scheduled_lu(f)
    device = torch.device(device)
    d = dev_plan if dev_plan is not None else splu_to_device(plan, device)
    data = f.data if values is None else np.asarray(values, np.float64)
    if pivot_eps is None:
        # PARDISO defaults: 1e-4 single, 1e-13 double (test_pardiso.c:144-148)
        eps_rel = 1e-13 if policy.dtype == torch.float64 else 1e-4
        pivot_eps = eps_rel * float(np.abs(data).max() if data.size else 1.0)
    av = policy.cast_host(data).to(device)
    vals = splu_factor(d, av, pivot_eps, policy.flush_to_zero)
    nbad = perturbed_pivots(d, vals, pivot_eps, policy.flush_to_zero)
    return ScheduledLuResult(vals, int(nbad)), plan
