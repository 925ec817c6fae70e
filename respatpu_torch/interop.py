"""Carry respatpu's host state and results into the port, so that the tests
can run both packages on the same inputs. Nothing here imports JAX: inputs are
read through their numpy views.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .analysis import IluSchedule
from .formats import COOMatrix, CSRMatrix, coo_to_csr
from .kernels.bandlu import DeviceBand, with_inverses
from .kernels.snlu import SupernodePartition
from .kernels.snlu_device import FrontalPlan, build_frontal_plan
from .kernels.splu import ScheduledLuPlan, plan_from_schedule
from .kernels.sptrsv import DeviceTri, tri_to_device
from .precision import get_policy

__all__ = ["csr_from_respatpu", "df_to_numpy", "band_from_respatpu",
           "band_to_numpy", "partition_from_respatpu", "plan_from_respatpu",
           "pool_from_respatpu", "ilu_schedule_from_respatpu", "splu_plan_from_respatpu",
           "tri_from_respatpu", "row_partition_from_respatpu", "sharded_pool_from_respatpu"]


def csr_from_respatpu(obj) -> CSRMatrix:
    """The port's CSR from anything shaped like ``respatpu.formats.CSRMatrix``
    (``shape``, ``indptr``, ``indices``, ``data``)."""
    return CSRMatrix(shape=(int(obj.shape[0]), int(obj.shape[1])),
                     indptr=np.ascontiguousarray(obj.indptr, np.int64),
                     indices=np.ascontiguousarray(obj.indices, np.int32),
                     data=np.ascontiguousarray(obj.data, np.float64))


def df_to_numpy(hi, lo) -> np.ndarray:
    """A respatpu double-float pair (``DF(hi, lo)``) as float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def band_from_respatpu(obj, device: Union[str, torch.device] = "cuda") -> DeviceBand:
    """The port's band from anything shaped like respatpu's ``DeviceBand``
    (``n``, ``p``, ``ml``, ``mu``, ``policy_name`` and ``data``, a tuple of
    arrays: one in the policy's type, or the double-float ``(hi, lo)``,
    which becomes fp64 by ``hi + lo``). A band factored by respatpu can then
    be solved by the port: the inverses of its diagonal triangles, which the
    port's sweep applies, are made here (``bandlu.with_inverses``)."""
    policy = get_policy(obj.policy_name)
    if len(obj.data) == 2:
        data = torch.from_numpy(df_to_numpy(*obj.data))
    else:
        # through fp32: numpy has no bfloat16, and every stored type widens exactly
        data = torch.from_numpy(np.asarray(obj.data[0], np.float32).copy())
    return with_inverses(DeviceBand(
        n=int(obj.n), p=int(obj.p), ml=int(obj.ml), mu=int(obj.mu), policy=policy,
        data=data.to(policy.dtype).contiguous().to(torch.device(device))))


def band_to_numpy(band: DeviceBand):
    """The arrays respatpu's ``DeviceBand.data`` would hold for this band:
    one array in the band's type (fp32 for bf16: the caller rounds), or for
    fp64 the ``(hi, lo)`` fp32 pair."""
    data = band.data.detach().cpu()
    if data.dtype == torch.float64:
        full = data.numpy()
        hi = full.astype(np.float32)
        return hi, (full - hi.astype(np.float64)).astype(np.float32)
    return (data.float().numpy(),)


def partition_from_respatpu(obj) -> SupernodePartition:
    """The port's partition from anything shaped like respatpu's
    ``SupernodePartition``."""
    return SupernodePartition(
        n=int(obj.n), perm=np.asarray(obj.perm), filled=csr_from_respatpu(obj.filled),
        snode_ptr=np.asarray(obj.snode_ptr, np.int64),
        sn_parent=np.asarray(obj.sn_parent, np.int64),
        rowstruct=[np.asarray(rs, np.int64) for rs in obj.rowstruct],
        levels=[np.asarray(lv, np.int64) for lv in obj.levels],
        fill_nnz=int(obj.fill_nnz))


def plan_from_respatpu(plan) -> FrontalPlan:
    """The port's frontal plan for the partition of respatpu's ``FrontalPlan``
    (anything with ``part``). Front shapes are the same; the pool's layout is
    the port's own (group by group), so ``off`` differs from respatpu's by
    the permutation that :func:`pool_from_respatpu` applies."""
    return build_frontal_plan(partition_from_respatpu(plan.part))


def _front_gather(src_off: np.ndarray, dst_off: np.ndarray, mp: np.ndarray):
    """Flat index pairs that move every front from one pool layout to another."""
    size = mp * mp
    within = np.arange(int(size.sum()), dtype=np.int64) - np.repeat(np.cumsum(size) - size, size)
    return np.repeat(src_off, size) + within, np.repeat(dst_off, size) + within


def pool_from_respatpu(plan, pool_np, device: Union[str, torch.device] = "cuda",
                       dtype: torch.dtype = torch.float32):
    """``(port plan, port pool)`` from respatpu's ``FrontalPlan`` and its pool
    (assembled or factored) as a numpy array: every front moved from
    respatpu's layout (supernode order) to the port's (group by group).
    ``snlu_device.values_from_pool`` brings a port pool back into
    ``part.filled.data`` layout, which is what respatpu's function of that
    name gives for its own pool."""
    tplan = plan_from_respatpu(plan)
    src, dst = _front_gather(np.asarray(plan.off, np.int64), tplan.off, tplan.wp + tplan.rp)
    out = np.zeros(tplan.pool_size, dtype=np.float64)
    out[dst] = np.asarray(pool_np, np.float64)[src]
    return tplan, torch.from_numpy(out).to(dtype).to(torch.device(device))


def ilu_schedule_from_respatpu(sched) -> IluSchedule:
    """The port's Chow-Patel schedule from respatpu's ``IluSchedule`` (pair
    lists padded to ``t_max`` with -1): the same pairs in the same order,
    kept ragged."""
    pa = np.asarray(sched.pairs_a, np.int64)
    pb = np.asarray(sched.pairs_b, np.int64)
    live = pa >= 0
    ptr = np.zeros(int(sched.nnz) + 1, dtype=np.int64)
    np.cumsum(live.sum(axis=1), out=ptr[1:])
    return IluSchedule(nnz=int(sched.nnz), t_max=int(sched.t_max), ptr=ptr,
                       pairs_a=pa[live], pairs_b=pb[live],
                       is_lower=np.asarray(sched.is_lower, bool),
                       diag_pos_col=np.asarray(sched.diag_pos_col, np.int64),
                       diag_pos=np.asarray(sched.diag_pos, np.int64),
                       zero_diag=np.asarray(sched.zero_diag, bool))


def splu_plan_from_respatpu(plan) -> ScheduledLuPlan:
    """The port's scheduled-LU plan from respatpu's ``ScheduledLuPlan``: its
    padded pair lists kept ragged (:func:`ilu_schedule_from_respatpu`), then
    the port's entry levels and tasks; respatpu's chunks and ``depth`` are
    left behind. Both packages then factor with the same pair lists."""
    return plan_from_schedule(int(plan.n), ilu_schedule_from_respatpu(plan.sched))


def tri_from_respatpu(t_csr, values=None, lower: bool = True, unit_diag: bool = False,
                      policy="fp32", device: Union[str, torch.device] = "cuda") -> DeviceTri:
    """The port's exact-solve factor from a triangle of respatpu's (anything
    shaped like its ``CSRMatrix``) and, optionally, factor values on its
    pattern (numpy; respatpu's ILU(0) values, double-float pairs summed with
    :func:`df_to_numpy`), so that both packages solve with the same factor."""
    return tri_to_device(csr_from_respatpu(t_csr), lower=lower, unit_diag=unit_diag,
                         policy=policy, values=values, device=device)


def row_partition_from_respatpu(plan):
    """The port's row partition (``dist.RowPartitionPlan``) of the matrix and
    shard count of respatpu's ``RowPartitionPlan`` (its numpy arrays): each
    shard's ELL sub-rows read back into global entries (the columns through
    respatpu's halo layout and ``send_idx``), then partitioned by the port.
    An explicit zero at a shard's first local column reads as ELL padding
    and is dropped; it adds nothing to a product."""
    from .dist import build_row_partition
    ndev, n_loc, halo, n = int(plan.ndev), int(plan.n_loc), int(plan.halo), int(plan.n)
    cols = np.asarray(plan.cols, np.int64)
    vals = np.asarray(plan.vals, np.float64)
    ros = np.asarray(plan.row_of_sub, np.int64)
    send_idx = np.asarray(plan.send_idx, np.int64)
    rows_g, cols_g, vals_g = [], [], []
    for d in range(ndev):
        c, v = cols[d], vals[d]
        live = (ros[d][:, None] >= 0) & ((v != 0) | (c != 0))
        r = np.broadcast_to(ros[d][:, None], c.shape)[live] + d * n_loc
        c, v = c[live], v[live]
        t = c - n_loc
        remote = t >= 0
        s, pos = t[remote] // halo, t[remote] % halo
        g = c + d * n_loc
        g[remote] = s * n_loc + send_idx[s, d, pos]
        rows_g.append(r)
        cols_g.append(g)
        vals_g.append(v)
    a = coo_to_csr(COOMatrix((n, n), np.concatenate(rows_g).astype(np.int32),
                             np.concatenate(cols_g).astype(np.int32), np.concatenate(vals_g)))
    out = build_row_partition(a, ndev)
    if (out.n_loc, out.halo) != (n_loc, halo):
        raise ValueError(f"the partition read back has (n_loc, halo) = {(out.n_loc, out.halo)}, "
                         f"respatpu's {(n_loc, halo)}")
    return out


def sharded_pool_from_respatpu(fac, mesh=None, policy="fp32"):
    """The port's ``DistSubtreeLu`` holding the factor of respatpu's
    ``DistSubtreeLu`` ``fac``: its ``factor_values()`` (host fp64) scattered
    into the port's shard pools for the same partition, nothing factored, so
    that the port's distributed solves can be held against respatpu's on one
    factor. ``mesh`` defaults to as many shards as ``fac`` has, on the card."""
    from .dist import make_mesh
    from .dist_snlu_sub import DistSubtreeLu
    mesh = mesh if mesh is not None else make_mesh(int(fac.ndev))
    return DistSubtreeLu.from_factor(csr_from_respatpu(fac.a), partition_from_respatpu(fac.part),
                                     np.asarray(fac.factor_values(), np.float64), mesh=mesh,
                                     policy=policy)
