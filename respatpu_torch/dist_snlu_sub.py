"""Distributed multifrontal LU whose front pool is sharded by subtree owner.

The counterpart of ``respatpu/dist_snlu_sub.py``: the MUMPS slot with memory
that scales (test_mumps.c:121-128, job=4 with the matrix spread over the
communicator).

* The elimination forest is cut into subtrees of balanced front volume
  (:func:`assign_subtrees`, respatpu's proportional mapping with LPT
  packing: the same owners for the same forest), and every shard's pool
  holds only the fronts it owns, laid out group by group with int64 offsets,
  so no front exists on two shards.
* The factorization goes over respatpu's (tree level, bucket shape) groups.
  In each, every shard factors its own fronts of the group (the port's
  ``snlu_device.factor_group``: the block-LU kernel K1, cuBLAS TRSMs and
  ``baddbmm_``) and adds the Schur corners whose parent it owns into that
  parent with the extend-add kernel K3. A corner whose parent another shard
  owns (only near the top of the forest) is copied to the owner, into a
  staging area behind its pool, and added there by K3 as well, the sources in
  shard order: no atomics, and two runs give the same bits. Only the owners
  hold a group's fronts; no shard pads its part of a group to a common shape
  (respatpu's ``valid``).
* The solves go over the groups too: every shard runs the frontal sweep
  kernel K4 on its fronts against the right-hand side, which is held once a
  place (fronts of one group never share a pivot row, so the shards of one
  card write disjoint entries of it), with control words of its own (P3);
  every other place then receives the shard's solved pivots, and, forward,
  each shard's updates to ancestor rows are added by the row-reduction
  kernel K5 into every place's copy, shard after shard: the psum of
  respatpu's per-shard deltas, in shard order.

On a mesh over ranks each rank uploads, assembles and factors its own
shards' pools; a corner whose parent another rank owns, and a solve's
pivots and updates, go to the other ranks in one exchange a group. Every
rank holds the right-hand side and x whole and the report's counts summed.
The pools stay where they are: ``factor_values`` and persistence refuse
such a factor.

Refinement (:meth:`DistSubtreeLu.solve_refined`) is ``solve.solve_refined``
around these solves: fp64 residuals on the CSR SpMV kernel (K0), GMRES-IR if
plain refinement stalls.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional, Union

import numpy as np
import torch

from .dist import Mesh, make_mesh
from .formats import CSRMatrix
from .kernels import snlu_device as F
from .kernels.snlu import SupernodePartition, analyze_supernodes
from .precision import Policy, get_policy
from .solve import SolveReport, _OriginalSolves, solve_refined

__all__ = ["assign_subtrees", "ShardedFrontalPlan", "build_sharded_plan",
           "DistSubtreeLu", "dist_factorize_sharded"]


def assign_subtrees(sn_parent: np.ndarray, vol: np.ndarray, ndev: int) -> np.ndarray:
    """Balanced subtree -> shard assignment (proportional mapping), respatpu's.

    ``sn_parent`` is the supernode forest in topological order (children
    before parents), ``vol`` a front's weight (its padded area). The largest
    subtree is split until none exceeds total / (4 ndev); the subtrees are
    packed onto shards by LPT; a split node goes to the least loaded of its
    children's owners; the other nodes inherit their subtree's owner.
    Returns ``owner[nsn]`` in [0, ndev)."""
    nsn = sn_parent.size
    owner = np.zeros(nsn, dtype=np.int32)
    if ndev <= 1 or nsn == 0:
        return owner
    children: List[List[int]] = [[] for _ in range(nsn)]
    for s in range(nsn):
        if sn_parent[s] >= 0:
            children[sn_parent[s]].append(s)
    subvol = vol.astype(np.float64).copy()
    for s in range(nsn):
        if sn_parent[s] >= 0:
            subvol[sn_parent[s]] += subvol[s]
    roots = [s for s in range(nsn) if sn_parent[s] < 0]
    thr = float(sum(subvol[r] for r in roots)) / (4.0 * ndev)
    heap = [(-subvol[r], r) for r in roots]
    heapq.heapify(heap)
    tasks: List[int] = []  # the subtrees' roots
    tops: List[int] = []  # split nodes
    while heap:
        nv, s = heapq.heappop(heap)
        if -nv > thr and children[s]:
            tops.append(s)
            for c in children[s]:
                heapq.heappush(heap, (-subvol[c], c))
        else:
            tasks.append(s)
    load = [(0.0, d) for d in range(ndev)]
    heapq.heapify(load)
    assigned = np.zeros(nsn, dtype=bool)
    loadv = np.zeros(ndev, dtype=np.float64)
    for t in sorted(tasks, key=lambda s: -subvol[s]):
        ld, d = heapq.heappop(load)
        owner[t] = d
        assigned[t] = True
        loadv[d] += float(subvol[t])
        heapq.heappush(load, (ld + float(subvol[t]), d))
    for s in sorted(tops):  # a top's children are assigned already
        best = min({int(owner[c]) for c in children[s]}, key=lambda d: (loadv[d], d))
        owner[s] = best
        assigned[s] = True
        loadv[best] += float(vol[s])
    for s in range(nsn - 1, -1, -1):
        if not assigned[s]:
            owner[s] = owner[sn_parent[s]]
    return owner


@dataclasses.dataclass
class _Remote:
    """Children of one source shard whose parents this shard owns: their
    places ``b0:b1`` in the source's part of the group, and where their
    corners go in this shard's pool."""
    src: int
    b0: int
    b1: int
    lp: np.ndarray  # int32[nr, rp]
    poff: np.ndarray  # int64[nr]: the parents' offsets in this shard's pool
    pmp: np.ndarray  # int32[nr]
    seg_ptr: np.ndarray  # int32[nseg + 1]: runs of one parent, from 0


@dataclasses.dataclass
class _ShardGroup:
    """One shard's fronts of a group: the roots, then the children whose
    parent it owns (sorted by parent: ``seg_ptr`` over ``nroot:nloc``), then
    the children whose parent another shard owns, by that shard."""
    snodes: np.ndarray  # int64[nf]
    g0: int  # offset of the first front in the shard's pool
    nroot: int
    nloc: int
    piv: np.ndarray  # int32[nf, wp]
    rsx: np.ndarray  # int32[nf, rp]
    lp: np.ndarray  # int32[nf, rp]
    poff: np.ndarray  # int64[nf]: the parent's offset in this pool (-1 past nloc and at roots)
    pmp: np.ndarray  # int32[nf]
    seg_ptr: np.ndarray  # int32[nseg + 1]
    red_rows: np.ndarray
    red_ptr: np.ndarray
    red_src: np.ndarray

    @property
    def nf(self) -> int:
        return int(self.snodes.size)


@dataclasses.dataclass
class _SubGroup:
    level: int
    wp: int
    rp: int
    shards: List[Optional[_ShardGroup]]  # None where the shard owns no front of it
    incoming: List[List[_Remote]]  # [e]: corners shard e receives, sources in shard order

    @property
    def mp(self) -> int:
        return self.wp + self.rp


@dataclasses.dataclass
class ShardedFrontalPlan:
    part: SupernodePartition
    ndev: int
    owner: np.ndarray  # int32[nsn]
    local_sizes: np.ndarray  # int64[ndev]: pool entries a shard owns
    stage_sizes: np.ndarray  # int64[ndev]: staging entries behind each pool
    total_front_vol: int  # sum of mp^2 over all fronts (the unsharded pool)
    asm_dev: np.ndarray  # int32[fill nnz]: the shard of each filled entry
    asm_dst: np.ndarray  # int64[fill nnz]: its place in that shard's pool
    asm_nz: np.ndarray  # int64: the filled entries with a value (A's)
    ones_dev: np.ndarray  # the padded pivots' diagonal: shard
    ones_dst: np.ndarray  # and place
    groups: List[_SubGroup]

    @property
    def local_size(self) -> int:
        """The largest shard's pool, in entries (respatpu's per-device pool)."""
        return int(self.local_sizes.max(initial=1))


def build_sharded_plan(part: SupernodePartition, ndev: int,
                       max_pool_floats: int = 2**31) -> ShardedFrontalPlan:
    """The single-card frontal plan (``snlu_device.build_frontal_plan``:
    front shapes, groups, assembly map, extend-add positions) cut by
    subtree owner: each shard's fronts, group by group, with its own pool
    offsets, the split of every group's extend-add into the local part and
    the corners routed to other shards, and the assembly map into the
    shards' pools. ``max_pool_floats`` caps a shard's pool (plus its largest
    front): past it this raises ``MemoryError``. The pool is sharded, so a
    problem whose whole pool passes the cap factors as long as every shard's
    part fits."""
    base = F.build_frontal_plan(part, gather=False)  # a shard's extend-adds take the row regime
    nsn = part.nsn
    mp = base.wp + base.rp
    area = mp * mp
    parent = np.asarray(part.sn_parent, dtype=np.int64)
    owner = assign_subtrees(parent, area, ndev)

    # each shard's order of its fronts within every group, and so its offsets
    orders = []
    off_local = np.zeros(nsn, dtype=np.int64)
    sizes = np.zeros(ndev, dtype=np.int64)
    for g in base.groups:
        sn = g.snodes
        po = np.where(parent[sn] >= 0, owner[np.maximum(parent[sn], 0)], -1)
        per = []
        for d in range(ndev):
            idx = np.flatnonzero(owner[sn] == d)
            key = np.where((po[idx] < 0) | (po[idx] == d), 0, 1 + po[idx])
            idx = idx[np.argsort(key, kind="stable")]
            per.append(idx)
            if idx.size:
                sz = area[sn[idx]]
                off_local[sn[idx]] = sizes[d] + np.cumsum(sz) - sz
                sizes[d] += int(sz.sum())
        orders.append((po, per))
    if int(sizes.max(initial=0)) + int(area.max(initial=0)) >= max_pool_floats:
        raise MemoryError(f"a shard's pool would need {int(sizes.max()) / 2**28:.1f} GiB fp32 "
                          "(the pool ceiling); use more shards")

    groups: List[_SubGroup] = []
    stage = np.zeros(ndev, dtype=np.int64)
    for g, (po, per) in zip(base.groups, orders):
        sn = g.snodes
        parts: List[Optional[_ShardGroup]] = [None] * ndev
        incoming: List[List[_Remote]] = [[] for _ in range(ndev)]
        for d in range(ndev):
            idx = per[d]
            if idx.size == 0:
                continue
            sd = sn[idx]
            pd, ps = po[idx], parent[sd]
            nroot = int((pd < 0).sum())
            nloc = int(((pd < 0) | (pd == d)).sum())
            local = np.arange(idx.size) < nloc
            poff = np.where(local & (pd >= 0), off_local[np.maximum(ps, 0)], -1).astype(np.int64)
            seg_ptr = np.zeros(1, np.int32)
            if nloc > nroot:
                pl = ps[nroot:nloc]
                cuts = nroot + np.flatnonzero(np.r_[True, pl[1:] != pl[:-1]])
                seg_ptr = np.r_[cuts, nloc].astype(np.int32)
            red_rows, red_ptr, red_src, _ = F.reduction_csr(g.rsx[idx], part.n)
            for e in range(ndev):
                at = np.flatnonzero(pd == e) if e != d else np.empty(0, np.int64)
                if at.size == 0:
                    continue
                b0, b1 = int(at[0]), int(at[-1]) + 1
                pr = ps[b0:b1]
                rc = np.flatnonzero(np.r_[True, pr[1:] != pr[:-1]])
                incoming[e].append(_Remote(
                    src=d, b0=b0, b1=b1, lp=np.ascontiguousarray(g.lp[idx[b0:b1]]),
                    poff=off_local[pr].astype(np.int64), pmp=mp[pr].astype(np.int32),
                    seg_ptr=np.r_[rc, b1 - b0].astype(np.int32)))
                stage[e] = max(stage[e], (b1 - b0) * (g.rp + 1) ** 2)
            parts[d] = _ShardGroup(
                snodes=sd, g0=int(off_local[sd[0]]), nroot=nroot, nloc=nloc,
                piv=np.ascontiguousarray(g.piv[idx]), rsx=np.ascontiguousarray(g.rsx[idx]),
                lp=np.ascontiguousarray(g.lp[idx]), poff=poff,
                pmp=np.where(local, g.pmp[idx], 0).astype(np.int32), seg_ptr=seg_ptr,
                red_rows=red_rows, red_ptr=red_ptr, red_src=red_src)
        groups.append(_SubGroup(level=g.level, wp=g.wp, rp=g.rp, shards=parts,
                                incoming=incoming))

    # the assembly map and the padded pivots, moved from the single-card pool
    # layout (fronts ascending by offset there) into the shards' pools
    by_off = np.argsort(base.off, kind="stable")
    starts = base.off[by_off]

    def place(dst):
        sn = by_off[np.searchsorted(starts, dst, side="right") - 1]
        return owner[sn], dst - base.off[sn] + off_local[sn]

    asm_dev, asm_dst = place(base.asm_dst)
    ones_dev, ones_dst = place(base.ones_dst)
    return ShardedFrontalPlan(part=part, ndev=ndev, owner=owner, local_sizes=sizes,
                              stage_sizes=stage, total_front_vol=int(area.sum()),
                              asm_dev=asm_dev.astype(np.int32), asm_dst=asm_dst,
                              asm_nz=base.asm_nz, ones_dev=ones_dev, ones_dst=ones_dst,
                              groups=groups)


_ARRAYS = ("piv", "rsx", "lp", "poff", "pmp", "seg_ptr", "red_rows", "red_ptr", "red_src")
_FAR = ("piv", "red_rows", "red_ptr", "red_src")  # what a place needs of another's shard


class DistSubtreeLu(_OriginalSolves):
    """Subtree-sharded distributed multifrontal LU: factor and solves on the
    mesh, each shard's pool holding only its subtrees' fronts
    (``local_pool_bytes``); the factor never exists whole on any device.

    ``policy`` fp32 (and fp32_ftz, bf16) factors in an fp32 pool, fp64 in an
    fp64 one (respatpu's df64 refuses). ``part`` may be the supernodal
    partition of an earlier analysis of ``a``, which is then not run again.
    The padded pivots' diagonal, A's values and the factor are those of the
    single-card ``solve.SupernodalLuFactorization`` of the same partition;
    only the order in which a parent receives its children's corners
    differs where they lie on several shards."""

    matched = False

    def __init__(self, a: CSRMatrix, mesh: Optional[Mesh] = None,
                 policy: Union[str, Policy] = "fp32", order: str = "fillauto",
                 amalg: int = 32, pivot_eps: Optional[float] = None,
                 max_pool_floats: int = 2**31, part: Optional[SupernodePartition] = None):
        self._setup(a, mesh, policy, order, amalg, part, max_pool_floats, pivot_eps)
        self.report.t_factorize = self.refactorize_timed()

    @classmethod
    def from_factor(cls, a: CSRMatrix, part: SupernodePartition, values: np.ndarray,
                    mesh: Optional[Mesh] = None, policy: Union[str, Policy] = "fp32",
                    max_pool_floats: int = 2**31) -> "DistSubtreeLu":
        """The sharded factor of ``part`` whose factored values (filled-pattern
        layout, as ``factor_values`` gives them) are ``values``: scattered into
        the shards' pools, nothing factored (``refactorize_timed`` factors A's
        own values again)."""
        self = cls.__new__(cls)
        self._setup(a, mesh, policy, "fillauto", 32, part, max_pool_floats, None)
        self.pools = self._assemble(values, 1.0)
        self.mesh.synchronize()
        return self

    def _setup(self, a, mesh, policy, order, amalg, part, max_pool_floats, pivot_eps):
        self.mesh = mesh = mesh or make_mesh()
        self.ndev = mesh.size
        self.device = mesh.local_places[0].device
        policy = get_policy(policy)
        self.policy = policy
        self.a = a
        self.report = SolveReport(policy=policy.name)
        self._dtype = policy.accum_dtype  # bf16 values are factored in fp32
        self._itemsize = torch.finfo(self._dtype).bits // 8
        self._flush = policy.flush_to_zero
        for place in mesh.local_places:
            if place.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the front "
                                   "factorization needs full fp32 products")
        t0 = time.perf_counter()
        self._order, self._amalg = order, amalg  # persisted: a reload re-runs the analysis
        self.part = part if part is not None else analyze_supernodes(a, order=order, amalg=amalg)
        self.perm = self.part.perm
        self.plan = plan = build_sharded_plan(self.part, self.ndev,
                                              max_pool_floats=max_pool_floats)
        mesh.check_plan("DistSubtreeLu", policy.name, self.perm, plan.owner, plan.local_sizes,
                        plan.stage_sizes, [(g.level, g.wp, g.rp, [sg.nf if sg else 0
                                                                  for sg in g.shards])
                                           for g in plan.groups])
        self._perm_dev = torch.from_numpy(self.perm.astype(np.int64)).to(self.device)
        # every group's index arrays on this rank's shards, uploaded once; and at
        # each place the pivots and reduction lists of the other places' shards
        self._dev = []
        mesh.fork()
        for g in plan.groups:
            row: List[Optional[dict]] = [None] * self.ndev
            for d in mesh.local_shards:
                sg = g.shards[d]
                dev = mesh.shards[d].device
                with mesh.on(d):
                    t = ({k: torch.from_numpy(np.ascontiguousarray(getattr(sg, k))).to(dev)
                          for k in _ARRAYS} if sg is not None else {})
                    t["incoming"] = [{k: torch.from_numpy(getattr(r, k)).to(dev)
                                      for k in ("lp", "poff", "pmp", "seg_ptr")}
                                     for r in g.incoming[d]]
                    t["far"] = {}
                    if d == mesh.lead[mesh.shards[d].place]:
                        t["far"] = {e: {k: torch.from_numpy(np.ascontiguousarray(
                                        getattr(g.shards[e], k))).to(dev) for k in _FAR}
                                    for e in range(self.ndev) if g.shards[e] is not None
                                    and mesh.shards[e].place != mesh.shards[d].place}
                row[d] = t
            self._dev.append(row)
        mesh.join()
        self.mesh.synchronize()
        self.report.t_analyze = time.perf_counter() - t0
        f = self.part.filled
        amax = float(np.abs(f.data).max()) if f.nnz else 1.0
        self.pivot_eps = (F.default_pivot_eps(amax, self._dtype) if pivot_eps is None
                          else float(pivot_eps))
        self.report.factor_bytes = self.plan.total_front_vol * self._itemsize

    def _assemble(self, values: np.ndarray, ones: float, nz: Optional[np.ndarray] = None
                  ) -> List[torch.Tensor]:
        """Every shard's pool (with its staging area behind it): ``values``
        (filled-pattern layout) at their places (only the entries ``nz``,
        where given; the others 0), ``ones`` on the padded pivots' diagonal."""
        plan, mesh = self.plan, self.mesh
        if nz is None:
            nz = np.arange(plan.asm_dst.size)
        vals = np.asarray(values, np.float64)[nz]
        pools: List[Optional[torch.Tensor]] = [None] * self.ndev
        mesh.fork()
        for d in mesh.local_shards:
            dev = mesh.shards[d].device
            with mesh.on(d):
                pool = torch.zeros(int(plan.local_sizes[d] + plan.stage_sizes[d]),
                                   dtype=self._dtype, device=dev)
                sel = plan.asm_dev[nz] == d
                v = torch.from_numpy(vals[sel]).to(self._dtype)
                if self._flush:
                    v = torch.where(v.abs() < torch.finfo(v.dtype).tiny, torch.zeros_like(v), v)
                pool[torch.from_numpy(plan.asm_dst[nz][sel]).to(dev)] = v.to(dev)
                pool[torch.from_numpy(plan.ones_dst[plan.ones_dev == d]).to(dev)] = ones
            pools[d] = pool
        mesh.join()
        return pools

    def refactorize_timed(self) -> float:
        """Assemble the pools from A's values and factor them group by group
        on the mesh; the wall time to a device synchronize. Refreshes the
        stored factor."""
        self.pools = None
        mesh, plan, eps, fl = self.mesh, self.plan, self.pivot_eps, self._flush
        p = self.ndev
        t0 = time.perf_counter()
        pools = self._assemble(self.part.filled.data, max(1.0, eps * 1.001), plan.asm_nz)
        counts: List[list] = [[] for _ in range(p)]
        moved = mesh.bytes_moved + mesh.bytes_sent
        mesh.fork()
        for g, dg in zip(plan.groups, self._dev):
            wp, rp = g.wp, g.rp
            for d in mesh.local_shards:
                sg = g.shards[d]
                if sg is None:
                    continue
                t = dg[d]
                with mesh.on(d):
                    counts[d].append(F.factor_group(pools[d], sg.g0, sg.nf, wp, rp, eps,
                                                    fl).sum())
                    if sg.nloc > sg.nroot and rp:
                        k = sg.nloc
                        F.extend_add(pools[d], sg.g0, k, wp, rp, t["lp"][:k], t["poff"][:k],
                                     t["pmp"][:k], t["seg_ptr"], fl)
            if not rp:
                continue
            # the corners whose parents another shard owns, to the owner
            send: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in range(p)]
            expect: List[List[Optional[tuple]]] = [[None] * p for _ in range(p)]
            for e in range(p):
                for r in g.incoming[e]:
                    s, src = r.src, g.shards[r.src]
                    if mesh.is_local(s):
                        send[s][e] = pools[s][src.g0:src.g0 + src.nf * g.mp ** 2].view(
                            src.nf, g.mp, g.mp)[r.b0:r.b1, wp:, wp:]
                    expect[e][s] = ((r.b1 - r.b0, rp, rp), self._dtype)
            recv = mesh.all_to_all(send, expect)
            for e in mesh.local_shards:
                base = int(plan.local_sizes[e])
                for r, rt in zip(g.incoming[e], dg[e]["incoming"]):
                    nr = r.b1 - r.b0
                    with mesh.on(e):
                        staged = pools[e][base:base + nr * (rp + 1) ** 2].view(nr, rp + 1, rp + 1)
                        staged[:, 1:, 1:].copy_(recv[e][r.src])
                        F.extend_add(pools[e], base, nr, 1, rp, rt["lp"], rt["poff"],
                                     rt["pmp"], rt["seg_ptr"], fl)
        nbad = mesh.map(lambda d, c: torch.stack(c).sum() if c else None, counts)
        mesh.join()
        mine = sum(int(nbad[d]) for d in mesh.local_shards if nbad[d] is not None)
        self.report.n_pivot_perturbed = int(mesh.rank_values([mine]).sum())
        self.mesh.synchronize()
        self.pools = pools
        self.bytes_exchanged = mesh.bytes_moved + mesh.bytes_sent - moved
        return time.perf_counter() - t0

    def factor_values(self) -> np.ndarray:
        """Factored entries in ``part.filled.data`` layout (host fp64, the
        pools' accuracy), for persistence and checks: each shard's pool
        pulled once, into host memory. A mesh over ranks refuses: each rank
        holds only its own shards' pools (``pools[d]``)."""
        if self.mesh.ranks > 1:
            raise ValueError("factor_values: the factor's pools lie on several ranks; each rank "
                             "holds its own shards' pools only")
        plan = self.plan
        out = np.empty(plan.asm_dst.size, np.float64)
        self.mesh.join()
        for d, pool in enumerate(self.pools):
            sel = plan.asm_dev == d
            out[sel] = pool[:int(plan.local_sizes[d])].to("cpu", torch.float64).numpy()[
                plan.asm_dst[sel]]
        return out

    @property
    def local_pool_bytes(self) -> int:
        """The largest shard's pool (the memory-scaling claim)."""
        return self.plan.local_size * self._itemsize

    @property
    def replicated_pool_bytes(self) -> int:
        """What one unsharded pool holds: every front."""
        return self.plan.total_front_vol * self._itemsize

    def solve_device(self, bp: torch.Tensor) -> torch.Tensor:
        """Solve L U x = bp in permuted coordinates, ``bp`` [n] at this rank's
        first place; x in the pool's type there (over ranks, every rank
        passes the same b and gets the whole x). The right-hand side is held
        once a place: K4 on every shard's fronts of a group; then every other
        place receives the shard's solved pivots and, forward, its updates,
        which K5 adds into every place's copy in shard order."""
        mesh, plan = self.mesh, self.plan
        n, fl, item, p = self.part.n, self._flush, self._itemsize, self.ndev
        mesh.fork()
        first = mesh.lead[mesh.local_places[0]]
        ys = {}
        for place in mesh.local_places:
            lead = mesh.lead[place]
            mesh.wait(lead, [first])
            with mesh.on(lead):
                y = torch.zeros(n + 1, dtype=self._dtype, device=place.device)
                y[:n] = bp.to(self._dtype).to(place.device)
            ys[place] = y
        for d in mesh.local_shards:
            mesh.wait(d, [mesh.lead[mesh.shards[d].place]])
        # each shard's control words for the whole solve, zeroed on its stream
        ctl, at = {}, {}
        for d in mesh.local_shards:
            words = [F.control_words(g.shards[d].nf, g.wp, g.rp, item)
                     if g.shards[d] is not None else 0 for g in plan.groups]
            at[d] = np.r_[0, np.cumsum(words)].tolist()
            with mesh.on(d):
                ctl[d] = torch.zeros(2 * at[d][-1], dtype=torch.int32,
                                     device=mesh.shards[d].device)

        def sweep(gi, forward):
            g, dg = plan.groups[gi], self._dev[gi]
            add = forward and g.rp > 0
            upd = {}
            for d in mesh.local_shards:
                sg = g.shards[d]
                if sg is None:
                    continue
                t = dg[d]
                base = 0 if forward else at[d][-1]
                with mesh.on(d):
                    upd[d] = F.front_sweep(
                        self.pools[d], ys[mesh.shards[d].place], sg.g0, sg.nf, g.wp, g.rp,
                        t["piv"], t["rsx"], forward, fl,
                        control=ctl[d][base + at[d][gi]:base + at[d][gi + 1]])
            # a shard's solved pivots (and updates) to every other place
            send: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in range(p)]
            expect: List[List[Optional[tuple]]] = [[None] * p for _ in range(p)]
            for d, sg in enumerate(g.shards):
                if sg is None:
                    continue
                for place in mesh.places:
                    lead = mesh.lead[place]
                    if place == mesh.shards[d].place:
                        continue
                    if mesh.is_local(d):
                        with mesh.on(d):
                            z = ys[mesh.shards[d].place][dg[d]["piv"].long()].reshape(-1)
                            send[d][lead] = torch.cat([z, upd[d].reshape(-1)]) if add else z
                    expect[lead][d] = ((sg.nf * (g.wp + g.rp * add),), self._dtype)
            recv = mesh.all_to_all(send, expect)
            for place in mesh.local_places:
                lead = mesh.lead[place]
                mesh.wait(lead, list(upd))
                for d, sg in enumerate(g.shards):
                    if sg is None:
                        continue
                    got = recv[lead][d]
                    if got is None:  # a shard of this place
                        red = dg[d]
                        u = mesh.take(upd[d], d, lead, count=False) if add else None
                    else:
                        red = dg[lead]["far"][d]
                        zn = sg.nf * g.wp
                        with mesh.on(lead):
                            ys[place][red["piv"].long()] = got[:zn].view(sg.nf, g.wp)
                        u = got[zn:].view(sg.nf, g.rp) if add else None
                    if add:
                        with mesh.on(lead):
                            F.rows_reduce(ys[place], u, red["red_rows"], red["red_ptr"],
                                          red["red_src"], fl)
            for d in mesh.local_shards:
                mesh.wait(d, [mesh.lead[mesh.shards[d].place]])

        ng = len(plan.groups)
        for gi in range(ng):
            sweep(gi, True)
        for gi in range(ng - 1, -1, -1):
            sweep(gi, False)
        with mesh.on(first):
            x = ys[mesh.local_places[0]][:n]
        mesh.join()
        return x

    def solve_refined(self, b: np.ndarray, tol: float = 1e-12, max_iters: int = 30) -> np.ndarray:
        """Refinement around the sharded factor (``solve.solve_refined``:
        fp64 residuals on K0 at this rank's first place, the distributed
        solves as corrections, one host wait an iteration, GMRES-IR where
        plain refinement stalls; over ranks, the same on every rank).
        Returns x; ``report`` holds its numbers."""
        x, rep = solve_refined(self.a, b, fac=self, tol=tol, max_iters=max_iters)
        self.report.t_solve, self.report.iterations = rep.t_solve, rep.iterations
        self.report.residual, self.report.converged = rep.residual, rep.converged
        return x


def dist_factorize_sharded(a: CSRMatrix, mesh: Optional[Mesh] = None, **kw) -> DistSubtreeLu:
    return DistSubtreeLu(a, mesh=mesh, **kw)
