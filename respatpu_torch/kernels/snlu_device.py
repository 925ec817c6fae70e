"""Device numeric multifrontal LU: batched frontal partial LU, extend-add and
the frontal triangular solves, straight from one pool of dense fronts.

The counterpart of ``respatpu/kernels/snlu_device.py`` (the symbolic analysis
lives in kernels/snlu.py): PARDISO phases 22 and 33 (test_pardiso.c:204-244)
for patterns whose dense band does not fit. Every front is a dense matrix
padded to a bucket shape (``wp`` pivot columns + ``rp`` update rows), so the
O(fill^1.5) flops run as batched dense block operations.

What is carried over is what respatpu computes; how differs, because nothing
here is compiled per shape and the card gathers in hardware:

* the pool is laid out group by group, so a (tree level, bucket shape) group
  of B fronts is one contiguous view ``pool[g0 : g0 + B*mp*mp].view(B, mp,
  mp)``: no gather and no write-back around a group, and no batch padding;
* offsets are int64 throughout; the pool's ceiling is a memory guard that
  raises ``MemoryError`` with the size needed;
* the extend-add needs O(r) indices a front (``lp``: the position of each
  update row in the parent front), not O(r^2) source/destination pairs, and
  all of the plan is built with array operations, no loop over fronts;
* the solves read only the blocks they use (L11/L21 forward, U11/U12
  backward) as strided views of the pool.

A group's pivot blocks are factored by the block-LU kernel of the band path
(``kernels.bandlu.block_lu``: batched, static pivot perturbation with a
count; it perturbs ``|d| <= eps`` where respatpu's front code has ``< eps``,
which differs only for a pivot equal to eps bit for bit), 128 pivots at a
time; between its launches the two triangular solves and the trailing product
of a block step are large dense operations and go to
``torch.linalg.solve_triangular`` and ``baddbmm_`` with TF32 off, as respatpu
leaves them to XLA. Three hand-written CUDA kernels (``csrc/frontal.cu``)
take the data-dependent steps:

* ``extend_add``: each front's Schur corner into its parent front, the
  parent's children in plan order, no atomics, by a regime picked from the
  group's shape at plan time (``add_regime``): a thread a parent entry over
  the plan's lists of its sources where parents have many small children
  (``gather_lists``), the parents' rows piece by piece elsewhere;
* ``front_sweep``: one group's forward or backward substitution in one launch,
  by a regime picked from the group's shape at plan time (``sweep_regime``):
  a warp a front for pivot blocks up to 32, a thread block a front (its panel
  over several blocks where it has many update rows) up to ``MAX_TRI``, and
  for wider fronts a blocked substitution that reads the triangle in place;
* ``rows_reduce``: the forward sweep's updates summed into y per destination
  row in plan order, no atomics, the rows binned by their number of sources;
* ``front_sweep_t`` (K12): the transposed system's group solves (``U^T``
  forward, ``L^T`` backward; the condition estimate's) in the sweep's three
  regimes, by kernels of their own whose lanes run along the fronts' rows
  (the wide regime streams its tiles through shared memory).

Each has its plain PyTorch version beside it (``extend_add_plain``,
``front_sweep_plain``, ``rows_reduce_plain``, ``front_sweep_t_plain``). A
wrapper launches its kernel for a CUDA tensor and runs the plain version for
a CPU tensor; nothing else chooses. On a card ``FrontalSolver`` replays a
solve's launches as one CUDA graph. The factored pool and every solve repeat
bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..precision import ftz
from ..timing import count
from .bandlu import MAX_P, block_lu
from .snlu import SupernodePartition

__all__ = ["FrontalPlan", "build_frontal_plan", "frontal_factor_pool",
           "values_from_pool", "FrontalSolver", "factor_group", "reduction_csr",
           "assemble_pool", "default_pivot_eps", "extend_add",
           "extend_add_plain", "front_sweep", "front_sweep_plain", "front_sweep_t",
           "front_sweep_t_plain", "rows_reduce", "rows_reduce_plain",
           "launch_sweep", "control_words", "control_zeros", "sweep_regime", "warp_deal",
           "add_regime", "gather_lists", "LAUNCHES", "MAX_TRI", "RED_BINS", "GATHER_KIDS",
           "GATHER_RP", "GATHER_CAP"]

MAX_TRI = 128  # widest pivot block a thread block solves (kMaxTri of csrc/frontal.cu)
WARP_TRI = 32  # widest pivot block a warp solves in registers (kWarpTri)
TILE_ROWS = 64  # fewest update rows a tile of a block-regime front takes
FILL_BLOCKS = 264  # thread blocks that fill the card twice over (132 SMs)
# rows_reduce's bins: rows of at most 8 sources (a lane each), at most 64 (8
# lanes each), more (a warp each): kThreadRow, kGroupRow, kGroupLanes
RED_BINS = ((8, 1), (64, 8), (None, 32))
_REGIMES = {"warp": 0, "block": 1, "wide": 2}
# extend-add: the gather regime takes groups with GATHER_KIDS or more children
# under a parent, corners of at most GATHER_RP update rows, and lists that fit
# in GATHER_CAP 4-byte words a corner entry (padding included)
GATHER_KIDS = 8
GATHER_RP = 128
GATHER_CAP = 2
_ADD_REGIMES = {"rows": 0, "gather": 1}

_INST = {(torch.float32, False): "f32", (torch.float32, True): "f32_ftz",
         (torch.float64, False): "f64"}
_EXTEND_ADD = tuple(f"respa_extend_add_{i}" for i in ("f32", "f32_ftz", "f64"))
_FRONT_SWEEP = tuple(f"respa_front_sweep_{t}{d}_{i}" for t in ("", "t_") for d in ("fwd", "bwd")
                     for i in ("f32", "f32_ftz", "f64"))
_ROWS_REDUCE = ("respa_rows_reduce_f32", "respa_rows_reduce_f64")

# Kernel launches per entry point of the library, raised by the wrappers right
# after each launch succeeds and nowhere else.
LAUNCHES = {name: 0 for name in (*_EXTEND_ADD, *_FRONT_SWEEP, *_ROWS_REDUCE)}

_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
           1536, 2048, 3072, 4096, 6144, 8192)


def _pad_dim(x: int) -> int:
    """Pad a front dimension to a small bucket schedule (x2/x1.5 ladder), so
    that fronts of near sizes share a group and the kernels see few shapes;
    beyond the ladder, to multiples of 2048. The schedule is respatpu's, so
    both packages give a front the same shape."""
    if x <= 0:
        return 0
    for v in _LADDER:
        if x <= v:
            return v
    return int(-(-x // 2048) * 2048)


def _pad_dims(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    ladder = np.asarray(_LADDER, dtype=np.int64)
    small = ladder[np.minimum(np.searchsorted(ladder, x), ladder.size - 1)]
    out = np.where(x <= ladder[-1], small, -(-x // 2048) * 2048)
    return np.where(x <= 0, 0, out)


@dataclasses.dataclass
class _Group:
    """One batched factor call: fronts of equal bucket shape in one level, in
    pool order (sorted by parent, roots first)."""
    level: int
    wp: int  # padded pivot width
    rp: int  # padded update-row count
    snodes: np.ndarray  # int64[B] member supernode ids
    g0: int  # pool offset of the group's first front
    piv: np.ndarray  # int32[B, wp] global pivot rows (pad -> n)
    rsx: np.ndarray  # int32[B, rp] global update rows (pad -> n)
    lp: np.ndarray  # int32[B, rp] position of each update row in the parent front (pad -> -1)
    poff: np.ndarray  # int64[B] the parent front's pool offset (root -> -1)
    pmp: np.ndarray  # int32[B] the parent front's size (root -> 0)
    seg_ptr: np.ndarray  # int32[nseg + 1] runs of members with one parent
    red_rows: np.ndarray  # int32[nd] update rows this group touches, ascending
    red_ptr: np.ndarray  # int64[nd + 1] CSR over red_src
    red_src: np.ndarray  # int32[sum r] flat index into upd[B, rp], plan order within a row
    red_bins: np.ndarray  # int64[len(RED_BINS)] rows in each bin of RED_BINS
    regime: str  # the sweep kernel's regime for this shape (sweep_regime)
    tiles: int  # thread blocks a front in the block regime, else 1
    add: str = "rows"  # the extend-add kernel's regime (add_regime)
    ga_base: int = 0  # gather regime: pool offset that ga_dst counts from
    ga_dst: np.ndarray = dataclasses.field(  # int32[nd] parent entries the group touches
        default_factory=lambda: np.empty(0, np.int32))
    ga_src: np.ndarray = dataclasses.field(  # int32: their sources, offsets from g0, by rank
        default_factory=lambda: np.empty(0, np.int32))
    ga_ptr: np.ndarray = dataclasses.field(  # int32[kmax + 1]: rank k's run of ga_src
        default_factory=lambda: np.empty(0, np.int32))

    @property
    def mp(self) -> int:
        return self.wp + self.rp

    @property
    def nfronts(self) -> int:
        return int(self.snodes.size)


@dataclasses.dataclass
class FrontalPlan:
    """Host-precomputed static structure for the device numeric phase."""
    part: SupernodePartition
    pool_size: int
    off: np.ndarray  # int64[nsn] pool offset per front (group-by-group layout)
    wp: np.ndarray  # int64[nsn]
    rp: np.ndarray  # int64[nsn]
    asm_dst: np.ndarray  # int64[fill nnz] flat pool position of filled.data[k]
    asm_nz: np.ndarray  # int64: the k with filled.data[k] != 0 (A's entries; the rest is fill)
    ones_dst: np.ndarray  # padded-pivot diagonal positions (init to 1.0)
    groups: List[_Group]  # level-ordered batched factor calls
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)
    _assembly: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def asm_src(self) -> np.ndarray:
        """filled.data index per assembled entry: every entry, in order."""
        return np.arange(self.asm_dst.size, dtype=np.int64)

    def on_device(self, device: torch.device) -> List[Dict[str, torch.Tensor]]:
        """The groups' index arrays as tensors on ``device`` (uploaded once)."""
        device = torch.device(device)
        if device not in self._device:
            names = ("piv", "rsx", "lp", "poff", "pmp", "seg_ptr", "red_rows",
                     "red_ptr", "red_src", "ga_dst", "ga_src", "ga_ptr")
            self._device[device] = [
                {k: torch.from_numpy(getattr(g, k)).to(device) for k in names}
                for g in self.groups]
            for g, d in zip(self.groups, self._device[device]):
                d["gather"] = ((g.ga_base, d["ga_dst"], d["ga_src"], d["ga_ptr"])
                               if g.add == "gather" else None)
        return self._device[device]


_USE_NATIVE = True  # False: the assembly map by array operations


def _native_ok() -> bool:
    if not _USE_NATIVE:
        return False
    from ..io import native
    return native.available()


def warp_deal(nd: int) -> np.ndarray:
    """Where the reduction kernel's layout puts the k-th of ``nd`` rows: the
    rows are dealt to warps of 32 consecutive positions one at a time, warp
    after warp (k-th row to warp k mod W, W = ceil(nd / 32), the last warp
    short), so that a warp holds at most a share of the long rows."""
    w = max(-(-nd // 32), 1)
    pos = (np.arange(32, dtype=np.int64)[:, None] + 32 * np.arange(w, dtype=np.int64)[None, :])
    pos = pos.ravel()
    return pos[pos < nd]


def reduction_csr(rsx: np.ndarray, n: int):
    """The forward sweep's gather for one group: from ``rsx`` int32[B, rp]
    (entries >= n are padding) the destination rows it touches
    (``red_rows`` int32[nd]), and for each the flat positions in ``upd``
    [B, rp] that feed it, in plan order (``red_ptr`` int64[nd + 1] over
    ``red_src`` int32). The rows are cut into the bins of ``RED_BINS`` by
    their number of sources (``red_bins`` int64: the rows in each) and laid
    out by :func:`warp_deal` in the order longest bin first, ascending within
    a bin: a warp of the kernel takes its 32 rows with few long ones."""
    flat = rsx.ravel()
    src = np.flatnonzero(flat < n)
    dest = flat[src]
    by_row = np.argsort(dest, kind="stable")
    dest, src = dest[by_row], src[by_row]
    first = (np.flatnonzero(np.r_[True, dest[1:] != dest[:-1]]) if dest.size
             else np.empty(0, np.int64))
    count = np.diff(np.r_[first, dest.size])
    limits = np.asarray([most for most, _ in RED_BINS[:-1]])
    bin_of = np.searchsorted(limits, count, side="left")
    order = np.empty(first.size, np.int64)
    order[warp_deal(first.size)] = np.argsort(-bin_of, kind="stable")
    count = count[order]
    ptr = np.r_[0, np.cumsum(count)].astype(np.int64)
    take = np.repeat(first[order] - ptr[:-1], count) + np.arange(dest.size)
    return (dest[first[order]].astype(np.int32), ptr, src[take].astype(np.int32),
            np.bincount(bin_of, minlength=len(RED_BINS)).astype(np.int64))


def sweep_regime(nf: int, wp: int, rp: int) -> Tuple[str, int]:
    """The sweep kernel's regime for a group of ``nf`` fronts of ``wp`` +
    ``rp``, and its tiles: ``wide`` past ``MAX_TRI`` pivots; else the panel
    of a front with many update rows is cut into tiles of at least
    ``TILE_ROWS`` rows, as many as fill the card with the group's fronts;
    ``warp`` for an untiled front of at most ``WARP_TRI`` pivots, ``block``
    otherwise."""
    if wp > MAX_TRI:
        return "wide", 1
    tiles = max(1, min(rp // TILE_ROWS, -(-FILL_BLOCKS // nf), 65535))
    if tiles == 1 and wp <= WARP_TRI:
        return "warp", 1
    return "block", tiles


def gather_lists(lp: np.ndarray, poff: np.ndarray, pmp: np.ndarray, seg_ptr: np.ndarray,
                 wp: int, rp: int):
    """The extend-add's gather lists for one group of ``lp.shape[0]`` fronts
    (``_Group``'s arrays): ``(base, dst, src, ptr)``, or None where an offset
    would not fit 32 bits.

    Every parent entry that a corner entry in use reaches gets one place in
    ``dst`` (int32, its pool offset less ``base``), the entries ordered by
    their number of sources, most first (so that the entries with more than
    k sources are the first ones), then by offset, so that neighbouring
    threads of the kernel write neighbouring parent entries. Its k-th source
    in plan order (the children in pool order) is ``src[ptr[k] + d]``
    (int32, the corner entry's offset from the group's first front) for
    ``d < ptr[k + 1] - ptr[k]``."""
    nf = lp.shape[0]
    mp = wp + rp
    first = int(seg_ptr[0]) if seg_ptr.size > 1 else nf
    if first >= nf or rp == 0:
        return 0, np.empty(0, np.int32), np.empty(0, np.int32), np.zeros(1, np.int32)
    l = lp[first:].astype(np.int64)
    cnt = (l >= 0).sum(1)
    sq = cnt * cnt
    b = np.repeat(np.arange(cnt.size), sq)
    within = np.arange(int(sq.sum()), dtype=np.int64) - (np.cumsum(sq) - sq)[b]
    i, j = np.divmod(within, cnt[b])
    flat = l.ravel()
    row = b * rp
    dst = poff[first:][b] + flat[row + i] * pmp[first:].astype(np.int64)[b] + flat[row + j]
    src = (b + first) * (mp * mp) + (wp + i) * mp + (wp + j)
    del b, within, i, j, row
    # by entry (a stable sort keeps the children's order), rank within the entry
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    heads = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
    count = np.diff(np.r_[heads, dst.size])
    rank = np.arange(dst.size) - np.repeat(heads, count)
    # most sources first: the few entries with several, then the rest in order
    many = np.flatnonzero(count > 1)
    by = np.r_[many[np.argsort(-count[many], kind="stable")], np.flatnonzero(count == 1)]
    place = np.empty(heads.size, np.int64)
    place[by] = np.arange(heads.size)
    kmax = int(count.max())
    longer = heads.size - np.r_[0, np.cumsum(np.bincount(count, minlength=kmax + 1))[1:kmax]]
    ptr = np.r_[0, np.cumsum(longer)]
    out_dst = np.empty(heads.size, np.int64)
    out_dst[place] = dst[heads]
    out_src = np.empty(src.size, np.int64)
    out_src[ptr[rank] + np.repeat(place, count)] = src
    base = int(out_dst.min())
    if int(out_dst.max()) - base >= 2**31 or nf * mp * mp >= 2**31 or out_src.size >= 2**31:
        return None
    return (base, (out_dst - base).astype(np.int32), out_src.astype(np.int32),
            ptr.astype(np.int32))


def add_regime(nf: int, rp: int, most_children: int, list_words: Optional[int]) -> str:
    """The extend-add kernel's regime for a group of ``nf`` fronts with
    ``rp`` update rows, at most ``most_children`` of them under one parent,
    whose gather lists take ``list_words`` 4-byte words (None: not made, or
    past 32-bit offsets): ``gather`` where the row regime would walk
    ``GATHER_KIDS`` or more children of a parent one after the other, for
    corners of at most ``GATHER_RP`` rows whose lists fit in ``GATHER_CAP``
    words a corner entry (the padded corners' ``nf * rp^2``); else ``rows``.
    The lists cost host time at analysis and device memory beside the pool,
    so the groups whose rows the row regime adds well keep it."""
    if (list_words is not None and 0 < rp <= GATHER_RP and most_children >= GATHER_KIDS
            and list_words <= GATHER_CAP * nf * rp * rp):
        return "gather"
    return "rows"


def build_frontal_plan(part: SupernodePartition, itemsize: int = 4,
                       max_pool_bytes: Optional[int] = None,
                       gather: bool = True) -> FrontalPlan:
    """Vectorized host analysis: pool layout, assembly scatter, extend-add
    positions and regimes (with the gather lists), level/bucket grouping,
    the solves' index arrays.

    ``max_pool_bytes`` caps the flat pool of ``itemsize``-byte values; a pool
    past it raises ``MemoryError`` naming the size needed (None: no cap).
    ``gather=False`` makes no gather lists: every group's extend-add takes
    the row regime (the subtree-sharded plan, which splits the groups)."""
    n, nsn = part.n, part.nsn
    sp = part.snode_ptr
    w = np.diff(sp).astype(np.int64)
    r = np.array([rs.size for rs in part.rowstruct], dtype=np.int64)
    wp, rp = _pad_dims(w), _pad_dims(r)
    mp = wp + rp
    pool_size = int((mp * mp).sum())
    if max_pool_bytes is not None and pool_size * itemsize > max_pool_bytes:
        raise MemoryError(
            f"front pool would need {pool_size * itemsize / 2**30:.1f} GiB "
            f"({nsn} fronts, widest {int(mp.max(initial=0))}) against a budget of "
            f"{max_pool_bytes / 2**30:.1f} GiB")
    parent = np.asarray(part.sn_parent, dtype=np.int64)

    # pool order: by level, then bucket shape, then parent (roots first), then id
    level = np.zeros(nsn, dtype=np.int64)
    for lvl, members in enumerate(part.levels):
        level[np.asarray(members, dtype=np.int64)] = lvl
    shape_key = (level << 42) + (wp << 21) + rp
    order = np.lexsort((np.arange(nsn), parent, shape_key))
    off = np.empty(nsn, dtype=np.int64)
    sizes = (mp * mp)[order]
    off[order] = np.cumsum(sizes) - sizes

    # concatenated row structures with a globally-sorted key so that the
    # local position of row g inside snode s's structure is ONE searchsorted
    rs_ptr = np.zeros(nsn + 1, dtype=np.int64)
    np.cumsum(r, out=rs_ptr[1:])
    RS = (np.concatenate(part.rowstruct) if nsn and rs_ptr[-1] else
          np.empty(0, dtype=np.int64)).astype(np.int64)
    rs_sn = np.repeat(np.arange(nsn, dtype=np.int64), r)
    rs_keys = rs_sn * np.int64(n + 1) + RS

    def loc(sn: np.ndarray, g: np.ndarray) -> np.ndarray:
        """Local front position of global row/col g inside front sn."""
        in_piv = g < sp[sn + 1]
        key = sn * np.int64(n + 1) + g
        if rs_keys.size == 0:
            # no sub-diagonal fill anywhere (e.g. diagonal matrix): every
            # entry must sit inside its pivot block
            if not np.all(in_piv):
                raise AssertionError(
                    "entry outside pivot block but rowstruct is empty")
            return g - sp[sn]
        pos_rs = np.searchsorted(rs_keys, key)
        hit = rs_keys[np.minimum(pos_rs, rs_keys.size - 1)] == key
        if not np.all(in_piv | hit):
            raise AssertionError(
                "filled pattern is not structurally symmetric: an entry "
                "falls outside its front's row structure")
        return np.where(in_piv, g - sp[sn], wp[sn] + (pos_rs - rs_ptr[sn]))

    # ---- assembly map: every filled entry belongs to exactly one front ----
    f = part.filled
    if _native_ok():
        from ..io import native
        asm_dst = native.frontal_asm_dst(n, f.indptr, f.indices, sp, rs_ptr, RS, off, wp, mp)
    else:
        col2sn = np.repeat(np.arange(nsn, dtype=np.int64), w)
        rows = np.repeat(np.arange(n, dtype=np.int64), f.row_lengths())
        cols = f.indices.astype(np.int64)
        owner = np.minimum(col2sn[rows], col2sn[cols])  # the snode holding min(i, j)
        asm_dst = off[owner] + loc(owner, rows) * mp[owner] + loc(owner, cols)
        del rows, cols, owner

    # padded pivot diagonal -> 1.0 (factors as identity, harmless)
    cnt = wp - w
    grp = np.repeat(np.arange(nsn, dtype=np.int64), cnt)
    base = np.zeros(nsn + 1, dtype=np.int64)
    np.cumsum(cnt, out=base[1:])
    within = np.arange(int(base[-1]), dtype=np.int64) - np.repeat(base[:-1], cnt)
    t = w[grp] + within
    ones_dst = off[grp] + t * mp[grp] + t

    # ---- extend-add positions: each update row's place in the parent front,
    # for every front at once, aligned with RS ----
    lp_flat = (loc(parent[rs_sn], RS) if RS.size else np.empty(0, np.int64))

    # ---- level/bucket groups ----
    groups: List[_Group] = []
    skey = shape_key[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]]) if nsn else np.empty(0, np.int64)
    for a, b in zip(starts, np.r_[starts[1:], nsn]):
        sel = order[a:b]
        nf = sel.size
        gwp, grp_ = int(wp[sel[0]]), int(rp[sel[0]])
        if nf * max(gwp, grp_, 1) >= 2**31:
            raise MemoryError(f"a group of {nf} fronts {gwp}+{grp_} outgrows 32-bit row indices")
        cw = np.arange(gwp, dtype=np.int64)[None, :]
        piv = np.where(cw < w[sel][:, None], sp[sel][:, None] + cw, n).astype(np.int32)
        cr = np.arange(grp_, dtype=np.int64)[None, :]
        used = cr < r[sel][:, None]
        at = np.minimum(rs_ptr[sel][:, None] + cr, max(RS.size - 1, 0))
        if RS.size:
            rsx = np.where(used, RS[at], n).astype(np.int32)
            lp = np.where(used, lp_flat[at], -1).astype(np.int32)
        else:
            rsx = np.full((nf, grp_), n, dtype=np.int32)
            lp = np.full((nf, grp_), -1, dtype=np.int32)
        par = parent[sel]
        has = par >= 0
        poff = np.where(has, off[np.maximum(par, 0)], -1).astype(np.int64)
        pmp = np.where(has, mp[np.maximum(par, 0)], 0).astype(np.int32)
        nroot = int(nf - has.sum())  # sorted by parent: the roots come first
        cut = nroot + np.flatnonzero(np.r_[True, par[nroot + 1:] != par[nroot:-1]]) \
            if nroot < nf else np.empty(0, np.int64)
        seg_ptr = np.r_[cut, nf].astype(np.int32) if cut.size else np.zeros(1, np.int32)
        red_rows, red_ptr, red_src, red_bins = reduction_csr(rsx, n)
        regime, tiles = sweep_regime(nf, gwp, grp_)
        lists, add = None, "rows"
        most = int(np.diff(seg_ptr).max(initial=0))
        if gather and add_regime(nf, grp_, most, 0) == "gather":  # the lists could pay
            used = (lp[nroot:] >= 0).sum(1).astype(np.int64)
            if int((used * used).sum()) < GATHER_CAP * nf * grp_ * grp_:  # can fit at all
                lists = gather_lists(lp, poff, pmp, seg_ptr, gwp, grp_)
                if lists is not None:
                    add = add_regime(nf, grp_, most, sum(int(x.size) for x in lists[1:]))
        groups.append(_Group(
            level=int(level[sel[0]]), wp=gwp, rp=grp_, snodes=sel, g0=int(off[sel[0]]),
            piv=piv, rsx=rsx, lp=lp, poff=poff, pmp=pmp, seg_ptr=seg_ptr,
            red_rows=red_rows, red_ptr=red_ptr, red_src=red_src, red_bins=red_bins,
            regime=regime, tiles=tiles, add=add,
            **(dict(zip(("ga_base", "ga_dst", "ga_src", "ga_ptr"), lists))
               if add == "gather" else {})))

    return FrontalPlan(part=part, pool_size=pool_size, off=off, wp=wp, rp=rp,
                       asm_dst=asm_dst, asm_nz=np.flatnonzero(f.data), ones_dst=ones_dst,
                       groups=groups)


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _library():
    from . import _build
    lib = _build.load()
    if lib.respa_front_max_tri() != MAX_TRI:
        raise RuntimeError(f"frontal.cu solves triangles up to {lib.respa_front_max_tri()}, "
                           f"the wrappers expect {MAX_TRI}")
    return lib


def _instance(pool: torch.Tensor, flush: bool) -> str:
    try:
        return _INST[pool.dtype, bool(flush)]
    except KeyError:
        raise TypeError(f"no frontal kernel for {pool.dtype}"
                        f"{' with flush-to-zero' if flush else ''}") from None


def _check_group(pool: torch.Tensor, g0: int, nf: int, wp: int, rp: int, **index):
    mp = wp + rp
    if pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError("the pool must be a flat contiguous tensor")
    if nf < 1 or wp < 1 or rp < 0 or g0 < 0 or g0 + nf * mp * mp > pool.numel():
        raise ValueError(f"group of {nf} fronts {wp}+{rp} at {g0} does not lie in a "
                         f"pool of {pool.numel()}")
    for name, (t, shape, dtype) in index.items():
        if (t.device != pool.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype}{list(shape)} on {pool.device}, "
                             f"got {t.dtype}{list(t.shape)} on {t.device}")


def _fronts(pool: torch.Tensor, g0: int, nf: int, mp: int) -> torch.Tensor:
    return pool[g0:g0 + nf * mp * mp].view(nf, mp, mp)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def extend_add_plain(pool: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
                     lp: torch.Tensor, poff: torch.Tensor, pmp: torch.Tensor,
                     seg_ptr: torch.Tensor, flush: bool = False) -> None:
    """The extend-add kernel's function in plain torch ops, on any device:
    for every front b of the group with a parent, in pool order,
    ``parent[lp[b, i], lp[b, j]] += F_b[wp + i, wp + j]`` over the update rows
    in use, flushed under ``flush``. Round k adds the k-th child of every
    parent: no two fronts of a round share a destination, and a parent gets
    its children in the kernel's order (in either of its regimes)."""
    if seg_ptr.numel() < 2 or rp == 0:
        return
    mp = wp + rp
    corner = _fronts(pool, g0, nf, mp)[:, wp:, wp:]
    seg = seg_ptr.long()
    lens = seg[1:] - seg[:-1]
    first = int(seg[0])
    rank = torch.arange(first, nf, device=pool.device) - torch.repeat_interleave(seg[:-1], lens)
    for k in range(int(lens.max())):
        sel = first + torch.nonzero(rank == k)[:, 0]
        l = lp[sel].long()
        ok = l >= 0
        dst = (poff[sel][:, None, None] + l[:, :, None] * pmp[sel].long()[:, None, None]
               + l[:, None, :])
        m = ok[:, :, None] & ok[:, None, :]
        d = dst[m]
        pool[d] = ftz(pool[d] + corner[sel][m], flush)


def extend_add(pool: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
               lp: torch.Tensor, poff: torch.Tensor, pmp: torch.Tensor,
               seg_ptr: torch.Tensor, flush: bool = False, gather=None) -> None:
    """Add the Schur corners of one group's fronts into their parent fronts,
    in place in ``pool``; see :func:`extend_add_plain` for the function and
    :class:`_Group` for the index arrays.

    ``gather`` is the group's ``(base, dst, src, ptr)`` from
    :func:`gather_lists` as tensors on the pool's device (the plan's
    ``on_device(...)[g]["gather"]``), or None. On a CUDA device this is one
    launch of the extend-add kernel on the current stream (none for a group
    without parents): its gather regime over the lists where they are given,
    else its row regime; it raises if the inputs do not fit the kernel or
    the launch fails. On the CPU it runs the plain version. Either way a
    parent's entries get their children's values in pool order, so the two
    regimes give the same bits."""
    nseg = int(seg_ptr.numel()) - 1
    _check_group(pool, g0, nf, wp, rp, lp=(lp, (nf, rp), torch.int32),
                 poff=(poff, (nf,), torch.int64), pmp=(pmp, (nf,), torch.int32),
                 seg_ptr=(seg_ptr, (nseg + 1,), torch.int32))
    if gather is not None:
        base, dst, src, ptr = gather
        _check_group(pool, g0, nf, wp, rp, dst=(dst, (dst.numel(),), torch.int32),
                     src=(src, (src.numel(),), torch.int32),
                     ptr=(ptr, (ptr.numel(),), torch.int32))
        if ptr.numel() < 2 or dst.numel() < 1 or int(base) < 0:
            raise ValueError("gather lists need at least one entry and one rank, and base >= 0")
    if pool.device.type == "cpu":
        return extend_add_plain(pool, g0, nf, wp, rp, lp, poff, pmp, seg_ptr, flush)
    if pool.device.type != "cuda":
        raise ValueError(f"no extend-add for device {pool.device}")
    if nseg < 1 or rp == 0:
        return
    name = f"respa_extend_add_{_instance(pool, flush)}"
    tiles = max(1, min(512, rp // 8))  # 8 warps a block: one row a warp up to rp = 4096
    lists = (0, 0, 0, None, None, None) if gather is None else (
        int(gather[0]), int(gather[1].numel()), int(gather[3].numel()) - 1,
        gather[1].data_ptr(), gather[2].data_ptr(), gather[3].data_ptr())
    rc = getattr(_library(), name)(
        pool.device.index, pool.data_ptr(), g0, nf, wp, rp, lp.data_ptr(),
        poff.data_ptr(), pmp.data_ptr(), seg_ptr.data_ptr(), nseg, tiles,
        _ADD_REGIMES["rows" if gather is None else "gather"], *lists,
        torch.cuda.current_stream(pool.device).cuda_stream)
    _launched(name, rc)


def _unit_diag(u: torch.Tensor) -> torch.Tensor:
    """A copy of the triangles ``u`` [B, w, w] with zero diagonal entries set
    to 1 (an all-zero padded pivot solves as identity)."""
    u = u.clone()
    d = torch.diagonal(u, dim1=-2, dim2=-1)
    d[d == 0] = 1
    return u


def _put(y: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """y[idx] = vals. Padded entries of idx all point at y's spare last slot
    and their values are all 0 (a padded pivot's row and column are zero), so
    the slot keeps its 0 and no mask, which would wait for the device, is
    needed."""
    y[idx.reshape(-1)] = vals.reshape(-1)


def front_sweep_plain(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int,
                      rp: int, piv: torch.Tensor, rsx: torch.Tensor, forward: bool,
                      flush: bool = False) -> Optional[torch.Tensor]:
    """The sweep kernel's function in plain torch ops, on any device.

    ``y`` is the permuted right-hand side with one spare slot at index n,
    which holds 0 and which the padded entries of ``piv`` / ``rsx`` point at.
    Forward: ``z = L11^-1 y[piv]`` (unit lower), ``y[piv] = z``, returns
    ``upd = -L21 z`` [B, rp] for :func:`rows_reduce`. Backward:
    ``z = U11^-1 (y[piv] - U12 y[rsx])`` with a zero diagonal entry read as 1,
    ``y[piv] = z``, returns None."""
    f = _fronts(pool, g0, nf, wp + rp)
    pv = piv.long()
    yp = ftz(y[pv], flush)[..., None]
    if forward:
        z = ftz(torch.linalg.solve_triangular(f[:, :wp, :wp], yp, upper=False,
                                              unitriangular=True), flush)
        _put(y, pv, z[..., 0])
        return ftz(-(f[:, wp:, :wp] @ z)[..., 0], flush)
    if rp:
        yp = ftz(yp - ftz(f[:, :wp, wp:] @ ftz(y[rsx.long()], flush)[..., None], flush), flush)
    z = ftz(torch.linalg.solve_triangular(_unit_diag(f[:, :wp, :wp]), yp, upper=True), flush)
    _put(y, pv, z[..., 0])
    return None


def _sweep(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
           piv: torch.Tensor, rsx: torch.Tensor, forward: bool, flush: bool,
           control: torch.Tensor, transposed: bool) -> Optional[torch.Tensor]:
    """:func:`front_sweep` (K4) or :func:`front_sweep_t` (K12): the checks,
    the plain version on the CPU, one launch on a card."""
    _check_group(pool, g0, nf, wp, rp, piv=(piv, (nf, wp), torch.int32),
                 rsx=(rsx, (nf, rp), torch.int32))
    if y.dim() != 1 or y.dtype != pool.dtype or y.device != pool.device or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous {pool.dtype} vector on {pool.device}")
    words = control_words(nf, wp, rp, pool.element_size())
    if (control.dtype != torch.int32 or control.device != pool.device
            or control.numel() < words or not control.is_contiguous()):
        raise ValueError(f"control must be {words} contiguous int32 words on {pool.device}")
    if pool.device.type == "cpu":
        plain = front_sweep_t_plain if transposed else front_sweep_plain
        return plain(pool, y, g0, nf, wp, rp, piv, rsx, forward, flush)
    if pool.device.type != "cuda":
        raise ValueError(f"no frontal sweep for device {pool.device}")
    _, tiles = sweep_regime(nf, wp, rp)
    if forward:
        out = torch.empty((nf, rp), dtype=pool.dtype, device=pool.device)
    else:  # the partials of a tiled front's panel
        out = torch.empty((nf, tiles, wp) if tiles > 1 else (1,), dtype=pool.dtype,
                          device=pool.device)
    launch_sweep(pool, y, g0, nf, wp, rp, piv, rsx, forward, flush, out, control,
                 transposed=transposed)
    return out if forward else None


def front_sweep(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
                piv: torch.Tensor, rsx: torch.Tensor, forward: bool, flush: bool = False, *,
                control: torch.Tensor) -> Optional[torch.Tensor]:
    """One group's forward or backward substitution from the factored pool,
    in place in ``y`` [n + 1]; see :func:`front_sweep_plain`. ``control`` is
    as for :func:`launch_sweep` (the plain version has no use for it, but it
    is checked on every device alike).

    On a CUDA device this is one launch of the sweep kernel on the current
    stream, in the regime :func:`sweep_regime` picks for the group's shape
    (every width, the triangle read in place); it raises if the inputs do not
    fit the kernel or the launch fails. On the CPU it runs the plain
    version."""
    return _sweep(pool, y, g0, nf, wp, rp, piv, rsx, forward, flush, control, False)


def front_sweep_t(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
                  piv: torch.Tensor, rsx: torch.Tensor, forward: bool, flush: bool = False, *,
                  control: torch.Tensor) -> Optional[torch.Tensor]:
    """One group's substitution for the transposed system, in place in
    ``y``: forward ``U^T`` (returns the updates for :func:`rows_reduce`),
    backward ``L^T``; see :func:`front_sweep_t_plain`. As
    :func:`front_sweep` in all else: on a CUDA device one launch of K12 in
    the group's regime, with the same control words; on the CPU the plain
    version."""
    return _sweep(pool, y, g0, nf, wp, rp, piv, rsx, forward, flush, control, True)


def control_words(nf: int, wp: int, rp: int, itemsize: int) -> int:
    """int32 words of control one sweep launch of a group takes: a ticket a
    front (even, so that the wide regime's mailbox behind them is 8-byte
    aligned) and, in the wide regime, a (word, tag) pair for every 32-bit word
    of z."""
    regime, _ = sweep_regime(nf, wp, rp)
    tickets = nf + (nf & 1)
    return tickets + (nf * wp * itemsize // 2 if regime == "wide" else 0)


def control_zeros(pool: torch.Tensor, nf: int, wp: int, rp: int) -> torch.Tensor:
    """Fresh control words for one sweep launch of a group: int32 zeros of
    :func:`control_words`, on the pool's device, zeroed on the current
    stream."""
    return torch.zeros(control_words(nf, wp, rp, pool.element_size()), dtype=torch.int32,
                       device=pool.device)


def launch_sweep(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int, rp: int,
                 piv: torch.Tensor, rsx: torch.Tensor, forward: bool, flush: bool,
                 zbuf: torch.Tensor, control: torch.Tensor,
                 upd: Optional[torch.Tensor] = None, transposed: bool = False) -> None:
    """One launch of the sweep kernel on the current stream and nothing
    beside it: the part of :func:`front_sweep` that is the kernel, for
    checked inputs on a card. ``zbuf`` is the output :func:`front_sweep`
    allocates: forward ``upd`` [B, rp]; backward the scratch [B, tiles, wp]
    in which the tiles of a block-regime front leave their panel's partials
    (any tensor of the pool's type where the group is not tiled). ``upd``, if
    given, is the forward output instead.

    ``control`` is the launch's tickets and mailbox: int32 zeros of at least
    :func:`control_words`, for this launch alone, zeroed on the current
    stream (a solve hands each launch its run of one zeroed buffer).
    ``transposed`` launches K12, the transposed system's sweep, instead."""
    n = y.numel() - 1
    regime, tiles = sweep_regime(nf, wp, rp)
    out = upd if forward and upd is not None else zbuf
    tickets = nf + (nf & 1)
    name = (f"respa_front_sweep_{'t_' if transposed else ''}{'fwd' if forward else 'bwd'}_"
            f"{_instance(pool, flush)}")
    rc = getattr(_library(), name)(
        pool.device.index, pool.data_ptr(), g0, nf, wp, rp, piv.data_ptr(), rsx.data_ptr(),
        y.data_ptr(), n, out.data_ptr(), _REGIMES[regime], tiles, control.data_ptr(),
        control[tickets:].data_ptr() if regime == "wide" else control.data_ptr(),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _launched(name, rc)


def rows_reduce_plain(y: torch.Tensor, upd: torch.Tensor, red_rows: torch.Tensor,
                      red_ptr: torch.Tensor, red_src: torch.Tensor,
                      flush: bool = False) -> None:
    """The row-reduction kernel's function in plain torch ops, on any device:
    ``y[red_rows[k]] += sum(upd.flat[red_src[red_ptr[k] : red_ptr[k+1]]])``,
    in the kernel's order: a row of the bin ``(most, lanes)`` of
    ``RED_BINS`` its length falls in is summed by ``lanes`` partial sums,
    partial l taking sources l, l + lanes, ... in plan order, and then a
    halving tree over the partials; under ``flush`` every partial sum is
    flushed."""
    nd = red_rows.numel()
    if nd == 0:
        return
    start = red_ptr[:-1]
    lens = red_ptr[1:] - start
    vals = upd.reshape(-1)[red_src.long()]
    sums = torch.zeros(nd, dtype=y.dtype, device=y.device)
    lo = 0
    for most, lanes in RED_BINS:
        sel = torch.nonzero((lens > lo) & (lens <= most if most else True))[:, 0]
        lo = most
        if sel.numel() == 0:
            continue
        s0, ln = start[sel][:, None], lens[sel][:, None]
        lane = torch.arange(lanes, device=y.device)[None, :]
        part = torch.zeros((sel.numel(), lanes), dtype=y.dtype, device=y.device)
        for j in range(-(-int(ln.max()) // lanes)):
            k = j * lanes + lane
            ok = k < ln
            part = torch.where(ok, ftz(part + vals[(s0 + k).clamp(max=vals.numel() - 1)], flush),
                               part)
        off = lanes // 2
        while off:
            part[:, :off] = ftz(part[:, :off] + part[:, off:2 * off], flush)
            off //= 2
        sums[sel] = part[:, 0]
    rows = red_rows.long()
    y[rows] = ftz(y[rows] + sums, flush)


def rows_reduce(y: torch.Tensor, upd: torch.Tensor, red_rows: torch.Tensor,
                red_ptr: torch.Tensor, red_src: torch.Tensor, flush: bool = False) -> None:
    """Add one group's updates ``upd`` [B, rp] into ``y`` in place, gathered
    per destination row; see :func:`rows_reduce_plain`.

    On a CUDA device this is one launch of the reduction kernel on the
    current stream, a warp 32 destination rows (a lane, a group of 8 lanes or
    the warp a row, by its bin), the sources of a row in a fixed order (no
    atomics); it raises if the inputs do not fit the kernel
    or the launch fails. On the CPU it runs the plain version."""
    nd = int(red_rows.numel())
    for name, t, dtype in (("red_rows", red_rows, torch.int32), ("red_ptr", red_ptr, torch.int64),
                           ("red_src", red_src, torch.int32), ("upd", upd, y.dtype)):
        if t.device != y.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {y.device}")
    if red_ptr.numel() != nd + 1 or y.dim() != 1 or not y.is_contiguous():
        raise ValueError("red_ptr must have one entry more than red_rows, y must be a vector")
    if y.device.type == "cpu":
        return rows_reduce_plain(y, upd, red_rows, red_ptr, red_src, flush)
    if y.device.type != "cuda":
        raise ValueError(f"no row reduction for device {y.device}")
    if nd == 0:
        return
    if y.dtype not in (torch.float32, torch.float64) or (flush and y.dtype != torch.float32):
        raise TypeError(f"no row reduction for {y.dtype}{' with flush-to-zero' if flush else ''}")
    name = "respa_rows_reduce_f64" if y.dtype == torch.float64 else "respa_rows_reduce_f32"
    rc = getattr(_library(), name)(
        y.device.index, y.data_ptr(), upd.data_ptr(), red_rows.data_ptr(), red_ptr.data_ptr(),
        red_src.data_ptr(), nd, int(flush), torch.cuda.current_stream(y.device).cuda_stream)
    _launched(name, rc)


def front_sweep_t_plain(pool: torch.Tensor, y: torch.Tensor, g0: int, nf: int, wp: int,
                        rp: int, piv: torch.Tensor, rsx: torch.Tensor,
                        forward: bool, flush: bool = False) -> Optional[torch.Tensor]:
    """K12's function in plain torch ops, on any device: one group's
    substitution for the transposed system (the Hager condition estimate's
    solves). Forward, U^T z = s (U^T is lower, non-unit): ``z = U11^-T y[piv]``,
    ``y[piv] = z``, returns ``upd = -U12^T z`` for :func:`rows_reduce`.
    Backward, L^T w = z (unit upper): ``y[piv] = L11^-T (y[piv] - L21^T
    y[rsx])``. Under ``flush`` y, every product's sum and every result is
    flushed to zero, as :func:`front_sweep_plain` does."""
    f = _fronts(pool, g0, nf, wp + rp)
    pv = piv.long()
    yp = ftz(y[pv], flush)[..., None]
    if forward:
        z = ftz(torch.linalg.solve_triangular(_unit_diag(f[:, :wp, :wp]).mT, yp, upper=False),
                flush)
        _put(y, pv, z[..., 0])
        return ftz(-(f[:, :wp, wp:].mT @ z)[..., 0], flush)
    if rp:
        yp = ftz(yp - ftz(f[:, wp:, :wp].mT @ ftz(y[rsx.long()], flush)[..., None], flush),
                 flush)
    z = ftz(torch.linalg.solve_triangular(f[:, :wp, :wp].mT, yp, upper=True,
                                          unitriangular=True), flush)
    _put(y, pv, z[..., 0])
    return None


# ---------------------------------------------------------------------------
# Numeric factorization
# ---------------------------------------------------------------------------


def factor_group(pool: torch.Tensor, g0: int, nf: int, wp: int, rp: int, eps: float,
                 flush: bool = False) -> torch.Tensor:
    """Blocked right-looking partial LU over the first ``wp`` pivots of every
    front of one group, in place in ``pool`` (the fronts are a view of it).
    Returns the int32 count of perturbed pivots per front.

    Per block of up to 128 pivots: :func:`kernels.bandlu.block_lu` on the
    fronts' diagonal blocks (one batched launch on the strided view), one
    unit-lower triangular solve for the U panel, one right-upper one for the
    L panel, one batched in-place product for the trailing block. Padding
    rows and columns are zero and padded pivots carry a diagonal above eps,
    so padding factors as identity and is never counted."""
    mp = wp + rp
    f = _fronts(pool, g0, nf, mp)
    count = torch.zeros(nf, dtype=torch.int32, device=pool.device)
    for k in range(0, wp, MAX_P):
        e = min(k + MAX_P, wp)
        d = f[:, k:e, k:e]
        lu, bad = block_lu(d, eps, flush)
        d.copy_(lu)
        count += bad
        if e == mp:
            break
        u = f[:, k:e, e:]
        yb = ftz(torch.linalg.solve_triangular(lu, u, upper=False, unitriangular=True), flush)
        u.copy_(yb)
        l = f[:, e:, k:e]
        xb = ftz(torch.linalg.solve_triangular(lu, l, upper=True, left=False), flush)
        l.copy_(xb)
        c = f[:, e:, e:]
        if flush:
            c.copy_(ftz(torch.baddbmm(c, xb, yb, alpha=-1.0), True))
        else:
            c.baddbmm_(xb, yb, alpha=-1.0)
    return count


def default_pivot_eps(amax: float, dtype: torch.dtype) -> float:
    """PARDISO's static-pivoting threshold: 1e-4 (fp32 pool) or 1e-13 (fp64)
    times max(max|A|, 1)."""
    return (1e-13 if dtype == torch.float64 else 1e-4) * max(amax, 1.0)


def assemble_pool(plan: FrontalPlan, dtype: torch.dtype, device: torch.device,
                  pivot_eps: float, flush: bool = False) -> torch.Tensor:
    """The assembled (unfactored) front pool on ``device``: A's entries at
    their fronts' positions, zeros at the fill, and on the padded pivots'
    diagonal a value above the perturbation threshold. Only the non-zero
    entries are uploaded (the plan knows where they are), once: their
    positions and values stay on the device with the plan."""
    device = torch.device(device)
    key = (device, dtype, bool(flush))
    if key not in plan._assembly:
        nz = plan.asm_nz
        vals = np.ascontiguousarray(plan.part.filled.data[nz],
                                    dtype=np.float64 if dtype == torch.float64 else np.float32)
        plan._assembly[key] = (torch.from_numpy(plan.asm_dst[nz]).to(device),
                               ftz(torch.from_numpy(vals), flush).to(device),
                               torch.from_numpy(plan.ones_dst).to(device))
    at, vals, ones = plan._assembly[key]
    pool = torch.zeros(plan.pool_size, dtype=dtype, device=device)
    pool[at] = vals
    # padding pivots factor as scalars; keep them above the threshold so they
    # are never counted as perturbed (their rows and columns are zero)
    pool[ones] = max(1.0, pivot_eps * 1.001)
    return pool


def frontal_factor_pool(plan: FrontalPlan, dtype: torch.dtype = torch.float32,
                        device: Union[str, torch.device] = "cuda",
                        pivot_eps: Optional[float] = None, flush: bool = False,
                        pool: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    """Run the numeric multifrontal factorization; the factored front pool
    stays on the device (the frontal solver consumes it in place).

    ``pool`` may be an assembled pool to factor in place (the tests hand the
    same assembled fronts to both packages); by default it is assembled from
    ``plan.part.filled``. Returns ``(pool, n_pivot_perturbed)``; the count is
    fetched once at the end, so no group waits for the host."""
    device = torch.device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the front "
                           "factorization needs full fp32 products")
    if pivot_eps is None:
        f = plan.part.filled
        pivot_eps = default_pivot_eps(float(np.abs(f.data).max()) if f.nnz else 1.0, dtype)
    if pool is None:
        pool = assemble_pool(plan, dtype, device, pivot_eps, flush)
    counts = []
    for g, dg in zip(plan.groups, plan.on_device(device)):
        counts.append(factor_group(pool, g.g0, g.nfronts, g.wp, g.rp, pivot_eps, flush).sum())
        extend_add(pool, g.g0, g.nfronts, g.wp, g.rp, dg["lp"], dg["poff"], dg["pmp"],
                   dg["seg_ptr"], flush, dg["gather"])
    nbad = int(torch.stack(counts).sum()) if counts else 0
    return pool, nbad


def values_from_pool(plan: FrontalPlan, pool: torch.Tensor) -> np.ndarray:
    """Factored entries in ``plan.part.filled.data`` layout (host fp64, the
    pool's accuracy): diagnostics and tests; one pull of the whole pool."""
    return pool.detach().to("cpu", torch.float64).numpy()[plan.asm_dst]


# ---------------------------------------------------------------------------
# Frontal triangular solves (straight from the factored pool)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SolveGraph:
    """One captured solve: ``graph`` replays every launch of a solve from the
    right-hand side in ``b`` to the solution in ``x``, both buffers of the
    graph's own pool; ``launches`` is what one replay adds to ``LAUNCHES``."""

    graph: "torch.cuda.CUDAGraph"
    b: torch.Tensor
    x: torch.Tensor
    launches: Dict[str, int]


class FrontalSolver:
    """Triangular solves straight from the device-resident factored pool.

    The PARDISO phase-33 path (test_pardiso.c:241-244) of the multifrontal
    factorization: a chunked triangular solve over the factor's CSR would
    pad every slot to the widest factor row, which a circuit's hub-coupled
    rows make hopeless; here wide rows are just rows of a dense front. Per
    (level, bucket) group one sweep launch each way, and forward one
    reduction launch: ``launches_per_solve`` counts them.

    On a card the plan never changes, so the first solve of a direction (K4
    or K12) on a stream captures all of its launches into a CUDA graph and
    every later solve there replays it: one graph launch in place of
    ``launches_per_solve`` enqueued from Python, the same kernels in the same
    order on the same inputs, so the same bits. The solver keeps the graphs
    of the last ``GRAPHS`` (direction, stream) pairs, so two streams never
    share a graph's buffers. A solve inside a caller's own capture, and every
    solve on the CPU, runs the eager loop. The counters ``frontal_capture``,
    ``frontal_replay`` and ``frontal_eager`` of ``timing.count`` say how each
    card solve was issued."""

    GRAPHS = 4

    def __init__(self, plan: FrontalPlan, pool: torch.Tensor, flush: bool = False):
        self.plan = plan
        self.pool = pool
        self.flush = bool(flush)
        self.n = plan.part.n
        self._dev = plan.on_device(pool.device)
        # each sweep launch of a solve takes its own run of one buffer of
        # control words, zeroed once a solve on the solve's stream
        words = [control_words(g.nfronts, g.wp, g.rp, pool.element_size())
                 for g in plan.groups]
        self._ctl_off = np.concatenate([[0], np.cumsum(words)]).tolist()
        self._graphs: Dict[Tuple[bool, int], _SolveGraph] = {}  # oldest first

    @property
    def launches_per_solve(self) -> int:
        """Kernel launches of one ``solve_device`` on a card: a forward and a
        backward sweep a group, and a reduction for each group with update
        rows. A replayed solve launches the same kernels from its graph."""
        return sum(2 + (g.rp > 0) for g in self.plan.groups)

    def _check(self, b: torch.Tensor) -> None:
        if b.shape != (self.n,) or b.device != self.pool.device:
            raise ValueError(f"the right-hand side must be ({self.n},) on {self.pool.device}")

    def _start(self, b: torch.Tensor) -> torch.Tensor:
        self._check(b)
        y = torch.zeros(self.n + 1, dtype=self.pool.dtype, device=self.pool.device)
        y[:self.n] = b.to(self.pool.dtype)
        return y

    def _run(self, y: torch.Tensor, sweep, forward: bool) -> None:
        idx = range(len(self.plan.groups))
        for gi in (idx if forward else reversed(idx)):
            g, dg = self.plan.groups[gi], self._dev[gi]
            upd = sweep(gi, y, g.g0, g.nfronts, g.wp, g.rp, dg["piv"], dg["rsx"], forward)
            if forward and g.rp:
                rows_reduce(y, upd, dg["red_rows"], dg["red_ptr"], dg["red_src"], self.flush)

    def _eager(self, b: torch.Tensor, group_sweep) -> torch.Tensor:
        """Both sweeps of every group with ``group_sweep`` (K4's or K12's
        wrapper), launch by launch. On a card every sweep launch takes fresh
        control words: one buffer for the whole solve, zeroed on the current
        stream, forward and backward each in their own half, every group in
        its own run. Solves on two streams, or a replayed CUDA graph of one,
        share no ticket and no mailbox word."""
        y = self._start(b)
        ctl = torch.zeros(2 * self._ctl_off[-1], dtype=torch.int32, device=self.pool.device)

        def sweep(gi, *args):
            base = 0 if args[-1] else self._ctl_off[-1]
            control = ctl[base + self._ctl_off[gi]:base + self._ctl_off[gi + 1]]
            return group_sweep(self.pool, *args, self.flush, control=control)

        self._run(y, sweep, True)
        self._run(y, sweep, False)
        return y[:self.n]

    def _capture(self, group_sweep) -> _SolveGraph:
        """The eager solve captured on a side stream, from a right-hand side
        buffer of the graph's pool: nothing runs, and ``LAUNCHES`` is left as
        it was (each replay adds the launches)."""
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(torch.cuda.Stream(self.pool.device)):
                graph.capture_begin()
                try:
                    b = torch.empty(self.n, dtype=self.pool.dtype, device=self.pool.device)
                    x = self._eager(b, group_sweep)
                finally:
                    graph.capture_end()
        finally:
            launches = {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
            LAUNCHES.update(before)
        return _SolveGraph(graph, b, x, launches)

    def _solve(self, b: torch.Tensor, group_sweep) -> torch.Tensor:
        """The eager loop on the CPU and inside a caller's capture; else this
        stream's graph of the direction, captured at its first solve, with b
        copied into its input. The solution is a copy the caller owns."""
        if self.pool.device.type != "cuda":
            return self._eager(b, group_sweep)
        self._check(b)
        with torch.cuda.device(self.pool.device):
            if torch.cuda.is_current_stream_capturing():
                count("frontal_eager")
                return self._eager(b, group_sweep)
            key = (group_sweep is front_sweep_t, torch.cuda.current_stream().cuda_stream)
            solve = self._graphs.get(key)
            if solve is None:
                if len(self._graphs) >= self.GRAPHS:  # the oldest may still run
                    torch.cuda.synchronize()
                    del self._graphs[next(iter(self._graphs))]
                solve = self._graphs[key] = self._capture(group_sweep)
                count("frontal_capture")
            else:
                count("frontal_replay")
            solve.b.copy_(b)
            solve.graph.replay()
            for name, k in solve.launches.items():
                LAUNCHES[name] += k
            return solve.x.clone()

    def solve_device(self, bp: torch.Tensor) -> torch.Tensor:
        """Solve L U x = bp in permuted coordinates; x in the pool's type
        (K4 and K5 on a card)."""
        return self._solve(bp, front_sweep)

    def solve_t_device(self, sp: torch.Tensor) -> torch.Tensor:
        """Solve (L U)^T w = sp in permuted coordinates: U^T then L^T, under
        the factorization's flush-to-zero (K12 and K5 on a card)."""
        return self._solve(sp, front_sweep_t)
