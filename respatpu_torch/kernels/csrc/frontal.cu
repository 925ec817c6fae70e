// Multifrontal LU on the card: extend-add, the frontal substitution sweeps and
// the ordered row reduction (sm_90a).
//
// The factored fronts live in one flat pool, laid out group by group: a
// (tree level, padded shape) group of B fronts is the contiguous block
// pool[g0 : g0 + B*mp*mp] read as [B, mp, mp], mp = wp + rp (wp padded pivot
// columns, rp padded update rows). These kernels take the three data-dependent
// steps of respatpu/kernels/snlu_device.py that its XLA program wrote as
// gathers and scatter-adds over the whole pool:
//
// extend_add (replaces `pool.at[schur_dst].add(...)`, snlu_device.py:373-374).
//   Adds each front's rp x rp Schur corner into its parent's front. respatpu
//   uploads a source and a destination index for every corner entry; here a
//   front carries only lp[rp], the position of each of its update rows in the
//   parent front, and the kernel forms dst = lp[i]*pmp + lp[j]. Siblings
//   collide in the parent, and a sum with atomics would change from run to
//   run. What fixes the bits is the order in which the children's values
//   reach each parent entry: plan order, ((p + c1) + c2) + ... for every
//   entry, whatever else runs at once. An entry's chain is the number of
//   children that touch it, not the number of children of its parent. Two
//   regimes, picked from the group's shape at plan time
//   (snlu_device.add_regime), one launch a group either way:
//   * gather (many small children under a parent, e.g. a circuit's hub with
//     167 children of 16 rows): the plan lists, for every parent entry the
//     group touches, its sources in child order (offsets into the group,
//     int32), the entries ordered by their number of sources so that rank
//     k's sources are one contiguous run over the first entries. A thread
//     takes an entry, adds its sources in rank order (asking for the next
//     one's position before it reads the current one), then stores once;
//     most entries have one source, and a thread keeps few registers. The
//     lists cost bytes beside the function's; the plan caps them
//     (snlu_device.GATHER_CAP).
//   * rows (the other groups, e.g. the few large children of the top levels,
//     and every group of the distributed path): the group's fronts are
//     sorted by parent, a thread block takes one parent (blockIdx.x) and a
//     share of its rows (blockIdx.y). A parent with one child in the group
//     splits it into (row, piece) units over all its warps; with several,
//     every warp owns the destination rows with lp[i] % (warps in the grid
//     row) == its number and walks the children in plan order with a warp
//     barrier between two. A row is added piece by piece: kAddPiece runs of
//     32 positions asked for at once (one for corners of at most 32 rows),
//     then all their source and destination values, then the stores.
//   No atomics, a fixed order, a factor that repeats bit for bit. Bound by
//   bytes (each corner read once, each parent entry read and written once,
//   lp).
//
// front_sweep fwd / bwd (replace `_fwd_group` :467-487 and `_bwd_group`
//   :490-509). Forward: z = L11^-1 y[piv] (unit lower, wp x wp), y[piv] = z,
//   upd = -L21 z into a scratch [B, rp]. Backward: rhs = y[piv] - U12 y[rsx],
//   z = U11^-1 rhs, y[piv] = z; a zero diagonal entry is read as 1 at every
//   width. Only the blocks in use are read (L11/L21 or U11/U12), in place with
//   row stride mp, never the Schur corner. A front owns its pivot rows, so
//   y[piv] needs no care; the update rows of different fronts collide, which
//   is what rows_reduce is for. What bounds the function is bytes (the
//   triangle and the panel once, y's entries, the indices); what stands in
//   the way is the dependent chain of wp unknowns. Three regimes, picked from
//   the group's shape at plan time (snlu_device.sweep_regime), one launch a
//   group each:
//   * warp (wp <= 32, one tile): dc1 has 10,681 fronts of wp = 8 in one group,
//     which a block a front left 120 of 128 threads idle behind a block
//     barrier a column. A warp takes a front, four fronts a block: lane i
//     holds row i of the triangle in registers and z[c] comes by a shuffle,
//     no barrier; the same warp forms the panel with its lanes on
//     consecutive columns.
//   * block (wp <= 128): one block solves the triangle in shared memory, a
//     thread a row and a barrier a column. A front with many update rows
//     (2cubes_sphere's rp = 6,144 panels, which one block streamed on one of
//     132 SMs) is cut into `tiles` blocks over its panel rows. Forward, every
//     tile solves the triangle again (it comes from L2) and writes its share
//     of upd; the tile that draws the last ticket, which every tile draws
//     after it has read y[piv], writes y[piv]. Backward, every tile writes its
//     partial of U12 y[rsx] into a scratch [B, tiles, wp]; the tile that draws
//     the last ticket sums the partials in tile order, solves the triangle and
//     writes y[piv]. The last tile puts the ticket back to 0.
//   * wide (wp > 128): the triangle was cuBLAS's trsv after a copy of the
//     strided triangle (4.5 ms for dc1's 20,480-wide front, its bound
//     0.26 ms). Now the kernel reads it in place, by blocked substitution over
//     64-row tasks: a thread block draws a task from a ticket (forward the
//     row blocks top down and then 64-row blocks of the panel; backward the
//     row blocks bottom up), so every task it waits on is held by a block
//     that is already running and the launch needs no cooperation. What
//     bounds it is the chain of row blocks, one after the other. So a task
//     does all it can before the chain reaches it: it inverts its diagonal
//     block (a thread a column; backward a zero diagonal entry read as 1),
//     loads the two blocks beside it into shared memory, and streams its
//     rows against every earlier z block as it arrives (backward first U12
//     y[rsx]), one warp taking each z block from a mailbox. When the z block
//     just before its own arrives, the block takes two 64 x 64 products in
//     shared memory (that block, then the inverse) and publishes its z block:
//     a link of the chain is one mailbox trip and those two products. A
//     forward panel task streams all z blocks and writes its rows of upd.
//     The mailbox is the band sweep's (band_lu.cu): each 32-bit word of z
//     with the tag kTag in one 8-byte store, so a reader needs no fence; the
//     wrapper hands every launch a mailbox and tickets freshly zeroed on the
//     launch's stream, so no word of another launch or another stream is
//     ever seen (a replayed CUDA graph replays its zeroing too). The fp32
//     instance sums in fp64
//     (the long sums of a circuit's ill-conditioned wide fronts, summed in
//     fp32 in another order than the library's, came out up to 10x further
//     from the exact result than the library's) and rounds each z to fp32 as
//     it is published.
//   Every sum has a fixed order (per-lane partials, fixed shuffle trees,
//   partials of tiles in tile order): a sweep repeats bit for bit.
//
// front_sweep_t fwd / bwd (K12; replace `_fwd_group_t` :513-534 and
//   `_bwd_group_t` :537-556, the transposed solves of the Hager condition
//   estimate). Forward U^T z = y[piv] (lower, a zero diagonal read as one),
//   y[piv] = z, upd = -U12^T z; backward y[piv] = L11^-T (y[piv] - L21^T
//   y[rsx]) (unit upper). They are K4's kernels in each regime with the
//   front read transposed (TRANS: entry (i, j) of a block is read at (j, i))
//   and the unit diagonal moved from the forward to the backward sweep: the
//   same blocks' bytes bound them, the same chain stands in the way, and K4's
//   control words, tickets and mailbox serve them unchanged. The transposed
//   reads run along a front's columns, so a warp's lanes that took one row's
//   consecutive entries now take one column's; the wide regime swaps its
//   staging loops' index order so that its block loads stay in rows.
//
// rows_reduce (the forward sweep's `y.at[rsx].add(upd)`, :486, as a gather).
//   The plan holds, per group, the destination rows and for each the list of
//   (front, local row) sources in plan order as a CSR over the flat upd, its
//   rows cut into bins by source count: at most kThreadRow, at most
//   kGroupRow, more; and dealt to the warps longest bin first, so that a
//   warp holds at most a share of the long rows. A warp takes 32 rows of
//   the CSR. A row of the first bin is summed by its own lane in plan order;
//   a row of the second by a group of kGroupLanes lanes, four rows at a time;
//   a row of the third by the whole warp; lane groups and warps take the
//   sources kGroupLanes or 32 apart, each lane in order, then a fixed shuffle
//   tree. No atomics; the plain version sums in the same order, so the two
//   agree bit for bit. Bound by bytes; dc1's rows have about 2 sources, so a
//   warp a row left 30 lanes idle.
//
// FTZ instances: nvcc compiles with -ftz=false, so the flush is explicit, on
// what is read from y and on every product and sum.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTri = 128;       // widest pivot block the block regime solves
constexpr int kWarpTri = 32;       // widest pivot block the warp regime solves
constexpr int kSweepThreads = 128; // block regime
constexpr int kWarpFronts = 4;     // warp regime: fronts (warps) a thread block
constexpr int kWideRows = 64;      // wide regime: rows a task
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideRowsPerWarp = kWideRows / kWideWarps;
constexpr int kWidePad = kWideRows + 1;  // shared rows, padded against bank conflicts
constexpr int kAddThreads = 256;
constexpr int kAddPiece = 8;       // extend-add rows past 32: 32-entry runs a warp has in flight
constexpr int kReduceThreads = 256;
constexpr int kThreadRow = 8;      // rows_reduce: most sources a lane sums alone
constexpr int kGroupRow = 64;      // most sources a lane group sums
constexpr int kGroupLanes = 8;
enum Regime { kWarp = 0, kBlock = 1, kWide = 2 };

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }
__device__ __forceinline__ double flush(double v) { return v; }

template <bool FTZ, typename A>
__device__ __forceinline__ A fz(A v) {
    if constexpr (FTZ) return flush(v);
    return v;
}

// a*b + c: fused where nothing is flushed; under FTZ the product and the sum
// are rounded and flushed one after the other.
template <bool FTZ>
__device__ __forceinline__ float muladd(float a, float b, float c) {
    if constexpr (FTZ) return flush(__fadd_rn(flush(__fmul_rn(a, b)), c));
    return fmaf(a, b, c);
}
template <bool FTZ>
__device__ __forceinline__ double muladd(double a, double b, double c) { return fma(a, b, c); }

// Offset of entry (row, col) of a front of size mp, or of (col, row) where the
// front is read transposed (K12).
template <bool TRANS>
__device__ __forceinline__ int64_t at(int64_t row, int64_t col, int64_t mp) {
    return TRANS ? col * mp + row : row * mp + col;
}

// A front's diagonal entry at row t, a zero read as one (t < wp).
template <typename A>
__device__ __forceinline__ A diag_or_one(const A* F, int t, int64_t mp) {
    const A d = F[t * mp + t];
    return d == A(0) ? A(1) : d;
}

// Lanes that share one row of a panel product: 8, 16 or 32 by its length.
__device__ __forceinline__ int lanes_for(int len) { return len > 16 ? 32 : (len > 8 ? 16 : 8); }

// Sum over the `g` lanes of a row's lane group (g a power of two <= 32), in a
// fixed tree; the group's first lane gets the total. The whole warp calls it.
template <typename A>
__device__ __forceinline__ A group_sum(A s, int g) {
    for (int off = g >> 1; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off, g);
    return s;
}

// ---------------------------------------------------------------------------
// extend-add
// ---------------------------------------------------------------------------

// A piece of one child row added into its parent row: R 32-entry runs of
// the row (those that reach rp), all positions first, then all source and
// destination values, then the stores, so that a warp has the whole piece in
// flight. R = 1 for corners of at most 32 rows, which keeps a thread's
// registers, and so the warps the card holds, at what one run needs.
template <typename A, bool FTZ, int R>
__device__ __forceinline__ void add_piece(const A* __restrict__ srow, A* __restrict__ drow,
                                          const int32_t* __restrict__ l, int j0, int rp,
                                          int lane) {
    int dj[R];
    A s[R], d[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int j = j0 + 32 * u + lane;
        dj[u] = j < rp ? l[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
        if (dj[u] >= 0) {
            s[u] = srow[j0 + 32 * u + lane];
            d[u] = drow[dj[u]];
        }
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
        if (dj[u] >= 0) drow[dj[u]] = fz<FTZ>(d[u] + s[u]);
}

// The row regime: a thread block takes a parent (blockIdx.x) with `tiles`
// others (blockIdx.y). A parent with one child in the group shares it with no
// other launch's work, so every warp of the grid row takes (row, piece) units
// of it. A parent with several children: a warp owns the parent rows with
// lp[i] % (warps in the grid row) == its number, walks the children in plan
// order with a warp barrier between two, and adds each of its rows piece by
// piece; a warp reads 32 positions at once and finds its rows by a ballot.
template <typename A, bool FTZ, int R>
__global__ void __launch_bounds__(kAddThreads)
extend_add_rows(A* __restrict__ pool, int64_t g0, int wp, int rp,
                const int32_t* __restrict__ lp, const int64_t* __restrict__ poff,
                const int32_t* __restrict__ pmp, const int32_t* __restrict__ seg_ptr) {
    const int b0 = seg_ptr[blockIdx.x], b1 = seg_ptr[blockIdx.x + 1];
    const int warps = blockDim.x >> 5;
    const int lane = threadIdx.x & 31;
    const int owners = gridDim.y * warps;
    const int me = blockIdx.y * warps + (threadIdx.x >> 5);
    const int64_t mp = wp + rp;
    A* parent = pool + poff[b0];
    const int64_t pm = pmp[b0];
    constexpr int kSpan = 32 * R;
    const int pieces = (rp + kSpan - 1) / kSpan;
    if (b1 - b0 == 1) {
        const A* child = pool + g0 + b0 * mp * mp;
        const int32_t* l = lp + static_cast<int64_t>(b0) * rp;
        for (int u = me; u < rp * pieces; u += owners) {
            const int i = u / pieces, c = u % pieces;
            const int di = l[i];
            if (di < 0) break;  // the rows in use come first, and u only grows
            add_piece<A, FTZ, R>(child + (wp + i) * mp + wp, parent + di * pm, l, c * kSpan,
                                 rp, lane);
        }
        return;
    }
    // the first 32 positions of the next child are fetched while this one is
    // added, so a parent's many small children cost one memory trip each
    int ahead = lane < rp ? lp[static_cast<int64_t>(b0) * rp + lane] : -1;
    for (int b = b0; b < b1; ++b) {
        const A* child = pool + g0 + b * mp * mp;
        const int32_t* l = lp + static_cast<int64_t>(b) * rp;
        int di = ahead;
        if (b + 1 < b1) ahead = lane < rp ? l[rp + lane] : -1;
        for (int i0 = 0; i0 < rp; i0 += 32) {
            if (i0) di = i0 + lane < rp ? l[i0 + lane] : -1;
            // the rows of this 32 that this warp owns; the rows in use come first
            unsigned mine = __ballot_sync(kFull, di >= 0 && di % owners == me);
            const bool more = __all_sync(kFull, di >= 0);
            while (mine) {
                const int k = __ffs(mine) - 1;
                mine &= mine - 1;
                const int drow_at = __shfl_sync(kFull, di, k);
                for (int c = 0; c < pieces; ++c)
                    add_piece<A, FTZ, R>(child + (wp + i0 + k) * mp + wp, parent + drow_at * pm,
                                         l, c * kSpan, rp, lane);
            }
            if (!more) break;
        }
        __syncwarp();  // the next child may reach the same entries from other lanes
    }
}

// The gather regime: a thread an entry of the parents that the group
// touches, dst[d] its offset from `base`; its sources, offsets from g0 of
// corner entries in the children's plan order, are src[ptr[k] + d] for the
// ranks k with d < ptr[k + 1] - ptr[k] (the entries ordered by their number
// of sources, most first). A thread adds them to the parent's entry in rank
// order, the plain version's ((p + c1) + c2) + ..., and stores once; it asks
// for the next source's position before it reads the current source, so a
// source costs one memory trip. Most entries have one source: a thread keeps
// few registers, so that the card holds as many of them as it can.
template <typename A, bool FTZ>
__global__ void __launch_bounds__(kAddThreads)
extend_add_gather(A* __restrict__ pool, int64_t g0, int64_t base, int nd, int kmax,
                  const int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                  const int32_t* __restrict__ ptr) {
    const int d = blockIdx.x * kAddThreads + threadIdx.x;
    if (d >= nd) return;
    A* to = pool + base + dst[d];
    const A* from = pool + g0;
    int at = src[d];  // rank 0's run starts at 0 and holds every entry
    A v = *to;
    int k = 1, lo = __ldg(ptr + 1);
    while (true) {
        // rank k's run, if it reaches this entry: its position, asked for now
        const int hi = k < kmax ? __ldg(ptr + k + 1) : lo;
        const int next = d < hi - lo ? src[lo + d] : -1;
        v = fz<FTZ>(v + from[at]);
        if (next < 0) break;
        at = next;
        lo = hi;
        ++k;
    }
    *to = v;
}

// ---------------------------------------------------------------------------
// frontal sweeps: the warp regime
// ---------------------------------------------------------------------------

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_fwd_warp(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
               const int32_t* __restrict__ piv, A* __restrict__ y, int n, A* __restrict__ upd) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarpFronts + (threadIdx.x >> 5);
    if (b >= nf) return;  // whole warps leave together
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int row = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    A l[kWarpTri];  // lane i: row i of L11 (U11^T) left of the diagonal
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c)
        l[c] = c < lane && lane < wp ? F[at<TRANS>(lane, c, mp)] : A(0);
    const A dl = TRANS && lane < wp ? diag_or_one(F, lane, mp) : A(1);
    // upd = -L21 z: g lanes a row on consecutive columns (g >= wp), 32 / g rows a
    // pass; the first kPre passes' values are asked for before the triangle
    constexpr int kPre = 4;
    const int g = lanes_for(wp), ln = lane % g, sub = lane / g, per = 32 / g;
    A pre[kPre];
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int i = q * per + sub;
        pre[q] = i < rp && ln < wp ? F[at<TRANS>(wp + i, ln, mp)] : A(0);
    }
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c) {
        if (c < wp) {
            if (TRANS && lane == c) v = fz<FTZ>(v / dl);  // U^T's diagonal
            if (c + 1 < wp) {  // z[c] is final here
                const A zc = __shfl_sync(kFull, v, c);
                if (lane > c) v = muladd<FTZ>(-l[c], zc, v);
            }
        }
    }
    if (row < n) y[row] = v;
    if (rp == 0) return;
    const A zc = __shfl_sync(kFull, v, ln);
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int i = q * per + sub;
        A s = A(0);
        if (i < rp && ln < wp) s = muladd<FTZ>(pre[q], zc, s);
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
#pragma unroll 4
    for (int i0 = kPre * per; i0 < rp; i0 += per) {
        const int i = i0 + sub;
        A s = A(0);
        if (i < rp && ln < wp) s = muladd<FTZ>(F[at<TRANS>(wp + i, ln, mp)], zc, s);
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_bwd_warp(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
               const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
               A* __restrict__ y, int n) {
    __shared__ A rhs[kWarpFronts][kWarpTri];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarpFronts + w;
    if (b >= nf) return;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    A u[kWarpTri];  // lane i: row i of U11 (L11^T) from the diagonal on, asked for first
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c)
        u[c] = c >= lane && c < wp ? F[at<TRANS>(lane, c, mp)] : A(0);
    // U12 y[rsx]: g lanes a pivot row on consecutive update rows
    const int g = lanes_for(rp), ln = lane % g, sub = lane / g, per = 32 / g;
    for (int i0 = 0; i0 < wp; i0 += per) {
        const int i = i0 + sub;
        A s = A(0);
        if (i < wp) {
            for (int r = ln; r < rp; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(F[at<TRANS>(i, wp + r, mp)], fz<FTZ>(y[row]), s);
            }
        }
        s = group_sum(s, g);
        if (i < wp && ln == 0) rhs[w][i] = s;
    }
    __syncwarp();
    const int row = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    A v = lane < wp ? fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - rhs[w][lane]) : A(0);
#pragma unroll
    for (int c = kWarpTri - 1; c >= 0; --c) {
        if (c < wp) {
            if (!TRANS && lane == c) {  // L11^T has a unit diagonal
                A d = u[c];
                if (d == A(0)) d = A(1);
                v = fz<FTZ>(v / d);
            }
            const A zc = __shfl_sync(kFull, v, c);
            if (lane < c) v = muladd<FTZ>(-u[c], zc, v);
        }
    }
    if (row < n) y[row] = v;
}

// ---------------------------------------------------------------------------
// frontal sweeps: the block regime, a front's panel over gridDim.y tiles
// ---------------------------------------------------------------------------

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kSweepThreads)
front_fwd_block(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                const int32_t* __restrict__ piv, A* __restrict__ y, int n, A* __restrict__ upd,
                int* __restrict__ ticket) {
    __shared__ A z[kMaxTri];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int row = t < wp ? piv[static_cast<int64_t>(b) * wp + t] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    const A dt = TRANS && t < wp ? diag_or_one(F, t, mp) : A(1);  // U^T's diagonal
    if (TRANS && t == 0) v = fz<FTZ>(v / dt);
    if (t < wp) z[t] = v;
    __syncthreads();
    if (tiles > 1) {
        // a tile draws its ticket once it has read y[piv]: the last to draw writes y[piv]
        if (t == 0) {
            last = atomicAdd(ticket + b, 1) == tiles - 1;
        }
        __syncthreads();
    }
    for (int c = 0; c + 1 < wp; ++c) {  // z[c] is final here
        if (t > c && t < wp) v = muladd<FTZ>(-F[at<TRANS>(t, c, mp)], z[c], v);
        if (t == c + 1) {
            if (TRANS) v = fz<FTZ>(v / dt);
            z[t] = v;
        }
        __syncthreads();
    }
    if (row < n && (tiles == 1 || last)) y[row] = v;
    if (rp == 0) return;
    // this tile's rows of upd = -L21 z, g lanes a row
    const int chunk = (rp + tiles - 1) / tiles;
    const int i_end = min(rp, static_cast<int>(blockIdx.y + 1) * chunk);
    const int g = lanes_for(wp);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    for (int base = static_cast<int>(blockIdx.y) * chunk; base < i_end; base += per_pass) {
        const int i = base + sub;
        A s = A(0);
        if (i < i_end) {
            for (int w = ln; w < wp; w += g) s = muladd<FTZ>(F[at<TRANS>(wp + i, w, mp)], z[w], s);
        }
        s = group_sum(s, g);
        if (i < i_end && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kSweepThreads)
front_bwd_block(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                A* __restrict__ y, int n, A* __restrict__ part, int* __restrict__ ticket) {
    __shared__ A z[kMaxTri];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y, tile = blockIdx.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* pv = piv + static_cast<int64_t>(b) * wp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    // this tile's update rows r0 .. r1 - 1 of U12 y[rsx], a lane group a pivot row
    const int chunk = (rp + tiles - 1) / tiles;
    const int r0 = tile * chunk, r1 = min(rp, r0 + chunk);
    const int g = lanes_for(chunk);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    for (int base = 0; base < wp; base += per_pass) {
        const int i = base + sub;
        A s = A(0);
        if (i < wp) {
            for (int r = r0 + ln; r < r1; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(F[at<TRANS>(i, wp + r, mp)], fz<FTZ>(y[row]), s);
            }
        }
        s = group_sum(s, g);
        if (i < wp && ln == 0) {
            if (tiles > 1) {
                part[(static_cast<int64_t>(b) * tiles + tile) * wp + i] = s;
            } else {
                const int row = pv[i];
                z[i] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
            }
        }
    }
    if (tiles > 1) {
        // the tile that draws the last ticket sums the partials in tile order
        __threadfence();
        __syncthreads();
        if (t == 0) {
            last = atomicAdd(ticket + b, 1) == tiles - 1;
        }
        __syncthreads();
        if (!last) return;
        __threadfence();
        if (t < wp) {
            A s = A(0);
            for (int k = 0; k < tiles; ++k)
                s = fz<FTZ>(s + __ldcg(part + (static_cast<int64_t>(b) * tiles + k) * wp + t));
            const int row = pv[t];
            z[t] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
        }
    }
    __syncthreads();
    A v = t < wp ? z[t] : A(0);
    for (int c = wp - 1; c >= 0; --c) {
        if (t == c) {
            if (!TRANS) v = fz<FTZ>(v / diag_or_one(F, t, mp));  // L11^T: unit
            z[c] = v;
        }
        __syncthreads();
        if (t < c) v = muladd<FTZ>(-F[at<TRANS>(t, c, mp)], z[c], v);
    }
    if (t < wp) {
        const int row = pv[t];
        if (row < n) y[row] = v;
    }
}

// ---------------------------------------------------------------------------
// frontal sweeps: the wide regime, blocked substitution by ticketed tasks
// ---------------------------------------------------------------------------

// The mailbox: every 32-bit word of a solved value travels with the tag kTag
// (a zeroed word carries 0) in one 8-byte store, which the card performs as a whole, so a reader
// that sees the tag has the word. A double is two such pairs. A reader that
// is not next in the chain sleeps between polls; one that spins for seconds
// traps instead of hanging.
constexpr unsigned kSpinLimit = 1u << 26;
constexpr unsigned kTag = 1;

__device__ __forceinline__ void mail_put(unsigned* slot, unsigned word, unsigned tag) {
    asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(slot), "r"(word), "r"(tag)
                 : "memory");
}

// The words of the N slots with `live` set, once every one carries `tag`; the
// slots are read together, so a lane waits one trip for all of them.
template <int N>
__device__ __forceinline__ void mail_get_all(const unsigned* const (&slot)[N],
                                             const bool (&live)[N], unsigned tag,
                                             bool patient, unsigned (&word)[N]) {
    unsigned spins = 0;
    while (true) {
        bool all = true;
#pragma unroll
        for (int q = 0; q < N; ++q) {
            unsigned seen = tag;
            if (live[q])
                asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
                             : "=r"(word[q]), "=r"(seen)
                             : "l"(slot[q])
                             : "memory");
            all = all && seen == tag;
        }
        if (all) return;
        if (++spins > kSpinLimit) __trap();
        if (patient) __nanosleep(256);
    }
}

__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, float v, unsigned tag) {
    mail_put(mail + 2 * e, __float_as_uint(v), tag);
}
__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, double v, unsigned tag) {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v));
    mail_put(mail + 4 * e, static_cast<unsigned>(bits), tag);
    mail_put(mail + 4 * e + 2, static_cast<unsigned>(bits >> 32), tag);
}

// z[c] and z[c + 32] for one lane (0 past wp), waited for together.
__device__ __forceinline__ void mail_recv_pair(const unsigned* mail, int c, int wp, unsigned tag,
                                               bool patient, float* z) {
    const unsigned* const slot[2] = {mail + 2 * c, mail + 2 * (c + 32)};
    const bool live[2] = {c < wp, c + 32 < wp};
    unsigned w[2] = {0u, 0u};
    mail_get_all(slot, live, tag, patient, w);
    z[0] = live[0] ? __uint_as_float(w[0]) : 0.0f;
    z[1] = live[1] ? __uint_as_float(w[1]) : 0.0f;
}
__device__ __forceinline__ void mail_recv_pair(const unsigned* mail, int c, int wp, unsigned tag,
                                               bool patient, double* z) {
    const unsigned* const slot[4] = {mail + 4 * c, mail + 4 * c + 2, mail + 4 * (c + 32),
                                     mail + 4 * (c + 32) + 2};
    const bool live[4] = {c < wp, c < wp, c + 32 < wp, c + 32 < wp};
    unsigned w[4] = {0u, 0u, 0u, 0u};
    mail_get_all(slot, live, tag, patient, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const unsigned long long lo = w[2 * h], hi = w[2 * h + 1];
        z[h] = live[2 * h] ? __longlong_as_double(static_cast<long long>(lo | (hi << 32))) : 0.0;
    }
}

// The wide regime's sums: fp64 for the fp32 instance (a circuit's wide fronts
// amplify rounding, and a long chain summed in fp32 in another order than
// the library's stood up to 10x further from the exact result than the
// library's did); z is still rounded to the pool's type as it is solved. The
// FTZ instance flushes every fp32 partial sum; fp64 sums in fp64.
template <typename A, bool FTZ>
using WideAcc = std::conditional_t<FTZ || sizeof(A) == 8, A, double>;

// sum over k in [k0, k1) of m[k] * x[k], in four partials (k - k0 taken mod 4,
// then (p0 + p1) + (p2 + p3)), each product and sum flushed under FTZ: the
// order is fixed by k0 and k1, and a 64-term product is no 64-step chain.
template <bool FTZ, typename Acc, typename M, typename Z>
__device__ __forceinline__ Acc dot4(const M* m, const Z* x, int xs, int k0, int k1) {
    Acc p0 = Acc(0), p1 = Acc(0), p2 = Acc(0), p3 = Acc(0);
    int k = k0;
    for (; k + 3 < k1; k += 4) {
        p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k * xs]), p0);
        p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[(k + 1) * xs]), p1);
        p2 = muladd<FTZ>(Acc(m[k + 2]), Acc(x[(k + 2) * xs]), p2);
        p3 = muladd<FTZ>(Acc(m[k + 3]), Acc(x[(k + 3) * xs]), p3);
    }
    if (k < k1) p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k * xs]), p0);
    if (k + 1 < k1) p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[(k + 1) * xs]), p1);
    if (k + 2 < k1) p2 = muladd<FTZ>(Acc(m[k + 2]), Acc(x[(k + 2) * xs]), p2);
    return fz<FTZ>(fz<FTZ>(p0 + p1) + fz<FTZ>(p2 + p3));
}

// m[16q .. 16q + 16) . x[16q .. 16q + 16) in two partials, then summed over the four
// threads q of a row (adjacent lanes) by a butterfly that gives all four the same bits.
template <bool FTZ, typename Acc, typename M, typename Z>
__device__ __forceinline__ Acc quarter_dot(const M* m, const Z* x, int q) {
    Acc p0 = Acc(0), p1 = Acc(0);
#pragma unroll
    for (int k = 16 * q; k < 16 * q + 16; k += 2) {
        p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k]), p0);
        p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[k + 1]), p1);
    }
    Acc s = fz<FTZ>(p0 + p1);
    s = fz<FTZ>(s + __shfl_xor_sync(kFull, s, 1));
    return fz<FTZ>(s + __shfl_xor_sync(kFull, s, 2));
}

// One task of a wide front: rows r0 .. r0 + nrows - 1 of front b. A triangle
// task (row block `blk`) solves its 64 unknowns; a forward panel task forms
// its 64 rows of upd. ctl[0] is the ticket.
// Before any wait a triangle task inverts its diagonal block (a thread a
// column, in Acc) and loads the two blocks beside it, so that once the z block
// solved just before its own arrives, the block takes it through two 64 x 64
// products in shared memory, four threads a row, and publishes.
template <typename A, bool FTZ, bool FWD, bool TRANS>
__global__ void __launch_bounds__(kWideThreads)
front_wide_kernel(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                  const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                  A* __restrict__ y, int n, A* __restrict__ upd, int* __restrict__ ctl,
                  unsigned* __restrict__ mail, unsigned tag) {
    using Acc = WideAcc<A, FTZ>;
    constexpr bool kUnit = FWD != TRANS;  // L11 forward, L11^T backward
    extern __shared__ __align__(16) unsigned char wide_smem[];
    Acc* X = reinterpret_cast<Acc*>(wide_smem);  // the diagonal block's inverse
    A* S1 = reinterpret_cast<A*>(X + kWideRows * kWidePad);  // the block solved just before
    A* S2 = S1 + kWideRows * kWidePad;  // the diagonal block, then the block before S1
    __shared__ A zs[2][kWideRows];      // the z block being streamed
    __shared__ A zn[kWideRows];         // a z block beside the diagonal
    __shared__ Acc acc[kWideRows];
    __shared__ Acc rhs[kWideRows];
    __shared__ Acc rcp[kWideRows];      // non-unit: 1 / the diagonal (0 read as 1)
    __shared__ A yp[kWideRows];
    __shared__ int task;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nrb = (wp + kWideRows - 1) / kWideRows;
    if (t == 0) task = atomicAdd(ctl, 1);
    __syncthreads();
    const int b = task % nf, step = task / nf;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    unsigned* mb = mail + static_cast<int64_t>(b) * wp * (sizeof(A) / 2);
    const bool panel = FWD && step >= nrb;
    const int blk = FWD ? step : nrb - 1 - step;  // a triangle task's row block
    const int r0 = panel ? wp + (step - nrb) * kWideRows : blk * kWideRows;
    const int nrows = min(kWideRows, (panel ? wp + rp : wp) - r0);
    const int n1 = FWD ? blk - 1 : blk + 1;  // the z block solved just before this one
    const int n2 = FWD ? blk - 2 : blk + 2;  // and the one before that
    const bool has1 = !panel && n1 >= 0 && n1 < nrb;
    const bool has2 = !panel && n2 >= 0 && n2 < nrb;

    if (!panel) {
        if (t < kWideRows) {
            const int row = t < nrows ? piv[static_cast<int64_t>(b) * wp + r0 + t] : n;
            yp[t] = row < n ? fz<FTZ>(y[row]) : A(0);
            if (!kUnit) {
                const A d = t < nrows ? F[static_cast<int64_t>(r0 + t) * mp + r0 + t] : A(0);
                rcp[t] = Acc(1) / (d == A(0) ? Acc(1) : Acc(d));
            }
        }
        for (int e = t; e < kWideRows * kWideRows; e += kWideThreads) {
            // consecutive threads read along the front's rows either way
            const int i = TRANS ? e % kWideRows : e / kWideRows;
            const int c = TRANS ? e / kWideRows : e % kWideRows;
            const bool tri = FWD ? c < i : c > i;
            S2[i * kWidePad + c] =
                i < nrows && c < nrows && tri ? F[at<TRANS>(r0 + i, r0 + c, mp)] : A(0);
            const int c1 = n1 * kWideRows + c;
            S1[i * kWidePad + c] =
                i < nrows && has1 && c1 < wp ? F[at<TRANS>(r0 + i, c1, mp)] : A(0);
        }
        __syncthreads();
        if (t < kWideRows) {  // column t of the inverse: unit lower, or upper times 1/d
            Acc* x = X + t;
            for (int ii = 0; ii < kWideRows; ++ii) {
                const int i = FWD ? ii : kWideRows - 1 - ii;
                const int k0 = FWD ? t : i + 1, k1 = FWD ? i : t + 1;  // the solved rows
                const Acc v = fz<FTZ>(Acc(i == t) - dot4<FTZ, Acc>(S2 + i * kWidePad, x,
                                                                  kWidePad, k0, k1));
                x[i * kWidePad] = kUnit ? v : fz<FTZ>(v * rcp[i]);
            }
        }
        __syncthreads();
        for (int e = t; e < kWideRows * kWideRows; e += kWideThreads) {
            const int i = TRANS ? e % kWideRows : e / kWideRows;
            const int c = TRANS ? e / kWideRows : e % kWideRows;
            const int c2 = n2 * kWideRows + c;
            S2[i * kWidePad + c] =
                i < nrows && has2 && c2 < wp ? F[at<TRANS>(r0 + i, c2, mp)] : A(0);
        }
    }

    // stream this warp's rows against every other block of columns, in a fixed order
    Acc part[kWideRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kWideRowsPerWarp; ++j) part[j] = Acc(0);
    const int rw = warp * kWideRowsPerWarp;
    const int64_t rows0 = r0 + rw;  // this warp's first row
    if (!FWD) {  // U12 y[rsx], known from the start; kSpan columns' loads in flight at once
        constexpr int kSpan = sizeof(A) == 4 ? 8 : 4;  // columns a lane takes an iteration
        for (int c0 = 0; c0 < rp; c0 += 32 * kSpan) {
            Acc x[kSpan];
            A lv[kWideRowsPerWarp][kSpan];
#pragma unroll
            for (int h = 0; h < kSpan; ++h) {
                const int c = c0 + lane + 32 * h;
                const int row = c < rp ? rsx[static_cast<int64_t>(b) * rp + c] : n;
                x[h] = row < n ? Acc(fz<FTZ>(y[row])) : Acc(0);
#pragma unroll
                for (int j = 0; j < kWideRowsPerWarp; ++j)
                    lv[j][h] =
                        rw + j < nrows && c < rp ? F[at<TRANS>(rows0 + j, wp + c, mp)] : A(0);
            }
#pragma unroll
            for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
                for (int h = 0; h < kSpan; ++h) part[j] = muladd<FTZ>(Acc(lv[j][h]), x[h], part[j]);
            }
        }
    }
    // forward: column blocks 0 .. blk - 3 (a panel task: all); backward: nrb - 1 .. blk + 3
    const int nstream = panel ? nrb : (FWD ? max(blk - 2, 0) : max(nrb - blk - 3, 0));
    for (int s = 0; s < nstream; ++s) {
        const int kb = FWD ? s : nrb - 1 - s;
        const int c0 = kb * kWideRows;
        // a block far from this task's own is not on the chain's path: poll it at leisure
        const bool patient = panel ? kb < nrb - 2 : (FWD ? kb < blk - 4 : kb > blk + 4);
        A lv[kWideRowsPerWarp][2];  // asked for before the wait for z
#pragma unroll
        for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = c0 + lane + 32 * h;
                lv[j][h] = rw + j < nrows && c < wp ? F[at<TRANS>(rows0 + j, c, mp)] : A(0);
            }
        }
        if (warp == 0) {
            A z[2];
            mail_recv_pair(mb, c0 + lane, wp, tag, patient, z);
            zs[s & 1][lane] = z[0];
            zs[s & 1][lane + 32] = z[1];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                part[j] = muladd<FTZ>(Acc(lv[j][h]), Acc(zs[s & 1][lane + 32 * h]), part[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kWideRowsPerWarp; ++j) {
        const Acc s = group_sum(part[j], 32);
        if (lane == 0) acc[rw + j] = s;
    }
    __syncthreads();

    if (panel) {
        if (t < nrows) upd[static_cast<int64_t>(b) * rp + (r0 - wp) + t] = fz<FTZ>(A(-acc[t]));
    } else {
        // the whole block finishes the rows, four threads a row on 16 columns each: the two
        // blocks beside the diagonal as their z arrive (warp 0 takes them from the mailbox),
        // then z = X rhs; the four partials are summed in a fixed butterfly
        const int r = t >> 2, q = t & 3;
        Acc v = r < nrows ? fz<FTZ>(Acc(yp[r]) - acc[r]) : Acc(0);
        for (int near = 2; near >= 1; --near) {
            if (!(near == 2 ? has2 : has1)) continue;
            if (warp == 0) {
                A z[2];
                mail_recv_pair(mb, (near == 2 ? n2 : n1) * kWideRows + lane, wp, tag, false, z);
                zn[lane] = z[0];
                zn[lane + 32] = z[1];
            }
            __syncthreads();
            const A* M = near == 2 ? S2 : S1;
            v = fz<FTZ>(v - quarter_dot<FTZ, Acc>(M + r * kWidePad, zn, q));
            __syncthreads();  // zn is read before the next block overwrites it
        }
        if (q == 0) rhs[r] = v;
        __syncthreads();
        const A zr = A(quarter_dot<FTZ, Acc>(X + r * kWidePad, rhs, q));
        if (q == 0 && r < nrows) {
            mail_send(mb, r0 + r, zr, tag);
            const int row = piv[static_cast<int64_t>(b) * wp + r0 + r];
            if (row < n) y[row] = zr;
        }
    }
}

// ---------------------------------------------------------------------------
// ordered row reduction
// ---------------------------------------------------------------------------

template <typename A>
__device__ __forceinline__ A add(A a, A b, int do_flush) {
    const A s = a + b;
    return do_flush ? flush(s) : s;
}

// Sum over a lane group of g lanes as group_sum, each partial flushed under do_flush.
template <typename A>
__device__ __forceinline__ A group_sum_fz(A s, int g, int do_flush) {
    for (int off = g >> 1; off > 0; off >>= 1) s = add(s, __shfl_down_sync(kFull, s, off, g), do_flush);
    return s;
}

template <typename A>
__global__ void __launch_bounds__(kReduceThreads)
rows_reduce_kernel(A* __restrict__ y, const A* __restrict__ upd,
                   const int32_t* __restrict__ rows, const int64_t* __restrict__ ptr,
                   const int32_t* __restrict__ src, int nd, int do_flush) {
    const int lane = threadIdx.x & 31;
    const int r0 = (blockIdx.x * (kReduceThreads / 32) + (threadIdx.x >> 5)) * 32;
    if (r0 >= nd) return;  // whole warps leave together
    const int r = r0 + lane;
    int64_t p0 = 0, p1 = 0;
    if (r < nd) {
        p0 = ptr[r];
        p1 = ptr[r + 1];
    }
    const int64_t len = p1 - p0;
    if (r < nd && len <= kThreadRow) {  // a lane a row, its sources in order
        A v[kThreadRow];
#pragma unroll
        for (int k = 0; k < kThreadRow; ++k) v[k] = k < len ? upd[src[p0 + k]] : A(0);
        A s = A(0);
#pragma unroll
        for (int k = 0; k < kThreadRow; ++k)
            if (k < len) s = add(s, v[k], do_flush);
        y[rows[r]] = add(y[rows[r]], s, do_flush);
    }
    // rows of the second bin, four at a time, one to each group of kGroupLanes lanes
    unsigned mid = __ballot_sync(kFull, len > kThreadRow && len <= kGroupRow);
    const int sub = lane / kGroupLanes, ln = lane % kGroupLanes;
    while (mid) {
        int mine = -1;
        for (int q = 0; q < 32 / kGroupLanes && mid; ++q) {
            const int k = __ffs(mid) - 1;
            mid &= mid - 1;
            if (q == sub) mine = k;
        }
        const int at = mine < 0 ? 0 : mine;
        const int64_t q0 = __shfl_sync(kFull, p0, at), q1 = __shfl_sync(kFull, p1, at);
        A s = A(0);
        if (mine >= 0)
            for (int64_t k = q0 + ln; k < q1; k += kGroupLanes) s = add(s, upd[src[k]], do_flush);
        s = group_sum_fz(s, kGroupLanes, do_flush);
        if (mine >= 0 && ln == 0) y[rows[r0 + mine]] = add(y[rows[r0 + mine]], s, do_flush);
    }
    // the longest rows, a warp each
    unsigned big = __ballot_sync(kFull, len > kGroupRow);
    while (big) {
        const int k0 = __ffs(big) - 1;
        big &= big - 1;
        const int64_t q0 = __shfl_sync(kFull, p0, k0), q1 = __shfl_sync(kFull, p1, k0);
        A s = A(0);
        for (int64_t k = q0 + lane; k < q1; k += 32) s = add(s, upd[src[k]], do_flush);
        s = group_sum_fz(s, 32, do_flush);
        if (lane == 0) y[rows[r0 + k0]] = add(y[rows[r0 + k0]], s, do_flush);
    }
}

bool bad_group(int nfronts, int wp, int rp) { return nfronts < 1 || wp < 1 || rp < 0; }

// The wide kernel's dynamic shared memory: the inverse and the two blocks beside it.
template <typename A, bool FTZ>
constexpr size_t wide_smem_bytes() {
    return kWideRows * kWidePad * (sizeof(WideAcc<A, FTZ>) + 2 * sizeof(A));
}

template <typename A, bool FTZ, bool TRANS>
int sweep_fwd(int device, const A* pool, int64_t g0, int nf, int wp, int rp, const int32_t* piv,
              A* y, int n, A* upd, int regime, int tiles, int* ctl, unsigned* mail,
              cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bad_group(nf, wp, rp) || tiles < 1 || tiles > 65535 ||
        (regime == kWarp && (wp > kWarpTri || tiles != 1)) ||
        (regime == kBlock && wp > kMaxTri) || (regime == kWide && tiles != 1) ||
        regime < kWarp || regime > kWide)
        return static_cast<int>(cudaErrorInvalidValue);
    if (regime == kWarp) {
        const unsigned blocks = static_cast<unsigned>((nf + kWarpFronts - 1) / kWarpFronts);
        front_fwd_warp<A, FTZ, TRANS><<<blocks, kWarpFronts * 32, 0, stream>>>(
            pool, g0, nf, wp, rp, piv, y, n, upd);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        front_fwd_block<A, FTZ, TRANS><<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv,
                                                                          y, n, upd, ctl);
    } else {
        const size_t smem = wide_smem_bytes<A, FTZ>();
        err = cudaFuncSetAttribute(front_wide_kernel<A, FTZ, true, TRANS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const int64_t tasks = static_cast<int64_t>(nf) *
            ((wp + kWideRows - 1) / kWideRows + (rp + kWideRows - 1) / kWideRows);
        if (tasks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
        front_wide_kernel<A, FTZ, true, TRANS><<<static_cast<unsigned>(tasks), kWideThreads, smem,
                                                 stream>>>(pool, g0, nf, wp, rp, piv, nullptr, y,
                                                           n, upd, ctl, mail, kTag);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename A, bool FTZ, bool TRANS>
int sweep_bwd(int device, const A* pool, int64_t g0, int nf, int wp, int rp, const int32_t* piv,
              const int32_t* rsx, A* y, int n, A* part, int regime, int tiles, int* ctl,
              unsigned* mail, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bad_group(nf, wp, rp) || tiles < 1 || tiles > 65535 ||
        (regime == kWarp && (wp > kWarpTri || tiles != 1)) ||
        (regime == kBlock && (wp > kMaxTri || (tiles > 1 && rp < tiles))) ||
        (regime == kWide && tiles != 1) || regime < kWarp || regime > kWide)
        return static_cast<int>(cudaErrorInvalidValue);
    if (regime == kWarp) {
        const unsigned blocks = static_cast<unsigned>((nf + kWarpFronts - 1) / kWarpFronts);
        front_bwd_warp<A, FTZ, TRANS><<<blocks, kWarpFronts * 32, 0, stream>>>(
            pool, g0, nf, wp, rp, piv, rsx, y, n);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        front_bwd_block<A, FTZ, TRANS><<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv,
                                                                          rsx, y, n, part, ctl);
    } else {
        const size_t smem = wide_smem_bytes<A, FTZ>();
        err = cudaFuncSetAttribute(front_wide_kernel<A, FTZ, false, TRANS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const int64_t tasks = static_cast<int64_t>(nf) * ((wp + kWideRows - 1) / kWideRows);
        if (tasks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
        front_wide_kernel<A, FTZ, false, TRANS><<<static_cast<unsigned>(tasks), kWideThreads,
                                                  smem, stream>>>(pool, g0, nf, wp, rp, piv, rsx,
                                                                  y, n, nullptr, ctl, mail, kTag);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface. Every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers; A is float for the f32 instances and double for f64.
//
// respa_extend_add_*: `pool` is the flat front pool; the group's fronts are
// pool[g0 + b*mp*mp ...], b < B, mp = wp + rp; `lp` int32[B, rp] (the rows in
// use first, then -1), `poff` int64[B] and `pmp` int32[B] the parent front's
// pool offset and size, `seg_ptr` int32[nseg + 1] the runs of fronts with one
// parent; `tiles` thread blocks share a parent's rows. `regime` 0 (rows) reads
// those; 1 (gather) reads the group's lists instead: `dst` int32[nd] (parent
// entries, offsets from `base`), `src` int32 and `ptr` int32[kmax + 1] (rank
// k's sources src[ptr[k] + d] for d < ptr[k + 1] - ptr[k], offsets from g0).
//
// respa_front_sweep_{fwd,bwd}_* and the transposed respa_front_sweep_t_{fwd,bwd}_*
// (K12, the same arguments): `piv` int32[B, wp] and `rsx` int32[B, rp]
// index y (A[n + 1]; an index >= n is padding: read as 0, never written;
// forward does not read rsx); `regime` 0 (warp: wp <= 32, tiles 1), 1 (block:
// wp <= respa_front_max_tri(), `tiles` blocks a front over its update rows)
// or 2 (wide: any wp, tiles 1). `out` is forward upd A[B, rp], backward the
// partials A[B, tiles, wp] of a tiled block group (not read otherwise).
// `ctl` int32[B] (the block regime's tickets; the wide regime's one ticket)
// and `mail` uint32[B * wp * sizeof(A) / 2] (wide regime only) zeroed for this
// launch and for no other: a launch leaves them used.
//
// respa_rows_reduce_*: y[rows[r]] += sum of upd[src[ptr[r] : ptr[r+1]]], r < nd.
extern "C" {

int respa_front_max_tri() { return kMaxTri; }

#define RESPA_EXTEND_ADD(NAME, A, FTZ)                                                        \
    int NAME(int device, void* pool, int64_t g0, int nfronts, int wp, int rp, const void* lp, \
             const void* poff, const void* pmp, const void* seg_ptr, int nseg, int tiles,     \
             int regime, int64_t base, int nd, int kmax, const void* dst, const void* src,    \
             const void* ptr, void* stream) {                                                 \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (bad_group(nfronts, wp, rp) || rp < 1 || nseg < 1 || tiles < 1 || tiles > 65535)   \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        cudaStream_t s = static_cast<cudaStream_t>(stream);                                   \
        if (regime == 1) {                                                                    \
            if (nd < 1 || kmax < 1) return static_cast<int>(cudaErrorInvalidValue);           \
            extend_add_gather<A, FTZ><<<static_cast<unsigned>((nd + kAddThreads - 1) /        \
                                                              kAddThreads),                   \
                                        kAddThreads, 0, s>>>(                                 \
                static_cast<A*>(pool), g0, base, nd, kmax, static_cast<const int32_t*>(dst),  \
                static_cast<const int32_t*>(src), static_cast<const int32_t*>(ptr));          \
            return static_cast<int>(cudaGetLastError());                                      \
        }                                                                                     \
        if (regime != 0) return static_cast<int>(cudaErrorInvalidValue);                      \
        dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(tiles));                 \
        auto rows = rp <= 32 ? extend_add_rows<A, FTZ, 1> : extend_add_rows<A, FTZ, kAddPiece>; \
        rows<<<grid, kAddThreads, 0, s>>>(                                                    \
            static_cast<A*>(pool), g0, wp, rp, static_cast<const int32_t*>(lp),               \
            static_cast<const int64_t*>(poff), static_cast<const int32_t*>(pmp),              \
            static_cast<const int32_t*>(seg_ptr));                                            \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_EXTEND_ADD(respa_extend_add_f32, float, false)
RESPA_EXTEND_ADD(respa_extend_add_f32_ftz, float, true)
RESPA_EXTEND_ADD(respa_extend_add_f64, double, false)

#define RESPA_FRONT_SWEEP(PREFIX, SUFFIX, A, FTZ, TRANS)                                      \
    int PREFIX##_fwd_##SUFFIX(int device, const void* pool, int64_t g0, int nfronts,          \
                              int wp, int rp, const void* piv, const void* rsx,               \
                              void* y, int n, void* out, int regime, int tiles,               \
                              void* ctl, void* mail, void* stream) {                          \
        (void)rsx;                                                                            \
        return sweep_fwd<A, FTZ, TRANS>(device, static_cast<const A*>(pool), g0, nfronts, wp, rp, \
                                 static_cast<const int32_t*>(piv), static_cast<A*>(y), n,     \
                                 static_cast<A*>(out), regime, tiles, static_cast<int*>(ctl), \
                                 static_cast<unsigned*>(mail),                                \
                                 static_cast<cudaStream_t>(stream));                          \
    }                                                                                         \
    int PREFIX##_bwd_##SUFFIX(int device, const void* pool, int64_t g0, int nfronts,          \
                              int wp, int rp, const void* piv, const void* rsx,               \
                              void* y, int n, void* out, int regime, int tiles,               \
                              void* ctl, void* mail, void* stream) {                          \
        return sweep_bwd<A, FTZ, TRANS>(device, static_cast<const A*>(pool), g0, nfronts, wp, rp, \
                                 static_cast<const int32_t*>(piv),                            \
                                 static_cast<const int32_t*>(rsx), static_cast<A*>(y), n,     \
                                 static_cast<A*>(out), regime, tiles, static_cast<int*>(ctl), \
                                 static_cast<unsigned*>(mail),                                \
                                 static_cast<cudaStream_t>(stream));                          \
    }

RESPA_FRONT_SWEEP(respa_front_sweep, f32, float, false, false)
RESPA_FRONT_SWEEP(respa_front_sweep, f32_ftz, float, true, false)
RESPA_FRONT_SWEEP(respa_front_sweep, f64, double, false, false)
RESPA_FRONT_SWEEP(respa_front_sweep_t, f32, float, false, true)
RESPA_FRONT_SWEEP(respa_front_sweep_t, f32_ftz, float, true, true)
RESPA_FRONT_SWEEP(respa_front_sweep_t, f64, double, false, true)

#define RESPA_ROWS_REDUCE(NAME, A)                                                            \
    int NAME(int device, void* y, const void* upd, const void* rows, const void* ptr,         \
             const void* src, int nd, int do_flush, void* stream) {                           \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nd < 1) return static_cast<int>(cudaErrorInvalidValue);                           \
        const int rows_per_block = kReduceThreads; /* 32 rows a warp */                       \
        const unsigned blocks = static_cast<unsigned>((nd + rows_per_block - 1) / rows_per_block); \
        rows_reduce_kernel<A><<<blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
            static_cast<A*>(y), static_cast<const A*>(upd), static_cast<const int32_t*>(rows), \
            static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(src), nd, do_flush); \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_ROWS_REDUCE(respa_rows_reduce_f32, float)
RESPA_ROWS_REDUCE(respa_rows_reduce_f64, double)

}  // extern "C"
