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
//   y[rsx]) (unit upper). The same blocks' bytes bound them as K4, the same
//   chain stands in the way, and K4's regimes, control words, tickets and
//   mailbox serve them unchanged; the kernels are their own, because read
//   transposed a front's outputs are consecutive entries of its rows, and
//   every product maps its lanes onto them:
//   * warp (built for W = wp rounded up to 8, 16 or 32): lane i holds column
//     i of the triangle (F's rows read along their entries); the forward
//     panel gives a lane an update row and loops over the pivots with z by
//     shuffles, no reduction tree; the backward panel puts the lanes on the
//     pivots and 32 / W lane groups on update rows, met in a fixed butterfly.
//   * block: a thread a pivot reads F's row c at step c, kAhead steps ahead;
//     the forward panel is a thread an update row over half the pivots (two
//     halves summed in order), the backward one threads on the pivots and
//     groups on update rows, y[rsx] staged in shared memory.
//   * wide (front_wide_t_kernel): a task streams 64 x 64 tiles of F's rows
//     (64 of them, its 64 columns) into a ring of shared memory by cp.async,
//     wide_t_stages() tiles ahead of the mailbox wait for their z block, so
//     that a block that arrives finds its tile there; a warp takes 8 rows of a
//     tile, a lane two outputs, and the eight warps' partials meet in a fixed
//     tree. The tasks, tickets, mailbox, the diagonal inverse built before
//     the wait, fp64 sums for fp32 and z rounded as it is published are K4's;
//     the inverse is its own: built four rows a step, its rows padded so that
//     the product z = X rhs, four threads a row on entries 4 apart held in
//     registers, meets no bank conflict (K4's quarters of its rows met four
//     at a time in one bank, and that product took most of a link).
//   The forward sweeps divide by U11's diagonal through its correctly
//   rounded reciprocal, taken before the chain; the FTZ instance rounds and
//   flushes through PTX's .ftz instructions. Every sum has a fixed order.
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
// frontal sweeps (K4): the warp regime
// ---------------------------------------------------------------------------

template <typename A, bool FTZ>
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
    A l[kWarpTri];  // lane i: row i of L11 left of the diagonal
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c) l[c] = c < lane && lane < wp ? F[lane * mp + c] : A(0);
    // upd = -L21 z: g lanes a row on consecutive columns (g >= wp), 32 / g rows a
    // pass; the first kPre passes' values are asked for before the triangle
    constexpr int kPre = 4;
    const int g = lanes_for(wp), ln = lane % g, sub = lane / g, per = 32 / g;
    A pre[kPre];
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int i = q * per + sub;
        pre[q] = i < rp && ln < wp ? F[(wp + i) * mp + ln] : A(0);
    }
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c) {
        if (c + 1 < wp) {  // z[c] is final here
            const A zc = __shfl_sync(kFull, v, c);
            if (lane > c) v = muladd<FTZ>(-l[c], zc, v);
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
        if (i < rp && ln < wp) s = muladd<FTZ>(F[(wp + i) * mp + ln], zc, s);
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ>
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
    A u[kWarpTri];  // lane i: row i of U11 from the diagonal on, asked for first
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c) u[c] = c >= lane && c < wp ? F[lane * mp + c] : A(0);
    // U12 y[rsx]: g lanes a pivot row on consecutive update rows
    const int g = lanes_for(rp), ln = lane % g, sub = lane / g, per = 32 / g;
    for (int i0 = 0; i0 < wp; i0 += per) {
        const int i = i0 + sub;
        A s = A(0);
        if (i < wp) {
            for (int r = ln; r < rp; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(F[i * mp + wp + r], fz<FTZ>(y[row]), s);
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
            if (lane == c) {
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
// frontal sweeps (K4): the block regime, a front's panel over gridDim.y tiles
// ---------------------------------------------------------------------------

template <typename A, bool FTZ>
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
        if (t > c && t < wp) v = muladd<FTZ>(-F[t * mp + c], z[c], v);
        if (t == c + 1) z[t] = v;
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
            for (int w = ln; w < wp; w += g) s = muladd<FTZ>(F[(wp + i) * mp + w], z[w], s);
        }
        s = group_sum(s, g);
        if (i < i_end && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ>
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
                if (row < n) s = muladd<FTZ>(F[i * mp + wp + r], fz<FTZ>(y[row]), s);
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
            v = fz<FTZ>(v / diag_or_one(F, t, mp));
            z[c] = v;
        }
        __syncthreads();
        if (t < c) v = muladd<FTZ>(-F[t * mp + c], z[c], v);
    }
    if (t < wp) {
        const int row = pv[t];
        if (row < n) y[row] = v;
    }
}

// ---------------------------------------------------------------------------
// frontal sweeps (K4): the wide regime, blocked substitution by ticketed tasks
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
template <typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kWideThreads)
front_wide_kernel(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                  const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                  A* __restrict__ y, int n, A* __restrict__ upd, int* __restrict__ ctl,
                  unsigned* __restrict__ mail, unsigned tag) {
    using Acc = WideAcc<A, FTZ>;
    constexpr bool kUnit = FWD;  // L11 forward
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
            const int i = e / kWideRows, c = e % kWideRows;  // along the front's rows
            const bool tri = FWD ? c < i : c > i;
            S2[i * kWidePad + c] =
                i < nrows && c < nrows && tri ? F[(r0 + i) * mp + r0 + c] : A(0);
            const int c1 = n1 * kWideRows + c;
            S1[i * kWidePad + c] = i < nrows && has1 && c1 < wp ? F[(r0 + i) * mp + c1] : A(0);
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
            const int i = e / kWideRows, c = e % kWideRows;
            const int c2 = n2 * kWideRows + c;
            S2[i * kWidePad + c] = i < nrows && has2 && c2 < wp ? F[(r0 + i) * mp + c2] : A(0);
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
                    lv[j][h] = rw + j < nrows && c < rp ? F[(rows0 + j) * mp + wp + c] : A(0);
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
                lv[j][h] = rw + j < nrows && c < wp ? F[(rows0 + j) * mp + c] : A(0);
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
// the transposed sweeps (K12)
// ---------------------------------------------------------------------------

// K12's arithmetic. Under FTZ it takes PTX's .ftz instructions, which flush
// subnormal inputs and results within the instruction (to a zero of the
// result's sign): a product and a sum are still rounded and flushed one after
// the other, in two instructions where an explicit flush took six.
__device__ __forceinline__ float mul_ftz(float a, float b) {
    float r;
    asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
    float r;
    asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
template <bool FTZ>
__device__ __forceinline__ float madd(float a, float b, float c) {
    if constexpr (FTZ) return add_ftz(mul_ftz(a, b), c);
    return fmaf(a, b, c);
}
template <bool FTZ>
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
template <bool FTZ, typename A>
__device__ __forceinline__ A mul_t(A a, A b) {
    if constexpr (FTZ) return mul_ftz(a, b);
    return a * b;
}
template <bool FTZ, typename A>
__device__ __forceinline__ A add_t(A a, A b) {
    if constexpr (FTZ) return add_ftz(a, b);
    return a + b;
}

// 1 / d, a zero d read as 1, correctly rounded: the forward sweep's division
// by U11's diagonal, taken off the chain, which then multiplies by it (within
// an ulp of the quotient).
__device__ __forceinline__ float recip_or_one(float d) { return d == 0.0f ? 1.0f : __frcp_rn(d); }
__device__ __forceinline__ double recip_or_one(double d) { return d == 0.0 ? 1.0 : __drcp_rn(d); }

// The warp regime's kernels are built for W = wp rounded up to 8, 16 or 32
// (the launch picks it), so that a group of narrow fronts, the populous ones,
// runs loops of W steps and holds W entries a lane.

// Warp regime, forward: lane i holds row i of U11^T, which is column i of U11:
// at pivot c the lanes read F's row c, consecutive entries. upd = -U12^T z:
// lane i takes update row i (F's column wp + i), the even and the odd pivots
// in order as two sums, z[c] by a shuffle; a pass of 32 update rows reads F's
// rows 0 .. wp - 1 along 32 consecutive entries. The first pass's entries of
// the first kPreC pivots are asked for before the triangle.
template <typename A, bool FTZ, int W>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_fwd_warp_t(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                 const int32_t* __restrict__ piv, A* __restrict__ y, int n,
                 A* __restrict__ upd) {
    constexpr int kPreC = W < 8 ? W : 8;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarpFronts + (threadIdx.x >> 5);
    if (b >= nf) return;  // whole warps leave together
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int row = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    A l[W];
#pragma unroll
    for (int c = 0; c < W; ++c) l[c] = c < lane && lane < wp ? F[c * mp + lane] : A(0);
    const A rd = lane < wp ? recip_or_one(F[lane * mp + lane]) : A(1);
    const A* col = F + wp + lane;  // update row `lane` of U12^T: F's column wp + lane
    A pre[kPreC];
#pragma unroll
    for (int c = 0; c < kPreC; ++c) pre[c] = c < wp && lane < rp ? col[c * mp] : A(0);
#pragma unroll
    for (int c = 0; c < W; ++c) {
        if (c < wp) {
            if (lane == c) v = mul_t<FTZ>(v, rd);
            if (c + 1 < wp) {  // z[c] is final here
                const A zc = __shfl_sync(kFull, v, c);
                if (lane > c) v = madd<FTZ>(-l[c], zc, v);
            }
        }
    }
    if (row < n) y[row] = v;
    if (rp == 0) return;
    for (int i0 = 0; i0 < rp; i0 += 32) {
        const bool live = i0 + lane < rp;
        A s[2] = {A(0), A(0)};  // even and odd pivots: two chains half as long
#pragma unroll
        for (int c = 0; c < W; ++c) {
            if (c < wp) {
                const A zc = __shfl_sync(kFull, v, c);
                const A f = i0 == 0 && c < kPreC ? pre[c < kPreC ? c : 0]
                                                 : (live ? col[c * mp + i0] : A(0));
                s[c & 1] = madd<FTZ>(f, zc, s[c & 1]);
            }
        }
        if (live) upd[static_cast<int64_t>(b) * rp + i0 + lane] = -add_t<FTZ>(s[0], s[1]);
    }
}

// Warp regime, backward: rhs = y[piv] - L21^T y[rsx]. Lane i % W takes pivot
// i, the 32 / W lane groups update rows 32 / W apart, each in order: an update
// row is F's row wp + r, read along its entries. The groups' partials meet in
// a fixed butterfly, then the unit upper triangle L11^T (lane i: column i of
// L11 below the diagonal).
template <typename A, bool FTZ, int W>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_bwd_warp_t(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                 const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                 A* __restrict__ y, int n) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarpFronts + (threadIdx.x >> 5);
    if (b >= nf) return;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    A u[W];
#pragma unroll
    for (int c = 0; c < W; ++c) u[c] = c > lane && c < wp ? F[c * mp + lane] : A(0);
    const int prow = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    const A yp = prow < n ? fz<FTZ>(y[prow]) : A(0);
    const int i = lane % W, grp = lane / W;
    A s = A(0);
#pragma unroll 4
    for (int r = grp; r < rp; r += 32 / W) {
        const int row = rs[r];
        const A x = row < n ? fz<FTZ>(y[row]) : A(0);
        if (i < wp) s = madd<FTZ>(F[(wp + r) * mp + i], x, s);
    }
#pragma unroll
    for (int off = W; off < 32; off <<= 1) s = add_t<FTZ>(s, __shfl_xor_sync(kFull, s, off));
    A v = lane < wp ? fz<FTZ>(yp - s) : A(0);
#pragma unroll
    for (int c = W - 1; c >= 0; --c) {
        if (c < wp) {
            const A zc = __shfl_sync(kFull, v, c);
            if (lane < c) v = madd<FTZ>(-u[c], zc, v);
        }
    }
    if (prow < n) y[prow] = v;
}

// Block regime: the triangle's entries of a pivot step are a row of F (thread
// t reads entry t), asked for kAhead steps before the step that uses them; the
// backward panel's entries are asked for kBatch at a time before their
// products (left to the compiler, that loop ran slower in fp32_ftz; the
// forward panel's loop measured faster left to it).
constexpr int kAhead = 8;
constexpr int kBatch = 8;

// Block regime, forward: U11^T z = y[piv] by substitution in shared memory
// (1 / the diagonal taken before the chain); then this tile's rows of upd =
// -U12^T z, a thread an update row (F's column wp + i) over one half of the
// pivots, the two halves summed in order; a pass of 64 rows reads F's rows
// along 64 consecutive entries.
template <typename A, bool FTZ>
__global__ void __launch_bounds__(kSweepThreads)
front_fwd_block_t(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                  const int32_t* __restrict__ piv, A* __restrict__ y, int n,
                  A* __restrict__ upd, int* __restrict__ ticket) {
    constexpr int kRows = kSweepThreads / 2;
    __shared__ A z[kMaxTri];
    __shared__ A half[kRows];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const bool mine = t < wp;
    const int row = mine ? piv[static_cast<int64_t>(b) * wp + t] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    const A rd = mine ? recip_or_one(F[t * mp + t]) : A(1);
    A ahead[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) ahead[k] = mine && k < wp ? F[k * mp + t] : A(0);
    if (t == 0) v = mul_t<FTZ>(v, rd);
    if (mine) z[t] = v;
    __syncthreads();
    if (tiles > 1) {
        // a tile draws its ticket once it has read y[piv]: the last to draw writes y[piv]
        if (t == 0) {
            last = atomicAdd(ticket + b, 1) == tiles - 1;
        }
        __syncthreads();
    }
    for (int c0 = 0; c0 + 1 < wp; c0 += kAhead) {
        A cur[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            cur[k] = ahead[k];
            const int c = c0 + kAhead + k;
            ahead[k] = mine && c < wp ? F[c * mp + t] : A(0);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            const int c = c0 + k;
            if (c + 1 < wp) {  // z[c] is final here
                if (t > c && mine) v = madd<FTZ>(-cur[k], z[c], v);
                if (t == c + 1) {
                    v = mul_t<FTZ>(v, rd);
                    z[t] = v;
                }
                __syncthreads();
            }
        }
    }
    if (row < n && (tiles == 1 || last)) y[row] = v;
    if (rp == 0) return;
    const int chunk = (rp + tiles - 1) / tiles;
    const int i_end = min(rp, static_cast<int>(blockIdx.y + 1) * chunk);
    const int h = t / kRows, wh = (wp + 1) / 2;
    const int w0 = h * wh, w1 = min(wp, w0 + wh);
    for (int base = static_cast<int>(blockIdx.y) * chunk; base < i_end; base += kRows) {
        const int i = base + t % kRows;
        A s = A(0);
        if (i < i_end) {
#pragma unroll 8
            for (int w = w0; w < w1; ++w) s = madd<FTZ>(F[w * mp + wp + i], z[w], s);
        }
        if (h == 1) half[t - kRows] = s;
        __syncthreads();
        if (h == 0 && i < i_end)
            upd[static_cast<int64_t>(b) * rp + i] = -add_t<FTZ>(s, half[t]);
        __syncthreads();
    }
}

// Block regime, backward: this tile's update rows r0 .. r1 - 1 of L21^T
// y[rsx], thread t % P on pivot t % P (P = wp rounded up to 32, 64 or 128),
// the 128 / P thread groups on update rows 128 / P apart, each in order, an
// update row read along F's row wp + r; y[rsx] staged in shared memory 128
// rows at a time; the groups' partials summed in group order. Then as K4:
// tiles leave partials [B, tiles, wp], the last tile sums them in tile order,
// and the unit upper triangle L11^T by substitution.
template <typename A, bool FTZ>
__global__ void __launch_bounds__(kSweepThreads)
front_bwd_block_t(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                  const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                  A* __restrict__ y, int n, A* __restrict__ part, int* __restrict__ ticket) {
    __shared__ A z[kMaxTri];
    __shared__ A xr[kSweepThreads];
    __shared__ A grp_sum[kSweepThreads];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y, tile = blockIdx.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* pv = piv + static_cast<int64_t>(b) * wp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    const int chunk = (rp + tiles - 1) / tiles;
    const int r0 = tile * chunk, r1 = min(rp, r0 + chunk);
    const int P = wp > 64 ? 128 : (wp > 32 ? 64 : 32), G = kSweepThreads / P;
    const int i = t % P, grp = t / P;
    A s = A(0);
    for (int s0 = r0; s0 < r1; s0 += kSweepThreads) {
        const int rows = min(kSweepThreads, r1 - s0);
        if (t < rows) {
            const int row = rs[s0 + t];
            xr[t] = row < n ? fz<FTZ>(y[row]) : A(0);
        }
        __syncthreads();
        if (i < wp) {
            for (int kb = grp; kb < rows; kb += kBatch * G) {  // kBatch loads, then products
                A f[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int k = kb + u * G;
                    f[u] = k < rows ? F[(wp + s0 + k) * mp + i] : A(0);
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    if (kb + u * G < rows) s = madd<FTZ>(f[u], xr[kb + u * G], s);
            }
        }
        __syncthreads();
    }
    grp_sum[t] = s;
    __syncthreads();
    if (t < wp) {
        for (int k = 1; k < G; ++k) s = add_t<FTZ>(s, grp_sum[k * P + t]);
        if (tiles > 1) {
            part[(static_cast<int64_t>(b) * tiles + tile) * wp + t] = s;
        } else {
            const int row = pv[t];
            z[t] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
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
            A p = A(0);
            for (int k = 0; k < tiles; ++k)
                p = fz<FTZ>(p + __ldcg(part + (static_cast<int64_t>(b) * tiles + k) * wp + t));
            const int row = pv[t];
            z[t] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - p);
        }
    }
    __syncthreads();
    const bool mine = t < wp;
    A v = mine ? z[t] : A(0);
    A ahead[kAhead];  // F's rows wp - 1, wp - 2, ...: column t of L11 from the bottom
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
        const int c = wp - 1 - k;
        ahead[k] = mine && c >= 0 ? F[c * mp + t] : A(0);
    }
    for (int c0 = wp - 1; c0 >= 0; c0 -= kAhead) {
        A cur[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            cur[k] = ahead[k];
            const int c = c0 - kAhead - k;
            ahead[k] = mine && c >= 0 ? F[c * mp + t] : A(0);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            const int c = c0 - k;
            if (c >= 0) {
                if (t == c) z[c] = v;  // L11^T has a unit diagonal
                __syncthreads();
                if (t < c) v = madd<FTZ>(-cur[k], z[c], v);
            }
        }
    }
    if (mine) {
        const int row = pv[t];
        if (row < n) y[row] = v;
    }
}

// Wide regime: the streamed tiles go through shared memory by cp.async, 16
// bytes at a time where a tile's rows start on 16-byte boundaries and it is
// 64 columns wide (every tile of a plan's front), else element by element (any
// front offset and width); a missing element is filled with zero.
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(live ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src),
                 "r"(live ? 8 : 0)
                 : "memory");
}
// 16 bytes, bypassing L1, for a tile whose rows start on 16-byte boundaries.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(live ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Tiles of a wide task's stream in flight at once: 16 KB each in fp32, 32 KB
// in fp64, so that two blocks fit an SM either way.
template <typename A>
__host__ __device__ constexpr int wide_t_stages() { return sizeof(A) == 4 ? 3 : 2; }
// K12's inverse X, rows padded to 68 words: the four threads of a row read
// entries 4 apart (k = 4j + q), so that a warp's eight rows and four quarters
// fall on distinct banks (K4's 16-entry quarters of 65-word rows met in one
// bank four at a time, and its product took most of a link).
constexpr int kXPad = kWideRows + 4;

// Row r of X times rhs, the quarter q of a row's four threads taking k = 4j + q
// (its entries of X, xr[j] = X[r][4j + q], held in registers) in four chains,
// met by a butterfly that gives the four the same bits.
template <bool FTZ, typename Acc>
__device__ __forceinline__ Acc x_dot(const Acc (&xr)[kWideRows / 4], const Acc* rhs, int q) {
    Acc p[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll
    for (int j = 0; j < kWideRows / 4; ++j) p[j & 3] = madd<FTZ>(xr[j], rhs[4 * j + q], p[j & 3]);
    Acc v = add_t<FTZ>(add_t<FTZ>(p[0], p[1]), add_t<FTZ>(p[2], p[3]));
    v = add_t<FTZ>(v, __shfl_xor_sync(kFull, v, 1));
    return add_t<FTZ>(v, __shfl_xor_sync(kFull, v, 2));
}
// Two neighbouring elements, read from shared memory at once.
template <typename A>
using Pair = std::conditional_t<sizeof(A) == 4, float2, double2>;
constexpr int kWideTile = kWideRows * kWideRows;

// One task of a wide front read transposed: outputs r0 .. r0 + nrows - 1,
// which are consecutive entries of F's rows. A triangle task (row block
// `blk`) solves its 64 unknowns: forward U11^T (lower, 1 / the diagonal from
// its inverse), backward L11^T (unit upper); a forward panel task forms its
// 64 entries of upd = -U12^T z. The task streams 64 x 64 tiles of F, 64 of
// its rows and the task's 64 columns: backward first the update rows' tiles
// (x = y[rsx]), then the z blocks after its own, last first; forward the z
// blocks before its own. Each tile comes by cp.async into a ring of
// wide_t_stages() stages, issued that many tiles before its x is waited for,
// so that a z block that arrives finds its tile in shared memory. A warp
// takes 8 of a tile's rows and a lane two neighbouring outputs: every load of
// the tile and every read of it runs along F's rows. The eight warps'
// partials are summed in a fixed tree, then z = X rhs (x_dot). Before its
// stream a triangle task builds the inverse X of its diagonal block (staged
// in the ring's last stage, which is issued after), four threads a column
// and four rows a step, and each thread takes its entries of X into
// registers.
template <typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kWideThreads)
front_wide_t_kernel(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                    const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                    A* __restrict__ y, int n, A* __restrict__ upd, int* __restrict__ ctl,
                    unsigned* __restrict__ mail, unsigned tag) {
    using Acc = WideAcc<A, FTZ>;
    constexpr int kStages = wide_t_stages<A>();
    constexpr bool kUnit = !FWD;  // L11^T backward; U11^T forward has its diagonal
    extern __shared__ __align__(16) unsigned char wide_smem[];
    Acc* X = reinterpret_cast<Acc*>(wide_smem);  // the diagonal block's inverse
    A* ring = reinterpret_cast<A*>(X + kWideRows * kXPad);
    A* D = ring + (kStages - 1) * kWideTile;  // the diagonal block (padded rows) while X is built
    __shared__ Acc xs[kWideRows];              // the x of the tile being summed
    __shared__ Acc red[kWideWarps][kWideRows];
    __shared__ Acc rhs[kWideRows];
    __shared__ Acc rcp[kWideRows];
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
    const int npan = FWD ? 0 : (rp + kWideRows - 1) / kWideRows;
    const int ntiles = npan + (panel ? nrb : (FWD ? blk : nrb - 1 - blk));
    // tile s: F's rows from row0 (those before rend), x from y[rsx] or z block kb
    auto kb_of = [&](int s) { return FWD ? s - npan : nrb - 1 - (s - npan); };
    const A* Fc = F + r0;  // the task's first column
    const bool vec = nrows == kWideRows &&
        (reinterpret_cast<uintptr_t>(Fc) | static_cast<uintptr_t>(mp * sizeof(A))) % 16 == 0;
    auto issue = [&](int s) {
        if (s < ntiles) {
            const int64_t row0 = s < npan ? wp + s * kWideRows : kb_of(s) * kWideRows;
            const int64_t rend = s < npan ? mp : wp;
            A* st = ring + (s % kStages) * kWideTile;
            if (vec) {
                constexpr int kPer = 16 / sizeof(A), kRowChunks = kWideRows / kPer;
#pragma unroll
                for (int e = t; e < kWideTile / kPer; e += kWideThreads) {
                    const int cc = e / kRowChunks, ii = e % kRowChunks * kPer;
                    const bool live = row0 + cc < rend;
                    cp_async16(st + cc * kWideRows + ii, live ? Fc + (row0 + cc) * mp + ii : Fc,
                               live);
                }
            } else {
#pragma unroll 4
                for (int e = t; e < kWideTile; e += kWideThreads) {
                    const int cc = e / kWideRows, ii = e % kWideRows;
                    const bool live = row0 + cc < rend && ii < nrows;
                    cp_async(st + e, live ? Fc + (row0 + cc) * mp + ii : F, live);
                }
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s + 1 < kStages; ++s) issue(s);

    if (!panel) {
        if (t < kWideRows) {
            const int row = t < nrows ? piv[static_cast<int64_t>(b) * wp + r0 + t] : n;
            yp[t] = row < n ? fz<FTZ>(y[row]) : A(0);
            if (!kUnit) {
                const A d = t < nrows ? F[static_cast<int64_t>(r0 + t) * mp + r0 + t] : A(0);
                rcp[t] = Acc(1) / (d == A(0) ? Acc(1) : Acc(d));
            }
        }
        // D[i][c] = F[r0 + c][r0 + i]: consecutive threads read along F's row r0 + c
        for (int e = t; e < kWideTile; e += kWideThreads) {
            const int c = e / kWideRows, i = e % kWideRows;
            const bool tri = FWD ? c < i : c > i;
            D[i * kWidePad + c] =
                i < nrows && c < nrows && tri ? F[(r0 + c) * mp + r0 + i] : A(0);
        }
        __syncthreads();
        {  // column c of the inverse (lower times 1/d, or unit upper): four threads a
           // column, four rows a step (their sums over the rows solved before the step
           // side by side, then the four in order)
            const int c = t >> 2, q = t & 3;
            Acc* x = X + c;
            for (int b4 = 0; b4 < kWideRows; b4 += 4) {
                int ii[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) ii[m] = FWD ? b4 + m : kWideRows - 1 - b4 - m;
                const int k0 = FWD ? c : kWideRows - b4, k1 = FWD ? b4 : c + 1;
                Acc pp[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
                for (int k = k0 + ((q - k0) & 3); k < k1; k += 4) {  // k % 4 == q
                    const Acc xk = x[k * kXPad];
#pragma unroll
                    for (int m = 0; m < 4; ++m)
                        pp[m] = madd<FTZ>(Acc(D[ii[m] * kWidePad + k]), xk, pp[m]);
                }
                Acc v[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    Acc sm = add_t<FTZ>(pp[m], __shfl_xor_sync(kFull, pp[m], 1));
                    sm = add_t<FTZ>(sm, __shfl_xor_sync(kFull, sm, 2));
#pragma unroll
                    for (int l = 0; l < m; ++l)
                        sm = madd<FTZ>(Acc(D[ii[m] * kWidePad + ii[l]]), v[l], sm);
                    const Acc w = fz<FTZ>(Acc(ii[m] == c) - sm);
                    v[m] = kUnit ? w : mul_t<FTZ>(w, rcp[ii[m]]);
                }
                if (q == 0) {
#pragma unroll
                    for (int m = 0; m < 4; ++m) x[ii[m] * kXPad] = v[m];
                }
                __syncwarp();  // the quad reads them at the next step
            }
        }
        __syncthreads();  // D's stage is free for the ring
    }
    const int r = t >> 2, q = t & 3;  // z = X rhs at the end, four threads a row
    Acc xr[kWideRows / 4];            // this thread's entries of X, asked for before the stream
#pragma unroll
    for (int j = 0; j < kWideRows / 4; ++j) xr[j] = panel ? Acc(0) : X[r * kXPad + 4 * j + q];

    // outputs 2 lane and 2 lane + 1 over this warp's rows, each in two chains (even and odd rows)
    Acc acc[2][2] = {{Acc(0), Acc(0)}, {Acc(0), Acc(0)}};
    int prow[2] = {n, n};               // warp 0: the update rows of the next y[rsx] tile
    if (warp == 0 && npan > 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h;
            prow[h] = r < rp ? rsx[static_cast<int64_t>(b) * rp + r] : n;
        }
    }
    for (int s = 0; s < ntiles; ++s) {
        issue(s + kStages - 1);  // into the stage tile s - 1 left
        if (warp == 0) {
            A x[2];
            if (s < npan) {
#pragma unroll
                for (int h = 0; h < 2; ++h) x[h] = prow[h] < n ? fz<FTZ>(y[prow[h]]) : A(0);
                if (s + 1 < npan) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = (s + 1) * kWideRows + lane + 32 * h;
                        prow[h] = r < rp ? rsx[static_cast<int64_t>(b) * rp + r] : n;
                    }
                }
            } else {
                // a block far from this task's own is not on the chain's path: poll it at leisure
                const int kb = kb_of(s);
                const bool patient = panel ? kb < nrb - 2 : (FWD ? kb < blk - 4 : kb > blk + 4);
                mail_recv_pair(mb, kb * kWideRows + lane, wp, tag, patient, x);
            }
            xs[lane] = Acc(x[0]);
            xs[lane + 32] = Acc(x[1]);
        }
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const A* st = ring + (s % kStages) * kWideTile + 2 * lane;
#pragma unroll
        for (int j = 0; j < kWideRowsPerWarp; ++j) {
            const int cc = warp * kWideRowsPerWarp + j;
            const Acc x = xs[cc];
            const auto pair = *reinterpret_cast<const Pair<A>*>(st + cc * kWideRows);
            acc[0][j & 1] = madd<FTZ>(Acc(pair.x), x, acc[0][j & 1]);
            acc[1][j & 1] = madd<FTZ>(Acc(pair.y), x, acc[1][j & 1]);
        }
        if (s + 1 < ntiles) __syncthreads();  // the stage and xs are read before they are refilled
    }
    cp_async_wait<0>();
    red[warp][2 * lane] = add_t<FTZ>(acc[0][0], acc[0][1]);
    red[warp][2 * lane + 1] = add_t<FTZ>(acc[1][0], acc[1][1]);
    __syncthreads();
    if (t < kWideRows) {  // the eight warps' partials in a fixed tree
        Acc h[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) h[w] = add_t<FTZ>(red[2 * w][t], red[2 * w + 1][t]);
        const Acc s = add_t<FTZ>(add_t<FTZ>(h[0], h[1]), add_t<FTZ>(h[2], h[3]));
        if (panel) {
            if (t < nrows) upd[static_cast<int64_t>(b) * rp + (r0 - wp) + t] = fz<FTZ>(A(-s));
        } else {
            rhs[t] = t < nrows ? fz<FTZ>(Acc(yp[t]) - s) : Acc(0);
        }
    }
    if (panel) return;
    __syncthreads();
    const A zr = A(x_dot<FTZ>(xr, rhs, q));
    if (q == 0 && r < nrows) {
        mail_send(mb, r0 + r, zr, tag);
        const int row = piv[static_cast<int64_t>(b) * wp + r0 + r];
        if (row < n) y[row] = zr;
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

// The wide kernels' dynamic shared memory. K4: the inverse and the two blocks
// beside it. K12: the inverse and the ring of streamed tiles, whose last
// stage (and 64 elements past it) holds the padded diagonal block while the
// inverse is built.
template <typename A, bool FTZ>
constexpr size_t wide_smem_bytes() {
    return kWideRows * kWidePad * (sizeof(WideAcc<A, FTZ>) + 2 * sizeof(A));
}
template <typename A, bool FTZ>
constexpr size_t wide_t_smem_bytes() {
    return kWideRows * kXPad * sizeof(WideAcc<A, FTZ>) +
           (wide_t_stages<A>() * kWideTile + kWideRows) * sizeof(A);
}

bool bad_group(int nfronts, int wp, int rp) { return nfronts < 1 || wp < 1 || rp < 0; }

// One launch of a wide kernel over ``tasks`` tasks, after raising its dynamic
// shared memory to ``smem`` bytes.
template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, size_t smem, int64_t tasks, cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tasks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(tasks), kWideThreads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
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
        auto kernel = !TRANS    ? front_fwd_warp<A, FTZ>
                      : wp <= 8  ? front_fwd_warp_t<A, FTZ, 8>
                      : wp <= 16 ? front_fwd_warp_t<A, FTZ, 16>
                                 : front_fwd_warp_t<A, FTZ, 32>;
        kernel<<<blocks, kWarpFronts * 32, 0, stream>>>(pool, g0, nf, wp, rp, piv, y, n, upd);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        auto kernel = TRANS ? front_fwd_block_t<A, FTZ> : front_fwd_block<A, FTZ>;
        kernel<<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv, y, n, upd, ctl);
    } else {
        const int64_t tasks = static_cast<int64_t>(nf) *
            ((wp + kWideRows - 1) / kWideRows + (rp + kWideRows - 1) / kWideRows);
        const int32_t* none = nullptr;
        if (TRANS)
            return launch_wide(front_wide_t_kernel<A, FTZ, true>, wide_t_smem_bytes<A, FTZ>(),
                               tasks, stream, pool, g0, nf, wp, rp, piv, none, y, n, upd, ctl,
                               mail, kTag);
        return launch_wide(front_wide_kernel<A, FTZ, true>, wide_smem_bytes<A, FTZ>(), tasks,
                           stream, pool, g0, nf, wp, rp, piv, none, y, n, upd, ctl, mail, kTag);
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
        auto kernel = !TRANS    ? front_bwd_warp<A, FTZ>
                      : wp <= 8  ? front_bwd_warp_t<A, FTZ, 8>
                      : wp <= 16 ? front_bwd_warp_t<A, FTZ, 16>
                                 : front_bwd_warp_t<A, FTZ, 32>;
        kernel<<<blocks, kWarpFronts * 32, 0, stream>>>(pool, g0, nf, wp, rp, piv, rsx, y, n);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        auto kernel = TRANS ? front_bwd_block_t<A, FTZ> : front_bwd_block<A, FTZ>;
        kernel<<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv, rsx, y, n, part, ctl);
    } else {
        const int64_t tasks = static_cast<int64_t>(nf) * ((wp + kWideRows - 1) / kWideRows);
        A* none = nullptr;
        if (TRANS)
            return launch_wide(front_wide_t_kernel<A, FTZ, false>, wide_t_smem_bytes<A, FTZ>(),
                               tasks, stream, pool, g0, nf, wp, rp, piv, rsx, y, n, none, ctl,
                               mail, kTag);
        return launch_wide(front_wide_kernel<A, FTZ, false>, wide_smem_bytes<A, FTZ>(), tasks,
                           stream, pool, g0, nf, wp, rp, piv, rsx, y, n, none, ctl, mail, kTag);
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
