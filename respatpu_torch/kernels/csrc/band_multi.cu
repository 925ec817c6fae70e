// K10: the banded block substitution for several right-hand sides (sm_90a).
//
// Replaces respatpu/kernels/bandlu.py _solve_core (:284-335) with nrhs > 1,
// as respatpu/dist_lu.py runs it for SPIKE's tips (:112-131, V_j = A_j^-1
// [0; B_j] and W_j = A_j^-1 [C_j; 0], mu*p or ml*p columns each) and for a
// solve of several right-hand sides (:137). One launch is one sweep,
// forward (unit lower L) or backward (upper U), over b and out [nb*p, nrhs]
// row-major in the accumulator type; the band is read in its own type (fp32,
// bf16 or fp64) as the accumulator type.
//
// What bounds it: operations for many columns, bytes for a few. A sweep
// multiplies every panel block of one side of the band with nrhs columns,
// 2 p^2 nrhs flops a block, and solves nb triangles of p^2 nrhs; SPIKE's tips
// on 2cubes_sphere (nb = 203 a shard, ml = mu = 18, p = 128, 2,304 columns)
// are about 0.28 TFLOP a sweep, 4.2 ms at 67 TFLOP/s fp32 outside the tensor
// cores. The band's bytes (one side, 0.24 GB a shard) take 0.07 ms at
// 3.35 TB/s; a sweep of 4 columns over 2cubes_sphere's whole band (nb 812)
// reads 1 GB of it, 0.3 ms.
//
// The wrapper (kernels/bandlu.py _multi_plan) picks one of two regimes and
// its sizes at launch, from nrhs, the band and the card's SM count.
//
// Many columns: the columns are independent, so a tile of COLS columns (32
// or 128) walks every block row in the sweep's order and waits for no other
// tile. A tile's rows go to `slots` blocks in turn (row slots), as many as
// fill the SMs with one block each (slots <= ml + 1 or mu + 1), each
// publishing a finished block row through a flag (release / acquire) that
// the blocks of the later rows wait on; the far panels are multiplied before
// the near row is done, so only the nearest panel and the triangle of a row
// lie on the chain. At the tips' shape 18 tiles of 128 columns with 7 slots
// each take 126 of the H100's 132 SMs, 8 warps each, and the tiles read the
// band from L2 4.3 GB a sweep (a tile reads it once). A block's threads form
// 16 row groups x COLS / TN column groups: each thread keeps an 8 x TN tile
// of the block row's p x COLS sums in registers (8 x 8 at 128 columns: a
// staged column costs 4 16-byte shared reads for 64 fused multiply-adds). A
// block row's panel products stream the band row through shared memory in
// chunks of kChunk band columns beside the matching kChunk rows of the solved
// vector blocks. The chunks are double-buffered: the next one is in flight
// (cp.async for fp32 and fp64, registers for bf16, widened as it lands) while
// the block computes on this one, one barrier a chunk. Then the diagonal
// block streams through the same buffers and each half-warp solves its TN
// columns by shuffles, no barrier inside a chunk: forward the unit lower
// triangle, pivot j handed from its row group to the 15 others; backward the
// upper one, the owner scaling by the reciprocal of the diagonal first.
//
// Few columns (nrhs <= kFewCols = 4): K2's pipeline (band_lu.cu) as it was
// before K2 took the inverse of the diagonal triangle, carrying kFewCols
// values a row. slots = min(ml + 1 or mu + 1, rows, SMs) blocks,
// launched cooperatively, take the rows in turn; a row's block loads its
// diagonal block into shared memory, then for each panel from the farthest
// asks for its values (lane l keeps rows l, l + 32, .. of the panel, warp w
// its columns 16 w .. 16 w + 15) before it waits for the solved vector block
// in a mailbox of (word, tag) pairs, the way K2 does: the band is read once,
// and a row costs one trip through L2. The warps' partial sums are added in
// warp order through shared memory, and the triangle is solved by
// substitution as K11 solves it (32 unknowns a warp, shuffles inside it, one
// barrier a warp), kFewCols columns at a time.
//
// Every sum has an order fixed by the shape (the panels from the farthest
// to the nearest, a chunk's columns in order, the warps in order), so a
// sweep repeats bit for bit. A column's sums do not depend on the tile width
// or the slots, so the many-column regime gives the same bits on any card;
// the few-column regime sums in another order (by warps, and its triangle),
// so its bits depend on nrhs <= kFewCols alone. Products stay in full fp32
// (no TF32), as respatpu's front products (snlu_device.py:288-292); fp64 in
// plain fp64 FMAs.
//
// first_row (forward only): the right-hand side's block rows before it are
// zero, so out's rows there are zero (the wrapper writes them) and the
// panels that reach them add only zeros. The kernel starts at first_row and
// leaves those panels out; that changes no bit, since a fused multiply-add
// of a zero product leaves a sum as it was (a zero sum +0). SPIKE's V has
// its right-hand side in the last mu block rows only.
//
// FTZ instances: every product, partial sum, difference and quotient is
// flushed, as K2 flushes: products and differences by the .ftz instructions,
// the rest explicitly (common.cuh).

#include "common.cuh"

namespace {

constexpr int kMultiMaxP = 128;           // largest block (kMaxP of band_lu.cu)
constexpr int kRows = 8;                  // rows a thread keeps
constexpr int kGroups = kMultiMaxP / kRows;  // row groups: 16, a half-warp
constexpr int kChunk = 32;                // band columns a chunk stages
constexpr int kFewCols = 4;               // the few-column regime's right-hand sides

// The many-column regime's tiles: COLS columns, TN of them a thread, and
// kGroups * COLS / TN threads.
template <int COLS>
struct Tile;
template <>
struct Tile<32> {
    static constexpr int kTn = 4;
    static constexpr int kThreads = kGroups * 32 / kTn;  // 128
};
template <>
struct Tile<128> {
    static constexpr int kTn = 8;
    static constexpr int kThreads = kGroups * 128 / kTn;  // 256
};

// Shared layout of a staged chunk: for each of its kChunk band columns, the
// p rows by row group, group g's 8 rows contiguous from g * kSlot (padded so
// that 8 groups' 16-byte reads fall on distinct banks), and the column
// padded again so that a warp's stores of 8 columns x 4 rows do.
template <typename A>
struct Layout;
template <>
struct Layout<float> {
    static constexpr int kSlot = 12;
    static constexpr int kLine = kGroups * kSlot + 4;
};
template <>
struct Layout<double> {
    static constexpr int kSlot = 10;
    static constexpr int kLine = kGroups * kSlot + 2;
};

__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }

// The flushing product and difference, each one instruction: the .ftz forms
// flush a subnormal result (and operand) to a zero of its sign; the operands
// here are flushed already, so they give common.cuh's explicit flush up to
// the sign of a zero.
__device__ __forceinline__ float mul_ftz(float a, float b) {
    float r;
    asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
    float r;
    asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// acc - a * x, rounded once (fused) where nothing is flushed; under FTZ the
// product and the difference one after the other, each flushed
template <bool FTZ, typename A>
__device__ __forceinline__ A minus_prod(A acc, A a, A x) {
    if constexpr (FTZ) return sub_ftz(acc, mul_ftz(a, x));
    return fused(-a, x, acc);
}

// A band chunk in flight: the chunk k0 .. k0 + kChunk - 1 of the p x p block
// that starts at band column `col` of the block row at `row` (its rows w
// apart), staged into `tile` in the owners' layout, entries past p as zero.
// Where the band's type is the accumulator type the copy is asynchronous
// (cp.async through L1, no registers, the band is read-only); bf16 values
// wait in registers and are widened as they land.
template <typename V, typename A, int THREADS>
struct BandChunk {
    static constexpr int kRowStep = THREADS / 8;  // rows a pass of the block covers
    V held[kChunk * kMultiMaxP / THREADS];       // the bf16 path's values in flight

    __device__ __forceinline__ void issue(A* tile, const V* row, int64_t w, int p, int col,
                                          int k0) {
        using L = Layout<A>;
        // a warp reads 4 rows x 8 columns: 32-byte runs of the band, conflict-free stores
        const int t = threadIdx.x;
        const int k = t & 7, i0 = t >> 3;
#pragma unroll
        for (int kb = 0; kb < kChunk / 8; ++kb) {
            const int kk = 8 * kb + k;
            const bool in_k = k0 + kk < p;
#pragma unroll
            for (int ib = 0; ib < kMultiMaxP / kRowStep; ++ib) {
                const int i = i0 + ib * kRowStep;
                const bool in = in_k && i < p;
                const V* src = in ? row + i * w + col + k0 + kk : row;
                A* dst = tile + kk * L::kLine + (i / kRows) * L::kSlot + i % kRows;
                if constexpr (sizeof(V) == sizeof(A)) {
                    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
                    if constexpr (sizeof(A) == 4) {
                        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
                                     "l"(src), "r"(in ? 4 : 0) : "memory");
                    } else {
                        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s),
                                     "l"(src), "r"(in ? 8 : 0) : "memory");
                    }
                } else {
                    held[kb * (kMultiMaxP / kRowStep) + ib] = in ? *src : narrow<V>(0.0f);
                }
            }
        }
        if constexpr (sizeof(V) == sizeof(A)) asm volatile("cp.async.commit_group;" ::: "memory");
    }

    __device__ __forceinline__ void land(A* tile) {
        if constexpr (sizeof(V) == sizeof(A)) {
            asm volatile("cp.async.wait_group 0;" ::: "memory");
        } else {
            using L = Layout<A>;
            const int t = threadIdx.x;
            const int k = t & 7, i0 = t >> 3;
#pragma unroll
            for (int kb = 0; kb < kChunk / 8; ++kb) {
#pragma unroll
                for (int ib = 0; ib < kMultiMaxP / kRowStep; ++ib) {
                    const int kk = 8 * kb + k, i = i0 + ib * kRowStep;
                    tile[kk * L::kLine + (i / kRows) * L::kSlot + i % kRows] =
                        widen(held[kb * (kMultiMaxP / kRowStep) + ib]);
                }
            }
        }
    }
};

// A chunk of solved rows in flight: rows r0 .. r0 + kChunk - 1 (those below
// `rows`) of the block's column tile of out, read through L2 (another block
// of the launch may have written them) once their block row is published.
template <typename A, int COLS, int THREADS>
struct VecChunk {
    A held[kChunk * COLS / THREADS];

    __device__ __forceinline__ void issue(const A* out, int64_t r0, int rows, int nrhs,
                                          int col0) {
#pragma unroll
        for (int u = 0; u < kChunk * COLS / THREADS; ++u) {
            const int e = threadIdx.x + u * THREADS;
            const int k = e / COLS, c = e % COLS;
            held[u] = (k < rows && col0 + c < nrhs) ? __ldcg(out + (r0 + k) * nrhs + col0 + c)
                                                    : A(0);
        }
    }

    __device__ __forceinline__ void land(A* ys) {
#pragma unroll
        for (int u = 0; u < kChunk * COLS / THREADS; ++u) ys[threadIdx.x + u * THREADS] = held[u];
    }
};

// Block row q of the sweep is published: ready[q * tiles + tile] = 1. Every
// thread of a block that needs it waits for it (acquire); a wait of seconds
// traps instead of hanging.
__device__ __forceinline__ void wait_ready(const int* flag) {
    unsigned spins = 0;
    while (load_acquire(flag) == 0) backoff(spins);
}

// n contiguous values of shared memory, 16 bytes at a time (16-byte aligned)
template <int N>
__device__ __forceinline__ void read_vec(const float* src, float (&a)[N]) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(src)[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
    }
}
template <int N>
__device__ __forceinline__ void read_vec(const double* src, double (&a)[N]) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
        const double2 v = reinterpret_cast<const double2*>(src)[q];
        a[2 * q] = v.x;
        a[2 * q + 1] = v.y;
    }
}

// a thread's 8 values of column kk of a staged chunk (its row group's)
template <typename A>
__device__ __forceinline__ void read_rows(const A* tile, int kk, int group, A (&a)[kRows]) {
    read_vec<kRows>(tile + kk * Layout<A>::kLine + group * Layout<A>::kSlot, a);
}

// The triangle's columns jc * kChunk .. of the diagonal block, staged in
// `tile`: forward pivot j is final in its row group's registers and goes to
// the 15 other groups of the half-warp by shuffles, one a column; backward the
// owner first scales by the reciprocal of the diagonal (as tri_solve). A
// row group's 8 pivots are unrolled,
// so the register of pivot j, j % 8, is named statically.
template <typename A, bool FTZ, bool FWD, int TN>
__device__ __forceinline__ void tri_chunk(const A* tile, int jc, int p, int group, int half,
                                          A (&acc)[kRows][TN]) {
#pragma unroll 1
    for (int gq = 0; gq < kChunk / kRows; ++gq) {
        const int g = FWD ? gq : kChunk / kRows - 1 - gq;
        const int jo = jc * (kChunk / kRows) + g;  // the row group that owns these pivots
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
            const int jm = FWD ? u : kRows - 1 - u;  // the owner's register of pivot j
            const int jj = g * kRows + jm;
            const int j = jc * kChunk + jj;
            if (j < p) {
                A a[kRows];
                read_rows(tile, jj, group, a);  // column j of the block at my rows
                if (!FWD && group == jo) {
                    // one division a pivot: the half-warp runs the owner's branch
                    const A rinv = fz<FTZ>(div(A(1), a[jm]));
#pragma unroll
                    for (int cc = 0; cc < TN; ++cc)
                        acc[jm][cc] = fz<FTZ>(mul(acc[jm][cc], rinv));
                }
                A xj[TN];
#pragma unroll
                for (int cc = 0; cc < TN; ++cc)
                    xj[cc] = __shfl_sync(kFull, acc[jm][cc], half + jo);
#pragma unroll
                for (int m = 0; m < kRows; ++m) {
                    const int i = group * kRows + m;
                    if (FWD ? i > j : i < j) {
#pragma unroll
                        for (int cc = 0; cc < TN; ++cc)
                            acc[m][cc] = minus_prod<FTZ>(acc[m][cc], a[m], xj[cc]);
                    }
                }
            }
        }
    }
}

// The shared memory of a many-column block: two band chunks and two vector
// chunks, one being read while the next one lands.
template <typename A, int COLS>
constexpr size_t multi_smem() {
    return 2 * (static_cast<size_t>(kChunk) * Layout<A>::kLine + kChunk * COLS) * sizeof(A);
}

template <typename V, typename A, bool FTZ, bool FWD, int COLS>
__global__ void __launch_bounds__(Tile<COLS>::kThreads)
band_multi_kernel(int nb, int p, int ml, int mu, int nrhs, int first_row,
                  const V* __restrict__ band, const A* __restrict__ b, A* out, int* ready) {
    using L = Layout<A>;
    constexpr int TN = Tile<COLS>::kTn;
    constexpr int THREADS = Tile<COLS>::kThreads;
    extern __shared__ __align__(16) unsigned char multi_raw[];
    A* tiles = reinterpret_cast<A*>(multi_raw);               // 2 x kChunk * kLine
    A* vecs = tiles + 2 * kChunk * L::kLine;                  // 2 x kChunk * COLS
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int group = lane & (kGroups - 1);  // rows 8 group .. 8 group + 7
    const int half = lane & kGroups;         // the first lane of my half-warp
    const int c = (warp * 2 + (lane >> 4)) * TN;  // my columns c .. c + TN - 1 in the tile
    const int tile = blockIdx.x, ntiles = gridDim.x;
    const int col0 = tile * COLS;
    const int64_t w = static_cast<int64_t>(ml + mu + 1) * p;
    const int r0 = FWD ? first_row : 0;
    const int nch = (p + kChunk - 1) / kChunk;
    BandChunk<V, A, THREADS> bnext;
    VecChunk<A, COLS, THREADS> vnext;

    // the launch's gridDim.y blocks of a tile take its rows in turn
    for (int q = r0 + static_cast<int>(blockIdx.y); q < nb; q += gridDim.y) {
        const int r = FWD ? q : nb - 1 - q;
        const V* row = band + static_cast<int64_t>(r) * p * w;
        const int dmax = FWD ? min(ml, r - r0) : min(mu, nb - 1 - r);
        const int nsteps = (dmax + 1) * nch;  // the panels from the farthest, then the diagonal
        A acc[kRows][TN];
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
            for (int cc = 0; cc < TN; ++cc) acc[m][cc] = A(0);

        // step s: chunk s % nch of panel d = dmax - s / nch (d = 0: the diagonal block)
        auto issue = [&](int s, int buf) {
            const int d = dmax - s / nch;
            const int k0 = (d > 0 || FWD ? s % nch : nch - 1 - s % nch) * kChunk;
            const int col = (FWD ? ml - d : ml + d) * p;
            bnext.issue(tiles + buf * kChunk * L::kLine, row, w, p, col, k0);
            if (d > 0) {
                // once a panel, and not for a row this block solved itself
                if (k0 == 0 && d % gridDim.y != 0)
                    wait_ready(ready + static_cast<int64_t>(q - d) * ntiles + tile);
                vnext.issue(out, static_cast<int64_t>(FWD ? r - d : r + d) * p + k0,
                            min(kChunk, p - k0), nrhs, col0);
            }
        };
        issue(0, 0);
        for (int s = 0; s < nsteps; ++s) {
            const int buf = s & 1;
            const int d = dmax - s / nch;
            A* tl = tiles + buf * kChunk * L::kLine;
            A* ys = vecs + buf * kChunk * COLS;
            bnext.land(tl);
            if (d > 0) vnext.land(ys);
            __syncthreads();  // the chunk has landed; the other buffer is free
            if (s + 1 < nsteps) issue(s + 1, buf ^ 1);
            if (d > 0) {
#pragma unroll 4
                for (int kk = 0; kk < kChunk; ++kk) {
                    A a[kRows], x[TN];
                    read_rows(tl, kk, group, a);
                    read_vec<TN>(ys + kk * COLS + c, x);
#pragma unroll
                    for (int m = 0; m < kRows; ++m)
#pragma unroll
                        for (int cc = 0; cc < TN; ++cc)
                            acc[m][cc] = minus_prod<FTZ>(acc[m][cc], -a[m], x[cc]);
                }
                continue;
            }
            const int jc = FWD ? s % nch : nch - 1 - s % nch;
            if (s == dmax * nch) {  // the right-hand side less the panels' sum
#pragma unroll
                for (int m = 0; m < kRows; ++m) {
                    const int i = group * kRows + m;
                    const A* brow = b + (static_cast<int64_t>(r) * p + i) * nrhs + col0 + c;
#pragma unroll
                    for (int cc = 0; cc < TN; ++cc) {
                        const A rhs = i < p && col0 + c + cc < nrhs ? fz<FTZ>(brow[cc]) : A(0);
                        acc[m][cc] = fz<FTZ>(sub(rhs, acc[m][cc]));
                    }
                }
            }
            tri_chunk<A, FTZ, FWD, TN>(tl, jc, p, group, half, acc);
        }

#pragma unroll
        for (int m = 0; m < kRows; ++m) {
            const int i = group * kRows + m;
            A* orow = out + (static_cast<int64_t>(r) * p + i) * nrhs + col0 + c;
#pragma unroll
            for (int cc = 0; cc < TN; ++cc)
                if (i < p && col0 + c + cc < nrhs) orow[cc] = acc[m][cc];
        }
        __threadfence();
        __syncthreads();  // every row of the tile is written, and the buffers are free
        if (threadIdx.x == 0) store_release(ready + static_cast<int64_t>(q) * ntiles + tile, 1);
    }
}

// ---------------------------------------------------------------------------
// The few-column regime
// ---------------------------------------------------------------------------

constexpr int kFewThreads = 256;
constexpr int kFewWarps = kFewThreads / 32;
constexpr int kFewK = kMultiMaxP / kFewWarps;  // panel columns a warp sums: 16
constexpr int kFewS = kMultiMaxP / 32;         // panel rows a lane keeps: 4

// The mailbox: every 32-bit word of a solved block travels with its row's tag
// in one 8-byte store, which the card performs as a whole, so a reader that
// sees the tag has the word (K2's, band_lu.cu); a double is two such pairs.
__device__ __forceinline__ void mail_put(unsigned* slot, unsigned word, unsigned tag) {
    asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(slot), "r"(word), "r"(tag)
                 : "memory");
}

__device__ __forceinline__ unsigned mail_get(const unsigned* slot, unsigned tag) {
    unsigned word, seen, spins = 0;
    for (;;) {
        asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
                     : "=r"(word), "=r"(seen)
                     : "l"(slot)
                     : "memory");
        if (seen == tag) return word;
        if (++spins > kSpinLimit) __trap();
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
__device__ __forceinline__ float mail_recv(const unsigned* mail, int64_t e, unsigned tag,
                                           float) {
    return __uint_as_float(mail_get(mail + 2 * e, tag));
}
__device__ __forceinline__ double mail_recv(const unsigned* mail, int64_t e, unsigned tag,
                                            double) {
    const unsigned long long lo = mail_get(mail + 4 * e, tag);
    const unsigned long long hi = mail_get(mail + 4 * e + 2, tag);
    return __longlong_as_double(static_cast<long long>(lo | (hi << 32)));
}

// Solve the P x P triangle held in shared memory (`dblk`, row stride p + 1)
// against the kFewCols columns of `acc` ([p][kFewCols]) in place: the
// triangle solve of K2's and K11's first designs, its `mine` a value a
// column. In the solve's own order t = 0..P-1 (t = i for a lower system, t = P-1-i for an upper one)
// the system is lower; a non-unit row is first scaled by the reciprocal of
// its diagonal entry. Warp k owns the unknowns 32 k .. 32 k + 31, solves them
// through shuffles and puts them into shared memory; behind one barrier the
// later warps subtract their contribution.
template <typename A, bool FTZ, bool LOWER, bool UNIT>
__device__ __forceinline__ void tri_few(const A* dblk, A* acc, int p) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int lds = p + 1;
    const int nblk = (p + 31) / 32;
    const int t = 32 * warp + lane;
    const bool live = warp < nblk && t < p;
    const int i = LOWER ? t : p - 1 - t;
    if (warp < nblk) {
        A drow[32], mine[kFewCols];
        A rinv = A(1);
        if (!UNIT && live) rinv = fz<FTZ>(div(A(1), dblk[i * lds + i]));
#pragma unroll
        for (int s = 0; s < 32; ++s) {
            const int ts = 32 * warp + s;
            const int js = LOWER ? ts : p - 1 - ts;
            drow[s] = (live && s < lane) ? dblk[i * lds + js] : A(0);
            if (!UNIT) drow[s] = fz<FTZ>(mul(drow[s], rinv));
        }
#pragma unroll
        for (int cc = 0; cc < kFewCols; ++cc) {
            const A v = live ? acc[i * kFewCols + cc] : A(0);
            mine[cc] = UNIT ? v : fz<FTZ>(mul(v, rinv));
        }
        for (int k = 0; k < nblk; ++k) {
            if (warp == k) {
#pragma unroll
                for (int s = 0; s < 32; ++s) {
#pragma unroll
                    for (int cc = 0; cc < kFewCols; ++cc) {
                        const A xs = __shfl_sync(kFull, mine[cc], s);
                        if (lane > s) mine[cc] = minus_prod<FTZ>(mine[cc], drow[s], xs);
                    }
                }
                if (live) {
#pragma unroll
                    for (int cc = 0; cc < kFewCols; ++cc) acc[i * kFewCols + cc] = mine[cc];
                }
            }
            __syncthreads();
            if (warp > k && live) {
                A sum[kFewCols];
#pragma unroll
                for (int cc = 0; cc < kFewCols; ++cc) sum[cc] = A(0);
#pragma unroll 8
                for (int s = 0; s < 32; ++s) {
                    const int ts = 32 * k + s;
                    const int js = LOWER ? ts : p - 1 - ts;
                    const A dv = dblk[i * lds + js];
#pragma unroll
                    for (int cc = 0; cc < kFewCols; ++cc)
                        sum[cc] = minus_prod<FTZ>(sum[cc], -dv, acc[js * kFewCols + cc]);
                }
#pragma unroll
                for (int cc = 0; cc < kFewCols; ++cc)
                    mine[cc] = UNIT ? fz<FTZ>(sub(mine[cc], sum[cc]))
                                    : minus_prod<FTZ>(mine[cc], rinv, sum[cc]);
            }
        }
    } else {
        for (int k = 0; k < nblk; ++k) __syncthreads();
    }
    __syncthreads();
}

// shared values of a few-column block: the diagonal block (padded to 4
// values), the row's sums (then its solution), two vector blocks, and the
// warps' partial sums
__host__ __device__ __forceinline__ int few_dblk(int p) { return (p * (p + 1) + 3) & ~3; }

template <typename A>
size_t few_smem(int p) {
    return (static_cast<size_t>(few_dblk(p)) + static_cast<size_t>(3 + kFewWarps) * p * kFewCols) *
           sizeof(A);
}

template <typename V, typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kFewThreads)
band_few_kernel(int nb, int p, int ml, int mu, int nrhs, int first_row,
                const V* __restrict__ band, const A* __restrict__ b, A* __restrict__ out,
                unsigned* mail) {
    extern __shared__ __align__(16) unsigned char few_raw[];
    A* dblk = reinterpret_cast<A*>(few_raw);  // p x (p + 1)
    A* accs = dblk + few_dblk(p);             // p x kFewCols
    A* vbuf = accs + p * kFewCols;            // 2 x p x kFewCols
    A* red = vbuf + 2 * p * kFewCols;         // kFewWarps x p x kFewCols
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int64_t w = static_cast<int64_t>(ml + mu + 1) * p;
    const int r0 = FWD ? first_row : 0;
    const int m = FWD ? ml : mu;
    const int kb = warp * kFewK;  // my warp's panel columns kb .. kb + kFewK - 1
    const int pc = p * kFewCols;

    for (int q = r0 + static_cast<int>(blockIdx.x); q < nb; q += gridDim.x) {
        const int r = FWD ? q : nb - 1 - q;
        const V* row = band + static_cast<int64_t>(r) * p * w;
        for (int e = tid; e < p * p; e += kFewThreads) {
            const int i = e / p, k = e % p;
            dblk[i * (p + 1) + k] = widen(row[i * w + static_cast<int64_t>(ml) * p + k]);
        }
        A part[kFewS][kFewCols];
#pragma unroll
        for (int s = 0; s < kFewS; ++s)
#pragma unroll
            for (int cc = 0; cc < kFewCols; ++cc) part[s][cc] = A(0);

        const int dmax = min(m, q - r0);
        for (int d = dmax, t = 0; d >= 1; --d, ++t) {
            const V* pan = row + static_cast<int64_t>(FWD ? ml - d : ml + d) * p;
            // the panel's values are asked for before the wait for its vector
            V pv[kFewS][kFewK];
#pragma unroll
            for (int s = 0; s < kFewS; ++s) {
                const int i = lane + 32 * s;
#pragma unroll
                for (int kk = 0; kk < kFewK; ++kk) {
                    const int k = kb + kk;
                    pv[s][kk] = (i < p && k < p) ? pan[i * w + k] : V{};
                }
            }
            // the solved block q - d, from the mailbox
            A* vb = vbuf + (t & 1) * pc;
            const int64_t base = static_cast<int64_t>(q - d) * pc;
            for (int e = tid; e < pc; e += kFewThreads)
                vb[e] = fz<FTZ>(mail_recv(mail, base + e, q - d + 1, A(0)));
            __syncthreads();  // the block has landed (and the one before it is read)
#pragma unroll
            for (int kk = 0; kk < kFewK; ++kk) {
                const int k = kb + kk;
                if (k < p) {
                    A v[kFewCols];
#pragma unroll
                    for (int cc = 0; cc < kFewCols; ++cc) v[cc] = vb[k * kFewCols + cc];
#pragma unroll
                    for (int s = 0; s < kFewS; ++s) {
                        const A a = widen(pv[s][kk]);
#pragma unroll
                        for (int cc = 0; cc < kFewCols; ++cc)
                            part[s][cc] = minus_prod<FTZ>(part[s][cc], -a, v[cc]);
                    }
                }
            }
        }
        // the warps' partial sums, added in warp order
#pragma unroll
        for (int s = 0; s < kFewS; ++s) {
            const int i = lane + 32 * s;
            if (i < p) {
#pragma unroll
                for (int cc = 0; cc < kFewCols; ++cc)
                    red[(warp * p + i) * kFewCols + cc] = part[s][cc];
            }
        }
        __syncthreads();
        for (int e = tid; e < pc; e += kFewThreads) {
            const int i = e / kFewCols, cc = e % kFewCols;
            A sum = red[e];
            for (int v = 1; v < kFewWarps; ++v) sum = fz<FTZ>(add(sum, red[v * pc + e]));
            const A rhs = cc < nrhs ? fz<FTZ>(b[(static_cast<int64_t>(r) * p + i) * nrhs + cc])
                                    : A(0);
            accs[e] = fz<FTZ>(sub(rhs, sum));
        }
        __syncthreads();
        tri_few<A, FTZ, FWD, FWD>(dblk, accs, p);
        for (int e = tid; e < pc; e += kFewThreads) {
            mail_send(mail, static_cast<int64_t>(q) * pc + e, accs[e], q + 1);  // first
            const int i = e / kFewCols, cc = e % kFewCols;
            if (cc < nrhs) out[(static_cast<int64_t>(r) * p + i) * nrhs + cc] = accs[e];
        }
        __syncthreads();  // dblk, accs and red are rewritten in the next row
    }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename V, typename A, bool FTZ, bool FWD, int COLS>
cudaError_t launch_band_multi(int nb, int p, int ml, int mu, int nrhs, int first_row, int slots,
                              const void* band, const void* b, void* out, void* ready,
                              cudaStream_t stream) {
    auto kernel = band_multi_kernel<V, A, FTZ, FWD, COLS>;
    constexpr int THREADS = Tile<COLS>::kThreads;
    const size_t smem = multi_smem<A, COLS>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int tiles = (nrhs + COLS - 1) / COLS;
    const V* band_v = static_cast<const V*>(band);
    const A* b_a = static_cast<const A*>(b);
    A* out_a = static_cast<A*>(out);
    int* ready_i = static_cast<int*>(ready);
    if (slots <= 1) {
        kernel<<<dim3(tiles, 1), THREADS, smem, stream>>>(nb, p, ml, mu, nrhs, first_row, band_v,
                                                         b_a, out_a, ready_i);
        return cudaGetLastError();
    }
    // the slots of a tile wait on each other: all blocks resident at once
    void* args[] = {&nb, &p, &ml, &mu, &nrhs, &first_row, &band_v, &b_a, &out_a, &ready_i};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(tiles, slots),
                                      dim3(THREADS), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename V, typename A, bool FTZ, bool FWD>
cudaError_t launch_band_few(int nb, int p, int ml, int mu, int nrhs, int first_row, int slots,
                            const void* band, const void* b, void* out, void* mail,
                            cudaStream_t stream) {
    auto kernel = band_few_kernel<V, A, FTZ, FWD>;
    const size_t smem = few_smem<A>(p);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const V* band_v = static_cast<const V*>(band);
    const A* b_a = static_cast<const A*>(b);
    A* out_a = static_cast<A*>(out);
    unsigned* mail_u = static_cast<unsigned*>(mail);
    void* args[] = {&nb, &p, &ml, &mu, &nrhs, &first_row, &band_v, &b_a, &out_a, &mail_u};
    // cooperative, as K2: the mailbox waits need every block resident
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(slots),
                                      dim3(kFewThreads), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename V, typename A, bool FTZ, bool FWD>
cudaError_t launch_sweep_multi(int nb, int p, int ml, int mu, int nrhs, int first_row, int cols,
                               int slots, const void* band, const void* b, void* out,
                               void* ready, cudaStream_t stream) {
    const int m = FWD ? ml : mu;
    if (slots < 1 || slots > m + 1 || slots > nb - first_row) return cudaErrorInvalidValue;
    if (cols == kFewCols && nrhs <= kFewCols)
        return launch_band_few<V, A, FTZ, FWD>(nb, p, ml, mu, nrhs, first_row, slots, band, b,
                                               out, ready, stream);
    if (cols == 32)
        return launch_band_multi<V, A, FTZ, FWD, 32>(nb, p, ml, mu, nrhs, first_row, slots, band,
                                                     b, out, ready, stream);
    if (cols == 128)
        return launch_band_multi<V, A, FTZ, FWD, 128>(nb, p, ml, mu, nrhs, first_row, slots,
                                                      band, b, out, ready, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes: respa_band_sweep_multi_{fwd,bwd}_*.
// `band` is the factored band [nb, p, (ml+mu+1)*p] in the instance's value
// type; `b` and `out` are [nb*p, nrhs] row-major in the accumulator type;
// forward sweeps start at block row `first_row` (out's rows before it are
// the caller's zeros), backward ones take first_row = 0. `cols` picks the
// regime: kFewCols (nrhs <= kFewCols; `slots` blocks), or tiles of 32 or 128
// columns (`slots` row slots a tile, 1 for none). `ready` is zero, for this
// launch alone: int32[nb * ceil(nrhs / cols)] flags for a tile regime, the
// mailbox for the few-column one (2 * nb * p * kFewCols * (4-byte words of
// an accumulator value) 32-bit words). Returns the cudaError_t of the launch
// (0 = launched); allocates nothing, does not synchronise.
extern "C" {

int respa_band_multi_few_cols() { return kFewCols; }

#define RESPA_BAND_MULTI(NAME, V, A, FTZ, FWD)                                                 \
    int NAME(int device, int nb, int p, int ml, int mu, int nrhs, int first_row, int cols,    \
             int slots, const void* band, const void* b, void* out, void* ready,              \
             void* stream) {                                                                   \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nb <= 0 || p < 1 || p > kMultiMaxP || ml < 1 || mu < 1 || nrhs < 1 ||             \
            first_row < 0 || first_row >= nb || (!(FWD) && first_row != 0))                    \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        return static_cast<int>(launch_sweep_multi<V, A, FTZ, FWD>(                           \
            nb, p, ml, mu, nrhs, first_row, cols, slots, band, b, out, ready,                 \
            static_cast<cudaStream_t>(stream)));                                               \
    }

RESPA_BAND_MULTI(respa_band_sweep_multi_fwd_f32, float, float, false, true)
RESPA_BAND_MULTI(respa_band_sweep_multi_bwd_f32, float, float, false, false)
RESPA_BAND_MULTI(respa_band_sweep_multi_fwd_f32_ftz, float, float, true, true)
RESPA_BAND_MULTI(respa_band_sweep_multi_bwd_f32_ftz, float, float, true, false)
RESPA_BAND_MULTI(respa_band_sweep_multi_fwd_bf16, __nv_bfloat16, float, false, true)
RESPA_BAND_MULTI(respa_band_sweep_multi_bwd_bf16, __nv_bfloat16, float, false, false)
RESPA_BAND_MULTI(respa_band_sweep_multi_fwd_f64, double, double, false, true)
RESPA_BAND_MULTI(respa_band_sweep_multi_bwd_f64, double, double, false, false)

}  // extern "C"
