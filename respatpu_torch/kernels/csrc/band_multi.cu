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
// What bounds it: operations. A sweep multiplies every panel block of one
// side of the band with nrhs columns, 2 p^2 nrhs flops a block, and solves
// nb triangles of p^2 nrhs; SPIKE's tips on 2cubes_sphere (nb = 203 a
// shard, ml = mu = 18, p = 128, 2,304 columns) are about 0.28 TFLOP a sweep,
// 4.2 ms at 67 TFLOP/s fp32 outside the tensor cores. The band's bytes (one
// side, 0.24 GB a shard) take 0.07 ms at 3.35 TB/s.
//
// Design: the columns are independent, so the blocks of a tile of kCols
// columns walk every block row in the sweep's order and wait for no other
// tile. A block's 128 threads form 16 row groups x 8 column groups: each
// thread keeps an 8 x 4 tile of the block row's p x 32 sums in registers. A
// block row's panel products stream the band row through shared memory in
// chunks of kChunk band columns (each tile re-reads the band from L2) beside
// the matching kChunk rows of the solved vector blocks; a column of a chunk
// costs a thread three 16-byte shared reads (8 panel values, 4 vector values)
// for 32 fused multiply-adds. The chunks are double-buffered: the next one is
// in flight (cp.async for fp32 and fp64, registers for bf16) while the block
// computes on this one, one barrier a chunk. Then the diagonal block streams
// through the same buffers and each half-warp solves its 4 columns by
// shuffles, no barrier inside a chunk: forward the unit lower triangle,
// pivot j handed from its row group to the 15 others; backward the upper
// one, the owner dividing by the diagonal first. Where the tiles fill the
// SMs one block walks all of a tile's rows; with fewer (a handful of
// right-hand sides, which would leave one SM streaming the whole band) up to
// ml + 1 (mu + 1) blocks of a tile, as many as the idle SMs allow, take its
// rows in turn, as K2's blocks do, each publishing a
// finished block row through a flag (release / acquire) that the blocks of
// the later rows wait on; the far panels are multiplied before the near row
// is done. Every sum has an order fixed by the shape (the panels from the
// farthest to the nearest, a chunk's columns in order), so a sweep repeats
// bit for bit. Products stay in full fp32 (no TF32), as respatpu's front
// products (snlu_device.py:288-292); fp64 in plain fp64 FMAs.
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
constexpr int kCols = 32;                 // right-hand-side columns a block owns
constexpr int kRows = 8;                  // rows a thread keeps
constexpr int kTn = 4;                    // columns a thread keeps
constexpr int kGroups = kMultiMaxP / kRows;  // row groups: 16, a half-warp
constexpr int kThreads = kGroups * kCols / kTn;  // 128
constexpr int kChunk = 32;                // band columns a chunk stages

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
template <typename V, typename A>
struct BandChunk {
    V held[kChunk * kMultiMaxP / kThreads];  // the bf16 path's values in flight

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
            for (int ib = 0; ib < kMultiMaxP / (kThreads / 8); ++ib) {
                const int i = i0 + ib * (kThreads / 8);
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
                    held[kb * (kMultiMaxP / (kThreads / 8)) + ib] = in ? *src : narrow<V>(0.0f);
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
                for (int ib = 0; ib < kMultiMaxP / (kThreads / 8); ++ib) {
                    const int kk = 8 * kb + k, i = i0 + ib * (kThreads / 8);
                    tile[kk * L::kLine + (i / kRows) * L::kSlot + i % kRows] =
                        widen(held[kb * (kMultiMaxP / (kThreads / 8)) + ib]);
                }
            }
        }
    }
};

// A chunk of solved rows in flight: rows r0 .. r0 + kChunk - 1 (those below
// `rows`) of the block's column tile of out, read through L2 (another block
// of the launch may have written them) once their block row is published.
template <typename A>
struct VecChunk {
    A held[kChunk * kCols / kThreads];

    __device__ __forceinline__ void issue(const A* out, int64_t r0, int rows, int nrhs,
                                          int col0) {
#pragma unroll
        for (int u = 0; u < kChunk * kCols / kThreads; ++u) {
            const int e = threadIdx.x + u * kThreads;
            const int k = e / kCols, c = e % kCols;
            held[u] = (k < rows && col0 + c < nrhs) ? __ldcg(out + (r0 + k) * nrhs + col0 + c)
                                                    : A(0);
        }
    }

    __device__ __forceinline__ void land(A* ys) {
#pragma unroll
        for (int u = 0; u < kChunk * kCols / kThreads; ++u) ys[threadIdx.x + u * kThreads] = held[u];
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
// owner divides by the diagonal first. A row group's 8 pivots are unrolled,
// so the register of pivot j, j % 8, is named statically.
template <typename A, bool FTZ, bool FWD>
__device__ __forceinline__ void tri_chunk(const A* tile, int jc, int p, int group, int half,
                                          A (&acc)[kRows][kTn]) {
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
#pragma unroll
                    for (int cc = 0; cc < kTn; ++cc)
                        acc[jm][cc] = fz<FTZ>(div(acc[jm][cc], a[jm]));
                }
                A xj[kTn];
#pragma unroll
                for (int cc = 0; cc < kTn; ++cc)
                    xj[cc] = __shfl_sync(kFull, acc[jm][cc], half + jo);
#pragma unroll
                for (int m = 0; m < kRows; ++m) {
                    const int i = group * kRows + m;
                    if (FWD ? i > j : i < j) {
#pragma unroll
                        for (int cc = 0; cc < kTn; ++cc)
                            acc[m][cc] = minus_prod<FTZ>(acc[m][cc], a[m], xj[cc]);
                    }
                }
            }
        }
    }
}

// The shared memory of a block: two band chunks and two vector chunks, one
// being read while the next one lands.
template <typename A>
constexpr size_t multi_smem() {
    return 2 * (static_cast<size_t>(kChunk) * Layout<A>::kLine + kChunk * kCols) * sizeof(A);
}

template <typename V, typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kThreads)
band_multi_kernel(int nb, int p, int ml, int mu, int nrhs, int first_row,
                  const V* __restrict__ band, const A* __restrict__ b, A* out, int* ready) {
    using L = Layout<A>;
    extern __shared__ __align__(16) unsigned char multi_raw[];
    A* tiles = reinterpret_cast<A*>(multi_raw);               // 2 x kChunk * kLine
    A* vecs = tiles + 2 * kChunk * L::kLine;                  // 2 x kChunk * kCols
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int group = lane & (kGroups - 1);  // rows 8 group .. 8 group + 7
    const int half = lane & kGroups;         // the first lane of my half-warp
    const int c = (warp * 2 + (lane >> 4)) * kTn;  // my columns c .. c + 3 in the tile
    const int tile = blockIdx.x, ntiles = gridDim.x;
    const int col0 = tile * kCols;
    const int64_t w = static_cast<int64_t>(ml + mu + 1) * p;
    const int r0 = FWD ? first_row : 0;
    const int nch = (p + kChunk - 1) / kChunk;
    BandChunk<V, A> bnext;
    VecChunk<A> vnext;

    // the launch's gridDim.y blocks of a tile take its rows in turn
    for (int q = r0 + static_cast<int>(blockIdx.y); q < nb; q += gridDim.y) {
        const int r = FWD ? q : nb - 1 - q;
        const V* row = band + static_cast<int64_t>(r) * p * w;
        const int dmax = FWD ? min(ml, r - r0) : min(mu, nb - 1 - r);
        const int nsteps = (dmax + 1) * nch;  // the panels from the farthest, then the diagonal
        A acc[kRows][kTn];
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
            for (int cc = 0; cc < kTn; ++cc) acc[m][cc] = A(0);

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
            A* ys = vecs + buf * kChunk * kCols;
            bnext.land(tl);
            if (d > 0) vnext.land(ys);
            __syncthreads();  // the chunk has landed; the other buffer is free
            if (s + 1 < nsteps) issue(s + 1, buf ^ 1);
            if (d > 0) {
#pragma unroll 4
                for (int kk = 0; kk < kChunk; ++kk) {
                    A a[kRows], x[kTn];
                    read_rows(tl, kk, group, a);
                    read_vec<kTn>(ys + kk * kCols + c, x);
#pragma unroll
                    for (int m = 0; m < kRows; ++m)
#pragma unroll
                        for (int cc = 0; cc < kTn; ++cc)
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
                    for (int cc = 0; cc < kTn; ++cc) {
                        const A rhs = i < p && col0 + c + cc < nrhs ? fz<FTZ>(brow[cc]) : A(0);
                        acc[m][cc] = fz<FTZ>(sub(rhs, acc[m][cc]));
                    }
                }
            }
            tri_chunk<A, FTZ, FWD>(tl, jc, p, group, half, acc);
        }

#pragma unroll
        for (int m = 0; m < kRows; ++m) {
            const int i = group * kRows + m;
            A* orow = out + (static_cast<int64_t>(r) * p + i) * nrhs + col0 + c;
#pragma unroll
            for (int cc = 0; cc < kTn; ++cc)
                if (i < p && col0 + c + cc < nrhs) orow[cc] = acc[m][cc];
        }
        __threadfence();
        __syncthreads();  // every row of the tile is written, and the buffers are free
        if (threadIdx.x == 0) store_release(ready + static_cast<int64_t>(q) * ntiles + tile, 1);
    }
}

template <typename V, typename A, bool FTZ, bool FWD>
cudaError_t launch_band_multi(int device, int nb, int p, int ml, int mu, int nrhs, int first_row,
                              const void* band, const void* b, void* out, void* ready,
                              cudaStream_t stream) {
    auto kernel = band_multi_kernel<V, A, FTZ, FWD>;
    const size_t smem = multi_smem<A>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    // Where the tiles alone leave SMs idle (few right-hand sides), a tile's
    // rows go to `slots` blocks in turn, as many as give every SM one block,
    // at most one a panel and the diagonal, as K2 does. The slots wait on
    // each other, so they are launched cooperatively (all resident at once:
    // tiles * slots <= sms <= per_sm * sms).
    const int tiles = (nrhs + kCols - 1) / kCols;
    int slots = max(1, sms / tiles);
    slots = min(slots, (FWD ? ml : mu) + 1);
    slots = min(slots, nb - first_row);
    const V* band_v = static_cast<const V*>(band);
    const A* b_a = static_cast<const A*>(b);
    A* out_a = static_cast<A*>(out);
    int* ready_i = static_cast<int*>(ready);
    if (slots <= 1) {
        kernel<<<dim3(tiles, 1), kThreads, smem, stream>>>(nb, p, ml, mu, nrhs, first_row, band_v,
                                                          b_a, out_a, ready_i);
        return cudaGetLastError();
    }
    void* args[] = {&nb, &p, &ml, &mu, &nrhs, &first_row, &band_v, &b_a, &out_a, &ready_i};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(tiles, slots),
                                      dim3(kThreads), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes: respa_band_sweep_multi_{fwd,bwd}_*.
// `band` is the factored band [nb, p, (ml+mu+1)*p] in the instance's value
// type; `b` and `out` are [nb*p, nrhs] row-major in the accumulator type;
// forward sweeps start at block row `first_row` (out's rows before it are
// the caller's zeros), backward ones take first_row = 0. `ready` is
// int32[nb * ceil(nrhs / 32)], zero, for this launch alone. Returns the
// cudaError_t of the launch (0 = launched); allocates nothing, does not
// synchronise.
extern "C" {

#define RESPA_BAND_MULTI(NAME, V, A, FTZ, FWD)                                                 \
    int NAME(int device, int nb, int p, int ml, int mu, int nrhs, int first_row,              \
             const void* band, const void* b, void* out, void* ready, void* stream) {         \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nb <= 0 || p < 1 || p > kMultiMaxP || ml < 1 || mu < 1 || nrhs < 1 ||             \
            first_row < 0 || first_row >= nb || (!(FWD) && first_row != 0))                    \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        return static_cast<int>(launch_band_multi<V, A, FTZ, FWD>(                            \
            device, nb, p, ml, mu, nrhs, first_row, band, b, out, ready,                      \
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
