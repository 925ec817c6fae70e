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
//   run. So the group's fronts are sorted by parent, a thread block takes one
//   parent (blockIdx.x) and a share of its rows (blockIdx.y), and every warp
//   owns the destination rows with lp[i] % (warps in the grid row) == its
//   number: an entry of the parent is only ever touched by one warp, which
//   walks the parent's children in plan order with a warp barrier between two
//   children. No atomics, a fixed order, a factor that repeats bit for bit.
//   A warp reads 32 positions at once and finds its rows by a ballot. Bound
//   by bytes (each corner read once, each parent entry read and written
//   once); what keeps it from that bound is the serial walk over a hub
//   parent's hundreds of children (a memory trip each), and for one large
//   child the rows a warp takes one after the other.
//
// front_sweep fwd / bwd (replace `_fwd_group` :467-487 and `_bwd_group`
//   :490-509). One thread block a front. Forward: z = L11^-1 y[piv] (unit
//   lower, wp x wp), y[piv] = z, upd = -L21 z into a scratch [B, rp].
//   Backward: rhs = y[piv] - U12 y[rsx], z = U11^-1 rhs (a zero diagonal
//   entry is read as 1), y[piv] = z. Only the blocks in use are read
//   (L11/L21 or U11/U12), never the Schur corner. The triangle is solved
//   column by column, one thread a row and one block barrier a column, for
//   wp <= 128; a wider front (split != 0) leaves the triangle to the caller
//   and the kernel takes the panel product, tiled over blockIdx.y. A front
//   owns its pivot rows, so y[piv] needs no care; the update rows of
//   different fronts collide, which is what rows_reduce is for. Bound by
//   bytes (the wp x mp panel once); at wp = 8 by launch and barrier latency.
//
// rows_reduce (the forward sweep's `y.at[rsx].add(upd)`, :486, as a gather).
//   The plan holds, per group, the destination rows and for each the list of
//   (front, local row) sources in plan order as a CSR over the flat upd. One
//   warp a destination row: lanes take the sources 32 apart, each in order,
//   then a fixed shuffle tree. No atomics; the solve repeats bit for bit.
//
// FTZ instances: nvcc compiles with -ftz=false, so the flush is explicit, on
// what is read from y and on every product and sum.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTri = 128;       // widest pivot block a sweep block solves itself
constexpr int kSweepThreads = 128;
constexpr int kAddThreads = 256;
constexpr int kReduceThreads = 256;

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

// Lanes that share one row of a panel product: 8, 16 or 32 by its length.
__device__ __forceinline__ int lanes_for(int len) { return len > 16 ? 32 : (len > 8 ? 16 : 8); }

// Sum over the `g` lanes of a row's lane group (g a power of two <= 32), in a
// fixed tree; the group's first lane gets the total. The whole warp calls it.
template <typename A>
__device__ __forceinline__ A group_sum(A s, int g) {
    for (int off = g >> 1; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off, g);
    return s;
}

// ---------------------------------------------------------------------------
// extend-add
// ---------------------------------------------------------------------------

template <typename A, bool FTZ>
__global__ void __launch_bounds__(kAddThreads)
extend_add_kernel(A* __restrict__ pool, int64_t g0, int wp, int rp,
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
    // the first 32 positions of the next child are fetched while this one is
    // added, so a hub parent's many small children cost one memory trip each
    int ahead = lane < rp ? lp[static_cast<int64_t>(b0) * rp + lane] : -1;
    for (int b = b0; b < b1; ++b) {
        const A* child = pool + g0 + b * mp * mp;
        const int32_t* l = lp + static_cast<int64_t>(b) * rp;
        int di = ahead;
        if (b + 1 < b1) ahead = lane < rp ? l[rp + lane] : -1;
        for (int i0 = 0; i0 < rp; i0 += 32) {
            if (i0) di = i0 + lane < rp ? l[i0 + lane] : -1;
            // the rows of this 32 that this warp owns; the rows in use come first
            unsigned mine = __ballot_sync(0xffffffffu, di >= 0 && di % owners == me);
            const bool more = __all_sync(0xffffffffu, di >= 0);
            while (mine) {
                const int k = __ffs(mine) - 1;
                mine &= mine - 1;
                const int drow_at = __shfl_sync(0xffffffffu, di, k);
                const A* srow = child + (wp + i0 + k) * mp + wp;
                A* drow = parent + drow_at * pm;
                for (int j = lane; j < rp; j += 32) {
                    const int dj = l[j];
                    if (dj < 0) break;
                    drow[dj] = fz<FTZ>(drow[dj] + srow[j]);
                }
            }
            if (!more) break;
        }
        __syncwarp();  // the next child may reach the same entries from other lanes
    }
}

// ---------------------------------------------------------------------------
// frontal sweeps
// ---------------------------------------------------------------------------

template <typename A, bool FTZ>
__global__ void __launch_bounds__(kSweepThreads)
front_fwd_kernel(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                 const int32_t* __restrict__ piv, A* __restrict__ y, int n,
                 const A* __restrict__ zbuf, A* __restrict__ upd, int split) {
    __shared__ A z[kMaxTri];
    const int b = blockIdx.x, t = threadIdx.x;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const A* zz = z;
    if (!split) {
        const int row = t < wp ? piv[static_cast<int64_t>(b) * wp + t] : n;
        A v = row < n ? fz<FTZ>(y[row]) : A(0);
        if (t < wp) z[t] = v;
        __syncthreads();
        const A* lrow = F + t * mp;
        for (int c = 0; c + 1 < wp; ++c) {  // z[c] is final here
            if (t > c && t < wp) v = muladd<FTZ>(-lrow[c], z[c], v);
            if (t == c + 1) z[t] = v;
            __syncthreads();
        }
        if (row < n) y[row] = v;
    } else {
        zz = zbuf + static_cast<int64_t>(b) * wp;
    }
    if (rp == 0) return;
    const int g = lanes_for(wp);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    const int stride = gridDim.y * per_pass;
    for (int base = blockIdx.y * per_pass; base < rp; base += stride) {
        const int i = base + sub;
        A s = A(0);
        if (i < rp) {
            const A* lr = F + (wp + i) * mp;
            for (int w = ln; w < wp; w += g) s = muladd<FTZ>(lr[w], zz[w], s);
        }
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ>
__global__ void __launch_bounds__(kSweepThreads)
front_bwd_kernel(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                 const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                 A* __restrict__ y, int n, A* __restrict__ zbuf, int split) {
    __shared__ A z[kMaxTri];
    const int b = blockIdx.x, t = threadIdx.x;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* pv = piv + static_cast<int64_t>(b) * wp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    // rhs = y[piv] - U12 y[rsx], a lane group a pivot row
    const int g = lanes_for(rp);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    const int stride = gridDim.y * per_pass;
    for (int base = blockIdx.y * per_pass; base < wp; base += stride) {
        const int i = base + sub;
        A s = A(0);
        if (i < wp) {
            const A* ur = F + i * mp + wp;
            for (int r = ln; r < rp; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(ur[r], fz<FTZ>(y[row]), s);
            }
        }
        s = group_sum(s, g);
        if (i < wp && ln == 0) {
            const int row = pv[i];
            const A rhs = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
            if (split) zbuf[static_cast<int64_t>(b) * wp + i] = rhs;
            else z[i] = rhs;
        }
    }
    if (split) return;
    __syncthreads();
    A v = t < wp ? z[t] : A(0);
    const A* urow = F + t * mp;
    for (int c = wp - 1; c >= 0; --c) {
        if (t == c) {
            A d = urow[c];
            if (d == A(0)) d = A(1);
            v = fz<FTZ>(v / d);
            z[c] = v;
        }
        __syncthreads();
        if (t < c) v = muladd<FTZ>(-urow[c], z[c], v);
    }
    if (t < wp) {
        const int row = pv[t];
        if (row < n) y[row] = v;
    }
}

// ---------------------------------------------------------------------------
// ordered row reduction
// ---------------------------------------------------------------------------

template <typename A>
__global__ void __launch_bounds__(kReduceThreads)
rows_reduce_kernel(A* __restrict__ y, const A* __restrict__ upd,
                   const int32_t* __restrict__ rows, const int64_t* __restrict__ ptr,
                   const int32_t* __restrict__ src, int nd, int do_flush) {
    const int r = blockIdx.x * (kReduceThreads / 32) + (threadIdx.x >> 5);
    if (r >= nd) return;  // whole warps leave together
    const int lane = threadIdx.x & 31;
    A s = A(0);
    for (int64_t k = ptr[r] + lane; k < ptr[r + 1]; k += 32) {
        s += upd[src[k]];
        if (do_flush) s = flush(s);
    }
    s = group_sum(s, 32);
    if (lane == 0) {
        A v = y[rows[r]] + s;
        y[rows[r]] = do_flush ? flush(v) : v;
    }
}

bool bad_group(int nfronts, int wp, int rp) { return nfronts < 1 || wp < 1 || rp < 0; }

}  // namespace

// C interface. Every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers; A is float for the f32 instances and double for f64.
//
// respa_extend_add_*: `pool` is the flat front pool; the group's fronts are
// pool[g0 + b*mp*mp ...], b < B, mp = wp + rp; `lp` int32[B, rp] (the rows in
// use first, then -1), `poff` int64[B] and `pmp` int32[B] the parent front's
// pool offset and size, `seg_ptr` int32[nseg + 1] the runs of fronts with one
// parent; `tiles` thread blocks share a parent's rows.
//
// respa_front_sweep_{fwd,bwd}_*: `piv` int32[B, wp] and `rsx` int32[B, rp]
// index y (A[n + 1]; an index >= n is padding: read as 0, never written);
// `zbuf` A[B, wp] and `split` are for fronts wider than respa_front_max_tri():
// forward with split the kernel reads the solved z from zbuf and only forms
// upd, backward with split it writes the right-hand side into zbuf and the
// caller solves the triangle; `tiles` blocks share a front's panel product
// (1 unless split). `upd` is A[B, rp].
//
// respa_rows_reduce_*: y[rows[r]] += sum of upd[src[ptr[r] : ptr[r+1]]], r < nd.
extern "C" {

int respa_front_max_tri() { return kMaxTri; }

#define RESPA_EXTEND_ADD(NAME, A, FTZ)                                                        \
    int NAME(int device, void* pool, int64_t g0, int nfronts, int wp, int rp, const void* lp, \
             const void* poff, const void* pmp, const void* seg_ptr, int nseg, int tiles,     \
             void* stream) {                                                                  \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (bad_group(nfronts, wp, rp) || rp < 1 || nseg < 1 || tiles < 1 || tiles > 65535)   \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(tiles));                 \
        extend_add_kernel<A, FTZ><<<grid, kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
            static_cast<A*>(pool), g0, wp, rp, static_cast<const int32_t*>(lp),               \
            static_cast<const int64_t*>(poff), static_cast<const int32_t*>(pmp),              \
            static_cast<const int32_t*>(seg_ptr));                                            \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_EXTEND_ADD(respa_extend_add_f32, float, false)
RESPA_EXTEND_ADD(respa_extend_add_f32_ftz, float, true)
RESPA_EXTEND_ADD(respa_extend_add_f64, double, false)

#define RESPA_FRONT_SWEEP(SUFFIX, A, FTZ)                                                     \
    int respa_front_sweep_fwd_##SUFFIX(int device, const void* pool, int64_t g0, int nfronts, \
                                       int wp, int rp, const void* piv, void* y, int n,       \
                                       const void* zbuf, void* upd, int split, int tiles,     \
                                       void* stream) {                                        \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (bad_group(nfronts, wp, rp) || tiles < 1 || tiles > 65535 ||                       \
            (!split && (wp > kMaxTri || tiles != 1)))                                         \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        dim3 grid(static_cast<unsigned>(nfronts), static_cast<unsigned>(tiles));              \
        front_fwd_kernel<A, FTZ><<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
            static_cast<const A*>(pool), g0, wp, rp, static_cast<const int32_t*>(piv),        \
            static_cast<A*>(y), n, static_cast<const A*>(zbuf), static_cast<A*>(upd), split); \
        return static_cast<int>(cudaGetLastError());                                          \
    }                                                                                         \
    int respa_front_sweep_bwd_##SUFFIX(int device, const void* pool, int64_t g0, int nfronts, \
                                       int wp, int rp, const void* piv, const void* rsx,      \
                                       void* y, int n, void* zbuf, int split, int tiles,      \
                                       void* stream) {                                        \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (bad_group(nfronts, wp, rp) || tiles < 1 || tiles > 65535 ||                       \
            (!split && (wp > kMaxTri || tiles != 1)))                                         \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        dim3 grid(static_cast<unsigned>(nfronts), static_cast<unsigned>(tiles));              \
        front_bwd_kernel<A, FTZ><<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
            static_cast<const A*>(pool), g0, wp, rp, static_cast<const int32_t*>(piv),        \
            static_cast<const int32_t*>(rsx), static_cast<A*>(y), n, static_cast<A*>(zbuf),   \
            split);                                                                           \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_FRONT_SWEEP(f32, float, false)
RESPA_FRONT_SWEEP(f32_ftz, float, true)
RESPA_FRONT_SWEEP(f64, double, false)

#define RESPA_ROWS_REDUCE(NAME, A)                                                            \
    int NAME(int device, void* y, const void* upd, const void* rows, const void* ptr,         \
             const void* src, int nd, int do_flush, void* stream) {                           \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nd < 1) return static_cast<int>(cudaErrorInvalidValue);                           \
        const int per_block = kReduceThreads / 32;                                            \
        const unsigned blocks = static_cast<unsigned>((nd + per_block - 1) / per_block);      \
        rows_reduce_kernel<A><<<blocks, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
            static_cast<A*>(y), static_cast<const A*>(upd), static_cast<const int32_t*>(rows), \
            static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(src), nd, do_flush); \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_ROWS_REDUCE(respa_rows_reduce_f32, float)
RESPA_ROWS_REDUCE(respa_rows_reduce_f64, double)

}  // extern "C"
