// Measurements that chip_smoke.py makes beside the package's kernels, built
// with them into a library of their own, which the package never loads:
//   respa_dia_design_addend_f32  the other design of the DIA SpMV's remainder
//                                (K9), timed against the package's (phase 12);
//   respa_l2_read_probe          the card's L2 read rate, which K8's value
//                                gathers are set against (phase 10);
//   respa_barrier_probe          one block's barrier with a shared-memory
//                                hand-over, the first K1's step a pivot
//                                (phase 6);
//   respa_block_lu_before_*      K1 as it was before its panel design (a
//                                16 x 16 thread grid, the block in registers,
//                                one barrier a pivot), timed beside the
//                                package's K1 in the same run (phase 6).
//
// K9: the package's kernel sums each remainder row inside K9. Here the remainder's
// product comes from the CSR kernel K0 (a DeviceCsr over all n rows) and this
// kernel adds it last, as an addend of n values: the diagonals in ascending
// offset order from +0, then y_i + addend_i for every row. Where K0 sums each
// remainder row one entry after the other (a row of at most 32 entries among
// short rows), the two designs agree bit for bit on rows with remainder
// entries; on a row without any, this one adds K0's +0.
#include "../../kernels/csrc/dia.cu"

namespace {

template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
dia_addend_kernel(int64_t n, int64_t ncols, int ndiag, const int64_t* __restrict__ offsets,
                  const V* __restrict__ diags, const A* __restrict__ x,
                  const A* __restrict__ addend, A* __restrict__ y) {
    __shared__ int64_t off[kMaxDiags];
    for (int k = threadIdx.x; k < ndiag; k += kThreads) off[k] = offsets[k];
    __syncthreads();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; i < n;
         i += stride) {
        A s = A(0);
        for (int k = 0; k < ndiag; ++k)
            s = fz<FTZ>(add(s, fz<FTZ>(mul(widen(once(diags + k * n + i)),
                                           x_at<A, FTZ>(x, i + off[k], ncols)))));
        s = fz<FTZ>(add(s, addend[i]));
        __stcs(y + i, s);
    }
}

}  // namespace

// device, n, ncols, ndiag, offsets, diags, x, addend (fp32[n]), y, stream; fp32
extern "C" int respa_dia_design_addend_f32(int device, int64_t n, int64_t ncols, int ndiag,
                                           const void* offsets, const void* diags,
                                           const void* x, const void* addend, void* y,
                                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1 || ndiag < 0 || ndiag > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65535 * 16 ? want : 65535 * 16);
    dia_addend_kernel<float, float, false><<<blocks, kThreads, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
        n, ncols, ndiag, static_cast<const int64_t*>(offsets), static_cast<const float*>(diags),
        static_cast<const float*>(x), static_cast<const float*>(addend), static_cast<float*>(y));
    return static_cast<int>(cudaGetLastError());
}

namespace {

// Every thread reads its 16-byte words of buf, `rounds` times over, through
// L2 alone (ld.global.cg skips L1); buf is small enough to stay in L2, so the
// reads after the first round are L2 hits. The sum keeps the loads.
__global__ void __launch_bounds__(256)
l2_read_probe_kernel(const float4* __restrict__ buf, int64_t words, int rounds,
                     float* __restrict__ out) {
    float acc = 0.0f;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int r = 0; r < rounds; ++r) {
#pragma unroll 4
        for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < words;
             i += stride) {
            const float4 v = __ldcg(buf + i);
            acc += (v.x + v.y) + (v.z + v.w);
        }
    }
    if (acc == -1.0f) out[0] = acc;  // never, for a buffer of ones
}

}  // namespace

// device, buf (16-byte words), words, rounds, out (fp32[1]), stream: one launch
// of 8 blocks of 256 threads an SM reading buf `rounds` times.
extern "C" int respa_l2_read_probe(int device, const void* buf, int64_t words, int rounds,
                                   void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (words < 1 || rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
    l2_read_probe_kernel<<<8 * sms, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(buf), words, rounds, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

namespace {

// One block of 256 threads (K1's 16 x 16) passes a value on `rounds` times:
// a thread writes a double-buffered shared word, the block meets at a barrier,
// every thread reads the word. That is the least a pivot of K1 costs: its
// pivot row and column go through shared memory past one barrier.
__global__ void __launch_bounds__(256) barrier_probe_kernel(int rounds, float* __restrict__ out) {
    __shared__ float cell[2];
    float v = static_cast<float>(threadIdx.x);
    for (int r = 0; r < rounds; ++r) {
        if (threadIdx.x == static_cast<unsigned>(r & 255)) cell[r & 1] = v;
        __syncthreads();
        v += cell[r & 1];
    }
    if (v == -1.0f) out[0] = v;  // never: keeps the loop
}

}  // namespace

// device, rounds, out (fp32[1]), stream: one launch of one block of 256 threads.
extern "C" int respa_barrier_probe(int device, int rounds, void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
    barrier_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        rounds, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

// K1 before its panel design, kept only to be timed beside it: the block in
// the registers of a 16 x 16 thread grid, thread (ty, tx) owning the
// elements (ty + 16 i, tx + 16 k); per pivot the owners of row j and column j
// put them into shared memory (double-buffered, one barrier a pivot) and
// every thread updates its registers. The same function and bits as K1.
namespace first_k1 {

constexpr int kP = 128;
constexpr int kDim = 16;
constexpr int kTile = kP / kDim;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
template <bool FTZ>
__device__ __forceinline__ float mul(float a, float b) { return fz<FTZ>(__fmul_rn(a, b)); }
template <bool FTZ>
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
template <bool FTZ>
__device__ __forceinline__ float sub(float a, float b) { return fz<FTZ>(__fsub_rn(a, b)); }
template <bool FTZ>
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
template <bool FTZ>
__device__ __forceinline__ float quot(float a, float b) { return fz<FTZ>(__fdiv_rn(a, b)); }
template <bool FTZ>
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
template <typename A>
__device__ __forceinline__ A absval(A v) { return v < A(0) ? -v : v; }

template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kDim * kDim)
block_lu_kernel(int p, const V* __restrict__ in, int64_t ld, int64_t batch_stride, A eps,
                A* __restrict__ out, int32_t* __restrict__ n_perturbed) {
    // pivot row and pivot column of the current pivot, double-buffered so
    // that one barrier a pivot is enough
    __shared__ A rowbuf[2][kP];
    __shared__ A colbuf[2][kP];
    const int tid = threadIdx.x;
    const int tx = tid % kDim;
    const int ty = tid / kDim;
    const V* src = in + static_cast<int64_t>(blockIdx.x) * batch_stride;

    // thread (ty, tx) keeps the elements (ty + 16 i, tx + 16 k) in registers
    A t[kTile][kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
            const int row = ty + kDim * i, col = tx + kDim * k;
            A v = (row < p && col < p) ? to_acc(src[row * ld + col]) : A(0);
            if constexpr (FTZ) v = ::flush(v);
            t[i][k] = v;
        }
    }
    int count = 0;  // kept by the thread that owns the diagonal element

#pragma unroll
    for (int jt = 0; jt < kTile; ++jt) {
        // pivots j = 16 jt + jm: jt is a compile-time constant here, so the
        // register tile is indexed statically
#pragma unroll 1
        for (int jm = 0; jm < kDim; ++jm) {
            const int j = kDim * jt + jm;
            if (j >= p) break;
            const int par = j & 1;
            if (ty == jm) {
#pragma unroll
                for (int k = jt; k < kTile; ++k) rowbuf[par][tx + kDim * k] = t[jt][k];
            }
            if (tx == jm) {
#pragma unroll
                for (int i = jt; i < kTile; ++i) colbuf[par][ty + kDim * i] = t[i][jt];
            }
            __syncthreads();
            A piv = rowbuf[par][j];
            const bool bad = absval(piv) <= eps;
            if (bad) piv = piv < A(0) ? -eps : eps;
            // the 16 threads that share ty need the same 8 quotients: each of
            // the first 8 takes one division, and shuffles hand them round
            const int lane = tid & 31;
            const int mine_row = ty + kDim * (tx & (kTile - 1));
            const A mine_l = quot<FTZ>(colbuf[par][mine_row], piv);
            A l[kTile], u[kTile];
#pragma unroll
            for (int i = jt; i < kTile; ++i) {
                const bool below = i > jt || ty > jm;  // row ty + 16 i > j
                const A li = __shfl_sync(0xffffffffu, mine_l, (lane & kDim) | i);
                l[i] = below ? li : A(0);
            }
#pragma unroll
            for (int k = jt; k < kTile; ++k) {
                const bool right = k > jt || tx > jm;  // column tx + 16 k > j
                u[k] = right ? rowbuf[par][tx + kDim * k] : A(0);
            }
#pragma unroll
            for (int i = jt; i < kTile; ++i) {
                const bool below = i > jt || ty > jm;
#pragma unroll
                for (int k = jt; k < kTile; ++k) {
                    const bool right = k > jt || tx > jm;
                    if (below && right) t[i][k] = sub<FTZ>(t[i][k], mul<FTZ>(l[i], u[k]));
                }
                if (below && tx == jm) t[i][jt] = l[i];
            }
            if (ty == jm && tx == jm) {
                t[jt][jt] = piv;
                count += bad ? 1 : 0;
            }
        }
    }

    A* dst = out + static_cast<int64_t>(blockIdx.x) * p * p;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
            const int row = ty + kDim * i, col = tx + kDim * k;
            if (row < p && col < p) dst[row * p + col] = t[i][k];
        }
    }
    // every diagonal element's owner has tx == ty: sum their counts
    __shared__ int counts[kDim];
    if (tx == ty) counts[tx] = count;
    __syncthreads();
    if (tid == 0) {
        int total = 0;
        for (int k = 0; k < kDim; ++k) total += counts[k];
        n_perturbed[blockIdx.x] = total;
    }
}

template <typename V, typename A, bool FTZ>
cudaError_t launch_block_lu(int nblocks, int p, const void* in, int64_t ld, int64_t batch_stride,
                            double eps, void* out, void* n_perturbed, cudaStream_t stream) {
    block_lu_kernel<V, A, FTZ><<<static_cast<unsigned>(nblocks), kDim * kDim, 0, stream>>>(
        p, static_cast<const V*>(in), ld, batch_stride, static_cast<A>(eps),
        static_cast<A*>(out), static_cast<int32_t*>(n_perturbed));
    return cudaGetLastError();
}


}  // namespace first_k1

// device, nblocks, p, in, in_is_bf16, ld, batch_stride, eps, lu, n_perturbed,
// stream: as respa_block_lu_* (kernels/csrc/band_lu.cu)
#define RESPA_BLOCK_LU_BEFORE(NAME, A, FTZ)                                                   \
    extern "C" int NAME(int device, int nblocks, int p, const void* in, int in_is_bf16,      \
                        int64_t ld, int64_t batch_stride, double eps, void* lu,               \
                        void* n_perturbed, void* stream) {                                    \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nblocks < 1 || p < 1 || p > first_k1::kP || ld < p)                               \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        cudaStream_t s = static_cast<cudaStream_t>(stream);                                   \
        if (in_is_bf16) {                                                                     \
            if (sizeof(A) != sizeof(float)) return static_cast<int>(cudaErrorInvalidValue);   \
            return static_cast<int>(first_k1::launch_block_lu<__nv_bfloat16, float, FTZ>(     \
                nblocks, p, in, ld, batch_stride, eps, lu, n_perturbed, s));                  \
        }                                                                                     \
        return static_cast<int>(first_k1::launch_block_lu<A, A, FTZ>(                         \
            nblocks, p, in, ld, batch_stride, eps, lu, n_perturbed, s));                      \
    }

RESPA_BLOCK_LU_BEFORE(respa_block_lu_before_f32, float, false)
RESPA_BLOCK_LU_BEFORE(respa_block_lu_before_f32_ftz, float, true)
RESPA_BLOCK_LU_BEFORE(respa_block_lu_before_f64, double, false)
