// CSR SpMV, y = A x, one warp per row, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of respatpu together with their wrappers:
//   respatpu/kernels/gsell.py    _gsell_kernel    (_spmv_gsell_core): fp32 and bf16 values
//   respatpu/kernels/gsell_df.py _gsell_df_kernel (_spmv_gsell_df_core): df64
// The GSELL packing, windows, spill, hub split and virtual rows existed only
// because the TPU has no hardware gather; this card has one, so the kernel
// reads CSR as it is. df64 becomes native fp64.
//
// What bounds it: bytes. One pass moves, at least,
//   (n+1)*8 (int64 row pointer) + nnz*4 (int32 columns) + nnz*sizeof(V)
//   + n*sizeof(X) (x, if each entry is read once) + n*sizeof(Y)
// and does 2*nnz flops, far below the card's flop/byte balance.
//
// Design: lane l of the row's warp walks entries start+l, start+l+32, ...,
// so a warp's loads of columns and values are coalesced, and accumulates in
// a register. A fixed __shfl_xor_sync butterfly then sums the 32 lanes and
// lane 0 writes y[row]. The order of every sum is fixed and no atomics are
// used, so the result is bitwise the same from run to run (the determinism
// gsell_df.py:27-29 documents). Empty rows write 0.
//
// Limits of this first version: a row shorter than 32 leaves lanes idle, and
// a wide hub row is left to one warp. Row splitting or merge-path balancing
// is later work.
//
// FTZ instance: nvcc compiles with -ftz=false, so the flush is explicit:
// x on load, each product and each partial sum. Products and sums are
// rounded separately (__fmul_rn/__fadd_rn) so that no fused multiply-add
// skips the flush of the product. Values were flushed at upload.

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
spmv_csr_warp(int64_t n_rows, const int64_t* __restrict__ indptr,
              const int32_t* __restrict__ indices, const V* __restrict__ vals,
              const A* __restrict__ x, A* __restrict__ y) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n_rows) return;  // uniform across the warp: the shuffles below see all 32 lanes
    const int64_t start = indptr[row];
    const int64_t end = indptr[row + 1];
    A sum = 0;
    for (int64_t k = start + lane; k < end; k += 32) {
        const A v = to_acc(vals[k]);
        if constexpr (FTZ) {
            const float p = flush(__fmul_rn(v, flush(x[indices[k]])));
            sum = flush(__fadd_rn(sum, p));
        } else {
            sum += v * x[indices[k]];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const A other = __shfl_xor_sync(0xffffffffu, sum, off);
        if constexpr (FTZ) {
            sum = flush(__fadd_rn(sum, other));
        } else {
            sum += other;
        }
    }
    if (lane == 0) y[row] = sum;
}

template <typename V, typename A, bool FTZ>
int launch(int device, int64_t n_rows, const void* indptr, const void* indices,
           const void* vals, const void* x, void* y, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (n_rows <= 0 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    spmv_csr_warp<V, A, FTZ><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        n_rows, static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
        static_cast<const V*>(vals), static_cast<const A*>(x), static_cast<A*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device pointer;
// `stream` is a cudaStream_t. Returns the cudaError_t of the launch (0 = ok).
// The kernel allocates nothing and does not synchronise.
extern "C" {

int respa_spmv_csr_f32(int device, int64_t n_rows, const void* indptr, const void* indices,
                       const void* vals, const void* x, void* y, void* stream) {
    return launch<float, float, false>(device, n_rows, indptr, indices, vals, x, y, stream);
}

int respa_spmv_csr_f32_ftz(int device, int64_t n_rows, const void* indptr, const void* indices,
                           const void* vals, const void* x, void* y, void* stream) {
    return launch<float, float, true>(device, n_rows, indptr, indices, vals, x, y, stream);
}

int respa_spmv_csr_bf16(int device, int64_t n_rows, const void* indptr, const void* indices,
                        const void* vals, const void* x, void* y, void* stream) {
    return launch<__nv_bfloat16, float, false>(device, n_rows, indptr, indices, vals, x, y, stream);
}

int respa_spmv_csr_f64(int device, int64_t n_rows, const void* indptr, const void* indices,
                       const void* vals, const void* x, void* y, void* stream) {
    return launch<double, double, false>(device, n_rows, indptr, indices, vals, x, y, stream);
}

}  // extern "C"
