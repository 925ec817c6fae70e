// Exact sparse triangular solve in one launch (K7).
//
// Replaces respatpu/kernels/sptrsv.py _sptrsv_single, _sptrsv_df and
// _sptrsv_blocked (a lax.scan over level-aligned chunks of rows) with one
// launch that has no level loop:
//
//     y_i = (b_i - sum_j N_ij y_j) * dinv_i
//
// over the strict triangle N (CSR: lower, columns < i; upper, columns > i)
// and the reciprocal diagonal dinv, made on the host. Warps take rows from an
// atomic ticket in dependency order (ascending rows for lower, descending for
// upper), so every row a row waits on was taken before it by a warp that is
// already running: no cooperative launch is needed and nothing deadlocks.
// A warp's lanes take the row's entries l, l + 32, ... each waiting on the
// ready flag of its column, and sum them in that order; a shuffle tree adds
// the 32 partials (lane 0's order: a halving tree); lane 0 forms the row's
// value and publishes it with a release store of its flag. Flags and ticket
// are zeroed for each launch on its stream (never a tag counted on the host).
// Every product and sum is rounded on its own, so the solve equals
// tri_solve_plain, which goes level by level in the same order, bit for bit.
// (Reference: "On Parallel Solution of Sparse Triangular Linear Systems in
// CUDA", PAPERS.md.)
//
// Instances: f32; f32_ftz (b, every product, partial sum and result flushed to
// zero); bf16 (bf16 values and dinv, b and y fp32, each y_i rounded to bf16
// once); f64.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// a wait of a second or more traps (a launch failure) instead of hanging
constexpr unsigned kSpinLimit = 1u << 24;

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }

template <bool FTZ>
__device__ __forceinline__ float fz(float v) {
    if constexpr (FTZ) return flush(v);
    return v;
}
template <bool FTZ>
__device__ __forceinline__ double fz(double v) { return v; }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename V>
__device__ __forceinline__ float round_to(float v) {
    if constexpr (sizeof(V) == 2) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}
template <typename V>
__device__ __forceinline__ double round_to(double v) { return v; }

__device__ __forceinline__ void publish(int* flag) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(1) : "memory");
}

__device__ __forceinline__ void wait_ready(const int* flag) {
    unsigned spins = 0;
    while (true) {
        int v;
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
        if (v) return;
        if (++spins > kSpinLimit) __trap();
        __nanosleep(32);
    }
}

// flags: int32[n] ready flags then the ticket at flags[n], all zero.
template <typename V, typename A, bool FTZ, bool LOWER>
__global__ void __launch_bounds__(kThreads)
tri_solve_kernel(int n, const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                 const V* __restrict__ vals, const V* __restrict__ dinv,
                 const A* __restrict__ b, A* y, int* flags) {
    const int lane = threadIdx.x & 31;
    while (true) {
        int k = 0;
        if (lane == 0) k = atomicAdd(flags + n, 1);
        k = __shfl_sync(kFull, k, 0);
        if (k >= n) return;
        const int i = LOWER ? k : n - 1 - k;
        A s = A(0);
        for (int64_t e = indptr[i] + lane; e < indptr[i + 1]; e += 32) {
            const int32_t j = indices[e];
            wait_ready(flags + j);
            s = fz<FTZ>(add(s, fz<FTZ>(mul(widen(vals[e]), __ldcg(y + j)))));
        }
        __syncwarp();
#pragma unroll
        for (int off = 16; off; off >>= 1) s = fz<FTZ>(add(s, __shfl_xor_sync(kFull, s, off)));
        if (lane == 0) {
            const A v = fz<FTZ>(sub(fz<FTZ>(b[i]), s));
            __stcg(y + i, round_to<V>(fz<FTZ>(mul(v, widen(dinv[i])))));
            publish(flags + i);
        }
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int lower, int n, const void* indptr, const void* indices,
           const void* vals, const void* dinv, const void* b, void* y, void* flags,
           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int warps = kThreads / 32;
    const int want = (n + warps - 1) / warps;
    const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
    auto args = [&](auto kernel) {
        kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            n, static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
            static_cast<const V*>(vals), static_cast<const V*>(dinv), static_cast<const A*>(b),
            static_cast<A*>(y), static_cast<int*>(flags));
    };
    if (lower)
        args(tri_solve_kernel<V, A, FTZ, true>);
    else
        args(tri_solve_kernel<V, A, FTZ, false>);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers: the strict triangle N as `indptr` int64[n + 1], `indices`
// int32 and `vals` V; `dinv` V[n]; `b` A[n] and `y` A[n] (A = fp32, fp64 for
// f64); `flags` int32[n + 1] zeroed for this launch alone.
extern "C" {

#define RESPA_TRI_SOLVE(SUFFIX, V, A, FTZ)                                                     \
    int respa_tri_solve_lower_##SUFFIX(int device, int n, const void* indptr,                  \
                                       const void* indices, const void* vals,                  \
                                       const void* dinv, const void* b, void* y, void* flags,  \
                                       void* stream) {                                         \
        return launch<V, A, FTZ>(device, 1, n, indptr, indices, vals, dinv, b, y, flags,       \
                                 stream);                                                      \
    }                                                                                          \
    int respa_tri_solve_upper_##SUFFIX(int device, int n, const void* indptr,                  \
                                       const void* indices, const void* vals,                  \
                                       const void* dinv, const void* b, void* y, void* flags,  \
                                       void* stream) {                                         \
        return launch<V, A, FTZ>(device, 0, n, indptr, indices, vals, dinv, b, y, flags,       \
                                 stream);                                                      \
    }

RESPA_TRI_SOLVE(f32, float, float, false)
RESPA_TRI_SOLVE(f32_ftz, float, float, true)
RESPA_TRI_SOLVE(bf16, __nv_bfloat16, float, false)
RESPA_TRI_SOLVE(f64, double, double, false)

}  // extern "C"
