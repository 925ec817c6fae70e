// One Chow-Patel ILU(0) sweep in one launch (K6).
//
// Replaces respatpu/kernels/ilu0.py _ilu0_single (and its double-float twin
// _ilu0_df): one fixed-point sweep over every stored entry p = (i, j) of A,
//
//     s      = a_ij - sum_t old[pairs_a[t]] * old[pairs_b[t]]   (t in list order)
//     new[p] = s / old[u_jj]   if p is below the diagonal (a missing or zero u_jj read as 1)
//     new[p] = s               otherwise,
//
// with every value read from the previous iterate `old` and written to a second
// buffer `new` (Jacobi: the result of a sweep does not depend on the order in
// which entries are taken). Every product and sum is rounded on its own (no
// fused multiply-add) and each entry adds its pairs (ragged: ptr[p] ..
// ptr[p+1] - 1) one after the other in list order, so the sweep equals
// ilu0_sweep_plain bit for bit. With `fix` set a diagonal entry whose new
// value is at most eps in size becomes +-eps (+eps for 0), read from its own
// new value only. With `resid` given, the largest |new - old| is folded into
// it by an atomic max of its bits (one a warp), which gives the same result
// in every order.
//
// What bounds it on this card: bytes (A's values, the iterate and the output
// once each, the pair lists, the kinds and diagonal positions), the iterate's
// gathers served by L2. A thread an entry, its pairs' lists read as they lie
// (a warp's 32 entries' lists are one contiguous run, so its loads of them
// coalesce); for the single-word instances every read-once stream is loaded
// and stored evict-first, which keeps the gathered iterate in L2 (fp64 keeps
// plain loads, which are faster for it). The residual is folded once a warp:
// one atomic an entry on one fp64 word costs a sweep 18 times as much. The
// other designs measured beside this one in the same runs (plain or
// evict-first loads for every instance, the first version, a warp taking its
// entries' pairs 32 or 64 at a time with the products through shared memory)
// are in bench/csrc/ilu0_designs.cu; their times are in PERF.md.
//
// Instances: f32; f32_ftz (every value read, product, partial sum and result
// flushed to zero); bf16 (bf16 values, sums in fp32, each result rounded to
// bf16 once); f64.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// to the value type; on the host too, where the launch rounds eps
template <typename V>
__host__ __device__ __forceinline__ V narrow(float v);
template <>
__host__ __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__host__ __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <typename V>
__host__ __device__ __forceinline__ V narrow(double v) { return v; }

// the largest of a warp's |new - old| (non-negative, so ordered as their
// bits; a NaN's bits are the largest), folded into *r by lane 0
__device__ __forceinline__ void warp_fold_max(float* r, float v, int lane) {
    const unsigned m = __reduce_max_sync(kFull, __float_as_uint(v));
    if (lane == 0) atomicMax(reinterpret_cast<unsigned*>(r), m);
}
__device__ __forceinline__ void warp_fold_max(double* r, double v, int lane) {
    unsigned long long m = static_cast<unsigned long long>(__double_as_longlong(v));
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, m, off);
        m = o > m ? o : m;
    }
    if (lane == 0) atomicMax(reinterpret_cast<unsigned long long*>(r), m);
}

enum Kind : int8_t { kUpper = 0, kLower = 1, kDiag = 2 };

// A stream read once, loaded and stored evict-first under EVICT, which
// leaves L2 to the gathered iterate.
template <bool EVICT, typename T>
__device__ __forceinline__ T once(const T* p) {
    if constexpr (EVICT) return __ldcs(p);
    return *p;
}
template <bool EVICT>
__device__ __forceinline__ __nv_bfloat16 once(const __nv_bfloat16* p) {
    if constexpr (EVICT)
        return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
    return *p;
}
template <bool EVICT, typename T>
__device__ __forceinline__ void put_once(T* p, T v) {
    if constexpr (EVICT)
        __stcs(p, v);
    else
        *p = v;
}
template <bool EVICT>
__device__ __forceinline__ void put_once(__nv_bfloat16* p, __nv_bfloat16 v) {
    if constexpr (EVICT)
        __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
    else
        *p = v;
}

// V: the stored value type; A: the type sums are taken in (fp32 for bf16).
// A thread an entry; a warp takes 32 consecutive entries.
template <typename V, typename A, bool FTZ, bool EVICT>
__global__ void __launch_bounds__(kThreads)
ilu0_sweep_kernel(int64_t nnz, const V* __restrict__ a, const V* __restrict__ old,
                  V* __restrict__ out, const int64_t* __restrict__ ptr,
                  const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                  const int8_t* __restrict__ kind, const int32_t* __restrict__ diag_col,
                  V eps, int fix, A* __restrict__ resid) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t p0 = (blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5)) * 32;
         p0 < nnz; p0 += warps * 32) {
        const int64_t p = p0 + lane;
        const bool live = p < nnz;
        A s = A(0), own = A(0);
        V nv = narrow<V>(A(0));
        if (live) {
            const int64_t t1 = once<EVICT>(ptr + p + 1);
            for (int64_t t = once<EVICT>(ptr + p); t < t1; ++t)
                s = fz<FTZ>(add(s, fz<FTZ>(mul(fz<FTZ>(widen(old[once<EVICT>(pa + t)])),
                                               fz<FTZ>(widen(old[once<EVICT>(pb + t)]))))));
            A v = fz<FTZ>(sub(fz<FTZ>(widen(once<EVICT>(a + p))), s));
            const int8_t k = once<EVICT>(kind + p);
            if (k == kLower) {
                const int32_t dc = once<EVICT>(diag_col + p);
                A d = dc >= 0 ? fz<FTZ>(widen(old[dc])) : A(1);
                if (d == A(0)) d = A(1);
                v = fz<FTZ>(div(v, d));
            }
            nv = narrow<V>(v);
            if (fix && k == kDiag) {
                const A e = widen(eps);
                if (fabs(widen(nv)) <= e) nv = widen(nv) < A(0) ? narrow<V>(-e) : eps;
            }
            put_once<EVICT>(out + p, nv);
            if (resid != nullptr) own = fz<FTZ>(widen(old[p]));
        }
        if (resid != nullptr)
            warp_fold_max(resid, live ? fabs(fz<FTZ>(sub(widen(nv), own))) : A(0), lane);
    }
}

template <typename V, typename A, bool FTZ, bool EVICT>
int launch(int device, int64_t nnz, const void* a, const void* old, void* out, const void* ptr,
           const void* pa, const void* pb, const void* kind, const void* diag_col, double eps,
           int fix, void* resid, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nnz < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (nnz + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65535 * 8 ? want : 65535 * 8);
    ilu0_sweep_kernel<V, A, FTZ, EVICT>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nnz, static_cast<const V*>(a), static_cast<const V*>(old), static_cast<V*>(out),
        static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(pa),
        static_cast<const int32_t*>(pb), static_cast<const int8_t*>(kind),
        static_cast<const int32_t*>(diag_col), narrow<V>(static_cast<A>(eps)), fix,
        static_cast<A*>(resid));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers: `a`, `old`, `out` V[nnz] (float, bf16 or double by the
// instance); `ptr` int64[nnz + 1]; `pa`, `pb` int32[ptr[nnz]]; `kind` int8[nnz]
// (0 above the diagonal, 1 below, 2 on it); `diag_col` int32[nnz] (the
// position of u_jj for an entry below the diagonal, -1 where it is missing);
// `resid` one A (fp32, fp64 for f64) to fold the largest |out - old| into, or
// null. `eps` is rounded to V.
extern "C" {

#define RESPA_ILU0_SWEEP(SUFFIX, V, A, FTZ, EVICT)                                             \
    int respa_ilu0_sweep_##SUFFIX(int device, int64_t nnz, const void* a, const void* old,     \
                                  void* out, const void* ptr, const void* pa, const void* pb,   \
                                  const void* kind, const void* diag_col, double eps, int fix,  \
                                  void* resid, void* stream) {                                  \
        return launch<V, A, FTZ, EVICT>(device, nnz, a, old, out, ptr, pa, pb, kind, diag_col,  \
                                        eps, fix, resid, stream);                               \
    }

RESPA_ILU0_SWEEP(f32, float, float, false, true)
RESPA_ILU0_SWEEP(f32_ftz, float, float, true, true)
RESPA_ILU0_SWEEP(bf16, __nv_bfloat16, float, false, true)
RESPA_ILU0_SWEEP(f64, double, double, false, false)

}  // extern "C"
