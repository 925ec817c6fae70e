// Helpers shared by the port's CUDA kernels: the rounding and flush rules of
// every instance, whole-word value loads and stores through L2, and the
// level counters of the one-launch schedules (K7 in sptrsv.cu, K8 in
// splu.cu).
//
// Rounding: every product, sum, difference and quotient is rounded on its own
// (__fmul_rn and friends: no fused multiply-add, IEEE division), so a kernel
// equals its plain PyTorch version bit for bit. Flush: nvcc compiles with
// -ftz=false, so the fp32_ftz instances flush explicitly, with fz<true>.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEager = 64;  // polls before a wait starts to sleep
// A wait of more polls than this traps (a launch failure) instead of
// hanging. Each poll is an L2 round trip (about 0.6 us on the H100, the link
// probe's hand-over) and, after the first kEager, a sleep as well, so the
// trap comes after ten seconds or more of waiting.
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
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

// a stored value in the accumulator type
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// to the value type; on the host too, where a launch rounds eps
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

// A value that another warp of the same launch writes, read and written
// whole (single-copy atomic) through L2.
__device__ __forceinline__ float load_value(const float* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
    return __uint_as_float(v);
}
__device__ __forceinline__ double load_value(const double* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
    return __longlong_as_double(static_cast<long long>(v));
}
__device__ __forceinline__ __nv_bfloat16 load_value(const __nv_bfloat16* p) {
    unsigned short v;
    asm volatile("ld.relaxed.gpu.global.b16 %0, [%1];" : "=h"(v) : "l"(p));
    return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ void store_value(float* p, float v) {
    asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(__float_as_uint(v)));
}
__device__ __forceinline__ void store_value(double* p, double v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p),
                 "l"(static_cast<unsigned long long>(__double_as_longlong(v))));
}
__device__ __forceinline__ void store_value(__nv_bfloat16* p, __nv_bfloat16 v) {
    asm volatile("st.relaxed.gpu.global.b16 [%0], %1;" ::"l"(p), "h"(__bfloat16_as_ushort(v)));
}

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// one more poll of a wait: traps past kSpinLimit, sleeps after kEager
__device__ __forceinline__ void backoff(unsigned& spins) {
    if (++spins > kSpinLimit) __trap();
    if (spins > kEager) __nanosleep(32);
}

// Level counters (ctl[v]: the entries or rows of level v written so far,
// zeroed for each launch). Lane 0 waits until level v - 1 counts `need`; the
// warp follows.
__device__ __forceinline__ void wait_level(const int* ctl, int v, int need, int lane) {
    if (lane == 0 && v > 0) {
        unsigned spins = 0;
        while (load_acquire(ctl + v - 1) < need) backoff(spins);
    }
    __syncwarp();
}

// the warp's `done` entries or rows of level v are written; lane 0 adds them
// to the level's count
__device__ __forceinline__ void post_level(int* ctl, int v, int done, int lane) {
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicAdd(ctl + v, done);
}

}  // namespace
