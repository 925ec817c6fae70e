// Other designs of one Chow-Patel ILU(0) sweep (K6), built beside the
// package's kernel only to be timed against it on the card
// (`python3 chip_smoke.py --ilu-times`). The package never loads this
// library.
//
// Every design takes the same inputs as kernels/csrc/ilu0.cu and returns the
// same values bit for bit (each entry adds its pairs in list order from +0,
// every product and sum rounded on its own):
//   0, 1  the package's body (a thread an entry, a warp on 32 consecutive
//         entries, the residual folded once a warp) with its read-once
//         streams evict-first (0) or plain (1);
//   2     the first version: a thread an entry over a grid-stride loop, the
//         residual folded by one atomic an entry;
//   3, 4  warp-cooperative gathers: a warp's 32 entries own one contiguous
//         run of the pair lists, which the warp walks 32 (3) or 64 (4) pairs
//         at a time, a lane a pair, both gathers of a pair issued together,
//         the products through shared memory, each lane then adding its own
//         entry's products in list order; an entry's loads that do not
//         depend on its pairs are issued before the pair loop.
#include "../../kernels/csrc/ilu0.cu"

namespace {

template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
first_sweep_kernel(int64_t nnz, const V* __restrict__ a, const V* __restrict__ old,
                   V* __restrict__ out, const int64_t* __restrict__ ptr,
                   const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                   const int8_t* __restrict__ kind, const int32_t* __restrict__ diag_col,
                   V eps, int fix, A* __restrict__ resid) {
    for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; p < nnz;
         p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        A s = A(0);
        for (int64_t t = ptr[p]; t < ptr[p + 1]; ++t)
            s = fz<FTZ>(add(s, fz<FTZ>(mul(fz<FTZ>(widen(old[pa[t]])),
                                           fz<FTZ>(widen(old[pb[t]]))))));
        A v = fz<FTZ>(sub(fz<FTZ>(widen(a[p])), s));
        const int8_t k = kind[p];
        if (k == kLower) {
            const int32_t dc = diag_col[p];
            A d = dc >= 0 ? fz<FTZ>(widen(old[dc])) : A(1);
            if (d == A(0)) d = A(1);
            v = fz<FTZ>(div(v, d));
        }
        V nv = narrow<V>(v);
        if (fix && k == kDiag) {
            const A e = widen(eps);
            if (fabs(widen(nv)) <= e) nv = widen(nv) < A(0) ? narrow<V>(-e) : eps;
        }
        out[p] = nv;
        if (resid != nullptr) {
            const A r = fabs(fz<FTZ>(sub(widen(nv), fz<FTZ>(widen(old[p])))));
            if constexpr (sizeof(A) == 4)
                atomicMax(reinterpret_cast<unsigned*>(resid), __float_as_uint(r));
            else
                atomicMax(reinterpret_cast<unsigned long long*>(resid),
                          static_cast<unsigned long long>(__double_as_longlong(r)));
        }
    }
}

template <typename V, typename A, bool FTZ, int CHUNK>
__global__ void __launch_bounds__(kThreads)
coop_sweep_kernel(int64_t nnz, const V* __restrict__ a, const V* __restrict__ old,
                  V* __restrict__ out, const int64_t* __restrict__ ptr,
                  const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                  const int8_t* __restrict__ kind, const int32_t* __restrict__ diag_col,
                  V eps, int fix, A* __restrict__ resid) {
    __shared__ A prods[kWarps][CHUNK];
    A* prod = prods[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t p0 = (blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5)) * 32;
         p0 < nnz; p0 += warps * 32) {
        const int64_t p = p0 + lane;
        const bool live = p < nnz;
        const int64_t pe = live ? p : nnz - 1;
        // loads that do not depend on the pairs, issued first
        const int64_t t0 = ptr[pe], t1 = live ? ptr[pe + 1] : t0;
        const A av = fz<FTZ>(widen(a[pe]));
        const int8_t k = kind[pe];
        const int32_t dc = k == kLower ? diag_col[pe] : -1;
        const A dv = dc >= 0 ? fz<FTZ>(widen(old[dc])) : A(1);
        const A own = resid != nullptr ? fz<FTZ>(widen(old[pe])) : A(0);
        const int64_t w0 = ptr[p0];
        const int64_t w1 = ptr[p0 + 32 < nnz ? p0 + 32 : nnz];
        A s = A(0);
        for (int64_t c = w0; c < w1; c += CHUNK) {
#pragma unroll
            for (int j = lane; j < CHUNK; j += 32) {
                const int64_t t = c + j;
                if (t < w1) {
                    const int32_t ia = pa[t], ib = pb[t];
                    const A x = fz<FTZ>(widen(old[ia])), y = fz<FTZ>(widen(old[ib]));
                    prod[j] = fz<FTZ>(mul(x, y));
                }
            }
            __syncwarp();
            const int64_t lo = t0 > c ? t0 : c, hi = t1 < c + CHUNK ? t1 : c + CHUNK;
            for (int64_t t = lo; t < hi; ++t) s = fz<FTZ>(add(s, prod[t - c]));
            __syncwarp();
        }
        A nvw = A(0);
        if (live) {
            A v = fz<FTZ>(sub(av, s));
            if (k == kLower) v = fz<FTZ>(div(v, dv == A(0) ? A(1) : dv));
            V nv = narrow<V>(v);
            if (fix && k == kDiag) {
                const A e = widen(eps);
                if (fabs(widen(nv)) <= e) nv = widen(nv) < A(0) ? narrow<V>(-e) : eps;
            }
            out[p] = nv;
            nvw = widen(nv);
        }
        if (resid != nullptr)
            warp_fold_max(resid, live ? fabs(fz<FTZ>(sub(nvw, own))) : A(0), lane);
    }
}

template <typename V, typename A, bool FTZ>
int launch_design(int design, int64_t nnz, const void* a, const void* old, void* out,
                  const void* ptr, const void* pa, const void* pb, const void* kind,
                  const void* diag_col, double eps, int fix, void* resid, cudaStream_t stream) {
    if (nnz < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (nnz + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65535 * 8 ? want : 65535 * 8);
    auto go = [&](auto kernel) {
        kernel<<<blocks, kThreads, 0, stream>>>(
            nnz, static_cast<const V*>(a), static_cast<const V*>(old), static_cast<V*>(out),
            static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(pa),
            static_cast<const int32_t*>(pb), static_cast<const int8_t*>(kind),
            static_cast<const int32_t*>(diag_col), narrow<V>(static_cast<A>(eps)), fix,
            static_cast<A*>(resid));
    };
    switch (design) {
        case 0: go(ilu0_sweep_kernel<V, A, FTZ, true>); break;
        case 1: go(ilu0_sweep_kernel<V, A, FTZ, false>); break;
        case 2: go(first_sweep_kernel<V, A, FTZ>); break;
        case 3: go(coop_sweep_kernel<V, A, FTZ, 32>); break;
        case 4: go(coop_sweep_kernel<V, A, FTZ, 64>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: as respa_ilu0_sweep_<inst> (kernels/csrc/ilu0.cu), with the
// design (0-4, above) and the instance (0 f32, 1 f32_ftz, 2 bf16, 3 f64)
// first.
extern "C" int respa_ilu0_design_sweep(int design, int inst, int device, int64_t nnz,
                                       const void* a, const void* old, void* out,
                                       const void* ptr, const void* pa, const void* pb,
                                       const void* kind, const void* diag_col, double eps,
                                       int fix, void* resid, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (inst) {
        case 0:
            return launch_design<float, float, false>(design, nnz, a, old, out, ptr, pa, pb,
                                                      kind, diag_col, eps, fix, resid, s);
        case 1:
            return launch_design<float, float, true>(design, nnz, a, old, out, ptr, pa, pb,
                                                     kind, diag_col, eps, fix, resid, s);
        case 2:
            return launch_design<__nv_bfloat16, float, false>(design, nnz, a, old, out, ptr, pa,
                                                              pb, kind, diag_col, eps, fix,
                                                              resid, s);
        case 3:
            return launch_design<double, double, false>(design, nnz, a, old, out, ptr, pa, pb,
                                                        kind, diag_col, eps, fix, resid, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
