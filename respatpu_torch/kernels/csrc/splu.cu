// Exact sparse LU, or exact ILU(0), in one launch (K8).
//
// Replaces respatpu/kernels/splu.py _factor_single and its double-float twin
// _factor_df (a lax.scan over level-aligned chunks of entries, each updated
// `depth` times) with one launch that has no level loop. On a pattern F, every
// stored entry p = (i, j):
//
//     s      = sum_t vals[pairs_a[t]] * vals[pairs_b[t]]     (t in list order)
//     vals[p] = a[p] - s                 on or above the diagonal (U)
//     vals[p] = (a[p] - s) / d           below it (L), d = u_jj clamped:
//                                        |u_jj| <= eps -> -eps if negative,
//                                        else +eps (also for a missing u_jj)
//
// Every pair entry and u_jj lie in earlier *levels* (kernels/splu.py
// entry_levels), so each entry is computed once, from final values, and the
// result is the exact elimination. What bounds it on this card: the bytes (the
// pair positions streamed once, two value gathers a pair served from L2, each
// entry's own words) on wide levels, and the chain of levels, a hand-over
// through L2 a level, on narrow ones.
//
// The design is K7's (csrc/sptrsv.cu). The plan is made once on the host: the
// entries in level order (a position q for every entry, short entries of at
// most kShort pairs before long ones in a level), level offsets, and tasks in
// level order: up to 32 short entries of one level (a lane an entry, its pairs
// summed one after the other in list order from +0) or a run of long entries
// of one level, about LONG_PAIRS pairs in all (kernels/splu.py; a warp over each entry in
// turn: lane l over the pairs l, l + 32, ..., then a halving tree over the
// 32 partials). Warps take tasks from an atomic ticket, one atomicAdd a task, and
// a task of level v waits once, by lane 0, until the completion counter of
// level v - 1 counts every entry of it (an entry of level v - 1 is written
// only after level v - 2 is complete, so every earlier level is complete
// then). Every dependency of a task lies in an earlier level, so in a task
// ticketed before it by a warp that is already running: no cooperative launch
// is needed and nothing deadlocks. A finished task fences and adds its entries
// to its level's counter with one atomic. A lane loads its entry's position,
// a[p], list bounds, diagonal position, kind and first two pairs' positions
// before the wait, and after it issues the loads of u_jj and of the pairs'
// values together, four pairs' positions and values at a time in every chain
// of pairs (the sum's order unchanged); values are read through L2 (relaxed
// loads at gpu scope) and written whole. The counters and the ticket are zeroed for each launch
// on its stream.
//
// Every product, sum and the division are rounded on their own (no fused
// multiply-add, IEEE division), so the factor equals splu_factor_plain, which
// goes level by level in the same order, bit for bit.
//
// Instances: f32; f32_ftz (every value read, product, partial sum and result
// flushed to zero); bf16 (bf16 values, sums in fp32, each result rounded to
// bf16 once); f64.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kShort = 32;  // a short entry: at most this many pairs

template <typename V, typename A, bool FTZ>
__device__ __forceinline__ A product(const V* vals, int32_t i, int32_t j) {
    return fz<FTZ>(mul(fz<FTZ>(widen(load_value(vals + i))), fz<FTZ>(widen(load_value(vals + j)))));
}

// s + the products of pairs e, e + step, e + 2 step, e + 3 step, added in that
// order: the four pairs' positions and then their eight values are loaded
// together, so a chain of pairs waits one round trip for four of them
template <typename V, typename A, bool FTZ>
__device__ __forceinline__ A add_four(A s, const V* vals, const int32_t* __restrict__ pa,
                                      const int32_t* __restrict__ pb, int64_t e, int step) {
    int32_t i[4], j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        i[u] = pa[e + u * step];
        j[u] = pb[e + u * step];
    }
    V x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        x[u] = load_value(vals + i[u]);
        y[u] = load_value(vals + j[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
        s = fz<FTZ>(add(s, fz<FTZ>(mul(fz<FTZ>(widen(x[u])), fz<FTZ>(widen(y[u]))))));
    return s;
}

// v = a - s, divided by u_jj for an L entry (d, read when has_d), clamped:
// |d| <= eps (or no u_jj) -> -eps if d is negative, else +eps; rounded to V
template <typename V, typename A, bool FTZ>
__device__ __forceinline__ V finish(A av, A s, bool lower, bool has_d, A d, A eps) {
    A v = fz<FTZ>(sub(av, s));
    if (lower) {
        if (!has_d || fabs(d) <= eps) d = d < A(0) ? -eps : eps;
        v = fz<FTZ>(div(v, d));
    }
    return narrow<V>(v);
}

// an L entry's divisor as read after the wait (0 where it is missing)
template <typename V, typename A, bool FTZ>
__device__ __forceinline__ A divisor(const V* vals, bool lower, int32_t dc) {
    return lower && dc >= 0 ? fz<FTZ>(widen(load_value(vals + dc))) : A(0);
}

// tasks: int4 {q0, q1, v, w}: positions q0 .. q1 - 1 of level v; w == v: up
// to 32 short entries, a lane an entry; w < 0: a run of long entries, a warp
// over each one's pairs in turn.
template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
splu_factor_kernel(int ntasks, const int4* __restrict__ tasks, const int32_t* __restrict__ level_ptr,
                   const int32_t* __restrict__ perm, const int64_t* __restrict__ ptr,
                   const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                   const int8_t* __restrict__ is_lower, const int32_t* __restrict__ diag_col,
                   const V* __restrict__ a, V* vals, V eps_v, int* ctl, int* ticket) {
    const int lane = threadIdx.x & 31;
    const A eps = widen(eps_v);
    while (true) {
        int k = 0;
        if (lane == 0) k = atomicAdd(ticket, 1);
        k = __shfl_sync(kFull, k, 0);
        if (k >= ntasks) return;
        const int4 t = tasks[k];
        const int q0 = t.x, q1 = t.y, v0 = t.z;
        const int need = v0 > 0 ? level_ptr[v0] - level_ptr[v0 - 1] : 0;
        if (t.w == v0) {
            // up to 32 short entries of one level, a lane an entry; its words
            // and its first two pairs' positions loaded before the wait
            const int q = q0 + lane;
            const bool live = q < q1;
            int32_t p = 0, dc = -1, a0 = 0, b0 = 0, a1 = 0, b1 = 0;
            int64_t e0 = 0, e1 = 0;
            bool lower = false;
            A av = A(0);
            if (live) {
                p = perm[q];
                e0 = ptr[p];
                e1 = ptr[p + 1];
                av = fz<FTZ>(widen(a[p]));
                lower = is_lower[p] != 0;
                dc = diag_col[p];
                if (e1 > e0) {
                    a0 = pa[e0];
                    b0 = pb[e0];
                }
                if (e1 > e0 + 1) {
                    a1 = pa[e0 + 1];
                    b1 = pb[e0 + 1];
                }
            }
            wait_level(ctl, v0, need, lane);
            if (live) {
                const A d = divisor<V, A, FTZ>(vals, lower, dc);  // beside the pairs' loads
                A s = A(0);
                if (e1 > e0) s = fz<FTZ>(add(s, product<V, A, FTZ>(vals, a0, b0)));
                if (e1 > e0 + 1) s = fz<FTZ>(add(s, product<V, A, FTZ>(vals, a1, b1)));
                int64_t e = e0 + 2;
                for (; e + 3 < e1; e += 4) s = add_four<V, A, FTZ>(s, vals, pa, pb, e, 1);
                for (; e < e1; ++e) s = fz<FTZ>(add(s, product<V, A, FTZ>(vals, pa[e], pb[e])));
                store_value(vals + p, finish<V, A, FTZ>(av, s, lower, dc >= 0, d, eps));
            }
            post_level(ctl, v0, q1 - q0, lane);
        } else {
            // a run of long entries of one level: for each, lane l over the
            // pairs l, l + 32, ..., then a halving tree; the run's first
            // entry's words loaded before the wait
            int32_t p = perm[q0];
            int64_t e0 = ptr[p], e1 = ptr[p + 1];
            A av = fz<FTZ>(widen(a[p]));
            bool lower = is_lower[p] != 0;
            int32_t dc = diag_col[p];
            wait_level(ctl, v0, need, lane);
            for (int q = q0; q < q1; ++q) {
                if (q > q0) {
                    p = perm[q];
                    e0 = ptr[p];
                    e1 = ptr[p + 1];
                    av = fz<FTZ>(widen(a[p]));
                    lower = is_lower[p] != 0;
                    dc = diag_col[p];
                }
                const A d = lane == 0 ? divisor<V, A, FTZ>(vals, lower, dc) : A(0);
                A s = A(0);
                int64_t e = e0 + lane;
                for (; e + 96 < e1; e += 128) s = add_four<V, A, FTZ>(s, vals, pa, pb, e, 32);
                for (; e < e1; e += 32) s = fz<FTZ>(add(s, product<V, A, FTZ>(vals, pa[e], pb[e])));
#pragma unroll
                for (int off = 16; off; off >>= 1)
                    s = fz<FTZ>(add(s, __shfl_xor_sync(kFull, s, off)));
                if (lane == 0)
                    store_value(vals + p, finish<V, A, FTZ>(av, s, lower, dc >= 0, d, eps));
            }
            post_level(ctl, v0, q1 - q0, lane);
        }
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int ntasks, int warps, const void* tasks, const void* level_ptr,
           const void* perm, const void* ptr, const void* pa, const void* pb,
           const void* is_lower, const void* diag_col, const void* a, void* vals, double eps,
           void* ctl, int nctl, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ntasks < 1 || warps < 1 || nctl < 1) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int want = (warps + kWarps - 1) / kWarps;
    const unsigned blocks = static_cast<unsigned>(want < kBlocksPerSm * sms ? want
                                                                            : kBlocksPerSm * sms);
    int* words = static_cast<int*>(ctl);
    splu_factor_kernel<V, A, FTZ><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ntasks, static_cast<const int4*>(tasks), static_cast<const int32_t*>(level_ptr),
        static_cast<const int32_t*>(perm), static_cast<const int64_t*>(ptr),
        static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
        static_cast<const int8_t*>(is_lower), static_cast<const int32_t*>(diag_col),
        static_cast<const V*>(a), static_cast<V*>(vals), narrow<V>(static_cast<A>(eps)), words,
        words + nctl - 1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers, all from the plan (kernels/splu.py) but a, vals and ctl:
// `tasks` int32[ntasks][4]; `level_ptr` int32[levels + 1] and `perm` int32[nnz]
// (positions); `ptr` int64[nnz + 1], `pa`, `pb` int32[ptr[nnz]] (entry p's
// pairs); `is_lower` int8[nnz]; `diag_col` int32[nnz] (the position of u_jj, -1
// where it is missing); `a` V[nnz] A's values on the pattern; `vals` V[nnz],
// every entry written once; `ctl` int32[nctl] zeroed for this launch alone,
// levels + 1 words, the last the ticket. `warps` is how many warps take tasks
// (at most kBlocksPerSm blocks an SM). `eps` is rounded to V.
extern "C" {

#define RESPA_SPLU_FACTOR(SUFFIX, V, A, FTZ)                                                     \
    int respa_splu_factor_##SUFFIX(int device, int ntasks, int warps, const void* tasks,         \
                                   const void* level_ptr, const void* perm, const void* ptr,     \
                                   const void* pa, const void* pb, const void* is_lower,        \
                                   const void* diag_col, const void* a, void* vals, double eps, \
                                   void* ctl, int nctl, void* stream) {                         \
        return launch<V, A, FTZ>(device, ntasks, warps, tasks, level_ptr, perm, ptr, pa, pb,    \
                                 is_lower, diag_col, a, vals, eps, ctl, nctl, stream);          \
    }

RESPA_SPLU_FACTOR(f32, float, float, false)
RESPA_SPLU_FACTOR(f32_ftz, float, float, true)
RESPA_SPLU_FACTOR(bf16, __nv_bfloat16, float, false)
RESPA_SPLU_FACTOR(f64, double, double, false)

// the plan's sizes the kernel was built with: 0 short entry, 1 entries a task
int respa_splu_limit(int which) {
    const int limits[] = {kShort, 32};
    return which >= 0 && which < 2 ? limits[which] : -1;
}

}  // extern "C"
