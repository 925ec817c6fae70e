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
// level order (kernels/splu.py): up to kTaskEntries short entries of one level
// (a lane an entry, its pairs summed one after the other in list order from
// +0), or a run of long entries of one level (a warp over each entry in turn:
// lane l over the pairs l, l + 32, ..., then a halving tree over the 32
// partials), either holding at most the plan's pair budget (at most kBudget),
// or one long entry past it alone. Warps take tasks from an atomic ticket, one
// atomicAdd a task, and a task of level v waits once, by lane 0, until the
// completion counter of level v - 1 counts every entry of it (an entry of
// level v - 1 is written only after level v - 2 is complete, so every earlier
// level is complete then). Every dependency of a task lies in an earlier
// level, so in a task ticketed before it by a warp that is already running:
// no cooperative launch is needed and nothing deadlocks.
//
// A level costs its slowest task, and a task's time after its wait is the
// chain of memory trips that it makes. The pair positions never change, so a
// warp reads them before the wait, each entry's list found from its position
// (the plan's first pair and count by position: no trip through perm first),
// and the entry's own words after them: its lanes stage the task's pairs (each
// entry's in turn, a flat run of slots) in shared memory, coalesced, every
// load of a batch issued before the first store, beside every entry's own
// words (a lane an entry). After the wait the lanes ask for the values of
// all of the task's pairs, and the divisors, at once (one round trip through
// L2, two in fp64), and put each pair's product in its slot; then each
// entry's products are summed from shared memory in the order above. A long
// entry past kBudget pairs (on the Laplacian's fill most levels hold one:
// the median level's longest entry has 735, the longest 1,420) keeps its pairs in registers
// instead: lane l its pairs l + 32 k, kValueBatch at a time, the next
// group's positions asked for with this group's values, so each group costs
// one trip; the first group's positions (in registers) and the kBudget
// pairs' after them (in the stage) are read before the wait. A
// finished task adds its entries to its level's counter as K7 does
// (post_level: a fence, the warp's barrier, lane 0's atomicAdd; a release
// reduction in its place measured the same). Each level's counter and the
// ticket lie on 128-byte lines of their own: the waiters' polls of one level
// and the posts to the next then meet at no line. Values are read through L2
// (relaxed loads at gpu scope) and written whole. The counters and the
// ticket are zeroed for each launch on its stream.
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
constexpr int kShort = 32;        // a short entry: at most this many pairs
constexpr int kTaskEntries = 32;  // entries a task, a lane each
constexpr int kBudget = 512;      // pairs a task stages (an entry past it: after its first group)
constexpr int kStageBatch = 8;    // pairs a lane asks the positions of at once
// pairs a lane asks the values of at once: a task of kBudget pairs in one
// round in fp32 and bf16, two in fp64 (its values take two registers each)
template <typename V>
constexpr int kValueBatch = sizeof(V) > 4 ? kBudget / 64 : kBudget / 32;
static_assert(kBudget % 64 == 0, "a task's slots are whole rounds of the warp");
constexpr int kLine = 32;  // ints: each level's counter, and the ticket, on a line of its own

// A warp's stage in shared memory: slot t holds a pair's two positions, then
// its product in their place; the task's entries' first pairs and first slots.
struct Stage {
    int2 slot[kBudget];
    int64_t e0[kTaskEntries];
    int off[kTaskEntries + 1];  // off[n]: the slots in use
};

template <typename A>
__device__ __forceinline__ A& prod_at(int2* slot, int t) {
    return *reinterpret_cast<A*>(slot + t);
}

// slots [0, off[n]) from the entries' pair lists: slot t of entry k (off[k] <=
// t < off[k + 1]) holds pair e0[k] + t - off[k]; lane l stages the slots l,
// l + 32, ..., kStageBatch at a time, every load of a batch issued before the
// first store
__device__ __forceinline__ void stage_positions(Stage& st, int n, const int32_t* __restrict__ pa,
                                                const int32_t* __restrict__ pb, int lane) {
    const int total = st.off[n];
    int k = 0;
    for (int t0 = lane; t0 < total; t0 += 32 * kStageBatch) {
        int64_t e[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
            const int t = t0 + 32 * u;
            if (t < total) {
                while (t >= st.off[k + 1]) ++k;
                e[u] = st.e0[k] + (t - st.off[k]);
            }
        }
        int2 ij[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
            if (t0 + 32 * u < total) ij[u] = make_int2(pa[e[u]], pb[e[u]]);
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
            if (t0 + 32 * u < total) st.slot[t0 + 32 * u] = ij[u];
        }
    }
}

// every staged pair's product in its slot: lane l takes the slots l + 32 u,
// kValueBatch<V> at a time, their values asked for together (a slot is staged and
// overwritten by the same lane)
template <typename V, typename A, bool FTZ>
__device__ __forceinline__ void products(int2* slot, int total, const V* vals, int lane) {
    constexpr int kBatch = kValueBatch<V>;
    for (int t0 = lane; t0 < total; t0 += 32 * kBatch) {
        int2 ij[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            ij[u] = t0 + 32 * u < total ? slot[t0 + 32 * u] : make_int2(0, 0);
        V x[kBatch], y[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (t0 + 32 * u < total) {
                x[u] = load_value(vals + ij[u].x);
                y[u] = load_value(vals + ij[u].y);
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (t0 + 32 * u < total)
                prod_at<A>(slot, t0 + 32 * u) =
                    fz<FTZ>(mul(fz<FTZ>(widen(x[u])), fz<FTZ>(widen(y[u]))));
        }
    }
}

// s + the products of slots o + j, j = from, from + step, ... < len, in order
template <typename A, bool FTZ>
__device__ __forceinline__ A sum_slots(A s, int2* slot, int o, int from, int len, int step) {
    for (int j = from; j < len; j += step) s = fz<FTZ>(add(s, prod_at<A>(slot, o + j)));
    return s;
}

// lane 0's sum of the warp's 32 partials by a halving tree (every lane ends
// with the same bits: each step adds the same two partials)
template <typename A, bool FTZ>
__device__ __forceinline__ A tree(A s) {
#pragma unroll
    for (int off = 16; off; off >>= 1) s = fz<FTZ>(add(s, __shfl_xor_sync(kFull, s, off)));
    return s;
}

// lane l's pairs l + 32 u (u < kValueBatch<V>) from pair i0 on of an entry's
// list of len pairs: their positions
template <typename V>
__device__ __forceinline__ void load_group(int2 (&pos)[kValueBatch<V>],
                                           const int32_t* __restrict__ pa,
                                           const int32_t* __restrict__ pb, int64_t e0, int len,
                                           int i0, int lane) {
#pragma unroll
    for (int u = 0; u < kValueBatch<V>; ++u) {
        const int i = i0 + lane + 32 * u;
        if (i < len) pos[u] = make_int2(pa[e0 + i], pb[e0 + i]);
    }
}

// lane l's partial of a long entry past kBudget pairs: its pairs l, l + 32,
// ... in order, kValueBatch<V> at a time, their positions in registers; the
// positions of the next group are asked for right after the values of this
// one (from the stage, which holds the kBudget pairs after the first group,
// then from the lists), so a group costs one trip through L2. `pos` holds the
// first group's positions and `slot` the stage's, both read before the wait.
template <typename V, typename A, bool FTZ>
__device__ __forceinline__ A stream_sum(int2 (&pos)[kValueBatch<V>], const int2* slot,
                                        const int32_t* __restrict__ pa,
                                        const int32_t* __restrict__ pb, int64_t e0, int len,
                                        const V* vals, int lane) {
    constexpr int kG = kValueBatch<V>, kSpan = 32 * kG;
    A s = A(0);
    for (int i0 = 0; i0 < len; i0 += kSpan) {
        V x[kG], y[kG];
#pragma unroll
        for (int u = 0; u < kG; ++u) {
            if (i0 + lane + 32 * u < len) {
                x[u] = load_value(vals + pos[u].x);
                y[u] = load_value(vals + pos[u].y);
            }
        }
        const int next = i0 + kSpan;
        if (next < len && next < kSpan + kBudget) {
#pragma unroll
            for (int u = 0; u < kG; ++u) {
                const int i = next + lane + 32 * u;
                if (i < len) pos[u] = slot[i - kSpan];
            }
        } else if (next < len) {
            load_group<V>(pos, pa, pb, e0, len, next, lane);
        }
#pragma unroll
        for (int u = 0; u < kG; ++u) {
            if (i0 + lane + 32 * u < len)
                s = fz<FTZ>(add(s, fz<FTZ>(mul(fz<FTZ>(widen(x[u])), fz<FTZ>(widen(y[u]))))));
        }
    }
    return s;
}

// lane 0 waits until a level's counter counts `need`; the warp follows
__device__ __forceinline__ void wait_counter(const int* counter, int need, int lane) {
    if (lane == 0) {
        unsigned spins = 0;
        while (load_acquire(counter) < need) backoff(spins);
    }
    __syncwarp();
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
// over each one's pairs in turn. A task of more than kBudget pairs is one
// long entry (the plan cuts so; the kernel traps otherwise).
template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
splu_factor_kernel(int ntasks, const int4* __restrict__ tasks, const int32_t* __restrict__ level_ptr,
                   const int32_t* __restrict__ perm, const int64_t* __restrict__ first,
                   const int32_t* __restrict__ count, const int32_t* __restrict__ pa,
                   const int32_t* __restrict__ pb,
                   const int8_t* __restrict__ is_lower, const int32_t* __restrict__ diag_col,
                   const V* __restrict__ a, V* vals, V eps_v, int* ctl, int* ticket) {
    __shared__ Stage stages[kWarps];
    Stage& st = stages[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    const A eps = widen(eps_v);
    int k = 0;
    if (lane == 0) k = atomicAdd(ticket, 1);
    k = __shfl_sync(kFull, k, 0);
    while (k < ntasks) {
        const int4 t = tasks[k];
        const int q0 = t.x, n = t.y - t.x, v0 = t.z;
        const int need = v0 > 0 ? level_ptr[v0] - level_ptr[v0 - 1] : 0;
        // lane j < n: entry j's pair list (by position: no trip through perm
        // before the positions), and its first slot (a scan of the lengths)
        const bool live = lane < n;
        int32_t p = 0;
        int64_t e0 = 0;
        int len = 0;
        if (live) {
            e0 = first[q0 + lane];
            len = count[q0 + lane];
            p = perm[q0 + lane];
        }
        int off = len;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int o = __shfl_up_sync(kFull, off, s);
            if (lane >= s) off += o;
        }
        const int total = __shfl_sync(kFull, off, 31);
        off -= len;
        const bool stream = total > kBudget;  // one long entry, streamed
        if (stream && n != 1) __trap();
        // the stage is free: the task before ended with the warp's barrier
        int2 pos[kValueBatch<V>];
        if (stream) {
            // the first group's positions in registers, the next kBudget in the stage
            constexpr int kFirst = 32 * kValueBatch<V>;
            load_group<V>(pos, pa, pb, __shfl_sync(kFull, e0, 0), total, 0, lane);  // n = 1
            if (lane == 0) {
                st.e0[0] = e0 + kFirst;
                st.off[0] = 0;
                st.off[1] = min(total - kFirst, kBudget);
            }
        } else {
            if (live) {
                st.e0[lane] = e0;
                st.off[lane] = off;
            }
            if (lane == 0) st.off[n] = total;
        }
        __syncwarp();
        stage_positions(st, stream ? 1 : n, pa, pb, lane);
        // the entry's own words, asked for after the positions: they are
        // needed after the wait only
        int32_t dc = -1;
        bool lower = false;
        A av = A(0);
        if (live) {
            av = fz<FTZ>(widen(a[p]));
            lower = is_lower[p] != 0;
            dc = diag_col[p];
        }
        if (v0 > 0) wait_counter(ctl + kLine * (v0 - 1), need, lane);
        // a long task takes its next ticket now, the trip beside its own
        // (every task before that ticket is held by a running warp, as for a
        // ticket taken after the post); a short one after its post
        const bool ahead = t.w != v0;
        int next = 0;
        if (ahead && lane == 0) next = atomicAdd(ticket, 1);
        const A d = live ? divisor<V, A, FTZ>(vals, lower, dc) : A(0);  // beside the values
        A sum = A(0);
        if (stream) {
            sum = tree<A, FTZ>(stream_sum<V, A, FTZ>(pos, st.slot, pa, pb,
                                                     __shfl_sync(kFull, e0, 0), total, vals,
                                                     lane));
        } else {
            products<V, A, FTZ>(st.slot, total, vals, lane);
            __syncwarp();
            if (t.w == v0) {
                if (live) sum = sum_slots<A, FTZ>(A(0), st.slot, off, 0, len, 1);
            } else {
                for (int j = 0; j < n; ++j) {
                    const int o = __shfl_sync(kFull, off, j), l = __shfl_sync(kFull, len, j);
                    const A s = tree<A, FTZ>(sum_slots<A, FTZ>(A(0), st.slot, o, lane, l, 32));
                    if (lane == j) sum = s;
                }
            }
        }
        if (live) store_value(vals + p, finish<V, A, FTZ>(av, sum, lower, dc >= 0, d, eps));
        post_level(ctl + kLine * v0, 0, n, lane);
        if (!ahead && lane == 0) next = atomicAdd(ticket, 1);
        k = __shfl_sync(kFull, next, 0);
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int ntasks, int warps, const void* tasks, const void* level_ptr,
           const void* perm, const void* first, const void* count, const void* pa, const void* pb,
           const void* is_lower, const void* diag_col, const void* a, void* vals, double eps,
           void* ctl, int nctl, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ntasks < 1 || warps < 1 || nctl < kLine || nctl % kLine)
        return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, splu_factor_kernel<V, A, FTZ>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    // no more blocks than are resident at once: a later block would only
    // find the tickets taken
    const int want = (warps + kWarps - 1) / kWarps;
    const unsigned blocks = static_cast<unsigned>(want < per_sm * sms ? want : per_sm * sms);
    int* words = static_cast<int*>(ctl);
    splu_factor_kernel<V, A, FTZ><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ntasks, static_cast<const int4*>(tasks), static_cast<const int32_t*>(level_ptr),
        static_cast<const int32_t*>(perm), static_cast<const int64_t*>(first),
        static_cast<const int32_t*>(count), static_cast<const int32_t*>(pa),
        static_cast<const int32_t*>(pb),
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
// (positions); `first` int64[nnz] and `count` int32[nnz], by position, the
// entry's first pair and its number of pairs in `pa`, `pb` (int32, every
// entry's pairs in entry order); `is_lower` int8[nnz]; `diag_col` int32[nnz]
// (the position of u_jj, -1 where it is missing); `a` V[nnz] A's values on
// the pattern; `vals` V[nnz],
// every entry written once; `ctl` int32[nctl] zeroed for this launch alone,
// kLine * (levels + 1) words: level v's counter at kLine * v, the last word
// the ticket (each on a 128-byte line of its own). `warps` is how many warps take tasks
// (at most as many as are resident at once). `eps` is rounded to V.
extern "C" {

#define RESPA_SPLU_FACTOR(SUFFIX, V, A, FTZ)                                                     \
    int respa_splu_factor_##SUFFIX(int device, int ntasks, int warps, const void* tasks,         \
                                   const void* level_ptr, const void* perm, const void* first,   \
                                   const void* count, const void* pa, const void* pb,           \
                                   const void* is_lower, const void* diag_col, const void* a,   \
                                   void* vals, double eps, void* ctl, int nctl, void* stream) { \
        return launch<V, A, FTZ>(device, ntasks, warps, tasks, level_ptr, perm, first, count,   \
                                 pa, pb, is_lower, diag_col, a, vals, eps, ctl, nctl, stream);  \
    }

RESPA_SPLU_FACTOR(f32, float, float, false)
RESPA_SPLU_FACTOR(f32_ftz, float, float, true)
RESPA_SPLU_FACTOR(bf16, __nv_bfloat16, float, false)
RESPA_SPLU_FACTOR(f64, double, double, false)

// the plan's sizes the kernel was built with: 0 short entry, 1 entries a
// task, 2 the largest pair budget of a task of several entries, 3 the
// control words a level
int respa_splu_limit(int which) {
    const int limits[] = {kShort, kTaskEntries, kBudget, kLine};
    return which >= 0 && which < 4 ? limits[which] : -1;
}

}  // extern "C"
