// Exact sparse triangular solve in one launch (K7).
//
// Replaces respatpu/kernels/sptrsv.py _sptrsv_single, _sptrsv_df and
// _sptrsv_blocked (a lax.scan over level-aligned chunks of rows) with one
// launch that has no level loop:
//
//     y_i = (b_i - sum_j N_ij y_j) * dinv_i
//
// over the strict triangle N and the reciprocal diagonal dinv, made on the
// host. What bounds it on this card is not bytes (the triangle is read once
// in a few microseconds) but the chain of levels: between two warps a level
// costs a hand-over through L2 (the finishing warp's release, the waiting
// warp's acquire, then its loads of y). The design makes that hand-over the
// only thing on the chain: one wait a task, everything else loaded before it.
//
// The schedule is made once a factor, at upload (kernels/sptrsv.py
// tri_schedule): the rows in level order (a *position* q for every row, short
// rows of at most kShort strict entries before long ones in a level), the
// triangle stored in that order with its columns as positions, and tasks in
// level order: up to 32 short rows of one level (a lane a row), one long row
// (a warp over its entries), or a run of consecutive thin levels (at most 32
// rows each, all short) walked by one warp with the run staged in shared
// memory and its values written out at its end. Warps take tasks from an
// atomic ticket, one atomicAdd a task. Every dependency of a task lies in an
// earlier level, so in a task ticketed before it by a warp that is already
// running: no cooperative launch is needed and nothing deadlocks. A lane
// loads its row's offsets, columns, values, b and dinv before it waits; after
// the wait only the loads of y remain.
//
// Two ways to wait, chosen by `mode`: 0, one completion counter a level (a
// task of level v waits once, by lane 0, until ctl[v - 1] counts every row of
// level v - 1; a row of level v - 1 is written only after level v - 2 is
// complete, so that implies every earlier level is complete; a finished task
// fences and adds its rows to its level's counter with one atomic); 1, a
// ready flag a row carried by the value itself (yp starts as a signalling
// NaN that no arithmetic result can be, each value is written whole once, and
// a lane's loads of its columns' values are its wait). The counters or yp,
// and the ticket, are set for each launch on its stream (never a tag counted
// on the host). How many warps take tasks is the schedule's choice (a few
// levels' worth: more would only poll). Measured on the card (PERF.md): mode
// 0 is the faster, and the package launches only it; mode 1 stays to be
// timed beside it. One block walking every level with a barrier between
// levels was slower for fp64.
// (Reference: "On Parallel Solution of Sparse Triangular Linear Systems in
// CUDA", PAPERS.md.)
//
// A short row sums its products in CSR order from +0, and a long
// row keeps the warp order (lane l over the entries l, l + 32, ..., then a
// halving tree over the 32 partials). Every product and sum is rounded on its
// own (and flushed under fp32_ftz), so the solve equals tri_solve_plain, which
// goes level by level in the same order, bit for bit.
//
// Instances: f32; f32_ftz (b, every product, partial sum and result flushed to
// zero); bf16 (bf16 values and dinv, b and y fp32, each y_i rounded to bf16
// once); f64.
//
// Also here: a probe of the card's one-way link latency, two warps on two SMs
// bouncing a flag through L2 by release and acquire, which gives the chain
// bound levels x latency.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShort = 16;        // a short row: at most this many strict entries
constexpr int kRunRows = 128;     // a run's rows, staged in shared memory
constexpr int kRunEntries = 512;  // a run's entries
constexpr int kEager = 64;        // polls before a wait starts to sleep
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

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A value of y by position, read and written whole (single-copy atomic), so
// that under mode 1 the value is its own ready flag: yp starts as kPending,
// a signalling NaN that no arithmetic result can be (an operation on a NaN
// returns a quiet one).
constexpr unsigned kPending32 = 0x7f800001u;
constexpr unsigned long long kPending64 = 0x7ff0000000000001ull;
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
__device__ __forceinline__ void store_value(float* p, float v) {
    asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(__float_as_uint(v)));
}
__device__ __forceinline__ void store_value(double* p, double v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p),
                 "l"(static_cast<unsigned long long>(__double_as_longlong(v))));
}
__device__ __forceinline__ bool pending(float v) { return __float_as_uint(v) == kPending32; }
__device__ __forceinline__ bool pending(double v) {
    return static_cast<unsigned long long>(__double_as_longlong(v)) == kPending64;
}

__device__ __forceinline__ void backoff(unsigned& spins) {
    if (++spins > kSpinLimit) __trap();
    if (spins > kEager) __nanosleep(32);
}

// mode 0: lane 0 waits until level v - 1 is complete; the warp follows
__device__ __forceinline__ void wait_level(const int* ctl, int v, int need, int lane) {
    if (lane == 0 && v > 0) {
        unsigned spins = 0;
        while (load_acquire(ctl + v - 1) < need) backoff(spins);
    }
    __syncwarp();
}

// mode 0: the warp's rows are written; lane 0 adds them to level v's count
__device__ __forceinline__ void post_level(int* ctl, int v, int rows, int lane) {
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicAdd(ctl + v, rows);
}

// mode 1: until every value of `cols` (this lane's entries e0 + lane, +32,
// ... below e1, those of positions below `below`) is written
template <typename A, typename Cols>
__device__ __forceinline__ void wait_values(const A* yp, Cols cols, int64_t e0, int64_t e1,
                                            int below, int lane) {
    unsigned spins = 0;
    while (true) {
        bool ready = true;
        for (int64_t e = e0 + lane; e < e1; e += 32) {
            const int c = cols[e];
            if (c < below) ready &= !pending(load_value(yp + c));
        }
        if (__all_sync(kFull, ready)) return;
        backoff(spins);
    }
}

// the run of one warp, staged in shared memory (values widened)
template <typename A>
struct Run {
    A y[kRunRows];
    A b[kRunRows];
    A dinv[kRunRows];
    int32_t row[kRunRows];
    int32_t ptr[kRunRows + 1];
    int32_t lev[kRunRows + 1];
    int32_t col[kRunEntries];
    A val[kRunEntries];
};

// tasks: int4 {q0, q1, v0, v1}: positions q0 .. q1 - 1 from level v0 on;
// v1 == v0: up to 32 short rows of level v0, a lane a row; v1 < 0: one long
// row, a warp over its entries; v1 > v0: a run of the levels v0 .. v1.
template <typename V, typename A, bool FTZ, bool FLAGS>
__global__ void __launch_bounds__(kThreads)
tri_solve_kernel(int ntasks, const int4* __restrict__ tasks, const int32_t* __restrict__ level_ptr,
                 const int32_t* __restrict__ perm, const int64_t* __restrict__ ptr,
                 const int32_t* __restrict__ cols, const V* __restrict__ vals,
                 const V* __restrict__ dinv, const A* __restrict__ b, A* __restrict__ y, A* yp,
                 int* ctl, int* ticket) {
    __shared__ Run<A> runs[kWarps];
    Run<A>& st = runs[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    while (true) {
        int k = 0;
        if (lane == 0) k = atomicAdd(ticket, 1);
        k = __shfl_sync(kFull, k, 0);
        if (k >= ntasks) return;
        const int4 t = tasks[k];
        const int q0 = t.x, q1 = t.y, v0 = t.z;
        const int need = (!FLAGS && v0 > 0) ? level_ptr[v0] - level_ptr[v0 - 1] : 0;
        if (t.w == v0) {
            // up to 32 short rows of one level, a lane a row
            const int q = q0 + lane;
            const bool live = q < q1;
            int len = 0, row = 0;
            int32_t c[kShort];
            A v[kShort];
            A bi = A(0), di = A(0);
            if (live) {
                const int64_t e0 = ptr[q];
                len = static_cast<int>(ptr[q + 1] - e0);
                row = perm[q];
#pragma unroll
                for (int m = 0; m < kShort; ++m)
                    if (m < len) {
                        c[m] = cols[e0 + m];
                        v[m] = widen(vals[e0 + m]);
                    }
                bi = fz<FTZ>(b[row]);
                di = widen(dinv[row]);
            }
            A yv[kShort];
            if constexpr (FLAGS) {
                // the loads of y are the wait: poll until none is pending
                unsigned spins = 0;
                while (true) {
                    bool ready = true;
#pragma unroll
                    for (int m = 0; m < kShort; ++m)
                        if (m < len) {
                            yv[m] = load_value(yp + c[m]);
                            ready &= !pending(yv[m]);
                        }
                    if (ready) break;
                    backoff(spins);
                }
            } else {
                wait_level(ctl, v0, need, lane);
#pragma unroll
                for (int m = 0; m < kShort; ++m)
                    if (m < len) yv[m] = load_value(yp + c[m]);
            }
            A s = A(0);
#pragma unroll
            for (int m = 0; m < kShort; ++m)
                if (m < len) s = fz<FTZ>(add(s, fz<FTZ>(mul(v[m], yv[m]))));
            if (live) {
                const A r = round_to<V>(fz<FTZ>(mul(fz<FTZ>(sub(bi, s)), di)));
                store_value(yp + q, r);
                __stcs(y + row, r);
            }
            if constexpr (!FLAGS) post_level(ctl, v0, q1 - q0, lane);
        } else if (t.w < 0) {
            // one long row: lane l over the entries l, l + 32, ..., then a halving tree
            const int64_t e0 = ptr[q0], e1 = ptr[q0 + 1];
            const int row = perm[q0];
            const A bi = fz<FTZ>(b[row]);
            const A di = widen(dinv[row]);
            if constexpr (FLAGS)
                wait_values(yp, cols, e0, e1, q0, lane);
            else
                wait_level(ctl, v0, need, lane);
            A s = A(0);
            for (int64_t e = e0 + lane; e < e1; e += 32)
                s = fz<FTZ>(add(s, fz<FTZ>(mul(widen(vals[e]), load_value(yp + cols[e])))));
#pragma unroll
            for (int off = 16; off; off >>= 1) s = fz<FTZ>(add(s, __shfl_xor_sync(kFull, s, off)));
            if (lane == 0) {
                const A r = round_to<V>(fz<FTZ>(mul(fz<FTZ>(sub(bi, s)), di)));
                store_value(yp + q0, r);
                __stcs(y + row, r);
            }
            if constexpr (!FLAGS) post_level(ctl, v0, 1, lane);
        } else {
            // a run of thin levels: stage it, wait once, walk it level by level
            // in shared memory, then write its values out together
            const int nr = q1 - q0, nl = t.w - v0 + 1;
            const int64_t e0 = ptr[q0];
            const int ne = static_cast<int>(ptr[q1] - e0);
            for (int i = lane; i < nr; i += 32) {
                const int r = perm[q0 + i];
                st.row[i] = r;
                st.b[i] = fz<FTZ>(b[r]);
                st.dinv[i] = widen(dinv[r]);
                st.ptr[i] = static_cast<int32_t>(ptr[q0 + i] - e0);
            }
            for (int i = lane; i <= nl; i += 32) st.lev[i] = level_ptr[v0 + i] - q0;
            if (lane == 0) st.ptr[nr] = ne;
            for (int i = lane; i < ne; i += 32) {
                st.col[i] = cols[e0 + i];
                st.val[i] = widen(vals[e0 + i]);
            }
            __syncwarp();
            if constexpr (FLAGS)
                wait_values(yp, st.col, 0, ne, q0, lane);
            else
                wait_level(ctl, v0, need, lane);
            for (int l = 0; l < nl; ++l) {
                const int r = st.lev[l] + lane;
                if (r < st.lev[l + 1]) {
                    A s = A(0);
                    for (int e = st.ptr[r]; e < st.ptr[r + 1]; ++e) {
                        const int c = st.col[e];
                        const A yc = c >= q0 ? st.y[c - q0] : load_value(yp + c);
                        s = fz<FTZ>(add(s, fz<FTZ>(mul(st.val[e], yc))));
                    }
                    st.y[r] = round_to<V>(fz<FTZ>(mul(fz<FTZ>(sub(st.b[r], s)), st.dinv[r])));
                }
                __syncwarp();
            }
            for (int i = lane; i < nr; i += 32) {
                store_value(yp + q0 + i, st.y[i]);
                __stcs(y + st.row[i], st.y[i]);
            }
            if constexpr (!FLAGS) post_level(ctl, t.w, st.lev[nl] - st.lev[nl - 1], lane);
            __syncwarp();
        }
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int ntasks, int warps, const void* tasks, const void* level_ptr,
           const void* perm, const void* ptr, const void* cols, const void* vals,
           const void* dinv, const void* b, void* y, void* yp, void* ctl, int nctl, int mode,
           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ntasks < 1 || warps < 1 || nctl < 1 || (mode != 0 && mode != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int want = (warps + kWarps - 1) / kWarps;
    const unsigned blocks = static_cast<unsigned>(want < kBlocksPerSm * sms ? want
                                                                            : kBlocksPerSm * sms);
    int* words = static_cast<int*>(ctl);
    auto go = [&](auto kernel) {
        kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            ntasks, static_cast<const int4*>(tasks), static_cast<const int32_t*>(level_ptr),
            static_cast<const int32_t*>(perm), static_cast<const int64_t*>(ptr),
            static_cast<const int32_t*>(cols), static_cast<const V*>(vals),
            static_cast<const V*>(dinv), static_cast<const A*>(b), static_cast<A*>(y),
            static_cast<A*>(yp), words, words + nctl - 1);
    };
    if (mode == 0)
        go(tri_solve_kernel<V, A, FTZ, false>);
    else
        go(tri_solve_kernel<V, A, FTZ, true>);
    return static_cast<int>(cudaGetLastError());
}

// Two single-thread blocks, one on each of two SMs (each asks for more than
// half an SM's shared memory): block 0 stores 2k + 1 by release and waits by
// acquire for block 1's 2k + 2, `rounds` times, timed by the global timer.
constexpr int kProbeSmem = 150 * 1024;

__global__ void link_probe_kernel(int rounds, int* flag, long long* out) {
    extern __shared__ int unused[];
    (void)unused;
    if (threadIdx.x != 0) return;
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    out[1 + blockIdx.x] = smid;
    const bool ping = blockIdx.x == 0;
    long long t0 = 0;
    for (int k = -16; k < rounds; ++k) {  // 16 rounds of warm-up
        if (k == 0 && ping) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
        const int mine = 2 * (k + 16) + (ping ? 1 : 2), theirs = ping ? mine + 1 : mine - 1;
        if (ping) store_release(flag, mine);
        unsigned spins = 0;  // no sleep here: a poll is the link being measured
        while (load_acquire(flag) != theirs)
            if (++spins > kSpinLimit) __trap();
        if (!ping) store_release(flag, mine);
    }
    if (ping) {
        long long t1;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
        out[0] = t1 - t0;
    }
}

}  // namespace

// C interface: every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). `mode`: 0,
// tasks waiting on level counters; 1, tasks waiting on ready values. Pointers
// are device pointers, all from tri_schedule but b, y, yp and ctl: `tasks`
// int32[ntasks][4]; `level_ptr` int32[levels + 1] and `perm` int32[n]
// (positions); the strict triangle in position order as `ptr` int64[n + 1],
// `cols` int32 (positions) and `vals` V; `dinv` V[n] and `b` A[n] by row
// (A = fp32, fp64 for f64); `y` A[n] by row and `yp` A[n] by position, both
// written, yp all kPending under mode 1; `ctl` int32[nctl] zeroed for this
// launch alone, its last word the ticket: levels + 1 words under mode 0, 1
// under mode 1. `warps` is how many warps take tasks (at most four blocks an
// SM). The lower and upper entries launch the same kernel: in position order
// a triangle has no direction.
extern "C" {

#define RESPA_TRI_SOLVE_ONE(DIR, SUFFIX, V, A, FTZ)                                            \
    int respa_tri_solve_##DIR##_##SUFFIX(int device, int ntasks, int warps,                    \
                                         const void* tasks, const void* level_ptr,             \
                                         const void* perm, const void* ptr, const void* cols,  \
                                         const void* vals, const void* dinv, const void* b,    \
                                         void* y, void* yp, void* ctl, int nctl, int mode,     \
                                         void* stream) {                                       \
        return launch<V, A, FTZ>(device, ntasks, warps, tasks, level_ptr, perm, ptr, cols,     \
                                 vals, dinv, b, y, yp, ctl, nctl, mode, stream);               \
    }
#define RESPA_TRI_SOLVE(SUFFIX, V, A, FTZ)         \
    RESPA_TRI_SOLVE_ONE(lower, SUFFIX, V, A, FTZ)  \
    RESPA_TRI_SOLVE_ONE(upper, SUFFIX, V, A, FTZ)

RESPA_TRI_SOLVE(f32, float, float, false)
RESPA_TRI_SOLVE(f32_ftz, float, float, true)
RESPA_TRI_SOLVE(bf16, __nv_bfloat16, float, false)
RESPA_TRI_SOLVE(f64, double, double, false)

// the schedule's sizes the kernel was built with: 0 short row, 1 run rows,
// 2 run entries, 3 rows a task
int respa_tri_solve_limit(int which) {
    const int limits[] = {kShort, kRunRows, kRunEntries, 32};
    return which >= 0 && which < 4 ? limits[which] : -1;
}

// `flag` one int32 zeroed; `out` int64[3]: the nanoseconds of `rounds` round
// trips, and the two blocks' SM ids.
int respa_link_probe(int device, int rounds, void* flag, void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(link_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kProbeSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    link_probe_kernel<<<2, 32, kProbeSmem, static_cast<cudaStream_t>(stream)>>>(
        rounds, static_cast<int*>(flag), static_cast<long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
