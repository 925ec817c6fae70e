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
//                                package's K1 in the same run (phase 6);
//   respa_band_sweep_before_*    K2 before it took the inverses of the
//                                diagonal triangles,
//   respa_extend_add_before_*    K3 before its two regimes,
//   respa_splu_factor_before_*   K8 before it staged a task's pair
//                                positions (on its own plan, cut at runs of
//                                256 pairs), and
//   respa_band_sweep_t_before_*  K11 before it took the inverses, and
//   respa_front_sweep_t_before_* K12 before its own kernels (K4's read
//                                transposed), each timed beside the
//                                package's in turns (`chip_smoke.py --before`).
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

// K2 before it took the inverses of the diagonal triangles (its first design:
// the diagonal block in shared memory, solved by substitution, 32 unknowns a
// warp through shuffles and a barrier between warps; the row sums by a
// shuffle tree a row), kept only to be timed beside K2. The same mailbox,
// panels and launch as K2; within the sweep tolerance of K2's plain version.
namespace first_k2 {

constexpr int kMaxP = 128;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kRowsPerWarp = kMaxP / kSweepWarps;
constexpr int kColsPerLane = kMaxP / 32;

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

// Separately rounded operations (no contraction into a fused multiply-add),
// flushed under FTZ.
template <bool FTZ>
__device__ __forceinline__ float mul(float a, float b) {
    const float r = __fmul_rn(a, b);
    return FTZ ? flush(r) : r;
}
template <bool FTZ>
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
template <bool FTZ>
__device__ __forceinline__ float sub(float a, float b) {
    const float r = __fsub_rn(a, b);
    return FTZ ? flush(r) : r;
}
template <bool FTZ>
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
template <bool FTZ>
__device__ __forceinline__ float add(float a, float b) {
    const float r = __fadd_rn(a, b);
    return FTZ ? flush(r) : r;
}
template <bool FTZ>
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
template <bool FTZ>
__device__ __forceinline__ float quot(float a, float b) {
    const float r = __fdiv_rn(a, b);
    return FTZ ? flush(r) : r;
}
template <bool FTZ>
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }

// t - l * u: one fused multiply-add; under FTZ the product and the
// difference are rounded, and flushed, one after the other.
template <bool FTZ>
__device__ __forceinline__ float nmuladd(float t, float l, float u) {
    if constexpr (FTZ) {
        return sub<true>(t, mul<true>(l, u));
    } else {
        return __fmaf_rn(-l, u, t);
    }
}
template <bool FTZ>
__device__ __forceinline__ double nmuladd(double t, double l, double u) {
    return __fma_rn(-l, u, t);
}

// Mailbox of the sweeps: every 32-bit word of a solved vector block travels
// with a tag in one 8-byte store, which the card performs as a whole, so a
// reader that sees the tag has the word, with no fence and no second trip to
// memory (the low-latency protocol of collective libraries). A double is two
// such pairs. A reader that spins for seconds traps instead of hanging.
constexpr unsigned kSpinLimit = 1u << 26;

__device__ __forceinline__ void mail_put(unsigned* slot, unsigned word, unsigned tag) {
    asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(slot), "r"(word), "r"(tag)
                 : "memory");
}

__device__ __forceinline__ unsigned mail_get(const unsigned* slot, unsigned tag) {
    unsigned word, seen, spins = 0;
    do {
        asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
                     : "=r"(word), "=r"(seen)
                     : "l"(slot)
                     : "memory");
        if (++spins > kSpinLimit) __trap();
    } while (seen != tag);
    return word;
}

__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, float v, unsigned tag) {
    mail_put(mail + 2 * e, __float_as_uint(v), tag);
}
__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, double v, unsigned tag) {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v));
    mail_put(mail + 4 * e, static_cast<unsigned>(bits), tag);
    mail_put(mail + 4 * e + 2, static_cast<unsigned>(bits >> 32), tag);
}
__device__ __forceinline__ void mail_recv(const unsigned* mail, int64_t e, unsigned tag, float* v) {
    *v = __uint_as_float(mail_get(mail + 2 * e, tag));
}
__device__ __forceinline__ void mail_recv(const unsigned* mail, int64_t e, unsigned tag,
                                          double* v) {
    const unsigned long long lo = mail_get(mail + 4 * e, tag);
    const unsigned long long hi = mail_get(mail + 4 * e + 2, tag);
    *v = __longlong_as_double(static_cast<long long>(lo | (hi << 32)));
}

// Solve the P x P triangular system held in shared memory (`dblk`, row stride
// p + 1) against `acc` in place. In the solve's own order t = 0..P-1 (t = i
// for a lower system, t = P-1-i for an upper one) the system is lower
// triangular; a unit diagonal is not read, otherwise each row is first
// scaled by the reciprocal of its diagonal entry, so that no division or
// product sits on the chain. K2 solves lower unit forward and upper non-unit
// backward, K11 lower non-unit forward and upper unit backward.
// Warp k owns the unknowns 32 k .. 32 k + 31, one a lane, and keeps its rows
// of the 32 x 32 diagonal block in registers. Warp 0 solves its 32 unknowns
// through shuffles and puts them into shared memory; behind one barrier the
// later warps subtract their contribution from their own unknowns, and
// warp 1 goes on to solve, and so on: one barrier for 32 unknowns, and only
// the chain of shuffles and the next warp's 32 updates between two solves.
template <typename A, bool FTZ, bool LOWER, bool UNIT>
__device__ __forceinline__ void tri_solve(const A* dblk, A* acc, int p) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int lds = p + 1;
    const int nblk = (p + 31) / 32;
    const int t = 32 * warp + lane;
    const bool live = warp < nblk && t < p;
    const int i = LOWER ? t : p - 1 - t;
    A drow[32];
    A mine = A(0);
    if (warp < nblk) {
        A rinv = A(1);
        if (!UNIT && live) rinv = quot<FTZ>(A(1), dblk[i * lds + i]);
#pragma unroll
        for (int s = 0; s < 32; ++s) {
            const int ts = 32 * warp + s;
            const int js = LOWER ? ts : p - 1 - ts;
            drow[s] = (live && s < lane) ? dblk[i * lds + js] : A(0);
            if (!UNIT) drow[s] = mul<FTZ>(drow[s], rinv);
        }
        if (live) mine = UNIT ? acc[i] : mul<FTZ>(acc[i], rinv);
        for (int k = 0; k < nblk; ++k) {
            if (warp == k) {
#pragma unroll
                for (int s = 0; s < 32; ++s) {
                    const A xs = __shfl_sync(0xffffffffu, mine, s);
                    if (lane > s) mine = nmuladd<FTZ>(mine, drow[s], xs);
                }
                if (live) acc[i] = mine;
            }
            __syncthreads();
            if (warp > k && live) {
                A sum = A(0);
#pragma unroll 8
                for (int s = 0; s < 32; ++s) {
                    const int ts = 32 * k + s;
                    const int js = LOWER ? ts : p - 1 - ts;
                    sum = nmuladd<FTZ>(sum, -dblk[i * lds + js], acc[js]);
                }
                mine = UNIT ? sub<FTZ>(mine, sum) : nmuladd<FTZ>(mine, rinv, sum);
            }
        }
    } else {
        for (int k = 0; k < nblk; ++k) __syncthreads();
    }
    __syncthreads();
}

template <typename V, typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kSweepThreads)
band_sweep_kernel(int nb, int p, int ml, int mu, const V* __restrict__ band,
                  const A* __restrict__ b, A* __restrict__ out, unsigned* mail) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    A* dblk = reinterpret_cast<A*>(smem_raw);  // p x (p + 1)
    A* acc = dblk + p * (p + 1);               // p
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t w = static_cast<int64_t>(ml + mu + 1) * p;
    const int m = FWD ? ml : mu;

    for (int q = blockIdx.x; q < nb; q += gridDim.x) {
        const int r = FWD ? q : nb - 1 - q;
        const V* row = band + static_cast<int64_t>(r) * p * w;

#ifndef RESPA_SWEEP_NO_DIAG
        // (a measurement build of bench/band_probe.py leaves this load out)
        for (int e = tid; e < p * p; e += kSweepThreads) {
            const int i = e / p, k = e % p;
            dblk[i * (p + 1) + k] = to_acc(row[i * w + static_cast<int64_t>(ml) * p + k]);
        }
#endif

        A part[kRowsPerWarp];
#pragma unroll
        for (int ii = 0; ii < kRowsPerWarp; ++ii) part[ii] = A(0);

#ifdef RESPA_SWEEP_NEAR_ONLY
        // Measurement build of bench/band_probe.py, never the package's: only
        // the nearest panel, so that the far panels' share shows as a difference.
        for (int d = min(1, q); d >= 1; --d) {
#else
        for (int d = min(m, q); d >= 1; --d) {
#endif
            const int64_t c0 = static_cast<int64_t>(FWD ? ml - d : ml + d) * p;
            // the panel's values are asked for before the wait for its vector
            V pv[kRowsPerWarp][kColsPerLane];
#pragma unroll
            for (int ii = 0; ii < kRowsPerWarp; ++ii) {
                const int i = warp + kSweepWarps * ii;
                const V* src = row + i * w + c0;
#pragma unroll
                for (int k = 0; k < kColsPerLane; ++k) {
                    const int col = lane + 32 * k;
                    if (i < p && col < p) pv[ii][k] = src[col];
                }
            }
            // every lane takes its own words of the vector block from the
            // mailbox, waiting until the block that solves row q - d has sent them
            A v[kColsPerLane];
#pragma unroll
            for (int k = 0; k < kColsPerLane; ++k) {
                const int col = lane + 32 * k;
                A x = A(0);
                if (col < p) mail_recv(mail, static_cast<int64_t>(q - d) * p + col, q - d + 1, &x);
                if constexpr (FTZ) x = flush(x);
                v[k] = x;
            }
#pragma unroll
            for (int ii = 0; ii < kRowsPerWarp; ++ii) {
                const int i = warp + kSweepWarps * ii;
#pragma unroll
                for (int k = 0; k < kColsPerLane; ++k) {
                    const int col = lane + 32 * k;
                    if (i < p && col < p)
                        part[ii] = nmuladd<FTZ>(part[ii], -to_acc(pv[ii][k]), v[k]);
                }
            }
        }

#pragma unroll
        for (int ii = 0; ii < kRowsPerWarp; ++ii) {
            A sum = part[ii];
            for (int off = 16; off > 0; off >>= 1)
                sum = add<FTZ>(sum, __shfl_xor_sync(0xffffffffu, sum, off));
            const int i = warp + kSweepWarps * ii;
            if (lane == 0 && i < p) {
                A rhs = b[static_cast<int64_t>(r) * p + i];
                if constexpr (FTZ) rhs = flush(rhs);
                acc[i] = sub<FTZ>(rhs, sum);
            }
        }
        __syncthreads();  // dblk and acc are complete

#ifndef RESPA_SWEEP_NO_TRI
        // (a measurement build of bench/band_probe.py leaves the solve out)
        tri_solve<A, FTZ, FWD, FWD>(dblk, acc, p);
#endif

        if (tid < p) {
            const int64_t e = static_cast<int64_t>(q) * p + tid;
            mail_send(mail, e, acc[tid], q + 1);  // first: the next row waits for it
            out[static_cast<int64_t>(r) * p + tid] = acc[tid];
        }
        __syncthreads();  // acc is rewritten in the next row
    }
}

template <typename A>
size_t sweep_smem(int p) { return (static_cast<size_t>(p) * (p + 1) + p) * sizeof(A); }

template <typename V, typename A, bool FTZ, bool FWD>
cudaError_t launch_band_sweep(int device, int nb, int p, int ml, int mu, const void* band,
                              const void* b, void* out, void* mail, cudaStream_t stream) {
    auto kernel = band_sweep_kernel<V, A, FTZ, FWD>;
    const size_t smem = sweep_smem<A>(p);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSweepThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    // one block an SM: a block's panel reads want an SM's whole load path
    int grid = (FWD ? ml : mu) + 1;
    if (grid > nb) grid = nb;
    if (grid > sms) grid = sms;
    const V* band_v = static_cast<const V*>(band);
    const A* b_a = static_cast<const A*>(b);
    A* out_a = static_cast<A*>(out);
    unsigned* mail_u = static_cast<unsigned*>(mail);
    void* args[] = {&nb, &p, &ml, &mu, &band_v, &b_a, &out_a, &mail_u};
    // cooperative: the launch fails unless all `grid` blocks are resident
    // together, which the mailbox waits rely on
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                      dim3(kSweepThreads), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace first_k2

// device, nb, p, ml, mu, band, b, out, mail, stream: as respa_band_sweep_*
// (kernels/csrc/band_lu.cu) before it took `inv`
#define RESPA_BAND_SWEEP_BEFORE(NAME, V, A, FTZ, FWD)                                         \
    extern "C" int NAME(int device, int nb, int p, int ml, int mu, const void* band,         \
                        const void* b, void* out, void* mail, void* stream) {                 \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nb < 1 || p < 1 || p > first_k2::kMaxP || ml < 1 || mu < 1)                        \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        return static_cast<int>(first_k2::launch_band_sweep<V, A, FTZ, FWD>(                  \
            device, nb, p, ml, mu, band, b, out, mail, static_cast<cudaStream_t>(stream)));    \
    }

RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_fwd_f32, float, float, false, true)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_bwd_f32, float, float, false, false)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_fwd_f32_ftz, float, float, true, true)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_bwd_f32_ftz, float, float, true, false)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_fwd_bf16, __nv_bfloat16, float, false, true)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_bwd_bf16, __nv_bfloat16, float, false, false)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_fwd_f64, double, double, false, true)
RESPA_BAND_SWEEP_BEFORE(respa_band_sweep_before_bwd_f64, double, double, false, false)

// K3 before its two regimes (its first design): a thread block a parent, every
// warp walking every child of it in plan order, a row's 32-entry runs one
// after the other. Kept only to be timed beside K3; the same bits.
namespace first_k3 {

constexpr int kAddThreads = 256;

template <bool FTZ, typename A>
__device__ __forceinline__ A fz(A v) {
    if constexpr (FTZ) return ::flush(v);
    return v;
}

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

}  // namespace first_k3

// device, pool, g0, nfronts, wp, rp, lp, poff, pmp, seg_ptr, nseg, tiles,
// stream: as respa_extend_add_* (kernels/csrc/frontal.cu) before its regimes
#define RESPA_EXTEND_ADD_BEFORE(NAME, A, FTZ)                                                 \
    extern "C" int NAME(int device, void* pool, int64_t g0, int nfronts, int wp, int rp,     \
                        const void* lp, const void* poff, const void* pmp,                    \
                        const void* seg_ptr, int nseg, int tiles, void* stream) {             \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nfronts < 1 || wp < 1 || rp < 1 || nseg < 1 || tiles < 1 || tiles > 65535)       \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(tiles));                 \
        first_k3::extend_add_kernel<A, FTZ><<<grid, first_k3::kAddThreads, 0,                 \
                                              static_cast<cudaStream_t>(stream)>>>(           \
            static_cast<A*>(pool), g0, wp, rp, static_cast<const int32_t*>(lp),               \
            static_cast<const int64_t*>(poff), static_cast<const int32_t*>(pmp),              \
            static_cast<const int32_t*>(seg_ptr));                                            \
        return static_cast<int>(cudaGetLastError());                                          \
    }

RESPA_EXTEND_ADD_BEFORE(respa_extend_add_before_f32, float, false)
RESPA_EXTEND_ADD_BEFORE(respa_extend_add_before_f32_ftz, float, true)
RESPA_EXTEND_ADD_BEFORE(respa_extend_add_before_f64, double, false)

// K8 before it staged a task's pair positions (its first design: a lane
// loads its entry's first two pairs' positions before the wait, then four
// pairs' positions and values at a time; a long entry's words loaded after
// the wait, one entry after the other; K7's hand-over). Kept only to be
// timed beside K8; the same bits on a plan whose long runs it takes whole.
namespace first_k8 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kShort = 32;

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

}  // namespace first_k8

// device, ntasks, warps, tasks, level_ptr, perm, ptr, pairs_a, pairs_b,
// is_lower, diag_col, a, vals, eps, ctl, nctl, stream: as respa_splu_factor_*
// (kernels/csrc/splu.cu) before it staged the positions
#define RESPA_SPLU_FACTOR_BEFORE(SUFFIX, V, A, FTZ)                                              \
    extern "C" int respa_splu_factor_before_##SUFFIX(                                           \
        int device, int ntasks, int warps, const void* tasks, const void* level_ptr,            \
        const void* perm, const void* ptr, const void* pa, const void* pb, const void* is_lower, \
        const void* diag_col, const void* a, void* vals, double eps, void* ctl, int nctl,       \
        void* stream) {                                                                         \
        return first_k8::launch<V, A, FTZ>(device, ntasks, warps, tasks, level_ptr, perm, ptr,  \
                                           pa, pb, is_lower, diag_col, a, vals, eps, ctl, nctl, \
                                           stream);                                             \
    }

RESPA_SPLU_FACTOR_BEFORE(f32, float, float, false)
RESPA_SPLU_FACTOR_BEFORE(f32_ftz, float, float, true)
RESPA_SPLU_FACTOR_BEFORE(bf16, __nv_bfloat16, float, false)
RESPA_SPLU_FACTOR_BEFORE(f64, double, double, false)

// K11 before it took the inverses (its first design: the diagonal block
// staged transposed in shared memory and solved by first_k2's substitution,
// the panels' partial sums of the eight warps added through shared memory
// between two barriers, the mailbox read a word after the other). Kept only to
// be timed beside K11; within the sweep tolerance of its plain version.
namespace first_k2 {  // beside K2's first version, with its helpers

template <typename V, typename A, bool FTZ, bool FWD>
__global__ void __launch_bounds__(kSweepThreads)
band_sweep_t_kernel(int nb, int p, int ml, int mu, const V* __restrict__ band,
                    const A* __restrict__ b, A* __restrict__ out, unsigned* mail) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    A* dblk = reinterpret_cast<A*>(smem_raw);  // the diagonal block transposed, p x (p + 1)
    A* acc = dblk + p * (p + 1);               // p
    A* red = acc + p;                          // the warps' partial sums, kSweepWarps x p
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int64_t w = static_cast<int64_t>(ml + mu + 1) * p;
    const int m = FWD ? mu : ml;  // U^T reaches mu block rows back, L^T ml ahead

    for (int q = blockIdx.x; q < nb; q += gridDim.x) {
        const int r = FWD ? q : nb - 1 - q;
        const V* row = band + static_cast<int64_t>(r) * p * w;
        // dblk[i][k] = D[k][i]: consecutive threads read consecutive i of row k
        for (int e = tid; e < p * p; e += kSweepThreads) {
            const int k = e / p, i = e % p;
            dblk[i * (p + 1) + k] = to_acc(row[k * w + static_cast<int64_t>(ml) * p + i]);
        }

        A part[kColsPerLane];  // entries i = lane + 32 c, over this warp's panel rows
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) part[c] = A(0);
        for (int d = min(m, q); d >= 1; --d) {
            // the block of band row r -/+ d in this row's column, read transposed
            const V* prow = band + static_cast<int64_t>(FWD ? r - d : r + d) * p * w +
                            static_cast<int64_t>(FWD ? ml + d : ml - d) * p;
            V pv[kRowsPerWarp][kColsPerLane];  // asked for before the wait for the vector
#pragma unroll
            for (int kk = 0; kk < kRowsPerWarp; ++kk) {
                const int k = warp + kSweepWarps * kk;
#pragma unroll
                for (int c = 0; c < kColsPerLane; ++c) {
                    const int i = lane + 32 * c;
                    if (k < p && i < p) pv[kk][c] = prow[k * w + i];
                }
            }
            // lane l takes the vector's words l + 32 j; a warp's panel row k comes by a shuffle
            A vv[kColsPerLane];
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j) {
                const int k = lane + 32 * j;
                A x = A(0);
                if (k < p) mail_recv(mail, static_cast<int64_t>(q - d) * p + k, q - d + 1, &x);
                if constexpr (FTZ) x = flush(x);
                vv[j] = x;
            }
#pragma unroll
            for (int kk = 0; kk < kRowsPerWarp; ++kk) {
                const int k = warp + kSweepWarps * kk;  // lane k % 32 holds it in vv[k / 32]
                const A v = __shfl_sync(0xffffffffu, vv[kk / 4], warp + kSweepWarps * (kk % 4));
#pragma unroll
                for (int c = 0; c < kColsPerLane; ++c) {
                    const int i = lane + 32 * c;
                    if (k < p && i < p) part[c] = nmuladd<FTZ>(part[c], -to_acc(pv[kk][c]), v);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
            const int i = lane + 32 * c;
            if (i < p) red[warp * p + i] = part[c];
        }
        __syncthreads();  // dblk and the partials are complete
        if (tid < p) {
            A sum = A(0);
            for (int k = 0; k < kSweepWarps; ++k) sum = add<FTZ>(sum, red[k * p + tid]);
            A rhs = b[static_cast<int64_t>(r) * p + tid];
            if constexpr (FTZ) rhs = flush(rhs);
            acc[tid] = sub<FTZ>(rhs, sum);
        }
        __syncthreads();
        tri_solve<A, FTZ, FWD, !FWD>(dblk, acc, p);
        if (tid < p) {
            const int64_t e = static_cast<int64_t>(q) * p + tid;
            mail_send(mail, e, acc[tid], q + 1);  // first: the next row waits for it
            out[static_cast<int64_t>(r) * p + tid] = acc[tid];
        }
        __syncthreads();  // acc and red are rewritten in the next row
    }
}

template <typename A>
size_t sweep_t_smem(int p) {
    return (static_cast<size_t>(p) * (p + 1) + p + static_cast<size_t>(kSweepWarps) * p) *
           sizeof(A);
}

template <typename V, typename A, bool FTZ, bool FWD>
cudaError_t launch_band_sweep_t(int device, int nb, int p, int ml, int mu, const void* band,
                                const void* b, void* out, void* mail, cudaStream_t stream) {
    auto kernel = band_sweep_t_kernel<V, A, FTZ, FWD>;
    const size_t smem = sweep_t_smem<A>(p);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSweepThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    int grid = (FWD ? mu : ml) + 1;
    if (grid > nb) grid = nb;
    if (grid > sms) grid = sms;
    const V* band_v = static_cast<const V*>(band);
    const A* b_a = static_cast<const A*>(b);
    A* out_a = static_cast<A*>(out);
    unsigned* mail_u = static_cast<unsigned*>(mail);
    void* args[] = {&nb, &p, &ml, &mu, &band_v, &b_a, &out_a, &mail_u};
    // cooperative, as K2: the mailbox waits need every block resident
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                      dim3(kSweepThreads), args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace first_k2

// device, nb, p, ml, mu, band, b, out, mail, stream: as respa_band_sweep_t_*
// (kernels/csrc/band_lu.cu) before it took `inv`
#define RESPA_BAND_SWEEP_T_BEFORE(NAME, V, A, FTZ, FWD)                                       \
    extern "C" int NAME(int device, int nb, int p, int ml, int mu, const void* band,         \
                        const void* b, void* out, void* mail, void* stream) {                 \
        cudaError_t err = cudaSetDevice(device);                                              \
        if (err != cudaSuccess) return static_cast<int>(err);                                 \
        if (nb < 1 || p < 1 || p > first_k2::kMaxP || ml < 1 || mu < 1)                        \
            return static_cast<int>(cudaErrorInvalidValue);                                   \
        return static_cast<int>(first_k2::launch_band_sweep_t<V, A, FTZ, FWD>(               \
            device, nb, p, ml, mu, band, b, out, mail, static_cast<cudaStream_t>(stream)));    \
    }

RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_fwd_f32, float, float, false, true)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_bwd_f32, float, float, false, false)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_fwd_f32_ftz, float, float, true, true)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_bwd_f32_ftz, float, float, true, false)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_fwd_bf16, __nv_bfloat16, float, false, true)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_bwd_bf16, __nv_bfloat16, float, false, false)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_fwd_f64, double, double, false, true)
RESPA_BAND_SWEEP_T_BEFORE(respa_band_sweep_t_before_bwd_f64, double, double, false, false)

// K12 before its own kernels (PR 12's design, kept only to be timed beside
// K12 by `chip_smoke.py --before`): K4's warp, block and wide kernels with
// the front read transposed (TRANS), whose products keep K4's lane map and so
// read down a front's columns. The same arguments, control words and results
// (within the sweep tolerance) as K12.
namespace first_k12 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTri = 128;       // widest pivot block the block regime solves
constexpr int kWarpTri = 32;       // widest pivot block the warp regime solves
constexpr int kSweepThreads = 128; // block regime
constexpr int kWarpFronts = 4;     // warp regime: fronts (warps) a thread block
constexpr int kWideRows = 64;      // wide regime: rows a task
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideRowsPerWarp = kWideRows / kWideWarps;
constexpr int kWidePad = kWideRows + 1;  // shared rows, padded against bank conflicts
constexpr int kAddThreads = 256;
constexpr int kAddPiece = 8;       // extend-add rows past 32: 32-entry runs a warp has in flight
constexpr int kReduceThreads = 256;
constexpr int kThreadRow = 8;      // rows_reduce: most sources a lane sums alone
constexpr int kGroupRow = 64;      // most sources a lane group sums
constexpr int kGroupLanes = 8;
enum Regime { kWarp = 0, kBlock = 1, kWide = 2 };

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

// Offset of entry (row, col) of a front of size mp, or of (col, row) where the
// front is read transposed (K12).
template <bool TRANS>
__device__ __forceinline__ int64_t at(int64_t row, int64_t col, int64_t mp) {
    return TRANS ? col * mp + row : row * mp + col;
}

// A front's diagonal entry at row t, a zero read as one (t < wp).
template <typename A>
__device__ __forceinline__ A diag_or_one(const A* F, int t, int64_t mp) {
    const A d = F[t * mp + t];
    return d == A(0) ? A(1) : d;
}

// Lanes that share one row of a panel product: 8, 16 or 32 by its length.
__device__ __forceinline__ int lanes_for(int len) { return len > 16 ? 32 : (len > 8 ? 16 : 8); }

// Sum over the `g` lanes of a row's lane group (g a power of two <= 32), in a
// fixed tree; the group's first lane gets the total. The whole warp calls it.
template <typename A>
__device__ __forceinline__ A group_sum(A s, int g) {
    for (int off = g >> 1; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off, g);
    return s;
}

// ---------------------------------------------------------------------------
// frontal sweeps: the warp regime
// ---------------------------------------------------------------------------

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_fwd_warp(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
               const int32_t* __restrict__ piv, A* __restrict__ y, int n, A* __restrict__ upd) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarpFronts + (threadIdx.x >> 5);
    if (b >= nf) return;  // whole warps leave together
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int row = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    A l[kWarpTri];  // lane i: row i of L11 (U11^T) left of the diagonal
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c)
        l[c] = c < lane && lane < wp ? F[at<TRANS>(lane, c, mp)] : A(0);
    const A dl = TRANS && lane < wp ? diag_or_one(F, lane, mp) : A(1);
    // upd = -L21 z: g lanes a row on consecutive columns (g >= wp), 32 / g rows a
    // pass; the first kPre passes' values are asked for before the triangle
    constexpr int kPre = 4;
    const int g = lanes_for(wp), ln = lane % g, sub = lane / g, per = 32 / g;
    A pre[kPre];
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int i = q * per + sub;
        pre[q] = i < rp && ln < wp ? F[at<TRANS>(wp + i, ln, mp)] : A(0);
    }
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c) {
        if (c < wp) {
            if (TRANS && lane == c) v = fz<FTZ>(v / dl);  // U^T's diagonal
            if (c + 1 < wp) {  // z[c] is final here
                const A zc = __shfl_sync(kFull, v, c);
                if (lane > c) v = muladd<FTZ>(-l[c], zc, v);
            }
        }
    }
    if (row < n) y[row] = v;
    if (rp == 0) return;
    const A zc = __shfl_sync(kFull, v, ln);
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        const int i = q * per + sub;
        A s = A(0);
        if (i < rp && ln < wp) s = muladd<FTZ>(pre[q], zc, s);
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
#pragma unroll 4
    for (int i0 = kPre * per; i0 < rp; i0 += per) {
        const int i = i0 + sub;
        A s = A(0);
        if (i < rp && ln < wp) s = muladd<FTZ>(F[at<TRANS>(wp + i, ln, mp)], zc, s);
        s = group_sum(s, g);
        if (i < rp && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kWarpFronts * 32)
front_bwd_warp(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
               const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
               A* __restrict__ y, int n) {
    __shared__ A rhs[kWarpFronts][kWarpTri];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * kWarpFronts + w;
    if (b >= nf) return;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    A u[kWarpTri];  // lane i: row i of U11 (L11^T) from the diagonal on, asked for first
#pragma unroll
    for (int c = 0; c < kWarpTri; ++c)
        u[c] = c >= lane && c < wp ? F[at<TRANS>(lane, c, mp)] : A(0);
    // U12 y[rsx]: g lanes a pivot row on consecutive update rows
    const int g = lanes_for(rp), ln = lane % g, sub = lane / g, per = 32 / g;
    for (int i0 = 0; i0 < wp; i0 += per) {
        const int i = i0 + sub;
        A s = A(0);
        if (i < wp) {
            for (int r = ln; r < rp; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(F[at<TRANS>(i, wp + r, mp)], fz<FTZ>(y[row]), s);
            }
        }
        s = group_sum(s, g);
        if (i < wp && ln == 0) rhs[w][i] = s;
    }
    __syncwarp();
    const int row = lane < wp ? piv[static_cast<int64_t>(b) * wp + lane] : n;
    A v = lane < wp ? fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - rhs[w][lane]) : A(0);
#pragma unroll
    for (int c = kWarpTri - 1; c >= 0; --c) {
        if (c < wp) {
            if (!TRANS && lane == c) {  // L11^T has a unit diagonal
                A d = u[c];
                if (d == A(0)) d = A(1);
                v = fz<FTZ>(v / d);
            }
            const A zc = __shfl_sync(kFull, v, c);
            if (lane < c) v = muladd<FTZ>(-u[c], zc, v);
        }
    }
    if (row < n) y[row] = v;
}

// ---------------------------------------------------------------------------
// frontal sweeps: the block regime, a front's panel over gridDim.y tiles
// ---------------------------------------------------------------------------

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kSweepThreads)
front_fwd_block(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                const int32_t* __restrict__ piv, A* __restrict__ y, int n, A* __restrict__ upd,
                int* __restrict__ ticket) {
    __shared__ A z[kMaxTri];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int row = t < wp ? piv[static_cast<int64_t>(b) * wp + t] : n;
    A v = row < n ? fz<FTZ>(y[row]) : A(0);
    const A dt = TRANS && t < wp ? diag_or_one(F, t, mp) : A(1);  // U^T's diagonal
    if (TRANS && t == 0) v = fz<FTZ>(v / dt);
    if (t < wp) z[t] = v;
    __syncthreads();
    if (tiles > 1) {
        // a tile draws its ticket once it has read y[piv]: the last to draw writes y[piv]
        if (t == 0) {
            last = atomicAdd(ticket + b, 1) == tiles - 1;
        }
        __syncthreads();
    }
    for (int c = 0; c + 1 < wp; ++c) {  // z[c] is final here
        if (t > c && t < wp) v = muladd<FTZ>(-F[at<TRANS>(t, c, mp)], z[c], v);
        if (t == c + 1) {
            if (TRANS) v = fz<FTZ>(v / dt);
            z[t] = v;
        }
        __syncthreads();
    }
    if (row < n && (tiles == 1 || last)) y[row] = v;
    if (rp == 0) return;
    // this tile's rows of upd = -L21 z, g lanes a row
    const int chunk = (rp + tiles - 1) / tiles;
    const int i_end = min(rp, static_cast<int>(blockIdx.y + 1) * chunk);
    const int g = lanes_for(wp);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    for (int base = static_cast<int>(blockIdx.y) * chunk; base < i_end; base += per_pass) {
        const int i = base + sub;
        A s = A(0);
        if (i < i_end) {
            for (int w = ln; w < wp; w += g) s = muladd<FTZ>(F[at<TRANS>(wp + i, w, mp)], z[w], s);
        }
        s = group_sum(s, g);
        if (i < i_end && ln == 0) upd[static_cast<int64_t>(b) * rp + i] = fz<FTZ>(-s);
    }
}

template <typename A, bool FTZ, bool TRANS>
__global__ void __launch_bounds__(kSweepThreads)
front_bwd_block(const A* __restrict__ pool, int64_t g0, int wp, int rp,
                const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                A* __restrict__ y, int n, A* __restrict__ part, int* __restrict__ ticket) {
    __shared__ A z[kMaxTri];
    __shared__ int last;
    const int b = blockIdx.x, t = threadIdx.x, tiles = gridDim.y, tile = blockIdx.y;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    const int32_t* pv = piv + static_cast<int64_t>(b) * wp;
    const int32_t* rs = rsx + static_cast<int64_t>(b) * rp;
    // this tile's update rows r0 .. r1 - 1 of U12 y[rsx], a lane group a pivot row
    const int chunk = (rp + tiles - 1) / tiles;
    const int r0 = tile * chunk, r1 = min(rp, r0 + chunk);
    const int g = lanes_for(chunk);
    const int per_pass = kSweepThreads / g;
    const int sub = t / g, ln = t % g;
    for (int base = 0; base < wp; base += per_pass) {
        const int i = base + sub;
        A s = A(0);
        if (i < wp) {
            for (int r = r0 + ln; r < r1; r += g) {
                const int row = rs[r];
                if (row < n) s = muladd<FTZ>(F[at<TRANS>(i, wp + r, mp)], fz<FTZ>(y[row]), s);
            }
        }
        s = group_sum(s, g);
        if (i < wp && ln == 0) {
            if (tiles > 1) {
                part[(static_cast<int64_t>(b) * tiles + tile) * wp + i] = s;
            } else {
                const int row = pv[i];
                z[i] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
            }
        }
    }
    if (tiles > 1) {
        // the tile that draws the last ticket sums the partials in tile order
        __threadfence();
        __syncthreads();
        if (t == 0) {
            last = atomicAdd(ticket + b, 1) == tiles - 1;
        }
        __syncthreads();
        if (!last) return;
        __threadfence();
        if (t < wp) {
            A s = A(0);
            for (int k = 0; k < tiles; ++k)
                s = fz<FTZ>(s + __ldcg(part + (static_cast<int64_t>(b) * tiles + k) * wp + t));
            const int row = pv[t];
            z[t] = fz<FTZ>((row < n ? fz<FTZ>(y[row]) : A(0)) - s);
        }
    }
    __syncthreads();
    A v = t < wp ? z[t] : A(0);
    for (int c = wp - 1; c >= 0; --c) {
        if (t == c) {
            if (!TRANS) v = fz<FTZ>(v / diag_or_one(F, t, mp));  // L11^T: unit
            z[c] = v;
        }
        __syncthreads();
        if (t < c) v = muladd<FTZ>(-F[at<TRANS>(t, c, mp)], z[c], v);
    }
    if (t < wp) {
        const int row = pv[t];
        if (row < n) y[row] = v;
    }
}

// ---------------------------------------------------------------------------
// frontal sweeps: the wide regime, blocked substitution by ticketed tasks
// ---------------------------------------------------------------------------

// The mailbox: every 32-bit word of a solved value travels with the tag kTag
// (a zeroed word carries 0) in one 8-byte store, which the card performs as a whole, so a reader
// that sees the tag has the word. A double is two such pairs. A reader that
// is not next in the chain sleeps between polls; one that spins for seconds
// traps instead of hanging.
constexpr unsigned kSpinLimit = 1u << 26;
constexpr unsigned kTag = 1;

__device__ __forceinline__ void mail_put(unsigned* slot, unsigned word, unsigned tag) {
    asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(slot), "r"(word), "r"(tag)
                 : "memory");
}

// The words of the N slots with `live` set, once every one carries `tag`; the
// slots are read together, so a lane waits one trip for all of them.
template <int N>
__device__ __forceinline__ void mail_get_all(const unsigned* const (&slot)[N],
                                             const bool (&live)[N], unsigned tag,
                                             bool patient, unsigned (&word)[N]) {
    unsigned spins = 0;
    while (true) {
        bool all = true;
#pragma unroll
        for (int q = 0; q < N; ++q) {
            unsigned seen = tag;
            if (live[q])
                asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
                             : "=r"(word[q]), "=r"(seen)
                             : "l"(slot[q])
                             : "memory");
            all = all && seen == tag;
        }
        if (all) return;
        if (++spins > kSpinLimit) __trap();
        if (patient) __nanosleep(256);
    }
}

__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, float v, unsigned tag) {
    mail_put(mail + 2 * e, __float_as_uint(v), tag);
}
__device__ __forceinline__ void mail_send(unsigned* mail, int64_t e, double v, unsigned tag) {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(v));
    mail_put(mail + 4 * e, static_cast<unsigned>(bits), tag);
    mail_put(mail + 4 * e + 2, static_cast<unsigned>(bits >> 32), tag);
}

// z[c] and z[c + 32] for one lane (0 past wp), waited for together.
__device__ __forceinline__ void mail_recv_pair(const unsigned* mail, int c, int wp, unsigned tag,
                                               bool patient, float* z) {
    const unsigned* const slot[2] = {mail + 2 * c, mail + 2 * (c + 32)};
    const bool live[2] = {c < wp, c + 32 < wp};
    unsigned w[2] = {0u, 0u};
    mail_get_all(slot, live, tag, patient, w);
    z[0] = live[0] ? __uint_as_float(w[0]) : 0.0f;
    z[1] = live[1] ? __uint_as_float(w[1]) : 0.0f;
}
__device__ __forceinline__ void mail_recv_pair(const unsigned* mail, int c, int wp, unsigned tag,
                                               bool patient, double* z) {
    const unsigned* const slot[4] = {mail + 4 * c, mail + 4 * c + 2, mail + 4 * (c + 32),
                                     mail + 4 * (c + 32) + 2};
    const bool live[4] = {c < wp, c < wp, c + 32 < wp, c + 32 < wp};
    unsigned w[4] = {0u, 0u, 0u, 0u};
    mail_get_all(slot, live, tag, patient, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const unsigned long long lo = w[2 * h], hi = w[2 * h + 1];
        z[h] = live[2 * h] ? __longlong_as_double(static_cast<long long>(lo | (hi << 32))) : 0.0;
    }
}

// The wide regime's sums: fp64 for the fp32 instance (a circuit's wide fronts
// amplify rounding, and a long chain summed in fp32 in another order than
// the library's stood up to 10x further from the exact result than the
// library's did); z is still rounded to the pool's type as it is solved. The
// FTZ instance flushes every fp32 partial sum; fp64 sums in fp64.
template <typename A, bool FTZ>
using WideAcc = std::conditional_t<FTZ || sizeof(A) == 8, A, double>;

// sum over k in [k0, k1) of m[k] * x[k], in four partials (k - k0 taken mod 4,
// then (p0 + p1) + (p2 + p3)), each product and sum flushed under FTZ: the
// order is fixed by k0 and k1, and a 64-term product is no 64-step chain.
template <bool FTZ, typename Acc, typename M, typename Z>
__device__ __forceinline__ Acc dot4(const M* m, const Z* x, int xs, int k0, int k1) {
    Acc p0 = Acc(0), p1 = Acc(0), p2 = Acc(0), p3 = Acc(0);
    int k = k0;
    for (; k + 3 < k1; k += 4) {
        p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k * xs]), p0);
        p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[(k + 1) * xs]), p1);
        p2 = muladd<FTZ>(Acc(m[k + 2]), Acc(x[(k + 2) * xs]), p2);
        p3 = muladd<FTZ>(Acc(m[k + 3]), Acc(x[(k + 3) * xs]), p3);
    }
    if (k < k1) p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k * xs]), p0);
    if (k + 1 < k1) p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[(k + 1) * xs]), p1);
    if (k + 2 < k1) p2 = muladd<FTZ>(Acc(m[k + 2]), Acc(x[(k + 2) * xs]), p2);
    return fz<FTZ>(fz<FTZ>(p0 + p1) + fz<FTZ>(p2 + p3));
}

// m[16q .. 16q + 16) . x[16q .. 16q + 16) in two partials, then summed over the four
// threads q of a row (adjacent lanes) by a butterfly that gives all four the same bits.
template <bool FTZ, typename Acc, typename M, typename Z>
__device__ __forceinline__ Acc quarter_dot(const M* m, const Z* x, int q) {
    Acc p0 = Acc(0), p1 = Acc(0);
#pragma unroll
    for (int k = 16 * q; k < 16 * q + 16; k += 2) {
        p0 = muladd<FTZ>(Acc(m[k]), Acc(x[k]), p0);
        p1 = muladd<FTZ>(Acc(m[k + 1]), Acc(x[k + 1]), p1);
    }
    Acc s = fz<FTZ>(p0 + p1);
    s = fz<FTZ>(s + __shfl_xor_sync(kFull, s, 1));
    return fz<FTZ>(s + __shfl_xor_sync(kFull, s, 2));
}

// One task of a wide front: rows r0 .. r0 + nrows - 1 of front b. A triangle
// task (row block `blk`) solves its 64 unknowns; a forward panel task forms
// its 64 rows of upd. ctl[0] is the ticket.
// Before any wait a triangle task inverts its diagonal block (a thread a
// column, in Acc) and loads the two blocks beside it, so that once the z block
// solved just before its own arrives, the block takes it through two 64 x 64
// products in shared memory, four threads a row, and publishes.
template <typename A, bool FTZ, bool FWD, bool TRANS>
__global__ void __launch_bounds__(kWideThreads)
front_wide_kernel(const A* __restrict__ pool, int64_t g0, int nf, int wp, int rp,
                  const int32_t* __restrict__ piv, const int32_t* __restrict__ rsx,
                  A* __restrict__ y, int n, A* __restrict__ upd, int* __restrict__ ctl,
                  unsigned* __restrict__ mail, unsigned tag) {
    using Acc = WideAcc<A, FTZ>;
    constexpr bool kUnit = FWD != TRANS;  // L11 forward, L11^T backward
    extern __shared__ __align__(16) unsigned char wide_smem[];
    Acc* X = reinterpret_cast<Acc*>(wide_smem);  // the diagonal block's inverse
    A* S1 = reinterpret_cast<A*>(X + kWideRows * kWidePad);  // the block solved just before
    A* S2 = S1 + kWideRows * kWidePad;  // the diagonal block, then the block before S1
    __shared__ A zs[2][kWideRows];      // the z block being streamed
    __shared__ A zn[kWideRows];         // a z block beside the diagonal
    __shared__ Acc acc[kWideRows];
    __shared__ Acc rhs[kWideRows];
    __shared__ Acc rcp[kWideRows];      // non-unit: 1 / the diagonal (0 read as 1)
    __shared__ A yp[kWideRows];
    __shared__ int task;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nrb = (wp + kWideRows - 1) / kWideRows;
    if (t == 0) task = atomicAdd(ctl, 1);
    __syncthreads();
    const int b = task % nf, step = task / nf;
    const int64_t mp = wp + rp;
    const A* F = pool + g0 + b * mp * mp;
    unsigned* mb = mail + static_cast<int64_t>(b) * wp * (sizeof(A) / 2);
    const bool panel = FWD && step >= nrb;
    const int blk = FWD ? step : nrb - 1 - step;  // a triangle task's row block
    const int r0 = panel ? wp + (step - nrb) * kWideRows : blk * kWideRows;
    const int nrows = min(kWideRows, (panel ? wp + rp : wp) - r0);
    const int n1 = FWD ? blk - 1 : blk + 1;  // the z block solved just before this one
    const int n2 = FWD ? blk - 2 : blk + 2;  // and the one before that
    const bool has1 = !panel && n1 >= 0 && n1 < nrb;
    const bool has2 = !panel && n2 >= 0 && n2 < nrb;

    if (!panel) {
        if (t < kWideRows) {
            const int row = t < nrows ? piv[static_cast<int64_t>(b) * wp + r0 + t] : n;
            yp[t] = row < n ? fz<FTZ>(y[row]) : A(0);
            if (!kUnit) {
                const A d = t < nrows ? F[static_cast<int64_t>(r0 + t) * mp + r0 + t] : A(0);
                rcp[t] = Acc(1) / (d == A(0) ? Acc(1) : Acc(d));
            }
        }
        for (int e = t; e < kWideRows * kWideRows; e += kWideThreads) {
            // consecutive threads read along the front's rows either way
            const int i = TRANS ? e % kWideRows : e / kWideRows;
            const int c = TRANS ? e / kWideRows : e % kWideRows;
            const bool tri = FWD ? c < i : c > i;
            S2[i * kWidePad + c] =
                i < nrows && c < nrows && tri ? F[at<TRANS>(r0 + i, r0 + c, mp)] : A(0);
            const int c1 = n1 * kWideRows + c;
            S1[i * kWidePad + c] =
                i < nrows && has1 && c1 < wp ? F[at<TRANS>(r0 + i, c1, mp)] : A(0);
        }
        __syncthreads();
        if (t < kWideRows) {  // column t of the inverse: unit lower, or upper times 1/d
            Acc* x = X + t;
            for (int ii = 0; ii < kWideRows; ++ii) {
                const int i = FWD ? ii : kWideRows - 1 - ii;
                const int k0 = FWD ? t : i + 1, k1 = FWD ? i : t + 1;  // the solved rows
                const Acc v = fz<FTZ>(Acc(i == t) - dot4<FTZ, Acc>(S2 + i * kWidePad, x,
                                                                  kWidePad, k0, k1));
                x[i * kWidePad] = kUnit ? v : fz<FTZ>(v * rcp[i]);
            }
        }
        __syncthreads();
        for (int e = t; e < kWideRows * kWideRows; e += kWideThreads) {
            const int i = TRANS ? e % kWideRows : e / kWideRows;
            const int c = TRANS ? e / kWideRows : e % kWideRows;
            const int c2 = n2 * kWideRows + c;
            S2[i * kWidePad + c] =
                i < nrows && has2 && c2 < wp ? F[at<TRANS>(r0 + i, c2, mp)] : A(0);
        }
    }

    // stream this warp's rows against every other block of columns, in a fixed order
    Acc part[kWideRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kWideRowsPerWarp; ++j) part[j] = Acc(0);
    const int rw = warp * kWideRowsPerWarp;
    const int64_t rows0 = r0 + rw;  // this warp's first row
    if (!FWD) {  // U12 y[rsx], known from the start; kSpan columns' loads in flight at once
        constexpr int kSpan = sizeof(A) == 4 ? 8 : 4;  // columns a lane takes an iteration
        for (int c0 = 0; c0 < rp; c0 += 32 * kSpan) {
            Acc x[kSpan];
            A lv[kWideRowsPerWarp][kSpan];
#pragma unroll
            for (int h = 0; h < kSpan; ++h) {
                const int c = c0 + lane + 32 * h;
                const int row = c < rp ? rsx[static_cast<int64_t>(b) * rp + c] : n;
                x[h] = row < n ? Acc(fz<FTZ>(y[row])) : Acc(0);
#pragma unroll
                for (int j = 0; j < kWideRowsPerWarp; ++j)
                    lv[j][h] =
                        rw + j < nrows && c < rp ? F[at<TRANS>(rows0 + j, wp + c, mp)] : A(0);
            }
#pragma unroll
            for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
                for (int h = 0; h < kSpan; ++h) part[j] = muladd<FTZ>(Acc(lv[j][h]), x[h], part[j]);
            }
        }
    }
    // forward: column blocks 0 .. blk - 3 (a panel task: all); backward: nrb - 1 .. blk + 3
    const int nstream = panel ? nrb : (FWD ? max(blk - 2, 0) : max(nrb - blk - 3, 0));
    for (int s = 0; s < nstream; ++s) {
        const int kb = FWD ? s : nrb - 1 - s;
        const int c0 = kb * kWideRows;
        // a block far from this task's own is not on the chain's path: poll it at leisure
        const bool patient = panel ? kb < nrb - 2 : (FWD ? kb < blk - 4 : kb > blk + 4);
        A lv[kWideRowsPerWarp][2];  // asked for before the wait for z
#pragma unroll
        for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = c0 + lane + 32 * h;
                lv[j][h] = rw + j < nrows && c < wp ? F[at<TRANS>(rows0 + j, c, mp)] : A(0);
            }
        }
        if (warp == 0) {
            A z[2];
            mail_recv_pair(mb, c0 + lane, wp, tag, patient, z);
            zs[s & 1][lane] = z[0];
            zs[s & 1][lane + 32] = z[1];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kWideRowsPerWarp; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                part[j] = muladd<FTZ>(Acc(lv[j][h]), Acc(zs[s & 1][lane + 32 * h]), part[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kWideRowsPerWarp; ++j) {
        const Acc s = group_sum(part[j], 32);
        if (lane == 0) acc[rw + j] = s;
    }
    __syncthreads();

    if (panel) {
        if (t < nrows) upd[static_cast<int64_t>(b) * rp + (r0 - wp) + t] = fz<FTZ>(A(-acc[t]));
    } else {
        // the whole block finishes the rows, four threads a row on 16 columns each: the two
        // blocks beside the diagonal as their z arrive (warp 0 takes them from the mailbox),
        // then z = X rhs; the four partials are summed in a fixed butterfly
        const int r = t >> 2, q = t & 3;
        Acc v = r < nrows ? fz<FTZ>(Acc(yp[r]) - acc[r]) : Acc(0);
        for (int near = 2; near >= 1; --near) {
            if (!(near == 2 ? has2 : has1)) continue;
            if (warp == 0) {
                A z[2];
                mail_recv_pair(mb, (near == 2 ? n2 : n1) * kWideRows + lane, wp, tag, false, z);
                zn[lane] = z[0];
                zn[lane + 32] = z[1];
            }
            __syncthreads();
            const A* M = near == 2 ? S2 : S1;
            v = fz<FTZ>(v - quarter_dot<FTZ, Acc>(M + r * kWidePad, zn, q));
            __syncthreads();  // zn is read before the next block overwrites it
        }
        if (q == 0) rhs[r] = v;
        __syncthreads();
        const A zr = A(quarter_dot<FTZ, Acc>(X + r * kWidePad, rhs, q));
        if (q == 0 && r < nrows) {
            mail_send(mb, r0 + r, zr, tag);
            const int row = piv[static_cast<int64_t>(b) * wp + r0 + r];
            if (row < n) y[row] = zr;
        }
    }
}

bool bad_group(int nfronts, int wp, int rp) { return nfronts < 1 || wp < 1 || rp < 0; }

// The wide kernel's dynamic shared memory: the inverse and the two blocks beside it.
template <typename A, bool FTZ>
constexpr size_t wide_smem_bytes() {
    return kWideRows * kWidePad * (sizeof(WideAcc<A, FTZ>) + 2 * sizeof(A));
}

template <typename A, bool FTZ, bool TRANS>
int sweep_fwd(int device, const A* pool, int64_t g0, int nf, int wp, int rp, const int32_t* piv,
              A* y, int n, A* upd, int regime, int tiles, int* ctl, unsigned* mail,
              cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bad_group(nf, wp, rp) || tiles < 1 || tiles > 65535 ||
        (regime == kWarp && (wp > kWarpTri || tiles != 1)) ||
        (regime == kBlock && wp > kMaxTri) || (regime == kWide && tiles != 1) ||
        regime < kWarp || regime > kWide)
        return static_cast<int>(cudaErrorInvalidValue);
    if (regime == kWarp) {
        const unsigned blocks = static_cast<unsigned>((nf + kWarpFronts - 1) / kWarpFronts);
        front_fwd_warp<A, FTZ, TRANS><<<blocks, kWarpFronts * 32, 0, stream>>>(
            pool, g0, nf, wp, rp, piv, y, n, upd);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        front_fwd_block<A, FTZ, TRANS><<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv,
                                                                          y, n, upd, ctl);
    } else {
        const size_t smem = wide_smem_bytes<A, FTZ>();
        err = cudaFuncSetAttribute(front_wide_kernel<A, FTZ, true, TRANS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const int64_t tasks = static_cast<int64_t>(nf) *
            ((wp + kWideRows - 1) / kWideRows + (rp + kWideRows - 1) / kWideRows);
        if (tasks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
        front_wide_kernel<A, FTZ, true, TRANS><<<static_cast<unsigned>(tasks), kWideThreads, smem,
                                                 stream>>>(pool, g0, nf, wp, rp, piv, nullptr, y,
                                                           n, upd, ctl, mail, kTag);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename A, bool FTZ, bool TRANS>
int sweep_bwd(int device, const A* pool, int64_t g0, int nf, int wp, int rp, const int32_t* piv,
              const int32_t* rsx, A* y, int n, A* part, int regime, int tiles, int* ctl,
              unsigned* mail, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bad_group(nf, wp, rp) || tiles < 1 || tiles > 65535 ||
        (regime == kWarp && (wp > kWarpTri || tiles != 1)) ||
        (regime == kBlock && (wp > kMaxTri || (tiles > 1 && rp < tiles))) ||
        (regime == kWide && tiles != 1) || regime < kWarp || regime > kWide)
        return static_cast<int>(cudaErrorInvalidValue);
    if (regime == kWarp) {
        const unsigned blocks = static_cast<unsigned>((nf + kWarpFronts - 1) / kWarpFronts);
        front_bwd_warp<A, FTZ, TRANS><<<blocks, kWarpFronts * 32, 0, stream>>>(
            pool, g0, nf, wp, rp, piv, rsx, y, n);
    } else if (regime == kBlock) {
        dim3 grid(static_cast<unsigned>(nf), static_cast<unsigned>(tiles));
        front_bwd_block<A, FTZ, TRANS><<<grid, kSweepThreads, 0, stream>>>(pool, g0, wp, rp, piv,
                                                                          rsx, y, n, part, ctl);
    } else {
        const size_t smem = wide_smem_bytes<A, FTZ>();
        err = cudaFuncSetAttribute(front_wide_kernel<A, FTZ, false, TRANS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const int64_t tasks = static_cast<int64_t>(nf) * ((wp + kWideRows - 1) / kWideRows);
        if (tasks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
        front_wide_kernel<A, FTZ, false, TRANS><<<static_cast<unsigned>(tasks), kWideThreads,
                                                  smem, stream>>>(pool, g0, nf, wp, rp, piv, rsx,
                                                                  y, n, nullptr, ctl, mail, kTag);
    }
    return static_cast<int>(cudaGetLastError());
}


}  // namespace first_k12

// device, pool, g0, nfronts, wp, rp, piv, rsx, y, n, out, regime, tiles, ctl,
// mail, stream: as respa_front_sweep_t_* (kernels/csrc/frontal.cu)
#define RESPA_FRONT_SWEEP_T_BEFORE(SUFFIX, A, FTZ)                                            \
    extern "C" int respa_front_sweep_t_before_fwd_##SUFFIX(                                   \
        int device, const void* pool, int64_t g0, int nfronts, int wp, int rp,                \
        const void* piv, const void* rsx, void* y, int n, void* out, int regime, int tiles,   \
        void* ctl, void* mail, void* stream) {                                                \
        (void)rsx;                                                                            \
        return first_k12::sweep_fwd<A, FTZ, true>(                                            \
            device, static_cast<const A*>(pool), g0, nfronts, wp, rp,                         \
            static_cast<const int32_t*>(piv), static_cast<A*>(y), n, static_cast<A*>(out),    \
            regime, tiles, static_cast<int*>(ctl), static_cast<unsigned*>(mail),              \
            static_cast<cudaStream_t>(stream));                                               \
    }                                                                                         \
    extern "C" int respa_front_sweep_t_before_bwd_##SUFFIX(                                   \
        int device, const void* pool, int64_t g0, int nfronts, int wp, int rp,                \
        const void* piv, const void* rsx, void* y, int n, void* out, int regime, int tiles,   \
        void* ctl, void* mail, void* stream) {                                                \
        return first_k12::sweep_bwd<A, FTZ, true>(                                            \
            device, static_cast<const A*>(pool), g0, nfronts, wp, rp,                         \
            static_cast<const int32_t*>(piv), static_cast<const int32_t*>(rsx),               \
            static_cast<A*>(y), n, static_cast<A*>(out), regime, tiles,                       \
            static_cast<int*>(ctl), static_cast<unsigned*>(mail),                             \
            static_cast<cudaStream_t>(stream));                                               \
    }

RESPA_FRONT_SWEEP_T_BEFORE(f32, float, false)
RESPA_FRONT_SWEEP_T_BEFORE(f32_ftz, float, true)
RESPA_FRONT_SWEEP_T_BEFORE(f64, double, false)
