// Diagonal-format (DIA) SpMV for stencil matrices (K9).
//
// Replaces respatpu/kernels/dia.py _dia_spmv_single and its double-float twin
// _dia_spmv_df (a sum of shifted slices of a zero-padded x, unrolled by XLA):
//
//     y_i = sum_k d[k, i] * x[i + off_k]  (+ r_i)
//
// over the stored diagonals in ascending offset order, from +0, with x read as
// 0 outside its columns (a rectangular matrix reads x[:ncols]); r_i is the
// remainder's row i (the entries on no stored diagonal), summed here too: its
// products one after the other in CSR order from +0, as the CSR kernel K0 sums
// a row among short rows, and added last. Every product and sum is rounded on
// its own (no fused multiply-add), so the result equals dia_spmv_plain bit
// for bit.
//
// What bounds it on this card: bytes. The diagonals are read once, ndiag x n
// values and no index stream; x and y once each (x's slices overlap and come
// from L2); the remainder as compact CSR over the rows that have entries
// (their row numbers, slices, columns and values). One thread a row, a block a
// tile of kThreads rows, so a warp's reads of each diagonal and of each slice
// of x are contiguous; the offsets sit in shared memory. A tile with
// remainder rows (tile_ptr gives them, ascending) maps each one onto its
// thread through shared memory; that thread sums it. The other design, the
// remainder's product by K0 and then added by this kernel, walks all n rows'
// pointers for the remainder's few entries; it is kept for timing in
// bench/csrc/smoke_probes.cu, and its time is in PERF.md.
//
// Instances: f32; f32_ftz (x, every product, partial sum and the result
// flushed to zero); bf16 (bf16 values, x, sums and y fp32: the port's
// bf16 policy, where respatpu's DIA rounds x to bf16 and sums in bf16); f64.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // rows a tile: the remainder's tile_ptr is cut for it
constexpr int kMaxDiags = 512;  // build_dia keeps at most this many

// a diagonal's value, read once: loaded evict-first, which leaves L2 to x
template <typename V>
__device__ __forceinline__ V once(const V* p) { return __ldcs(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 once(const __nv_bfloat16* p) {
    return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// x[c] as a product reads it: 0 outside the columns, flushed under FTZ
template <typename A, bool FTZ>
__device__ __forceinline__ A x_at(const A* __restrict__ x, int64_t c, int64_t ncols) {
    return (c >= 0 && c < ncols) ? fz<FTZ>(x[c]) : A(0);
}

// The compact remainder: rows[r] its r-th row (ascending), ptr[r] .. ptr[r + 1]
// that row's columns and values; tile_ptr[t] its first row at or after tile t.
template <typename V>
struct Remainder {
    const int32_t* __restrict__ tile_ptr;  // null: no remainder
    const int32_t* __restrict__ rows;
    const int64_t* __restrict__ ptr;
    const int32_t* __restrict__ cols;
    const V* __restrict__ vals;
};

// V: the stored value type; A: x, the sums and y (fp32 for bf16).
template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(int64_t n, int64_t ncols, int ndiag, const int64_t* __restrict__ offsets,
                const V* __restrict__ diags, const A* __restrict__ x, Remainder<V> rem,
                A* __restrict__ y) {
    __shared__ int64_t off[kMaxDiags];
    __shared__ int32_t slot[kThreads];
    for (int k = threadIdx.x; k < ndiag; k += kThreads) off[k] = offsets[k];
    __syncthreads();
    const int64_t tiles = (n + kThreads - 1) / kThreads;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int64_t i0 = t * kThreads;
        const int64_t i = i0 + threadIdx.x;
        A s = A(0);
        if (i < n)
            for (int k = 0; k < ndiag; ++k)
                s = fz<FTZ>(add(s, fz<FTZ>(mul(widen(once(diags + k * n + i)),
                                               x_at<A, FTZ>(x, i + off[k], ncols)))));
        const int r0 = rem.tile_ptr != nullptr ? rem.tile_ptr[t] : 0;
        const int r1 = rem.tile_ptr != nullptr ? rem.tile_ptr[t + 1] : 0;
        if (r1 > r0) {  // the same for the whole block
            slot[threadIdx.x] = -1;
            __syncthreads();
            for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
                slot[rem.rows[r] - i0] = r;
            __syncthreads();
            const int r = slot[threadIdx.x];
            if (r >= 0) {
                A rs = A(0);
                for (int64_t e = rem.ptr[r]; e < rem.ptr[r + 1]; ++e)
                    rs = fz<FTZ>(add(rs, fz<FTZ>(mul(widen(rem.vals[e]),
                                                     x_at<A, FTZ>(x, rem.cols[e], ncols)))));
                s = fz<FTZ>(add(s, rs));
            }
            __syncthreads();  // slot is read before the next tile writes it
        }
        if (i < n) __stcs(y + i, s);
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int64_t n, int64_t ncols, int ndiag, const void* offsets,
           const void* diags, const void* x, int tile, const void* tile_ptr, const void* rows,
           const void* ptr, const void* cols, const void* vals, void* y, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1 || ncols < 0 || ndiag < 0 || ndiag > kMaxDiags || tile != kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65535 * 16 ? want : 65535 * 16);
    const Remainder<V> rem{static_cast<const int32_t*>(tile_ptr), static_cast<const int32_t*>(rows),
                           static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(cols),
                           static_cast<const V*>(vals)};
    dia_spmv_kernel<V, A, FTZ><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n, ncols, ndiag, static_cast<const int64_t*>(offsets), static_cast<const V*>(diags),
        static_cast<const A*>(x), rem, static_cast<A*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: every function selects `device`, launches on `stream` and
// returns the cudaError_t of the launch as an int (0 = launched). Pointers are
// device pointers: `offsets` int64[ndiag] ascending; `diags` V[ndiag][n]
// (diags[k][i] = A[i, i + offsets[k]], 0 where that is no entry); `x` A[ncols];
// `y` A[n] written (A = fp32, fp64 for f64). ndiag is at most 512. The
// remainder, or five nulls: `tile_ptr` int32[ceil(n / tile) + 1], `rows`
// int32[] ascending, `ptr` int64[rows + 1], `cols` int32[] and `vals` V[];
// `tile` is the rows a tile_ptr entry covers and must be the kernel's (256).
extern "C" {

#define RESPA_DIA_SPMV(SUFFIX, V, A, FTZ)                                                      \
    int respa_dia_spmv_##SUFFIX(int device, int64_t n, int64_t ncols, int ndiag,               \
                                const void* offsets, const void* diags, const void* x,         \
                                int tile, const void* tile_ptr, const void* rows,              \
                                const void* ptr, const void* cols, const void* vals, void* y,  \
                                void* stream) {                                                \
        return launch<V, A, FTZ>(device, n, ncols, ndiag, offsets, diags, x, tile, tile_ptr,   \
                                 rows, ptr, cols, vals, y, stream);                            \
    }

RESPA_DIA_SPMV(f32, float, float, false)
RESPA_DIA_SPMV(f32_ftz, float, float, true)
RESPA_DIA_SPMV(bf16, __nv_bfloat16, float, false)
RESPA_DIA_SPMV(f64, double, double, false)

}  // extern "C"
