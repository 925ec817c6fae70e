// CSR SpMV, y = A x, by row-block streaming, for Hopper (sm_90a).
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
// and does 2*nnz flops, far below the card's flop/byte balance. What a
// kernel loses against that bound on this card is latency and idle lanes:
// the chain row pointer -> column index -> x gather must be kept in flight
// many times over per SM, with all 32 lanes of a warp on the two big
// streams (columns and values, 75-85% of the bytes).
//
// Design (CSR-stream, after Greathouse and Daga, SC14). The wrapper uploads,
// beside the matrix, `row_blocks`: consecutive rows grouped on the host so
// that a group holds at most kCap entries and at most kMaxRows rows; a row
// longer than kCap is a group of its own. One thread block takes one group.
//   stream: the block's entries are one contiguous range of `indices` and
//     `vals`. Thread t takes entries t, t+kThreads, ..., kPerThread of them,
//     whatever the row boundaries are: every lane is busy, every load is
//     coalesced, and a thread has kPerThread independent column and value
//     loads, then kPerThread independent gathers of x, in flight (an fp64
//     thread takes them in two batches of kF64Batch = 4, which keeps it at 40
//     registers, as the fp32 instances, and so six blocks on an SM, not four).
//     The products go to shared memory. The row pointer is read once per block,
//     coalesced, and kept in shared memory as offsets into the products.
//   reduce: with L = the largest power of two <= kThreads / rows (<= 32),
//     L lanes sum a row's products from shared memory: lane l takes entries
//     l, l+L, ... in order, then a __shfl_xor_sync tree over the L lanes.
//     FEM-like blocks (many short rows) get a thread per row, blocks of few
//     long rows a sub-warp or a warp per row. A row that is more than
//     kSerialMax * L long among short ones (a circuit's hub row) is left out
//     and then summed by the whole warp its lanes belong to, so that it does
//     not sit on one thread. L and that choice depend on the row lengths alone.
//   long rows (> kCap entries): the whole block strides over the row with
//     per-thread partial sums, then a fixed shared-memory tree.
// Every sum's order is fixed by the matrix; there are no atomics, so the
// result is bitwise the same from run to run (the determinism
// gsell_df.py:27-29 documents). Empty rows write 0.
//
// kCap = kThreads * kPerThread = 256 * 8 = 2048: 8 loads a thread of each
// stream keep about 16 KB a block in flight, the products take 8 KB (fp32)
// or 16 KB (fp64) of shared memory, six blocks stay resident on an SM, and
// the catalogue's matrices still give 400-2000 blocks for 132 SMs. On an
// H100 (bench/spmv_tune.py, PERF.md) 4 entries a thread were 12% slower on
// the FEM stand-ins in fp32, 16 no faster and far slower in fp64 (98
// registers), and 128 or 512 threads with 8 entries within 2% of 256.
// kMaxRows = kThreads lets the reduce take every row of a block at once.
//
// The RESPA_SPMV_* macros exist for bench/spmv_tune.py, which builds other
// sizes and two measurement variants; the package builds the defaults.
//
// FTZ instance: nvcc compiles with -ftz=false, so the flush is explicit:
// x on load, each product before it is stored and each partial sum of the
// reduce. Products and sums are rounded separately (__fmul_rn/__fadd_rn) so
// that no fused multiply-add skips the flush of the product. Values were
// flushed at upload.

#include "common.cuh"

#ifndef RESPA_SPMV_THREADS
#define RESPA_SPMV_THREADS 256
#endif
#ifndef RESPA_SPMV_PER_THREAD
#define RESPA_SPMV_PER_THREAD 8
#endif
#ifndef RESPA_SPMV_F64_BATCH
#define RESPA_SPMV_F64_BATCH 4
#endif

namespace {

constexpr int kThreads = RESPA_SPMV_THREADS;
constexpr int kPerThread = RESPA_SPMV_PER_THREAD;
constexpr int kF64Batch = RESPA_SPMV_F64_BATCH;  // loads a thread keeps in flight, fp64
constexpr int kCap = kThreads * kPerThread;  // entries of a streamed block
constexpr int kMaxRows = kThreads;           // rows of a block: one reduce pass
constexpr int kSerialMax = 32;               // entries a lane sums before a row counts as wide
constexpr int kLongUnroll = 4;

static_assert(kPerThread % kF64Batch == 0, "an fp64 thread loads its entries in whole batches");
static_assert(kThreads >= 32 && kThreads <= 1024 && (kThreads & (kThreads - 1)) == 0,
              "kThreads must be a power of two in [32, 1024]");

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <bool FTZ, typename A>
__device__ __forceinline__ A load_x(const A* __restrict__ x, int32_t col) {
    if constexpr (FTZ) {
        return flush(__ldg(x + col));
    } else {
        return __ldg(x + col);
    }
}

template <bool FTZ, typename A>
__device__ __forceinline__ A mul(A a, A b) {
    if constexpr (FTZ) {
        return flush(__fmul_rn(a, b));
    } else {
        return a * b;
    }
}

template <bool FTZ, typename A>
__device__ __forceinline__ A add(A a, A b) {
    if constexpr (FTZ) {
        return flush(__fadd_rn(a, b));
    } else {
        return a + b;
    }
}

// Sum of prod[s + lane], prod[s + lane + lanes], ... (in that order) over the
// `lanes` lanes of an aligned group, by a shuffle tree. Every thread of the
// warp must call it with the same `lanes`; the total is in every lane.
template <bool FTZ, typename A>
__device__ __forceinline__ A row_sum(const A* prod, int s, int e, int lane, int lanes) {
    A sum = 0;
#pragma unroll 4
    for (int k = s + lane; k < e; k += lanes) sum = add<FTZ>(sum, prod[k]);
    for (int off = lanes >> 1; off > 0; off >>= 1)
        sum = add<FTZ>(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    return sum;
}

template <typename V, typename A, bool FTZ>
__global__ void __launch_bounds__(kThreads)
spmv_csr_stream(const int32_t* __restrict__ row_blocks, const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices, const V* __restrict__ vals,
                const A* __restrict__ x, A* __restrict__ y) {
    __shared__ A prod[kCap];
    __shared__ int32_t row_off[kMaxRows + 1];
    const int tid = threadIdx.x;
    const int32_t r0 = row_blocks[blockIdx.x];
    const int rows = row_blocks[blockIdx.x + 1] - r0;
    const int64_t e0 = indptr[r0];
    const int64_t e1 = indptr[r0 + rows];

    if (e1 - e0 > kCap) {
        // A long row (the partition gives it a block of its own).
        A sum = 0;
        int64_t k = e0 + tid;
        for (; k + (kLongUnroll - 1) * kThreads < e1; k += kLongUnroll * kThreads) {
            int32_t col[kLongUnroll];
            V v[kLongUnroll];
            A xv[kLongUnroll];
#pragma unroll
            for (int j = 0; j < kLongUnroll; ++j) {
                col[j] = indices[k + j * kThreads];
                v[j] = vals[k + j * kThreads];
            }
#pragma unroll
            for (int j = 0; j < kLongUnroll; ++j) xv[j] = load_x<FTZ>(x, col[j]);
#pragma unroll
            for (int j = 0; j < kLongUnroll; ++j)
                sum = add<FTZ>(sum, mul<FTZ>(to_acc(v[j]), xv[j]));
        }
        for (; k < e1; k += kThreads)
            sum = add<FTZ>(sum, mul<FTZ>(to_acc(vals[k]), load_x<FTZ>(x, indices[k])));
        prod[tid] = sum;
        __syncthreads();
        for (int s = kThreads / 2; s > 0; s >>= 1) {
            if (tid < s) prod[tid] = add<FTZ>(prod[tid], prod[tid + s]);
            __syncthreads();
        }
        if (tid == 0) y[r0] = prod[0];
        return;
    }

    // Stream: products of the block's entries into shared memory.
    const int cnt = static_cast<int>(e1 - e0);
    for (int r = tid; r <= rows; r += kThreads)
        row_off[r] = static_cast<int32_t>(indptr[r0 + r] - e0);
    constexpr int kBatch = sizeof(A) == 8 ? kF64Batch : kPerThread;
#pragma unroll 1
    for (int j0 = 0; j0 < kPerThread; j0 += kBatch) {
        int32_t col[kBatch];
        V v[kBatch];
        A xv[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int k = tid + (j0 + j) * kThreads;
            if (k < cnt) {
                col[j] = indices[e0 + k];
                v[j] = vals[e0 + k];
#ifdef RESPA_SPMV_PROBE_X01
                // Measurement build of bench/spmv_tune.py: every gather goes to
                // x[0] or x[1], so that what the gathers cost shows as a difference.
                col[j] &= 1;
#endif
            }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int k = tid + (j0 + j) * kThreads;
            if (k < cnt) xv[j] = load_x<FTZ>(x, col[j]);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int k = tid + (j0 + j) * kThreads;
            if (k < cnt) prod[k] = mul<FTZ>(to_acc(v[j]), xv[j]);
        }
    }
    __syncthreads();
#ifdef RESPA_SPMV_STREAM_ONLY
    // Measurement build of bench/spmv_tune.py, never the package's: stop after
    // the stream phase (one product per row keeps its loads alive), so that
    // the reduce phase's share of the time can be read as a difference.
    if (tid < rows) y[r0 + tid] = cnt ? prod[row_off[tid] < cnt ? row_off[tid] : 0] : A(0);
    return;
#endif

    // Reduce: L lanes per row, every row of the block at once.
    int lanes = 32;
    while (lanes > 1 && rows * lanes > kThreads) lanes >>= 1;
    const int wide_from = lanes < 32 ? kSerialMax * lanes : kCap;
    const int r = tid / lanes;
    const int lane = tid & (lanes - 1);
    int s = 0, e = 0;
    if (r < rows) {
        s = row_off[r];
        e = row_off[r + 1];
    }
    const bool wide = e - s > wide_from;
    const A sum = row_sum<FTZ>(prod, s, wide ? s : e, lane, lanes);
    if (r < rows && lane == 0 && !wide) y[r0 + r] = sum;
    // The wide rows among this warp's rows, one after the other, each by the
    // whole warp.
    const int warp_lane = tid & 31;
    unsigned todo = __ballot_sync(0xffffffffu, wide && lane == 0);
    while (todo) {
        const int src = __ffs(todo) - 1;  // the lane that holds the row's bounds
        todo &= todo - 1;
        const int ws = __shfl_sync(0xffffffffu, s, src);
        const int we = __shfl_sync(0xffffffffu, e, src);
        const A wsum = row_sum<FTZ>(prod, ws, we, warp_lane, 32);
        if (warp_lane == 0) y[r0 + (tid + src) / lanes] = wsum;
    }
}

template <typename V, typename A, bool FTZ>
int launch(int device, int n_blocks, const void* row_blocks, const void* indptr,
           const void* indices, const void* vals, const void* x, void* y, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    spmv_csr_stream<V, A, FTZ><<<static_cast<unsigned>(n_blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row_blocks), static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices), static_cast<const V*>(vals),
        static_cast<const A*>(x), static_cast<A*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device pointer;
// `row_blocks` is int32[n_blocks + 1], the first row of each block and the
// row count last, cut by the wrapper for respa_spmv_csr_cap() entries and
// respa_spmv_csr_max_rows() rows a block; `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 = ok). The kernel allocates
// nothing and does not synchronise.
extern "C" {

int respa_spmv_csr_cap() { return kCap; }
int respa_spmv_csr_max_rows() { return kMaxRows; }

int respa_spmv_csr_f32(int device, int n_blocks, const void* row_blocks, const void* indptr,
                       const void* indices, const void* vals, const void* x, void* y,
                       void* stream) {
    return launch<float, float, false>(device, n_blocks, row_blocks, indptr, indices, vals, x, y,
                                       stream);
}

int respa_spmv_csr_f32_ftz(int device, int n_blocks, const void* row_blocks, const void* indptr,
                           const void* indices, const void* vals, const void* x, void* y,
                           void* stream) {
    return launch<float, float, true>(device, n_blocks, row_blocks, indptr, indices, vals, x, y,
                                      stream);
}

int respa_spmv_csr_bf16(int device, int n_blocks, const void* row_blocks, const void* indptr,
                        const void* indices, const void* vals, const void* x, void* y,
                        void* stream) {
    return launch<__nv_bfloat16, float, false>(device, n_blocks, row_blocks, indptr, indices, vals,
                                               x, y, stream);
}

int respa_spmv_csr_f64(int device, int n_blocks, const void* row_blocks, const void* indptr,
                       const void* indices, const void* vals, const void* x, void* y,
                       void* stream) {
    return launch<double, double, false>(device, n_blocks, row_blocks, indptr, indices, vals, x, y,
                                         stream);
}

}  // extern "C"
