// Measurements that chip_smoke.py makes beside the package's kernels, built
// with them into a library of their own, which the package never loads:
//   respa_dia_design_addend_f32  the other design of the DIA SpMV's remainder
//                                (K9), timed against the package's (phase 12);
//   respa_l2_read_probe          the card's L2 read rate, which K8's value
//                                gathers are set against (phase 10);
//   respa_barrier_probe          one block's barrier with a shared-memory
//                                hand-over, K1's step a pivot, which its chain
//                                of 128 pivots is set against (phase 6).
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
