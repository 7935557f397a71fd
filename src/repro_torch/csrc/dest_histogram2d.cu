// dest_histogram2d: per-row destination histogram, (L, q) int32 -> (L, n_bins) int32.
//
// Replaces the Pallas kernel repro/kernels/chunk_router/chunk_router.py
// dest_histogram2d_kernel (body _hist2d_kernel, one-hot reduction
// _block_counts): counts[r, b] = #{j : dest[r, j] == b}; values outside
// [0, n_bins) -- the exchange plan's invalid-request sentinel -- are counted
// nowhere.
//
// Bound on an H100: the kernel reads L*q*4 bytes and writes L*n_bins*4.  At
// the planner's shapes (L = 32 nodes, q = 8 requests, n_bins = 33) that is
// about 5 KB, so the launch latency, not memory or arithmetic, bounds it.
//
// Design: one block per row.  The block zeroes a shared-memory bin array of
// n_bins int32, its threads stride over the row's q values and atomicAdd in
// shared memory (skipping out-of-range values), then write the bins out.
// Integer counts are exact whatever order the atomics land in, so the result
// is deterministic and equals the plain version bit for bit.  The TPU
// kernel's (q, n_bins) one-hot block is not carried over: on this card it
// would cost q*n_bins compares per row where the atomics cost q adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void dest_histogram2d_kernel(const int32_t* __restrict__ dest,
                                        int32_t* __restrict__ counts,
                                        int q, int n_bins) {
    extern __shared__ int32_t bins[];
    const int64_t row = blockIdx.x;
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    const int32_t* in = dest + row * q;
    for (int j = threadIdx.x; j < q; j += blockDim.x) {
        const int32_t d = in[j];
        if (d >= 0 && d < n_bins) atomicAdd(&bins[d], 1);
    }
    __syncthreads();
    int32_t* out = counts + row * n_bins;
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) out[b] = bins[b];
}

}  // namespace

// dest: (L, q) int32, counts: (L, n_bins) int32, both contiguous on the card.
extern "C" int dest_histogram2d(const void* dest, void* counts, int L, int q,
                                int n_bins, void* stream) {
    if (L <= 0 || n_bins <= 0) return 0;
    const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            dest_histogram2d_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = 32;
    const int widest = q > n_bins ? q : n_bins;
    while (threads < widest && threads < 256) threads *= 2;
    dest_histogram2d_kernel<<<L, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest), static_cast<int32_t*>(counts), q,
        n_bins);
    return static_cast<int>(cudaGetLastError());
}
