// dest_histogram: destination histogram of one flat vector, (n,) int32 -> (n_bins,) int32.
//
// Replaces the Pallas kernel repro/kernels/chunk_router/chunk_router.py
// dest_histogram_kernel (body _hist_kernel, one-hot reduction
// _block_counts): counts[b] = #{i : dest[i] == b}; values outside
// [0, n_bins) -- the exchange plan's -1 sentinel, and the TPU wrapper's -1
// block padding -- are counted nowhere.
//
// Bound on an H100: the kernel reads 4n bytes and writes 4*n_bins.  At the
// shapes it is run at (the 45,770 chunk destinations of one gemma3-1b
// checkpoint save into 32 nodes: 183 KB, 0.05 us at 3.35 TB/s) the launch
// latency, not HBM, bounds it.
//
// Design: a grid-stride loop of blocks of 256 threads, the grid sized so a
// thread reads about ITEMS values (at most two blocks per SM).  Each block
// zeroes a shared-memory bin array of n_bins int32, adds its values into
// it with shared atomics (skipping
// out-of-range values), then adds its non-zero bins into the global counts
// with atomicAdd.  The entry point zeroes counts with cudaMemsetAsync on the
// same stream first.  Integer counts are exact whatever order the atomics
// land in, so the result is deterministic and equals the plain version bit
// for bit.  The TPU kernel's (block, n_bins) one-hot matrix and its
// per-block partials summed outside the kernel are not carried over: on
// this card they would cost n*n_bins compares where the atomics cost n adds,
// and blocks here run in parallel, so they fold their bins with atomics.
// Above 48 KiB of bins (n_bins > 12288) the shared array needs the opt-in
// of cudaFuncSetAttribute, as in dest_histogram2d.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                   // values a thread reads
constexpr long long MAX_BLOCKS = 2 * 132;   // two blocks per H100 SM

__global__ void __launch_bounds__(THREADS)
dest_histogram_kernel(const int32_t* __restrict__ dest, long long n,
                      int32_t* __restrict__ counts, int n_bins) {
    extern __shared__ int32_t bins[];
    for (int b = threadIdx.x; b < n_bins; b += THREADS) bins[b] = 0;
    __syncthreads();
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
         i < n; i += stride) {
        const int32_t d = dest[i];
        if (d >= 0 && d < n_bins) atomicAdd(&bins[d], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += THREADS) {
        const int32_t c = bins[b];
        if (c) atomicAdd(&counts[b], c);
    }
}

}  // namespace

// dest: (n,) int32, counts: (n_bins,) int32, both contiguous on the card.
extern "C" int dest_histogram(const void* dest, void* counts, long long n,
                              int n_bins, void* stream) {
    if (n_bins <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_bins, s);
    if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
    const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(dest_histogram_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    long long blocks = (n + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    dest_histogram_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
        static_cast<const int32_t*>(dest), n, static_cast<int32_t*>(counts),
        n_bins);
    return static_cast<int>(cudaGetLastError());
}
