// dest_histogram: destination histogram of one flat vector, (n,) int32 -> (n_bins,) int32.
//
// Replaces the Pallas kernel repro/kernels/chunk_router/chunk_router.py
// dest_histogram_kernel (body _hist_kernel, one-hot reduction
// _block_counts): counts[b] = #{i : dest[i] == b}; values outside
// [0, n_bins) -- the exchange plan's -1 sentinel, and the TPU wrapper's -1
// block padding -- are counted nowhere.
//
// Bound on an H100: the kernel reads 4n bytes and writes 4*n_bins.  At the
// shape it is run at (the 45,884 chunk destinations of one gemma3-1b
// checkpoint save into 32 nodes: 183 KB, 0.055 us at 3.35 TB/s) one
// launch's latency, not HBM, bounds it, so the design does as little as it
// can in one launch.  At 16 M values (64 MB, 20 us) HBM bounds it.
//
// Two paths, picked by n on the host:
//
// Cluster path (n <= cluster_max_n and n_bins <= 12288): one thread-block
// cluster of CLUSTER blocks of CLUSTER_THREADS threads, one launch, no
// memset, no scratch.  Each block zeroes its shared bins, reads its share of
// the input with 16-byte loads where the base is 16-byte aligned (4-byte
// loads otherwise), LOADS of them in flight a thread before it counts, and
// counts into its one copy of the bins in shared memory with atomics.
// After cluster.sync() block r adds its slice of the bins over all blocks
// of the cluster through distributed shared memory (map_shared_rank) and
// writes it to counts directly; a last cluster.sync() keeps every block's
// shared memory alive until all have read it.  Most of the kernel's time
// is the cluster's launch and its two barriers, not the counting: a copy
// of the bins per warp, tried to keep lanes of different warps off one
// bin, was no faster, so a block keeps one copy.  Blocks of 1024 threads
// with two loads each keep as many bytes in flight as 512 with four and
// count with twice the threads.  Measured by chip_smoke.py on an H100
// 80GB HBM3 at 700 W (device time): 3.22 us at the save's 45,884 values
// into 32 bins in one launch (8 x 512 threads, four loads: 3.25), against
// 4.52 us for the grid path below and 20.2 us for bincount; 4.13 us at
// 131,072 values (8 x 512: 4.42; grid: 4.96).  The cluster reads with 8
// SMs only, so from ~200 K values on the grid path is faster (4.88
// against 5.42 us at 262,144): the wrapper's CLUSTER_MAX_N.
// CLUSTER_THREADS and LOADS may be set with -D to build another block
// shape for timing beside this one (chip_smoke.py does).
//
// Grid path (larger n, or more bins than one block's 48 KB): the earlier
// design, kept for the inputs where more SMs pay: the entry point zeroes
// counts with cudaMemsetAsync, then a grid-stride loop of blocks of 256
// threads, sized so a thread reads about ITEMS values (at most two blocks
// an SM), counts into a shared-memory bin array, and adds its non-zero bins
// into counts with atomicAdd.  Above 48 KiB of bins (n_bins > 12288) the
// shared array needs the opt-in of cudaFuncSetAttribute.
//
// Integer counts are exact whatever order the atomics land in, so both
// paths are deterministic and equal the plain version bit for bit.  The
// TPU kernel's (block, n_bins) one-hot matrix and its per-block partials
// summed outside the kernel are not carried over: on this card they would
// cost n*n_bins compares where the atomics cost n adds, and blocks here run
// in parallel, so they fold their bins through shared memory or atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#ifndef CLUSTER_THREADS
#define CLUSTER_THREADS 1024
#endif
#ifndef LOADS
#define LOADS 2                            // 16-byte loads a thread batches
#endif

constexpr int CLUSTER = 8;                 // blocks of the one cluster
constexpr int SMEM_BINS = 48 * 1024 / 4;   // int32 bins in 48 KB
constexpr int THREADS = 256;
constexpr int ITEMS = 16;                   // values a thread reads
constexpr long long MAX_BLOCKS = 2 * 132;   // two blocks per H100 SM

__device__ __forceinline__ void count(int32_t* bins, int32_t d, int n_bins) {
    if (d >= 0 && d < n_bins) atomicAdd(&bins[d], 1);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(CLUSTER_THREADS)
dest_histogram_cluster_kernel(const int32_t* __restrict__ dest, long long n,
                              int32_t* __restrict__ counts, int n_bins) {
    extern __shared__ int32_t bins[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int b = threadIdx.x; b < n_bins; b += CLUSTER_THREADS) bins[b] = 0;
    __syncthreads();
    const long long tid = static_cast<long long>(rank) * CLUSTER_THREADS +
                          threadIdx.x;
    const long long stride = static_cast<long long>(CLUSTER) * CLUSTER_THREADS;
    long long done = 0;
    if ((reinterpret_cast<uintptr_t>(dest) & 15) == 0) {
        // LOADS 16-byte loads in flight a thread before it counts any: at
        // the save's 45,884 values one round covers the input, so the
        // block waits on memory once
        const long long n4 = n / 4;
        const int4* v = reinterpret_cast<const int4*>(dest);
        for (long long j0 = tid; j0 < n4; j0 += LOADS * stride) {
            int4 q[LOADS];
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const long long j = j0 + u * stride;
                q[u] = j < n4 ? v[j] : make_int4(-1, -1, -1, -1);
            }
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                count(bins, q[u].x, n_bins);
                count(bins, q[u].y, n_bins);
                count(bins, q[u].z, n_bins);
                count(bins, q[u].w, n_bins);
            }
        }
        done = 4 * n4;
    }
    for (long long i = done + tid; i < n; i += stride)
        count(bins, dest[i], n_bins);
    cluster.sync();                         // every block's bins are final
    const int per = (n_bins + CLUSTER - 1) / CLUSTER;
    const int b1 = min(n_bins, (rank + 1) * per);
    for (int b = rank * per + threadIdx.x; b < b1; b += CLUSTER_THREADS) {
        int32_t s = 0;
        for (int r = 0; r < CLUSTER; ++r)
            s += cluster.map_shared_rank(bins, r)[b];
        counts[b] = s;
    }
    cluster.sync();                         // no block leaves while read
}

__global__ void __launch_bounds__(THREADS)
dest_histogram_kernel(const int32_t* __restrict__ dest, long long n,
                      int32_t* __restrict__ counts, int n_bins) {
    extern __shared__ int32_t bins[];
    for (int b = threadIdx.x; b < n_bins; b += THREADS) bins[b] = 0;
    __syncthreads();
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
         i < n; i += stride)
        count(bins, dest[i], n_bins);
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += THREADS) {
        const int32_t c = bins[b];
        if (c) atomicAdd(&counts[b], c);
    }
}

}  // namespace

// dest: (n,) int32, counts: (n_bins,) int32, both contiguous on the card.
// n <= cluster_max_n (and n_bins <= 12288) takes the one-cluster path.
extern "C" int dest_histogram(const void* dest, void* counts, long long n,
                              int n_bins, long long cluster_max_n,
                              void* stream) {
    if (n_bins <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= cluster_max_n && n_bins <= SMEM_BINS) {
        dest_histogram_cluster_kernel<<<CLUSTER, CLUSTER_THREADS,
                                        sizeof(int32_t) * n_bins, s>>>(
            static_cast<const int32_t*>(dest), n,
            static_cast<int32_t*>(counts), n_bins);
        return static_cast<int>(cudaGetLastError());
    }
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
