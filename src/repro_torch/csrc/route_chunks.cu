// route_chunks: per-descriptor destination node plus a per-destination
// histogram; route_chunks_segmented: the destinations of every chunk of a
// whole checkpoint (all its leaves) in one launch.
//
// Replaces the Pallas kernel repro/kernels/chunk_router/chunk_router.py
// route_chunks_kernel (body _router_kernel, hash mix_hash_i32).  For each of
// n descriptors (path_hash, chunk_id, client), all int32:
//
//     dest = client                                 for modes 1 and 4
//     dest = mix(path_hash, chunk_id) % n_nodes     otherwise (modes 2, 3)
//
// and counts[b] = #{i : dest[i] == b} for b in [0, n_nodes); a dest outside
// that range (a client rank past the node count) is counted nowhere, as in
// the TPU kernel's one-hot block.  mix is the FNV-style mix of
// layouts.mix_hash: h = 0x811C9DC5; per part h = ((h ^ part) * 16777619)
// mod 2^32, masked to 31 bits, h ^= h >> 15; finally masked to 31 bits.
// The TPU kernel runs it in int32 (a wrapping multiply and a signed shift of
// a non-negative value); here it is uint32, the same bits.  The TPU kernel
// pads n to whole blocks and marks pad rows -1 so they count nowhere; here
// threads past n write nothing and count nothing, and dest is exactly (n,).
//
// Bound on an H100: 12n bytes read and 4n + 4*n_nodes written, a handful of
// integer ops per descriptor.  At the checkpoint store's shapes (one leaf,
// n <= 4608 chunks) that is tens of KB, so the launch latency bounds it.
//
// Design: one thread per descriptor, 256 to a block.  Each block zeroes a
// shared-memory histogram of n_nodes bins, counts its descriptors into it
// with shared atomics, then adds its non-zero bins to counts with global
// atomics (as dest_histogram2d.cu does per row).  counts is zeroed on the
// stream first.  Integer counts are exact in any order, so the result is
// deterministic and equals the plain version bit for bit.
//
// route_chunks_segmented routes a whole save (or restore) at once.  Its
// input is a leaf table, L rows of (path_hash, mode, first): the hash of
// the leaf's path, the layout mode for that path and the index of the
// leaf's first chunk among all n chunks (first[0] = 0, non-decreasing).
// For chunk i of the concatenation, with leaf l the last row whose
// first <= i:
//
//     chunk_id = i - first[l],  client = chunk_id mod n_nodes
//     dest[i]  = client                                   modes 1 and 4
//     dest[i]  = mix(path_hash[l], chunk_id) % n_nodes    modes 2 and 3
//
// exactly route_chunks_kernel's destination for the leaf's own descriptors
// (the checkpoint manager's chunk_id, cid mod n_nodes), with no counts.
// Bound: 12L bytes read and 4n written; at a gemma3-1b save (251 leaves,
// 45,884 chunks) that is 187 KB, 0.06 us at HBM rate, so one launch's
// latency bounds it.  What it removes is the host's cost of a launch per
// leaf.  Design: one thread per chunk, 256 to a block; each block copies
// the L offsets to shared memory (4L bytes, opted in above 48 KB) and each
// thread finds its leaf by binary search there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t mix_hash(int32_t a, int32_t b) {
    uint32_t h = 0x811C9DC5u;
    const uint32_t parts[2] = {static_cast<uint32_t>(a),
                               static_cast<uint32_t>(b)};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        h = (h ^ parts[k]) * 16777619u;
        h &= 0x7FFFFFFFu;
        h ^= h >> 15;
    }
    return h & 0x7FFFFFFFu;
}

__global__ void __launch_bounds__(THREADS)
route_chunks_kernel(const int32_t* __restrict__ path_hash,
                    const int32_t* __restrict__ chunk_id,
                    const int32_t* __restrict__ client,
                    int32_t* __restrict__ dest, int32_t* __restrict__ counts,
                    int64_t n, int mode, int n_nodes) {
    extern __shared__ int32_t bins[];
    for (int b = threadIdx.x; b < n_nodes; b += THREADS) bins[b] = 0;
    __syncthreads();
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i < n) {
        int32_t d;
        if (mode == 1 || mode == 4) {
            d = client[i];
        } else {
            d = static_cast<int32_t>(mix_hash(path_hash[i], chunk_id[i]) %
                                     static_cast<uint32_t>(n_nodes));
        }
        dest[i] = d;
        if (d >= 0 && d < n_nodes) atomicAdd(&bins[d], 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < n_nodes; b += THREADS) {
        const int32_t c = bins[b];
        if (c) atomicAdd(&counts[b], c);
    }
}

__global__ void __launch_bounds__(THREADS)
route_chunks_segmented_kernel(const int32_t* __restrict__ leaves, int n_leaves,
                              int32_t* __restrict__ dest, int64_t n,
                              int n_nodes) {
    extern __shared__ int32_t first[];
    for (int l = threadIdx.x; l < n_leaves; l += THREADS)
        first[l] = leaves[3 * l + 2];
    __syncthreads();
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= n) return;
    int lo = 0, hi = n_leaves - 1;     // the last l with first[l] <= i
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (first[mid] <= i) lo = mid;
        else hi = mid - 1;
    }
    const int32_t cid = static_cast<int32_t>(i - first[lo]);
    const int mode = leaves[3 * lo + 1];
    int32_t d;
    if (mode == 1 || mode == 4) {
        d = cid % n_nodes;
    } else {
        d = static_cast<int32_t>(mix_hash(leaves[3 * lo], cid) %
                                 static_cast<uint32_t>(n_nodes));
    }
    dest[i] = d;
}

}  // namespace

// path_hash, chunk_id, client, dest: (n,) int32; counts: (n_nodes,) int32.
// All contiguous on the card.
extern "C" int route_chunks(const void* path_hash, const void* chunk_id,
                            const void* client, void* dest, void* counts,
                            long long n, int mode, int n_nodes,
                            void* stream) {
    if (n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_nodes, s);
    if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
    const size_t smem = static_cast<size_t>(n_nodes) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(route_chunks_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    route_chunks_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
        static_cast<const int32_t*>(path_hash),
        static_cast<const int32_t*>(chunk_id),
        static_cast<const int32_t*>(client), static_cast<int32_t*>(dest),
        static_cast<int32_t*>(counts), n, mode, n_nodes);
    return static_cast<int>(cudaGetLastError());
}

// leaves: (n_leaves, 3) int32 rows (path_hash, mode, first); dest: (n,)
// int32.  Both contiguous on the card; n_leaves >= 1.
extern "C" int route_chunks_segmented(const void* leaves, int n_leaves,
                                      void* dest, long long n, int n_nodes,
                                      void* stream) {
    if (n_nodes <= 0 || n_leaves <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = static_cast<size_t>(n_leaves) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            route_chunks_segmented_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    route_chunks_segmented_kernel<<<static_cast<unsigned>(blocks), THREADS,
                                    smem, s>>>(
        static_cast<const int32_t*>(leaves), n_leaves,
        static_cast<int32_t*>(dest), n, n_nodes);
    return static_cast<int>(cudaGetLastError());
}
