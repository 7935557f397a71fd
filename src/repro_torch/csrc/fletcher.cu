// fletcher: position-weighted checksums of consecutive chunks of int32 words;
// fletcher_segmented: the checksums of every chunk of a whole checkpoint (all
// its leaves) in one launch.
//
// Replaces the Pallas kernel repro/kernels/fletcher/fletcher.py
// fletcher_kernel (body _fletcher_kernel).  Chunk c covers words
// [c*chunk_words, min((c+1)*chunk_words, n)) and gets, with P = 46337 and
// positions restarting at 1 in every chunk,
//
//     s1 = sum(|w_i| mod P)                      mod P
//     s2 = sum((|w_i| mod P) * (pos_i mod P) mod P)  mod P
//
// out[c] = (s1, s2) as int32.  |w| is taken as an unsigned 32-bit value, so
// |INT_MIN| = 2^31 exactly: this equals the int64 oracle fletcher_ref that
// the checkpoint manager uses on every word.  (The Pallas body takes abs in
// int32, where abs(INT_MIN) stays negative, so it disagrees with the oracle
// on the word 0x80000000, the bits of float -0.0.)  One chunk over the whole
// array is the Pallas kernel's (n,) -> (2,) checksum.
//
// Bound on an H100: every word is read once (4n bytes, n_chunks*8 bytes
// written), so HBM bounds it: a 12 GB train state takes at least 3.6 ms at
// 3.35 TB/s.  The arithmetic is a few 32-bit ops a word: the modulus by the
// constant P compiles to a multiply-high and a subtract, and each thread
// advances its position residue by an add and a compare, not a division.
//
// Design: blockIdx.x is the chunk and blockIdx.y a slice of SLICE words
// within it, so a checkpoint chunk (65536 words) is one block, and one long
// chunk still spreads over many SMs.  Each thread strides over its slice
// with 16-byte loads where the slice start is 16-byte aligned (checkpoint
// chunks always are), 4-byte loads otherwise, and keeps its two sums in
// 64-bit registers (a 65536-word chunk sums to ~3e9, past int32).  A
// warp-shuffle then shared-memory reduction gives the slice's partial sums;
// a second kernel adds the slices of each chunk and reduces mod P.  Sums of
// integers are exact in any order, so the result is deterministic and equal
// to the plain version bit for bit.  The TPU kernel's sequential grid with
// a per-block int32 partial is not carried over: blocks here run in
// parallel, so partials go to scratch and the second kernel folds them.

// fletcher_segmented checksums a whole save (or one group of leaves of a
// restore) at once.  Its input is a leaf table, L rows of int64 (words
// pointer, n_words, first): the leaf's words on the card, their count and
// the index of the leaf's first chunk among all chunks (first[0] = 0,
// first[l+1] = first[l] + max(1, ceil(n_words / chunk_words)), so an empty
// leaf keeps its one (0, 0) chunk).  out[first[l] + c] is chunk c of leaf l,
// exactly fletcher's for that leaf.  Bound on an H100: as above, HBM; a
// gemma3-1b save (12 GB in 251 leaves, 45,884 chunks) takes at least
// 3.58 ms.  What it removes is two launches and two allocations a leaf
// (fletcher's partial and fold kernels: 502 launches a save) and the host's
// work between them, which held the 250 small leaves to ~0.4 of the bound.
// Design: one block of 256 threads per chunk (chunk_words <= SLICE, so one
// block covers it and no fold or scratch is needed).  Warp 0 finds the
// chunk's leaf with a 32-way search over the first-chunk column (each lane
// tests one probe, a ballot picks the last that is <= the chunk: two rounds
// of loads for 1024 leaves, against ten of a binary search), then the block
// reads the chunk with 16-byte loads where its base is 16-byte aligned, 4-byte
// loads otherwise.  No residue is reduced inside the loop: with positions
// p <= 65536 and |w| <= 2^31, s1 = sum |w| < 2^47 and s2 = sum |w| * p <=
// 2^31 * 65536 * 65537 / 2 < 2^63 fit in 64 bits, and sum |w| * p is sum
// (|w| mod P)(p mod P) mod P.  So a word costs an abs, a 64-bit add and one
// wide multiply-add; the block then reduces its two sums and takes them mod P
// once.  Sums of integers are exact in any order: bit for bit the plain
// version.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 3.79 ms
// a save, 0.95 of the bound, against 7.70 ms for the 251 per-leaf calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t P = 46337u;
constexpr int THREADS = 256;
constexpr int64_t SLICE = 1 << 16;           // words per block

__device__ __forceinline__ uint32_t absmod(int32_t w) {
    const uint32_t a = w < 0 ? 0u - static_cast<uint32_t>(w)
                             : static_cast<uint32_t>(w);
    return a % P;
}

// Adds one word at a position whose residue mod P is pm (pm < P).
__device__ __forceinline__ void add_word(int32_t w, uint32_t pm,
                                         unsigned long long& s1,
                                         unsigned long long& s2) {
    const uint32_t a = absmod(w);
    s1 += a;
    s2 += (a * pm) % P;                       // a, pm < P, a*pm < 2^31
}

// (pm + k) mod P for pm < P and k < P, without a division.
__device__ __forceinline__ uint32_t wrap(uint32_t pm, uint32_t k) {
    const uint32_t q = pm + k;
    return q >= P ? q - P : q;
}

__global__ void __launch_bounds__(THREADS)
fletcher_partial_kernel(const int32_t* __restrict__ words, int64_t n,
                        int64_t chunk_words,
                        unsigned long long* __restrict__ partial) {
    const int64_t chunk = blockIdx.x;
    const int64_t slice = blockIdx.y;
    const int64_t c0 = chunk * chunk_words;
    int64_t c1 = c0 + chunk_words;
    if (c1 > n) c1 = n;
    int64_t lo = c0 + slice * SLICE;
    int64_t hi = lo + SLICE;
    if (hi > c1) hi = c1;
    unsigned long long s1 = 0, s2 = 0;
    if (lo < hi) {
        const int64_t len = hi - lo;
        const int32_t* base = words + lo;
        const int64_t pos0 = lo - c0 + 1;     // position of base[0]
        int64_t done = 0;
        if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
            // thread t reads words 4j..4j+3 for j = t, t+THREADS, ...: the
            // position residue advances by 4*THREADS (< P) per iteration
            const int64_t n4 = len / 4;
            const int4* v = reinterpret_cast<const int4*>(base);
            uint32_t pm = static_cast<uint32_t>((pos0 + 4 * threadIdx.x) % P);
            for (int64_t j = threadIdx.x; j < n4; j += THREADS) {
                const int4 q = v[j];
                add_word(q.x, pm, s1, s2);
                add_word(q.y, wrap(pm, 1), s1, s2);
                add_word(q.z, wrap(pm, 2), s1, s2);
                add_word(q.w, wrap(pm, 3), s1, s2);
                pm = wrap(pm, 4 * THREADS);
            }
            done = 4 * n4;
        }
        uint32_t pm = static_cast<uint32_t>((pos0 + done + threadIdx.x) % P);
        for (int64_t j = done + threadIdx.x; j < len; j += THREADS) {
            add_word(base[j], pm, s1, s2);
            pm = wrap(pm, THREADS);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
        s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    __shared__ unsigned long long w1[THREADS / 32], w2[THREADS / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        w1[warp] = s1;
        w2[warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long t1 = 0, t2 = 0;
        for (int k = 0; k < THREADS / 32; ++k) {
            t1 += w1[k];
            t2 += w2[k];
        }
        unsigned long long* out = partial + (chunk * gridDim.y + slice) * 2;
        out[0] = t1;
        out[1] = t2;
    }
}

__global__ void fletcher_fold_kernel(
    const unsigned long long* __restrict__ partial,
    int64_t n_chunks, int64_t slices, int32_t* __restrict__ out) {
    const int64_t chunk = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
    if (chunk >= n_chunks) return;
    unsigned long long t1 = 0, t2 = 0;
    const unsigned long long* p = partial + chunk * slices * 2;
    for (int64_t s = 0; s < slices; ++s) {
        t1 += p[2 * s];
        t2 += p[2 * s + 1];
    }
    out[2 * chunk] = static_cast<int32_t>(t1 % P);
    out[2 * chunk + 1] = static_cast<int32_t>(t2 % P);
}

// (s1, s2) of the chunk at base[0 .. len), positions 1..len, without any
// reduction mod P: both fit in 64 bits for len <= SLICE (header).
__device__ __forceinline__ uint32_t absw(int32_t w) {
    return w < 0 ? 0u - static_cast<uint32_t>(w) : static_cast<uint32_t>(w);
}

__global__ void __launch_bounds__(THREADS)
fletcher_segmented_kernel(const long long* __restrict__ leaves, int n_leaves,
                          int64_t chunk_words, int32_t* __restrict__ out) {
    const long long chunk = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __shared__ int leaf_of_block;
    __shared__ unsigned long long w1[THREADS / 32], w2[THREADS / 32];
    if (warp == 0) {
        // the last leaf l in [lo, lo + len) with first[l] <= chunk;
        // first[lo] <= chunk holds throughout (first[0] = 0)
        int lo = 0, len = n_leaves;
        while (len > 1) {
            const int step = (len + 31) / 32;
            const bool ok = lane * step < len &&
                            leaves[3 * (lo + lane * step) + 2] <= chunk;
            const unsigned m = __ballot_sync(0xffffffffu, ok);
            const int k = 31 - __clz(m);
            lo += k * step;
            len = min(step, len - k * step);
        }
        if (lane == 0) leaf_of_block = lo;
    }
    __syncthreads();
    const int l = leaf_of_block;
    const int32_t* words = reinterpret_cast<const int32_t*>(leaves[3 * l]);
    const long long n = leaves[3 * l + 1];
    const long long c0 = (chunk - leaves[3 * l + 2]) * chunk_words;
    long long c1 = c0 + chunk_words;
    if (c1 > n) c1 = n;
    const int len = c1 > c0 ? static_cast<int>(c1 - c0) : 0;
    const int32_t* base = words + c0;
    unsigned long long s1 = 0, s2 = 0;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
        const int n4 = len / 4;
        const int4* v = reinterpret_cast<const int4*>(base);
#pragma unroll 4
        for (int j = threadIdx.x; j < n4; j += THREADS) {
            const int4 q = v[j];
            const uint32_t p = 4u * j + 1u;   // position of q.x
            const uint32_t a0 = absw(q.x), a1 = absw(q.y), a2 = absw(q.z),
                           a3 = absw(q.w);
            s1 += static_cast<unsigned long long>(a0) + a1 +
                  static_cast<unsigned long long>(a2) + a3;
            s2 += static_cast<unsigned long long>(a0) * p +
                  static_cast<unsigned long long>(a1) * (p + 1u) +
                  static_cast<unsigned long long>(a2) * (p + 2u) +
                  static_cast<unsigned long long>(a3) * (p + 3u);
        }
        done = 4 * n4;
    }
    for (int j = done + threadIdx.x; j < len; j += THREADS) {
        const uint32_t a = absw(base[j]);
        s1 += a;
        s2 += static_cast<unsigned long long>(a) * (j + 1u);
    }
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
        s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
        w1[warp] = s1;
        w2[warp] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long t1 = 0, t2 = 0;
        for (int k = 0; k < THREADS / 32; ++k) {
            t1 += w1[k];
            t2 += w2[k];
        }
        out[2 * chunk] = static_cast<int32_t>(t1 % P);
        out[2 * chunk + 1] = static_cast<int32_t>(t2 % P);
    }
}

}  // namespace

// words: (n,) int32; out: (n_chunks, 2) int32 with n_chunks = max(1,
// ceil(n / chunk_words)); partial: n_chunks * slices * 2 uint64 scratch with
// slices = ceil(chunk_words / 65536).  All contiguous on the card.
extern "C" int fletcher(const void* words, void* out, void* partial,
                        long long n, long long chunk_words,
                        long long n_chunks, long long slices, void* stream) {
    if (n_chunks <= 0) return 0;
    if (chunk_words <= 0 || slices <= 0 || slices > 65535 ||
        n_chunks > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(slices));
    fletcher_partial_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int32_t*>(words), n, chunk_words,
        static_cast<unsigned long long*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int fold_blocks = static_cast<int>((n_chunks + 255) / 256);
    fletcher_fold_kernel<<<fold_blocks, 256, 0, s>>>(
        static_cast<const unsigned long long*>(partial), n_chunks, slices,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

// leaves: (n_leaves, 3) int64 rows (words pointer, n_words, first chunk) on
// the card, every leaf's words int32 on the card; out: (n_chunks, 2) int32
// with n_chunks = first[L-1] + max(1, ceil(n_words[L-1] / chunk_words)).
// 1 <= chunk_words <= 65536 (SLICE).
extern "C" int fletcher_segmented(const void* leaves, int n_leaves, void* out,
                                  long long n_chunks, long long chunk_words,
                                  void* stream) {
    if (n_leaves <= 0 || chunk_words <= 0 || chunk_words > SLICE ||
        n_chunks > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_chunks <= 0) return 0;
    fletcher_segmented_kernel<<<static_cast<unsigned>(n_chunks), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(leaves), n_leaves, chunk_words,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
