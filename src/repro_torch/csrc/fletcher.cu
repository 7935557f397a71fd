// fletcher: position-weighted checksums of consecutive chunks of int32 words.
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
