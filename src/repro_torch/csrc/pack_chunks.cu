// pack_chunks: send-order row gather, out[i] = payload[idx[i]], idx < 0 -> zero row.
//
// Replaces the Pallas kernel repro/kernels/chunk_pack/chunk_pack.py
// pack_chunks_kernel (body _pack_kernel): payload (n, w) 4-byte words
// (int32 or float32, copied as raw words), idx (m,) int32, out (m, w).  A
// sentinel row (idx < 0) is written as zeros and the payload is never read
// for it -- row 0 in particular is never gathered into a pad slot.  An idx
// at or past n is treated like the sentinel rather than read out of bounds.
//
// Bound on an H100: pure data movement.  The least traffic is the gathered
// rows read once plus every output row written once (about 2*m*w*4 bytes
// when no row is a sentinel), at 3.35 TB/s.  On the write path a row is one
// 1 MiB chunk plus 3 routing words (w = 262147), so m rows move m MiB each
// way.
//
// Design: a 2-D grid, blockIdx.x the tile of TILE words within a row and
// blockIdx.y the row (striding by gridDim.y past 65535 rows).  Blocks are
// issued in linear order, x fastest, so the blocks in flight walk the output
// in memory order, as a memcpy does, and no block divides to find its row.
// Each thread copies UNROLL words of its tile with 4-byte loads and stores,
// adjacent threads on adjacent words (coalesced), all loads issued before
// the stores.  Rows are w words long and w is odd on the write path, so row
// starts are not 16-byte aligned; 4-byte accesses need no alignment case.
// The TPU kernel's per-row DMA loop through VMEM is not carried over: here
// thousands of tiles of many rows run at once.  Two earlier layouts, a
// grid-stride loop over row-major tiles and one block per whole row, were
// slower at the write path's shapes on the card (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int64_t TILE = THREADS * UNROLL;

__global__ void __launch_bounds__(THREADS)
pack_chunks_kernel(const uint32_t* __restrict__ payload,
                   const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int64_t n, int64_t m,
                   int64_t w) {
    const int64_t col0 = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
    for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
        const int32_t src = idx[row];
        uint32_t v[UNROLL];
        if (src >= 0 && src < n) {
            const uint32_t* p = payload + static_cast<int64_t>(src) * w;
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) {
                const int64_t c = col0 + k * THREADS;
                v[k] = c < w ? p[c] : 0u;
            }
        } else {
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) v[k] = 0u;
        }
        uint32_t* o = out + row * w;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            const int64_t c = col0 + k * THREADS;
            if (c < w) o[c] = v[k];
        }
    }
}

}  // namespace

// payload: (n, w) 4-byte words, idx: (m,) int32, out: (m, w); contiguous on
// the card.  Launches nothing when there is no output.
extern "C" int pack_chunks(const void* payload, const void* idx, void* out,
                           long long n, long long m, long long w,
                           void* stream) {
    if (m <= 0 || w <= 0) return 0;
    const int64_t tiles_per_row = (w + TILE - 1) / TILE;
    if (tiles_per_row > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(tiles_per_row),
                    static_cast<unsigned>(m < 65535 ? m : 65535));
    pack_chunks_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(payload),
        static_cast<const int32_t*>(idx), static_cast<uint32_t*>(out), n, m,
        w);
    return static_cast<int>(cudaGetLastError());
}
