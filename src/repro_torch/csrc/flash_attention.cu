// flash_attention: blocked online-softmax attention over bf16 (B, H, S, D)
// views, causal or full, on Hopper's tensor cores: wgmma on bf16 tiles fed
// by TMA through a ring of K/V stages.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// flash_attention_bhsd (body _flash_kernel) for bf16 inputs; float32 inputs
// go to the 3xTF32 kernel in flash_attention_f32.cu.  For each (b, h) and
// query row i < S:
//
//     valid(i, j) = j < S and (not causal or j <= i)
//     s_ij        = valid ? scale * q_i . k_j : -1e30  (the reference's mask)
//     o_i         = sum_j softmax_j(s_ij) v_j / max(sum_j exp(...), 1e-30)
//
// with the reference's online-softmax update over 64-key tiles (running
// max m, running sum l, float32 accumulator; corr = exp(m - m_new)).  The
// arithmetic is the reference's on its own chip: the Pallas body's
// dot_generals run at the TPU's default precision, bf16 operands with
// float32 sums, and so do these: S = Q K^T takes q and k as stored, the
// scale goes on the float32 scores (folded with log2 e, then exp2f), P is
// rounded to bf16 for O += P V, l sums the float32 p, and the output is
// acc / max(l, 1e-30) rounded once to bf16 (nearest even).
//
// Bound on an H100: at gemma3-1b's global-attention shape (B 4, S 1024,
// H 4, D 256, causal) the work is 4*B*H*D*S(S+1)/2 = 8.6 GFLOP over 33.6 MB
// of q/k/v/o: 0.0087 ms at the bf16 tensor-core peak (989 TFLOP/s) and
// 0.010 ms at HBM's 3.35 TB/s.  K and V come back from L2 for every query
// tile: 16 heads x 136 tile pairs x 64 KB = 139 MB over the causal walk.
//
// Design.  One block of one warpgroup (128 threads) per (batch*head,
// 64-query tile), numbered so the longest causal query tiles start first;
// the loop over 64-key tiles takes the place of the TPU's sequential kv
// grid axis and stops at the diagonal tile when causal.
//
//   * Loads: TMA, issued by thread 0, tensor maps built on the host over
//     each (B, S, H, D) tensor in place (4-D, innermost first: D, S, H, B,
//     byte strides; no copy, no transpose).  A tile is D/BW boxes of
//     64 rows x BW columns: BW = 64 with the 128-byte swizzle (D = 64,
//     128, 256), BW = 16 with the 32-byte swizzle (D = 80, which is no
//     multiple of 64).  Rows past S arrive as zeros.
//   * Shared memory, all bf16: the Q tile, and STAGES stages of separate
//     K and V tiles, each with its own mbarrier (expect_tx).  K of stage s
//     is refilled with tile t + STAGES as soon as every warp is done with
//     S = Q K^T of tile t, V as soon as P V is: loads run under the
//     softmax and the other product.  D = 256 takes one stage, 97 KB, so
//     two blocks share an SM and one's softmax runs under the other's
//     products; D = 128 two stages, 81 KB (two blocks); D = 80 and 64 two
//     stages, 51 and 41 KB (four and five blocks).
//   * S = Q K^T: D/16 wgmma m64n64k16, both operands K-major from shared
//     memory through swizzled descriptors; float32 scores in registers
//     (32 a thread).  The mask (kpos >= S, and kpos > qpos when causal) is
//     applied only on the diagonal tile and the ragged last tile.
//   * O += P V: P rounded to bf16 in registers is the A operand (the
//     accumulator layout of S is the A-fragment layout of P V, so no
//     shuffle and no shared memory); V is the B operand in its (keys, D)
//     layout, MN-major through the descriptor's transpose bit.  One
//     wgmma m64nDk16 per 16 keys; the accumulator is D/2 float32
//     registers a thread (128 at D = 256).
//   * Epilogue: row sums reduced across the four threads of a row, the
//     division, bf16 pairs stored straight from registers, rows < S only.
//
// Alternatives measured on the H100 in the same calls, all slower at the
// gemma shape: two stages at D = 256 (160 KB, one block an SM); two
// consumer warpgroups on a 128-query block sharing each K/V stage; and
// the same with a producer warpgroup, where ptxas held every thread to
// the 168 registers of a 384-thread launch (setmaxnreg did not raise its
// allocation) and spilled at D = 256; and issuing S of tile t with P V of
// tile t - 1 so the softmax overlaps P V, where ptxas serialized the
// wgmmas (C7513/C7514: registers of an in-flight wgmma touched) in every
// arrangement tried, and at D = 256 a second P beside the scores and the
// accumulator leaves no registers to spare.
//
// Head dims taken: 64, 80, 128, 256; the wrapper raises on others, and on
// views TMA cannot read (base not 16-byte aligned, a stride not a multiple
// of 16 bytes).
//
// Compiler report (nvcc -Xptxas -v, sm_90a, CUDA 12.8), registers a
// thread, no stack and no spills at any D; shared memory is the dynamic
// size above plus 32 (D = 256) or 48 bytes of mbarriers:
//
//     D = 256: 186 registers
//     D = 128: 122 registers
//     D = 80:  98 registers
//     D = 64:  90 registers

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a block (wgmma M)
constexpr int BK = 64;            // keys a kv tile
constexpr int THREADS = 128;      // one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ENCODE_ERROR = 10000;   // + CUresult of a failed encode

template <int D>
struct Tiles {
    static constexpr int SWB = D % 64 == 0 ? 128 : 32;   // swizzle = row bytes
    static constexpr int BW = SWB / 2;                   // columns a box
    static constexpr int NB = D / BW;                    // boxes a tile
    static constexpr int BOX_BYTES = BK * SWB;
    static constexpr int TILE_BYTES = NB * BOX_BYTES;    // 64 x D x 2
    static constexpr int STAGES = D == 256 ? 1 : 2;
    static constexpr int SMEM = TILE_BYTES * (1 + 2 * STAGES) + 1024;
    static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 3;   // descriptor
    static_assert(D % BW == 0 && D % 16 == 0, "head dim");
};

struct Args {
    void* o;
    long long o_st[3];            // element strides (b, s, h) of o
    int H, S, BH, nq;
    float scale_log2;             // scale * log2(e)
    int causal;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
}

// Waits for the phase of the given parity to complete.  A load that never
// lands is a fault, not a wait: after 2^24 polls (seconds) the kernel traps,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (uint32_t n = 0;; ++n) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (n == (1u << 24)) __trap();
    }
}

// One tile (64 rows from row0 of head h, batch b) into shared memory at
// dst: NB boxes, completion counted on bar.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h,
                                          int b) {
    using T = Tiles<D>;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(T::TILE_BYTES)
        : "memory");
#pragma unroll
    for (int c = 0; c < T::NB; ++c)
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
                dst + c * T::BOX_BYTES),
            "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c * T::BW),
            "r"(row0), "r"(h), "r"(b)
            : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), swizzle layout in the top two bits.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
           (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
           (layout << 62);
}

// K-major operand (a Q or K tile): columns [16 kk, 16 kk + 16).  Within a
// box the k-step moves the start 32 bytes along the swizzled row; 8-row
// groups are 8 rows of SWB bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
    using T = Tiles<D>;
    const int col = 16 * kk;
    return make_desc(tile + (col / T::BW) * T::BOX_BYTES + (col % T::BW) * 2,
                     16, 8 * T::SWB, T::LAYOUT);
}

// MN-major operand (a V tile as the (keys, D) B of P V): keys
// [16 kk, 16 kk + 16), all D columns; column atoms of BW are one box
// apart (leading offset), 8-key groups 8 rows apart (stride offset).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
    using T = Tiles<D>;
    return make_desc(tile + 16 * kk * T::SWB, T::BOX_BYTES, 8 * T::SWB,
                     T::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 scores, float32) {+}= A (64 x 16, shared) B (64 x 16,
// shared)^T; both operands K-major.  accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, float32) += A (64 x 16, registers) * B (16 x 80, shared,
// MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39 "
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, shared,
// MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, float32) += A (64 x 16, registers) * B (16 x 256, shared,
// MN-major: the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
        "%122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Args a) {
    using T = Tiles<D>;
    constexpr int ST = T::STAGES;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[1 + 2 * ST];   // Q, K[ST], V[ST]

    const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t sk = sq + T::TILE_BYTES;              // + stage * TILE
    const uint32_t sv = sk + ST * T::TILE_BYTES;
    const uint32_t bq = smem_addr(&bars[0]);
    const uint32_t bk = bq + 8;                          // + stage * 8
    const uint32_t bv = bk + 8 * ST;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int qt = a.nq - 1 - static_cast<int>(blockIdx.x / a.BH);
    const int bh = static_cast<int>(blockIdx.x % a.BH);
    const int b = bh / a.H, h = bh % a.H;
    const int q0 = qt * BQ, S = a.S;
    const int nk = (S + BK - 1) / BK;
    const int kt_end = a.causal ? min(qt + 1, nk) : nk;

    if (tid == 0) {
        for (int i = 0; i < 1 + 2 * ST; ++i) mbar_init(bq + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        load_tile<D>(sq, &tq, bq, q0, h, b);
        for (int t = 0; t < ST && t < kt_end; ++t) {
            load_tile<D>(sk + t * T::TILE_BYTES, &tk, bk + 8 * t, t * BK, h, b);
            load_tile<D>(sv + t * T::TILE_BYTES, &tv, bv + 8 * t, t * BK, h, b);
        }
    }

    // this thread's rows of the tile: r0 and r0 + 8; its columns in each
    // 8-column chunk j of S and O: 8 j + cq and 8 j + cq + 1
    const int r0 = 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    mbar_wait(bq, 0);

    for (int t = 0; t < kt_end; ++t) {
        const int s = ST == 1 ? 0 : t % ST;
        const uint32_t parity = (t / ST) & 1;
        const uint32_t ktile = sk + s * T::TILE_BYTES;
        const uint32_t vtile = sv + s * T::TILE_BYTES;
        const bool refill = t + ST < kt_end;

        // S = Q K^T
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        mbar_wait(bk + 8 * s, parity);
        wgmma_fence();
        reg_fence(sc);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(sc, desc_kmajor<D>(sq, kk), desc_kmajor<D>(ktile, kk),
                         kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        if (refill) {
            __syncthreads();          // every warp is done with this K tile
            if (tid == 0)
                load_tile<D>(ktile, &tk, bk + 8 * s, (t + ST) * BK, h, b);
        }

        // mask, online softmax (log2 domain), P in bf16 registers
        const int k0 = t * BK;
        const bool edge = (a.causal && t == qt) || k0 + BK > S;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            float x = sc[i] * a.scale_log2;
            if (edge) {
                const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
                const int qpos = q0 + r0 + 8 * ((i / 2) & 1);
                if (kpos >= S || (a.causal && kpos > qpos)) x = NEG_INF;
            }
            sc[i] = x;
            mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            corr[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= corr[r];
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            const int r = (i / 2) & 1;
            const float p0 = exp2f(sc[i] - m[r]);
            const float p1 = exp2f(sc[i + 1] - m[r]);
            l[r] += p0 + p1;
            pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];

        // O += P V
        mbar_wait(bv + 8 * s, parity);
        wgmma_fence();
        reg_fence(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs(o, pa[kk], desc_mnmajor<D>(vtile, kk));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o);
        if (refill) {
            __syncthreads();          // every warp is done with this V tile
            if (tid == 0)
                load_tile<D>(vtile, &tv, bv + 8 * s, (t + ST) * BK, h, b);
        }
    }

    // epilogue: full row sums, the reference's division, bf16 stores
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_st[0] +
                        h * a.o_st[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float denom = fmaxf(l[r], 1e-30f);
        const int row = q0 + r0 + 8 * r;
        if (row >= S) continue;
        __nv_bfloat16* out = ob + row * a.o_st[1] + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                      o[4 * j + 2 * r + 1] / denom);
    }
}

// cuTensorMapEncodeTiled, reached through the runtime (CUDA 12.5 or later)
// so that no -lcuda link is needed.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

template <int D>
int launch(const void* const ptr[3], const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box,
           int swizzle, const Args& a, cudaStream_t stream) {
    using T = Tiles<D>;
    if (swizzle != T::SWB || box[0] != static_cast<cuuint32_t>(T::BW) ||
        box[1] != static_cast<cuuint32_t>(BK) || box[2] != 1 || box[3] != 1)
        return static_cast<int>(cudaErrorInvalidValue);
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    CUtensorMap maps[3];
    for (int i = 0; i < 3; ++i) {
        CUresult r = encode(
            &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr[i]), dims, strides + 3 * i, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
    }
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(a.nq) * a.BH;
    flash_attention_kernel<D><<<static_cast<unsigned>(blocks), THREADS,
                                T::SMEM, stream>>>(maps[0], maps[1], maps[2],
                                                   a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, H, S, D) views on the card, read by TMA through the
// geometry the wrapper computed (flash_attention.py, tma_geometry):
// dims = (D, S, H, B) innermost first; strides = the byte strides of dims
// 1..3 (S, H, B) of q, then k, then v; box = (BW, 64, 1, 1); swizzle =
// 128 or 32 bytes.  o: a bf16 view of the same shape, o_strides its
// element strides (batch, sequence, head), the last dim contiguous.
// Returns a cudaError_t, or 10000 + the CUresult of a failed tensor-map
// encode.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const uint64_t* dims,
                               const uint64_t* strides, const uint32_t* box,
                               int swizzle,
                               const long long* o_strides, float scale,
                               int causal, void* stream) {
    const long long D = dims[0], S = dims[1], H = dims[2], B = dims[3];
    if (B <= 0 || H <= 0 || S <= 0) return 0;
    Args a;
    a.o = o;
    for (int i = 0; i < 3; ++i) a.o_st[i] = o_strides[i];
    a.H = static_cast<int>(H);
    a.S = static_cast<int>(S);
    a.BH = static_cast<int>(B * H);
    a.nq = static_cast<int>((S + BQ - 1) / BQ);
    a.scale_log2 = scale * LOG2E;
    a.causal = causal;
    if (S > 2147483647LL || B * H > 2147483647LL ||
        static_cast<long long>(a.nq) * B * H > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* const ptr[3] = {q, k, v};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: return launch<64>(ptr, dims, strides, box, swizzle, a, s);
        case 80: return launch<80>(ptr, dims, strides, box, swizzle, a, s);
        case 128: return launch<128>(ptr, dims, strides, box, swizzle, a, s);
        case 256: return launch<256>(ptr, dims, strides, box, swizzle, a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
