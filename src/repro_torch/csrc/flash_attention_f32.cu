// flash_attention_f32: blocked online-softmax attention, causal or full,
// over a float32 (B, H, S, D) view read through strides, on the tensor
// cores in 3xTF32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// flash_attention_bhsd (body _flash_kernel) for float32 inputs; bf16 inputs
// go to the Hopper kernel in flash_attention.cu.  For each (b, h) and query
// row i < S, with s_ij = scale * (q_i . k_j) in float32:
//
//     valid(i, j) = j < S and (not causal or j <= i)
//     s_ij        = valid ? s_ij : -1e30           (the reference's NEG_INF)
//     o_i         = sum_j softmax_j(s_ij) v_j / max(sum_j exp(...), 1e-30)
//
// computed blockwise with a running max m, running sum l and float32
// accumulator per query row, exactly the reference's online-softmax update
// (m_new = max(m, rowmax); p = exp(s - m_new); corr = exp(m - m_new);
// l = l * corr + sum p; acc = acc * corr + p v), with expf and no
// fast-math.
//
// 3xTF32: both products, S = Q K^T and O += P V, run on the tensor cores
// (mma.sync m16n8k8, tf32 operands, float32 accumulators).  Each float32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done in
// two integer instructions: tf32_rna below), and each product is taken as
// hi*lo + lo*hi + hi*hi, accumulated in float32 (lo*lo, below float32's own
// rounding, is left out).  hi + lo carries 22 of x's 24 significand bits,
// so the result keeps float32 accuracy, where one TF32 pass is about 1e-3
// off on unit-normal inputs (tests/test_torch_flash_attention.py models
// both).  The tensor cores' own float32 sums round differently from FMAs;
// Q K^T is therefore summed 64 dims at a time into a fresh accumulator and
// the partial sums added in float32, so no chain of tensor-core sums runs
// over more than 24 products.
//
// Bound on an H100: at gemma3-1b's global-attention shape (B 4, S 1024,
// H 4, D 256, causal) the work is 4*B*H*D*S(S+1)/2 = 8.6 GFLOP over 67 MB
// of float32 q/k/v/o.  3xTF32 runs three tensor-core products for each, so
// at the TF32 peak (495 TFLOP/s) it takes at least 0.052 ms; the bytes take
// 0.020 ms; the float32 SIMT pipes (67 TFLOP/s) would need 0.128 ms.  What
// bounds this kernel in practice is the work around the products: the
// splits (five instructions an operand) outnumber the mma instructions
// about five to one.
//
// Design: one block of 8 warps per (batch*head, 64-query tile).  Warp w
// owns query rows 16(w % 4)..+15 of the tile and one half, w / 4, of each
// 32-key tile: 16 keys.  The loop over key tiles inside the block takes
// the place of the TPU's sequential kv grid axis; in causal mode it stops
// at the diagonal tile (the tiles the Pallas kernel skips with pl.when),
// and the two warps of a row group skip a key tile that lies wholly above
// their rows.  Blocks are numbered so the last query tiles, which walk the
// most kv tiles, start first.  Shared memory, float32 with a row pitch of
// D + 4 words (so that every fragment load below touches 32 distinct
// banks):
//
//     Qs   64 x (D+4)             the query tile, loaded once
//     Ks   2 stages x 32 x (D+4)  the key tiles
//     Vs   2 stages x 32 x (D+4)  the value tiles
//     red  2 x 2 x 64             the two halves' row maxima, by parity
//
// K and V of tile t+1 are loaded with cp.async (16-byte copies where every
// base and stride is 16-byte aligned, else 4-byte ones; rows past S are
// zero-filled) while tile t is computed.  A warp's scores (16 rows x 16
// keys) stay in registers: the accumulator layout of m16n8k8 holds, in
// thread (g, t) of the warp (g = lane / 4, t = lane % 4), rows g and g + 8
// at key columns 2t and 2t + 1 of each 8-key slice.  Taken as the A
// operand of P V with the slice's keys renumbered (column 2t as k index t,
// 2t + 1 as t + 4), those registers are P's A fragment as they stand; the
// V fragment then reads value rows 2t and 2t + 1.  The two warps of a row
// group exchange their row maxima through shared memory (a 64-thread named
// barrier), so both rescale by the same running max; each keeps its own
// running sum and a 16 x D output accumulator (D/2 registers a thread),
// and the second half's are added to the first's once, after the loop.
// Sizes of shared memory: D = 256: 200,704 bytes, one block per SM;
// D = 128: 102,400; D = 80: 65,536; D = 64: 53,248.  All above 48 KB, so
// the entry point opts in with cudaFuncSetAttribute(MaxDynamicShared-
// MemorySize) before each launch.  Head dims taken: 64, 80, 128, 256 (the
// JAX sweep and gemma3-1b); the entry point pads others, the wrapper
// raises.
//
// Compiler report (nvcc -Xptxas -v, sm_90a, CUDA 12.8), registers a thread,
// stack, spills; shared memory is all dynamic (sizes above):
//
//     D = 256: 244 registers, no stack, no spills
//     D = 128: 158;  D = 80: 151;  D = 64: 136 (no spills)
//
// __launch_bounds__(256, 1) lets ptxas go past 128 registers at D <= 128,
// where a cap of 128 spilled; shared memory allows two blocks an SM there,
// registers one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a block
constexpr int BK = 32;            // keys a kv tile
constexpr int WARPS = 8;          // 4 row groups x 2 key halves
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;         // K/V tiles in flight
constexpr int NT = BK / 16;       // 8-key slices of a warp's half tile
constexpr int GK = 64;            // dims a fresh score accumulator sums
constexpr float NEG_INF = -1e30f;

struct Args {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    long long st[12];             // (b, s, h) strides of q, k, v, o
    int H, S, BH, nq;
    float scale;
    int causal;
    int vec16;                    // q/k/v bases and strides 16-byte aligned
};

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((BQ + 2 * STAGES * BK) * (D + 4) + 2 * 2 * BQ);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the two warps of row group rg (warps rg and rg + 4) meet here
__device__ __forceinline__ void pair_barrier(int rg) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(rg + 1), "r"(64) : "memory");
}

// Rows [row0, row0 + rows) of one (b, h) slice into a rows x (D+4) tile;
// rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long s_stride, int row0,
                                          int rows, int S, bool vec16) {
    constexpr int P = D + 4;
    if (vec16) {
        constexpr int C = D / 4;  // 16-byte pieces a row
        for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) {
            const int r = idx / C;
            const int c = (idx - r * C) * 4;
            const bool ok = row0 + r < S;
            cp_async16(dst + r * P + c,
                       base + (ok ? (row0 + r) * s_stride + c : 0), ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
            const int r = idx / D;
            const int c = idx - r * D;
            const bool ok = row0 + r < S;
            cp_async4(dst + r * P + c,
                      base + (ok ? (row0 + r) * s_stride + c : 0), ok);
        }
    }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half a TF32 ulp added to the magnitude bits, the 13 low
// significand bits cleared.  Two integer instructions; cvt.rna itself
// compiles to three dependent ones (an FSETP guard for infinities and
// NaNs, a predicated add, the mask).  The result is cvt.rna's for every
// finite x and for infinities; a NaN stays a NaN or becomes an infinity
// whose lo part below is a NaN, so a NaN still reaches the output.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small cross terms first, then hi*hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
    mma_tf32(c, ah, bl[0], bl[1]);
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bh[0], bh[1]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const Args a) {
    extern __shared__ __align__(16) float smem[];
    constexpr int P = D + 4;
    constexpr int DT = D / 8;     // 8-column slices of the output
    float* Qs = smem;
    float* Ks = Qs + BQ * P;
    float* Vs = Ks + STAGES * BK * P;
    float* red = Vs + STAGES * BK * P;          // [2 parities][2 halves][BQ]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rg = warp & 3, half = warp >> 2;
    const int qt = a.nq - 1 - static_cast<int>(blockIdx.x / a.BH);
    const int bh = static_cast<int>(blockIdx.x % a.BH);
    const int b = bh / a.H, h = bh % a.H;
    const int q0 = qt * BQ;
    const int S = a.S;
    const bool vec = a.vec16 != 0;

    const float* qb = a.q + b * a.st[0] + h * a.st[2];
    const float* kb = a.k + b * a.st[3] + h * a.st[5];
    const float* vb = a.v + b * a.st[6] + h * a.st[8];
    float* ob = a.o + b * a.st[9] + h * a.st[11];

    const int nk = (S + BK - 1) / BK;
    int kt_end = nk;
    if (a.causal) {
        const int last = (q0 + BQ - 1) / BK + 1;   // past the diagonal tile
        kt_end = last < nk ? last : nk;
    }

    load_rows<D>(Qs, qb, a.st[1], q0, BQ, S, vec);
    load_rows<D>(Ks, kb, a.st[4], 0, BK, S, vec);
    load_rows<D>(Vs, vb, a.st[7], 0, BK, S, vec);
    cp_async_commit();

    float acc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int wrow = rg * 16;                   // the warp's first row
    const int kh = half * (BK / 2);             // its keys within a tile
    const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};
    const float* Qw = Qs + wrow * P;

    for (int kt = 0; kt < kt_end; ++kt) {
        const int stage = kt % STAGES;
        if (kt + 1 < kt_end) {
            const int next = (kt + 1) % STAGES;
            load_rows<D>(Ks + next * BK * P, kb, a.st[4], (kt + 1) * BK, BK,
                         S, vec);
            load_rows<D>(Vs + next * BK * P, vb, a.st[7], (kt + 1) * BK, BK,
                         S, vec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                        // tile kt is in place
        const int k0 = kt * BK;
        // both warps of a row group take the same branch (pair barrier)
        if (!a.causal || k0 <= q0 + wrow + 15) {
            const float* Kt = Ks + (stage * BK + kh) * P;
            const float* Vt = Vs + (stage * BK + kh) * P;
            float s[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            // S = Q K^T over this warp's 16 keys, summed GK dims at a time
            // into a fresh accumulator, then added in float32
#pragma unroll
            for (int kk0 = 0; kk0 < D; kk0 += GK) {
                float c[NT][4];
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
                for (int kk = kk0; kk < kk0 + GK && kk < D; kk += 8) {
                    uint32_t ah[4], al[4];
                    split(Qw[g * P + kk + t], ah[0], al[0]);
                    split(Qw[(g + 8) * P + kk + t], ah[1], al[1]);
                    split(Qw[g * P + kk + t + 4], ah[2], al[2]);
                    split(Qw[(g + 8) * P + kk + t + 4], ah[3], al[3]);
#pragma unroll
                    for (int j = 0; j < NT; ++j) {
                        uint32_t bh[2], bl[2];
                        split(Kt[(j * 8 + g) * P + kk + t], bh[0], bl[0]);
                        split(Kt[(j * 8 + g) * P + kk + t + 4], bh[1], bl[1]);
                        mma3(c[j], ah, al, bh, bl);
                    }
                }
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
            }

            // scale, mask, online softmax; element e of slice j is row
            // row[e / 2], key k0 + kh + 8j + 2t + e % 2
            const bool masked = k0 + BK > S ||
                                (a.causal && k0 + BK - 1 > q0 + wrow);
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[j][e] * a.scale;
                    if (masked) {
                        const int col = k0 + kh + 8 * j + 2 * t + (e & 1);
                        const bool ok = col < S &&
                                        (!a.causal || col <= row[e >> 1]);
                        x = ok ? x : NEG_INF;
                    }
                    s[j][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            // the row max over the whole tile: this warp's half, then the
            // other warp's, through shared memory
            float* mine = red + ((kt & 1) * 2 + half) * BQ + wrow;
            const float* other = red + ((kt & 1) * 2 + 1 - half) * BQ + wrow;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                if (t == 0) mine[g + 8 * r] = mx[r];
            }
            pair_barrier(rg);
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float m_new = fmaxf(m[r], fmaxf(mx[r], other[g + 8 * r]));
                corr[r] = expf(m[r] - m_new);
                m[r] = m_new;
            }
            float sum[2] = {0.f, 0.f};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = expf(s[j][e] - m[e >> 1]);
                    s[j][e] = p;
                    sum[e >> 1] += p;
                }
            // each half keeps the sum over its own keys (l and acc are
            // combined after the loop)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
                sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
                l[r] = l[r] * corr[r] + sum[r];
            }
#pragma unroll
            for (int n = 0; n < DT; ++n) {
                acc[n][0] *= corr[0];
                acc[n][1] *= corr[0];
                acc[n][2] *= corr[1];
                acc[n][3] *= corr[1];
            }

            // O += P V: slice j's P (rows g, g+8 x keys 2t, 2t+1) is the A
            // fragment with key 2t as k index t and 2t+1 as t+4
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                uint32_t ph[4], pl[4];
                split(s[j][0], ph[0], pl[0]);
                split(s[j][2], ph[1], pl[1]);
                split(s[j][1], ph[2], pl[2]);
                split(s[j][3], ph[3], pl[3]);
                const float* v0 = Vt + (j * 8 + 2 * t) * P + g;
#pragma unroll
                for (int n = 0; n < DT; ++n) {
                    uint32_t bh[2], bl[2];
                    split(v0[n * 8], bh[0], bl[0]);
                    split(v0[P + n * 8], bh[1], bl[1]);
                    mma3(acc[n], ph, pl, bh, bl);
                }
            }
        }
        __syncthreads();                        // stage kt % 2 is free
    }

    // the second half's acc and l join the first's through shared memory
    // (the K stages and the max buffer are free now), in fragment order
    float* part = Ks + rg * DT * 4 * 32;
    float* lpart = red + rg * 64;
    if (half == 1) {
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[(n * 4 + e) * 32 + lane] = acc[n][e];
        lpart[lane] = l[0];
        lpart[32 + lane] = l[1];
    }
    __syncthreads();
    if (half == 1) return;
    l[0] += lpart[lane];
    l[1] += lpart[32 + lane];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        float* out = ob + row[r] * a.st[10] + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            out[n * 8] = (acc[n][2 * r] + part[(n * 4 + 2 * r) * 32 + lane]) /
                         denom;
            out[n * 8 + 1] =
                (acc[n][2 * r + 1] + part[(n * 4 + 2 * r + 1) * 32 + lane]) /
                denom;
        }
    }
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(a.nq) * a.BH;
    flash_attention_f32_kernel<D><<<static_cast<unsigned>(blocks), THREADS,
                                   smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, int D, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<64>(a, stream);
        case 80: return launch<80>(a, stream);
        case 128: return launch<128>(a, stream);
        case 256: return launch<256>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// q, k, v, o: float32 (B, H, S, D) views on the card, the last dim
// contiguous; strides: 12 element strides, the (batch, sequence, head)
// strides of q, k, v and o in that order.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int S, int D, float scale, int causal,
                                   void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return 0;
    Args a;
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.o = static_cast<float*>(o);
    bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    for (int i = 0; i < 12; ++i) {
        a.st[i] = strides[i];
        if (i < 9 && strides[i] % 4 != 0) aligned = false;
    }
    a.H = H;
    a.S = S;
    a.BH = B * H;
    a.nq = (S + BQ - 1) / BQ;
    a.scale = scale;
    a.causal = causal;
    a.vec16 = aligned ? 1 : 0;
    if (static_cast<long long>(a.nq) * a.BH > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(a, D, s);
}
