// flash_attention_wide: blocked online-softmax attention, causal or full,
// over a float32 (B, H, S, D) view read through strides, for head dims
// above 256 (D a multiple of 128), on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// flash_attention_bhsd (body _flash_kernel) where D > 256: the reference
// pads D to a multiple of 128 lanes and attends at any D
// (repro/kernels/flash_attention/ops.py).  It computes what
// flash_attention_f32.cu computes, with the reference's masking (masked
// scores -1e30, the 1e-30 floor on the denominator) and float32 arithmetic:
// a bf16 or float16 input reaches it as float32 and the entry point rounds
// the result once to its own dtype.
//
// Why a kernel of its own: flash_attention_f32.cu keeps the whole query
// tile and two K and two V stages of D columns in shared memory, 200 KB at
// D = 256, so it has no room past 256.  Here the query and key tiles do not
// grow with D: S = Q K^T is summed over the full D by streaming Q and K
// through shared memory 64 dims at a time.  A block owns up to DV = 512
// output columns (D > 512 takes more blocks, each recomputing S for its
// slice), so the V tile (32 keys x 512 columns) is the one buffer that
// grows, up to its 512 columns.
//
// Bound on an H100: at (B, S, H, D) = (4, 1024, 4, 512), causal, the work
// is 4*B*H*D*S(S+1)/2 = 17.2 GFLOP over 134 MB of float32 q/k/v/o; at
// three TF32 products for each (3xTF32) and the TF32 peak (495 TFLOP/s)
// that is 0.104 ms, the bytes 0.040 ms.  As in flash_attention_f32.cu the
// operand splits (hi = tf32(x), lo = tf32(x - hi)) outnumber the products,
// and here the query tile is split again for every key tile.
//
// Design: one block of 8 warps per (64-query tile, batch*head, 512-column
// slice).  Warps rg and rg + 4 form the pair of row group rg (query rows
// 16 rg .. 16 rg + 15).  For S, each warp of a pair takes one 16-key half
// of a 32-key tile (m16n8k8 TF32 mma.sync, operands split hi + lo, three
// products each, Q K^T summed 64 dims at a time into a fresh accumulator
// and added in float32, as in flash_attention_f32.cu); the pair exchange
// row maxima through shared memory and apply the same online-softmax
// update.  Each warp then writes its half of P to shared memory, and for
// P V each warp of the pair takes one 256-column half of the output over
// all 32 keys: its accumulator is 16 rows x 256 columns (128 registers a
// thread).  So S is computed once a block, not once per output slice.
// The loop is flat over (key tile, 64-dim chunk): chunk i + 1's Q and K
// tiles are loaded with cp.async into the other stage of a two-stage ring
// while chunk i is multiplied, and a key tile's V tile is loaded at its
// first chunk and used after its last.  Blocks whose query tiles walk the
// most key tiles start first.  Shared memory, float32, rows padded so that
// every fragment load touches 32 distinct banks:
//
//     Q|K ring  2 x (64 + 32) x 68     query and key chunks
//     Vs        32 x 520               the key tile's V columns
//     Ps        64 x 36                P of the key tile
//     red       2 x 2 x 64             row maxima by parity
//
// 129,024 bytes, above 48 KB, so the entry point opts in before a launch;
// one block an SM.  nvcc -Xptxas -v (sm_90a, CUDA 12.8): 255 registers, 8
// bytes spilled.  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W,
// at (4, 1024, 4, 512) causal: 0.631 ms of device time, 0.165 of the bound,
// level with SDPA float32 (0.630 ms); a first design that gave each block
// a 128-column slice and recomputed S for each took 1.94 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a block
constexpr int BK = 32;            // keys a kv tile
constexpr int WARPS = 8;          // 4 row groups x 2 halves
constexpr int THREADS = 32 * WARPS;
constexpr int NT = BK / 16;       // 8-key slices of a warp's half of S
constexpr int GK = 64;            // dims of a streamed Q / K chunk
constexpr int DV = 512;           // output columns a block
constexpr int DH = DV / 2;        // output columns a warp
constexpr int DT = DH / 8;        // 8-column slices of a warp's output
constexpr int PQ = GK + 4;        // row pitches (floats)
constexpr int PV = DV + 8;
constexpr int PP = BK + 4;
constexpr int STAGE = (BQ + BK) * PQ;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM =
    sizeof(float) * (2 * STAGE + BK * PV + BQ * PP + 2 * 2 * BQ);

struct Args {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    long long st[12];             // (b, s, h) strides of q, k, v, o
    int H, S, D, BH, nq;
    float scale;
    int causal;
    int vec16;                    // q/k/v bases and strides 16-byte aligned
};

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

__device__ __forceinline__ void pair_barrier(int rg) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(rg + 1), "r"(64) : "memory");
}

// W columns of rows [row0, row0 + rows) from base into a tile of pitch P;
// rows at or past S and columns at or past width are zero-filled.
template <int W, int P>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long s_stride, int row0,
                                          int rows, int S, int width,
                                          bool vec16) {
    if (vec16) {
        constexpr int C = W / 4;
        for (int idx = threadIdx.x; idx < rows * C; idx += THREADS) {
            const int r = idx / C;
            const int c = (idx - r * C) * 4;
            const bool ok = row0 + r < S && c < width;
            cp_async16(dst + r * P + c,
                       base + (ok ? (row0 + r) * s_stride + c : 0), ok);
        }
    } else {
        for (int idx = threadIdx.x; idx < rows * W; idx += THREADS) {
            const int r = idx / W;
            const int c = idx - r * W;
            const bool ok = row0 + r < S && c < width;
            cp_async4(dst + r * P + c,
                      base + (ok ? (row0 + r) * s_stride + c : 0), ok);
        }
    }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (see
// flash_attention_f32.cu), and the split x = hi + lo
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

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

__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
    mma_tf32(c, ah, bl[0], bl[1]);
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bh[0], bh[1]);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wide_kernel(const Args a) {
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;                         // 2 stages of Q|K chunks
    float* Vs = ring + 2 * STAGE;
    float* Ps = Vs + BK * PV;
    float* red = Ps + BQ * PP;                  // [2 parities][2 halves][BQ]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int rg = warp & 3, half = warp >> 2;
    const int qt = a.nq - 1 - static_cast<int>(blockIdx.x / a.BH);
    const int bh = static_cast<int>(blockIdx.x % a.BH);
    const int b = bh / a.H, h = bh % a.H;
    const int col0 = static_cast<int>(blockIdx.y) * DV;
    const int width = min(DV, a.D - col0);      // a multiple of 128
    const int q0 = qt * BQ;
    const int S = a.S;
    const bool vec = a.vec16 != 0;

    const float* qb = a.q + b * a.st[0] + h * a.st[2];
    const float* kb = a.k + b * a.st[3] + h * a.st[5];
    const float* vb = a.v + b * a.st[6] + h * a.st[8] + col0;
    float* ob = a.o + b * a.st[9] + h * a.st[11] + col0;

    const int nk = (S + BK - 1) / BK;
    int kt_end = nk;
    if (a.causal) {
        const int last = (q0 + BQ - 1) / BK + 1;   // past the diagonal tile
        kt_end = last < nk ? last : nk;
    }
    const int nch = a.D / GK;                   // >= 2: D % 128 == 0
    const int total = kt_end * nch;

    // step i: key tile i / nch, dims (i % nch) * GK .. + GK
    auto issue = [&](int i) {
        float* st = ring + (i & 1) * STAGE;
        const int kt = i / nch, d0 = (i % nch) * GK;
        load_rows<GK, PQ>(st, qb + d0, a.st[1], q0, BQ, S, GK, vec);
        load_rows<GK, PQ>(st + BQ * PQ, kb + d0, a.st[4], kt * BK, BK, S,
                          GK, vec);
    };
    issue(0);
    cp_async_commit();

    float acc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float s[NT][4] = {};
    const int wrow = rg * 16;
    const int kh = half * (BK / 2);             // this warp's keys of S
    const int ch = half * DH;                   // its output columns
    const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};

    for (int i = 0; i < total; ++i) {
        const int kt = i / nch, dc = i % nch;
        const bool more = i + 1 < total;
        // groups in flight, oldest first: chunk i, [V of tile kt], [i + 1]
        if (dc == 0) {
            load_rows<DV, PV>(Vs, vb, a.st[7], kt * BK, BK, S, width, vec);
            cp_async_commit();
        }
        if (more) {
            issue(i + 1);
            cp_async_commit();
        }
        if (dc == 0) {
            if (more) cp_async_wait<2>();
            else cp_async_wait<1>();
        } else {
            // chunk i and V (committed before it) are in place
            if (more) cp_async_wait<1>();
            else cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = kt * BK;
        // both warps of a row group take the same branch (pair barriers)
        if (!a.causal || k0 <= q0 + wrow + 15) {
            if (dc == 0) {
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
            }
            const float* Qw = ring + (i & 1) * STAGE + wrow * PQ;
            const float* Kt = ring + (i & 1) * STAGE + (BQ + kh) * PQ;
            float c[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < GK; kk += 8) {
                uint32_t ah[4], al[4];
                split(Qw[g * PQ + kk + t], ah[0], al[0]);
                split(Qw[(g + 8) * PQ + kk + t], ah[1], al[1]);
                split(Qw[g * PQ + kk + t + 4], ah[2], al[2]);
                split(Qw[(g + 8) * PQ + kk + t + 4], ah[3], al[3]);
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    uint32_t bh2[2], bl2[2];
                    split(Kt[(j * 8 + g) * PQ + kk + t], bh2[0], bl2[0]);
                    split(Kt[(j * 8 + g) * PQ + kk + t + 4], bh2[1], bl2[1]);
                    mma3(c[j], ah, al, bh2, bl2);
                }
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];

            if (dc == nch - 1) {
                // scale, mask, online softmax (flash_attention_f32.cu);
                // element e of slice j is row row[e / 2], key
                // k0 + kh + 8j + 2t + e % 2
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
                float* mine = red + ((kt & 1) * 2 + half) * BQ + wrow;
                const float* other =
                    red + ((kt & 1) * 2 + 1 - half) * BQ + wrow;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 1));
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 2));
                    if (t == 0) mine[g + 8 * r] = mx[r];
                }
                pair_barrier(rg);
                float corr[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const float m_new =
                        fmaxf(m[r], fmaxf(mx[r], other[g + 8 * r]));
                    corr[r] = expf(m[r] - m_new);
                    m[r] = m_new;
                }
                // this warp's half of P to shared memory; it keeps the sum
                // over its own keys (the pair's sums join after the loop)
                float sum[2] = {0.f, 0.f};
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = expf(s[j][e] - m[e >> 1]);
                        Ps[(wrow + g + 8 * (e >> 1)) * PP + kh + 8 * j +
                           2 * t + (e & 1)] = p;
                        sum[e >> 1] += p;
                    }
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
                pair_barrier(rg);               // the pair's P is in place
                // O += P V: this warp's 16 rows x its 256 columns, all 32
                // keys of the tile
                const float* Pw = Ps + wrow * PP;
#pragma unroll
                for (int ks = 0; ks < BK; ks += 8) {
                    uint32_t ph[4], pl[4];
                    split(Pw[g * PP + ks + t], ph[0], pl[0]);
                    split(Pw[(g + 8) * PP + ks + t], ph[1], pl[1]);
                    split(Pw[g * PP + ks + t + 4], ph[2], pl[2]);
                    split(Pw[(g + 8) * PP + ks + t + 4], ph[3], pl[3]);
                    const float* v0 = Vs + (ks + t) * PV + ch + g;
#pragma unroll
                    for (int n = 0; n < DT; ++n) {
                        uint32_t bh2[2], bl2[2];
                        split(v0[n * 8], bh2[0], bl2[0]);
                        split(v0[4 * PV + n * 8], bh2[1], bl2[1]);
                        mma3(acc[n], ph, pl, bh2, bl2);
                    }
                }
            }
        }
        __syncthreads();            // this stage, V and P may be reused
    }

    // the pair's running sums join through shared memory (the ring is free
    // now); each warp writes its own columns
    float* lx = ring + (rg * 2 + half) * 64;
    const float* ly = ring + (rg * 2 + 1 - half) * 64;
    lx[lane] = l[0];
    lx[32 + lane] = l[1];
    __syncthreads();
    l[0] += ly[lane];
    l[1] += ly[32 + lane];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        float* out = ob + row[r] * a.st[10] + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            const int col = ch + n * 8 + 2 * t;
            if (col < width) {
                out[ch + n * 8] = acc[n][2 * r] / denom;
                out[ch + n * 8 + 1] = acc[n][2 * r + 1] / denom;
            }
        }
    }
}

}  // namespace

// q, k, v, o: float32 (B, H, S, D) views on the card, the last dim
// contiguous, D a multiple of 128; strides: 12 element strides, the
// (batch, sequence, head) strides of q, k, v and o in that order.
extern "C" int flash_attention_wide(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* strides, int B, int H,
                                    int S, int D, float scale, int causal,
                                    void* stream) {
    if (D <= 0 || D % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
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
    a.D = D;
    a.BH = B * H;
    a.nq = (S + BQ - 1) / BQ;
    a.scale = scale;
    a.causal = causal;
    a.vec16 = aligned ? 1 : 0;
    if (static_cast<long long>(a.nq) * a.BH > 2147483647LL || D / DV > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(static_cast<unsigned>(a.nq * a.BH),
              static_cast<unsigned>((D + DV - 1) / DV));
    flash_attention_wide_kernel<<<grid, THREADS, SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
