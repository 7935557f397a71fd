// flash_attention_f32: blocked online-softmax attention, causal or full,
// over a float32 (B, H, S, D) view read through strides.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// flash_attention_bhsd (body _flash_kernel) for float32 inputs; bf16 inputs
// go to the Hopper kernel in flash_attention.cu.  For each (b, h) and query
// row i < S, with s_ij = (scale * q_i) . k_j in float32:
//
//     valid(i, j) = j < S and (not causal or j <= i)
//     s_ij        = valid ? s_ij : -1e30           (the reference's NEG_INF)
//     o_i         = sum_j softmax_j(s_ij) v_j / max(sum_j exp(...), 1e-30)
//
// computed blockwise with a running max m, running sum l and float32
// accumulator per query row, exactly the reference's online-softmax update
// (m_new = max(m, rowmax); p = exp(s - m_new); corr = exp(m - m_new);
// l = l * corr + sum p; acc = acc * corr + p v).  Every product and sum is
// a float32 FMA (no TF32, no fast-math exp): wgmma has no float32 path that
// holds the reference's 2e-5, so this kernel stays on the SIMT pipes.
//
// Bound on an H100: at gemma3-1b's global-attention shape (B 4, S 1024,
// H 4, D 256, causal) the work is 4*B*H*D*S(S+1)/2 = 8.6 GFLOP over 67 MB
// of float32 q/k/v/o; on the float32 SIMT pipes (67 TFLOP/s) that takes at
// least 0.128 ms, and the bytes 0.020 ms.
//
// Design: one block of 256 threads per (batch*head, 64-query tile); the
// loop over 64-key tiles inside the block takes the place of the TPU's
// sequential kv grid axis, and in causal mode it stops at the diagonal tile
// (the tiles the Pallas kernel skips with pl.when).  Blocks are numbered so
// the last query tiles, which walk the most kv tiles, start first.  Thread
// (ty, tx) of a 16 x 16 layout owns query rows ty + 16i (i < 4), score
// columns tx + 16j (j < 4) and output columns tx + 16j (j < D/16), so a
// row's statistics are reduced with shuffles inside one half-warp.  Shared
// memory, all float32 with odd row pitches so that column reads are free of
// bank conflicts:
//
//     Qs  64 x (D+1)   the query tile, scaled on load
//     KVs 64 x (D+1)   the key tile, then the value tile in the same buffer
//     Ps  64 x 65      the probabilities of the current tile
//
// At D = 256 that is 148,224 bytes, one block per SM; at D = 128 82,688
// (two); at D = 80 58,112 and at D = 64 49,920 (three or four).  Sharing
// one buffer for K and V instead of two is what keeps D = 256 within the
// 227 KB a block may use (with separate K and V tiles it would need
// 214 KB).  Every size is above 48 KB, so the entry point opts in with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) before each launch.
// Head dims taken: 64, 80, 128, 256 (the JAX sweep and gemma3-1b); the
// wrapper raises on others.
//
// Compiler report (nvcc -Xptxas -v, sm_90a, CUDA 12.8), registers a thread,
// stack, spills; shared memory is all dynamic (sizes above):
//
//     D = 256: 190 registers, no stack, no spills
//     D = 128: 128 registers, no spills
//     D = 80, 64: 64 registers, no spills

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows a block
constexpr int BK = 64;            // keys a kv tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int RI = BQ / 16;       // rows a thread owns
constexpr int CJ = BK / 16;       // score columns a thread owns
constexpr int PP = BK + 1;        // pitch of Ps
constexpr float NEG_INF = -1e30f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long st[12];             // (b, s, h) strides of q, k, v, o
    int H, S, BH, nq;
    float scale;
    int causal;
};

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * BQ * (D + 1) + BQ * PP);
}

// Rows [row0, row0 + 64) of one (b, h) slice into a 64 x (D+1) float
// tile, times mul; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long s_stride, int row0,
                                          int S, float mul) {
    for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
        const int r = idx / D;
        const int d = idx - r * D;
        const int row = row0 + r;
        float x = 0.f;
        if (row < S) x = base[row * s_stride + d] * mul;
        dst[r * (D + 1) + d] = x;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const Args a) {
    extern __shared__ float smem[];
    float* Qs = smem;
    float* KVs = Qs + BQ * (D + 1);
    float* Ps = KVs + BK * (D + 1);
    constexpr int DJ = D / 16;    // output columns a thread owns

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int qt = a.nq - 1 - static_cast<int>(blockIdx.x / a.BH);
    const int bh = static_cast<int>(blockIdx.x % a.BH);
    const int b = bh / a.H, h = bh % a.H;
    const int q0 = qt * BQ;
    const int S = a.S;

    const float* qb =
        static_cast<const float*>(a.q) + b * a.st[0] + h * a.st[2];
    const float* kb =
        static_cast<const float*>(a.k) + b * a.st[3] + h * a.st[5];
    const float* vb =
        static_cast<const float*>(a.v) + b * a.st[6] + h * a.st[8];
    float* ob = static_cast<float*>(a.o) + b * a.st[9] + h * a.st[11];

    load_tile<D>(Qs, qb, a.st[1], q0, S, a.scale);

    float acc[RI][DJ];
    float m[RI], l[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    }

    const int nk = (S + BK - 1) / BK;
    int kt_end = nk;
    if (a.causal) {
        const int last = (q0 + BQ - 1) / BK + 1;   // past the diagonal tile
        kt_end = last < nk ? last : nk;
    }
    for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // the previous tile's V is read
        load_tile<D>(KVs, kb, a.st[4], k0, S, 1.f);
        __syncthreads();

        float s[RI][CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float qv[RI], kv[CJ];
#pragma unroll
            for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
            for (int j = 0; j < CJ; ++j) kv[j] = KVs[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const bool ok = kpos < S && (!a.causal || kpos <= qpos);
                s[i][j] = ok ? s[i][j] : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                const float p = expf(s[i][j] - m_new);
                sum += p;
                Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();              // K is read, Ps is written
        load_tile<D>(KVs, vb, a.st[7], k0, S, 1.f);
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float pv[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const float vv = KVs[c * (D + 1) + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        float* out = ob + row * a.st[10];
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            out[tx + 16 * j] = acc[i][j] / denom;
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
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
    a.H = H;
    a.S = S;
    a.BH = B * H;
    a.nq = (S + BQ - 1) / BQ;
    a.scale = scale;
    a.causal = causal;
    if (static_cast<long long>(a.nq) * a.BH > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dispatch(a, D, s);
}
