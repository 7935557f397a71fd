// dest_histogram2d: the exchange planner's routing kernels, one warp a row.
//
// Replaces the Pallas kernel repro/kernels/chunk_router/chunk_router.py
// dest_histogram2d_kernel (body _hist2d_kernel, one-hot reduction
// _block_counts) and, around it, the routing plan the reference builds from
// it (repro/core/exchange_plan.py _compact_plan and _compact_plan_ragged:
// stable argsort, histogram, exclusive cumsum, gathers and a scatter).
// Three entry points:
//
// * dest_histogram2d: counts[r, b] = #{j : dest[r, j] == b}, (L, q) int32
//   -> (L, n_bins) int32; values outside [0, n_bins) count nowhere.
// * route_plan: one uniform or ragged exchange round's whole plan.  With
//   budget[d] and offset[d] from an (2, n) int32 table, and rank[j] =
//   #{i < j : valid[i], dest[i] == dest[j]} (the position the stable sort
//   gives slot j in its destination's run), per row r:
//     counts[r, d]             histogram of the valid slots;
//     send_idx[r, offset[d]+k] the slot of rank k at d for k < min(counts,
//                              budget), -1 for the other k < budget[d];
//     reply_idx[r, j]          offset[d] + rank[j] when slot j is valid and
//                              rank[j] < budget[d], else -1;
//     overflow[r]              sum_d max(0, counts[r, d] - budget[d]).
//   Slots that are invalid or whose destination lies outside [0, n) count
//   nowhere (the reference's sentinel bin).
// * dest_budgets: budgets[d] = max_r counts[r, d], the measured ragged
//   spec's per-destination budgets before quantisation.
//
// Bound on an H100: at the planner's shapes (L = 32 nodes, q = 8 requests,
// n = 32) a plan reads ~1.6 KB and writes ~38 KB, nanoseconds of memory
// time: the launch, not memory or arithmetic, bounds it.  So the design
// puts the whole plan in one launch where the reference composes ~35
// operations, and reads the spec's table from the card.
//
// Design: one warp per row; a block takes as few rows as spread the rows
// over the SMs in one wave (the deployment's 32 rows: 32 blocks of one
// warp), at most 32 and as many as fit (each row keeps n + 1 int32
// counters in shared memory, the last one the sentinel bin).  The row is
// walked in 32-slot chunks in slot order.  __match_any_sync on the chunk's
// destinations gives each lane the mask of its peers; the group's leader
// adds __popc(peers) to the counter.  Pass 1 leaves the row's counts in the
// counters.  The plan then writes counts and overflow, fills the row's
// send columns with -1 (coalesced: a lane per pad run puts 32 segments in
// every store instruction), resets the counters and walks the chunks
// again: a slot's rank is its destination's counter before the chunk plus
// its lower peers (__popc(peers & lanemask_lt)); only then does the leader
// advance the counter, and a rank below the budget is scattered over the
// fill (the __syncwarp that ends the reset orders the two writes).  Ranks
// follow the slot order, never the order of atomics, so the plan is
// deterministic and equals the stable sort's bit for bit.  No per-slot
// storage, so any q.  The table's offsets must be the exclusive prefix sum
// of its budgets (segments in destination order).  The TPU kernel's
// (q, n_bins) one-hot block is not carried over: it would cost q * n_bins
// compares a row where the peer masks cost q / 32 matches.
// dest_budgets runs pass 1 of every row in one block and takes the column
// maximum with atomicMax on the output, which the block zeroes first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;
constexpr int MAX_SMEM = 232448;        // bytes a block may opt into on sm_90

// Destination of slot j, or the sentinel n for a slot past the row, an
// invalid one (valid may be null: every slot valid) or one outside [0, n).
__device__ __forceinline__ int slot_dest(const int32_t* __restrict__ dest,
                                         const uint8_t* __restrict__ valid,
                                         int j, int q, int n) {
    if (j >= q) return n;
    if (valid != nullptr && valid[j] == 0) return n;
    const int d = dest[j];
    return (d >= 0 && d < n) ? d : n;
}

__device__ __forceinline__ void zero_counters(int32_t* cnt, int n, int lane) {
    for (int d = lane; d <= n; d += 32) cnt[d] = 0;
    __syncwarp();
}

// Pass 1: cnt[0..n] (zeroed) += the row's histogram, sentinel in cnt[n].
__device__ __forceinline__ void count_row(const int32_t* __restrict__ dest,
                                          const uint8_t* __restrict__ valid,
                                          int q, int n, int32_t* cnt,
                                          int lane) {
    for (int base = 0; base < q; base += 32) {
        const int d = slot_dest(dest, valid, base + lane, q, n);
        const unsigned peers = __match_any_sync(FULL, d);
        if (lane == __ffs(peers) - 1) cnt[d] += __popc(peers);
        __syncwarp();
    }
}

__global__ void histogram_kernel(const int32_t* __restrict__ dest,
                                 int32_t* __restrict__ counts, int L, int q,
                                 int n) {
    extern __shared__ int32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                        + warp;
    if (row >= L) return;                      // whole warps only
    int32_t* cnt = smem + warp * (n + 1);
    zero_counters(cnt, n, lane);
    count_row(dest + row * q, nullptr, q, n, cnt, lane);
    for (int d = lane; d < n; d += 32) counts[row * n + d] = cnt[d];
}

__global__ void route_plan_kernel(const int32_t* __restrict__ dest,
                                  const uint8_t* __restrict__ valid,
                                  const int32_t* __restrict__ table,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ send_idx,
                                  int32_t* __restrict__ reply_idx,
                                  int32_t* __restrict__ overflow, int L,
                                  int q, int n, int64_t total) {
    extern __shared__ int32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                        + warp;
    if (row >= L) return;                      // whole warps only
    const int32_t* budget = table;
    const int32_t* offset = table + n;
    if (lane < n) {
        // the table's lines into L1 while pass 1 runs: the counts loop and
        // pass 2's data-dependent budget[d] and offset[d] then hit L1
        asm volatile("prefetch.global.L1 [%0];" :: "l"(budget + lane));
        asm volatile("prefetch.global.L1 [%0];" :: "l"(offset + lane));
    }
    const int32_t* drow = dest + row * q;
    const uint8_t* vrow = valid + row * q;
    int32_t* send = send_idx + row * total;
    int32_t* cnt = smem + warp * (n + 1);
    zero_counters(cnt, n, lane);
    count_row(drow, vrow, q, n, cnt, lane);

    // counts, overflow and the -1 fill; lane owns d = lane mod 32 here and
    // in the reset, so it reads its counters before it zeroes them
    int over = 0;
    for (int d = lane; d < n; d += 32) {
        const int c = cnt[d], b = budget[d];
        counts[row * n + d] = c;
        over += c > b ? c - b : 0;
    }
    for (int64_t c = lane; c < total; c += 32) send[c] = -1;
    zero_counters(cnt, n, lane);
    for (int s = 16; s > 0; s >>= 1) over += __shfl_xor_sync(FULL, over, s);
    if (lane == 0) overflow[row] = over;

    // pass 2: ranks in slot order, the scatter and the reply index
    const unsigned lower = (1u << lane) - 1u;
    for (int base = 0; base < q; base += 32) {
        const int j = base + lane;
        const int d = slot_dest(drow, vrow, j, q, n);
        const unsigned peers = __match_any_sync(FULL, d);
        const int before = cnt[d];
        __syncwarp();                          // every peer read `before`
        if (lane == __ffs(peers) - 1) cnt[d] = before + __popc(peers);
        __syncwarp();
        if (j < q) {
            int slot = -1;
            if (d < n) {
                const int rank = before + __popc(peers & lower);
                if (rank < budget[d]) {
                    slot = offset[d] + rank;
                    send[slot] = j;
                }
            }
            reply_idx[row * q + j] = slot;
        }
    }
}

__global__ void dest_budgets_kernel(const int32_t* __restrict__ dest,
                                    const uint8_t* __restrict__ valid,
                                    int32_t* __restrict__ budgets, int L,
                                    int q, int n) {
    extern __shared__ int32_t smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int d = threadIdx.x; d < n; d += blockDim.x) budgets[d] = 0;
    __syncthreads();                           // zeros before any atomicMax
    int32_t* cnt = smem + warp * (n + 1);
    for (int64_t row = warp; row < L; row += warps) {
        zero_counters(cnt, n, lane);
        count_row(dest + row * q, valid + row * q, q, n, cnt, lane);
        for (int d = lane; d < n; d += 32) {
            const int c = cnt[d];
            if (c > 0) atomicMax(budgets + d, c);
        }
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || sms <= 0)
            sms = 132;
    }
    return sms;
}

// Rows (warps) a block takes, each with n + 1 counters in shared memory:
// as few as spread L rows over the SMs in one wave (a warp alone on its
// SM issues its latency-bound chain fastest, and its stores have the SM's
// path to L2 to themselves), at most 32 and as many as fit; 0 if not even
// one fits.
int rows_per_block(int L, int n) {
    const int64_t per_row = static_cast<int64_t>(n + 1) * sizeof(int32_t);
    int64_t rows = (L + sm_count() - 1) / sm_count();
    if (rows > MAX_WARPS) rows = MAX_WARPS;
    if (rows > MAX_SMEM / per_row) rows = MAX_SMEM / per_row;
    return static_cast<int>(rows);
}

// Opt the kernel into `smem` bytes of dynamic shared memory where that is
// above the default 48 KB (once per size reached).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* granted) {
    if (smem <= 48 * 1024 || smem <= *granted) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) *granted = smem;
    return err;
}

size_t granted_hist = 0, granted_plan = 0, granted_budgets = 0;

}  // namespace

// dest: (L, q) int32, counts: (L, n_bins) int32, both contiguous on the card.
extern "C" int dest_histogram2d(const void* dest, void* counts, int L, int q,
                                int n_bins, void* stream) {
    if (L <= 0 || n_bins <= 0) return 0;
    const int rows = rows_per_block(L, n_bins);
    if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(rows) * (n_bins + 1) * 4;
    cudaError_t err = allow_smem(histogram_kernel, smem, &granted_hist);
    if (err != cudaSuccess) return static_cast<int>(err);
    histogram_kernel<<<(L + rows - 1) / rows, rows * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest), static_cast<int32_t*>(counts), L,
        q, n_bins);
    return static_cast<int>(cudaGetLastError());
}

// dest (L, q) int32, valid (L, q) bool, table (2, n) int32 [budget; offset];
// out: counts (L, n), send_idx (L, total), reply_idx (L, q), overflow (L,),
// all int32 and contiguous on the card.
extern "C" int route_plan(const void* dest, const void* valid,
                          const void* table, void* counts, void* send_idx,
                          void* reply_idx, void* overflow, int L, int q,
                          int n, long long total, void* stream) {
    if (L <= 0) return 0;
    const int rows = rows_per_block(L, n);
    if (n <= 0 || rows == 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(rows) * (n + 1) * 4;
    cudaError_t err = allow_smem(route_plan_kernel, smem, &granted_plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    route_plan_kernel<<<(L + rows - 1) / rows, rows * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(table), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(send_idx), static_cast<int32_t*>(reply_idx),
        static_cast<int32_t*>(overflow), L, q, n,
        static_cast<int64_t>(total));
    return static_cast<int>(cudaGetLastError());
}

// dest (L, q) int32, valid (L, q) bool -> budgets (n,) int32: one block.
extern "C" int dest_budgets(const void* dest, const void* valid,
                            void* budgets, int L, int q, int n,
                            void* stream) {
    if (n <= 0) return 0;
    int rows = MAX_SMEM / ((n + 1) * 4);
    if (rows > MAX_WARPS) rows = MAX_WARPS;
    if (rows > L) rows = L > 0 ? L : 1;
    if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(rows) * (n + 1) * 4;
    cudaError_t err = allow_smem(dest_budgets_kernel, smem, &granted_budgets);
    if (err != cudaSuccess) return static_cast<int>(err);
    dest_budgets_kernel<<<1, rows * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dest),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(budgets),
        L, q, n);
    return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the same launch path, for the launch floor that
// chip_smoke.py times beside route_plan.
namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int launch_floor(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
