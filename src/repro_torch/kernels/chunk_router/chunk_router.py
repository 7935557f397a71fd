"""CUDA wrappers of the routing kernels: the destination histogram of one
vector (``csrc/dest_histogram.cu``); the exchange planner's per-row kernels
(``csrc/dest_histogram2d.cu``: the per-row histogram, a whole routing plan,
a ragged spec's budgets); and batched chunk routing
(``csrc/route_chunks.cu``: one vector of descriptors, or every chunk of a
checkpoint from its leaf table).

They replace ``dest_histogram_kernel``, ``dest_histogram2d_kernel`` (with
the plan the reference's ``_compact_plan`` and ``_compact_plan_ragged`` build
around it) and ``route_chunks_kernel`` of
``repro.kernels.chunk_router.chunk_router``; each source file's header says
what bounds it and how it is built.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, check_cuda

DEST_HISTOGRAM = CudaKernel(
    "dest_histogram",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_longlong])
# the largest n counted by one thread-block cluster in one launch; past it
# the kernel takes its grid path (a memset, then up to two blocks an SM),
# which was faster from 262,144 values on (chip_smoke.py's sweep on an H100
# 80GB HBM3 at 700 W: 4.39 us against 4.85 at 131,072, 6.47 against 4.90
# at 262,144)
CLUSTER_MAX_N = 1 << 17


def dest_histogram(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(n,) int32 CUDA destinations → (n_bins,) int32 counts (kernel).

    Values outside [0, n_bins) are counted nowhere; n = 0 gives zeros
    without a launch.  Up to ``CLUSTER_MAX_N`` values (and 12288 bins) it
    is one launch with no memset.  Raises on CPU tensors, other dtypes or
    non-contiguous input.
    """
    check_cuda("dest", dest, (torch.int32,), 1)
    if n_bins < 0 or n_bins > 50000:
        raise ValueError(f"n_bins must lie in [0, 50000], got {n_bins}")
    n = dest.numel()
    if n == 0 or n_bins == 0:
        return torch.zeros(n_bins, dtype=torch.int32, device=dest.device)
    counts = torch.empty(n_bins, dtype=torch.int32, device=dest.device)
    DEST_HISTOGRAM.launch(dest.data_ptr(), counts.data_ptr(), n, n_bins,
                          CLUSTER_MAX_N)
    return counts


DEST_HISTOGRAM2D = CudaKernel(
    "dest_histogram2d",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int])
#: the most bins (destinations + 1) a row's shared-memory counters take
MAX_BINS = 50000


def dest_histogram2d(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(L, q) int32 CUDA destinations → (L, n_bins) int32 counts (kernel).

    Values outside [0, n_bins) are counted nowhere.  Raises on CPU tensors,
    other dtypes or non-contiguous input.
    """
    check_cuda("dest", dest, (torch.int32,), 2)
    if n_bins < 0 or n_bins > MAX_BINS:
        raise ValueError(f"n_bins must lie in [0, {MAX_BINS}], got {n_bins}")
    L, q = dest.shape
    if q >= 2 ** 31 or L >= 2 ** 31:
        raise ValueError(f"dest shape {tuple(dest.shape)} too large")
    counts = torch.empty((L, n_bins), dtype=torch.int32, device=dest.device)
    if L == 0 or n_bins == 0:
        return counts
    DEST_HISTOGRAM2D.launch(dest.data_ptr(), counts.data_ptr(), L, q, n_bins)
    return counts


def _check_routing(dest: torch.Tensor, valid: torch.Tensor,
                   n_nodes: int) -> None:
    check_cuda("dest", dest, (torch.int32,), 2)
    check_cuda("valid", valid, (torch.bool,), 2, dest.device)
    if valid.shape != dest.shape:
        raise ValueError(f"valid {tuple(valid.shape)} and dest "
                         f"{tuple(dest.shape)} differ in shape")
    if not 1 <= n_nodes < MAX_BINS:
        raise ValueError(f"n_nodes must lie in [1, {MAX_BINS - 1}], got "
                         f"{n_nodes}")
    if dest.shape[0] >= 2 ** 31 or dest.shape[1] >= 2 ** 31:
        raise ValueError(f"dest shape {tuple(dest.shape)} too large")


ROUTE_PLAN = CudaKernel(
    "route_plan",
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong], source="dest_histogram2d")


def route_plan(dest: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
               *, total: int):
    """One exchange round's routing plan, one launch (kernel).

    dest (L, q) int32 and valid (L, q) bool on the card; table (2, N)
    int32 on the same card: per-destination budgets, then the offsets of
    their segments in a send row of ``total`` columns.  Returns
    (send_idx (L, total), reply_idx (L, q), overflow (L,), counts (L, N)),
    all int32: slot k of destination d's segment holds the request of
    rank k there (rank = earlier valid requests of the row to d) or -1
    past min(count, budget); a request's reply column is its send column,
    or -1 when it is invalid, routed outside [0, N) or past the budget;
    overflow counts those past the budget.  Raises on CPU tensors, other
    dtypes, mismatched shapes or non-contiguous input.
    """
    check_cuda("table", table, (torch.int32,), 2)
    if table.shape[0] != 2:
        raise ValueError(f"table must be (2, N), got {tuple(table.shape)}")
    n = table.shape[1]
    _check_routing(dest, valid, n)
    if table.device != dest.device:
        raise ValueError(f"table is on {table.device}, expected "
                         f"{dest.device}")
    if not 0 <= total < 2 ** 31:
        raise ValueError(f"total must lie in [0, 2^31), got {total}")
    L, q = dest.shape
    dev = dest.device
    send_idx = torch.empty((L, total), dtype=torch.int32, device=dev)
    reply_idx = torch.empty((L, q), dtype=torch.int32, device=dev)
    overflow = torch.empty(L, dtype=torch.int32, device=dev)
    counts = torch.empty((L, n), dtype=torch.int32, device=dev)
    if L:
        ROUTE_PLAN.launch(dest.data_ptr(), valid.data_ptr(),
                          table.data_ptr(), counts.data_ptr(),
                          send_idx.data_ptr(), reply_idx.data_ptr(),
                          overflow.data_ptr(), L, q, n, total)
    return send_idx, reply_idx, overflow, counts


DEST_BUDGETS = CudaKernel(
    "dest_budgets",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, source="dest_histogram2d")


def dest_budgets(dest: torch.Tensor, valid: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """(L, q) int32 destinations and bool validity on the card → (n_nodes,)
    int32: each destination's largest per-row count of valid requests, one
    launch (kernel).  Raises on CPU tensors, other dtypes, mismatched
    shapes or non-contiguous input."""
    _check_routing(dest, valid, n_nodes)
    budgets = torch.empty(n_nodes, dtype=torch.int32, device=dest.device)
    L, q = dest.shape
    DEST_BUDGETS.launch(dest.data_ptr(), valid.data_ptr(), budgets.data_ptr(),
                        L, q, n_nodes)
    return budgets


ROUTE_CHUNKS = CudaKernel(
    "route_chunks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int])


def route_chunks(path_hash: torch.Tensor, chunk_id: torch.Tensor,
                 client: torch.Tensor, *, mode: int, n_nodes: int):
    """(n,) int32 CUDA descriptors → (dest (n,), counts (n_nodes,)) int32
    (kernel).

    Modes 1 and 4 send a chunk to its ``client``; any other mode to the
    FNV mix of (path_hash, chunk_id) mod ``n_nodes``.  Destinations outside
    [0, n_nodes) are counted nowhere.  Raises on CPU tensors, other dtypes,
    mismatched lengths or non-contiguous input.
    """
    check_cuda("path_hash", path_hash, (torch.int32,), 1)
    check_cuda("chunk_id", chunk_id, (torch.int32,), 1, path_hash.device)
    check_cuda("client", client, (torch.int32,), 1, path_hash.device)
    n = path_hash.numel()
    if chunk_id.numel() != n or client.numel() != n:
        raise ValueError("path_hash, chunk_id and client differ in length")
    if n_nodes < 1 or n_nodes > 50000:
        raise ValueError(f"n_nodes must lie in [1, 50000], got {n_nodes}")
    dest = torch.empty(n, dtype=torch.int32, device=path_hash.device)
    counts = torch.empty(n_nodes, dtype=torch.int32, device=path_hash.device)
    ROUTE_CHUNKS.launch(path_hash.data_ptr(), chunk_id.data_ptr(),
                        client.data_ptr(), dest.data_ptr(), counts.data_ptr(),
                        n, int(mode), n_nodes)
    return dest, counts


ROUTE_CHUNKS_SEGMENTED = CudaKernel(
    "route_chunks_segmented",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int], source="route_chunks")


def route_chunks_segmented(leaves: torch.Tensor, n_chunks: int, *,
                           n_nodes: int) -> torch.Tensor:
    """Destinations of every chunk of a checkpoint: an (L, 3) int32 CUDA
    leaf table of rows (path_hash, mode, first chunk) → (n_chunks,) int32
    (kernel, one launch).

    Chunk i belongs to the last leaf whose first chunk is ≤ i; its
    destination is ``route_chunks``'s for that leaf's descriptor
    (path_hash, chunk id i − first, client chunk id mod ``n_nodes``) under
    the leaf's mode.  The table's first column of offsets must start at 0
    and never decrease (``leaf_table`` builds it).  Raises on CPU tensors,
    other dtypes, other shapes or non-contiguous input.
    """
    check_cuda("leaves", leaves, (torch.int32,), 2)
    L = leaves.shape[0]
    if leaves.shape[1] != 3 or not 1 <= L <= 50000:
        raise ValueError(f"leaves must be (L, 3) with 1 <= L <= 50000, got "
                         f"{tuple(leaves.shape)}")
    if n_nodes < 1 or n_nodes > 50000:
        raise ValueError(f"n_nodes must lie in [1, 50000], got {n_nodes}")
    if not 0 <= n_chunks < 2 ** 31:
        raise ValueError(f"n_chunks must lie in [0, 2^31), got {n_chunks}")
    dest = torch.empty(n_chunks, dtype=torch.int32, device=leaves.device)
    if n_chunks:
        ROUTE_CHUNKS_SEGMENTED.launch(leaves.data_ptr(), L, dest.data_ptr(),
                                      n_chunks, n_nodes)
    return dest
