"""Entry points of the routing kernels: kernel on CUDA, plain version on the
CPU (the twin of ``repro.kernels.chunk_router.ops``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.chunk_router import chunk_router as cuda
from repro_torch.kernels.chunk_router.chunk_router import (  # noqa: F401
    dest_histogram, dest_histogram2d)
from repro_torch.kernels.chunk_router.ref import (dest_budgets_ref,
                                                  dest_histogram2d_ref,
                                                  dest_histogram_ref,
                                                  route_chunks_ref,
                                                  route_chunks_segmented_ref,
                                                  route_plan_ref)


def histogram_rows(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Per-destination counts of one vector: (n,) int32 → (n_bins,) int32.

    A CUDA tensor goes through the ``dest_histogram`` kernel (or raises); a
    CPU tensor through the bit-identical plain version.  Values outside
    [0, n_bins) are counted nowhere.
    """
    if dest.is_cuda:
        return dest_histogram(dest, n_bins=n_bins)
    if dest.device.type == "cpu":
        return dest_histogram_ref(dest, n_bins=n_bins)
    raise ValueError(f"histogram_rows: unsupported device {dest.device}")


def histogram_rows2d(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """Per-(row, destination) counts: (L, q) int32 → (L, n_bins) int32.

    A CUDA tensor goes through the ``dest_histogram2d`` kernel (or raises);
    a CPU tensor through the bit-identical plain version.  The client
    calls it to bound a uniform round's carry (``_carry_hint``); the
    planner's rounds and specs take ``route_plan`` and ``dest_budgets``.
    """
    if dest.is_cuda:
        return dest_histogram2d(dest, n_bins=n_bins)
    if dest.device.type == "cpu":
        return dest_histogram2d_ref(dest, n_bins=n_bins)
    raise ValueError(f"histogram_rows2d: unsupported device {dest.device}")


def route_plan(dest: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
               *, total: int):
    """One exchange round's routing plan: (L, q) int32 destinations and
    bool validity, a (2, N) int32 budget/offset table on the same device →
    (send_idx (L, total), reply_idx (L, q), overflow (L,), counts (L, N))
    int32.

    CUDA tensors go through the ``route_plan`` kernel, one launch (or
    raise); CPU tensors through the bit-identical plain version.  The
    exchange planner calls this once per round, uniform or ragged.
    """
    if dest.is_cuda:
        return cuda.route_plan(dest, valid, table, total=total)
    if dest.device.type == "cpu":
        return route_plan_ref(dest, valid, table, total=total)
    raise ValueError(f"route_plan: unsupported device {dest.device}")


def dest_budgets(dest: torch.Tensor, valid: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """Each destination's largest per-row count of valid requests:
    (L, q) int32 and bool → (n_nodes,) int32.

    CUDA tensors go through the ``dest_budgets`` kernel, one launch (or
    raise); CPU tensors through the bit-identical plain version.  The
    planner measures a ragged spec with it.
    """
    if dest.is_cuda:
        return cuda.dest_budgets(dest, valid, n_nodes)
    if dest.device.type == "cpu":
        return dest_budgets_ref(dest, valid, n_nodes)
    raise ValueError(f"dest_budgets: unsupported device {dest.device}")


def route_chunks(path_hash: torch.Tensor, chunk_id: torch.Tensor,
                      client: torch.Tensor, *, mode: int, n_nodes: int):
    """Destinations and per-destination counts of a batch of chunk
    descriptors: (n,) int32 each → ((n,), (n_nodes,)) int32.

    A CUDA batch goes through the ``route_chunks`` kernel (or raises), a
    CPU batch through the bit-identical plain version.
    """
    if path_hash.is_cuda:
        return cuda.route_chunks(path_hash, chunk_id, client, mode=mode,
                                 n_nodes=n_nodes)
    if path_hash.device.type == "cpu":
        return route_chunks_ref(path_hash, chunk_id, client, mode=mode,
                                n_nodes=n_nodes)
    raise ValueError(f"route_chunks: unsupported device "
                     f"{path_hash.device}")


def leaf_table(path_hashes: Sequence[int], modes: Sequence[int],
               n_chunks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The (L, 3) int32 leaf table of ``route_leaves`` — rows (path_hash,
    mode, first chunk) — and the L + 1 chunk offsets that cut its
    destinations back into leaves."""
    offsets = np.zeros(len(n_chunks) + 1, np.int64)
    np.cumsum(n_chunks, out=offsets[1:])
    table = np.stack([np.asarray(path_hashes, np.int64),
                      np.asarray(modes, np.int64), offsets[:-1]], axis=1)
    return table.astype(np.int32).reshape(-1, 3), offsets


def route_leaves(table: np.ndarray, n_chunks: int, *, n_nodes: int,
                 device) -> torch.Tensor:
    """Destinations of every chunk of a checkpoint, leaf after leaf: the
    leaf table goes to ``device`` in one copy, then through the
    ``route_chunks_segmented`` kernel (one launch) on a card, or its
    bit-identical plain version on the CPU.  The checkpoint manager routes
    a whole save, and a whole restore, with one call."""
    leaves = torch.as_tensor(table, device=device)
    if n_chunks == 0:
        return torch.empty(0, dtype=torch.int32, device=leaves.device)
    if leaves.is_cuda:
        return cuda.route_chunks_segmented(leaves, n_chunks, n_nodes=n_nodes)
    if leaves.device.type == "cpu":
        return route_chunks_segmented_ref(leaves, n_chunks, n_nodes=n_nodes)
    raise ValueError(f"route_leaves: unsupported device {leaves.device}")
