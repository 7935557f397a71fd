"""Entry points of the routing kernels: kernel on CUDA, plain version on the
CPU (the twin of ``repro.kernels.chunk_router.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.chunk_router import chunk_router as cuda
from repro_torch.kernels.chunk_router.chunk_router import (  # noqa: F401
    dest_histogram, dest_histogram2d)
from repro_torch.kernels.chunk_router.ref import (dest_histogram2d_ref,
                                                  dest_histogram_ref,
                                                  route_chunks_ref)


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
    a CPU tensor through the bit-identical plain version.  The exchange
    planner calls this once per round, and the client on the measured
    destinations of a call to size its ragged budgets.
    """
    if dest.is_cuda:
        return dest_histogram2d(dest, n_bins=n_bins)
    if dest.device.type == "cpu":
        return dest_histogram2d_ref(dest, n_bins=n_bins)
    raise ValueError(f"histogram_rows2d: unsupported device {dest.device}")


def route_chunks(path_hash: torch.Tensor, chunk_id: torch.Tensor,
                      client: torch.Tensor, *, mode: int, n_nodes: int):
    """Destinations and per-destination counts of a batch of chunk
    descriptors: (n,) int32 each → ((n,), (n_nodes,)) int32.

    A CUDA batch goes through the ``route_chunks`` kernel (or raises), a
    CPU batch through the bit-identical plain version.  The checkpoint
    store routes each leaf's chunks with one call, on save and on restore.
    """
    if path_hash.is_cuda:
        return cuda.route_chunks(path_hash, chunk_id, client, mode=mode,
                                 n_nodes=n_nodes)
    if path_hash.device.type == "cpu":
        return route_chunks_ref(path_hash, chunk_id, client, mode=mode,
                                n_nodes=n_nodes)
    raise ValueError(f"route_chunks: unsupported device "
                     f"{path_hash.device}")
