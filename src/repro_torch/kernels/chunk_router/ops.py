"""Engine entry point of the destination histogram: kernel on CUDA, plain
version on the CPU (the twin of ``repro.kernels.chunk_router.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.chunk_router.chunk_router import dest_histogram2d
from repro_torch.kernels.chunk_router.ref import dest_histogram2d_ref


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
