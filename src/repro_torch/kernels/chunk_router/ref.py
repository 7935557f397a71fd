"""Plain PyTorch version of the destination histogram (the kernel's oracle)."""
from __future__ import annotations

import torch


def dest_histogram2d_ref(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(L, q) destinations → (L, n_bins) int32 per-row counts.

    One-hot reduction over the slot axis; values outside [0, n_bins) match
    no bin (the exchange plan's invalid-request sentinel).
    """
    bins = torch.arange(n_bins, dtype=dest.dtype, device=dest.device)
    return (dest[..., None] == bins).sum(dim=1, dtype=torch.int32)
