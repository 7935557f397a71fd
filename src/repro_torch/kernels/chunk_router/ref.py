"""Plain PyTorch versions of the routing kernels (the kernels' oracles)."""
from __future__ import annotations

import torch

_MASK31 = 0x7FFFFFFF


def dest_histogram_ref(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(n,) destinations → (n_bins,) int32 counts: a bincount of the values
    in [0, n_bins); the rest (the -1 sentinel, values past the last bin)
    go to one extra bin that is dropped."""
    inb = (dest >= 0) & (dest < n_bins)
    idx = torch.where(inb, dest, n_bins).long()
    return torch.bincount(idx, minlength=n_bins + 1)[:n_bins].to(torch.int32)


def dest_histogram2d_ref(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(L, q) destinations → (L, n_bins) int32 per-row counts.

    One-hot reduction over the slot axis; values outside [0, n_bins) match
    no bin (the exchange plan's invalid-request sentinel).
    """
    bins = torch.arange(n_bins, dtype=dest.dtype, device=dest.device)
    return (dest[..., None] == bins).sum(dim=1, dtype=torch.int32)


def mix_hash_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The FNV-style mix of the reference's ``mix_hash_i32`` on int32
    tensors → non-negative int32.  The 31-bit mask after every step keeps
    the int64 product below 2⁵⁶, so its low 32 bits are the uint32
    product's."""
    h = 0x811C9DC5
    for part in (a, b):
        h = ((h ^ (part.to(torch.int64) & 0xFFFFFFFF)) * 16777619) & _MASK31
        h = h ^ (h >> 15)
    return (h & _MASK31).to(torch.int32)


def route_chunks_ref(path_hash: torch.Tensor, chunk_id: torch.Tensor,
                     client: torch.Tensor, *, mode: int, n_nodes: int):
    """(n,) descriptors → (dest (n,), counts (n_nodes,)) int32.

    Modes 1/4 → ``client``; otherwise the mix mod ``n_nodes``.  Counts are
    per destination; destinations outside [0, n_nodes) count nowhere.
    """
    if mode in (1, 4):
        dest = client.to(torch.int32)
    else:
        dest = (mix_hash_i32(path_hash, chunk_id) % n_nodes).to(torch.int32)
    counts = dest_histogram2d_ref(dest[None], n_bins=n_nodes)[0]
    return dest, counts
