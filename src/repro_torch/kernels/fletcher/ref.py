"""Plain PyTorch version of the per-chunk Fletcher checksum (the kernel's
oracle), exact in int64 like ``repro.kernels.fletcher.ref.fletcher_ref``."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

P = 46337  # prime with P*P < 2^31
SLAB_CHUNKS = 1024  # chunks fletcher_segmented_ref sums at a time


def n_chunks_of(n_words: int, chunk_words: int) -> int:
    """Chunks of ``chunk_words`` covering ``n_words`` (at least one, so an
    empty leaf still has one, empty, chunk)."""
    return max(1, -(-n_words // chunk_words))


def fletcher_chunks_ref(words: torch.Tensor, chunk_words: int
                        ) -> torch.Tensor:
    """(n,) int32 words → (n_chunks, 2) int32 checksums (s1, s2).

    Chunk c covers words [c·chunk_words, (c+1)·chunk_words); positions
    restart at 1 in every chunk.  ``|w|`` is taken in int64, so the word
    0x80000000 counts as 2³¹ (as in ``fletcher_ref``).
    """
    if chunk_words < 1:
        raise ValueError(f"chunk_words must be >= 1, got {chunk_words}")
    n = words.numel()
    nc = n_chunks_of(n, chunk_words)
    idx = torch.arange(n, dtype=torch.int64, device=words.device)
    chunk = idx // chunk_words
    w = words.reshape(-1).to(torch.int64).abs() % P
    pos = (idx - chunk * chunk_words + 1) % P
    s1 = torch.zeros(nc, dtype=torch.int64, device=words.device)
    s2 = torch.zeros(nc, dtype=torch.int64, device=words.device)
    s1.index_add_(0, chunk, w)
    s2.index_add_(0, chunk, (w * pos) % P)
    return torch.stack([s1 % P, s2 % P], dim=1).to(torch.int32)


def fletcher_ref(words: torch.Tensor) -> torch.Tensor:
    """(n,) int32 words → (2,) int32: the whole array as one chunk."""
    return fletcher_chunks_ref(words, max(1, words.numel()))[0]


def fletcher_segmented_ref(words: Sequence[torch.Tensor], chunk_words: int
                           ) -> torch.Tensor:
    """L (n_l,) int32 word vectors → (Σ max(1, ceil(n_l / chunk_words)), 2)
    int32: every leaf's chunk checksums, leaf after leaf.

    Computed apart from ``fletcher_chunks_ref``: each leaf is zero-padded to
    whole chunks and summed row by row as a (chunks, chunk_words) matrix
    (a zero word adds nothing), ``SLAB_CHUNKS`` rows at a time so a large
    leaf's int64 temporaries stay small.
    """
    if chunk_words < 1:
        raise ValueError(f"chunk_words must be >= 1, got {chunk_words}")
    pos = None
    out = []
    for w in words:
        w = w.reshape(-1)
        nc = n_chunks_of(w.numel(), chunk_words)
        if pos is None:
            pos = torch.arange(1, chunk_words + 1, dtype=torch.int64,
                               device=w.device) % P
        for r0 in range(0, nc, SLAB_CHUNKS):
            r1 = min(nc, r0 + SLAB_CHUNKS)
            seg = w[r0 * chunk_words:r1 * chunk_words].to(torch.int64)
            a = F.pad(seg.abs() % P, (0, (r1 - r0) * chunk_words -
                                      seg.numel())).view(r1 - r0, -1)
            out.append(torch.stack([a.sum(1) % P,
                                    ((a * pos) % P).sum(1) % P], dim=1))
    if not out:
        return torch.empty((0, 2), dtype=torch.int32)
    return torch.cat(out).to(torch.int32)
