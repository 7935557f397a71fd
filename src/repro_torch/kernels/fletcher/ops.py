"""Entry points of the Fletcher checksum: kernel on CUDA, plain version on
the CPU (the twin of ``repro.kernels.fletcher.ops``)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.fletcher.fletcher import (fletcher_chunks,
                                                   fletcher_segmented)
from repro_torch.kernels.fletcher.ref import (fletcher_chunks_ref,
                                              fletcher_segmented_ref)


def as_words(x: torch.Tensor) -> torch.Tensor:
    """Any contiguous tensor's bytes as a flat int32 tensor (a view when the
    byte count is a multiple of 4, else a copy zero-padded to one, as the
    checkpoint manager pads a leaf)."""
    flat = x.contiguous().reshape(-1)
    if flat.dtype == torch.int32:
        return flat
    raw = flat.view(torch.uint8)
    pad = -raw.numel() % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32)


def chunk_checksums(words: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """Per-chunk checksums: (n,) int32 → (max(1, ceil(n/chunk_words)), 2).

    A CUDA tensor goes through the ``fletcher`` kernel (or raises), one
    launch for all chunks; a CPU tensor through the bit-identical plain
    version.
    """
    if words.is_cuda:
        return fletcher_chunks(words, chunk_words)
    if words.device.type == "cpu":
        return fletcher_chunks_ref(words, chunk_words)
    raise ValueError(f"chunk_checksums: unsupported device {words.device}")



def leaf_checksums(words: Sequence[torch.Tensor], chunk_words: int
                   ) -> torch.Tensor:
    """Per-chunk checksums of many leaves, leaf after leaf: L (n_l,) int32
    word vectors → (Σ max(1, ceil(n_l / chunk_words)), 2) int32.

    Leaves on a card go through the ``fletcher_segmented`` kernel (or
    raise), one launch for all of them; leaves on the CPU through the
    bit-identical plain version.  The checkpoint manager checksums a whole
    save with one call, and a restore with one call per group of leaves.
    """
    if not words:
        return torch.empty((0, 2), dtype=torch.int32)
    if words[0].is_cuda:
        return fletcher_segmented(words, chunk_words)
    if words[0].device.type == "cpu":
        return fletcher_segmented_ref(words, chunk_words)
    raise ValueError(f"leaf_checksums: unsupported device {words[0].device}")
