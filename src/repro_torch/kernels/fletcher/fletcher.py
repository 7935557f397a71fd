"""CUDA wrappers of the Fletcher checksum kernels (``csrc/fletcher.cu``): the
chunks of one vector of words, and the chunks of many leaves in one launch.

Both replace ``repro.kernels.fletcher.fletcher.fletcher_kernel``; the source
file's header says what bounds them and how they are built.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import CudaKernel, check_cuda
from repro_torch.kernels.fletcher.ref import n_chunks_of

SLICE = 1 << 16            # words one block reads (csrc/fletcher.cu)

FLETCHER = CudaKernel(
    "fletcher",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong])


def fletcher_chunks(words: torch.Tensor, chunk_words: int) -> torch.Tensor:
    """(n,) int32 CUDA words → (n_chunks, 2) int32 per-chunk checksums
    (kernel), n_chunks = max(1, ceil(n / chunk_words)).

    Raises on CPU tensors, other dtypes, non-contiguous input or a chunk
    longer than the kernel's grid covers.
    """
    check_cuda("words", words, (torch.int32,), 1)
    if chunk_words < 1:
        raise ValueError(f"chunk_words must be >= 1, got {chunk_words}")
    n = words.numel()
    nc = n_chunks_of(n, chunk_words)
    slices = -(-min(chunk_words, max(n, 1)) // SLICE)
    if slices > 65535 or nc >= 2 ** 31:
        raise ValueError(f"{n} words in chunks of {chunk_words} exceed the "
                         f"kernel's grid")
    out = torch.empty((nc, 2), dtype=torch.int32, device=words.device)
    partial = torch.empty((nc, slices, 2), dtype=torch.int64,
                          device=words.device)
    FLETCHER.launch(words.data_ptr(), out.data_ptr(), partial.data_ptr(), n,
                    chunk_words, nc, slices)
    return out


FLETCHER_SEGMENTED = CudaKernel(
    "fletcher_segmented",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong], source="fletcher")


def fletcher_segmented(words: Sequence[torch.Tensor], chunk_words: int
                       ) -> torch.Tensor:
    """Checksums of every chunk of many leaves: L (n_l,) int32 CUDA word
    vectors → (Σ max(1, ceil(n_l / chunk_words)), 2) int32, leaf after
    leaf (kernel, one launch).

    Row ``first_l + c`` is ``fletcher_chunks(words[l], chunk_words)[c]``.
    The leaf table (pointer, length, first chunk) goes to the card in one
    copy that does not wait for the stream.  Raises on an empty list, CPU
    tensors, leaves on different cards, other dtypes, non-contiguous
    leaves, or ``chunk_words`` outside [1, SLICE].
    """
    if not words:
        raise ValueError("fletcher_segmented needs at least one leaf")
    if len(words) > 1 << 24:
        raise ValueError(f"{len(words)} leaves exceed the kernel's table")
    if not 1 <= chunk_words <= SLICE:
        raise ValueError(f"chunk_words must lie in [1, {SLICE}], got "
                         f"{chunk_words}")
    dev = words[0].device
    for i, w in enumerate(words):
        check_cuda(f"words[{i}]", w, (torch.int32,), 1, dev)
    n = np.asarray([w.numel() for w in words], np.int64)
    first = np.zeros(len(words) + 1, np.int64)
    np.cumsum(np.maximum(1, -(-n // chunk_words)), out=first[1:])
    n_chunks = int(first[-1])
    if n_chunks >= 2 ** 31:
        raise ValueError(f"{n_chunks} chunks exceed the kernel's grid")
    table = np.stack([np.asarray([w.data_ptr() for w in words], np.int64),
                      n, first[:-1]], axis=1)
    # page-locked and non-blocking, so the copy does not wait for the
    # stream's earlier work
    leaves = torch.as_tensor(table).pin_memory().to(dev, non_blocking=True)
    out = torch.empty((n_chunks, 2), dtype=torch.int32, device=dev)
    FLETCHER_SEGMENTED.launch(leaves.data_ptr(), len(words), out.data_ptr(),
                              n_chunks, chunk_words)
    return out
