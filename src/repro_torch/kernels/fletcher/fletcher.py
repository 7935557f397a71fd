"""CUDA wrapper of the Fletcher checksum kernel (``csrc/fletcher.cu``).

Replaces ``repro.kernels.fletcher.fletcher.fletcher_kernel``; the source
file's header says what bounds it and how it is built.
"""
from __future__ import annotations

import ctypes

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
