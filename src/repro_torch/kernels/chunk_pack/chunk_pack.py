"""CUDA wrapper of the send-order gather kernel (``csrc/pack_chunks.cu``).

Replaces ``repro.kernels.chunk_pack.chunk_pack.pack_chunks_kernel``; the
source file's header says what bounds it and how it is built.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, check_cuda

PACK_CHUNKS = CudaKernel(
    "pack_chunks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_longlong, ctypes.c_longlong])


def pack_chunks(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = payload[idx[i]]`` on the card; ``idx[i] < 0`` → zero row.

    payload: (n, w) int32 or float32, contiguous CUDA; idx: (m,) int32 on
    the same device.  Ids must lie in [-1, n); the kernel writes a zero row
    for any id outside [0, n) instead of reading out of bounds.
    """
    check_cuda("payload", payload, (torch.int32, torch.float32), 2)
    check_cuda("idx", idx, (torch.int32,), 1, payload.device)
    n, w = payload.shape
    m = idx.shape[0]
    out = torch.empty((m, w), dtype=payload.dtype, device=payload.device)
    if m == 0 or w == 0:
        return out
    PACK_CHUNKS.launch(payload.data_ptr(), idx.data_ptr(), out.data_ptr(),
                       n, m, w)
    return out
