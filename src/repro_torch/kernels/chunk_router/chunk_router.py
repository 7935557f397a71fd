"""CUDA wrapper of the destination-histogram kernel (``csrc/dest_histogram2d.cu``).

Replaces ``repro.kernels.chunk_router.chunk_router.dest_histogram2d_kernel``;
the source file's header says what bounds it and how it is built.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, check_cuda

DEST_HISTOGRAM2D = CudaKernel(
    "dest_histogram2d",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int])


def dest_histogram2d(dest: torch.Tensor, *, n_bins: int) -> torch.Tensor:
    """(L, q) int32 CUDA destinations → (L, n_bins) int32 counts (kernel).

    Values outside [0, n_bins) are counted nowhere.  Raises on CPU tensors,
    other dtypes or non-contiguous input.
    """
    check_cuda("dest", dest, (torch.int32,), 2)
    if n_bins < 0 or n_bins > 50000:
        raise ValueError(f"n_bins must lie in [0, 50000], got {n_bins}")
    L, q = dest.shape
    if q >= 2 ** 31 or L >= 2 ** 31:
        raise ValueError(f"dest shape {tuple(dest.shape)} too large")
    counts = torch.empty((L, n_bins), dtype=torch.int32, device=dest.device)
    if L == 0 or n_bins == 0:
        return counts
    DEST_HISTOGRAM2D.launch(dest.data_ptr(), counts.data_ptr(), L, q, n_bins)
    return counts
