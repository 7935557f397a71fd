"""CUDA wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention.
flash_attention_bhsd``; the source file's header says what bounds it, how
its tiles are laid out and how it is built.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel

# head dims with an instance, and query rows a block (csrc/flash_attention.cu)
HEAD_DIMS = (64, 80, 128, 256)
BLOCK_Q = 64

FLASH_ATTENTION = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int])


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True
                         ) -> torch.Tensor:
    """Attention over (B, H, S, D) CUDA views (kernel); float32 or bf16,
    output in q's dtype and q's memory layout.

    The views are read through their strides, so a (B, S, H, D) tensor
    passed as ``x.transpose(1, 2)`` is not copied; only the head dim must
    be contiguous.  Raises on CPU tensors, mismatched shapes, devices or
    dtypes, and head dims the kernel has no instance for.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"q, k and v must all be float32 or all bfloat16,"
                             f" got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"q, k and v must share one (B, H, S, D) shape, "
                             f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported: the kernel takes "
                         f"{HEAD_DIMS}")
    if B * H * -(-S // BLOCK_Q) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 2, 1)])
    FLASH_ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), strides, B, H, S, D,
                           int(q.dtype == torch.bfloat16), float(scale),
                           int(bool(causal)))
    return out
