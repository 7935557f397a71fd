"""Entry point of flash attention: kernel on CUDA, plain version on the CPU
(the twin of ``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, WIDE_STEP, flash_attention_bhsd, tma_problem)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def padded_head_dim(d: int) -> int:
    """The smallest head dim a kernel takes that is ≥ ``d``: an instance
    up to 256, above it the next multiple of 128 (the wide float32
    kernel; the reference pads every D to a multiple of 128)."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    return -(-d // WIDE_STEP) * WIDE_STEP


def _readable(view: torch.Tensor) -> torch.Tensor:
    """A (B, H, S, D) view the kernel can read in place, copied where it
    cannot: bf16 where TMA cannot read it (``tma_problem``), float32 where
    the head dim is not contiguous."""
    bad = (tma_problem(view) if view.dtype == torch.bfloat16
           else view.stride(3) != 1)
    return view.clone(memory_format=torch.contiguous_format) if bad else view


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool,
                   kernel=flash_attention_bhsd) -> torch.Tensor:
    """What the entry point does around the kernel on CUDA.

    bf16 stays bf16 up to D = 256; any other dtype, and every dtype above
    256 (the wide kernel is float32 only), is computed in float32 and
    rounded once to its own (the reference casts to float32 inside its
    body).  D is zero-padded to ``padded_head_dim(D)``: zero columns add
    nothing to q·k, the scale stays the caller's, and the padded output
    columns are cut off.  Views the kernel cannot read in place are copied
    (``_readable``).  ``kernel`` takes (B, H, S, D) views; the tests pass
    a plain version to check all of this on the CPU.
    """
    out_dtype = q.dtype
    D = q.shape[-1]
    padded = padded_head_dim(D)
    keep_bf16 = padded <= HEAD_DIMS[-1]
    q, k, v = (x if x.dtype == torch.bfloat16 and keep_bf16 else x.float()
               for x in (q, k, v))
    pad = padded - D
    if pad:
        q, k, v = (F.pad(x, (0, pad)) for x in (q, k, v))
    o = kernel(*(_readable(x.transpose(1, 2)) for x in (q, k, v)),
               scale=scale, causal=causal).transpose(1, 2)
    if pad:
        o = o[..., :D].contiguous()
    return o.to(out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = None,
                    block_q: int = 512, block_k: int = 512,
                    interpret: bool = None) -> torch.Tensor:
    """q/k/v: (B, S, H, D), kv already GQA-expanded to H heads → (B, S, H, D)
    in q's dtype; ``scale`` defaults to 1/√D of the true D.

    CUDA tensors go through a ``flash_attention`` kernel (or raise): bf16
    through the Hopper kernel, any other dtype through the float32 one
    (``attention_bshd``).  Like the reference, which pads D to a multiple
    of 128 lanes, the entry point takes any head dim: up to 256 it
    zero-pads D to the next kernel instance (64, 80, 128 or 256), above it
    to the next multiple of 128, computed in float32 by the wide kernel;
    it takes any strides, copying a view the kernel cannot read in place.
    CPU tensors go through the plain version.  ``block_q``, ``block_k`` and
    ``interpret`` are the TPU kernel's tiling and interpret mode: accepted
    and ignored (the CUDA kernels pick their own tiles).
    """
    del block_q, block_k, interpret
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return attention_bshd(q, k, v, scale=scale, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
