"""Entry point of flash attention: kernel on CUDA, plain version on the CPU
(the twin of ``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = None) -> torch.Tensor:
    """q/k/v: (B, S, H, D), kv already GQA-expanded to H heads → (B, S, H, D)
    in q's dtype; ``scale`` defaults to 1/√D.

    CUDA tensors go through the ``flash_attention`` kernel (or raise), which
    reads the (B, H, S, D) views of q/k/v in place and picks its own tiles;
    CPU tensors through the plain version.  The reference's padding of D to
    128 lanes and its transposes to (BH, S, D) are TPU layout needs and are
    not carried over.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), scale=scale,
                                    causal=causal).transpose(1, 2)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
