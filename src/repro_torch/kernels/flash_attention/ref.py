"""Plain PyTorch versions of flash attention (the kernel's oracles)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True) -> torch.Tensor:
    """q/k/v: (BH, S, D) → (BH, S, D) in q's dtype; scores, softmax and the
    product with v in float32, masked scores filled with -1e30."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return o.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, S, H, D) → (B, S, H, D): ``attention_ref`` over every
    (batch, head)."""
    B, S, H, D = q.shape

    def bh(a):
        return a.transpose(1, 2).reshape(B * H, S, D)

    o = attention_ref(bh(q), bh(k), bh(v), scale=scale, causal=causal)
    return o.reshape(B, H, S, D).transpose(1, 2).contiguous()
