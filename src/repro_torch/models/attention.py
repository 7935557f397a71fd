"""Attention for training and prefill (twin of ``repro.models.attention``):
grouped-query attention with full causal or sliding-window masks.

Layouts follow the JAX package: ``wq (d, H, D)``, ``wk``/``wv (d, KV, D)``,
``wo (H, D, d)``; activations ``(B, S, H, D)``; query head ``h`` reads kv
head ``h // (H // KV)`` (consecutive grouping).  Scores and softmax are
float32.  The reference's memory-saving forms — an online-softmax scan over
KV blocks for causal layers and blocked windows for local ones — compute
the same function as the one masked softmax here; at the port's training
shapes (S ≤ 1024) the (B, H, S, S) float32 scores are 64 MiB a layer.  The
decode cache, MLA and M-RoPE are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import P

NEG_INF = -1e30


def describe_attention(cfg: ModelConfig) -> dict:
    if cfg.use_mla or cfg.qkv_bias:
        raise NotImplementedError(
            "MLA and qkv biases are not ported yet (ROADMAP Queue 1)")
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": P((d, H, D)), "wk": P((d, KV, D)), "wv": P((d, KV, D)),
            "wo": P((H, D, d))}


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, KV·groups, D), consecutive grouping."""
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def attention_mask(S: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: query q sees key k iff k ≤ q and, with a window,
    q - window ≤ k (each query sees ``window + 1`` keys)."""
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] >= pos[:, None] - window
    return mask


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, scale: float) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over GQA-expanded
    (B, S, H, D) q/k/v, in float32; returns q's dtype."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s = s.masked_fill(~attention_mask(S, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    """(B, S, d) → q, k, v of (B, S, H, D) in x's dtype: the projections,
    RoPE on q and k, and k/v GQA-expanded to H heads."""
    B, S, d = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt).reshape(d, H * D)).view(B, S, H, D)
    k = (x @ params["wk"].to(dt).reshape(d, KV * D)).view(B, S, KV, D)
    v = (x @ params["wv"].to(dt).reshape(d, KV * D)).view(B, S, KV, D)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, repeat_kv(k, H // KV), repeat_kv(v, H // KV)


def apply_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, window: int = 0) -> torch.Tensor:
    """(B, S, d) → (B, S, d).  ``window`` > 0 and < S makes the layer
    sliding-window; otherwise it is full causal."""
    B, S, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    q, kx, vx = project_qkv(params, x, positions, cfg)
    o = masked_attention(q, kx, vx, window=window if window < S else 0,
                         scale=1.0 / math.sqrt(D))
    return o.reshape(B, S, H * D) @ params["wo"].to(x.dtype).reshape(H * D, d)
