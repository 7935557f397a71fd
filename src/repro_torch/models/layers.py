"""Shared neural layers (twin of ``repro.models.layers``): norms, rotary
embeddings (M-RoPE included), MLPs, embeddings.  Layouts follow the JAX
package: a weight matrix is ``(d_in, d_out)`` and applied as ``x @ W``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import P, dense, torch_dtype


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMS norm computed in float32; ``zero_centered`` scales by ``1 + s``
    (gemma)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = (1.0 + scale) if zero_centered else scale
    return (y * s).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in float32 (the population variance), as the
    reference's; no model calls it."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + b).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs), in float32.

    x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv             # (..., S, D/2)
    ang = ang[..., None, :]                              # (..., S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL), in float32: the D/2 frequency lanes are
    split into temporal / height / width sections, each lane rotated by its
    own position stream.

    x: (B, S, H, D); positions: (3, B, S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                 # (D/2,)
    pos = positions.float()
    ang, lo = [], 0
    for stream, n in enumerate(sections):                # lanes [lo, lo + n)
        ang.append(pos[stream][..., None] * inv[lo:lo + n])
        lo += n
    ang = torch.cat(ang, dim=-1)[:, :, None, :]          # (B, S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed (n, d) float32 table: sines then cosines of
    ``pos * 10000^(-i / max(d/2 - 1, 1))``, i < d/2 (the reference's
    denominator)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    inv = torch.exp(-math.log(10000.0) * i / max(d // 2 - 1, 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def describe_mlp(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi_gate": dense(d, d_ff, "embed", "ffn"),
                "wi_up": dense(d, d_ff, "embed", "ffn"),
                "wo": dense(d_ff, d, "ffn", "embed")}
    return {"wi": dense(d, d_ff, "embed", "ffn"),
            "wo": dense(d_ff, d, "ffn", "embed")}


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (through float32, as JAX rounds a
    Python constant), as a Python float.  A product of a tensor with such a
    float is computed in float32 and rounded once, which for bf16 equals
    the reference's bf16 × bf16 product; as a float it needs no transfer to
    the card."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, written out as the
    reference writes it: its constants rounded to ``x``'s dtype and every
    op rounded to it, so bf16 results match bit for bit (one fused
    ``F.gelu(approximate="tanh")`` rounds once and differs in ~40% of bf16
    outputs by an ulp)."""
    c = rounded(math.sqrt(2 / math.pi), x.dtype)
    k = rounded(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), rounded after each op in bf16."""
    return x * torch.sigmoid(x)


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = x @ params["wi_gate"].to(dt)
        u = x @ params["wi_up"].to(dt)
        act = silu(g) if cfg.mlp_type == "swiglu" else _gelu(g)
        return (act * u) @ params["wo"].to(dt)
    h = x @ params["wi"].to(dt)
    h = F.relu(h).square() if cfg.mlp_type == "relu2" else _gelu(h)
    return h @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def describe_embedding(cfg: ModelConfig) -> dict:
    out = {"embedding": P((cfg.padded_vocab, cfg.d_model),
                          ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense(cfg.d_model, cfg.padded_vocab, "embed",
                               "vocab")
    return out


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    x = F.embedding(tokens.long(), params["embedding"]).to(dt)
    if cfg.embed_scale:
        # sqrt(d) rounded to float32, then to the activation dtype (in
        # bf16, sqrt(1152) = 33.94 becomes 34.0), as the reference does
        x = x * rounded(math.sqrt(cfg.d_model), dt)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embedding"].to(x.dtype).t()
    return x @ params["lm_head"].to(x.dtype)
