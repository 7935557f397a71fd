"""Hymba (twin of ``repro.models.hymba``): attention and Mamba heads in
parallel in every layer, meta tokens, sliding-window attention;
arXiv:2411.13676.

Each layer runs attention heads and SSM heads on the same pre-norm input
and averages their RMS-normed outputs, then a gated MLP.
``num_meta_tokens`` learned tokens are prepended to the sequence (RoPE
positions 0..M-1; the sliding-window layers keep them visible as sinks).
Layers {0, 15, 31} attend globally, the rest in a window of 1024.  Runs of
one kind are stacked under ``seg{j}_{kind}`` (hymba-1.5b: 1, 14, 1, 15, 1
layers), as in the reference.

The cache of a segment is ``{"attn": {"k", "v"} (n, B, L, KV, D), "conv"
(n, B, K-1, di), "ssm" (n, B, di, N) float32}``; ``decode_step`` writes it
in place and returns the same tree, and its ``cache_len`` counts the meta
tokens.  As in the reference, decode never feeds the meta tokens: their
cache slots stay zero and the SSM starts from a zero state, so decode does
not reproduce ``forward`` (ROADMAP 3b).

``_mamba_path`` builds the scan's (B, L, di, N) float32 inputs a chunk of
``ssm.MAMBA_CHUNK`` rows at a time (at hymba-1.5b's width a whole-sequence
one is 1.73 GB at B 4 × 4224 rows) and reads each chunk's states out
before the next; the reference pads the last chunk with the identity (a 1,
b 0), which changes no state, and the port scans it unpadded.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import attention as attn
from repro_torch.models import layers as nnl
from repro_torch.models import ssm
from repro_torch.models.param import P, norm_scale, stack_layers, torch_dtype
from repro_torch.models.transformer import (HiddenStateLM, _layer_slice,
                                            segments)


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.num_heads * cfg.head_dim      # 25 · 64 = 1600 = d_model


def describe_hymba_layer(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = _d_inner(cfg)
    N = cfg.ssm_state
    dt_rank = max(8, d // 16)
    return {
        "ln": norm_scale(d),
        "ln_mlp": norm_scale(d),
        "attn": attn.describe_attention(cfg),
        "norm_attn": norm_scale(d),
        "w_xz": P((d, 2 * di), ("embed", "ffn")),
        "conv_w": P((cfg.conv_kernel, di), (None, "ffn"), stddev=0.1),
        "conv_b": P((di,), ("ffn",), init="zeros"),
        "w_bc": P((di, 2 * N), ("ffn", None)),
        "w_dt1": P((di, dt_rank), ("ffn", None)),
        "w_dt2": P((dt_rank, di), (None, "ffn")),
        "b_dt": P((di,), ("ffn",), init="const", value=-4.6),  # softplus ≈ 0.01
        "a_log": P((di, N), ("ffn", None), init="log_arange"),
        "d_skip": P((di,), ("ffn",), init="ones"),
        "w_ssm_out": P((di, d), ("ffn", "embed")),
        "norm_ssm": norm_scale(d),
        "mlp": nnl.describe_mlp(cfg, cfg.d_ff),
    }


def _mamba_path(params: dict, h: torch.Tensor, cfg: ModelConfig,
                state: Optional[dict]) -> torch.Tensor:
    """The SSM heads, (B, S, d) → (B, S, d).  ``state`` (decode): the
    layer's ``{"conv", "ssm", ...}``, its conv tail and SSM state written
    in place."""
    B, S, _ = h.shape
    di = _d_inner(cfg)
    N = cfg.ssm_state
    dt_ = h.dtype
    xz = h @ params["w_xz"].to(dt_)
    xs, z = xz[..., :di], xz[..., di:]
    xc, new_conv = ssm.causal_conv1d(
        xs, params["conv_w"], params["conv_b"],
        state["conv"] if state is not None else None)
    xc = nnl.silu(xc)
    bc = xc @ params["w_bc"].to(dt_)                        # (B, S, 2N)
    b_in, c_out = bc[..., :N].float(), bc[..., N:].float()
    dt_pre = (xc @ params["w_dt1"].to(dt_)) @ params["w_dt2"].to(dt_)
    delta = F.softplus(dt_pre.float() + params["b_dt"].float())  # (B,S,di)
    A = -torch.exp(params["a_log"].float())                 # (di, N)
    dx = delta * xc.float()
    h_prev = state["ssm"] if state is not None else None
    ys = []
    for s0 in range(0, S, ssm.MAMBA_CHUNK):
        rows = slice(s0, s0 + ssm.MAMBA_CHUNK)
        a = torch.exp(delta[:, rows, :, None] * A)          # (B, L, di, N)
        bx = dx[:, rows, :, None] * b_in[:, rows, None, :]
        if S == 1:
            if h_prev is None:
                h_prev = torch.zeros((B, di, N), dtype=torch.float32,
                                     device=h.device)
            hs, h_prev = ssm.mamba_step(a[:, 0], bx[:, 0], h_prev)
            hs = hs[:, None]
        else:
            hs, h_prev = ssm.mamba_scan(a, bx, h_prev, chunk=a.shape[1])
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, c_out[:, rows]))
    y = torch.cat(ys, 1) + params["d_skip"].float() * xc.float()
    out = (y.to(dt_) * nnl.silu(z)) @ params["w_ssm_out"].to(dt_)
    if state is not None:
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(h_prev)
    return out


def apply_hymba_layer(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, kind: str,
                      *, cache: Optional[dict] = None,
                      cache_len: Optional[int] = None) -> torch.Tensor:
    """One layer, (B, S, d) → (B, S, d); with ``cache`` (this layer's
    slice) a decode step that writes it in place."""
    window = cfg.window_size if kind == "swa" else 0
    sink = cfg.num_meta_tokens if window else 0
    h = nnl.rms_norm(x, params["ln"], cfg.norm_eps)
    a_out = attn.apply_attention(
        params["attn"], h, positions, cfg, window=window,
        cache=cache["attn"] if cache is not None else None,
        cache_len=cache_len, sink_len=sink)
    s_out = _mamba_path(params, h, cfg, cache)
    fused = 0.5 * (nnl.rms_norm(a_out, params["norm_attn"], cfg.norm_eps)
                   + nnl.rms_norm(s_out, params["norm_ssm"], cfg.norm_eps))
    x = x + fused
    x = logical_constraint(x, "batch", "seq", "embed")
    h2 = nnl.rms_norm(x, params["ln_mlp"], cfg.norm_eps)
    x = x + nnl.apply_mlp(params["mlp"], h2, cfg)
    return logical_constraint(x, "batch", "seq", "embed")


class HymbaModel(HiddenStateLM):
    """The hybrid LM; parameters are an explicit nested dict of tensors in
    the reference's layout (``describe``)."""

    def segments(self) -> List[Tuple[str, str, int]]:
        """[(name, kind, layers), ...], one a run of one kind."""
        return [(f"seg{j}_{k}", k, n)
                for j, (k, n) in enumerate(segments(self.cfg))]

    # ---- parameters -------------------------------------------------------
    def describe(self) -> dict:
        cfg = self.cfg
        return {
            "embed": nnl.describe_embedding(cfg),
            "meta_tokens": P((cfg.num_meta_tokens, cfg.d_model),
                             (None, "embed")),
            "stack": {name: stack_layers(describe_hymba_layer(cfg), n)
                      for name, _, n in self.segments()},
            "ln_f": norm_scale(cfg.d_model),
        }

    # ---- forward ----------------------------------------------------------
    def _trunk(self, params: dict, x: torch.Tensor, positions: torch.Tensor,
               caches: Optional[dict] = None,
               cache_len: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        for name, kind, n in self.segments():
            seg = params["stack"][name]
            for j in range(n):
                p_j = _layer_slice(seg, j)
                if caches is not None:
                    x = apply_hymba_layer(
                        p_j, x, positions, cfg, kind,
                        cache=_layer_slice(caches[name], j),
                        cache_len=cache_len)
                elif cfg.remat and torch.is_grad_enabled():
                    x = checkpoint(apply_hymba_layer, p_j, x, positions, cfg,
                                   kind, use_reentrant=False)
                else:
                    x = apply_hymba_layer(p_j, x, positions, cfg, kind)
        return x

    def _hidden(self, params: dict, batch: dict) -> torch.Tensor:
        """The normalised final hidden states of the tokens (B, S, d): the
        meta tokens prepended, run, and cut off again."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        M = cfg.num_meta_tokens
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        meta = params["meta_tokens"].to(x.dtype)[None].expand(
            B, M, cfg.d_model)
        x = torch.cat([meta, x], dim=1)
        positions = torch.arange(S + M, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        x = self._trunk(params, x, positions)[:, M:]
        return nnl.rms_norm(x, params["ln_f"], cfg.norm_eps)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    cache_len: Union[int, torch.Tensor], **_):
        """tokens (B, 1); ``cache_len`` (an int or a scalar tensor, whose
        read is a host sync) counts the meta tokens and the tokens so far,
        the new one included: the token takes RoPE position
        ``cache_len - 1``.  Returns (logits (B, 1, V), cache), the cache
        written in place."""
        cfg = self.cfg
        n = int(cache_len)
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        pos = torch.full(tokens.shape, n - 1, dtype=torch.int32,
                         device=tokens.device)
        x = self._trunk(params, x, pos, cache, n)
        x = nnl.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return nnl.unembed(params["embed"], x, cfg), cache

    # ---- cache ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype: str = "bfloat16",
                   device=None) -> dict:
        """Zero caches on ``device`` (the CUDA card unless given; "meta"
        for shapes only): k, v and the conv tail in ``dtype``, the SSM
        state float32."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = torch_dtype(dtype)
        di = _d_inner(cfg)
        kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)

        def zeros(n, shape, t=dt):
            return torch.zeros((n,) + shape, dtype=t, device=dev)

        return {name: {"attn": {"k": zeros(n, kv), "v": zeros(n, kv)},
                       "conv": zeros(n, (batch, cfg.conv_kernel - 1, di)),
                       "ssm": zeros(n, (batch, di, cfg.ssm_state),
                                    torch.float32)}
                for name, _, n in self.segments()}

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: str = "bfloat16") -> dict:
        """The cache's shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def cache_axes(self, batch: int, max_len: int) -> dict:
        """The reference's logical axes of each cache leaf."""
        kv = ("layers", "batch", "act_kv_seq", "kv", None)
        return {name: {"attn": {"k": kv, "v": kv},
                       "conv": ("layers", "batch", None, "ffn"),
                       "ssm": ("layers", "batch", "ffn", None)}
                for name, _, _ in self.segments()}
