"""Whisper-style encoder-decoder (twin of ``repro.models.encdec``);
arXiv:2212.04356.

The encoder takes precomputed frame embeddings (B, encoder_seq, d) — the
stand-in for the convolutional front end, as in the reference — adds the
fixed sinusoidal table and runs bidirectional self-attention layers
(RMS-normed, as the reference's).  The decoder is a causal LM with learned
positions (``pos_dec``, no RoPE) and cross-attention to the encoder's
output.  Its cache is ``{f"layer{i}": {"self": {"k", "v"}, "cross_k",
"cross_v"}}``; ``decode_step`` writes the self-attention k and v in place
and reads the cross k and v as they stand.  ``init_cache`` zero-fills those
as the reference's does, and no serve path fills them from the encoder, so
decode from a fresh cache does not reproduce ``forward`` (ROADMAP 3b).
Filled by the caller from ``_xattn_kv`` of ``encode``'s output, it does.

The reference's ``_xattn_kv`` adds ``bv`` but not ``bk``, and its cross
attention has no ``bk``: the port copies both.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import attention as attn
from repro_torch.models import layers as nnl
from repro_torch.models.param import P, norm_scale, torch_dtype
from repro_torch.models.transformer import HiddenStateLM

POS_DEC = 32768       # learned decoder positions (the reference's table)


def _describe_xattn(cfg: ModelConfig) -> dict:
    d, H, D = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"wq": P((d, H, D), ("embed", "heads", None)),
            "wk": P((d, H, D), ("embed", "heads", None)),
            "wv": P((d, H, D), ("embed", "heads", None)),
            "wo": P((H, D, d), ("heads", None, "embed")),
            "bq": P((H, D), ("heads", None), init="zeros"),
            "bv": P((H, D), ("heads", None), init="zeros")}


def describe_encoder_layer(cfg: ModelConfig) -> dict:
    return {"ln_attn": norm_scale(cfg.d_model),
            "attn": attn.describe_attention(cfg),
            "ln_mlp": norm_scale(cfg.d_model),
            "mlp": nnl.describe_mlp(cfg, cfg.d_ff)}


def describe_decoder_layer(cfg: ModelConfig) -> dict:
    return {"ln_self": norm_scale(cfg.d_model),
            "attn": attn.describe_attention(cfg),
            "ln_cross": norm_scale(cfg.d_model),
            "xattn": _describe_xattn(cfg),
            "ln_mlp": norm_scale(cfg.d_model),
            "mlp": nnl.describe_mlp(cfg, cfg.d_ff)}


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, n, D) → (B, S, n, D) in x's dtype."""
    B, S, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) @ (H, D, d) → (B, S, d)."""
    B, S, H, D = o.shape
    return o.reshape(B, S, H * D) @ wo.to(o.dtype).reshape(H * D, -1)


def _self_attention_bidir(params: dict, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Non-causal self attention (the encoder), qkv biases with ``bk``."""
    dt = x.dtype
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    G = cfg.num_heads // cfg.num_kv_heads
    o = attn.online_softmax_attention(
        q, attn.repeat_kv(k, G), attn.repeat_kv(v, G), causal=False,
        scale=1.0 / math.sqrt(cfg.head_dim))
    return _out(o, params["wo"])


def _cross_attention(params: dict, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, Sq, d) against precomputed k, v (B, Senc, H, D)."""
    dt = x.dtype
    q = _heads(x, params["wq"]) + params["bq"].to(dt)
    o = attn.online_softmax_attention(q, k.to(dt), v.to(dt), causal=False,
                                      scale=1.0 / math.sqrt(cfg.head_dim))
    return _out(o, params["wo"])


def _xattn_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross k and v (B, Senc, H, D) of the encoder's
    output: ``bv`` added, no ``bk`` (as the reference)."""
    k = _heads(enc_out, params["wk"])
    v = _heads(enc_out, params["wv"]) + params["bv"].to(enc_out.dtype)
    return k, v


class EncDecModel(HiddenStateLM):
    """The encoder-decoder; parameters are an explicit nested dict of
    tensors in the reference's layout (``describe``); its batches carry
    ``audio_embeds`` (B, Senc, d) beside the tokens."""

    # ---- parameters -------------------------------------------------------
    def describe(self) -> dict:
        cfg = self.cfg
        return {
            "embed": nnl.describe_embedding(cfg),
            "pos_dec": P((POS_DEC, cfg.d_model), (None, "embed"),
                         stddev=0.01),
            "encoder": {f"layer{i}": describe_encoder_layer(cfg)
                        for i in range(cfg.encoder_layers)},
            "decoder": {f"layer{i}": describe_decoder_layer(cfg)
                        for i in range(cfg.num_layers)},
            "ln_enc": norm_scale(cfg.d_model),
            "ln_dec": norm_scale(cfg.d_model),
        }

    # ---- encoder ----------------------------------------------------------
    def encode(self, params: dict, audio_embeds: torch.Tensor
               ) -> torch.Tensor:
        """(B, Senc, d) frame embeddings → the encoder's normalised output
        in ``cfg.dtype``."""
        cfg = self.cfg
        x = audio_embeds.to(torch_dtype(cfg.dtype))
        S = x.shape[1]
        x = x + nnl.sinusoidal_positions(S, cfg.d_model, x.device).to(
            x.dtype)[None]
        for i in range(cfg.encoder_layers):
            p = params["encoder"][f"layer{i}"]
            h = nnl.rms_norm(x, p["ln_attn"], cfg.norm_eps)
            x = x + _self_attention_bidir(p["attn"], h, cfg)
            h = nnl.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
            x = x + nnl.apply_mlp(p["mlp"], h, cfg)
            x = logical_constraint(x, "batch", None, "embed")
        return nnl.rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # ---- decoder ----------------------------------------------------------
    def _decode_trunk(self, params: dict, x: torch.Tensor,
                      enc_out: Optional[torch.Tensor] = None,
                      caches: Optional[dict] = None,
                      cache_len: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        for i in range(cfg.num_layers):
            p = params["decoder"][f"layer{i}"]
            c = caches[f"layer{i}"] if caches is not None else None
            h = nnl.rms_norm(x, p["ln_self"], cfg.norm_eps)
            x = x + attn.apply_attention(
                p["attn"], h, None, cfg,
                cache=c["self"] if c is not None else None,
                cache_len=cache_len)
            h = nnl.rms_norm(x, p["ln_cross"], cfg.norm_eps)
            if c is not None:
                xk, xv = c["cross_k"], c["cross_v"]
            else:
                xk, xv = _xattn_kv(p["xattn"], enc_out, cfg)
            x = x + _cross_attention(p["xattn"], h, xk, xv, cfg)
            h = nnl.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
            x = x + nnl.apply_mlp(p["mlp"], h, cfg)
            x = logical_constraint(x, "batch", None, "embed")
        return x

    def _hidden(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        enc_out = self.encode(params, batch["audio_embeds"])
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        x = x + params["pos_dec"][:S].to(x.dtype)[None]
        x = self._decode_trunk(params, x, enc_out=enc_out)
        return nnl.rms_norm(x, params["ln_dec"], cfg.norm_eps)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    cache_len: Union[int, torch.Tensor], **_):
        """tokens (B, 1); ``cache_len`` (an int or a scalar tensor, whose
        read is a host sync) the tokens so far, the new one included: it
        takes learned position ``cache_len - 1`` (clamped into the table,
        as the reference's ``dynamic_slice``).  Returns (logits (B, 1, V),
        cache), the self-attention cache written in place."""
        cfg = self.cfg
        n = int(cache_len)
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        idx = min(max(n - 1, 0), params["pos_dec"].shape[0] - 1)
        x = x + params["pos_dec"][idx:idx + 1].to(x.dtype)[None]
        x = self._decode_trunk(params, x, caches=cache, cache_len=n)
        x = nnl.rms_norm(x, params["ln_dec"], cfg.norm_eps)
        return nnl.unembed(params["embed"], x, cfg), cache

    # ---- cache ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype: str = "bfloat16",
                   device=None) -> dict:
        """Zero caches on ``device`` (the CUDA card unless given; "meta"
        for shapes only), every leaf in ``dtype``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = torch_dtype(dtype)
        kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        xkv = (batch, cfg.encoder_seq, cfg.num_heads, cfg.head_dim)
        return {f"layer{i}": {
            "self": {"k": torch.zeros(kv, dtype=dt, device=dev),
                     "v": torch.zeros(kv, dtype=dt, device=dev)},
            "cross_k": torch.zeros(xkv, dtype=dt, device=dev),
            "cross_v": torch.zeros(xkv, dtype=dt, device=dev)}
            for i in range(cfg.num_layers)}

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: str = "bfloat16") -> dict:
        """The cache's shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def cache_axes(self, batch: int, max_len: int) -> dict:
        """The reference's logical axes of each cache leaf."""
        kv = ("batch", "act_kv_seq", "kv", None)
        x = ("batch", None, "heads", None)
        return {f"layer{i}": {"self": {"k": kv, "v": kv},
                              "cross_k": x, "cross_v": x}
                for i in range(self.cfg.num_layers)}
