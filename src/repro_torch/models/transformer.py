"""Decoder LM for the dense, MoE and VLM families (twin of
``repro.models.transformer``).

Layer stacks are *segmented*: contiguous runs of identically-structured
layers (gemma3's 5:1 local:global pattern gives nine) keep their parameters
stacked on a leading layer axis under ``seg{i}_{kind}``, as in the JAX
package, so checkpoint leaves match it one for one.  The reference scans a
segment; here a Python loop runs its layers, each recomputed in the
backward pass when ``cfg.remat`` is set (as ``jax.checkpoint`` does there).

The model is functional like the reference: ``forward``, ``loss_fn`` and
``decode_step`` take the parameter tree as an argument and never modify it,
so a training step can be redone from the same parameters.  The KV cache
is the reference's tree, ``{seg_name: {"k", "v"}}`` of (n, B, max_len, KV,
D), or ``{seg_name: {"c_kv", "k_pe"}}`` under MLA; ``decode_step`` writes it
in place and returns the same tree (the reference returns a new one).

A MoE layer (every layer of a MoE config but its ``dense`` ones) replaces
the MLP by ``models/moe.py``; the stack sums the layers' load-balance aux
losses, which ``forward`` returns and ``loss_fn`` adds to the loss.  A VLM
batch's ``patch_embeds`` replace the first token embeddings and its
``mrope_positions`` (3, B, S) drive M-RoPE.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import attention as attn
from repro_torch.models import layers as nnl
from repro_torch.models import moe as moe_mod
from repro_torch.models.param import (abstract, count_params, logical_axes,
                                      materialize, norm_scale, stack_layers,
                                      torch_dtype)

Z_LOSS = 1e-4
LOSS_SEQ_CHUNKS = 4


# ---------------------------------------------------------------------------
# layer kinds & segments
# ---------------------------------------------------------------------------
def layer_kind_list(cfg: ModelConfig) -> List[str]:
    if cfg.layer_kinds is not None:
        return list(cfg.layer_kinds)
    return ["full"] * cfg.num_layers


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(kind, count), ...] contiguous runs."""
    segs: List[Tuple[str, int]] = []
    for k in layer_kind_list(cfg):
        if segs and segs[-1][0] == k:
            segs[-1] = (k, segs[-1][1] + 1)
        else:
            segs.append((k, 1))
    return segs


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind in ("local", "swa") else 0


def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.is_moe and kind != "dense"


# ---------------------------------------------------------------------------
# one transformer layer
# ---------------------------------------------------------------------------
def describe_layer(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    desc = {"ln_attn": norm_scale(d), "ln_mlp": norm_scale(d),
            "attn": attn.describe_attention(cfg)}
    if _is_moe(cfg, kind):
        desc["moe"] = moe_mod.describe_moe(cfg)
    else:
        desc["mlp"] = nnl.describe_mlp(cfg, cfg.d_ff)
    return desc


def apply_layer(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, kind: str, *, cache: Optional[dict] = None,
                cache_len: Optional[int] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                moe_impl: str = "dropping"
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer: (x, its aux loss, a float32 scalar, or None without a
    MoE).  With ``cache`` (this layer's slice) a decode step that writes
    the cache in place."""
    zero_c = cfg.family == "dense" and cfg.embed_scale   # gemma
    h = nnl.rms_norm(x, params["ln_attn"], cfg.norm_eps, zero_centered=zero_c)
    if cfg.use_mla:
        a = attn.apply_mla(params["attn"], h, positions, cfg, cache=cache,
                           cache_len=cache_len)
    else:
        a = attn.apply_attention(params["attn"], h, positions, cfg,
                                 window=_window(cfg, kind), cache=cache,
                                 cache_len=cache_len,
                                 mrope_positions=mrope_positions)
    x = logical_constraint(x + a, "batch", "seq", "embed")
    h = nnl.rms_norm(x, params["ln_mlp"], cfg.norm_eps, zero_centered=zero_c)
    aux = None
    if _is_moe(cfg, kind):
        m, aux = moe_mod.apply_moe(params["moe"], h, cfg, impl=moe_impl)
    else:
        m = nnl.apply_mlp(params["mlp"], h, cfg)
    return logical_constraint(x + m, "batch", "seq", "embed"), aux


def _layer_slice(tree, j: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, j) for k, v in tree.items()}
    return tree[j]


def describe_stack(cfg: ModelConfig) -> dict:
    return {f"seg{i}_{kind}": stack_layers(describe_layer(cfg, kind), n)
            for i, (kind, n) in enumerate(segments(cfg))}


def apply_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, caches: Optional[dict] = None,
                cache_len: Optional[int] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                moe_impl: str = "dropping"
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run all segments: (x, the MoE layers' summed aux loss, None without
    a MoE layer: a dense stack adds no operation for it).  ``caches``:
    ``{seg_name: {...}}`` stacked on the layer axis, each layer's slice
    written in place."""
    aux_total = None
    kw = dict(mrope_positions=mrope_positions, moe_impl=moe_impl)
    for i, (kind, n) in enumerate(segments(cfg)):
        name = f"seg{i}_{kind}"
        seg = params[name]
        for j in range(n):
            p_j = _layer_slice(seg, j)
            if caches is not None:
                x, aux = apply_layer(p_j, x, positions, cfg, kind,
                                     cache=_layer_slice(caches[name], j),
                                     cache_len=cache_len, **kw)
            elif cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(apply_layer, p_j, x, positions, cfg,
                                    kind, use_reentrant=False, **kw)
            else:
                x, aux = apply_layer(p_j, x, positions, cfg, kind, **kw)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# whole LM
# ---------------------------------------------------------------------------
class TransformerLM(nn.Module):
    """Dense / MoE / VLM decoder LM; parameters are an explicit nested dict
    of tensors in the JAX package's layout (see ``describe``).  ``moe_impl``
    picks the MoE dispatch (``models/moe.py``: ``"dropping"``, the
    reference's default, ``"grouped"`` or ``"dense"``); the reference also
    reads it from ``REPRO_MOE_IMPL``, the port from the argument only."""

    def __init__(self, cfg: ModelConfig, moe_impl: str = "dropping"):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM builds the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        if moe_impl not in moe_mod.IMPLS:
            raise ValueError(f"unknown MoE dispatch {moe_impl!r}; one of "
                             f"{moe_mod.IMPLS}")
        self.cfg = cfg
        self.moe_impl = moe_impl

    # ---- parameters -------------------------------------------------------
    def describe(self) -> dict:
        cfg = self.cfg
        return {"embed": nnl.describe_embedding(cfg),
                "stack": describe_stack(cfg),
                "ln_f": norm_scale(cfg.d_model)}

    def init(self, seed: int, device=None) -> Dict:
        return materialize(seed, self.describe(), self.cfg.param_dtype,
                           device)

    def param_count(self) -> int:
        return count_params(self.describe())

    def abstract_params(self) -> Dict:
        """The parameters' shapes and dtypes as meta tensors."""
        return abstract(self.describe(), self.cfg.param_dtype)

    def param_axes(self) -> Dict:
        """The logical axes of each parameter leaf."""
        return logical_axes(self.describe())

    # ---- forward ----------------------------------------------------------
    def _trunk(self, params: dict, batch: dict
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The normalised final hidden states (B, S, d) and the aux loss.
        A VLM batch's ``patch_embeds`` (B, P, d) replace the first P token
        embeddings and its ``mrope_positions`` (3, B, S) drive M-RoPE."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        mrope = None
        if cfg.family == "vlm":
            pe = batch.get("patch_embeds")
            if pe is not None:
                x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
            mrope = batch.get("mrope_positions")
        x = logical_constraint(x, "batch", "seq", "embed")
        x, aux = apply_stack(params["stack"], x, positions, cfg,
                             mrope_positions=mrope, moe_impl=self.moe_impl)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return nnl.rms_norm(x, params["ln_f"], cfg.norm_eps,
                            zero_centered=cfg.embed_scale), aux

    def forward(self, params: dict, batch: dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits (B,S,V), aux_loss)."""
        x, aux = self._trunk(params, batch)
        logits = nnl.unembed(params["embed"], x, self.cfg)
        return logical_constraint(logits, "batch", "seq", "vocab"), aux

    def last_logits(self, params: dict, batch: dict) -> torch.Tensor:
        """``forward``'s logits at the last position only, (B, V): the
        trunk over the whole sequence, the unembedding of one row a
        sequence (the whole (B, S, V) logits would be 17 GiB in bf16 at
        S 32,768 and gemma3-1b's vocab)."""
        x, _ = self._trunk(params, batch)
        return nnl.unembed(params["embed"], x[:, -1], self.cfg)

    # ---- decode -----------------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    cache_len: Union[int, torch.Tensor], *,
                    mrope_positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (B, 1) new tokens; cache_len: the valid length, the new
        token included — an int, or a tensor (a scalar, or one a row whose
        first entry places the writes, as in the reference; reading a
        tensor costs a host sync).  Under M-RoPE without
        ``mrope_positions`` (3, B, 1) the three position streams advance
        together (generated tokens are text).  Returns (logits (B, 1, V),
        cache), the cache written in place."""
        cfg = self.cfg
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        if isinstance(cache_len, torch.Tensor):
            positions = (cache_len.reshape(-1, 1) - 1).expand(tokens.shape)
            n = int(cache_len.reshape(-1)[0])
        else:
            positions = torch.full(tokens.shape, cache_len - 1,
                                   dtype=torch.int32, device=tokens.device)
            n = cache_len
        positions = positions.to(torch.int32)
        if cfg.mrope and mrope_positions is None:
            mrope_positions = positions[None].expand(3, *tokens.shape)
        x = logical_constraint(x, "batch", None, "embed")
        x, _ = apply_stack(params["stack"], x, positions, cfg, caches=cache,
                           cache_len=n, mrope_positions=mrope_positions,
                           moe_impl=self.moe_impl)
        x = nnl.rms_norm(x, params["ln_f"], cfg.norm_eps,
                         zero_centered=cfg.embed_scale)
        return nnl.unembed(params["embed"], x, cfg), cache

    # ---- caches -----------------------------------------------------------
    def _cache_shape(self, batch: int, max_len: int):
        cfg = self.cfg
        if cfg.use_mla:
            axes = ("batch", "act_kv_seq", None)
            return ({"c_kv": (batch, max_len, cfg.kv_lora_rank),
                     "k_pe": (batch, max_len, cfg.qk_rope_head_dim)},
                    {"c_kv": axes, "k_pe": axes})
        shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "act_kv_seq", "kv", None)
        return {"k": shp, "v": shp}, {"k": axes, "v": axes}

    def cache_axes(self, batch: int, max_len: int) -> dict:
        """The reference's logical axes of each cache leaf."""
        _, axes = self._cache_shape(batch, max_len)
        return {f"seg{i}_{kind}": {k: ("layers",) + a
                                   for k, a in axes.items()}
                for i, (kind, _) in enumerate(segments(self.cfg))}

    def init_cache(self, batch: int, max_len: int, dtype: str = "bfloat16",
                   device=None) -> dict:
        """A zero cache on ``device`` (the CUDA card unless given; "meta"
        for shapes only)."""
        base, _ = self._cache_shape(batch, max_len)
        dev = resolve_device(device)
        return {f"seg{i}_{kind}": {
            k: torch.zeros((n,) + s, dtype=torch_dtype(dtype), device=dev)
            for k, s in base.items()}
            for i, (kind, n) in enumerate(segments(self.cfg))}

    def abstract_cache(self, batch: int, max_len: int,
                       dtype: str = "bfloat16") -> dict:
        """The cache's shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def loss_fn(self, params: dict, batch: dict
                ) -> Tuple[torch.Tensor, dict]:
        """Cross-entropy + z-loss + the MoE aux loss, and the metrics
        (``aux_loss`` among them)."""
        x, aux = self._trunk(params, batch)
        loss, metrics = chunked_ce_loss(params["embed"], x, batch["targets"],
                                        self.cfg,
                                        loss_mask=batch.get("loss_mask"))
        total = loss + aux
        metrics["aux_loss"] = aux
        metrics["loss"] = total
        return total, metrics


class HiddenStateLM(nn.Module):
    """``init``, ``param_count``, ``forward``, ``last_logits`` and
    ``loss_fn`` of a model with no aux loss (xLSTM, Hymba, the
    encoder-decoder), from its ``describe()`` and its
    ``_hidden(params, batch)``: the normalised final hidden states
    (B, S, d) of the batch's tokens."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, seed: int, device=None) -> Dict:
        return materialize(seed, self.describe(), self.cfg.param_dtype,
                           device)

    def param_count(self) -> int:
        return count_params(self.describe())

    def abstract_params(self) -> Dict:
        """The parameters' shapes and dtypes as meta tensors."""
        return abstract(self.describe(), self.cfg.param_dtype)

    def param_axes(self) -> Dict:
        """The logical axes of each parameter leaf."""
        return logical_axes(self.describe())

    def forward(self, params: dict, batch: dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward: (logits (B, S, V), a zero aux loss)."""
        x = self._hidden(params, batch)
        return (nnl.unembed(params["embed"], x, self.cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def last_logits(self, params: dict, batch: dict) -> torch.Tensor:
        """``forward``'s logits at the last position only, (B, V)."""
        x = self._hidden(params, batch)
        return nnl.unembed(params["embed"], x[:, -1], self.cfg)

    def loss_fn(self, params: dict, batch: dict
                ) -> Tuple[torch.Tensor, dict]:
        """Cross-entropy + z-loss and the metrics."""
        x = self._hidden(params, batch)
        loss, metrics = chunked_ce_loss(params["embed"], x, batch["targets"],
                                        self.cfg,
                                        loss_mask=batch.get("loss_mask"))
        metrics["loss"] = loss
        return loss, metrics


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def _ce_chunk(embed_params: dict, x: torch.Tensor, t: torch.Tensor,
              m: torch.Tensor, cfg: ModelConfig):
    logits = nnl.unembed(embed_params, x, cfg).float()
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) < \
            cfg.vocab_size
        logits = logits.masked_fill(~valid, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return ((lse - gold) * m).sum(), (lse.square() * m).sum(), m.sum()


def chunked_ce_loss(embed_params: dict, x: torch.Tensor,
                    targets: torch.Tensor, cfg: ModelConfig,
                    loss_mask: Optional[torch.Tensor] = None,
                    n_chunks: int = LOSS_SEQ_CHUNKS
                    ) -> Tuple[torch.Tensor, dict]:
    """Cross-entropy + z-loss over sequence chunks (the float32 logits of
    one chunk at a time); padded-vocab logits are masked with -1e30."""
    B, S, _ = x.shape
    n_chunks = max(1, min(n_chunks, S))
    while S % n_chunks:
        n_chunks -= 1
    Sc = S // n_chunks
    if loss_mask is None:
        loss_mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss_sum, z_sum, count = zero, zero, zero
    for c in range(n_chunks):
        sl = slice(c * Sc, (c + 1) * Sc)
        args = (embed_params, x[:, sl], targets[:, sl], loss_mask[:, sl], cfg)
        if cfg.remat and torch.is_grad_enabled():
            nll, z, m = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, z, m = _ce_chunk(*args)
        loss_sum, z_sum, count = loss_sum + nll, z_sum + z, count + m
    count = torch.clamp(count, min=1.0)
    ce = loss_sum / count
    zl = Z_LOSS * z_sum / count
    return ce + zl, {"ce": ce, "z_loss": zl, "tokens": count}
