"""xLSTM LM (twin of ``repro.models.xlstm``): interleaved mLSTM (matrix
memory) and sLSTM (scalar memory) blocks, arXiv:2405.04517.

  mLSTM block: pre-norm → up-projection to 2·di → [causal conv → q, k;
               v from before the conv → mLSTM] gated by SiLU(z) → group
               norm → down-projection, residual.
  sLSTM block: pre-norm → 4-gate recurrent cell (block-diagonal
               recurrence) → group norm → gated GELU FFN (4/3), residual.

The blocks are not stacked: ``{"blocks": {f"block{i}_{kind}": ...}}``, as
in the reference.  The recurrent state, the decode "cache", is O(1) in the
sequence length: ``{"conv" (B, K-1, di), "cell" (C, n, m)}`` a mLSTM block
and ``{"cell" (c, n, m, h)}`` a sLSTM block, the cells float32, the conv
tail in ``cfg.dtype``.  ``decode_step`` writes every state in place into
the tree it is given and returns that tree (the reference returns a new
one, ROADMAP 3a).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import layers as nnl
from repro_torch.models import ssm
from repro_torch.models.param import (P, dense, map_tree, norm_scale,
                                      torch_dtype)
from repro_torch.models.transformer import HiddenStateLM


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = int(cfg.proj_factor * cfg.d_model)
    H = cfg.num_heads
    return di, H, di // H


def describe_mlstm_block(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, H, _ = _mlstm_dims(cfg)
    return {
        "ln": norm_scale(d),
        "w_up": P((d, 2 * di), ("embed", "ffn")),
        "conv_w": P((cfg.conv_kernel, di), (None, "ffn"), stddev=0.1),
        "conv_b": P((di,), ("ffn",), init="zeros"),
        "wq": P((di, di), ("ffn", None)),
        "wk": P((di, di), ("ffn", None)),
        "wv": P((di, di), ("ffn", "ffn")),
        "w_i": P((di, H), ("ffn", None), init="zeros"),
        "b_i": P((H,), (None,), init="zeros"),
        "w_f": P((di, H), ("ffn", None), init="zeros"),
        "b_f": P((H,), (None,), init="const", value=3.0),  # open forget gates
        "gn": norm_scale(di, "ffn"),
        "w_down": P((di, d), ("ffn", "embed")),
    }


def _write_state(state: dict, new: dict) -> None:
    """Copy each new state (a tensor, or a tuple of them) into the one of
    its name in ``state``, in place."""
    for name, val in new.items():
        old = state[name]
        for dst, src in (zip(old, val) if isinstance(old, tuple)
                         else ((old, val),)):
            dst.copy_(src)


def apply_mlstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[dict] = None, *,
                      chunkwise: bool = True) -> torch.Tensor:
    """(B, S, d) → (B, S, d); ``state`` (decode) is written in place."""
    B, S, d = x.shape
    di, H, Dh = _mlstm_dims(cfg)
    dt = x.dtype
    h = nnl.rms_norm(x, params["ln"], cfg.norm_eps)
    up = h @ params["w_up"].to(dt)                          # (B, S, 2di)
    inner, z = up[..., :di], up[..., di:]
    c_out, new_conv = ssm.causal_conv1d(
        inner, params["conv_w"], params["conv_b"],
        state["conv"] if state is not None else None)
    c_act = nnl.silu(c_out)
    q = (c_act @ params["wq"].to(dt)).view(B, S, H, Dh)
    k = (c_act @ params["wk"].to(dt)).view(B, S, H, Dh)
    v = (inner @ params["wv"].to(dt)).view(B, S, H, Dh)
    i_pre = c_act @ params["w_i"].to(dt) + params["b_i"].to(dt)
    f_pre = c_act @ params["w_f"].to(dt) + params["b_f"].to(dt)
    cell = state["cell"] if state is not None else None
    if S == 1 or not chunkwise:
        hseq, new_cell = ssm.mlstm_sequential(q, k, v, i_pre, f_pre, cell)
    else:
        pad = (-S) % ssm.MLSTM_CHUNK
        if pad:
            # padded steps: f_pre huge (the state kept), i_pre -1e9 (no write)
            zpad = (0, 0, 0, 0, 0, pad)
            hseq, new_cell = ssm.mlstm_chunkwise(
                F.pad(q, zpad), F.pad(k, zpad), F.pad(v, zpad),
                F.pad(i_pre, (0, 0, 0, pad), value=-1e9),
                F.pad(f_pre, (0, 0, 0, pad), value=30.0), cell)
            hseq = hseq[:, :S]
        else:
            hseq, new_cell = ssm.mlstm_chunkwise(q, k, v, i_pre, f_pre,
                                                 cell)
    hflat = nnl.rms_norm(hseq.reshape(B, S, di), params["gn"], cfg.norm_eps)
    out = (hflat * nnl.silu(z)) @ params["w_down"].to(dt)
    if state is not None:
        _write_state(state, {"conv": new_conv, "cell": new_cell})
    return x + out


def describe_slstm_block(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    ffn = max(64, int(4 * d / 3) // 64 * 64)
    return {
        "ln": norm_scale(d),
        "w_in": P((d, H, Dh, 4), ("embed", None, None, None)),
        "b_in": P((H, Dh, 4), (None, None, None), init="zeros"),
        "r_z": P((H, Dh, Dh), (None, None, None), init="zeros"),
        "r_i": P((H, Dh, Dh), (None, None, None), init="zeros"),
        "r_f": P((H, Dh, Dh), (None, None, None), init="zeros"),
        "r_o": P((H, Dh, Dh), (None, None, None), init="zeros"),
        "gn": norm_scale(d),
        "ffn_gate": dense(d, ffn, "embed", "ffn"),
        "ffn_up": dense(d, ffn, "embed", "ffn"),
        "ffn_down": dense(ffn, d, "ffn", "embed"),
    }


def apply_slstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[dict] = None) -> torch.Tensor:
    """(B, S, d) → (B, S, d); ``state`` (decode) is written in place."""
    B, S, d = x.shape
    H = cfg.num_heads
    Dh = d // H
    dt = x.dtype
    h = nnl.rms_norm(x, params["ln"], cfg.norm_eps)
    gates = (h @ params["w_in"].to(dt).reshape(d, H * Dh * 4)).view(
        B, S, H, Dh, 4) + params["b_in"].to(dt)
    rw = {g: params[f"r_{g}"] for g in ("z", "i", "f", "o")}
    hseq, new_cell = ssm.slstm_parallel(
        gates, rw, state["cell"] if state is not None else None)
    hflat = nnl.rms_norm(hseq.reshape(B, S, d).to(dt), params["gn"],
                         cfg.norm_eps)
    g = hflat @ params["ffn_gate"].to(dt)
    u = hflat @ params["ffn_up"].to(dt)
    out = (nnl._gelu(g) * u) @ params["ffn_down"].to(dt)
    if state is not None:
        _write_state(state, {"cell": new_cell})
    return x + out


class XLSTMModel(HiddenStateLM):
    """The xLSTM LM; parameters are an explicit nested dict of tensors in
    the reference's layout (``describe``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.kinds = list(cfg.layer_kinds or ["mlstm"] * cfg.num_layers)

    def _names(self):
        return [f"block{i}_{kind}" for i, kind in enumerate(self.kinds)]

    # ---- parameters -------------------------------------------------------
    def describe(self) -> dict:
        cfg = self.cfg
        blocks = {name: (describe_slstm_block(cfg) if kind == "slstm"
                         else describe_mlstm_block(cfg))
                  for name, kind in zip(self._names(), self.kinds)}
        return {"embed": nnl.describe_embedding(cfg), "blocks": blocks,
                "ln_f": norm_scale(cfg.d_model)}

    # ---- forward ----------------------------------------------------------
    def _trunk(self, params: dict, x: torch.Tensor,
               states: Optional[dict]) -> torch.Tensor:
        cfg = self.cfg
        for name, kind in zip(self._names(), self.kinds):
            fn = apply_slstm_block if kind == "slstm" else apply_mlstm_block
            p = params["blocks"][name]
            if states is not None:
                x = fn(p, x, cfg, states[name])
            elif cfg.remat and torch.is_grad_enabled():
                x = checkpoint(fn, p, x, cfg, use_reentrant=False)
            else:
                x = fn(p, x, cfg)
            x = logical_constraint(x, "batch", "seq", "embed")
        return x

    def _hidden(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = nnl.embed_tokens(params["embed"], batch["tokens"], cfg)
        x = self._trunk(params, x, None)
        return nnl.rms_norm(x, params["ln_f"], cfg.norm_eps)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    cache_len: Union[int, torch.Tensor] = 0, **_):
        """tokens (B, 1) → (logits (B, 1, V), cache), every block's state
        written in place; ``cache_len`` is not read (the state carries the
        position)."""
        cfg = self.cfg
        x = nnl.embed_tokens(params["embed"], tokens, cfg)
        x = self._trunk(params, x, cache)
        x = nnl.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return nnl.unembed(params["embed"], x, cfg), cache

    # ---- recurrent state ("cache") ----------------------------------------
    def _state_shapes(self, batch: int, kind: str):
        cfg = self.cfg
        if kind == "slstm":
            s = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
            return {"cell": (s, s, s, s)}
        di, H, Dh = _mlstm_dims(cfg)
        return {"conv": (batch, cfg.conv_kernel - 1, di),
                "cell": ((batch, H, Dh, Dh), (batch, H, Dh), (batch, H))}

    def init_cache(self, batch: int, max_len: int = 0,
                   dtype: str = "bfloat16", device=None) -> dict:
        """Zero states on ``device`` (the CUDA card unless given; "meta" for
        shapes only), the stabilisers m at -inf; the conv tails in
        ``cfg.dtype`` (``dtype`` is not read, as in the reference), the
        cells float32."""
        dev = resolve_device(device)
        conv_dt = torch_dtype(self.cfg.dtype)

        def cell(shapes):
            out = [torch.zeros(s, dtype=torch.float32, device=dev)
                   for s in shapes]
            out[2] = torch.full(shapes[2], float("-inf"),
                                dtype=torch.float32, device=dev)
            return tuple(out)

        tree = {}
        for name, kind in zip(self._names(), self.kinds):
            shapes = self._state_shapes(batch, kind)
            tree[name] = {"cell": cell(shapes["cell"])}
            if "conv" in shapes:
                tree[name]["conv"] = torch.zeros(shapes["conv"],
                                                 dtype=conv_dt, device=dev)
        return tree

    def abstract_cache(self, batch: int, max_len: int = 0,
                       dtype: str = "bfloat16") -> dict:
        """The states' shapes and dtypes as meta tensors (no memory)."""
        return self.init_cache(batch, max_len, dtype, device="meta")

    def cache_axes(self, batch: int, max_len: int = 0) -> dict:
        """The reference's logical axes: ``batch`` first, then None."""
        return map_tree(lambda t: ("batch",) + (None,) * (t.ndim - 1),
                        self.abstract_cache(batch, max_len))
