"""Attention (twin of ``repro.models.attention``): grouped-query attention
with full causal or sliding-window masks, qkv biases, M-RoPE, the KV cache
with one-token decode, and multi-head latent attention (MLA).

Layouts follow the JAX package: ``wq (d, H, D)``, ``wk``/``wv (d, KV, D)``,
``wo (H, D, d)``, biases ``bq (H, D)``, ``bk``/``bv (KV, D)``; activations
``(B, S, H, D)``; query head ``h`` reads kv head ``h // (H // KV)``
(consecutive grouping).  Scores and softmax are float32.

Training and prefill compute one function in three forms: a masked softmax
over the (B, H, S, S) float32 scores (``masked_attention``), and the
reference's two blocked forms, which never hold those scores: an online
softmax over KV blocks for full layers (``online_softmax_attention``) and
q blocks against their window for local ones (``windowed_attention``, which
also stands for the reference's ``windowed_attention_parallel``, a sharding
layout of the same function).  ``apply_attention`` keeps the masked form
while its scores take at most ``MASKED_SCORES_BYTES`` (every training shape
of the port: 64 MiB a layer at gemma3-1b's B 4, S 1024) and takes the
blocked forms above it (gemma3-1b's prefill at S 32,768 would need 16 GiB a
layer at batch 1).  A local layer's query sees ``window + 1`` keys here.

Decode (``cache`` given) writes the new k and v into the cache at
``cache_len - 1`` and attends one token against it (``decode_attention``):
a local layer reads the ``window`` positions ending at ``cache_len``.  So
decode and prefill differ on local layers from position ``window`` on, as
they do in the reference; the port keeps both sides as the reference has
them.  Unlike the reference, which returns a new cache, the port writes the
cache in place (a copy of the whole cache a step would cost more than the
step).

MLA (DeepSeek-V2, ``apply_mla``) computes two different functions, as the
reference does: prefill and training materialise per-head keys and values
from the latent and run the online softmax at head dim ``dn + dr`` (v
zero-padded to it); decode runs in the latent space against a cache of
``{"c_kv" (B, L, r), "k_pe" (B, L, dr)}`` (weight absorption), also written
in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm
from repro_torch.models.param import P, dense, torch_dtype

BLOCK_KV = 512    # online-softmax KV block (the reference's)
BLOCK_Q = 1024    # q block of the blocked forms (the reference's windowed one)
# largest (B, H, S, S) float32 score tensor the masked form may build
MASKED_SCORES_BYTES = 1 << 30

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameter descriptors
# ---------------------------------------------------------------------------
def describe_attention(cfg: ModelConfig) -> dict:
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.use_mla:
        r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        return {"wq": P((d, H, dn + dr)), "w_dkv": dense(d, r),
                "w_kpe": dense(d, dr),
                "kv_norm": P((r,), init="ones", dtype="float32"),
                "w_uk": P((r, H, dn)), "w_uv": P((r, H, cfg.v_head_dim)),
                "wo": P((H, cfg.v_head_dim, d))}
    out = {"wq": P((d, H, D)), "wk": P((d, KV, D)), "wv": P((d, KV, D)),
           "wo": P((H, D, d))}
    if cfg.qkv_bias:
        out.update(bq=P((H, D), init="zeros"), bk=P((KV, D), init="zeros"),
                   bv=P((KV, D), init="zeros"))
    return out


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------
def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, KV·groups, D), consecutive grouping."""
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def attention_mask(S: int, window: int, device,
                   sink_len: int = 0) -> torch.Tensor:
    """(S, S) bool: query q sees key k iff k ≤ q and, with a window,
    q - window ≤ k (each query sees ``window + 1`` keys) or k < sink_len."""
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        near = pos[None, :] >= pos[:, None] - window
        if sink_len:
            near |= pos[None, :] < sink_len
        mask &= near
    return mask


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, scale: float,
                     sink_len: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over GQA-expanded
    (B, S, H, D) q/k/v, in float32; returns q's dtype."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s = s.masked_fill(~attention_mask(S, window, q.device, sink_len), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def online_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool,
                             q_offset: int = 0, scale: float,
                             block_kv: int = BLOCK_KV) -> torch.Tensor:
    """Memory-efficient attention (the reference's online softmax).

    q: (B, Sq, H, D); k/v: (B, Sk, H, D), GQA-expanded; ``q_offset`` is the
    position of q[0] for the causal mask.  The float32 scores of one
    (``BLOCK_Q``, ``block_kv``) tile exist at a time.  Under the causal
    mask a q block stops at the last KV block it can see: the blocks past
    it are masked whole, and their terms add exactly nothing to the
    reference's running max, sum and accumulator.  (The reference's
    ``logit_soft_cap``, which no caller sets, is left out.)"""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, H, Sk, D)
    out = torch.empty_like(q)
    for q0 in range(0, Sq, BLOCK_Q):
        qb = q[:, q0:q0 + BLOCK_Q].transpose(1, 2).float() * scale
        bq = qb.shape[2]
        qpos = q_offset + q0 + torch.arange(bq, device=q.device)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, block_kv):
            if causal and k0 > q_offset + q0 + bq - 1:
                break
            s = qb @ kt[:, :, k0:k0 + block_kv].float().transpose(-1, -2)
            if causal:
                kpos = k0 + torch.arange(s.shape[-1], device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + \
                p @ vt[:, :, k0:k0 + block_kv].float()
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + bq] = o.transpose(1, 2).to(q.dtype)
    return out


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int, scale: float, block_q: int = BLOCK_Q,
                       sink_len: int = 0) -> torch.Tensor:
    """Causal sliding-window attention in q blocks, O(S·(W + Bq)) work.

    q/k/v: (B, S, H, D), k/v GQA-expanded.  A q block of size Bq attends to
    the keys [i·Bq - W, (i+1)·Bq); each query sees ``window + 1`` keys.
    ``sink_len > 0`` keeps the first ``sink_len`` positions visible
    (causally) to every query; sinks inside the block's slice are counted
    there once, those before it are prepended."""
    B, S, H, D = q.shape
    dev = q.device
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, H, S, D)
    out = torch.empty_like(q)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        lo = max(q0 - window, 0)
        qpos = torch.arange(q0, q1, device=dev)[:, None]
        kpos = torch.arange(lo, q1, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window - 1)
        kj, vj = kt[:, :, lo:q1], vt[:, :, lo:q1]
        if sink_len:
            mask |= (kpos < sink_len) & (kpos <= qpos)
            spos = torch.arange(min(sink_len, S), device=dev)[None, :]
            mask = torch.cat([(spos <= qpos) & (spos < lo), mask], dim=1)
            kj = torch.cat([kt[:, :, :sink_len], kj], dim=2)
            vj = torch.cat([vt[:, :, :sink_len], vj], dim=2)
        qb = q[:, q0:q1].transpose(1, 2).float() * scale
        s = (qb @ kj.float().transpose(-1, -2)).masked_fill(~mask, NEG_INF)
        o = torch.softmax(s, dim=-1) @ vj.float()
        out[:, q0:q1] = o.transpose(1, 2).to(q.dtype)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *, window: int,
                     scale: float, groups: int,
                     sink_len: int = 0) -> torch.Tensor:
    """New tokens' attention against a cache.

    q: (B, Sq, H, D); caches: (B, S, KV, D), not expanded: the query heads
    are grouped as (KV, groups) against them; ``cache_len``: the tokens
    valid, the new ones included.  ``window > 0`` (and < S) reads only the
    ``window`` positions ending at ``cache_len`` (a static-width slice
    whose start the reference's ``dynamic_slice`` clamps into the cache);
    ``sink_len`` keeps the first positions visible as well."""
    B, S, KV, D = k_cache.shape
    Sq = q.shape[1]
    dev = q.device
    if window and window < S:
        start = max(cache_len - window, 0)
        lo = min(start, S - window)
        k_use = k_cache[:, lo:lo + window]
        v_use = v_cache[:, lo:lo + window]
        valid = start + torch.arange(window, device=dev) < cache_len
        if sink_len:
            spos = torch.arange(sink_len, device=dev)
            valid = torch.cat([(spos < cache_len) & (spos < start), valid])
            k_use = torch.cat([k_cache[:, :sink_len], k_use], dim=1)
            v_use = torch.cat([v_cache[:, :sink_len], v_use], dim=1)
    else:
        k_use, v_use = k_cache, v_cache
        valid = torch.arange(S, device=dev) < cache_len
    qg = q.float().mul(scale).view(B, Sq, KV, groups, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k_use.float())
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v_use.float())
    return o.reshape(B, Sq, KV * groups, D).to(q.dtype)


# ---------------------------------------------------------------------------
# full GQA attention layer
# ---------------------------------------------------------------------------
def project_heads(params: dict, x: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  cfg: ModelConfig,
                  mrope_positions: Optional[torch.Tensor] = None):
    """(B, S, d) → q (B, S, H, D), k and v (B, S, KV, D) in x's dtype: the
    projections, the qkv biases, RoPE on q and k (M-RoPE where the config
    has it and ``mrope_positions`` (3, B, S) are given; none when
    ``positions`` is None, as the reference's whisper decoder passes)."""
    B, S, d = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt).reshape(d, H * D)).view(B, S, H, D)
    k = (x @ params["wk"].to(dt).reshape(d, KV * D)).view(B, S, KV, D)
    v = (x @ params["wv"].to(dt).reshape(d, KV * D)).view(B, S, KV, D)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.mrope and mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, mrope_positions, cfg.rope_theta,
                            cfg.mrope_sections), v)
    if positions is None:                   # learned positions (whisper)
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def project_qkv(params: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor],
                cfg: ModelConfig,
                mrope_positions: Optional[torch.Tensor] = None):
    """``project_heads`` with k and v GQA-expanded to (B, S, H, D)."""
    q, k, v = project_heads(params, x, positions, cfg, mrope_positions)
    G = cfg.num_heads // cfg.num_kv_heads
    return q, repeat_kv(k, G), repeat_kv(v, G)


def write_cache(cache: dict, new: dict, cache_len: int) -> None:
    """Write each new (B, n, ...) entry of ``new`` (k and v, or MLA's c_kv
    and k_pe) into the cache leaf of its name, in place, at
    ``cache_len - 1``, the start clamped into [0, max_len - n] as the
    reference's ``dynamic_update_slice`` clamps it: past the end of the
    cache the last slots are overwritten."""
    for name, rows in new.items():
        leaf = cache[name]
        if rows.dtype != leaf.dtype:
            raise TypeError(f"cache of {leaf.dtype} written with "
                            f"{rows.dtype} {name} (the reference refuses it "
                            f"too)")
        S, n = leaf.shape[1], rows.shape[1]
        idx = min(max(cache_len - 1, 0), S - n)
        leaf[:, idx:idx + n] = rows


def apply_attention(params: dict, x: torch.Tensor,
                    positions: Optional[torch.Tensor],
                    cfg: ModelConfig, *, window: int = 0,
                    cache: Optional[dict] = None,
                    cache_len: Optional[int] = None,
                    mrope_positions: Optional[torch.Tensor] = None,
                    sink_len: int = 0) -> torch.Tensor:
    """(B, S, d) → (B, S, d).

    Train/prefill (``cache`` None): ``window`` > 0 and < S makes the layer
    sliding-window, otherwise it is full causal.  Decode: x is (B, 1, d),
    ``cache`` one layer's ``{"k", "v"}`` of (B, max_len, KV, D), written in
    place at ``cache_len - 1`` (an int: the tokens valid, the new one
    included).  ``mrope_positions`` (3, B, S) replace RoPE by M-RoPE where
    the config has it."""
    B, S, d = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(D)
    if cache is not None:
        q, k, v = project_heads(params, x, positions, cfg, mrope_positions)
        write_cache(cache, {"k": k, "v": v}, cache_len)
        o = decode_attention(q, cache["k"], cache["v"], cache_len,
                             window=window, scale=scale, groups=H // KV,
                             sink_len=sink_len)
    else:
        q, kx, vx = project_qkv(params, x, positions, cfg, mrope_positions)
        window = window if window < S else 0
        if B * H * S * S * 4 <= MASKED_SCORES_BYTES:
            o = masked_attention(q, kx, vx, window=window, scale=scale,
                                 sink_len=sink_len)
        elif window:
            o = windowed_attention(q, kx, vx, window=window, scale=scale,
                                   sink_len=sink_len)
        else:
            o = online_softmax_attention(q, kx, vx, causal=True, scale=scale)
    return o.reshape(B, S, H * D) @ params["wo"].to(x.dtype).reshape(H * D, d)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: str = "bfloat16", device=None) -> dict:
    """One layer's zero cache ``{"k", "v"}`` of (batch, max_len, KV, D) on
    ``device`` (the CUDA card unless given)."""
    shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {n: torch.zeros(shp, dtype=torch_dtype(dtype), device=dev)
            for n in ("k", "v")}


def abstract_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: str = "bfloat16") -> dict:
    """``init_kv_cache``'s shapes and dtypes as meta tensors (no memory)."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 latent attention)
# ---------------------------------------------------------------------------
def mla_latent_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                         c_kv: torch.Tensor, k_pe: torch.Tensor,
                         cache_len: int, scale: float) -> torch.Tensor:
    """The absorbed decode's attention in the latent space, in float32:
    q_lat (B, Sq, H, r) and q_pe (B, Sq, H, dr) against the latent cache
    c_kv (B, L, r) and k_pe (B, L, dr), positions below ``cache_len``
    valid; returns the softmax-weighted latent o_lat (B, Sq, H, r) in
    float32.  ``c_kv``'s float32 copy is made once for both products."""
    ckv = c_kv.float()
    s = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv)
         + torch.einsum("bshk,btk->bhst", q_pe.float(), k_pe.float())) * scale
    valid = torch.arange(c_kv.shape[1], device=c_kv.device) < cache_len
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    return torch.einsum("bhst,btr->bshr", p, ckv)


def mla_project(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    """(B, S, d) → q_nope (B, S, H, dn), q_pe (B, S, H, dr) with RoPE, the
    normalised latent c_kv (B, S, r) and k_pe (B, S, dr) with RoPE, all in
    x's dtype."""
    B, S, d = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt).reshape(d, H * (dn + dr))).view(
        B, S, H, dn + dr)
    q_pe = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv = rms_norm(x @ params["w_dkv"].to(dt), params["kv_norm"],
                    cfg.norm_eps)
    k_pe = apply_rope((x @ params["w_kpe"].to(dt))[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]
    return q[..., :dn], q_pe, c_kv, k_pe


def apply_mla(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, cache: Optional[dict] = None,
              cache_len: Optional[int] = None) -> torch.Tensor:
    """Multi-head latent attention, (B, S, d) → (B, S, d).

    Prefill / train (``cache`` None): per-head k_nope and v from the
    latent, k_pe shared by the heads, v zero-padded to ``dn + dr``, the
    causal ``online_softmax_attention`` at scale 1/sqrt(dn + dr), the
    output cut back to ``dv``.  Decode: the new c_kv and k_pe written into
    ``cache`` in place at ``cache_len - 1`` (clamped, ``write_cache``), then
    the weight-absorbed form: q_nope through ``w_uk`` into the latent,
    ``mla_latent_attention``, the latent output through ``w_uv``."""
    B, S, d = x.shape
    H = cfg.num_heads
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    dt = x.dtype
    scale = 1.0 / math.sqrt(dn + dr)
    q_nope, q_pe, c_kv, k_pe = mla_project(params, x, positions, cfg)
    if cache is not None:
        write_cache(cache, {"c_kv": c_kv, "k_pe": k_pe}, cache_len)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
        o_lat = mla_latent_attention(q_lat, q_pe, cache["c_kv"],
                                     cache["k_pe"], cache_len, scale)
        o = torch.einsum("bshr,rhk->bshk", o_lat.to(dt),
                         params["w_uv"].to(dt))
    else:
        k_nope = (c_kv @ params["w_uk"].to(dt).reshape(r, H * dn)).view(
            B, S, H, dn)
        v = (c_kv @ params["w_uv"].to(dt).reshape(r, H * dv)).view(
            B, S, H, dv)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        o = online_softmax_attention(
            torch.cat([q_nope, q_pe], dim=-1), k,
            torch.nn.functional.pad(v, (0, dn + dr - dv)),
            causal=True, scale=scale)[..., :dv]
    return o.reshape(B, S, H * dv) @ params["wo"].to(dt).reshape(H * dv, d)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: str = "bfloat16", device=None) -> dict:
    """One MLA layer's zero cache ``{"c_kv" (batch, max_len, r), "k_pe"
    (batch, max_len, dr)}`` on ``device`` (the CUDA card unless given)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device=dev),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                dtype=dt, device=dev)}


def abstract_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: str = "bfloat16") -> dict:
    """``init_mla_cache``'s shapes and dtypes as meta tensors (no
    memory)."""
    return init_mla_cache(cfg, batch, max_len, dtype, device="meta")
