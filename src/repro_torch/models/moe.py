"""Mixture-of-Experts (twin of ``repro.models.moe``): top-k router, shared
experts and three dispatches of the routed tokens.

* ``dense``    — every expert runs on every token, the outputs combined by
                 the router weights: the numerical oracle.
* ``dropping`` — the default: a global sort-based capacity dispatch.  The
                 N·k routed copies go to an (E, C, d) buffer in expert
                 order, the expert FFNs run as one batched product, the
                 results gather back; copies past an expert's capacity C
                 are dropped (Switch/GShard semantics).
* ``grouped``  — the same dispatch within each batch row (capacity from S,
                 not N): the reference's ``vmap`` over B, here one batched
                 computation with per-row offsets.

The dispatch copies the reference's order semantics exactly: a stable
argsort of the copies' experts, its inverse permutation, per-expert counts
and exclusive offsets, ``keep = pos < C``, a sentinel row ``E·C`` that
absorbs the dropped copies (its colliding writes are thrown away; the real
slots are unique), and a combine that zeroes dropped copies before the sum
over k.  ``jax.lax.top_k`` breaks ties by the lower index; the port takes a
stable descending sort, which does the same.  Counts are a scatter-add, not
``bincount``, which would wait for the card to size its output.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import silu
from repro_torch.models.param import P, dense

DEFAULT_CAPACITY_FACTOR = 1.25
IMPLS = ("dense", "grouped", "dropping")


def describe_moe(cfg: ModelConfig) -> dict:
    d, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out = {"router": dense(d, E, "embed", None, stddev=0.02),
           "wi_gate": P((E, d, F), ("experts", "embed", "expert_ffn")),
           "wi_up": P((E, d, F), ("experts", "embed", "expert_ffn")),
           "wo": P((E, F, d), ("experts", "expert_ffn", "embed"))}
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * cfg.moe_d_ff
        out.update(shared_wi_gate=dense(d, Fs, "embed", "ffn"),
                   shared_wi_up=dense(d, Fs, "embed", "ffn"),
                   shared_wo=dense(Fs, d, "ffn", "embed"))
    return out


def capacity(tokens: int, k: int, E: int,
             capacity_factor: float = DEFAULT_CAPACITY_FACTOR) -> int:
    """Slots an expert gets for ``tokens`` tokens routed to k of E experts:
    ``max(8, roundup8(int(cf · tokens · k / E)))``."""
    C = int(capacity_factor * tokens * k / E)
    return max(8, -(-C // 8) * 8)


def _router(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, d) → top-k ids (N, k) int64, top-k weights (N, k) in x's dtype
    (renormalised to sum 1), the load-balance aux loss (float32 scalar):
    ``E · Σ_e(frac_e · mean_p_e) · router_aux_loss``.  The logits are
    computed in x's dtype, then float32."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    assign = torch.zeros_like(probs).scatter_(1, ids, 1.0)
    aux = E * torch.sum(assign.mean(dim=0) * probs.mean(dim=0)) * \
        cfg.router_aux_loss
    return ids, w.to(x.dtype), aux


def _expert_ffn(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: xe (E, C, d) → (E, C, d)."""
    dt = xe.dtype
    g = torch.bmm(xe, params["wi_gate"].to(dt))
    u = torch.bmm(xe, params["wi_up"].to(dt))
    return torch.bmm(silu(g) * u, params["wo"].to(dt))


def dispatch_slots(ids: torch.Tensor, E: int, C: int):
    """Capacity dispatch of routed copies, each row of ``ids`` (G, M) a
    group of its own (M = tokens · k, in token-major order): each copy's
    slot ``expert · C + rank within its expert`` among the group's copies
    in stable expert order, or the sentinel ``E · C`` past capacity, and
    whether it was kept.  Returns (slot (G, M), keep (G, M))."""
    ids = ids.long()
    G, M = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(M, device=ids.device).expand(G, M))
    counts = torch.zeros((G, E), dtype=torch.long, device=ids.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids))
    offsets = counts.cumsum(dim=1) - counts                    # exclusive
    pos = ranks - offsets.gather(1, ids)
    keep = pos < C
    return torch.where(keep, ids * C + pos, E * C), keep


def _dispatch_combine(params: dict, x: torch.Tensor, ids: torch.Tensor,
                      w: torch.Tensor, E: int, C: int,
                      grouped: bool) -> torch.Tensor:
    """Capacity dispatch within each of G groups: x (G, T, d), ids and w
    (G, T, k) → (G, T, d).  Each group's (E·C + 1, d) buffer (the last row
    the sentinel) is a slice of one flat buffer; the expert products run
    over all groups at once, (E, G·C, d).  ``grouped``: the groups are the
    batch rows (the reference's layout constraints of each dispatch: the
    grouped buffers on (batch, experts), their outputs replicated over the
    model axis; the one group of ``dropping`` on experts)."""
    G, T, d = x.shape
    k = ids.shape[-1]
    slot, keep = dispatch_slots(ids.reshape(G, T * k), E, C)
    rows = E * C + 1
    flat = (slot + rows * torch.arange(G, device=x.device)[:, None]
            ).reshape(-1)
    src = x.repeat_interleave(k, dim=1).reshape(G * T * k, d)
    buf = x.new_zeros((G * rows, d)).index_copy(0, flat, src)
    xe = buf.view(G, rows, d)[:, :E * C].reshape(G, E, C, d)
    lead = "batch" if grouped else None
    xe = logical_constraint(xe, lead, "experts", None, None)
    ye = _expert_ffn(params, xe.transpose(0, 1).reshape(E, G * C, d))
    ye = ye.view(E, G, C, d).transpose(0, 1)
    ye = logical_constraint(ye, lead, None if grouped else "experts", None,
                            None).reshape(G, E * C, d)
    yg = ye.gather(1, slot.clamp(max=E * C - 1)[..., None].expand(-1, -1, d))
    yg = torch.where(keep[..., None], yg, 0.0)
    return (yg.view(G, T, k, d) * w[..., None]).sum(dim=2)


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              impl: str = "dropping",
              capacity_factor: float = DEFAULT_CAPACITY_FACTOR
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out (B, S, d), aux loss float32 scalar); ``impl`` one
    of ``IMPLS`` (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE dispatch {impl!r}; one of {IMPLS}")
    B, S, d = x.shape
    N = B * S
    dt = x.dtype
    xf = x.reshape(N, d)
    ids, w, aux = _router(params, xf, cfg)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    if impl == "dense":
        g = torch.matmul(xf, params["wi_gate"].to(dt))          # (E, N, F)
        u = torch.matmul(xf, params["wi_up"].to(dt))
        ye = torch.bmm(silu(g) * u, params["wo"].to(dt))        # (E, N, d)
        combine = torch.zeros((N, E), dtype=dt, device=x.device).scatter(
            1, ids, w)
        y = torch.einsum("ne,end->nd", combine, ye)
    elif impl == "grouped":
        y = _dispatch_combine(params, x, ids.view(B, S, k), w.view(B, S, k),
                              E, capacity(S, k, E, capacity_factor), True)
    else:
        y = _dispatch_combine(params, xf[None], ids[None], w[None], E,
                              capacity(N, k, E, capacity_factor), False)
    y = y.reshape(N, d)
    if cfg.num_shared_experts:
        g = xf @ params["shared_wi_gate"].to(dt)
        u = xf @ params["shared_wi_up"].to(dt)
        y = y + (silu(g) * u) @ params["shared_wo"].to(dt)
    return y.reshape(B, S, d), aux


def dropped_copies(ids: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """How many of the routed copies ``ids`` (G, M) the capacity dispatch
    drops at capacity C (an int64 tensor; no host sync)."""
    return (~dispatch_slots(ids, E, C)[1]).sum()
