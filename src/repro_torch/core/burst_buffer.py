"""Multi-mode burst-buffer engine on stacked tensors (twin of
``repro.core.burst_buffer``).

Every table has a leading node axis ``N``; the cross-node exchange is a row
permutation on one device (``exchange_plan``).  Each request batch carries
a per-request mode array, is routed by the triplet of ``layouts``, and
crosses the node axis through ``run_exchange``; one round serves a
mixed-mode batch.  Mode semantics are the JAX package's:

* Mode 1: all routing → self; reads of remote data broadcast-search;
* Mode 2: file metadata → the md-server subset, data hashed;
* Mode 3: everything hashed;
* Mode 4: local writes, hashed metadata recording the data location,
  two-phase reads.

Differences from the JAX engine, none visible in any result:

* **In place.** JAX arrays are immutable; here the entry points update the
  state's tables in place and return the same ``BBState`` (the payload
  table is the one structure too large to copy per call).  A state passed
  to ``forward_write`` or ``meta_op`` must not be used as a snapshot of
  the tables before the call.
* **Scatters.** A JAX scatter drops out-of-range indices (``mode="drop"``)
  and, on the CPU, lets the last of several updates to one slot win.  Here
  out-of-range updates are masked out, and a repeated (row, slot) is
  resolved to its last update before the scatter (``_scatter_last``), so
  the result does not depend on the order in which the card applies
  duplicate writes.
* **Stranded-data broadcast.** ``_broadcast_lookup`` resolves which node
  holds each missed chunk from the key tables alone and gathers only those
  rows, instead of materialising every node's payload for every request.
* **Re-compaction.** ``_clear_chunks`` gathers the surviving rows into a
  new table and swaps it into the state (a gather cannot write into its
  own source), so a relayout holds one extra data table at its peak.

The entry points carry the reference's ``engine.*`` spans, and the fused
write its ``exchange.plan/pack/apply`` spans, while a flight recorder is
active (``repro_torch.core.obs``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import obs
from repro_torch.core.exchange_plan import (  # noqa: F401  (re-exports)
    COMPACTED, DENSE, LOCAL_WRITE_MODES, ExchangeConfig, RaggedSpec,
    data_budget, exchange_footprint, fused_send, fused_write_plan,
    meta_budget, plan_ragged_spec, run_exchange)
from repro_torch.core.layouts import LayoutMode, route_data, route_meta
from repro_torch.core.policy import LayoutPolicy, as_policy
from repro_torch.kernels.chunk_pack.ops import gather_rows_batched

EMPTY = -1
I32 = torch.int32

# metadata op codes
OP_CREATE, OP_STAT, OP_REMOVE, OP_UPDATE = 0, 1, 2, 3


@dataclass
class BBState:
    """All node tables, stacked on a leading node axis (int32 tensors)."""

    data: torch.Tensor        # (N, cap, words) chunk payloads
    data_keys: torch.Tensor   # (N, cap, 2) (path_hash, chunk_id); -1 empty
    data_count: torch.Tensor  # (N,)
    meta_key: torch.Tensor    # (N, mcap) path_hash; -1 empty
    meta_size: torch.Tensor   # (N, mcap) file size (chunks)
    meta_loc: torch.Tensor    # (N, mcap) data_location_rank (Mode 4)
    meta_count: torch.Tensor  # (N,)
    dropped: torch.Tensor     # (N,) capacity-overflow counter


def init_state(n_nodes: int, cap: int, words: int, mcap: int,
               device=None) -> BBState:
    """Fresh empty node tables on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return BBState(full((n_nodes, cap, words), 0),
                   full((n_nodes, cap, 2), EMPTY), full((n_nodes,), 0),
                   full((n_nodes, mcap), EMPTY), full((n_nodes, mcap), 0),
                   full((n_nodes, mcap), EMPTY), full((n_nodes,), 0),
                   full((n_nodes,), 0))


def from_jax_state(arrays: Sequence[np.ndarray], device=None) -> BBState:
    """The eight tables of a JAX ``BBState`` (as numpy int32, in field
    order) as the port's tensors on ``device``."""
    dev = resolve_device(device)
    if len(arrays) != len(fields(BBState)):
        raise ValueError(f"expected {len(fields(BBState))} tables, got "
                         f"{len(arrays)}")
    return BBState(*(torch.tensor(np.array(a, np.int32), device=dev)
                     for a in arrays))


def to_numpy(state: BBState) -> Tuple[np.ndarray, ...]:
    """The eight tables as numpy int32 arrays, in field order."""
    return tuple(getattr(state, f.name).cpu().numpy()
                 for f in fields(BBState))


# ---------------------------------------------------------------------------
# node-local table ops
# ---------------------------------------------------------------------------
def _rows(shape, device) -> torch.Tensor:
    """(N, m) row index of every entry of an (N, m) batch."""
    return torch.arange(shape[0], device=device)[:, None].expand(shape)


def _scatter_last(table: torch.Tensor, slot: torch.Tensor,
                  values: torch.Tensor, keep: torch.Tensor) -> None:
    """``table[n, slot[n, j]] = values[n, j]`` for the ``keep`` entries, in
    place; when several kept entries of a row name one slot the last one
    wins (the JAX CPU scatter's order), whatever order the device would
    apply them in.

    Every entry writes: the value of the last kept entry aimed at its slot,
    or the slot's current value when no kept entry aims there.  Writes to
    one slot therefore all carry the same value, so the copy is
    deterministic, and no boolean mask makes the host wait for the card.
    """
    N, m = slot.shape
    cap = table.shape[1]
    if slot.numel() == 0 or table.numel() == 0:
        return
    flat = table.view(N * cap, -1)
    key = (_rows(slot.shape, slot.device) * cap + slot.clamp(0, cap - 1)
           ).reshape(-1)
    pos = torch.arange(N * m, device=slot.device)
    last = torch.full((N * cap,), -1, dtype=torch.int64, device=slot.device)
    last.scatter_reduce_(0, key, torch.where(keep.reshape(-1), pos, -1),
                         reduce="amax")
    win = last[key]
    vals = values.reshape(N * m, -1).to(table.dtype)[win.clamp(min=0)]
    flat.index_copy_(0, key, torch.where((win >= 0)[:, None], vals,
                                         flat[key]))


def _append_chunks(state: BBState, keys: torch.Tensor, data: torch.Tensor,
                   valid: torch.Tensor) -> BBState:
    """Append received chunks. keys: (N, m, 2); data: (N, m, w); valid:
    (N, m).  Duplicate keys append a new version; lookups return the
    newest.  Chunks past the table capacity are dropped and counted."""
    cap = state.data.shape[1]
    rank = torch.cumsum(valid.to(I32), dim=1, dtype=I32) - 1
    slot = state.data_count[:, None] + rank
    ok = valid & (slot < cap)
    rows = _rows(valid.shape, valid.device)
    r, s = rows[ok], slot[ok].long()
    state.data_keys[r, s] = keys[ok].to(I32)
    state.data[r, s] = data[ok].to(I32)
    state.data_count += ok.sum(dim=1, dtype=I32)
    state.dropped += (valid & ~ok).sum(dim=1, dtype=I32)
    return state


def _lookup_slots(state: BBState, keys: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys: (N, m, 2) → (newest table slot (N, m), found (N, m))."""
    tbl = state.data_keys
    eq = (tbl[:, None, :, 0] == keys[:, :, None, 0]) & \
         (tbl[:, None, :, 1] == keys[:, :, None, 1]) & \
         (tbl[:, None, :, 0] != EMPTY)                          # (N, m, cap)
    found = eq.any(dim=2) & valid
    newest = torch.arange(1, tbl.shape[1] + 1, dtype=I32, device=tbl.device)
    idx = torch.argmax(eq.to(I32) * newest, dim=2)
    return idx, found


def _lookup_chunks(state: BBState, keys: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys: (N, m, 2) → (payload (N, m, w), found (N, m)). Newest wins."""
    idx, found = _lookup_slots(state, keys, valid)
    payload = state.data[_rows(idx.shape, idx.device), idx]
    return payload.masked_fill_(~found[..., None], 0), found


def _alloc_meta_slots(mk: torch.Tensor, new_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each new entry a distinct EMPTY slot (ascending, per row).

    Returns (slot (N, m) — ``mcap`` for entries that don't fit, fits).
    Slots freed by REMOVE are reused.
    """
    N, mcap = mk.shape
    empty = mk == EMPTY
    n_empty = empty.sum(dim=1, dtype=I32)
    ar = torch.arange(mcap, dtype=I32, device=mk.device)[None, :]
    empty_idx = torch.argsort(torch.where(empty, ar, mcap), dim=1,
                              stable=True)
    rank = torch.cumsum(new_mask.to(I32), dim=1, dtype=I32) - 1
    fits = new_mask & (rank < n_empty[:, None])
    slot = torch.gather(empty_idx, 1, rank.clamp(0, mcap - 1).long())
    return torch.where(fits, slot.to(I32), mcap), fits


def _meta_find(mk: torch.Tensor, k: torch.Tensor, ok: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, mcap) table scan: first slot holding each key."""
    eq = (mk[:, None, :] == k[:, :, None]) & (mk[:, None, :] != EMPTY)
    return eq.any(dim=2) & ok, torch.argmax(eq.to(I32), dim=2)


def _meta_apply(state: BBState, op: torch.Tensor, key: torch.Tensor,
                size: torch.Tensor, loc: torch.Tensor, valid: torch.Tensor):
    """Apply a batch of metadata ops to the tables, in place.

    op/key/size/loc/valid: (N, m).  Returns (state, found, r_size, r_loc).
    Order within the batch: CREATE → UPDATE → STAT → REMOVE.
    """
    mk, ms, ml = state.meta_key, state.meta_size, state.meta_loc

    # CREATE (skip if exists — idempotent create)
    c_ok = valid & (op == OP_CREATE)
    exists, _ = _meta_find(mk, key, c_ok)
    c_new = c_ok & ~exists
    slot, fits = _alloc_meta_slots(mk, c_new)
    _scatter_last(mk, slot, key, fits)
    _scatter_last(ms, slot, size, fits)
    _scatter_last(ml, slot, loc, fits)
    state.dropped += (c_new & ~fits).sum(dim=1, dtype=I32)

    # UPDATE (size := max(size, new); loc := new if >= 0); a write to a
    # file without an entry upserts it (implicit create on first write)
    u_ok = valid & (op == OP_UPDATE)
    fnd_u0, _ = _meta_find(mk, key, u_ok)
    missing = u_ok & ~fnd_u0
    slot_m, fits_m = _alloc_meta_slots(mk, missing)
    _scatter_last(mk, slot_m, key, fits_m)
    _scatter_last(ms, slot_m, torch.zeros_like(size), fits_m)
    _scatter_last(ml, slot_m, loc, fits_m)
    state.dropped += (missing & ~fits_m).sum(dim=1, dtype=I32)

    fnd_u, idx_u = _meta_find(mk, key, u_ok)
    cur_sz = torch.gather(ms, 1, idx_u)
    new_sz = torch.where(fnd_u, torch.maximum(cur_sz, size), cur_sz)
    _scatter_last(ms, idx_u, new_sz, fnd_u)
    cur_loc = torch.gather(ml, 1, idx_u)
    new_loc = torch.where(fnd_u & (loc >= 0), loc, cur_loc)
    _scatter_last(ml, idx_u, new_loc, fnd_u)

    # STAT
    s_ok = valid & (op == OP_STAT)
    fnd_s, idx_s = _meta_find(mk, key, s_ok)
    r_size = torch.where(fnd_s, torch.gather(ms, 1, idx_s), -1)
    r_loc = torch.where(fnd_s, torch.gather(ml, 1, idx_s), -1)

    # REMOVE — clear the whole record (key, size, loc)
    r_ok = valid & (op == OP_REMOVE)
    fnd_r, idx_r = _meta_find(mk, key, r_ok)
    for t, v in ((mk, EMPTY), (ms, 0), (ml, EMPTY)):
        _scatter_last(t, idx_r, torch.full_like(idx_r, v), fnd_r)

    state.meta_count.copy_((mk != EMPTY).sum(dim=1, dtype=I32))
    found = (valid & (op == OP_CREATE)) | fnd_u | fnd_s | fnd_r
    return state, found, r_size, r_loc


def _meta_write_apply(state: BBState, key: torch.Tensor, size: torch.Tensor,
                      loc: torch.Tensor, valid: torch.Tensor,
                      create: torch.Tensor) -> BBState:
    """``_meta_apply`` for a write batch whose reply is discarded: only the
    CREATE and UPDATE passes (``create`` marks the CREATE ops), with the
    three metadata columns packed into one (N, mcap, 3) table so each pass
    is one scatter.  The tables end bit-for-bit as the generic apply's."""
    tbl = torch.stack([state.meta_key, state.meta_size, state.meta_loc],
                      dim=-1)                                    # (N, mcap, 3)
    mk = tbl[..., 0]

    # CREATE (skip if exists — idempotent create)
    c_ok = valid & create
    exists, _ = _meta_find(mk, key, c_ok)
    c_new = c_ok & ~exists
    slot, fits = _alloc_meta_slots(mk, c_new)
    _scatter_last(tbl, slot, torch.stack([key, size, loc], dim=-1), fits)
    state.dropped += (c_new & ~fits).sum(dim=1, dtype=I32)

    # UPDATE upsert on miss (implicit create: size 0, loc as sent)
    u_ok = valid & ~create
    fnd_u0, _ = _meta_find(mk, key, u_ok)
    missing = u_ok & ~fnd_u0
    slot_m, fits_m = _alloc_meta_slots(mk, missing)
    _scatter_last(tbl, slot_m,
                  torch.stack([key, torch.zeros_like(size), loc], dim=-1),
                  fits_m)
    state.dropped += (missing & ~fits_m).sum(dim=1, dtype=I32)

    # UPDATE (size := max(size, new); loc := new if >= 0)
    fnd_u, idx_u = _meta_find(mk, key, u_ok)
    cur = torch.gather(tbl, 1, idx_u[..., None].expand(-1, -1, 3))
    new_sz = torch.where(fnd_u, torch.maximum(cur[..., 1], size),
                         cur[..., 1])
    new_loc = torch.where(fnd_u & (loc >= 0), loc, cur[..., 2])
    _scatter_last(tbl, idx_u, torch.stack([key, new_sz, new_loc], dim=-1),
                  fnd_u)

    state.meta_key.copy_(tbl[..., 0])
    state.meta_size.copy_(tbl[..., 1])
    state.meta_loc.copy_(tbl[..., 2])
    state.meta_count.copy_((state.meta_key != EMPTY).sum(dim=1, dtype=I32))
    return state


# ---------------------------------------------------------------------------
# client-visible batched operations — every cross-node phase is ONE
# ``run_exchange`` call: a request buffer plus a receiver-side apply
# ---------------------------------------------------------------------------
def _client_ranks(L: int, device) -> torch.Tensor:
    return torch.arange(L, dtype=I32, device=device)[:, None]


def _mode_array(policy: LayoutPolicy, mode: Optional[torch.Tensor],
                ref: torch.Tensor) -> torch.Tensor:
    """Per-request mode array; defaults to the policy's uniform default."""
    if mode is None:
        return policy.mode_array(ref.shape, ref.device)
    return mode.to(I32)


def _ones_col(ref: torch.Tensor) -> torch.Tensor:
    """The occupancy column: arrives as the receiver validity mask (empty
    plan slots gather the sentinel zero row)."""
    return torch.ones(tuple(ref.shape[:-1]) + (1,), dtype=I32,
                      device=ref.device)


def _write_meta_fields(mode, chunk_id, client):
    """Op code (CREATE for chunk 0, else UPDATE) and recorded data location
    (the writer's rank for Mode 4, else -1) of a write's metadata plane."""
    op = torch.where(chunk_id == 0, OP_CREATE, OP_UPDATE).to(I32)
    loc = torch.where(mode == LayoutMode.HYBRID,
                      torch.broadcast_to(client, chunk_id.shape), -1)
    return op, loc.to(I32)


def _fused_write(state: BBState, policy: LayoutPolicy, executors,
                 dest: torch.Tensor, valid: torch.Tensor, mode: torch.Tensor,
                 path_hash: torch.Tensor, chunk_id: torch.Tensor,
                 payload: torch.Tensor, keys: torch.Tensor,
                 client: torch.Tensor) -> BBState:
    """The fused write: data and metadata planes in one round, no reply.

    Each plane packs under its own plan; ``fused_send`` hands each plane's
    receiver exactly its serial receive view, so ``_append_chunks`` and the
    write-only metadata apply see the rows the serial rounds would have
    handed them.  Callers gate on ``fused_write_plan``.
    """
    ex_d, ex_m = executors
    N = policy.n_nodes
    w = payload.shape[-1]
    op, loc = _write_meta_fields(mode, chunk_id, client)
    owner = route_meta(mode, N, policy.n_md_servers, path_hash, client)
    fields_d = torch.cat([keys, payload, _ones_col(keys)], dim=-1)
    fields_m = torch.stack([op, path_hash, chunk_id + 1, loc,
                            torch.ones_like(op)], dim=-1)
    with obs.span("exchange.plan", cat="trace", role="fused_write",
                  kind="compacted"):
        plan_d = ex_d.plan(dest, valid)
        plan_m = ex_m.plan(owner, valid)
    with obs.span("exchange.pack", cat="trace", role="fused_write",
                  executor=type(ex_d).__name__):
        recv_d, rv_d, recv_m, rv_m = fused_send(ex_d, plan_d, fields_d,
                                                ex_m, plan_m, fields_m)
    with obs.span("exchange.apply", cat="trace", role="fused_write"):
        state = _append_chunks(state, recv_d[..., :2], recv_d[..., 2:2 + w],
                               rv_d)
        state = _meta_write_apply(state, recv_m[..., 1], recv_m[..., 2],
                                  recv_m[..., 3], rv_m,
                                  create=recv_m[..., 0] == OP_CREATE)
    return state


@obs.trace_span("engine.forward_write")
def forward_write(state: BBState, layout, path_hash: torch.Tensor,
                  chunk_id: torch.Tensor, payload: torch.Tensor,
                  valid: torch.Tensor, mode: Optional[torch.Tensor] = None,
                  config: ExchangeConfig = DENSE,
                  update_meta: bool = True) -> BBState:
    """Each node writes a batch of chunks (tables updated in place).

    path_hash/chunk_id/valid: (N, q); payload: (N, q, w), converted to the
    int32 tables (a float payload truncates, as in the JAX engine).
    ``mode`` is the per-request mode array (policy default when omitted);
    its values must be members of ``policy.modes_present()``.  ``config``
    picks the exchange plane.  ``update_meta=False`` skips the metadata
    create/update round.
    """
    policy = as_policy(layout)
    N = policy.n_nodes
    client = _client_ranks(state.data.shape[0], path_hash.device)
    mode = _mode_array(policy, mode, path_hash)
    path_hash, chunk_id = path_hash.to(I32), chunk_id.to(I32)
    payload = payload.to(I32)
    dest = route_data(mode, N, path_hash, chunk_id, client)
    keys = torch.stack([path_hash, chunk_id], dim=-1)
    meta_valid = valid
    local_only = policy.modes_present() <= LOCAL_WRITE_MODES
    if update_meta and not local_only:
        fplan = fused_write_plan(policy, dest.shape[1], config)
        if fplan is not None:
            return _fused_write(state, policy, fplan, dest, valid, mode,
                                path_hash, chunk_id, payload, keys, client)
    if local_only:
        # every possible mode writes locally: no exchange at all
        state = _append_chunks(state, keys, payload, valid)
    else:
        fields = torch.cat([keys, payload, _ones_col(keys)], dim=-1)

        def apply(st, recv, rvalid):
            return _append_chunks(st, recv[..., :2], recv[..., 2:],
                                  rvalid), None

        state, _, served, overflow = run_exchange(
            "data", policy, config, dest, valid, fields, apply, state=state)
        if config.kind == "compacted" and not config.lossless:
            state.dropped += overflow
            # a write whose payload overflowed must not register metadata
            meta_valid = valid & served
    if not update_meta:
        return state
    op, loc = _write_meta_fields(mode, chunk_id, client)
    state, _, _, _ = meta_op(state, policy, op, path_hash, chunk_id + 1, loc,
                             meta_valid, mode, config)
    return state


@obs.trace_span("engine.forward_read")
def forward_read(state: BBState, layout, path_hash: torch.Tensor,
                 chunk_id: torch.Tensor, valid: torch.Tensor,
                 mode: Optional[torch.Tensor] = None,
                 config: ExchangeConfig = DENSE,
                 data_loc: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each node reads a batch of chunks → (payload (N, q, w), found).

    ``data_loc`` (optional, (N, q)) skips the hybrid metadata phase with
    precomputed data-location ranks (the client's two-phase read).
    Mode-1/4 misses are searched on every node (stranded-data broadcast).
    """
    policy = as_policy(layout)
    N = policy.n_nodes
    client = _client_ranks(state.data.shape[0], path_hash.device)
    mode = _mode_array(policy, mode, path_hash)
    path_hash, chunk_id = path_hash.to(I32), chunk_id.to(I32)
    present = policy.modes_present()
    keys = torch.stack([path_hash, chunk_id], dim=-1)

    if LayoutMode.HYBRID in present and data_loc is None:
        # phase 1 (hybrid requests only): metadata lookup for the data
        # location; other modes ride along as invalid slots
        _, found_m, _, loc = meta_op(
            state, policy, torch.full_like(path_hash, OP_STAT), path_hash,
            torch.zeros_like(path_hash), torch.full_like(path_hash, -1),
            valid & (mode == LayoutMode.HYBRID), mode, config)
        data_loc = torch.where(found_m & (loc >= 0), loc,
                               torch.broadcast_to(client, path_hash.shape))
    dest = route_data(mode, N, path_hash, chunk_id, client,
                      data_loc=data_loc)
    payload, found = routed_lookup(state, policy, dest, keys, valid, config)
    if present & LOCAL_WRITE_MODES:
        # stranded-data fallback: search every node for Mode-1/4 misses
        miss = valid & ~found & ((mode == LayoutMode.NODE_LOCAL) |
                                 (mode == LayoutMode.HYBRID))
        bpay, bfound = _broadcast_lookup(state, keys, miss, N)
        payload = torch.where(bfound[..., None], bpay, payload)
        found = found | bfound
    return payload, found


def routed_lookup(state: BBState, layout, dest: torch.Tensor,
                  keys: torch.Tensor, valid: torch.Tensor,
                  config: ExchangeConfig = DENSE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One planned chunk lookup at explicit destinations → (payload,
    found): route the keys, look the chunks up, route (payload, found)
    back."""
    policy = as_policy(layout)
    fields = torch.cat([keys, _ones_col(keys)], dim=-1)

    def apply(st, recv, rvalid):
        pay, fnd = _lookup_chunks(st, recv[..., :2], rvalid)
        return None, torch.cat([pay, fnd[..., None].to(I32)], dim=-1)

    _, out, _, _ = run_exchange("data", policy, config, dest, valid, fields,
                                apply, state=state)
    return out[..., :-1], (out[..., -1] > 0) & valid


def _broadcast_lookup(state: BBState, keys: torch.Tensor,
                      valid: torch.Tensor, N: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query every node for every (valid) request: the reply comes from the
    lowest-ranked node holding the chunk, its newest version.

    Equal to the JAX package's exchange of every node's full payload reply:
    which node answers is decided from the key tables alone, and only the
    answering rows are gathered.
    """
    L, q = valid.shape
    all_keys = keys.reshape(1, L * q, 2).expand(N, L * q, 2)
    all_valid = valid.reshape(1, L * q).expand(N, L * q)
    idx, fnd = _lookup_slots(state, all_keys, all_valid)      # (N, L·q)
    found_any = fnd.any(dim=0)
    first = torch.argmax(fnd.to(I32), dim=0)                  # (L·q,)
    slot = idx[first, torch.arange(L * q, device=valid.device)]
    payload = state.data[first, slot].reshape(L, q, state.data.shape[2])
    found_any = found_any.reshape(L, q)
    return payload.masked_fill_(~found_any[..., None], 0), found_any & valid


@obs.trace_span("engine.meta_op")
def meta_op(state: BBState, layout, op: torch.Tensor,
            path_hash: torch.Tensor, size: torch.Tensor, loc: torch.Tensor,
            valid: torch.Tensor, mode: Optional[torch.Tensor] = None,
            config: ExchangeConfig = DENSE):
    """Batched metadata operations routed to their per-request-mode owners.

    Returns (state, found (N, q), size (N, q), loc (N, q)); the tables are
    updated in place.  Under ``lossless=False`` ops beyond the per-owner
    budget are dropped: found=False replies, counted in ``dropped``.
    """
    policy = as_policy(layout)
    N = policy.n_nodes
    client = _client_ranks(state.data.shape[0], path_hash.device)
    mode = _mode_array(policy, mode, path_hash)
    path_hash = path_hash.to(I32)
    owner = route_meta(mode, N, policy.n_md_servers, path_hash, client)
    fields = torch.stack([op.to(I32), path_hash, size.to(I32), loc.to(I32),
                          torch.ones_like(path_hash)], dim=-1)   # (N, q, 5)

    def apply(st, recv, rvalid):
        st2, fnd, r_size, r_loc = _meta_apply(
            st, recv[..., 0], recv[..., 1], recv[..., 2], recv[..., 3],
            rvalid)
        return st2, torch.stack([fnd.to(I32), r_size, r_loc], dim=-1)

    # fill=-1 matches the dense plane's not-found value for size/loc and
    # still reads as found=False in the first column
    state, out, _, overflow = run_exchange(
        "meta", policy, config, owner, valid, fields, apply, state=state,
        reply_fill=-1)
    if config.kind == "compacted" and not config.lossless:
        state.dropped += overflow
    return state, (out[..., 0] > 0) & valid, out[..., 1], out[..., 2]


# ---------------------------------------------------------------------------
# live relayout (online adaptation)
#
# The adaptation subsystem (repro_torch.core.adapt) re-decides a scope's
# layout mode at run time and then MOVES the scope's stored chunks from
# their old-mode placement to the new one — losslessly, in bounded
# installments, while reads keep being served.  ``migrate_rows`` is that
# entry point: one installment of (path, chunk) worklist rows is fetched
# under the old epoch (full read machinery, including the hybrid meta
# phase and the Mode-1/4 stranded-data broadcast), probed at the new
# placement (placement-only: deliberately NO fallback), copied through the
# regular exchange plane, and the old copies are tombstoned everywhere
# except the new owner.  At every intermediate watermark the dual-epoch
# read (try the new placement, fall back to the old — see ``BBClient``)
# observes exactly the pre-migration data.
# ---------------------------------------------------------------------------
def _clear_chunks(state: BBState, keys: torch.Tensor,
                  valid: torch.Tensor) -> BBState:
    """Clear every stored version of the given keys, then re-compact.

    keys: (N, m, 2); valid: (N, m).  All table slots whose (path_hash,
    chunk_id) matches a valid request are blanked (key → EMPTY, payload
    → 0).  ``_append_chunks`` allocates at the ``data_count`` cursor, so
    the surviving rows are compacted to the front by a *stable* empty-last
    argsort (relative order kept, so the newest-wins lookup still resolves
    duplicates) and the cursor becomes the live-row count.

    The re-compaction is one ``gather_rows_batched`` of the data table and
    one of the key table (``pack_chunks`` on the card) into new tables,
    which replace the state's: a slot past the live rows gathers index -1,
    the kernel's zero row, which is the reference's payload blank; the
    keys' blank is EMPTY, so they are masked after the gather.
    """
    tbl = state.data_keys                                     # (N, cap, 2)
    N, cap, _ = tbl.shape
    hit = (tbl[:, None, :, 0] == keys[:, :, None, 0]) & \
          (tbl[:, None, :, 1] == keys[:, :, None, 1]) & \
          (tbl[:, None, :, 0] != EMPTY) & valid[:, :, None]   # (N, m, cap)
    keep = (tbl[..., 0] != EMPTY) & ~hit.any(dim=1)           # (N, cap)
    ar = torch.arange(cap, device=tbl.device)[None, :]
    order = torch.argsort(torch.where(keep, ar, cap), dim=1, stable=True)
    kept = torch.gather(keep, 1, order)
    idx = torch.where(kept, order, -1).to(I32)
    new_keys = gather_rows_batched(tbl, idx)
    state.data = gather_rows_batched(state.data, idx)
    state.data_keys = torch.where(kept[..., None], new_keys, EMPTY).to(I32)
    state.data_count = keep.sum(dim=1, dtype=I32)
    return state


def _tombstone_broadcast(state: BBState, keys: torch.Tensor,
                         valid: torch.Tensor, keep_rank: torch.Tensor
                         ) -> BBState:
    """Clear old copies of migrated chunks on every node but the new owner.

    keys: (L, q, 2); valid/keep_rank: (L, q) — ``keep_rank`` is the rank
    that now holds the chunk (its copy survives).  Every node receives
    every row (the reference's broadcast exchange, which on the stacked
    backend is each row's requests repeated for every receiver), because
    Mode-1/4 sources scatter copies by *writer* rank, which the migrator
    cannot reconstruct.
    """
    L, q = valid.shape
    kb = keys.reshape(1, L * q, 2).expand(L, L * q, 2)
    vb = valid.reshape(1, L * q).expand(L, L * q)
    pb = keep_rank.reshape(1, L * q).expand(L, L * q)
    me = _client_ranks(L, valid.device)                       # (L, 1)
    return _clear_chunks(state, kb, vb & (pb != me))


@obs.trace_span("engine.migrate_rows")
def migrate_rows(state: BBState, layout, path_hash: torch.Tensor,
                 chunk_id: torch.Tensor, valid: torch.Tensor,
                 old_mode: torch.Tensor, new_mode: torch.Tensor,
                 config: ExchangeConfig = COMPACTED
                 ) -> Tuple[BBState, torch.Tensor, torch.Tensor]:
    """Move one installment of chunks from old-mode to new-mode placement.

    path_hash/chunk_id/valid: (N, q) worklist rows; ``old_mode``/
    ``new_mode``: (N, q) per-request ``LayoutMode`` arrays, both members
    of the policy's ``modes_present()`` (the transition policy a
    ``LiveMigrator`` installs guarantees this).

    Returns (state, moved (N, q), found_old (N, q)); the tables are updated
    in place.  The reference's five steps, in its order — lossless at
    every step:

    1. fetch under the old epoch (``forward_read`` with the old modes);
       the payload is a new tensor, which steps 3 and 5 leave intact;
    2. placement-only probe at the new destination (``routed_lookup``, NO
       fallback), after a snapshot of the new epoch's metadata;
    3. copy rows found old but absent new through ``forward_write`` under
       the new modes, data only (``update_meta=False``);
    4. move the metadata: the old entry's exact stat size to the new
       owner (an entry in neither epoch is never resurrected), then
       REMOVE the old entry where the owner moved;
    5. tombstone old data copies everywhere but the new owner and
       re-compact the node tables (``_clear_chunks``).

    ``config`` must use uniform budgets: this entry point routes one
    worklist under two mode arrays, and a ragged spec is sized for one.
    """
    policy = as_policy(layout)
    if config.kind == "compacted" and (config.data_spec is not None or
                                       config.meta_spec is not None):
        raise ValueError(
            "migrate_rows routes one worklist under two mode arrays; a "
            "ragged spec sized for one of them would drop requests of the "
            "other — use uniform budgets (lossless carry covers overflow)")
    N = policy.n_nodes
    client = _client_ranks(state.data.shape[0], path_hash.device)
    old_mode, new_mode = old_mode.to(I32), new_mode.to(I32)
    path_hash, chunk_id = path_hash.to(I32), chunk_id.to(I32)
    keys = torch.stack([path_hash, chunk_id], dim=-1)
    shape = path_hash.shape

    def full(v):
        return torch.full(shape, v, dtype=I32, device=path_hash.device)

    # 1. old-epoch fetch
    payload, found_old = forward_read(state, policy, path_hash, chunk_id,
                                      valid, mode=old_mode, config=config)

    # 2. the new epoch's metadata (read-only: loc resolves hybrid probe
    # destinations; size carries an already-propagated stat size), then
    # the placement-only probe where step 3's copy would land — or, for a
    # HYBRID target, where the new epoch's metadata says a newer copy is
    write_dest = route_data(new_mode, N, path_hash, chunk_id, client)
    _, fm_new, sz_new, loc_new = meta_op(
        state, policy, full(OP_STAT), path_hash, full(0), full(-1), valid,
        mode=new_mode, config=config)
    probe_dest = write_dest
    if LayoutMode.HYBRID in policy.modes_present():
        probe_dest = torch.where(
            (new_mode == LayoutMode.HYBRID) & fm_new & (loc_new >= 0),
            loc_new, write_dest)
    _, found_new = routed_lookup(state, policy, probe_dest, keys, valid,
                                 config)

    # 3. copy the missing rows to their new placement — data only
    moved = valid & found_old & ~found_new
    state = forward_write(state, policy, path_hash, chunk_id, payload,
                          moved, mode=new_mode, config=config,
                          update_meta=False)

    # 4. metadata epoch move: the old owner's exact stat size at the new
    # owner (UPDATE upserts, restricted to rows whose metadata exists in
    # some epoch), then the old entry gone where the owner moved
    owner_old = route_meta(old_mode, N, policy.n_md_servers, path_hash,
                           client)
    owner_new = route_meta(new_mode, N, policy.n_md_servers, path_hash,
                           client)
    _, found_m, sz_old, _ = meta_op(
        state, policy, full(OP_STAT), path_hash, full(0), full(-1), valid,
        mode=old_mode, config=config)
    size_fix = torch.where(found_m, sz_old, sz_new)
    loc_fix = torch.where(moved & (new_mode == LayoutMode.HYBRID),
                          torch.broadcast_to(client, shape), -1).to(I32)
    state, _, _, _ = meta_op(
        state, policy, full(OP_UPDATE), path_hash, size_fix, loc_fix,
        valid & (found_m | fm_new), mode=new_mode, config=config)
    state, _, _, _ = meta_op(
        state, policy, full(OP_REMOVE), path_hash, full(0), full(-1),
        valid & (owner_old != owner_new), mode=old_mode, config=config)

    # 5. tombstone the old copies — keep the rank holding the surviving
    # new-epoch copy (the write destination for rows copied now, the probe
    # destination for rows already in place)
    keep = torch.where(moved, write_dest, probe_dest)
    state = _tombstone_broadcast(state, keys, valid & found_old, keep)
    return state, moved, found_old
