"""Exchange planner (twin of ``repro.core.exchange_plan``).

The same plan → execute pipeline as the JAX package.  Every table has a
leading node axis of the local rows; the cross-node exchange is a
permutation of rows between the (source, destination) axes, carried by
two collective hooks: ``exchange`` (the src/dst transpose:
:func:`stacked_exchange` on one device, ``mesh_engine.mesh_exchange`` over
``torch.distributed``) and ``shift`` (a k-step rotation of the node axis:
:func:`stacked_shift`, or the mesh's ring of sends and receives).  The same
executor code therefore runs on the stacked backend and on the mesh.

* :func:`build_executor` maps (role, policy, batch, :class:`ExchangeConfig`)
  to one executor;
* the executors share one interface (``plan`` / ``send`` / ``collect`` /
  ``served``):

  ==================  ====================================================
  ``DenseExecutor``   bucketize broadcast, O(N²·q) — the parity oracle
  ``UniformExecutor`` per-destination budget B, (L, N, B) buffers, with
                      the lossless carry round; at a measured global-max
                      ``bmax`` it is the mesh's "padded" plan
  ``RaggedExecutor``  packed (L, Σbᵢ) histogram-sized segments
                      (:class:`RaggedSpec`, stacked backend only)
  ``PermuteExecutor`` N−1 shift rounds of measured widths
                      (:class:`MeshRaggedSpec` "ppermute"); round 0 is
                      the node's own traffic and crosses nothing
  ==================  ====================================================

* :func:`run_exchange` runs plan → send → receiver apply → reply collect,
  plus the one copy of the carry round.  The JAX package gates the carry
  with ``lax.cond``; here the predicate is read from the device eagerly,
  through the ``global_sum`` hook so that every rank of a mesh takes the
  same branch (ranks that disagree would wait on each other's collectives
  for ever).
* :func:`fused_write_plan` / :func:`fused_send` ship a write's data and
  metadata planes as one round with no reply leg.

Every send-order gather goes through ``gather_rows_batched`` (the
``pack_chunks`` kernel on the card).  Every round's routing plan is one
``route_plan`` call, the ppermute plan's too (it routes each request on
its shift round instead of its destination), and every measured stacked
spec one ``dest_budgets`` call (kernels of ``csrc/dest_histogram2d.cu`` on
the card).  A mesh spec (``plan_mesh_ragged_spec``) needs every row's
counts and is one counts-only ``dest_histogram2d`` call.  The ragged
receive views are row permutations of the packed send buffer with zero
pads, which is again the ``pack_chunks`` gather.  A spec's static tables
(budgets and offsets, receive rows, reply index) are copied to the card
once per spec (``spec_tables``), so a stacked round makes no
host-to-device copy.

With a flight recorder active (``obs.activate``), every stage of
``run_exchange`` records a ``cat="trace"`` span, as the reference's does:
``exchange.plan`` → ``exchange.pack`` (wrapping an ``exchange.all_to_all``
or ``exchange.ppermute`` span at each call of a collective hook) →
``exchange.apply`` → ``exchange.collect`` → ``exchange.carry`` (holding
``exchange.carry.plan`` when the carry round runs).
``exchange_footprint`` models the int32 elements one engine call moves.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import obs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy, as_policy
from repro_torch.kernels.chunk_pack.ops import gather_rows, gather_rows_batched
from repro_torch.kernels.chunk_router.ops import (dest_budgets,
                                                  histogram_rows2d,
                                                  route_plan)

#: modes whose writes structurally concentrate a whole batch on one node
LOCAL_WRITE_MODES = frozenset({LayoutMode.NODE_LOCAL, LayoutMode.HYBRID})

I32 = torch.int32


def _extra(t: torch.Tensor, ndim: int) -> tuple:
    """Trailing singleton axes that broadcast a (L, q) mask over ``t``."""
    return (1,) * (t.dim() - ndim)


# ---------------------------------------------------------------------------
# collective hooks (backend-pluggable) and the dense oracle
# ---------------------------------------------------------------------------
def stacked_exchange(x: torch.Tensor) -> torch.Tensor:
    """(N_src, N_dst, ...) → (N_dst, N_src, ...): single-device all_to_all."""
    return x.transpose(0, 1)


def stacked_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """Single-device twin of a k-step ring shift over the node axis: row
    ``j`` of the result holds row ``(j − k) mod N`` of ``x``, so node
    ``i``'s buffer arrives at node ``(i + k) mod N`` (the mesh backend's
    ``build_mesh_shift``)."""
    return torch.roll(x, k, 0)


def bucketize(dest: torch.Tensor, valid: torch.Tensor, n_nodes: int,
              payload: torch.Tensor) -> torch.Tensor:
    """Route per-slot requests into per-destination buckets (no compaction).

    dest, valid: (N, q); payload: (N, q, ...).  Returns the buckets
    (N, n_nodes, q, ...), zero where a slot does not go to that node.
    """
    nodes = torch.arange(n_nodes, device=dest.device)
    hit = (dest[:, None, :] == nodes[None, :, None]) & valid[:, None, :]
    pb = payload[:, None].expand((payload.shape[0], n_nodes)
                                 + tuple(payload.shape[1:]))
    mask = hit.reshape(hit.shape + _extra(payload, 2))
    return torch.where(mask, pb, torch.zeros((), dtype=payload.dtype,
                                             device=payload.device))


def collect_replies(dest: torch.Tensor, reply_buckets: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Inverse of ``bucketize`` on the requester side: (N, n_nodes, q, ...)
    replies in slot positions → (N, q, ...), each slot taking the reply of
    its destination (zero for an out-of-range destination)."""
    nodes = torch.arange(n_nodes, device=dest.device)
    hit = dest[:, None, :] == nodes[None, :, None]
    mask = hit.reshape(hit.shape + _extra(reply_buckets, 3))
    return torch.where(mask, reply_buckets, 0).sum(
        dim=1, dtype=reply_buckets.dtype)


# ---------------------------------------------------------------------------
# static budget specs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RaggedSpec:
    """Static ragged per-destination send budgets (one exchange round).

    ``budgets[d]`` send-buffer columns are reserved for destination ``d``;
    the packed buffer is (L, ``total``) with destination ``d``'s segment at
    columns [``offsets[d]``, ``offsets[d]`` + bᵈ).  Build one with
    ``plan_ragged_spec`` on the destinations of a call.
    """

    budgets: Tuple[int, ...]

    @property
    def n_nodes(self) -> int:
        """Number of destinations (the length of the budget tuple)."""
        return len(self.budgets)

    @property
    def total(self) -> int:
        """Σbᵢ — the packed send-buffer column count."""
        return sum(self.budgets)

    @cached_property
    def bmax(self) -> int:
        """Widest per-destination segment (receive-side padding width)."""
        return max(self.budgets) if self.budgets else 0

    @cached_property
    def offsets(self) -> np.ndarray:
        """(n_nodes,) exclusive prefix sum of ``budgets``."""
        return np.concatenate(
            [[0], np.cumsum(self.budgets[:-1])]).astype(np.int32) \
            if self.budgets else np.zeros(0, np.int32)

    @cached_property
    def dcol(self) -> np.ndarray:
        """(total,) destination owning each packed column."""
        return np.repeat(np.arange(self.n_nodes, dtype=np.int32),
                         self.budgets)

    @cached_property
    def jcol(self) -> np.ndarray:
        """(total,) rank of each packed column within its segment."""
        return np.concatenate(
            [np.arange(b, dtype=np.int32) for b in self.budgets]
        ).astype(np.int32) if self.total else np.zeros(0, np.int32)

    @cached_property
    def recv_cols(self) -> np.ndarray:
        """(n_nodes·bmax,) packed column feeding each padded receive slot.

        Receive slot (d, j) reads packed column ``offsets[d] + j`` when
        ``j < budgets[d]``, else the sentinel ``-1`` (zero row).
        """
        col = np.full((self.n_nodes, max(self.bmax, 0)), -1, np.int32)
        for d, b in enumerate(self.budgets):
            col[d, :b] = self.offsets[d] + np.arange(b)
        return col.reshape(-1)


@dataclass(frozen=True)
class MeshRaggedSpec:
    """Measured mesh-ragged exchange plan: measured budgets, uniform splits.

    The mesh's ``all_to_all`` needs equal splits, so packed Σbᵢ segments
    cannot cross it.  Two measured plans can:

    * ``executor="padded"``: every destination segment padded to ``bmax``,
      the global maximum of the per-(source, destination) counts, through
      the ordinary ``all_to_all`` at (L, N, bmax);
    * ``executor="ppermute"``: N−1 shift rounds, round k carrying only
      ``round_widths[k]`` columns, the most any node sends to its rank+k
      neighbour; round 0 (a node's own traffic) crosses nothing.

    ``plan_mesh_ragged_spec`` measures both and picks the executor from the
    fabric model (``exchange_select.pick_mesh_executor``).
    """

    budgets: Tuple[int, ...]       # per-destination global-max budgets
    round_widths: Tuple[int, ...]  # per-shift-k widths; [0] is local
    executor: str = "padded"       # "padded" | "ppermute"

    def __post_init__(self):
        if self.executor not in ("padded", "ppermute"):
            raise ValueError(f"unknown mesh ragged executor "
                             f"{self.executor!r}; pass 'padded' or "
                             "'ppermute'")
        if len(self.round_widths) != len(self.budgets):
            raise ValueError("round_widths and budgets must both have one "
                             "entry per node")

    @property
    def n_nodes(self) -> int:
        """Number of nodes (= destinations = shift rounds)."""
        return len(self.budgets)

    @cached_property
    def bmax(self) -> int:
        """Global max per-destination budget — the padded plan's width."""
        return max(self.budgets) if self.budgets else 0

    @property
    def total(self) -> int:
        """Σ round widths — the ppermute plan's packed column count."""
        return sum(self.round_widths)

    @cached_property
    def offsets(self) -> np.ndarray:
        """(n_nodes + 1,) exclusive prefix sum of ``round_widths``."""
        return np.concatenate(
            [[0], np.cumsum(self.round_widths)]).astype(np.int32)

    @cached_property
    def col_round(self) -> np.ndarray:
        """(total,) shift round owning each packed column."""
        return np.repeat(np.arange(self.n_nodes, dtype=np.int32),
                         self.round_widths)

    @cached_property
    def col_pos(self) -> np.ndarray:
        """(total,) rank of each packed column within its round."""
        return np.concatenate(
            [np.arange(w, dtype=np.int32) for w in self.round_widths]
        ).astype(np.int32) if self.total else np.zeros(0, np.int32)

    @property
    def exchanged_cols(self) -> int:
        """Columns that cross the fabric (round 0 stays local)."""
        return sum(self.round_widths[1:])


def _quantize(budgets: np.ndarray, q: int, align: int,
              floor: Optional[np.ndarray]) -> np.ndarray:
    """Round measured budgets up to ``align`` lanes, clamp to q, apply the
    presizing floor (see ``plan_ragged_spec``)."""
    out = np.where(budgets > 0, np.minimum(q, -(-budgets // align) * align),
                   0)
    if floor is not None:
        out = np.minimum(q, np.maximum(out, np.asarray(floor, np.int64)))
    return out


def _routing_inputs(dest: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, q) destinations and validity as the routing kernels take them:
    contiguous int32 and bool (no copy where they already are)."""
    return dest.to(I32).contiguous(), valid.to(torch.bool).contiguous()


def plan_ragged_spec(dest: torch.Tensor, valid: torch.Tensor, n_nodes: int,
                     align: int = 8,
                     floor: Optional[np.ndarray] = None) -> RaggedSpec:
    """Measure per-destination traffic and build a lossless ``RaggedSpec``.

    Budget ``d`` is the per-row count maximum over all source rows (one
    ``dest_budgets`` call), rounded up to a multiple of ``align`` (clamped
    to the row length q; zero-traffic destinations stay 0).  ``floor``
    raises budgets to a running minimum so a steady workload converges to
    one spec.  Reads the budgets back to the host.
    """
    dest, valid = _routing_inputs(dest, valid)
    q = dest.shape[1]
    budgets = dest_budgets(dest, valid, n_nodes).cpu().numpy().astype(
        np.int64)
    budgets = _quantize(budgets, q, align, floor)
    return RaggedSpec(tuple(int(b) for b in budgets))


def plan_mesh_ragged_spec(dest: torch.Tensor, valid: torch.Tensor,
                          n_nodes: int, align: int = 8, row_bytes: int = 64,
                          allow_ppermute: bool = True,
                          node_ids: Optional[np.ndarray] = None,
                          floor: Optional[np.ndarray] = None
                          ) -> MeshRaggedSpec:
    """Measure one call's traffic and build its mesh-ragged plan.

    dest/valid: the global (N, q) request arrays, which every rank of the
    mesh client holds, so the host-side maxima below are the fleet-wide
    ones on every rank.  One counts-only ``dest_histogram2d`` call gives
    the per-(row, destination) counts, read back to the host; from them

    * per-destination **budgets** (the padded plan's ``bmax``), and
    * per-shift **round widths** ``w_k = max_i hist[i, (i + k) mod N]``
      (in round k node i talks only to node i+k),

    both quantized like ``plan_ragged_spec`` (``floor`` raises the budgets
    and the matching diagonals).  ``row_bytes`` converts columns to bytes
    for ``exchange_select.pick_mesh_executor``; ``allow_ppermute=False``
    forces the padded plan (the client's when nodes are not 1:1 with
    ranks).  ``node_ids`` maps row → global rank (identity when None).
    """
    from repro_torch.core import exchange_select
    dest, valid = _routing_inputs(dest, valid)
    q = dest.shape[1]
    d = torch.where(valid, dest, n_nodes).to(I32)
    hist = histogram_rows2d(d, n_bins=n_nodes + 1)[:, :n_nodes]
    hist = hist.cpu().numpy().astype(np.int64)
    if hist.shape[0] == 0:
        hist = np.zeros((1, n_nodes), np.int64)
    budgets = _quantize(hist.max(axis=0), q, align, floor)
    ranks = (np.arange(hist.shape[0]) if node_ids is None
             else np.asarray(node_ids)).astype(np.int64)
    # w_k: the widest (source → source+k) run over all sources
    widths = np.zeros(n_nodes, np.int64)
    for i, r in enumerate(ranks):
        k = (np.arange(n_nodes) - r) % n_nodes        # dest d ↦ round k
        np.maximum.at(widths, k, hist[i])
    widths = _quantize(widths, q, align,
                       None if floor is None else _ragged_floor_diag(
                           np.asarray(floor), ranks, n_nodes))
    executor = "padded"
    if allow_ppermute:
        executor = exchange_select.pick_mesh_executor(
            n_nodes, int(budgets.max(initial=0)) * n_nodes * row_bytes,
            [int(w) * row_bytes for w in widths[1:] if w > 0])
    return MeshRaggedSpec(tuple(int(b) for b in budgets),
                          tuple(int(w) for w in widths), executor)


def _ragged_floor_diag(floor: np.ndarray, ranks: np.ndarray,
                       n_nodes: int) -> np.ndarray:
    """Per-destination floor folded onto the shift-round diagonals."""
    out = np.zeros(n_nodes, np.int64)
    for r in ranks:
        k = (np.arange(n_nodes) - r) % n_nodes
        np.maximum.at(out, k, floor)
    return out


# ---------------------------------------------------------------------------
# exchange configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExchangeConfig:
    """Data-plane exchange selection (hashable).

    kind: "dense" (bucketize broadcast, the parity oracle) or "compacted".
    ``budget``/``meta_budget`` fix the uniform per-destination slot counts
    (``None`` auto-sizes, see ``data_budget``/``meta_budget``).
    ``lossless`` carries uniform-budget overflow into a second round sized
    ``q − B`` (``False``: drop and account it).  ``data_spec``/``meta_spec``
    switch a plane to a measured :class:`RaggedSpec` (stacked backend) or
    :class:`MeshRaggedSpec` (either backend).  ``pipeline`` lets a lossless
    write fuse its data and metadata rounds and pipelines the ppermute
    plan's rounds.  ``carry_budget_hint`` caps the carry round at a
    measured residual.
    """

    kind: str = "dense"
    budget: Optional[int] = None
    meta_budget: Optional[int] = None
    capacity: float = 2.0
    lossless: bool = True
    data_spec: Optional[Union[RaggedSpec, MeshRaggedSpec]] = None
    meta_spec: Optional[Union[RaggedSpec, MeshRaggedSpec]] = None
    pipeline: bool = True
    carry_budget_hint: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("dense", "compacted"):
            raise ValueError(f"unknown exchange kind {self.kind!r}; "
                             "pass 'dense' or 'compacted'")


DENSE = ExchangeConfig("dense")
COMPACTED = ExchangeConfig("compacted")


def _auto_budget(q: int, bins: int, capacity: float) -> int:
    b = int(math.ceil(capacity * q / max(1, bins)))
    return min(q, max(8, -(-b // 8) * 8))


def data_budget(policy: LayoutPolicy, q: int, config: ExchangeConfig) -> int:
    """Per-destination slot budget for the data exchange."""
    if config.budget is not None:
        return max(1, min(q, config.budget))
    if policy.modes_present() & LOCAL_WRITE_MODES:
        # local writes / hybrid data_loc reads can send a whole batch to one
        # node: the concentration is structural, so stay exact
        return q
    return _auto_budget(q, policy.n_nodes, config.capacity)


def meta_budget(policy: LayoutPolicy, q: int, config: ExchangeConfig) -> int:
    """Per-destination slot budget for the metadata exchange.

    Auto-sizing is lossless (``B = q``): the chunks of one file all route
    to one metadata owner however many nodes there are.
    """
    if config.meta_budget is not None:
        return max(1, min(q, config.meta_budget))
    if config.budget is not None:
        return max(1, min(q, config.budget))
    return q


def _carry_budget(q: int, b: int) -> int:
    """Budget of the lossless carry round after a round at ``b``: at most
    ``q − b`` requests of one (source, destination) pair are left over."""
    return max(0, q - b)


# ---------------------------------------------------------------------------
# the per-call plan
# ---------------------------------------------------------------------------
@dataclass
class ExchangePlan:
    """One call's routing, produced by ``Executor.plan``.

    ``send_idx``: request slot feeding each send-buffer column (-1 = pad);
    ``reply_idx``: flat reply column of each request (-1 = unserved);
    ``overflow``: (L,) valid requests beyond this plan's budgets;
    ``recv_perm``/``inv_perm``: the ppermute plan's round-order ↔
    source-major receive permutations.
    """

    dest: torch.Tensor
    valid: torch.Tensor
    send_idx: Optional[torch.Tensor] = None
    reply_idx: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None
    recv_perm: Optional[torch.Tensor] = None
    inv_perm: Optional[torch.Tensor] = None


def _carry_taken(overflow: torch.Tensor, global_sum: Callable) -> bool:
    """Whether the carry round runs, read from the device.  ``global_sum``
    must reduce over every node (``torch.sum`` on the stacked backend, an
    ``all_reduce`` on the mesh) so every rank takes the same branch and
    the collectives inside stay aligned."""
    return bool((global_sum(overflow) > 0).item())


def _compact_plan(dest: torch.Tensor, valid: torch.Tensor, n_nodes: int,
                  budget: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing plan for one uniform-budget round: the ragged plan of budget
    B and offset d·B for every destination d.

    dest/valid: (L, q).  Returns send_idx (L, n_nodes, budget) int32 (-1 for
    empty slots), reply_idx (L, q) int32 into the flat (n_nodes·budget)
    reply buffer (-1 for invalid/overflowed requests) and overflow (L,).
    """
    send_idx, reply_idx, overflow = _compact_plan_ragged(
        dest, valid, n_nodes, _uniform_spec(n_nodes, budget))
    return (send_idx.view(dest.shape[0], n_nodes, budget), reply_idx,
            overflow)


def _compact_gather(x: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """Gather request rows into send order: (L, q, ...) → (L, N, B, ...);
    empty budget slots (send_idx == -1) come back zero."""
    L = x.shape[0]
    out = gather_rows_batched(
        x, send_idx.reshape(L, send_idx.shape[1] * send_idx.shape[2]))
    return out.reshape((L,) + tuple(send_idx.shape[1:]) + tuple(x.shape[2:]))


def compact_collect_flat(reply_idx: torch.Tensor, reply: torch.Tensor,
                         fill: int = 0) -> torch.Tensor:
    """Scatter replies back to request slots: (L, S, ...) → (L, q, ...).

    Unserved requests (reply_idx == -1) get ``fill``.
    """
    L, q = reply_idx.shape
    rest = tuple(reply.shape[2:])
    if reply.shape[1] == 0:
        return torch.full((L, q) + rest, fill, dtype=reply.dtype,
                          device=reply.device)
    rows = torch.arange(L, device=reply.device)[:, None]
    got = reply[rows, reply_idx.clamp(0, reply.shape[1] - 1).long()]
    return got.masked_fill_((reply_idx < 0).reshape((L, q) + (1,) *
                                                     len(rest)), fill)


def compact_collect(reply_idx: torch.Tensor, reply: torch.Tensor,
                    fill: int = 0) -> torch.Tensor:
    """Uniform-budget twin of ``compact_collect_flat``: reply is
    (L, N, B, ...), flattened over the (destination, budget) axes."""
    L = reply.shape[0]
    return compact_collect_flat(
        reply_idx, reply.reshape((L, reply.shape[1] * reply.shape[2])
                                 + tuple(reply.shape[3:])), fill)


def _compact_plan_ragged(dest: torch.Tensor, valid: torch.Tensor,
                         n_nodes: int, spec: RaggedSpec
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing plan for one round of per-destination segment widths: one
    ``route_plan`` call on the spec's table.

    Returns (send_idx (L, Σbᵢ), reply_idx (L, q), overflow (L,)); overflow
    is zero when ``spec`` was measured on the same dest/valid.  Requests of
    one (source, destination) pair keep their slot order (the reference's
    stable sort), so the receiver appends in the dense path's order.
    """
    L, q = dest.shape
    dev = dest.device
    if q == 0:
        return (torch.full((L, spec.total), -1, dtype=I32, device=dev),
                torch.zeros((L, 0), dtype=I32, device=dev),
                torch.zeros(L, dtype=I32, device=dev))
    send_idx, reply_idx, overflow, _ = route_plan(
        *_routing_inputs(dest, valid), spec_tables(spec, dev).table,
        total=spec.total)
    return send_idx, reply_idx, overflow


def _take_rows(packed: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(L, S, F) packed send buffer × (N, M) flat row pointers on its
    device (-1 → zero row) → (N, M, F) receive view, through the pack
    kernel."""
    L, S = packed.shape[:2]
    rest = tuple(packed.shape[2:])
    out = gather_rows(packed.reshape(L * S, math.prod(rest)),
                      rows.reshape(-1))
    return out.reshape(tuple(rows.shape) + rest)


def _ragged_recv_rows(spec: RaggedSpec, n_src: int) -> np.ndarray:
    """(N, n_src·bmax) flat packed row feeding receive slot (d, s·bmax + j):
    ``s·Σb + recv_cols[d·bmax + j]``, or -1 for a pad slot."""
    col = spec.recv_cols.reshape(spec.n_nodes, spec.bmax)
    src = np.arange(n_src, dtype=np.int64)[None, :, None] * spec.total
    rows = np.where(col[:, None, :] >= 0, src + col[:, None, :], -1)
    return rows.reshape(spec.n_nodes, n_src * spec.bmax).astype(np.int32)


def _reply_rows(spec: RaggedSpec) -> np.ndarray:
    """(N·Σb,) row of the flat (N·N·bmax) padded reply view feeding packed
    reply column c of source s: ``dcol[c]·N·bmax + s·bmax + jcol[c]``."""
    n, M = spec.n_nodes, spec.n_nodes * spec.bmax
    src = np.arange(n, dtype=np.int64)[:, None]
    flat = spec.dcol[None, :].astype(np.int64) * M + src * spec.bmax \
        + spec.jcol[None, :]
    return flat.reshape(-1)


@functools.lru_cache(maxsize=64)
def _uniform_spec(n_nodes: int, budget: int) -> RaggedSpec:
    """The uniform round's budgets as a spec: B for every destination."""
    return RaggedSpec((budget,) * n_nodes)


class SpecTables:
    """A spec's static tables on one device, each copied there once, at
    first use (``spec_tables`` keeps one per (spec, device)).

    * ``table``: (2, N) int32 budgets and segment offsets, ``route_plan``'s
      input (for a uniform round, ``_uniform_spec``'s: B and d·B);
    * ``recv_rows``: (N, N·bmax) int32 packed rows of the ragged receive
      view (``_ragged_recv_rows``, N sources);
    * ``reply_rows``: (N·Σb,) int64 rows of the padded reply view that
      ``ragged_reply_exchange`` takes (``_reply_rows``).
    """

    def __init__(self, spec: RaggedSpec, device: torch.device):
        self.spec, self.device = spec, device

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @cached_property
    def table(self) -> torch.Tensor:
        spec = self.spec
        return self._put(np.stack([np.asarray(spec.budgets, np.int32),
                                   spec.offsets]).reshape(2, spec.n_nodes))

    @cached_property
    def recv_rows(self) -> torch.Tensor:
        return self._put(_ragged_recv_rows(self.spec, self.spec.n_nodes))

    @cached_property
    def reply_rows(self) -> torch.Tensor:
        return self._put(_reply_rows(self.spec))


@functools.lru_cache(maxsize=128)
def spec_tables(spec: RaggedSpec, device: torch.device) -> SpecTables:
    """The static tables of ``spec`` on ``device`` (one object per pair)."""
    return SpecTables(spec, device)


def ragged_exchange(x: torch.Tensor, spec: RaggedSpec,
                    n_nodes: int) -> torch.Tensor:
    """Stacked exchange of a packed ragged send buffer.

    x: (L = n_nodes, Σbᵢ, ...) source-major packed segments.  Returns the
    receiver view (n_nodes, n_nodes·bmax, ...): destination ``d`` sees its
    own segment from every source, padded to ``bmax`` with zero rows (the
    pads carry occupancy 0, so they arrive marked invalid).
    """
    if spec.bmax == 0:
        return x.new_zeros((n_nodes, 0) + tuple(x.shape[2:]))
    if x.shape[0] != spec.n_nodes:
        raise ValueError(f"ragged_exchange: {x.shape[0]} source rows, "
                         f"expected one per node ({spec.n_nodes})")
    return _take_rows(x, spec_tables(spec, x.device).recv_rows)


def ragged_reply_exchange(reply: torch.Tensor, spec: RaggedSpec,
                          n_nodes: int) -> torch.Tensor:
    """Inverse of ``ragged_exchange`` for replies: (n_nodes, n_nodes·bmax,
    ...) in padded receive order → (n_nodes, Σbᵢ, ...) packed columns of
    each source, ready for ``compact_collect_flat``."""
    rest = tuple(reply.shape[2:])
    if spec.total == 0:
        return reply.new_zeros((n_nodes, 0) + rest)
    M = n_nodes * spec.bmax
    out = reply.reshape((n_nodes * M,) + rest).index_select(
        0, spec_tables(spec, reply.device).reply_rows)
    return out.reshape((n_nodes, spec.total) + rest)


# ---------------------------------------------------------------------------
# executors: one interface, four transports
# ---------------------------------------------------------------------------
def _split(recv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Receive view → (fields, validity from the trailing occupancy col)."""
    return recv[..., :-1], recv[..., -1] > 0


@dataclass(frozen=True)
class DenseExecutor:
    """The bucketize broadcast — O(N²·q), kept as the parity oracle."""

    n_nodes: int
    carry_budget: int = 0

    def plan(self, dest, valid, client=None) -> ExchangePlan:
        """Dense needs no permutation: the plan is the routing itself."""
        return ExchangePlan(dest, valid)

    def send(self, plan: ExchangePlan, fields: torch.Tensor,
             exchange: Callable = stacked_exchange,
             shift: Callable = stacked_shift):
        """Broadcast-bucketize the fields; the trailing ones-column arrives
        as the receiver validity mask."""
        rf = exchange(bucketize(plan.dest, plan.valid, self.n_nodes,
                                fields))                    # (L, N_src, q, F)
        L = rf.shape[0]
        return _split(rf.reshape(L, rf.shape[1] * rf.shape[2], rf.shape[3]))

    def collect(self, plan: ExchangePlan, reply: torch.Tensor,
                exchange: Callable = stacked_exchange,
                shift: Callable = stacked_shift,
                fill: int = 0) -> torch.Tensor:
        """Reply buckets travel back; each slot takes its destination's."""
        L, M = reply.shape[:2]
        q = M // self.n_nodes
        r = exchange(reply.reshape((L, self.n_nodes, q)
                                   + tuple(reply.shape[2:])))
        return collect_replies(plan.dest, r, self.n_nodes)

    def served(self, plan: ExchangePlan) -> torch.Tensor:
        """Dense serves every valid request in one round."""
        return plan.valid


@dataclass(frozen=True)
class UniformExecutor:
    """Per-destination budget B: (L, N, B) send buffers, the shape the
    mesh's ``all_to_all`` carries.  At a measured global-max ``bmax``
    (``carry_budget`` 0: nothing can overflow) it is the mesh's padded
    ragged plan."""

    n_nodes: int
    budget: int
    carry_budget: int = 0

    def plan(self, dest, valid, client=None) -> ExchangePlan:
        """Destination-stable sort + budget clip (``_compact_plan``)."""
        send_idx, reply_idx, overflow = _compact_plan(
            dest, valid, self.n_nodes, self.budget)
        return ExchangePlan(dest, valid, send_idx, reply_idx, overflow)

    def send(self, plan: ExchangePlan, fields: torch.Tensor,
             exchange: Callable = stacked_exchange,
             shift: Callable = stacked_shift):
        """Gather into (L, N, B) budgeted buffers, one exchange."""
        rf = exchange(_compact_gather(fields, plan.send_idx))
        L = rf.shape[0]
        return _split(rf.reshape(L, rf.shape[1] * rf.shape[2], rf.shape[3]))

    def collect(self, plan: ExchangePlan, reply: torch.Tensor,
                exchange: Callable = stacked_exchange,
                shift: Callable = stacked_shift,
                fill: int = 0) -> torch.Tensor:
        """One reply exchange, scattered through the inverse plan."""
        L, M = reply.shape[:2]
        r = exchange(reply.reshape(
            (L, self.n_nodes, M // self.n_nodes) + tuple(reply.shape[2:])))
        return compact_collect(plan.reply_idx, r, fill)

    def served(self, plan: ExchangePlan) -> torch.Tensor:
        """Requests whose reply slot fit this round's budget."""
        return plan.reply_idx >= 0


@dataclass(frozen=True)
class RaggedExecutor:
    """Packed (L, Σbᵢ) histogram-sized segments (stacked backend only:
    the receive view is a gather over every source's packed rows)."""

    n_nodes: int
    spec: RaggedSpec
    carry_budget: int = 0

    def plan(self, dest, valid, client=None) -> ExchangePlan:
        """Segment-packed routing plan (``_compact_plan_ragged``)."""
        send_idx, reply_idx, overflow = _compact_plan_ragged(
            dest, valid, self.n_nodes, self.spec)
        return ExchangePlan(dest, valid, send_idx, reply_idx, overflow)

    def send(self, plan: ExchangePlan, fields: torch.Tensor,
             exchange: Callable = stacked_exchange,
             shift: Callable = stacked_shift):
        """Only the Σbᵢ packed columns are gathered; pads at the receiver."""
        return _split(ragged_exchange(
            gather_rows_batched(fields, plan.send_idx), self.spec,
            self.n_nodes))

    def collect(self, plan: ExchangePlan, reply: torch.Tensor,
                exchange: Callable = stacked_exchange,
                shift: Callable = stacked_shift,
                fill: int = 0) -> torch.Tensor:
        """Packed reply columns back to their request slots."""
        rr = ragged_reply_exchange(reply, self.spec, self.n_nodes)
        return compact_collect_flat(plan.reply_idx, rr, fill)

    def served(self, plan: ExchangePlan) -> torch.Tensor:
        """Measured segments cover every request (lossless by plan)."""
        return plan.valid


@functools.lru_cache(maxsize=64)
def _round_spec(spec: MeshRaggedSpec) -> RaggedSpec:
    """The ppermute plan's rounds as a ragged spec: round k is the
    "destination" of width ``round_widths[k]`` at offset ``offsets[k]``."""
    return RaggedSpec(spec.round_widths)


@functools.lru_cache(maxsize=64)
def _col_round(spec: MeshRaggedSpec, device: torch.device) -> torch.Tensor:
    """``spec.col_round`` on ``device`` (copied there once per spec)."""
    return torch.as_tensor(spec.col_round, device=device)


@dataclass(frozen=True)
class PermuteExecutor:
    """Segmented ppermute exchange: N−1 shift rounds of measured widths.

    Round k ships only what a node sends to its rank+k neighbour
    (``spec.round_widths[k]``), so a skewed histogram pays for its hot
    (source, destination) pair once instead of padding every pair; round
    0, a node's own traffic, never crosses the fabric.  Received columns
    are put back in source-major order (``recv_perm``, a ``pack_chunks``
    gather) before the table apply, so the receiver appends in the dense
    path's order.

    ``pipeline=True`` gathers each round's send buffer on its own, one
    round ahead of the shift that ships the round before it (a prologue
    load, an epilogue store), as the reference does; ``pipeline=False``
    gathers every round in one call before the first shift.  Identical
    values either way.
    """

    n_nodes: int
    spec: MeshRaggedSpec
    carry_budget: int = 0
    pipeline: bool = True

    def plan(self, dest, valid, client=None) -> ExchangePlan:
        """Routing plan over the shift rounds.

        ``client``: (L, 1) int32 global ranks of the local rows.  A
        request of row rank r to destination d rides round (d − r) mod N,
        so the round-major plan is one ragged ``route_plan`` with the
        rounds in place of the destinations.  Required: on the mesh the
        row index is not the rank.
        """
        if client is None:
            raise ValueError(
                "PermuteExecutor.plan needs the local rows' global ranks "
                "(client); engine entry points thread them — pass "
                "client= when calling run_exchange with a ppermute spec "
                "directly")
        N, spec = self.n_nodes, self.spec
        rounds = torch.remainder(dest.to(I32) - client, N).to(I32)
        send_idx, reply_idx, overflow = _compact_plan_ragged(
            rounds, valid, N, _round_spec(spec))
        # the column of round k came from rank − k: a stable sort of the
        # columns by source restores the dense arrival order
        src_rank = torch.remainder(
            client - _col_round(spec, dest.device)[None, :], N)
        recv_perm = torch.argsort(src_rank, dim=1, stable=True).to(I32)
        inv_perm = torch.argsort(recv_perm, dim=1).to(I32)
        return ExchangePlan(dest, valid, send_idx, reply_idx, overflow,
                            recv_perm, inv_perm)

    def _segments(self):
        off = self.spec.offsets
        return [(k, int(off[k]), int(w))
                for k, w in enumerate(self.spec.round_widths) if w > 0]

    def _ship_rounds(self, segments, load_fn, store_fn):
        """The round loop shared by send and collect: ``load_fn(k, off,
        w)`` packs round k's buffer, ``store_fn(k, buf)`` ships it.
        Pipelined, load k+1 is issued before store k (one round of
        lookahead); otherwise every load comes before the first store."""
        if not self.pipeline:
            loads = [load_fn(k, off, w) for k, off, w in segments]
            return [store_fn(k, buf)
                    for (k, _, _), buf in zip(segments, loads)]
        parts = []
        load_tag = None                                  # prologue: empty
        for i, (k, off, w) in enumerate(segments):
            with obs.span("exchange.pipeline.load", cat="trace", round=k):
                next_load = load_fn(k, off, w)
            if load_tag is not None:
                prev_k = segments[i - 1][0]
                with obs.span("exchange.pipeline.store", cat="trace",
                              round=prev_k):
                    parts.append(store_fn(prev_k, load_tag))
            load_tag = next_load
        if load_tag is not None:                         # epilogue
            last_k = segments[-1][0]
            with obs.span("exchange.pipeline.store", cat="trace",
                          round=last_k):
                parts.append(store_fn(last_k, load_tag))
        return parts

    def send(self, plan: ExchangePlan, fields: torch.Tensor,
             exchange: Callable = stacked_exchange,
             shift: Callable = stacked_shift):
        """Pack and shift each nonzero round, restore source order."""
        if self.pipeline:
            def load(k, off, w):
                return gather_rows_batched(fields,
                                           plan.send_idx[:, off:off + w])
        else:
            gathered = gather_rows_batched(fields, plan.send_idx)

            def load(k, off, w):
                return gathered[:, off:off + w]

        def store(k, buf):
            return buf if k == 0 else shift(buf, k)

        parts = self._ship_rounds(self._segments(), load, store)
        if not parts:
            L = fields.shape[0]
            return (fields.new_zeros((L, 0, fields.shape[-1] - 1)),
                    torch.zeros((L, 0), dtype=torch.bool,
                                device=fields.device))
        recv = torch.cat(parts, dim=1)                  # round order
        return _split(gather_rows_batched(recv, plan.recv_perm))

    def collect(self, plan: ExchangePlan, reply: torch.Tensor,
                exchange: Callable = stacked_exchange,
                shift: Callable = stacked_shift,
                fill: int = 0) -> torch.Tensor:
        """Shift each round's replies home and scatter to request slots."""
        if self.spec.total == 0:
            L, q = plan.reply_idx.shape
            return torch.full((L, q) + tuple(reply.shape[2:]), fill,
                              dtype=reply.dtype, device=reply.device)
        back = gather_rows_batched(reply, plan.inv_perm)   # round order

        def load(k, off, w):
            return back[:, off:off + w]

        def store(k, buf):
            return buf if k == 0 else shift(buf, -k)

        home = torch.cat(self._ship_rounds(self._segments(), load, store),
                         dim=1)
        return compact_collect_flat(plan.reply_idx, home, fill)

    def served(self, plan: ExchangePlan) -> torch.Tensor:
        """Measured round widths cover every request (lossless by plan)."""
        return plan.valid


Executor = Union[DenseExecutor, UniformExecutor, RaggedExecutor,
                 PermuteExecutor]


def build_executor(role: str, policy, q: int,
                   config: ExchangeConfig) -> Executor:
    """The planner: one routing decision shared by every entry point.

    ``role`` is "data" or "meta" (it selects the budget rule and which spec
    of ``config`` applies).
    """
    policy = as_policy(policy)
    N = policy.n_nodes
    if config.kind != "compacted":
        return DenseExecutor(N)
    spec = config.data_spec if role == "data" else config.meta_spec
    if isinstance(spec, MeshRaggedSpec):
        if spec.executor == "ppermute":
            return PermuteExecutor(N, spec, pipeline=config.pipeline)
        # padded: uniform at the measured global max, lossless by
        # construction, so no carry round
        return UniformExecutor(N, max(1, spec.bmax))
    if spec is not None:
        return RaggedExecutor(N, spec)
    B = (data_budget(policy, q, config) if role == "data"
         else meta_budget(policy, q, config))
    carry = _carry_budget(q, B) if (config.lossless and B < q) else 0
    if carry and config.carry_budget_hint is not None:
        carry = min(carry, max(0, int(config.carry_budget_hint)))
    return UniformExecutor(N, B, carry_budget=carry)


# ---------------------------------------------------------------------------
# fused write: data + metadata planes in one round
# ---------------------------------------------------------------------------
def fuse_specs(data_spec, meta_spec) -> Optional[RaggedSpec]:
    """Summed ragged spec of the fused write buffer (None = not fusable):
    each destination segment is the data segment followed by the metadata
    segment.  Only two stacked ``RaggedSpec``s fuse this way."""
    if not (isinstance(data_spec, RaggedSpec) and
            isinstance(meta_spec, RaggedSpec)) or \
            data_spec.n_nodes != meta_spec.n_nodes:
        return None
    return RaggedSpec(tuple(bd + bm for bd, bm in
                            zip(data_spec.budgets, meta_spec.budgets)))


def _fused_pack_cols(spec_d: RaggedSpec, spec_m: RaggedSpec) -> np.ndarray:
    """(Σbᵈ+Σbᵐ,) column of ``concat([data_packed, meta_packed])`` feeding
    each fused packed column (destination-major, data plane first)."""
    cols = []
    for d in range(spec_d.n_nodes):
        od, om = int(spec_d.offsets[d]), int(spec_m.offsets[d])
        cols.append(np.arange(od, od + spec_d.budgets[d]))
        cols.append(spec_d.total + np.arange(om, om + spec_m.budgets[d]))
    return (np.concatenate(cols).astype(np.int32) if cols
            else np.zeros(0, np.int32))


def _fused_recv_cols(spec_d: RaggedSpec, spec_m: RaggedSpec,
                     fused: RaggedSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Per-plane receive maps into the fused ``ragged_exchange`` view.

    Returns (data (N, N·bmaxᵈ), meta (N, N·bmaxᵐ)) int32 maps: entry
    ``[i, s·bmaxᵖ + j]`` is the fused receive column holding receiver
    ``i``'s j-th row from source ``s`` on plane p, or -1 for a pad slot.
    """
    n = spec_d.n_nodes
    bf = max(fused.bmax, 0)

    def plane(spec: RaggedSpec, base) -> np.ndarray:
        bp = max(spec.bmax, 0)
        idx = np.full((n, n * bp), -1, np.int32)
        for i in range(n):
            b = spec.budgets[i]
            for s in range(n):
                idx[i, s * bp:s * bp + b] = s * bf + base[i] + np.arange(b)
        return idx

    return plane(spec_d, [0] * n), plane(spec_m, list(spec_d.budgets))


@functools.lru_cache(maxsize=64)
def _fused_plane_rows(spec_d: RaggedSpec, spec_m: RaggedSpec,
                      device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each plane's receive view as flat rows of that plane's own packed
    buffer, composed through the fused buffer's maps, on ``device`` (copied
    there once per pair of specs).

    Fused receive column ``r`` of receiver ``i`` holds fused packed column
    ``fused.recv_cols[i·bf + r mod bf]`` of source ``r div bf``, which holds
    column ``_fused_pack_cols[...]`` of the planes' concatenation.  On the
    stacked backend the fused buffer itself never needs to exist: the
    composed maps gather each plane's receive view straight from the
    plane's packed rows.
    """
    fused = fuse_specs(spec_d, spec_m)
    n, bf = spec_d.n_nodes, fused.bmax
    cols_d, cols_m = _fused_recv_cols(spec_d, spec_m, fused)
    recv = fused.recv_cols.reshape(n, bf)
    pack = _fused_pack_cols(spec_d, spec_m)
    rows_i = np.arange(n)[:, None]

    def plane(cols: np.ndarray, lo: int, width: int) -> np.ndarray:
        if cols.size == 0:
            return cols
        ok = cols >= 0
        c = np.where(ok, cols, 0)
        p = recv[rows_i, c % bf]
        ok &= p >= 0
        col = pack[np.where(ok, p, 0)] - lo
        return np.where(ok, (c // bf) * width + col, -1).astype(np.int32)

    return (torch.as_tensor(plane(cols_d, 0, spec_d.total), device=device),
            torch.as_tensor(plane(cols_m, spec_d.total, spec_m.total),
                            device=device))


def fused_write_plan(policy, q: int, config: ExchangeConfig
                     ) -> Optional[Tuple[Executor, Executor]]:
    """Per-plane executors for the fused write round (None = not fused).

    Fusion needs a compacted, lossless, pipelined config and plans that
    cannot overflow into a carry round (a fused carry would split the
    metadata batch across two applies, and duplicate keys allocate
    differently in one apply than in two): measured specs of one kind on
    both planes — two stacked ragged specs, or two padded mesh specs (two
    uniform rounds at their ``bmax``) — or uniform budgets already at
    ``B = q``.  A ppermute plane never fuses (its rounds are not one
    collective).
    """
    if config.kind != "compacted" or not config.pipeline \
            or not config.lossless or q == 0:
        return None
    policy = as_policy(policy)
    N = policy.n_nodes
    ds, ms = config.data_spec, config.meta_spec
    if ds is not None or ms is not None:
        if isinstance(ds, MeshRaggedSpec) and isinstance(ms,
                                                         MeshRaggedSpec):
            if ds.n_nodes != ms.n_nodes \
                    or "ppermute" in (ds.executor, ms.executor):
                return None
            return (UniformExecutor(N, max(1, ds.bmax)),
                    UniformExecutor(N, max(1, ms.bmax)))
        if fuse_specs(ds, ms) is not None:
            return RaggedExecutor(N, ds), RaggedExecutor(N, ms)
        return None
    if data_budget(policy, q, config) < q \
            or meta_budget(policy, q, config) < q:
        return None
    return UniformExecutor(N, q), UniformExecutor(N, q)


def fused_send(ex_d: Executor, plan_d: ExchangePlan, fields_d: torch.Tensor,
               ex_m: Executor, plan_m: ExchangePlan, fields_m: torch.Tensor,
               exchange: Callable = stacked_exchange
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Ship two planes' requests as one round → ``(recv_d, rvalid_d, recv_m,
    rvalid_m)``, each plane's receive view exactly as its own
    ``Executor.send`` would have produced it.

    Two ``UniformExecutor``s cross in one ``exchange`` span, one call of
    the hook a plane: the reference pads the metadata rows to the
    payload's width to send one buffer, which at 1 MiB chunks would ship
    every 4-word metadata row as a 1 MiB row.  Two ``RaggedExecutor``s
    interleave per destination segment; the static maps of
    ``_fused_plane_rows`` take each plane's view from its packed rows.
    """
    if isinstance(ex_d, UniformExecutor):
        sd = _compact_gather(fields_d, plan_d.send_idx)
        sm = _compact_gather(fields_m, plan_m.send_idx)
        with obs.span("exchange.all_to_all", cat="trace"):
            rd, rm = exchange(sd), exchange(sm)
        L = rd.shape[0]
        return (*_split(rd.reshape(L, rd.shape[1] * rd.shape[2],
                                   rd.shape[3])),
                *_split(rm.reshape(L, rm.shape[1] * rm.shape[2],
                                   rm.shape[3])))
    rows_d, rows_m = _fused_plane_rows(ex_d.spec, ex_m.spec,
                                       fields_d.device)
    rd = _take_rows(gather_rows_batched(fields_d, plan_d.send_idx), rows_d)
    rm = _take_rows(gather_rows_batched(fields_m, plan_m.send_idx), rows_m)
    return (*_split(rd), *_split(rm))


# ---------------------------------------------------------------------------
# the round runner
# ---------------------------------------------------------------------------
def _spanned_collective(fn: Callable, name: str) -> Callable:
    """Wrap a collective hook so each call records a ``cat="trace"`` span
    (installed by ``run_exchange`` only while a recorder is active)."""
    def wrapped(*args, **kwargs):
        with obs.span(name, cat="trace"):
            return fn(*args, **kwargs)
    return wrapped


def run_exchange(role: str, policy, config: ExchangeConfig,
                 dest: torch.Tensor, valid: torch.Tensor,
                 fields: torch.Tensor, apply_fn: Callable, *, state,
                 exchange: Callable = stacked_exchange,
                 shift: Callable = stacked_shift,
                 global_sum: Callable = torch.sum,
                 client: Optional[torch.Tensor] = None, reply_fill: int = 0):
    """One planned exchange round, plus the shared carry round.

    1. ``build_executor`` picks the transport; the executor plans the
       routing and ships ``fields`` (a (L, q, F) int32 buffer whose
       trailing ones-column becomes the receiver validity mask) through the
       ``exchange``/``shift`` hooks;
    2. ``apply_fn(state, recv, rvalid) -> (new_state | None, reply | None)``
       runs the receiver-side table op;
    3. replies are routed back to request slots;
    4. a lossless uniform under-budget plan carries its residual into a
       second round at ``carry_budget`` when any row of any node
       overflowed (``_carry_taken``: the eager twin of the JAX package's
       ``lax.cond``).  The residual round is planned only when it runs:
       the reference hoists a pipelined config's plan out of the cond to
       overlap a compiled collective, which eager PyTorch cannot use.

    ``client`` carries the local rows' (L, 1) global ranks (the ppermute
    plan needs them).  Returns ``(state, out, served, overflow)``.
    """
    if obs.current_recorder() is not None:
        exchange = _spanned_collective(exchange, "exchange.all_to_all")
        shift = _spanned_collective(shift, "exchange.ppermute")
    with obs.span("exchange.plan", cat="trace", role=role,
                  kind=config.kind):
        ex = build_executor(role, policy, dest.shape[1], config)
        plan = ex.plan(dest, valid, client=client)
    with obs.span("exchange.pack", cat="trace", role=role,
                  executor=type(ex).__name__):
        recv, rvalid = ex.send(plan, fields, exchange, shift)
    with obs.span("exchange.apply", cat="trace", role=role):
        new_state, reply = apply_fn(state, recv, rvalid)
    mutates = new_state is not None
    st = new_state if mutates else state
    with obs.span("exchange.collect", cat="trace", role=role):
        out = (None if reply is None
               else ex.collect(plan, reply, exchange, shift, reply_fill))
    served = ex.served(plan)
    if ex.carry_budget:
        resid = valid & ~served
        ex2 = UniformExecutor(ex.n_nodes, ex.carry_budget)
        with obs.span("exchange.carry", cat="trace", role=role,
                      carry_budget=int(ex.carry_budget)):
            if _carry_taken(plan.overflow, global_sum):
                with obs.span("exchange.carry.plan", cat="trace",
                              role=role):
                    plan2 = ex2.plan(dest, resid, client=client)
                recv2, rvalid2 = ex2.send(plan2, fields, exchange, shift)
                st2, reply2 = apply_fn(st, recv2, rvalid2)
                if mutates:
                    st = st2
                if out is not None:
                    out2 = ex2.collect(plan2, reply2, exchange, shift,
                                       reply_fill)
                    out = torch.where(
                        resid.reshape(resid.shape + _extra(out, 2)), out2,
                        out)
    overflow = (plan.overflow if plan.overflow is not None
                else torch.zeros(dest.shape[0], dtype=I32,
                                 device=dest.device))
    return st, out, served, overflow


# ---------------------------------------------------------------------------
# modeled footprint
# ---------------------------------------------------------------------------
def _spec_cols(spec, n_nodes: int, uniform_b: int) -> int:
    """Exchanged send-buffer columns per source row for one plan."""
    if isinstance(spec, MeshRaggedSpec):
        return (spec.exchanged_cols if spec.executor == "ppermute"
                else n_nodes * max(1, spec.bmax))
    if isinstance(spec, RaggedSpec):
        return spec.total
    return n_nodes * uniform_b


def exchange_footprint(policy, q: int, words: int,
                       config: ExchangeConfig) -> Dict[str, int]:
    """Modeled int32 elements crossing the exchange per engine call (the
    reference's model).

    Counts every exchanged buffer (requests, masks and replies) for one
    write, one read (no broadcast fallback) and one metadata round.  Dense
    buffers carry q slots per (src, dst) pair; uniform compacted ones the
    per-destination budget; ragged ones the measured packed columns per
    source row: Σbᵢ for a stacked spec, N·bmax for the padded mesh plan,
    the nonzero off-diagonal round widths for the ppermute plan.  A fused write ships both planes' packed columns at
    the common row width and no metadata replies.  The ``*_carry_elems``
    fields are the worst case of the lossless carry round (0 for measured
    ragged plans and lossless B = q).
    """
    policy = as_policy(policy)
    N = policy.n_nodes
    if config.kind == "compacted":
        bd, bm = data_budget(policy, q, config), meta_budget(policy, q,
                                                             config)
    else:
        bd = bm = q
    cols_d = (_spec_cols(config.data_spec, N, bd)
              if config.kind == "compacted" else N * bd)
    cols_m = (_spec_cols(config.meta_spec, N, bm)
              if config.kind == "compacted" else N * bm)
    w_meta, w_wr, w_rd = (4 + 1) + 3, (2 + words + 1), (2 + 1) + (words + 1)
    w_fused = max(2 + words, 4) + 1           # widest plane row + mask
    meta = N * cols_m * w_meta                # op/key/size/loc+mask → replies
    write = N * cols_d * w_wr + meta          # keys+payload+mask, then meta
    read = N * cols_d * w_rd
    carry = {"write_carry_elems": 0, "read_carry_elems": 0,
             "meta_carry_elems": 0}
    fplan = fused_write_plan(policy, q, config)
    if fplan is not None:
        write = N * (cols_d + cols_m) * w_fused     # one round, no replies
    if config.kind == "compacted" and config.lossless:
        cd = 0 if config.data_spec is not None else _carry_budget(q, bd)
        cm = 0 if config.meta_spec is not None else _carry_budget(q, bm)
        if config.carry_budget_hint is not None:
            cd = min(cd, max(0, int(config.carry_budget_hint)))
            cm = min(cm, max(0, int(config.carry_budget_hint)))
        wc = N * N * cd * w_wr + N * N * cm * w_meta
        if fplan is not None:
            wc = 0          # fused plans are overflow-free by construction
        carry = {"write_carry_elems": wc,
                 "read_carry_elems": N * N * cd * w_rd,
                 "meta_carry_elems": N * N * cm * w_meta}
    return {"kind": config.kind, "data_budget": bd, "meta_budget": bm,
            "lossless": config.lossless,
            "write_elems": write, "read_elems": read, "meta_elems": meta,
            **carry}
