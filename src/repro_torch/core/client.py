"""BBClient: the burst-buffer facade on the stacked backend (twin of
``repro.core.client``).

Construct from a ``LayoutPolicy`` and get batched
``write/read/stat/create/remove`` with per-request layout modes resolved from
path scopes.  Requests are node-major ``(n_nodes, q)`` tensors
(``BBRequest``); ``encode`` builds one from path strings.  The tables live
on the CUDA card unless ``device`` names another device.

``exchange=`` picks the exchange plane per call:

* ``"auto"`` (default) — dense vs compacted by call shape
  (``exchange_select``);
* ``"compacted"`` — sort-based routing with budgets sized per destination
  from each call's measured histograms (``ragged=True``), packed into one
  (L, Σbᵢ) buffer; a write ships its data and metadata planes as one fused
  round; a hybrid read runs two-phase: the metadata probe first, then a
  data round sized from the probed locations;
* ``"dense"`` — the O(N²·q) bucketize broadcast, the parity oracle.

Not ported yet: the mesh backend, telemetry and online adaptation (policy
epochs, migration), and the flight recorder.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import burst_buffer as bb
from repro_torch.core import exchange_select
from repro_torch.core.layouts import LayoutMode, route_data, route_meta, str_hash
from repro_torch.core.policy import as_policy
from repro_torch.kernels.chunk_router.ops import histogram_rows2d

EXCHANGE_KINDS = ("auto", "dense", "compacted")
I32 = torch.int32


@dataclass
class BBRequest:
    """A batched I/O request: node-major tensors shaped (n_nodes, q).

    ``path_hash``: int32 31-bit FNV path hashes (see ``str_hash``);
    ``chunk_id``: int32 chunk index within the file (0 when omitted);
    ``payload``: (N, q, words) chunk data — writes only;
    ``valid``: bool request-slot mask (all true when omitted);
    ``scope_hash``: int32 policy-scope hashes (``encode`` fills these);
    ``mode``: int32 explicit per-request ``LayoutMode`` values, within
    ``policy.modes_present()``; ``size``/``loc``: int32 metadata fields.
    """

    path_hash: torch.Tensor
    chunk_id: Optional[torch.Tensor] = None
    payload: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    scope_hash: Optional[torch.Tensor] = None
    mode: Optional[torch.Tensor] = None
    size: Optional[torch.Tensor] = None
    loc: Optional[torch.Tensor] = None


class BBClient:
    """Facade over the multi-mode burst-buffer engine (stacked backend).

    >>> policy = LayoutPolicy.from_scopes(
    ...     {"/bb/ckpt": LayoutMode.HYBRID}, n_nodes=32)
    >>> client = BBClient(policy)                  # tables on the card
    >>> req = client.encode(paths, chunk_id=cids, payload=chunks)
    >>> client.write(req)
    >>> out, found = client.read(req)
    """

    def __init__(self, policy, *, device=None, cap: int = 256,
                 words: int = 16, mcap: int = 256,
                 state: Optional[bb.BBState] = None, exchange: str = "auto",
                 budget: Optional[int] = None,
                 meta_budget: Optional[int] = None, capacity: float = 2.0,
                 lossless: bool = True, ragged: bool = True,
                 two_phase: bool = True, pipeline: bool = True,
                 donate: bool = False):
        """Build a client holding fresh (or adopted) node tables.

        Args:
          policy: ``LayoutPolicy`` (or ``LayoutParams``); fixes ``n_nodes``.
          device: where the tables live; CUDA when omitted (raises if no
            card is present — pass ``"cpu"`` for the plain path).
          cap/words/mcap: per-node data slots, chunk width (int32 words)
            and metadata slots of a fresh ``BBState``.
          state: adopt an existing ``BBState`` (on ``device``).
          exchange: ``"auto"``, ``"dense"`` or ``"compacted"``.
          budget/meta_budget: explicit uniform per-destination slot counts
            of the compacted data/metadata exchange (no ragged sizing for
            that exchange); ``None`` auto-sizes.
          capacity: headroom of the uniform auto budgets over ``q/N``.
          lossless: carry uniform-budget overflow into a second round
            (default) instead of dropping and counting it.
          ragged: size compacted budgets per destination from each call's
            measured histograms.
          two_phase: run hybrid reads as metadata probe → measured data
            round (with ``ragged``).
          pipeline: fuse a lossless write's data and metadata rounds.
          donate: accepted for interface parity with the JAX client and
            ignored: the port always updates the tables in place.
        """
        self.policy = as_policy(policy)
        self.n_nodes = self.policy.n_nodes
        self.device = resolve_device(device)
        self.words = words
        if exchange not in EXCHANGE_KINDS:
            raise ValueError(f"unknown exchange {exchange!r}; pass one of "
                             f"{EXCHANGE_KINDS}")
        self.exchange_mode = exchange
        self.pipeline = bool(pipeline)
        self.exchange_config = bb.ExchangeConfig(
            kind=exchange if exchange != "auto" else "compacted",
            budget=budget, meta_budget=meta_budget, capacity=capacity,
            lossless=lossless, pipeline=self.pipeline)
        if state is not None and state.data.device != self.device:
            raise ValueError(f"state lives on {state.data.device}, client "
                             f"on {self.device}")
        self.state = (state if state is not None else
                      bb.init_state(self.n_nodes, cap, words, mcap,
                                    device=self.device))
        self._path_codes = functools.lru_cache(maxsize=1 << 16)(
            self._path_codes_uncached)
        self._pick_cache: Dict[int, str] = {}
        self.ragged = bool(ragged)
        self.two_phase = bool(two_phase) and self.ragged
        # running per-(role, q) budget floor: a steady workload converges
        # to one spec instead of re-planning per batch
        self._spec_floor: Dict[Tuple[str, int], np.ndarray] = {}
        # measured carry-width floor per q (see _carry_hint)
        self._hint_floor: Dict[int, int] = {}

    # ---- request construction ----------------------------------------------
    def _path_codes_uncached(self, path: str) -> Tuple[int, int]:
        """Uncached path → (path_hash, scope_hash) resolution."""
        return str_hash(path), self.policy.scope_hash_of(path)

    def encode(self, paths: Sequence[Sequence[str]], chunk_id=None,
               payload=None, valid=None) -> BBRequest:
        """Hash a (n_nodes, q) nest of path strings into a BBRequest.

        Path and scope hashes are computed here, once, and memoized per
        client; ``chunk_id``/``payload``/``valid`` (array-likes) are moved
        to the client's device.
        """
        rows = [[self._path_codes(p) for p in row] for row in paths]
        codes = np.asarray(rows, np.int32).reshape(len(rows), -1, 2)

        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                   else x, dtype=dtype, device=self.device)

        return BBRequest(
            path_hash=dev(codes[..., 0]),
            chunk_id=None if chunk_id is None else dev(chunk_id, I32),
            payload=None if payload is None else dev(payload),
            valid=None if valid is None else dev(valid, torch.bool),
            scope_hash=dev(codes[..., 1]))

    def _modes(self, req: BBRequest) -> torch.Tensor:
        """The per-request mode array of one request batch."""
        if req.mode is not None:
            allowed = {int(m) for m in self.policy.modes_present()}
            got = set(torch.unique(req.mode).tolist())
            if not got <= allowed:
                raise ValueError(
                    f"request modes {sorted(got - allowed)} not in this "
                    f"policy's modes_present() {sorted(allowed)}; add the "
                    "mode to a policy scope (or the default) instead")
            return req.mode.to(I32)
        if req.scope_hash is not None:
            return self.policy.resolve(req.scope_hash)
        return self.policy.mode_array(req.path_hash.shape,
                                      req.path_hash.device)

    @staticmethod
    def _valid(req: BBRequest) -> torch.Tensor:
        """Request-slot mask; all-true when the request omits one."""
        if req.valid is None:
            return torch.ones(req.path_hash.shape, dtype=torch.bool,
                              device=req.path_hash.device)
        return req.valid.to(torch.bool)

    @staticmethod
    def _chunk_id(req: BBRequest) -> torch.Tensor:
        """Chunk-id array; zeros (metadata convention) when omitted."""
        if req.chunk_id is None:
            return torch.zeros(req.path_hash.shape, dtype=I32,
                               device=req.path_hash.device)
        return req.chunk_id

    # ---- per-call exchange dispatch -----------------------------------------
    def _select_kind(self, q: int) -> str:
        """Exchange kind for one call: fixed, or picked by call shape."""
        if self.exchange_mode != "auto":
            return self.exchange_mode
        kind = self._pick_cache.get(q)
        if kind is None:
            kind = exchange_select.pick_backend(self.n_nodes, q, self.words)
            self._pick_cache[q] = kind
        return kind

    def _client_ranks(self) -> torch.Tensor:
        return torch.arange(self.n_nodes, dtype=I32,
                            device=self.device)[:, None]

    def _plan_spec(self, role: str, dest, valid) -> bb.RaggedSpec:
        """Measure one call's ragged spec, with convergent presizing: the
        measured budgets are maxed into a running per-(role, q) floor that
        seeds every later plan."""
        key = (role, dest.shape[1])
        floor = self._spec_floor.get(key)
        spec = bb.plan_ragged_spec(dest, valid, self.n_nodes, align=8,
                                   floor=floor)
        budgets = np.asarray(spec.budgets, np.int64)
        self._spec_floor[key] = (budgets if floor is None
                                 else np.maximum(floor, budgets))
        return spec

    def _call_config(self, op: str, mode, ph, cid, valid,
                     data_loc=None) -> bb.ExchangeConfig:
        """The exchange config of one call, with measured ragged specs when
        the call's destinations are computable without table state
        (``data_loc`` makes a hybrid read's data round computable)."""
        q = ph.shape[1]
        if self._select_kind(q) == "dense":
            return bb.DENSE
        cfg = self.exchange_config
        if cfg.kind != "compacted":
            cfg = dataclasses.replace(cfg, kind="compacted")
        if not self.ragged or q == 0:
            return cfg
        N, client = self.n_nodes, self._client_ranks()
        if op in ("write", "read") and cfg.budget is None:
            if op == "read" and data_loc is None and \
                    LayoutMode.HYBRID in self.policy.modes_present():
                # hybrid read destinations live in the metadata tables: the
                # two-phase path probes first and calls back with data_loc
                return cfg
            dest = route_data(mode, N, ph, cid, client, data_loc=data_loc)
            cfg = dataclasses.replace(
                cfg, data_spec=self._plan_spec("data", dest, valid))
        if op in ("write", "meta") and cfg.meta_budget is None and \
                cfg.budget is None:
            owner = route_meta(mode, N, self.policy.n_md_servers, ph, client)
            cfg = dataclasses.replace(
                cfg, meta_spec=self._plan_spec("meta", owner, valid))
        if cfg.pipeline and cfg.lossless and cfg.budget is not None:
            hint = self._carry_hint(op, mode, ph, cid, valid, data_loc, q,
                                    cfg)
            if hint is not None:
                cfg = dataclasses.replace(cfg, carry_budget_hint=hint)
        return cfg

    def _carry_hint(self, op: str, mode, ph, cid, valid, data_loc, q: int,
                    cfg: bb.ExchangeConfig) -> Optional[int]:
        """Measured worst per-(row, destination) round-1 residual, rounded
        up to 8 and maxed into a running per-q floor — an upper bound on
        the carry round's need, so capping the carry at it stays lossless.
        ``None`` when no plane can overflow or its destinations are not
        computable here."""
        policy, N = self.policy, self.n_nodes
        b_d = bb.data_budget(policy, q, cfg)
        b_m = bb.meta_budget(policy, q, cfg)
        if b_d >= q and b_m >= q:
            return None
        client = self._client_ranks()
        planes = []
        if op in ("write", "read") and b_d < q:
            if op == "read" and data_loc is None and \
                    LayoutMode.HYBRID in policy.modes_present():
                return None
            planes.append((route_data(mode, N, ph, cid, client,
                                      data_loc=data_loc), b_d))
        if op in ("write", "meta") and b_m < q:
            planes.append((route_meta(mode, N, policy.n_md_servers, ph,
                                      client), b_m))
        if not planes:
            return None
        worst = 0
        for dest, b in planes:
            d = torch.where(valid, dest, N).to(I32)
            counts = histogram_rows2d(d, n_bins=N + 1)[:, :N]
            worst = max(worst, int(counts.max().item()) - b)
        hint = 0 if worst <= 0 else min(q, -(-worst // 8) * 8)
        floor = self._hint_floor.get(q)
        if floor is None or hint > floor:
            self._hint_floor[q] = floor = hint
        return floor

    def _write(self, state, mode, ph, cid, payload, valid) -> bb.BBState:
        """Engine write entry (state explicit)."""
        cfg = self._call_config("write", mode, ph, cid, valid)
        return bb.forward_write(state, self.policy, ph, cid, payload, valid,
                                mode=mode, config=cfg)

    def _read(self, state, mode, ph, cid, valid):
        """Engine read entry (state explicit).  Hybrid-capable ragged reads
        go two-phase (``_read_two_phase``)."""
        q = ph.shape[1]
        if (self.two_phase and q > 0 and
                LayoutMode.HYBRID in self.policy.modes_present() and
                self.exchange_config.budget is None and
                self._select_kind(q) == "compacted"):
            return self._read_two_phase(state, mode, ph, cid, valid)
        cfg = self._call_config("read", mode, ph, cid, valid)
        return bb.forward_read(state, self.policy, ph, cid, valid, mode=mode,
                               config=cfg)

    def _read_two_phase(self, state, mode, ph, cid, valid):
        """Metadata probe → measured ragged data round: the probe is the
        engine's own hybrid STAT, so the answers are the one-call read's."""
        shape = ph.shape
        probe_valid = valid & (mode == LayoutMode.HYBRID)
        ranks = torch.broadcast_to(self._client_ranks(), shape)
        if not bool(probe_valid.any().item()):
            # no hybrid rows in this batch: every destination resolves
            # without table state
            data_loc = ranks
        else:
            cfg_m = self._call_config("meta", mode, ph, None, probe_valid)
            _, fm, _, loc = bb.meta_op(
                state, self.policy, torch.full(shape, bb.OP_STAT, dtype=I32,
                                               device=ph.device),
                ph, torch.zeros(shape, dtype=I32, device=ph.device),
                torch.full(shape, -1, dtype=I32, device=ph.device),
                probe_valid, mode=mode, config=cfg_m)
            data_loc = torch.where(fm & (loc >= 0), loc, ranks)
        cfg = self._call_config("read", mode, ph, cid, valid,
                                data_loc=data_loc)
        return bb.forward_read(state, self.policy, ph, cid, valid, mode=mode,
                               config=cfg, data_loc=data_loc)

    def _meta(self, state, mode, op, ph, size, loc, valid):
        """Engine metadata entry (state explicit)."""
        cfg = self._call_config("meta", mode, ph, None, valid)
        return bb.meta_op(state, self.policy, op, ph, size, loc, valid,
                          mode=mode, config=cfg)

    # ---- data plane ---------------------------------------------------------
    def write(self, req: BBRequest) -> "BBClient":
        """Write a batch of chunks; updates the held state, returns self."""
        if req.payload is None:
            raise ValueError("write requires req.payload")
        self.state = self._write(self.state, self._modes(req), req.path_hash,
                                 self._chunk_id(req), req.payload,
                                 self._valid(req))
        return self

    def read(self, req: BBRequest) -> Tuple[torch.Tensor, torch.Tensor]:
        """Read a batch of chunks → (payload (N, q, w), found (N, q))."""
        return self._read(self.state, self._modes(req), req.path_hash,
                          self._chunk_id(req), self._valid(req))

    # ---- metadata plane -----------------------------------------------------
    def _meta_call(self, opcode: int, req: BBRequest):
        """Shared create/stat/remove plumbing: fill defaults, run, unpack."""
        shape, dev = req.path_hash.shape, req.path_hash.device
        op = torch.full(shape, opcode, dtype=I32, device=dev)
        size = (torch.zeros(shape, dtype=I32, device=dev) if req.size is None
                else req.size.to(I32))
        loc = (torch.full(shape, -1, dtype=I32, device=dev) if req.loc is None
               else req.loc.to(I32))
        self.state, found, r_size, r_loc = self._meta(
            self.state, self._modes(req), op, req.path_hash, size, loc,
            self._valid(req))
        return found, r_size, r_loc

    def create(self, req: BBRequest) -> torch.Tensor:
        """Create file entries (idempotent) → found mask."""
        return self._meta_call(bb.OP_CREATE, req)[0]

    def stat(self, req: BBRequest
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stat file entries → (found, size, data_location_rank)."""
        return self._meta_call(bb.OP_STAT, req)

    def remove(self, req: BBRequest) -> torch.Tensor:
        """Remove file entries (record fully cleared) → found mask."""
        return self._meta_call(bb.OP_REMOVE, req)[0]
