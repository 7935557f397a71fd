"""BBClient: the burst-buffer facade (twin of ``repro.core.client``).

Construct from a ``LayoutPolicy`` and get batched
``write/read/stat/create/remove`` with per-request layout modes resolved from
path scopes.  Requests are node-major ``(n_nodes, q)`` tensors
(``BBRequest``); ``encode`` builds one from path strings.  The tables live
on the CUDA card unless ``device`` names another device.

``backend`` is ``"stacked"`` (every node's tables on one device) or a
``mesh_engine.NodeMesh``: one process a rank over ``torch.distributed``,
each rank holding its own node rows.  On a mesh every rank makes the same
calls with the same global requests; the calls return the rank's rows of
each result (``mesh.gather`` gives the global array), and every host
decision is made from global values (the requests, all-gathered replies,
all-reduced counters), so the ranks take the same branches and their
collectives line up.  Measured specs on a mesh are ``MeshRaggedSpec``s:
the padded plan, or the ppermute plan when nodes are 1:1 with ranks and
the fabric model picks it.

``exchange=`` picks the exchange plane per call:

* ``"auto"`` (default) — dense vs compacted by call shape
  (``exchange_select``);
* ``"compacted"`` — sort-based routing with budgets sized per destination
  from each call's measured histograms (``ragged=True``), packed into one
  (L, Σbᵢ) buffer; a write ships its data and metadata planes as one fused
  round; a hybrid read runs two-phase: the metadata probe first, then a
  data round sized from the probed locations;
* ``"dense"`` — the O(N²·q) bucketize broadcast, the parity oracle.

``telemetry=True`` folds every call into per-scope intent counters on the
client's device and keeps the host-side write registry that a
``LiveMigrator`` builds its worklists from; ``install_policy`` swaps the
layout plan as a policy epoch, with the dual-epoch read/stat fallback
armed while a scope migrates (``repro_torch.core.adapt``).  ``trace=``
takes a flight recorder (``repro_torch.core.obs.TraceRecorder``): every
call then records fenced ``client.*`` spans, byte and carry accounting and
the audit of each pick.

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
from repro_torch.core import exchange_select, obs
from repro_torch.core.layouts import (LayoutMode, route_data, route_meta,
                                      str_hash)
from repro_torch.core.policy import SCOPE_NONE, as_policy
from repro_torch.kernels.chunk_router.ops import histogram_rows2d

EXCHANGE_KINDS = ("auto", "dense", "compacted")
I32 = torch.int32


@dataclass(frozen=True)
class EpochFallback:
    """Dual-epoch read/stat routing during a live relayout.

    While a scope migrates, a chunk may still sit at its old-mode
    placement; the client re-issues read/stat *misses* of the migrating
    scope with ``old_mode`` so they are served from the old epoch (the
    engine's Mode-1/4 stranded-data broadcast included).  Armed and
    disarmed by ``BBClient.install_policy``.
    """

    scope_hash: int
    old_mode: int


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
    ``host``: numpy copies of the index fields ``encode`` moved to the
    device (``path_hash``, ``scope_hash``, ``chunk_id``, ``valid``), which
    the telemetry registry reads instead of copying them back; a request
    built another way has none, and the client copies what it needs.
    """

    path_hash: torch.Tensor
    chunk_id: Optional[torch.Tensor] = None
    payload: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    scope_hash: Optional[torch.Tensor] = None
    mode: Optional[torch.Tensor] = None
    size: Optional[torch.Tensor] = None
    loc: Optional[torch.Tensor] = None
    host: Optional[Dict[str, np.ndarray]] = None


def _stacked_ops(policy, config: bb.ExchangeConfig) -> Tuple:
    """(write, read, meta, read_loc) of the stacked backend, with the
    mesh ops' signatures (``mesh_engine.build_mesh_ops``)."""
    def write(state, mode, ph, cid, payload, valid):
        return bb.forward_write(state, policy, ph, cid, payload, valid,
                                mode=mode, config=config)

    def read(state, mode, ph, cid, valid):
        return bb.forward_read(state, policy, ph, cid, valid, mode=mode,
                               config=config)

    def meta(state, mode, op, ph, size, loc, valid):
        return bb.meta_op(state, policy, op, ph, size, loc, valid, mode=mode,
                          config=config)

    def read_loc(state, mode, ph, cid, valid, data_loc):
        return bb.forward_read(state, policy, ph, cid, valid, mode=mode,
                               config=config, data_loc=data_loc)

    return write, read, meta, read_loc


def _stacked_probe(policy, config: bb.ExchangeConfig):
    """The two-phase read's probe on the stacked backend: (state, mode, ph,
    valid) → (found, loc), one STAT ``meta_op``."""
    def probe(state, mode, ph, valid):
        shape, dev = ph.shape, ph.device
        _, found, _, loc = bb.meta_op(
            state, policy, torch.full(shape, bb.OP_STAT, dtype=I32,
                                      device=dev),
            ph, torch.zeros(shape, dtype=I32, device=dev),
            torch.full(shape, -1, dtype=I32, device=dev), valid, mode=mode,
            config=config)
        return found, loc

    return probe


class BBClient:
    """Facade over the multi-mode burst-buffer engine.

    >>> policy = LayoutPolicy.from_scopes(
    ...     {"/bb/ckpt": LayoutMode.HYBRID}, n_nodes=32)
    >>> client = BBClient(policy)          # or BBClient(policy, mesh)
    >>> req = client.encode(paths, chunk_id=cids, payload=chunks)
    >>> client.write(req)
    >>> out, found = client.read(req)
    """

    def __init__(self, policy, backend="stacked", *, device=None,
                 cap: int = 256,
                 words: int = 16, mcap: int = 256,
                 state: Optional[bb.BBState] = None, exchange: str = "auto",
                 budget: Optional[int] = None,
                 meta_budget: Optional[int] = None, capacity: float = 2.0,
                 lossless: bool = True, ragged: bool = True,
                 two_phase: bool = True, pipeline: bool = True,
                 donate: bool = False, telemetry: bool = False,
                 trace: Optional[obs.TraceRecorder] = None):
        """Build a client holding fresh (or adopted) node tables.

        Args:
          policy: ``LayoutPolicy`` (or ``LayoutParams``); fixes ``n_nodes``.
          backend: ``"stacked"`` or a ``mesh_engine.NodeMesh``
            (``make_node_mesh``); on a mesh the client holds the rank's
            node rows, on the mesh's device.
          device: where the tables live; CUDA when omitted (raises if no
            card is present — pass ``"cpu"`` for the plain path).  On a
            mesh, the mesh's device (``device`` may only name its type).
          cap/words/mcap: per-node data slots, chunk width (int32 words)
            and metadata slots of a fresh ``BBState``.
          state: start from an existing ``BBState`` of every node (on
            ``device``): its tables are cloned, so ``state`` stays as it
            was, unless ``donate``; a mesh client keeps its rank's rows.
          exchange: ``"auto"``, ``"dense"`` or ``"compacted"``.
          budget/meta_budget: explicit uniform per-destination slot counts
            of the compacted data/metadata exchange (no ragged sizing for
            that exchange); ``None`` auto-sizes.
          capacity: headroom of the uniform auto budgets over ``q/N``.
          lossless: carry uniform-budget overflow into a second round
            (default) instead of dropping and counting it.
          ragged: size compacted budgets per destination from each call's
            measured histograms (``RaggedSpec`` stacked, ``MeshRaggedSpec``
            on a mesh).
          two_phase: run hybrid reads as metadata probe → measured data
            round (with ``ragged``).
          pipeline: fuse a lossless write's data and metadata rounds.
          donate: adopt ``state``'s tables themselves instead of cloning
            them.  The client then updates them in place (as it updates
            its own tables on every call), so the caller gives ``state``
            up, as a JAX caller gives up a donated state.
          telemetry: accumulate per-scope intent counters on every call
            (``repro_torch.core.adapt.telemetry``, on the client's device)
            and keep the host-side write registry the ``LiveMigrator``
            builds its worklists from.  On a mesh the counters are kept
            per node row and ``snapshot()`` sums them over the mesh
            (``build_telemetry_reduce``).  Off by default.
          trace: an ``obs.TraceRecorder`` flight recorder: every engine
            call then records a fenced ``client.*`` span, byte/carry/drop
            accounting lands in ``trace.metrics`` and selector picks are
            audited into ``trace.audit``.  ``None`` (default) adds no
            launch, copy or synchronisation.
        """
        self.policy = as_policy(policy)
        self.n_nodes = self.policy.n_nodes
        self.backend = backend
        self.mesh = None if isinstance(backend, str) else backend
        if self.mesh is None:
            if backend != "stacked":
                raise ValueError(f"unknown backend {backend!r}; pass "
                                 "'stacked' or a NodeMesh")
            self.device = resolve_device(device)
            n_rows = self.n_nodes
        else:
            self.device = self.mesh.device
            if device is not None and \
                    torch.device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
            n_rows = self.mesh.local_n(self.n_nodes)
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
        if state is None:
            state = bb.init_state(n_rows, cap, words, mcap,
                                  device=self.device)
        elif self.mesh is not None or not donate:
            rows = (slice(None) if self.mesh is None
                    else self.mesh.rows(self.n_nodes))
            state = bb.BBState(*(
                getattr(state, f.name)[rows] if donate
                else getattr(state, f.name)[rows].clone()
                for f in dataclasses.fields(bb.BBState)))
        self.state = state
        self._path_codes = functools.lru_cache(maxsize=1 << 16)(
            self._path_codes_uncached)
        self._pick_cache: Dict[int, str] = {}
        self.ragged = bool(ragged)
        self.two_phase = bool(two_phase) and self.ragged
        # the newest measured spec of each role ("data", "meta")
        self.last_specs: Dict[str, object] = {}
        # ppermute plans rotate the ring of ranks: nodes 1:1 with ranks
        self._ppermute_ok = (self.mesh is not None and
                             self.mesh.world == self.n_nodes)
        # running per-(role, q) budget floor: a steady workload converges
        # to one spec instead of re-planning per batch
        self._spec_floor: Dict[Tuple[str, int], np.ndarray] = {}
        # measured carry-width floor per q (see _carry_hint)
        self._hint_floor: Dict[int, int] = {}
        self.obs = trace
        # modeled-footprint memo per (q, config) for traced accounting
        self._foot_cache: Dict[Tuple[int, bb.ExchangeConfig],
                               Dict[str, int]] = {}
        # suggest_align reads the telemetry back from the device: refresh
        # it every _ALIGN_REFRESH plans instead of per plan
        self._align_state: Dict[int, Tuple[int, int]] = {}
        # ---- online adaptation state (repro_torch.core.adapt) ----
        self.epoch = 0
        self.epoch_log: list = []
        self.fallback: Optional[EpochFallback] = None
        self.telemetry = None
        # write registry: scope_hash → {path_hash: size}; path_hash → writer
        self._files: Dict[int, Dict[int, int]] = {}
        self._writer: Dict[int, int] = {}
        if telemetry:
            from repro_torch.core.adapt.telemetry import ScopeTelemetry
            reduce = None
            if self.mesh is not None:
                from repro_torch.core.mesh_engine import \
                    build_telemetry_reduce
                reduce = build_telemetry_reduce(self.mesh)
            self.telemetry = ScopeTelemetry(
                self.policy, per_node=0 if self.mesh is None else n_rows,
                device=self.device, reduce=reduce)

    # ---- mesh: this rank's rows and global values ---------------------------
    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global request array (itself, stacked)."""
        return x if self.mesh is None else self.mesh.shard(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array of a per-rank result (itself, stacked)."""
        return x if self.mesh is None else self.mesh.gather(x)

    def _global_sum(self, x: torch.Tensor) -> float:
        """Sum over every node of a per-rank tensor, on the host."""
        if self.mesh is None:
            return float(x.sum().item())
        from repro_torch.core.mesh_engine import mesh_global_sum
        return float(mesh_global_sum(x, self.mesh).item())

    # ---- request construction ----------------------------------------------
    def _path_codes_uncached(self, path: str) -> Tuple[int, int]:
        """Uncached path → (path_hash, scope_hash) resolution."""
        return str_hash(path), self.policy.scope_hash_of(path)

    def encode(self, paths: Sequence[Sequence[str]], chunk_id=None,
               payload=None, valid=None) -> BBRequest:
        """Hash a (n_nodes, q) nest of path strings into a BBRequest.

        Path and scope hashes are computed here, once, and memoized per
        client; ``chunk_id``/``payload``/``valid`` (array-likes) are moved
        to the client's device.  The request keeps host copies of its
        index fields (``BBRequest.host``) for the telemetry registry.
        """
        rows = [[self._path_codes(p) for p in row] for row in paths]
        codes = np.asarray(rows, np.int32).reshape(len(rows), -1, 2)
        host = {"path_hash": codes[..., 0], "scope_hash": codes[..., 1]}

        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                   else x, dtype=dtype, device=self.device)

        for name, x, dtype in (("chunk_id", chunk_id, np.int32),
                               ("valid", valid, bool)):
            if x is not None and not torch.is_tensor(x):
                host[name] = np.asarray(x).astype(dtype)
        return BBRequest(
            path_hash=dev(codes[..., 0]),
            chunk_id=None if chunk_id is None else dev(chunk_id, I32),
            payload=None if payload is None else dev(payload),
            valid=None if valid is None else dev(valid, torch.bool),
            scope_hash=dev(codes[..., 1]), host=host)

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

    # ---- online adaptation: telemetry, registry, policy epochs --------------
    @staticmethod
    def _host(req: BBRequest, name: str) -> Optional[np.ndarray]:
        """Host copy of one index field of ``req``: the one ``encode`` kept,
        else a copy back from the device (None if the field is absent)."""
        if req.host is not None and name in req.host:
            return req.host[name]
        x = getattr(req, name)
        return None if x is None else x.cpu().numpy()

    def _host_scopes(self, req: BBRequest) -> np.ndarray:
        """Host scope hashes of the request (SCOPE_NONE if absent)."""
        sh = self._host(req, "scope_hash")
        return (np.full(req.path_hash.shape, SCOPE_NONE, np.int32)
                if sh is None else sh)

    def _host_valid(self, req: BBRequest) -> np.ndarray:
        """Host request-slot mask (all true when the request omits one)."""
        v = self._host(req, "valid")
        return (np.ones(req.path_hash.shape, bool) if v is None
                else v.astype(bool))

    def _record_writes(self, req: BBRequest, valid: np.ndarray) -> None:
        """Fold one write batch into the registry (worklists, affinity)."""
        ph = self._host(req, "path_hash")
        cid = self._host(req, "chunk_id")
        if cid is None:
            cid = np.zeros(ph.shape, np.int32)
        sh = self._host_scopes(req)
        for i, j in zip(*np.nonzero(valid)):
            p = int(ph[i, j])
            files = self._files.setdefault(int(sh[i, j]), {})
            files[p] = max(files.get(p, 0), int(cid[i, j]) + 1)
            self._writer.setdefault(p, int(i))

    def _self_hint(self, req: BBRequest) -> np.ndarray:
        """Per-request "was written by this row" mask (locality signal)."""
        ph = self._host(req, "path_hash")
        writer = self._writer
        return np.fromiter(
            (writer.get(int(p)) == i
             for i, row in enumerate(ph) for p in row),
            bool, count=ph.size).reshape(ph.shape)

    def _observe(self, req: BBRequest, kind: str) -> None:
        """Accumulate one call into the per-scope telemetry counters."""
        mode = self._modes(req)
        valid = self._valid(req)
        ph, cid = req.path_hash, self._chunk_id(req)
        ranks = self._client_ranks()
        if kind == "meta":
            dest = route_meta(mode, self.n_nodes, self.policy.n_md_servers,
                              ph, ranks)
        else:
            dest = route_data(mode, self.n_nodes, ph, cid, ranks)
        hint = None
        if kind == "read":
            # page-locked, so the copy to the card does not wait for it
            hint = torch.from_numpy(self._self_hint(req))
            if self.device.type == "cuda":
                hint = hint.pin_memory().to(self.device, non_blocking=True)
        if kind == "write":
            self._record_writes(req, self._host_valid(req))
        sh = None if req.scope_hash is None else self._local(req.scope_hash)
        self.telemetry.record(
            kind, sh, self._local(ph), self._local(cid), self._local(dest),
            self._local(valid), words=0 if kind == "meta" else self.words,
            self_hint=None if hint is None else self._local(hint),
            n_nodes=self.n_nodes, capacity=self.exchange_config.capacity)

    def scope_files(self, scope: str) -> Dict[int, int]:
        """Registry view of one scope: {path_hash: size-in-chunks}.

        Everything this client has routed into ``scope`` since
        construction (``telemetry=True`` keeps the registry) — the
        ``LiveMigrator``'s worklist source.
        """
        return dict(self._files.get(str_hash(scope.rstrip("/") or "/"),
                                    {}))

    def writer_of(self, path_hash: int) -> Optional[int]:
        """Registry view: the first rank that wrote ``path_hash`` (or
        None).  Migration installments writer-align worklist rows so the
        old epoch's metadata is reachable under every mode — Mode-1
        entries only exist on the writer's node."""
        return self._writer.get(int(path_hash))

    def install_policy(self, policy, *, migrating: Optional[str] = None,
                       old_mode: Optional[int] = None,
                       new_mode: Optional[int] = None) -> "BBClient":
        """Swap the layout plan mid-run — one policy epoch.

        With ``migrating`` (a scope name) the dual-epoch fallback is
        armed: read/stat misses of that scope are re-issued under
        ``old_mode`` until the next ``install_policy`` (normally the
        ``LiveMigrator.finish()`` call) disarms it.  Scope-string caches
        are invalidated; telemetry rows follow the new scope set.
        """
        policy = as_policy(policy)
        if policy.n_nodes != self.n_nodes:
            raise ValueError(
                f"policy n_nodes {policy.n_nodes} != client {self.n_nodes}"
                " — a node-count change is a re-deployment, not an epoch")
        self.policy = policy
        self.epoch += 1
        self._path_codes.cache_clear()
        self._spec_floor.clear()        # routing changed; floors are stale
        self._hint_floor.clear()
        self._align_state.clear()
        self._foot_cache.clear()        # budgets key on the policy
        self.fallback = (None if migrating is None else
                         EpochFallback(str_hash(migrating), int(old_mode)))
        if self.telemetry is not None:
            self.telemetry.rebind(policy)
        from repro_torch.core.adapt.migrate import PolicyEpoch
        self.epoch_log.append(PolicyEpoch(
            self.epoch, policy, migrating,
            None if old_mode is None else LayoutMode(old_mode),
            None if new_mode is None else LayoutMode(new_mode)))
        if self.obs is not None:
            self.obs.metrics.set_gauge("policy_epoch", float(self.epoch))
            self.obs.audit.record(
                "policy_epoch", f"epoch-{self.epoch}",
                inputs={"migrating": migrating,
                        "old_mode": None if old_mode is None
                        else int(old_mode),
                        "new_mode": None if new_mode is None
                        else int(new_mode)},
                evidence={"grade": "runtime", "source": "install_policy"})
        return self

    def _migrate_config(self) -> bb.ExchangeConfig:
        """Exchange config for relayout calls: uniform and lossless.

        Ragged specs are sized for ONE destination pattern, but
        ``migrate_rows`` routes the same worklist under two mode arrays —
        so migration always uses uniform budgets with the carry round
        (or the dense oracle when the client is pinned dense).
        """
        if self.exchange_mode == "dense":
            return bb.DENSE
        return dataclasses.replace(self.exchange_config, kind="compacted",
                                   data_spec=None, meta_spec=None,
                                   lossless=True)

    def migrate_rows(self, path_hash, chunk_id, valid, *, old_mode: int,
                     new_mode: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One relayout installment: move chunks old-mode → new-mode.

        Thin dispatch over ``burst_buffer.migrate_rows`` (stacked) or
        ``mesh_engine.build_mesh_migrate`` (mesh); drive it through a
        ``LiveMigrator`` rather than directly.  ``path_hash``/
        ``chunk_id``/``valid`` are (N, q) array-likes, moved to the
        client's device.  Returns (moved, found_old) masks (the rank's
        rows on a mesh).
        """
        allowed = {int(m) for m in self.policy.modes_present()}
        if not {int(old_mode), int(new_mode)} <= allowed:
            raise ValueError(
                f"migration modes ({old_mode}, {new_mode}) must be in the "
                f"installed policy's modes_present() {sorted(allowed)}; "
                "install the transition policy first")
        ph = torch.as_tensor(path_hash, dtype=I32, device=self.device)
        cid = torch.as_tensor(chunk_id, dtype=I32, device=self.device)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=self.device)
        old = torch.full(ph.shape, int(old_mode), dtype=I32,
                         device=self.device)
        new = torch.full(ph.shape, int(new_mode), dtype=I32,
                         device=self.device)
        cfg = self._migrate_config()
        op = self._migrate_op(cfg)
        with obs.activate(self.obs), \
                obs.span("client.migrate", cat="client",
                         old_mode=int(old_mode), new_mode=int(new_mode)) as h:
            self.state, moved, found_old = h.fence(
                op(self.state, ph, cid, valid, old, new))
        if self.obs is None:
            return moved, found_old
        m = self.obs.metrics
        m.inc("migrate_calls_total", epoch=self.epoch)
        m.inc("migrate_moved_total", self._global_sum(moved))
        return moved, found_old

    def _migrate_op(self, cfg: bb.ExchangeConfig):
        """``(state, ph, cid, valid, old_mode, new_mode)`` → ``(state,
        moved, found_old)`` for one config, on either backend."""
        if self.mesh is None:
            policy = self.policy
            return lambda state, *a: bb.migrate_rows(state, policy, *a,
                                                     config=cfg)
        from repro_torch.core.mesh_engine import build_mesh_migrate
        return build_mesh_migrate(self.mesh, self.policy, cfg)

    def _ops(self, config: bb.ExchangeConfig) -> Tuple:
        """(write, read, meta, read_loc) ops of one config."""
        if self.mesh is None:
            return _stacked_ops(self.policy, config)
        from repro_torch.core.mesh_engine import build_mesh_ops
        return build_mesh_ops(self.mesh, self.policy, config)

    def _probe_op(self, config: bb.ExchangeConfig):
        """The (found, loc)-only STAT op of one config (both backends)."""
        if self.mesh is None:
            return _stacked_probe(self.policy, config)
        from repro_torch.core.mesh_engine import build_mesh_probe
        return build_mesh_probe(self.mesh, self.policy, config)

    # ---- per-call exchange dispatch -----------------------------------------
    def _select_kind(self, q: int) -> str:
        """Exchange kind for one call: fixed, or picked by call shape."""
        if self.exchange_mode != "auto":
            return self.exchange_mode
        kind = self._pick_cache.get(q)
        if kind is None:
            kind = exchange_select.pick_backend(self.n_nodes, q, self.words)
            self._pick_cache[q] = kind
        elif self.obs is not None:
            self.obs.metrics.inc("exchange_pick_cache_hits_total", kind=kind)
        return kind

    def _client_ranks(self) -> torch.Tensor:
        return torch.arange(self.n_nodes, dtype=I32,
                            device=self.device)[:, None]

    def _plan_spec(self, role: str, dest, valid, row_bytes: int):
        """Measure one call's ragged spec, with convergent presizing: the
        measured budgets are maxed into a running per-(role, q) floor that
        seeds every later plan.  With telemetry on, the live extent
        histogram picks the quantization step (``_suggest_align``).  A
        mesh plans a ``MeshRaggedSpec`` (padded or ppermute, picked by the
        fabric model from ``row_bytes`` a column)."""
        key = (role, dest.shape[1])
        floor = self._spec_floor.get(key)
        align = self._suggest_align(dest.shape[1])
        if self.mesh is not None:
            spec = bb.plan_mesh_ragged_spec(
                dest, valid, self.n_nodes, align=align, row_bytes=row_bytes,
                allow_ppermute=self._ppermute_ok, floor=floor)
        else:
            spec = bb.plan_ragged_spec(dest, valid, self.n_nodes,
                                       align=align, floor=floor)
        budgets = np.asarray(spec.budgets, np.int64)
        grew = floor is None or bool((budgets > floor).any())
        if grew and self.obs is not None:
            # a grown floor means a new spec (and new device tables)
            self.obs.metrics.inc("ragged_respecializations_total", role=role)
        self._spec_floor[key] = (budgets if floor is None
                                 else np.maximum(floor, budgets))
        self.last_specs[role] = spec
        return spec

    #: plans between telemetry re-reads of the align hint (each re-read
    #: copies the counters back from the device)
    _ALIGN_REFRESH = 32

    def _suggest_align(self, q: int) -> int:
        """Cached quantization hint (``ScopeTelemetry.suggest_align``); 8
        with telemetry off.  The live value costs a device-to-host copy of
        the counters, so it is re-read every ``_ALIGN_REFRESH`` plans per
        batch width."""
        if self.telemetry is None:
            return 8
        align, left = self._align_state.get(q, (None, 0))
        if align is None or left <= 0:
            align, left = self.telemetry.suggest_align(q), self._ALIGN_REFRESH
        self._align_state[q] = (align, left - 1)
        return align

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
                cfg, data_spec=self._plan_spec("data", dest, valid,
                                               4 * (self.words + 3)))
        if op in ("write", "meta") and cfg.meta_budget is None and \
                cfg.budget is None:
            owner = route_meta(mode, N, self.policy.n_md_servers, ph, client)
            cfg = dataclasses.replace(
                cfg, meta_spec=self._plan_spec("meta", owner, valid, 4 * 8))
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
            if floor is not None and self.obs is not None:
                self.obs.metrics.inc("carry_hint_respecializations_total")
            self._hint_floor[q] = floor = hint
        return floor

    def _write(self, state, mode, ph, cid, payload, valid) -> bb.BBState:
        """Engine write entry (state explicit)."""
        with obs.activate(self.obs), \
                obs.span("client.write", cat="client",
                         q=int(ph.shape[1])) as h:
            cfg = self._call_config("write", mode, ph, cid, valid)
            out = h.fence(self._ops(cfg)[0](state, mode, ph, cid, payload,
                                            valid))
        if self.obs is not None:
            self._account("write", cfg, ph.shape[1], out, mode, ph, cid,
                          valid)
        return out

    def _read(self, state, mode, ph, cid, valid):
        """Engine read entry (state explicit).  Hybrid-capable ragged reads
        go two-phase (``_read_two_phase``)."""
        with obs.activate(self.obs):
            return self._read_impl(state, mode, ph, cid, valid)

    def _read_impl(self, state, mode, ph, cid, valid):
        """``_read`` body, run under the recorder activation (if any)."""
        q = ph.shape[1]
        if (self.two_phase and q > 0 and
                LayoutMode.HYBRID in self.policy.modes_present() and
                self.exchange_config.budget is None and
                self._select_kind(q) == "compacted"):
            return self._read_two_phase(state, mode, ph, cid, valid)
        with obs.span("client.read", cat="client", q=int(q)) as h:
            cfg = self._call_config("read", mode, ph, cid, valid)
            out = h.fence(self._ops(cfg)[1](state, mode, ph, cid, valid))
        if self.obs is not None:
            self._account("read", cfg, q, None, mode, ph, cid, valid)
        return out

    def _read_two_phase(self, state, mode, ph, cid, valid):
        """Metadata probe → measured ragged data round: the probe is the
        engine's own hybrid STAT, so the answers are the one-call read's.
        On a mesh the probed locations are all-gathered: every rank plans
        the data round from the global array."""
        shape = ph.shape
        probe_valid = valid & (mode == LayoutMode.HYBRID)
        ranks = torch.broadcast_to(self._client_ranks(), shape)
        if not bool(probe_valid.any().item()):
            # no hybrid rows in this batch: every destination resolves
            # without table state
            data_loc = ranks
        else:
            with obs.span("client.read.probe", cat="client") as h:
                cfg_m = self._call_config("meta", mode, ph, None,
                                          probe_valid)
                fm, loc = h.fence(self._probe_op(cfg_m)(state, mode, ph,
                                                        probe_valid))
            if self.obs is not None:
                self._account("meta", cfg_m, shape[1], None, mode, ph, None,
                              probe_valid)
            data_loc = self._gather(torch.where(fm & (loc >= 0), loc,
                                                self._local(ranks)))
        with obs.span("client.read.data", cat="client") as h:
            cfg = self._call_config("read", mode, ph, cid, valid,
                                    data_loc=data_loc)
            out = h.fence(self._ops(cfg)[3](state, mode, ph, cid, valid,
                                            data_loc))
        if self.obs is not None:
            self._account("read", cfg, shape[1], None, mode, ph, cid, valid)
        return out

    def _meta(self, state, mode, op, ph, size, loc, valid):
        """Engine metadata entry (state explicit)."""
        with obs.activate(self.obs), \
                obs.span("client.meta", cat="client",
                         q=int(ph.shape[1])) as h:
            cfg = self._call_config("meta", mode, ph, None, valid)
            out = h.fence(self._ops(cfg)[2](state, mode, op, ph, size, loc,
                                            valid))
        if self.obs is not None:
            self._account("meta", cfg, ph.shape[1], out[0], mode, ph, None,
                          valid)
        return out

    # ---- traced-call accounting (tracing on only) ---------------------------
    _FOOT_ELEMS = {"write": "write_elems", "read": "read_elems",
                   "meta": "meta_elems"}

    def _footprint(self, q: int, cfg: bb.ExchangeConfig) -> Dict[str, int]:
        """Memoized ``exchange_footprint`` of one (q, config) pair."""
        key = (q, cfg)
        foot = self._foot_cache.get(key)
        if foot is None:
            if len(self._foot_cache) >= 256:
                self._foot_cache.pop(next(iter(self._foot_cache)))
            foot = self._foot_cache[key] = bb.exchange_footprint(
                self.policy, q, self.words, cfg)
        return foot

    def _account(self, op: str, cfg: bb.ExchangeConfig, q: int, state_out,
                 mode, ph, cid, valid) -> None:
        """Metrics for one engine call: op mix, modeled exchange bytes,
        the engine's drop counter and the carry-round rate.

        ``exchange_bytes_total{op}`` increments by exactly the modeled
        footprint of the config the call ran under (4 bytes per int32
        element), and ``exchange_dropped_rows`` mirrors the engine's own
        cumulative ``state.dropped``.  For uniform lossless under-budget
        plans the per-(row, destination) overflow is measured to expose
        the carry-round rate.
        """
        m = self.obs.metrics
        foot = self._footprint(q, cfg)
        m.inc("client_ops_total", op=op, kind=foot["kind"],
              epoch=self.epoch)
        m.inc("exchange_bytes_total", 4 * foot[self._FOOT_ELEMS[op]], op=op)
        if state_out is not None:
            m.set_gauge("exchange_dropped_rows",
                        self._global_sum(state_out.dropped))
        if foot["kind"] != "compacted" or not cfg.lossless:
            return
        ranks = self._client_ranks()
        if op in ("write", "read") and cfg.data_spec is None and \
                foot["data_budget"] < q:
            dest = route_data(mode, self.n_nodes, ph, cid, ranks)
            self._carry_metrics(dest, valid, foot["data_budget"], "data")
        elif op == "meta" and cfg.meta_spec is None and \
                foot["meta_budget"] < q:
            owner = route_meta(mode, self.n_nodes, self.policy.n_md_servers,
                               ph, ranks)
            self._carry_metrics(owner, valid, foot["meta_budget"], "meta")

    def _carry_metrics(self, dest: torch.Tensor, valid: torch.Tensor,
                       budget: int, plane: str) -> None:
        """The executor's budget-overflow count, measured: per source row,
        the requests beyond the per-destination budget (what
        ``ExchangePlan.overflow`` sums and the carry round is gated on),
        fed to the carry-rate counters and the overflow histogram."""
        N = self.n_nodes
        d = torch.where(valid.to(torch.bool), dest, N).to(I32)
        counts = histogram_rows2d(d.contiguous(), n_bins=N + 1)[:, :N]
        over = int(torch.clamp(counts - budget, min=0).sum().item())
        m = self.obs.metrics
        m.inc("carry_eligible_total", plane=plane)
        m.observe("carry_overflow_rows", over, plane=plane)
        if over > 0:
            m.inc("carry_rounds_total", plane=plane)

    # ---- data plane ---------------------------------------------------------
    def write(self, req: BBRequest) -> "BBClient":
        """Write a batch of chunks; updates the held state, returns self."""
        if req.payload is None:
            raise ValueError("write requires req.payload")
        if self.telemetry is not None:
            self._observe(req, "write")
        self.state = self._write(self.state, self._modes(req), req.path_hash,
                                 self._chunk_id(req), req.payload,
                                 self._valid(req))
        return self

    def _epoch_miss(self, req: BBRequest, found: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """Migrating-scope rows the new epoch missed (None if no retry);
        one wait for the card, and only while a scope migrates.  ``found``
        is this rank's rows; the miss mask is global."""
        fb = self.fallback
        if fb is None or req.scope_hash is None:
            return None
        miss = self._valid(req) & ~self._gather(found) & \
            (req.scope_hash == fb.scope_hash)
        return miss if bool(miss.any().item()) else None

    def _old_modes(self, req: BBRequest) -> torch.Tensor:
        """The migrating scope's old mode over the request's shape."""
        return torch.full(req.path_hash.shape, self.fallback.old_mode,
                          dtype=I32, device=req.path_hash.device)

    def read(self, req: BBRequest) -> Tuple[torch.Tensor, torch.Tensor]:
        """Read a batch of chunks → (payload (L, q, w), found (L, q)): every
        node's rows stacked, the rank's rows on a mesh.

        During a live relayout (``fallback`` armed), misses of the
        migrating scope are re-issued under the old mode — a chunk the
        watermark hasn't reached yet is served from its old placement.
        """
        if self.telemetry is not None:
            self._observe(req, "read")
        payload, found = self._read(self.state, self._modes(req),
                                    req.path_hash, self._chunk_id(req),
                                    self._valid(req))
        miss = self._epoch_miss(req, found)
        if miss is not None:
            p2, f2 = self._read(self.state, self._old_modes(req),
                                req.path_hash, self._chunk_id(req), miss)
            payload = torch.where(f2[..., None], p2, payload)
            found = found | f2
        return payload, found

    # ---- metadata plane -----------------------------------------------------
    def _meta_call(self, opcode: int, req: BBRequest, mode=None, valid=None):
        """Shared create/stat/remove plumbing: fill defaults, run, unpack.

        ``mode``/``valid`` override the request's resolution — the
        dual-epoch retries pass the old-mode array with a miss mask."""
        shape, dev = req.path_hash.shape, req.path_hash.device
        op = torch.full(shape, opcode, dtype=I32, device=dev)
        size = (torch.zeros(shape, dtype=I32, device=dev) if req.size is None
                else req.size.to(I32))
        loc = (torch.full(shape, -1, dtype=I32, device=dev) if req.loc is None
               else req.loc.to(I32))
        if mode is None and self.telemetry is not None:
            self._observe(req, "meta")
        self.state, found, r_size, r_loc = self._meta(
            self.state, self._modes(req) if mode is None else mode, op,
            req.path_hash, size, loc,
            self._valid(req) if valid is None else valid)
        return found, r_size, r_loc

    def create(self, req: BBRequest) -> torch.Tensor:
        """Create file entries (idempotent) → found mask."""
        return self._meta_call(bb.OP_CREATE, req)[0]

    def stat(self, req: BBRequest
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stat file entries → (found, size, data_location_rank).

        Dual-epoch during a relayout: entries whose file the watermark
        hasn't reached are still served by the old-mode owner."""
        found, size, loc = self._meta_call(bb.OP_STAT, req)
        miss = self._epoch_miss(req, found)
        if miss is not None:
            f2, s2, l2 = self._meta_call(bb.OP_STAT, req,
                                         mode=self._old_modes(req),
                                         valid=miss)
            found = found | f2
            size = torch.where(f2, s2, size)
            loc = torch.where(f2, l2, loc)
        return found, size, loc

    def remove(self, req: BBRequest) -> torch.Tensor:
        """Remove file entries (record fully cleared) → found mask.

        During a relayout the remove is issued under BOTH epochs for the
        migrating scope, so a not-yet-migrated old-owner entry cannot
        resurface through the dual-epoch stat fallback."""
        found = self._meta_call(bb.OP_REMOVE, req)[0]
        if self.telemetry is not None:
            # prune the registry so later migration worklists skip the file
            ph, sh = self._host(req, "path_hash"), self._host_scopes(req)
            for i, j in zip(*np.nonzero(self._host_valid(req))):
                self._files.get(int(sh[i, j]), {}).pop(int(ph[i, j]), None)
        fb = self.fallback
        if fb is not None and req.scope_hash is not None:
            in_scope = self._valid(req) & (req.scope_hash == fb.scope_hash)
            if bool(in_scope.any().item()):
                f2 = self._meta_call(bb.OP_REMOVE, req,
                                     mode=self._old_modes(req),
                                     valid=in_scope)[0]
                found = found | f2
        return found
