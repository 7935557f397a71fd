"""Live lossless relayout: epoch-versioned policies + bounded installments
(twin of ``repro.core.adapt.migrate``).

Changing a scope's layout mode at runtime is a two-sided problem: the
*policy* flip is instant (a new ``LayoutPolicy`` on the client), but the
scope's already-stored chunks sit at old-mode placements.  The
``LiveMigrator`` bridges the two epochs:

1. a **transition policy** is installed — the real scopes with the
   migrating scope already mapped to its new mode, plus a synthetic
   ``/__epochN__`` scope carrying the old mode so the engine's static
   ``modes_present()`` keeps both epochs' fast paths compiled (stranded-
   data broadcast for a Mode-1/4 source, hybrid meta phase, …);
2. the client's **dual-epoch fallback** is armed: reads/stats of the
   migrating scope try the new placement first and re-issue misses under
   the old mode, so every chunk is reachable at every intermediate
   watermark;
3. the scope's chunk worklist (from the client's write registry) is fed
   through ``burst_buffer.migrate_rows`` in bounded **installments** —
   each one fetches, re-encodes, ships and tombstones at most
   ``step_chunks`` chunks, so migration never monopolizes a step budget;
4. when the **watermark** passes the end of the worklist, ``finish()``
   installs the final policy (synthetic scope and fallback dropped) and
   bumps the client epoch once more.

New writes during migration route by the transition policy (i.e. the new
mode) from the first installment on, so the worklist snapshot taken at
start is sufficient: nothing new ever lands at the old placement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import obs
from repro_torch.core.layouts import LayoutMode, str_hash
from repro_torch.core.policy import LayoutPolicy, _norm_scope

#: default relayout installment size (chunks per ``LiveMigrator.step``) —
#: shared with the migration-cost model (``redecide.migration_cost_s``)
#: so the modeled collective count tracks the real driver
DEFAULT_STEP_CHUNKS = 64


@dataclass(frozen=True)
class PolicyEpoch:
    """One installed policy generation on a client.

    ``migrating`` names the scope in flight (None once stable);
    ``old_mode``/``new_mode`` are that scope's endpoints.  Kept on the
    client as an audit trail — the engine itself only ever sees mode
    arrays, which is exactly what makes epoch transitions cheap.
    """

    epoch: int
    policy: LayoutPolicy
    migrating: Optional[str] = None
    old_mode: Optional[LayoutMode] = None
    new_mode: Optional[LayoutMode] = None


def transition_policy(policy: LayoutPolicy, scope: str,
                      new_mode: LayoutMode,
                      epoch: int) -> Tuple[LayoutPolicy, LayoutMode]:
    """The mid-migration policy: scope→new mode, old mode kept present.

    The synthetic ``/__epoch{n}__`` scope never matches a real path; it
    exists so ``modes_present()`` (the engine's static specialization
    set) covers the old mode while dual-epoch reads still need it.
    Returns (policy, old_mode).
    """
    scope = _norm_scope(scope)       # match the policy's stored spelling
    old_mode = policy.mode_for_path(scope)
    scopes = {s: m for s, m in policy.scopes}
    scopes[scope] = new_mode
    scopes[f"/__epoch{epoch}__"] = old_mode
    return (LayoutPolicy.from_scopes(
        scopes, n_nodes=policy.n_nodes, default=policy.default_mode,
        metadata_server_ratio=policy.metadata_server_ratio,
        chunk_bytes=policy.chunk_bytes), old_mode)


def final_policy(policy: LayoutPolicy, scope: str,
                 new_mode: LayoutMode) -> LayoutPolicy:
    """The post-migration policy: scope→new mode, synthetics dropped."""
    scopes = {s: m for s, m in policy.scopes
              if not s.startswith("/__epoch")}
    scopes[_norm_scope(scope)] = new_mode
    return LayoutPolicy.from_scopes(
        scopes, n_nodes=policy.n_nodes, default=policy.default_mode,
        metadata_server_ratio=policy.metadata_server_ratio,
        chunk_bytes=policy.chunk_bytes)


class LiveMigrator:
    """Drives one scope's relayout through bounded installments.

    >>> mig = LiveMigrator(client, "/bb/stream", LayoutMode.DIST_HASH)
    >>> while not mig.done:
    ...     mig.step()           # ≤ step_chunks chunks per call
    >>> mig.finish()             # final policy, fallback disarmed
    """

    def __init__(self, client, scope: str, new_mode: LayoutMode, *,
                 step_chunks: int = DEFAULT_STEP_CHUNKS):
        """Snapshot the worklist and install the transition policy.

        ``client`` must have its write registry enabled
        (``telemetry=True``) — the worklist is every (path, chunk) the
        client has routed into the migrating scope; stat() sizes are
        propagated from the old epoch's own metadata, which the
        writer-aligned rows can always reach.
        """
        self.client = client
        # normalized to the policy's stored spelling — a trailing slash
        # must not desynchronize the fallback hash from request hashes
        self.scope = _norm_scope(scope)
        self.new_mode = LayoutMode(new_mode)
        self.step_chunks = int(step_chunks)
        self.scope_hash = str_hash(self.scope)
        files = client.scope_files(self.scope)
        # writer-aligned worklist rows: each chunk is migrated FROM the
        # rank that wrote its file, so the old epoch's metadata (writer-
        # local under Mode 1) and data fast paths are reachable in place
        n = client.n_nodes
        by_row: List[List[Tuple[int, int, int, int]]] = [[] for _ in
                                                         range(n)]
        for k, (ph, size) in enumerate(sorted(files.items())):
            row = client.writer_of(ph)
            row = k % n if row is None else int(row) % n
            by_row[row] += [(row, ph, cid, size) for cid in range(size)]
        # round-robin interleave so one installment's (n, q) request
        # block fills densely instead of draining one writer at a time
        self.worklist: List[Tuple[int, int, int, int]] = []
        depth = max((len(r) for r in by_row), default=0)
        for d in range(depth):
            self.worklist += [r[d] for r in by_row if d < len(r)]
        self.watermark = 0
        self.installments = 0
        trans, self.old_mode = transition_policy(
            client.policy, self.scope, self.new_mode, client.epoch + 1)
        if self.old_mode == self.new_mode:
            raise ValueError(f"scope {scope!r} already in mode "
                             f"{self.new_mode!r}")
        client.install_policy(
            trans, migrating=self.scope, old_mode=self.old_mode,
            new_mode=self.new_mode)

    @property
    def total_chunks(self) -> int:
        """Worklist length — the migration's 100% watermark."""
        return len(self.worklist)

    @property
    def done(self) -> bool:
        """True once the watermark has passed every worklist row."""
        return self.watermark >= len(self.worklist)

    def step(self, max_chunks: Optional[int] = None) -> int:
        """Migrate the next installment; returns chunks processed.

        The installment is shaped into the engine's (N, q) request layout
        with a fixed per-step q and driven through the client's
        ``migrate_rows``.
        """
        if self.done:
            return 0
        n = self.client.n_nodes
        budget = int(max_chunks or self.step_chunks)
        q = max(1, -(-min(budget, len(self.worklist)) // n))
        ph = np.zeros((n, q), np.int32)
        cid = np.zeros((n, q), np.int32)
        valid = np.zeros((n, q), bool)
        cursor = np.zeros(n, np.int32)
        taken = 0
        # greedy in worklist order: stop at the first chunk whose writer
        # row is already full this installment (watermark stays a prefix)
        for row, p, c, _s in self.worklist[self.watermark:]:
            if taken >= budget or cursor[row] >= q:
                break
            j = cursor[row]
            ph[row, j], cid[row, j] = p, c
            valid[row, j] = True
            cursor[row] += 1
            taken += 1
        with obs.activate(self.client.obs), \
                obs.span("migrate.installment", cat="adapt",
                         scope=self.scope, installment=self.installments,
                         watermark=self.watermark, chunks=taken):
            self.client.migrate_rows(
                ph, cid, valid, old_mode=int(self.old_mode),
                new_mode=int(self.new_mode))
        self.watermark += taken
        self.installments += 1
        if self.client.obs is not None:
            m = self.client.obs.metrics
            m.inc("migrate_installments_total", scope=self.scope)
            m.set_gauge("migrate_watermark", float(self.watermark),
                        scope=self.scope)
        return taken

    def run(self) -> int:
        """Drain the whole worklist, then ``finish()``; returns chunks."""
        moved = 0
        while not self.done:
            moved += self.step()
        self.finish()
        return moved

    def finish(self) -> None:
        """Install the final policy and disarm the dual-epoch fallback."""
        if not self.done:
            raise RuntimeError(
                f"migration of {self.scope!r} at watermark "
                f"{self.watermark}/{len(self.worklist)}; drive step() to "
                "completion first")
        self.client.install_policy(
            final_policy(self.client.policy, self.scope, self.new_mode))
