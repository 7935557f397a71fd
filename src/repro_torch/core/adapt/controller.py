"""The adaptation control loop: telemetry → drift → re-decide → migrate
(a copy of ``repro.core.adapt.controller``).

``AdaptationController.tick()`` is the single entry point the host loop
(training step cadence, checkpoint manager, a benchmark harness) calls
periodically.  Each tick:

1. if a migration is in flight, drive the next installment(s) — nothing
   else competes with an active relayout;
2. otherwise diff the client's telemetry against the last tick's
   snapshot, derive per-scope signatures, and feed them to the drift
   detector;
3. for scopes whose drift fired, run the re-decision pipeline and the
   cost/benefit gate; adopt at most ONE delta per tick (the largest
   predicted gain) and start its ``LiveMigrator``;
4. rebase the drift baseline for every fired scope — adopted or gated
   away — so the same evidence cannot re-fire inside the cooldown.

Every tick returns a ``TickReport`` and appends it to ``history``, so a
run's adaptation story (what drifted when, what was proposed, what the
gate said, how long migration took) is auditable after the fact.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import obs
from repro_torch.core.adapt.drift import (DriftConfig, DriftDetector,
                                          DriftReport)
from repro_torch.core.adapt.migrate import DEFAULT_STEP_CHUNKS, LiveMigrator
from repro_torch.core.adapt.redecide import (PolicyDelta, gate_delta,
                                             propose_deltas)
from repro_torch.core.adapt.telemetry import DEFAULT_SCOPE
from repro_torch.core.simulator import DEFAULT_HW, Hardware


@dataclass
class AdaptConfig:
    """Controller knobs (drift hysteresis rides in ``drift``)."""

    drift: DriftConfig = field(default_factory=DriftConfig)
    horizon_rounds: float = 200.0   # expected remaining steady-state rounds
    step_chunks: int = DEFAULT_STEP_CHUNKS   # migration installment size
    installments_per_tick: int = 1  # relayout work per tick while active


@dataclass
class TickReport:
    """What one ``tick()`` observed and did."""

    tick: int
    phase: str                      # "idle" | "drifted" | "adopted" |
    #                                 "rejected" | "migrating" | "completed"
    divergence: Dict[str, float] = field(default_factory=dict)
    fired: List[str] = field(default_factory=list)
    delta: Optional[PolicyDelta] = None
    gate: Dict[str, float] = field(default_factory=dict)
    watermark: int = 0
    total_chunks: int = 0
    epoch: int = 0


class AdaptationController:
    """Owns the drift detector and at most one in-flight migration."""

    def __init__(self, client, baseline: Optional[Dict[str, np.ndarray]]
                 = None, cfg: Optional[AdaptConfig] = None,
                 hw: Hardware = DEFAULT_HW):
        """``client`` must be a ``BBClient(..., telemetry=True)``.

        ``baseline`` maps scope name → decision-time signature (from
        ``telemetry.signature_from_stats`` on the probe the selector saw,
        or ``signature_from_phases`` on the decided workload); scopes
        without one self-calibrate on their first observed tick.
        """
        if client.telemetry is None:
            raise ValueError("AdaptationController needs a client built "
                             "with telemetry=True")
        self.client = client
        self.cfg = cfg or AdaptConfig()
        self.hw = hw
        self.detector = DriftDetector(baseline=dict(baseline or {}),
                                      cfg=self.cfg.drift)
        self.migrator: Optional[LiveMigrator] = None
        self.history: List[TickReport] = []
        self.tick_count = 0
        self._take_snapshot()

    def _take_snapshot(self) -> None:
        self._snap = self.client.telemetry.snapshot()
        self._snap_names = self.client.telemetry.scope_names
        if self.client.obs is not None:
            # the snapshot was already paid for — fold it into the
            # per-scope gauges (subsumes the telemetry host plane)
            self.client.obs.metrics.fold_telemetry(self.client.telemetry,
                                                   snapshot=self._snap)

    def _tick_delta(self):
        """Per-scope signatures since the last tick, swap-safe.

        A scope-set-changing ``install_policy`` between ticks reshapes /
        reorders the telemetry rows; diffing against a stale positional
        snapshot would crash or misattribute counters, so such a tick
        yields no signal and just re-anchors the snapshot.
        """
        if self._snap_names != self.client.telemetry.scope_names:
            self._take_snapshot()
            return {}
        live = self.client.telemetry.signatures(since=self._snap)
        self._take_snapshot()
        return live

    # ---- the control loop ---------------------------------------------------
    def tick(self) -> TickReport:
        """One adaptation step; see the module docstring for the phases.

        Runs under the client's flight-recorder activation (when one is
        installed): the tick gets an ``adapt.tick`` span, drift outcomes
        land on the metrics registry, and the redecide/gate audit records
        go to the client's recorder.
        """
        rec = self.client.obs
        if rec is None:
            return self._tick_impl()
        with obs.activate(rec), obs.span("adapt.tick", cat="adapt",
                                         tick=self.tick_count + 1):
            report = self._tick_impl()
        rec.metrics.inc("adapt_ticks_total", phase=report.phase)
        return report

    def _tick_impl(self) -> TickReport:
        """``tick`` body (recorder activation handled by the caller)."""
        self.tick_count += 1
        if self.migrator is not None:
            return self._drive_migration()
        report = TickReport(self.tick_count, "idle",
                            epoch=self.client.epoch)
        live = self._tick_delta()
        fired: Dict[str, DriftReport] = {}
        for scope, (sig, weight) in live.items():
            dr = self.detector.observe(scope, sig, weight)
            report.divergence[scope] = dr.divergence
            if dr.fired and scope != DEFAULT_SCOPE:
                # the default bucket is not a path scope — unscoped
                # traffic has no worklist and "<default>" must never be
                # minted as a literal policy scope; its drift is still
                # reported above for observability
                fired[scope] = dr
        if not fired:
            self.history.append(report)
            return report
        report.phase = "drifted"
        report.fired = sorted(fired)
        deltas = propose_deltas(
            self.client.policy,
            {s: live[s] for s in fired if s in live}, hw=self.hw)
        for delta in deltas:
            n_chunks = sum(self.client.scope_files(delta.scope).values())
            ok, audit = gate_delta(delta, n_chunks, self.client.words,
                                   self.client.n_nodes,
                                   self.cfg.horizon_rounds, hw=self.hw,
                                   step_chunks=self.cfg.step_chunks)
            report.delta, report.gate = delta, audit
            if ok:
                report.phase = "adopted"
                self.migrator = LiveMigrator(
                    self.client, delta.scope, delta.new_mode,
                    step_chunks=self.cfg.step_chunks)
                report.epoch = self.client.epoch
                report.total_chunks = self.migrator.total_chunks
                break
            report.phase = "rejected"
        for scope in fired:
            # adopted or not, this evidence has been acted on: re-anchor
            # the baseline at the live signature and start the cooldown
            self.detector.rebase(scope, live[scope][0])
        self.history.append(report)
        return report

    def _drive_migration(self) -> TickReport:
        mig = self.migrator
        for _ in range(self.cfg.installments_per_tick):
            mig.step()
            if mig.done:
                break
        report = TickReport(self.tick_count, "migrating",
                            watermark=mig.watermark,
                            total_chunks=mig.total_chunks,
                            epoch=self.client.epoch)
        if mig.done:
            mig.finish()
            self.migrator = None
            report.phase = "completed"
            report.epoch = self.client.epoch
            # migration changed every placement signal; measure fresh
            self._take_snapshot()
        self.history.append(report)
        return report

    # ---- observability ------------------------------------------------------
    @property
    def migrating(self) -> bool:
        """True while a relayout is in flight."""
        return self.migrator is not None

    def summary(self) -> Dict:
        """Machine-readable run summary (the reference's BENCH_pr4.json
        `adaptation` block)."""
        adopted = [r for r in self.history if r.phase == "adopted"]
        completed = [r for r in self.history if r.phase == "completed"]
        return {
            "ticks": self.tick_count,
            "epoch": self.client.epoch,
            "adoptions": [
                {"tick": r.tick, "scope": r.delta.scope,
                 "old_mode": int(r.delta.old_mode),
                 "new_mode": int(r.delta.new_mode),
                 "gain_per_round_s": r.delta.gain_s,
                 **{k: float(v) for k, v in r.gate.items()}}
                for r in adopted],
            "completions": [{"tick": r.tick, "chunks": r.total_chunks}
                            for r in completed],
        }
