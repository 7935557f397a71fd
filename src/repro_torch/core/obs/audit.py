"""Decision audit log: every consequential pick, with the road not taken
(a copy of ``repro.core.obs.audit``).

The exchange/adapt pipeline makes a handful of decisions that shape
every byte on the fabric — dense vs. compacted
(``exchange_select.pick_backend``), padded all_to_all vs. ppermute
rounds (``pick_mesh_executor``), relayout adoption (``gate_delta``) and
mode re-decision (``propose_deltas``) — plus the silent degradations
(falling back from measured fabric rows to the analytic model).  Each
of those sites now emits a :class:`DecisionRecord` carrying the inputs
it saw, the modeled cost of every alternative it *rejected*, and an
evidence grade in the intent pipeline's vocabulary (``measured`` >
``runtime`` > ``analytic`` > ``fallback``) so a recording explains not
just what the system did but why, and on what grounds.

Records normally land in the active :class:`~.recorder.TraceRecorder`'s
audit ring; when no recorder is active (library code called outside any
client, e.g. the bench loaders at import time) they fall back to the
process-global :data:`GLOBAL_AUDIT` ring so no event is ever dropped.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: evidence grades, strongest first (the intent pipeline's tiers)
EVIDENCE_GRADES = ("measured", "runtime", "analytic", "fallback")


@dataclass(frozen=True)
class DecisionRecord:
    """One audited decision.

    ``kind`` names the decision site (``exchange_backend``,
    ``mesh_executor``, ``gate_delta``, ``redecide``,
    ``crossover_fallback``, ``fabric_fallback``, ``policy_epoch``),
    ``choice`` is the option taken, ``alternatives`` maps every rejected
    option to its modeled cost (same unit as the chosen one, recorded in
    ``inputs``), and ``evidence`` carries ``{"grade", "source", ...}``.
    """

    seq: int
    kind: str
    choice: str
    inputs: Dict[str, object] = field(default_factory=dict)
    alternatives: Dict[str, float] = field(default_factory=dict)
    evidence: Dict[str, object] = field(default_factory=dict)
    ts: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready plain dict (stable key order for diffable exports)."""
        return {
            "seq": self.seq,
            "kind": self.kind,
            "choice": self.choice,
            "inputs": dict(self.inputs),
            "alternatives": dict(self.alternatives),
            "evidence": dict(self.evidence),
            "ts": self.ts,
        }


class DecisionAudit:
    """Bounded ring of :class:`DecisionRecord` (oldest evicted first)."""

    def __init__(self, capacity: int = 4096) -> None:
        self._ring: deque = deque(maxlen=int(capacity))
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, choice: str, *,
               inputs: Optional[Dict[str, object]] = None,
               alternatives: Optional[Dict[str, float]] = None,
               evidence: Optional[Dict[str, object]] = None
               ) -> DecisionRecord:
        """Append one decision and return the stored record."""
        rec = DecisionRecord(
            seq=self._seq, kind=kind, choice=choice,
            inputs=dict(inputs or {}),
            alternatives=dict(alternatives or {}),
            evidence=dict(evidence or {}),
            ts=time.time())
        self._seq += 1
        self._ring.append(rec)
        return rec

    def records(self, kind: Optional[str] = None) -> List[DecisionRecord]:
        """All retained records, optionally filtered by ``kind``."""
        if kind is None:
            return list(self._ring)
        return [r for r in self._ring if r.kind == kind]

    def counts(self) -> Dict[str, int]:
        """Retained record count per kind (for quick summaries)."""
        return dict(Counter(r.kind for r in self._ring))

    def clear(self) -> None:
        """Drop every retained record (the sequence counter keeps going)."""
        self._ring.clear()

    def to_json(self) -> List[Dict[str, object]]:
        """JSON-ready list of all retained records, oldest first."""
        return [r.to_dict() for r in self._ring]


#: process-global fallback ring: decisions made with no recorder active
GLOBAL_AUDIT = DecisionAudit()


def record_decision(kind: str, choice: str, *,
                    inputs: Optional[Dict[str, object]] = None,
                    alternatives: Optional[Dict[str, float]] = None,
                    evidence: Optional[Dict[str, object]] = None
                    ) -> DecisionRecord:
    """Route one decision to the active recorder's audit, else the global.

    Also bumps the ``decisions_total{kind,choice}`` counter on the active
    recorder's metrics registry so decision mix shows up in snapshots
    without walking the ring.
    """
    from repro_torch.core.obs import recorder as _rec

    active = _rec.current_recorder()
    if active is not None:
        active.metrics.inc("decisions_total", kind=kind, choice=choice)
        return active.audit.record(
            kind, choice, inputs=inputs, alternatives=alternatives,
            evidence=evidence)
    return GLOBAL_AUDIT.record(
        kind, choice, inputs=inputs, alternatives=alternatives,
        evidence=evidence)
