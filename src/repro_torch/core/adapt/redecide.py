"""Re-decision: drifted signatures → candidate policy deltas, cost-gated
(a copy of ``repro.core.adapt.redecide``).

A fired drift report hands this module a live per-scope signature; the
signature is synthesized back into the simulator's phase vocabulary
(``phases_from_signature``) and costed under all four layout modes with
the SAME calibrated model the offline oracle uses (``simulate_phase`` —
this is the ``best_scope_modes`` machinery applied to a measured, not
assumed, workload).  The winning mode becomes a ``PolicyDelta`` carrying
its predicted per-round win, and ``gate_delta`` weighs that win over an
adaptation horizon against the cost of physically moving the scope's
stored chunks through the exchange plane.  Only deltas that clear the
gate reach the ``LiveMigrator``.

The migration gate reads the measured fabric model of the committed
benchmark artifacts through ``exchange_select.fabric_model``, as the
reference does, so the port makes the reference's decisions.  The
reference's ``signature_workload`` wraps the synthesized phases in a
``Workload`` for the full intent selector; the port's raises until the
intent pipeline (``core/workloads.py``) is ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import obs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.simulator import (DEFAULT_HW, Hardware, Phase,
                                        simulate_phase)

#: synthesized phase volume (MiB) — only *relative* per-mode times matter
_SYNTH_MIB = 1024.0
#: synthesized metadata op count at full meta share
_SYNTH_META_OPS = 200_000


@dataclass(frozen=True)
class PolicyDelta:
    """One proposed per-scope mode change with its predicted economics."""

    scope: str
    old_mode: LayoutMode
    new_mode: LayoutMode
    predicted_old_s: float        # synthesized round under the old mode
    predicted_new_s: float        # … and under the proposed mode

    @property
    def gain_s(self) -> float:
        """Predicted steady-state win per synthesized round (seconds)."""
        return self.predicted_old_s - self.predicted_new_s


def phases_from_signature(scope: str, sig: np.ndarray,
                          req_kib: float = 1024.0) -> List[Phase]:
    """Synthesize a phase list whose signature matches the live one.

    The inverse of ``telemetry.signature_from_phases`` up to volume: read
    and write bandwidth phases split by read share, reads attributed
    ``written_by="other"`` when the measured locality says the scope reads
    across ranks, sequential vs random from the stride signature, plus a
    metadata phase when the meta share is material.
    """
    read_share, meta_share, locality, seq, _, extent = \
        np.asarray(sig, np.float64)
    pattern = "seq" if seq >= 0.5 else "random"
    phases: List[Phase] = []
    if (1.0 - read_share) > 0.05:
        phases.append(Phase("bw", op="write", topology="NN",
                            pattern=pattern, req_kib=req_kib,
                            total_mib=_SYNTH_MIB * (1.0 - read_share),
                            scope=scope))
    if read_share > 0.05:
        phases.append(Phase("bw", op="read", topology="NN",
                            pattern=pattern, req_kib=req_kib,
                            total_mib=_SYNTH_MIB * read_share,
                            written_by="self" if locality >= 0.5
                            else "other",
                            cross_rank=max(0.0, 1.0 - locality),
                            scope=scope))
    if meta_share > 0.02:
        phases.append(Phase("meta", n_ops=int(_SYNTH_META_OPS * meta_share),
                            meta_mix={"create": 0.4, "stat": 0.6},
                            dir_pattern="unique" if extent < 0.75
                            else "shared",
                            cross_rank=max(0.0, 1.0 - locality),
                            scope=scope))
    return phases


def mode_times(phases: List[Phase], n_nodes: int,
               hw: Hardware = DEFAULT_HW,
               seed: int = 0) -> Dict[LayoutMode, float]:
    """Synthesized-round time of one phase group under every mode."""
    return {m: sum(simulate_phase(p, m, n_nodes, hw, seed + i).time_s
                   for i, p in enumerate(phases))
            for m in LayoutMode}


def propose_deltas(policy, live: Dict[str, Tuple[np.ndarray, float]],
                   hw: Hardware = DEFAULT_HW,
                   seed: int = 0) -> List[PolicyDelta]:
    """Candidate mode changes for the drifted scopes, best-mode first.

    ``live`` maps scope name → (signature, op-volume weight); scopes whose
    measured-best mode equals their current mode produce no delta.  Every
    scope costing emits a ``redecide`` audit record carrying the full
    per-mode time table — the alternatives the winner beat.
    """
    out = []
    for scope, (sig, _w) in live.items():
        phases = phases_from_signature(scope, sig)
        if not phases:
            continue
        times = mode_times(phases, policy.n_nodes, hw, seed)
        best = min(times, key=times.get)
        cur = policy.mode_for_path(scope)
        obs.record_decision(
            "redecide", best.name,
            inputs={"scope": scope, "current": cur.name,
                    "chosen_s": times[best], "n_phases": len(phases),
                    "signature": [float(x) for x in np.asarray(sig)]},
            alternatives={m.name: t for m, t in times.items() if m != best},
            evidence={"grade": "runtime",
                      "source": "telemetry-signature+simulator"})
        if best != cur:
            out.append(PolicyDelta(scope, cur, best, times[cur],
                                   times[best]))
    return sorted(out, key=lambda d: -d.gain_s)


#: engine collectives per migrate_rows installment (old fetch, new-epoch
#: stat, probe, copy, meta move ×2, tombstone ×3 — a ceiling)
_COLLECTIVES_PER_INSTALLMENT = 12.0


def _resolve_fabric(hw: Hardware,
                    fabric: Optional[Tuple[float, float]]
                    ) -> Optional[Tuple[float, float]]:
    """The ONE measured-vs-analytic decision for the migration cost.

    An explicit ``fabric`` wins; an explicit (non-default) ``hw`` means
    the caller chose the analytic model, so on-disk artifacts never
    override it; otherwise the measured fabric model applies when bench
    rows exist.  ``migration_cost_s`` and ``gate_delta``'s audit flag
    both go through here, so the flag can never disagree with the cost
    path actually taken.
    """
    if fabric is not None:
        return fabric
    if hw is not DEFAULT_HW:
        return None
    from repro_torch.core import exchange_select
    a_us, bpu, measured = exchange_select.fabric_model()
    return (a_us, bpu) if measured else None


def migration_cost_s(n_chunks: int, words: int, n_nodes: int,
                     hw: Hardware = DEFAULT_HW,
                     fabric: Optional[Tuple[float, float]] = None,
                     step_chunks: Optional[int] = None) -> float:
    """Modeled wall cost of relocating ``n_chunks`` stored chunks.

    Each migrated chunk crosses the fabric twice (old-owner fetch + new-
    owner ship); on top of the payload bytes every ``migrate_rows``
    installment (``step_chunks`` rows, the ``LiveMigrator`` default when
    omitted) pays a fixed number of collective launches.  When the
    committed bench JSON carries measured ``fabric`` rows (the real
    ``all_to_all`` timings — ``exchange_select.fabric_model``), the
    estimate uses that deployment's measured bytes/µs and per-collective
    overhead; with a non-default ``hw`` — an explicit caller model — or
    no measured rows, the analytic ``Hardware`` path applies (NIC
    bandwidth + per-chunk RPC cost), so a passed-in model is never
    silently overridden by on-disk artifacts.  ``fabric`` forces the
    measured path with the given (overhead µs, bytes/µs) — mainly for
    tests.  Deliberately a *ceiling*-flavored estimate either way — the
    gate should err toward keeping a marginal layout, not toward
    migration churn.
    """
    fabric = _resolve_fabric(hw, fabric)
    if fabric is not None:
        from repro_torch.core.adapt.migrate import DEFAULT_STEP_CHUNKS
        a_us, bpu = fabric
        payload_bytes = n_chunks * words * 4 * 2
        n_coll = _COLLECTIVES_PER_INSTALLMENT * max(
            1.0, n_chunks / float(step_chunks or DEFAULT_STEP_CHUNKS))
        return (payload_bytes / max(bpu, 1e-9) + n_coll * a_us) / 1e6
    payload_mib = n_chunks * words * 4 * 2 / (1 << 20)
    net_s = payload_mib / max(hw.net_mibs * n_nodes, 1e-9)
    rpc_s = n_chunks * n_nodes * hw.rpc_ms / 1e3 / max(n_nodes, 1)
    return net_s + rpc_s


def gate_delta(delta: PolicyDelta, n_chunks: int, words: int,
               n_nodes: int, horizon_rounds: float,
               hw: Hardware = DEFAULT_HW,
               step_chunks: Optional[int] = None
               ) -> Tuple[bool, Dict[str, float]]:
    """Cost/benefit gate: adopt iff the horizon win covers the move.

    Returns (adopt, audit dict).  ``horizon_rounds`` is how many
    synthesized steady-state rounds the new layout is expected to serve —
    the controller's stand-in for remaining job length; ``step_chunks``
    is the driver's installment size (cost-model collective count).  The
    audit's ``fabric_measured`` flag records whether the cost side came
    from the measured fabric model or the analytic fallback.
    """
    measured = _resolve_fabric(hw, None) is not None
    cost = migration_cost_s(n_chunks, words, n_nodes, hw,
                            step_chunks=step_chunks)
    win = delta.gain_s * horizon_rounds
    adopt = win > cost
    audit = {"migration_cost_s": cost, "horizon_win_s": win,
             "gain_per_round_s": delta.gain_s,
             "n_chunks": float(n_chunks),
             "fabric_measured": float(measured)}
    obs.record_decision(
        "gate_delta", "adopt" if adopt else "reject",
        inputs={"scope": delta.scope, "old_mode": delta.old_mode.name,
                "new_mode": delta.new_mode.name,
                "horizon_rounds": float(horizon_rounds), **audit},
        alternatives=({"reject": win} if adopt else {"adopt": cost}),
        evidence={"grade": "measured" if measured else "analytic",
                  "source": "fabric_model"})
    return adopt, audit


def signature_workload(scope: str, sig: np.ndarray, n_nodes: int):
    """The drifted signature as a ``Workload`` for the full selector path.

    Not ported yet: it needs ``core/workloads.py`` and the intent
    selector, which come with the intent pipeline (ROADMAP Queue 1
    item 6).
    """
    raise NotImplementedError(
        "signature_workload needs core/workloads.py and the intent "
        "selector, not ported yet (ROADMAP Queue 1 item 6: the intent "
        f"pipeline); scope {scope!r}, {n_nodes} nodes")
