"""EWMA drift detection over intent signatures, with hysteresis (a copy
of ``repro.core.adapt.drift``).

The detector answers one question per scope per tick: *has the live
workload diverged from the workload the layout decision was made from,
persistently enough to be worth acting on?*  Three guards keep it from
thrashing:

* **EWMA smoothing** — the live signature is folded into an exponentially
  weighted moving average, so one bursty batch cannot flip the verdict;
* **patience** — the smoothed divergence must exceed the threshold for
  ``patience`` *consecutive* ticks before the detector fires;
* **cooldown** — after a fire (whether the re-decision was adopted or
  rejected) the scope is silenced for ``cooldown`` ticks, so the
  re-decision pipeline is never invoked inside its own settling window
  (and a just-migrated scope gets time to rebuild its signature against
  the new baseline).

Divergence is a weighted L1 distance over the 6 signature dimensions
(weights de-emphasize the pressure/extent proxies, which have no exact
probe-side counterpart — see telemetry.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import obs
from repro_torch.core.adapt.telemetry import SIG_NAMES


@dataclass
class DriftConfig:
    """Knobs of the divergence test and its hysteresis."""

    alpha: float = 0.4            # EWMA weight of the newest tick
    threshold: float = 0.15       # weighted-L1 divergence that arms a scope
    patience: int = 2             # consecutive armed ticks before firing
    cooldown: int = 3             # silent ticks after a fire / rebase
    min_weight: float = 8.0       # ops below which a tick carries no signal
    weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.6, 0.4, 0.25)


@dataclass
class DriftReport:
    """One scope's verdict for one tick."""

    scope: str
    divergence: float
    armed: int                    # consecutive over-threshold ticks so far
    fired: bool                   # hysteresis satisfied — re-decide now
    cooling: int                  # remaining cooldown ticks (0 = live)
    ewma: Optional[np.ndarray] = None
    baseline: Optional[np.ndarray] = None


@dataclass
class _ScopeState:
    ewma: Optional[np.ndarray] = None
    armed: int = 0
    cooling: int = 0


@dataclass
class DriftDetector:
    """Per-scope EWMA divergence tracker (one instance per controller)."""

    baseline: Dict[str, np.ndarray] = field(default_factory=dict)
    cfg: DriftConfig = field(default_factory=DriftConfig)
    _state: Dict[str, _ScopeState] = field(default_factory=dict)

    def _weights(self) -> np.ndarray:
        w = np.asarray(self.cfg.weights, np.float64)
        assert w.shape == (len(SIG_NAMES),)
        return w

    def divergence(self, scope: str, sig: np.ndarray) -> float:
        """Weighted-L1 distance of ``sig`` from the scope's baseline."""
        base = self.baseline.get(scope)
        if base is None:
            return 0.0
        w = self._weights()
        return float((w * np.abs(np.asarray(sig) - base)).sum() / w.sum())

    @staticmethod
    def _metric(scope: str, outcome: str, div: float,
                st: "_ScopeState") -> None:
        """Publish one tick's hysteresis state to the active recorder.

        Counters (``drift_ticks_total{scope,outcome}``,
        ``drift_fired_total{scope}``) and gauges (``drift_armed``,
        ``drift_cooling``, ``drift_divergence``) expose exactly the
        hysteresis evolution the private ``_ScopeState`` holds, so tests
        and dashboards never need to peek at EWMA internals.
        """
        m = obs.current_metrics()
        if m is None:
            return
        m.inc("drift_ticks_total", scope=scope, outcome=outcome)
        if outcome == "fired":
            m.inc("drift_fired_total", scope=scope)
        m.set_gauge("drift_armed", float(st.armed), scope=scope)
        m.set_gauge("drift_cooling", float(st.cooling), scope=scope)
        m.set_gauge("drift_divergence", float(div), scope=scope)

    def observe(self, scope: str, sig: np.ndarray,
                weight: float) -> DriftReport:
        """Fold one tick's live signature in; return the scope verdict.

        A scope with no registered baseline adopts this signature as its
        baseline (self-calibration on the first observed tick) and cannot
        fire.  Low-volume ticks (< ``min_weight`` ops) neither advance nor
        reset the armed counter — silence is not evidence of stability.
        Each tick's outcome lands on the active recorder's metrics (see
        :meth:`_metric`).
        """
        st = self._state.setdefault(scope, _ScopeState())
        if weight < self.cfg.min_weight:
            if st.cooling:
                st.cooling -= 1
            self._metric(scope, "low_weight", 0.0, st)
            return DriftReport(scope, 0.0, st.armed, False, st.cooling)
        sig = np.asarray(sig, np.float64)
        if self.baseline.get(scope) is None:
            self.baseline[scope] = sig.copy()
            st.ewma = sig.copy()
            self._metric(scope, "baseline_init", 0.0, st)
            return DriftReport(scope, 0.0, 0, False, st.cooling,
                               st.ewma, self.baseline[scope])
        a = self.cfg.alpha
        st.ewma = sig.copy() if st.ewma is None else \
            a * sig + (1 - a) * st.ewma
        div = self.divergence(scope, st.ewma)
        if st.cooling:
            st.cooling -= 1
            st.armed = 0
            self._metric(scope, "cooling", div, st)
            return DriftReport(scope, div, 0, False, st.cooling, st.ewma,
                               self.baseline[scope])
        st.armed = st.armed + 1 if div > self.cfg.threshold else 0
        fired = st.armed >= self.cfg.patience
        self._metric(scope,
                     "fired" if fired else
                     "armed" if st.armed else "quiet", div, st)
        return DriftReport(scope, div, st.armed, fired, 0, st.ewma,
                           self.baseline[scope])

    def rebase(self, scope: str, sig: Optional[np.ndarray] = None) -> None:
        """Adopt a new baseline (after a re-decision) and start cooldown.

        Called whether the proposal was adopted or gated away — either
        way the detector must not re-fire on the same evidence next tick.
        """
        st = self._state.setdefault(scope, _ScopeState())
        if sig is not None:
            self.baseline[scope] = np.asarray(sig, np.float64).copy()
        elif st.ewma is not None:
            self.baseline[scope] = st.ewma.copy()
        st.armed = 0
        st.cooling = self.cfg.cooldown
        m = obs.current_metrics()
        if m is not None:
            m.inc("drift_rebase_total", scope=scope)
            m.set_gauge("drift_armed", 0.0, scope=scope)
            m.set_gauge("drift_cooling", float(st.cooling), scope=scope)
