"""Host-side metrics registry: counters, gauges and log2 histograms
(a copy of ``repro.core.obs.metrics``).

The registry is the numeric plane of the flight recorder
(:mod:`repro_torch.core.obs.recorder`).  It is deliberately tiny — a few
dicts keyed by ``name{label=value,...}`` strings — because every
increment happens on the host inside the client hot path and must cost
no more than a dict lookup.  Nothing here touches torch: device values
are converted by the *caller* (after the span fence has already paid
for the sync) so recording a metric never forces a device round-trip
of its own.

Naming follows the Prometheus convention loosely: monotonically
increasing series end in ``_total`` (counters), instantaneous values
are gauges, and distributions go to histograms with power-of-two
buckets.  The metric names emitted by the instrumented pipeline are
catalogued in ``docs/observability.md``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional


def metric_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical series key: ``name{k=v,...}`` with labels sorted by key.

    Stable label ordering makes the key usable as a plain dict key and
    keeps JSON snapshots diffable across runs.
    """
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def overlap_efficiency(sync_us: float, pipelined_us: float,
                       lower_bound_us: float) -> float:
    """How much of the pipelining headroom a measured round captured.

    ``1.0`` means the pipelined round reached the fabric model's
    pure-bytes lower bound (every µs of gather latency hidden behind the
    collective); ``0.0`` means it did no better than the synchronous
    round.  Clamped to [0, 1] so regressions (pipelined slower than
    sync) and fits whose lower bound exceeds the sync time (degenerate
    headroom) stay plottable rather than exploding the scale — in the
    degenerate case the round scores 1.0 when pipelining did not hurt
    and 0.0 when it did.
    """
    headroom = sync_us - lower_bound_us
    if headroom <= 0:
        return 1.0 if pipelined_us <= sync_us else 0.0
    return min(1.0, max(0.0, (sync_us - pipelined_us) / headroom))


class MetricsRegistry:
    """Counters, gauges and histograms for one recording.

    All three families share the flat ``name{labels}`` key space from
    :func:`metric_key`.  Counters only ever increase (use :meth:`inc`),
    gauges hold the latest value (:meth:`set_gauge`), and histograms
    accumulate counts in power-of-two buckets (:meth:`observe`).
    """

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Dict[str, float]] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels: object) -> None:
        """Add ``value`` to the counter ``name{labels}`` (created at 0)."""
        key = metric_key(name, labels)
        self.counters[key] = self.counters.get(key, 0.0) + float(value)

    def get(self, name: str, **labels: object) -> float:
        """Current value of a counter (0.0 when it was never incremented)."""
        return self.counters.get(metric_key(name, labels), 0.0)

    # -- gauges ------------------------------------------------------------
    def set_gauge(self, name: str, value: float, **labels: object) -> None:
        """Set the gauge ``name{labels}`` to ``value`` (last write wins)."""
        self.gauges[metric_key(name, labels)] = float(value)

    def gauge(self, name: str, **labels: object) -> Optional[float]:
        """Current value of a gauge, or ``None`` when it was never set."""
        return self.gauges.get(metric_key(name, labels))

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, value: float, **labels: object) -> None:
        """Record one sample into the log2 histogram ``name{labels}``.

        Buckets are upper bounds at powers of two (``le_1``, ``le_2``,
        ``le_4``, ...); non-positive samples land in ``le_0``.  The
        running ``count`` and ``sum`` ride along so means can be
        recovered without the raw samples.
        """
        key = metric_key(name, labels)
        h = self.histograms.setdefault(
            key, {"count": 0.0, "sum": 0.0})
        h["count"] += 1.0
        h["sum"] += float(value)
        if value <= 0:
            bucket = "le_0"
        else:
            bucket = f"le_{2 ** max(0, math.ceil(math.log2(value)))}"
        h[bucket] = h.get(bucket, 0.0) + 1.0

    # -- telemetry bridge --------------------------------------------------
    def fold_telemetry(self, telemetry, snapshot=None) -> None:
        """Fold a ``ScopeTelemetry`` snapshot into per-scope gauges.

        This subsumes the host side of the telemetry accumulator: the
        per-scope op mix (``scope_ops{scope,op}``), exchanged data/meta
        words (``scope_words{scope,plane}``), the modeled byte volume
        (``scope_bytes{scope}``) and the budget-overflow pressure share
        (``scope_pressure{scope}``).  Gauges are *set*, not added — the
        telemetry rows are already cumulative, so folding twice is
        idempotent.  Pass ``snapshot`` to reuse a host copy the caller
        already paid to materialize (the adaptation controller does).
        """
        from repro_torch.core.adapt import telemetry as tmod

        snap = snapshot if snapshot is not None else telemetry.snapshot()
        for scope in telemetry.scope_names:
            row = snap[telemetry.row_of(scope)]
            writes = float(row[tmod.F_WRITES])
            reads = float(row[tmod.F_READS])
            metas = float(row[tmod.F_META])
            self.set_gauge("scope_ops", writes, scope=scope, op="write")
            self.set_gauge("scope_ops", reads, scope=scope, op="read")
            self.set_gauge("scope_ops", metas, scope=scope, op="meta")
            words_w = float(row[tmod.F_WORDS_W])
            words_r = float(row[tmod.F_WORDS_R])
            self.set_gauge("scope_words", words_w, scope=scope, plane="write")
            self.set_gauge("scope_words", words_r, scope=scope, plane="read")
            self.set_gauge("scope_bytes", 4.0 * (words_w + words_r),
                           scope=scope)
            total = writes + reads + metas
            if total > 0:
                self.set_gauge("scope_pressure",
                               float(row[tmod.F_PRESSURE]) / total,
                               scope=scope)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict snapshot: ``{"counters", "gauges", "histograms"}``."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: dict(v) for k, v in self.histograms.items()},
        }
