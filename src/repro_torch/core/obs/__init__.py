"""Observability layer: flight recorder, metrics registry, decision audit
(twin of ``repro.core.obs``).

Public surface of ``repro_torch.core.obs`` — the single source of timing
truth for the exchange/adapt pipeline:

* :class:`TraceRecorder` / :func:`span` / :func:`activate` — bounded
  span ring with stream-synchronised (fenced) timing
  (:mod:`~repro_torch.core.obs.recorder`);
* :class:`MetricsRegistry` — counters/gauges/histograms
  (:mod:`~repro_torch.core.obs.metrics`);
* :class:`DecisionAudit` / :func:`record_decision` — every
  selector/gating choice with rejected-alternative costs and evidence
  grades (:mod:`~repro_torch.core.obs.audit`);
* :func:`write_recording` / :func:`provenance_meta` — Perfetto-loadable
  export and the recording's provenance block
  (:mod:`~repro_torch.core.obs.export`).

Everything is off by default: with no active recorder each
instrumentation point costs one truthiness check.
"""
from repro_torch.core.obs.audit import (
    EVIDENCE_GRADES,
    GLOBAL_AUDIT,
    DecisionAudit,
    DecisionRecord,
    record_decision,
)
from repro_torch.core.obs.export import (
    PROVENANCE_KEYS,
    SCHEMA_VERSION,
    provenance_meta,
    recording_dict,
    trace_events,
    write_recording,
)
from repro_torch.core.obs.metrics import (
    MetricsRegistry,
    metric_key,
    overlap_efficiency,
)
from repro_torch.core.obs.recorder import (
    Span,
    SpanHandle,
    TraceRecorder,
    activate,
    block_on,
    current_metrics,
    current_recorder,
    span,
    trace_span,
)

__all__ = [
    "DecisionAudit",
    "DecisionRecord",
    "EVIDENCE_GRADES",
    "GLOBAL_AUDIT",
    "MetricsRegistry",
    "PROVENANCE_KEYS",
    "SCHEMA_VERSION",
    "Span",
    "SpanHandle",
    "TraceRecorder",
    "activate",
    "block_on",
    "current_metrics",
    "current_recorder",
    "metric_key",
    "overlap_efficiency",
    "provenance_meta",
    "record_decision",
    "recording_dict",
    "span",
    "trace_span",
    "trace_events",
    "write_recording",
]
