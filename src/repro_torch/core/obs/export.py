"""Recording exporters: Perfetto trace JSON, metrics snapshots, provenance
(twin of ``repro.core.obs.export``).

One recording file carries all three planes so a single artifact is
both machine-readable (``tools/bbstat.py``) and directly loadable in
https://ui.perfetto.dev — the Chrome trace-event format tolerates extra
top-level keys, so ``metrics``, ``audit`` and ``meta`` ride alongside
``traceEvents``::

    {"traceEvents": [...], "metrics": {...}, "audit": [...], "meta": {...}}

The layout is the reference's, key for key, so ``tools/bbstat.py`` reads a
capture of the port as it reads one of the JAX package.
:func:`provenance_meta` records the torch and CUDA versions and the card's
name where the reference records jax's version and device kind.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
from typing import Dict, List, Optional

import torch

from repro_torch.core.obs.recorder import TraceRecorder

#: provenance schema of the port's recordings
SCHEMA_VERSION = 2

#: provenance keys of every recording's ``meta`` block
PROVENANCE_KEYS = ("schema_version", "git_sha", "torch_version",
                   "cuda_version", "device_kind", "warm_passes")


def trace_events(recorder: TraceRecorder) -> List[Dict[str, object]]:
    """Chrome trace-event list: one complete ("X") event per span.

    All spans share one pid/tid track; nesting is implied by timestamp
    containment, which the recorder's stack discipline guarantees.
    """
    events: List[Dict[str, object]] = []
    for sp in recorder.spans:
        events.append({
            "name": sp.name,
            "cat": sp.cat,
            "ph": "X",
            "ts": round(sp.ts_us, 3),
            "dur": round(max(sp.dur_us, 0.0), 3),
            "pid": 0,
            "tid": 0,
            "args": dict(sp.args, depth=sp.depth),
        })
    return events


def recording_dict(recorder: TraceRecorder,
                   meta: Optional[Dict[str, object]] = None
                   ) -> Dict[str, object]:
    """Assemble the full recording: spans + metrics + audit + meta."""
    return {
        "traceEvents": trace_events(recorder),
        "displayTimeUnit": "ms",
        "metrics": recorder.metrics.snapshot(),
        "audit": recorder.audit.to_json(),
        "meta": dict(meta) if meta else provenance_meta(),
    }


def write_recording(recorder: TraceRecorder, path,
                    meta: Optional[Dict[str, object]] = None) -> pathlib.Path:
    """Write the recording JSON to ``path`` and return it."""
    p = pathlib.Path(path)
    p.write_text(json.dumps(recording_dict(recorder, meta), indent=1))
    return p


def _git_sha() -> Optional[str]:
    root = pathlib.Path(__file__).resolve().parents[4]
    try:
        out = subprocess.run(
            ["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def provenance_meta(warm_passes: Optional[int] = None,
                    **extra: object) -> Dict[str, object]:
    """Provenance block of a recording: schema, git SHA, torch and CUDA
    versions, and the card's name (``"cpu"`` where no card is present).

    A checkout without git gives ``git_sha: None`` rather than raising:
    provenance is never the reason a run fails.
    """
    cuda = torch.cuda.is_available()
    meta: Dict[str, object] = {
        "schema_version": SCHEMA_VERSION,
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "warm_passes": warm_passes,
    }
    meta.update(extra)
    return meta
