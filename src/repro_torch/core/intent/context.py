"""Hybrid context: the unified structured profile (Fig. 5).

A copy of ``repro.core.intent.context``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.intent.probe import RuntimeStats
from repro_torch.core.intent.static_extractor import StaticFeatures


@dataclass
class HybridContext:
    """The unified structured profile fed to the reasoner (paper Fig. 5).

    Merges the static source/script features with the optional runtime
    probe stats; every property below implements one consolidation rule
    of §III-C (runtime evidence wins, static hints fill the gaps).
    """
    app: str
    static: StaticFeatures
    runtime: Optional[RuntimeStats]      # None under the w/o-Runtime ablation
    n_nodes: int = 32

    # ---- consolidated evidence (merging rules of §III-C) -------------------
    @property
    def topology(self) -> str:
        """File-sharing topology: "N-1", "N-N" or "unknown".

        Confidence-weighted merge: observed shared-file traffic overrides
        the static hint only when the hint is weak — unknown, or carried
        by low-confidence (regex-tier) evidence.  A dataflow-proven hint
        (confidence ≥ 0.8) stands even against noisy probe counters.
        """
        if self.runtime is not None and self.runtime.shared_file_ops > 0 and \
                (self.static.topology_hint == "unknown" or
                 self.static.confidence("topology_hint") < 0.8):
            return "N-1"
        return self.static.topology_hint

    @property
    def read_ratio(self) -> float:
        """Fraction of read ops (runtime-measured, else static hints)."""
        if self.runtime is not None:
            return self.runtime.read_ratio
        # static fallback: direction hint + script read_pct
        pct = self.static.bench_params.get("read_pct")
        if pct is not None:
            return int(pct) / 100.0
        return {"write": 0.05, "read": 0.95, "mixed": 0.5}.get(
            self.static.direction_hint, 0.5)

    @property
    def meta_share(self) -> float:
        """Fraction of metadata ops among all I/O calls."""
        if self.runtime is not None:
            return self.runtime.meta_share
        if self.static.meta_intensity == "high":
            # pure-metadata kernels (no data calls) vs meta-laced data loops
            return 0.45 if self.static.has_data_calls else 0.7
        return {"low": 0.02, "medium": 0.15}[self.static.meta_intensity]

    @property
    def small_requests(self) -> bool:
        """Dominant request size ≤ 64 KiB."""
        if self.runtime is not None and self.runtime.dominant_req_kib:
            return self.runtime.dominant_req_kib <= 64
        return self.static.small_requests

    @property
    def latency_sensitive(self) -> bool:
        """Tiny requests with real metadata traffic → latency-bound."""
        if self.runtime is not None and self.runtime.dominant_req_kib:
            return (self.runtime.dominant_req_kib <= 1.0
                    and self.runtime.meta_share > 0.05)
        return self.static.latency_sensitive

    @property
    def cross_rank_read(self) -> bool:
        """Ranks read data other ranks wrote (Mode-1 poison)."""
        if self.runtime is not None:
            return self.runtime.cross_rank_ops > 0 or \
                self.static.cross_rank_read
        return self.static.cross_rank_read

    @property
    def shared_file(self) -> bool:
        """At least one file is touched by several ranks."""
        if self.runtime is not None:
            return self.runtime.shared_file_ops > 0 or self.static.shared_file
        return self.static.shared_file

    @property
    def multi_phase(self) -> bool:
        """The job has more than one distinct I/O phase."""
        if self.runtime is not None:
            return self.runtime.n_phases > 1 or self.static.multi_phase
        return self.static.multi_phase

    @property
    def meta_mix(self) -> Dict[str, float]:
        """Per-op metadata distribution (empty without runtime stats)."""
        if self.runtime is not None and self.runtime.meta_mix:
            return self.runtime.meta_mix
        return {}

    # ---- Fig.5-style JSON ---------------------------------------------------
    def to_json(self) -> str:
        """Serialize the profile as the Fig.5-style JSON prompt block."""
        payload = {
            "bench_params": self.static.bench_params,
            "static_features": {
                "access_pattern": self.static.access_pattern,
                "topology_hint": self.static.topology_hint,
                "collective_io": self.static.collective_io,
                "rank_indexed_files": self.static.rank_indexed_files,
                "dir_pattern": self.static.dir_pattern,
                "meta_intensity": self.static.meta_intensity,
                "multi_phase": self.static.multi_phase,
                "phase_pattern": self.static.phase_pattern,
                "cross_rank_read": self.static.cross_rank_read,
            },
            "runtime_stats": (self.runtime.to_darshan_dict()
                              if self.runtime is not None else
                              "UNAVAILABLE (static-only ablation)"),
            "scale": {"n_nodes": self.n_nodes, "ppn": self.static.ppn},
        }
        evidence = self.static.provenance_dict()
        if evidence:
            payload["evidence"] = evidence
        return json.dumps(payload, indent=2)


#: Alias used by callers that think of the profile as a portable pack
#: of evidence rather than a live merge object.
ContextPack = HybridContext
