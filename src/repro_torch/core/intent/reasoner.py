"""Knowledge-augmented layout reasoning (§III-C.b/c).

``LLMBackend`` is the pluggable interface an external hosted model
(Qwen3-235B etc.) implements — it receives the Fig-6 prompt and returns the
decision JSON.  The offline default, ``KnowledgeReasoner``, executes the SAME
four-step derivation the prompt enforces (topology → intensity → direction →
phase behavior) as a deterministic rule program over the hybrid context and
the knowledge base.  Every decision carries the full prompt, the step trace,
a confidence score and a risk analysis; low confidence falls back to Mode 3.

Ablation switches mirror Table III:
* ``use_runtime=False``   — context built from static artifacts only,
* ``use_app_ref=False``   — application-level KB entries withheld,
* ``use_mode_know=False`` — mode-level architectural KB withheld; the
  reasoner retains only surface-level mode naming (locality for writes,
  centralization for metadata, hashing as default, "hybrid" for explicitly
  multi-phase mixes) and loses the asymmetric Mode-4 insights.

A copy of ``repro.core.intent.reasoner``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Protocol

from repro_torch.core.intent.context import HybridContext
from repro_torch.core.intent.knowledge import (app_create_buffering,
                                         app_expects_reread)
from repro_torch.core.layouts import DEFAULT_MODE, LayoutMode

CONFIDENCE_FALLBACK = 0.60


@dataclass
class Decision:
    """One layout decision: mode, confidence, topology and the reasoning
    steps that led to it (rendered into the decision JSON).
    """
    mode: LayoutMode
    confidence: float
    io_topology: str
    steps: List[str] = field(default_factory=list)
    risk: str = ""
    fallback_applied: bool = False

    def to_json(self) -> str:
        """Serialize as the Fig-6 decision-JSON contract."""
        return json.dumps({
            "selected_mode": f"Mode {int(self.mode)}",
            "confidence_score": round(self.confidence, 2),
            "io_topology": self.io_topology,
            "primary_reason": " -> ".join(self.steps),
            "risk_analysis": self.risk,
            "fallback_applied": self.fallback_applied,
        }, indent=2)


class LLMBackend(Protocol):
    """Anything that can answer a Fig-6 prompt with decision JSON."""
    def complete(self, prompt: str) -> str:
        """Returns the decision JSON for a Fig-6 prompt."""
        ...


class ExternalLLMBackend:
    """Adapter for a hosted LLM (requires network; not used offline)."""

    def __init__(self, call_fn):
        self._call = call_fn

    def complete(self, prompt: str) -> str:
        """Forward the prompt to the injected callable."""
        return self._call(prompt)


# ---------------------------------------------------------------------------
# the deterministic knowledge reasoner
# ---------------------------------------------------------------------------
class KnowledgeReasoner:
    """Deterministic stand-in for the paper's LLM reasoner.

    Encodes the mode-knowledge cards as explicit rules over the hybrid
    context; the ablation flags drop the app-reference / mode-knowledge
    evidence exactly like the paper's w/o-AppRef and w/o-ModeKnow runs.
    """
    def __init__(self, *, use_app_ref: bool = True, use_mode_know: bool = True):
        self.use_app_ref = use_app_ref
        self.use_mode_know = use_mode_know

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _read_evidence(ctx: HybridContext) -> bool:
        """Any direct evidence that written data is read back."""
        if ctx.runtime is not None:
            ops = ctx.runtime.posix_reads + ctx.runtime.posix_writes
            if ops and ctx.runtime.posix_reads / ops > 0.02:
                return True
        return ctx.read_ratio > 0.02 or ctx.cross_rank_read

    def reason(self, ctx: HybridContext) -> Decision:
        """Apply the rule cascade to one profile → a mode Decision."""
        steps: List[str] = []
        topo = ctx.topology
        rr = ctx.read_ratio
        meta = ctx.meta_share
        steps.append(f"topology={topo} (shared_file={ctx.shared_file}, "
                     f"rank_indexed={ctx.static.rank_indexed_files})")
        steps.append(f"intensity: meta_share={meta:.2f} "
                     f"({'metadata' if meta >= 0.25 else 'bandwidth'}-bound)")
        steps.append(f"direction: read_ratio={rr:.2f}")
        steps.append(f"phases: multi={ctx.multi_phase}, "
                     f"pattern={ctx.static.phase_pattern}, "
                     f"cross_rank_read={ctx.cross_rank_read}")

        d = self._decide(ctx, topo, rr, meta, steps)
        if d.confidence < CONFIDENCE_FALLBACK and d.mode != DEFAULT_MODE:
            steps.append(f"confidence {d.confidence:.2f} < "
                         f"{CONFIDENCE_FALLBACK}: fallback to Mode 3")
            return Decision(DEFAULT_MODE, d.confidence, d.io_topology,
                            steps, d.risk, fallback_applied=True)
        return d

    # -- the four-step rule program -------------------------------------------
    def _decide(self, ctx, topo, rr, meta, steps) -> Decision:
        mk = self.use_mode_know
        mix = ctx.meta_mix
        creates = mix.get("create", 0.0)
        if not mix and ctx.static.create_heavy:
            creates = 0.6                      # static structural evidence

        # ---- A: metadata-dominant ------------------------------------------
        if meta >= 0.25:
            pure = meta >= 0.6
            dirp = ctx.static.dir_pattern
            if pure:
                if dirp in ("shared", "deep"):
                    steps.append("pure metadata on shared/deep namespace -> "
                                 "centralized arbitration (Mode 2)")
                    return Decision(LayoutMode.CENTRAL_META, 0.92, topo, steps,
                                    "Mode 2 md-subset may cap N-N bandwidth")
                if mk and (creates >= 0.3 or
                           (self.use_app_ref and
                            app_create_buffering(ctx.app))):
                    steps.append("unique-dir create-heavy metadata -> local "
                                 "create buffering + global index (Mode 4)")
                    return Decision(LayoutMode.HYBRID, 0.86, topo, steps,
                                    "Mode 4 jitter under small random I/O")
                steps.append("metadata-dominant (no layout-specific "
                             "buffering insight) -> centralize (Mode 2)")
                return Decision(LayoutMode.CENTRAL_META, 0.7, topo, steps,
                                "may forgo local-buffer create throughput")
            # mixed metadata + data
            if ctx.latency_sensitive and dirp in ("shared", "deep"):
                steps.append("latency-critical tiny records with metadata "
                             "on shared namespace -> stable arbitration "
                             "(Mode 2)")
                return Decision(LayoutMode.CENTRAL_META, 0.76, topo, steps,
                                "Mode 4 local writes could win if "
                                "write-heavy")
            if mk and creates >= 0.3:
                steps.append("mixed data+metadata, create-heavy -> "
                             "write-local buffering (Mode 4)")
                return Decision(LayoutMode.HYBRID, 0.78, topo, steps,
                                "Mode 4 md-sync tax on pure bandwidth")
            if mk and ctx.small_requests and 0.3 < rr < 0.7:
                steps.append("small segmented R/W with metadata pressure -> "
                             "local write buffering + global index (Mode 4)")
                return Decision(LayoutMode.HYBRID, 0.72, topo, steps,
                                "metadata sync tax")
            steps.append("mixed metadata pressure -> centralize (Mode 2)")
            return Decision(LayoutMode.CENTRAL_META, 0.72, topo, steps,
                            "centralization may serialize data path")

        # ---- phase-structure rule (direct Mode-4 signature) -----------------
        if ctx.multi_phase and \
                ctx.static.phase_pattern == "write_then_read" and \
                ctx.static.cross_rank_read:
            steps.append("write burst then cross-rank read (static control "
                         "flow) -> local writes + globally visible metadata "
                         "(Mode 4)")
            return Decision(LayoutMode.HYBRID, 0.9, topo, steps,
                            "restart reads pay one redirect RPC")

        # ---- B1: write-dominant ---------------------------------------------
        if rr <= 0.3:
            if topo == "N-N" and not ctx.shared_file:
                if ctx.static.cross_rank_read:
                    steps.append("N-N write with later cross-rank reads -> "
                                 "Mode 4")
                    return Decision(LayoutMode.HYBRID, 0.85, topo, steps,
                                    "slightly lower burst bandwidth than "
                                    "Mode 1")
                steps.append("independent N-N sequential write burst -> "
                             "node-local isolation (Mode 1)")
                return Decision(LayoutMode.NODE_LOCAL, 0.95, topo, steps,
                                "catastrophic if data is read cross-node "
                                "later")
            # N-1 / shared write-dominant
            if self._read_evidence(ctx):
                if mk or ctx.multi_phase:
                    steps.append("shared write burst with observed "
                                 "read-back -> local slabs + global index "
                                 "(Mode 4)")
                    return Decision(LayoutMode.HYBRID, 0.84, topo, steps,
                                    "multi-writer shared files need "
                                    "redirect fallback")
                steps.append("write-dominant -> locality instinct (Mode 1, "
                             "no architectural knowledge)")
                return Decision(LayoutMode.NODE_LOCAL, 0.65, topo, steps, "")
            if mk and self.use_app_ref and app_expects_reread(ctx.app):
                steps.append(f"N-1 write burst; {ctx.app} checkpoints are "
                             "re-read in later phases (app KB) -> Mode 4")
                return Decision(LayoutMode.HYBRID, 0.82, topo, steps,
                                "if restart never happens, Mode 1 writes "
                                "faster")
            steps.append("N-1 write burst, no read-back evidence -> global "
                         "consistency (Mode 2)")
            return Decision(LayoutMode.CENTRAL_META, 0.72, topo, steps,
                            "forgoes write-local bandwidth")

        # ---- B2: read-dominant ----------------------------------------------
        if rr >= 0.7:
            random_access = (ctx.static.access_pattern == "random" or
                             (ctx.runtime is not None and
                              ctx.runtime.posix_seq_ratio < 0.5))
            if random_access and ctx.small_requests:
                steps.append("read-dominant random small I/O -> "
                             "coordination-free spread (Mode 3)")
                return Decision(LayoutMode.DIST_HASH, 0.85, topo, steps,
                                "no locality exploitation")
            steps.append("read-dominant sequential shared access -> "
                         "centralized namespace resolution (Mode 2)")
            return Decision(LayoutMode.CENTRAL_META, 0.85, topo, steps,
                            "md subset must scale with readers")

        # ---- B3: balanced mixed ----------------------------------------------
        if ctx.latency_sensitive and (ctx.shared_file or
                                      ctx.static.dir_pattern == "shared"):
            steps.append("latency-sensitive tiny records on shared "
                         "namespace -> stable arbitration (Mode 2)")
            return Decision(LayoutMode.CENTRAL_META, 0.74, topo, steps,
                            "Mode 4 local writes could win if write-heavy")
        if ctx.multi_phase and ctx.static.shared_file and \
                ctx.static.direction_hint in ("write", "mixed") and \
                ctx.static.phase_pattern == "write_then_read":
            steps.append("multi-phase shared-file write+read sections -> "
                         "write-local slabs + global index (Mode 4)")
            return Decision(LayoutMode.HYBRID, 0.72, topo, steps,
                            "jitter at large node counts")
        if ctx.shared_file and ctx.static.access_pattern == "random" and \
                meta < 0.05:
            steps.append("balanced shared-file random R/W -> no structural "
                         "winner; spread (Mode 3)")
            return Decision(LayoutMode.DIST_HASH, 0.55, topo, steps,
                            "near-tie between Mode 3 and Mode 4 at this "
                            "read ratio")
        if meta >= 0.05 and (mk or ctx.multi_phase):
            steps.append("balanced mix with metadata pressure -> write-local"
                         " + hashed metadata (Mode 4)")
            return Decision(LayoutMode.HYBRID, 0.72, topo, steps,
                            "jitter at large node counts")
        steps.append("balanced mix, no dominant signal -> fail-safe "
                     "(Mode 3)")
        return Decision(DEFAULT_MODE, 0.5, topo, steps, "")


class KnowledgeReasonerBackend:
    """LLMBackend adapter: parse the context back out of the prompt is not
    needed — the selector passes the context alongside; this adapter exists
    so the reasoner can stand wherever an LLM backend is expected."""

    def __init__(self, reasoner: KnowledgeReasoner, ctx: HybridContext):
        self.reasoner = reasoner
        self.ctx = ctx

    def complete(self, prompt: str) -> str:
        """Answer with the deterministic reasoner's decision JSON."""
        return self.reasoner.reason(self.ctx).to_json()


def parse_decision(text: str) -> Decision:
    """Parse a backend's JSON reply into a Decision (robust to chatter)."""
    start, end = text.find("{"), text.rfind("}")
    obj = json.loads(text[start:end + 1])
    mode = LayoutMode(int(str(obj["selected_mode"]).strip().split()[-1]))
    return Decision(mode, float(obj.get("confidence_score", 0.5)),
                    obj.get("io_topology", "?"),
                    [obj.get("primary_reason", "")],
                    obj.get("risk_analysis", ""),
                    bool(obj.get("fallback_applied", False)))
