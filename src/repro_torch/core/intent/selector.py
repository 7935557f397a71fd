"""End-to-end layout selection: extract → probe → reason → decide (§III-A).

With per-scope phases in a workload, the pipeline additionally reasons over
each scope's phase group and emits a *heterogeneous plan* — e.g. checkpoint
scope → HYBRID, shared-read scope → DIST_HASH — materialized as a
``LayoutPolicy`` via ``LayoutDecision.layout_policy``.

A copy of ``repro.core.intent.selector``;
the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.intent.context import HybridContext
from repro_torch.core.intent.probe import run_probe
from repro_torch.core.intent.prompt import build_prompt
from repro_torch.core.intent.reasoner import (Decision, KnowledgeReasoner,
                                        LLMBackend, parse_decision)
from repro_torch.core.intent.static_extractor import extract_static
from repro_torch.core.layouts import LayoutMode, LayoutParams
from repro_torch.core.policy import LayoutPolicy
from repro_torch.core.workloads import Workload


@dataclass
class LayoutDecision:
    """The pipeline's output for one workload.

    Carries the whole-job mode plus — when the workload's phases span
    several path scopes — the heterogeneous per-scope plan
    (``scope_modes``) that ``layout_policy()`` compiles into a
    ``LayoutPolicy`` for the client, with the full decision/prompt
    provenance kept for audit.
    """
    workload: str
    mode: LayoutMode
    confidence: float
    decision: Decision
    prompt: str
    context_json: str
    # heterogeneous plan: scope → mode (empty for single-scope workloads)
    scope_modes: Dict[str, LayoutMode] = field(default_factory=dict)
    scope_decisions: Dict[str, Decision] = field(default_factory=dict)

    def layout_params(self, n_nodes: int) -> LayoutParams:
        """Legacy single-mode view (ignores any per-scope plan)."""
        return LayoutParams(mode=self.mode, n_nodes=n_nodes)

    def layout_policy(self, n_nodes: int) -> LayoutPolicy:
        """The decision as an executable per-scope LayoutPolicy; the
        whole-job mode is the fail-safe default for unscoped paths."""
        return LayoutPolicy.from_scopes(self.scope_modes, n_nodes=n_nodes,
                                        default=self.mode)


def _decide_one(workload: Workload, *, use_runtime: bool, use_app_ref: bool,
                use_mode_know: bool, backend: Optional[LLMBackend],
                probe_seed: int, static_engine: str = "auto"):
    static = extract_static(workload.source_code, workload.job_script,
                            engine=static_engine)
    runtime = run_probe(workload, seed=probe_seed) if use_runtime else None
    ctx = HybridContext(app=workload.app, static=static, runtime=runtime,
                        n_nodes=workload.n_nodes)
    prompt = build_prompt(ctx, use_app_ref=use_app_ref,
                          use_mode_know=use_mode_know)
    if backend is not None:
        decision = parse_decision(backend.complete(prompt))
    else:
        reasoner = KnowledgeReasoner(use_app_ref=use_app_ref,
                                     use_mode_know=use_mode_know)
        decision = reasoner.reason(ctx)
    return decision, prompt, ctx


def select_layout(workload: Workload, *, use_runtime: bool = True,
                  use_app_ref: bool = True, use_mode_know: bool = True,
                  backend: Optional[LLMBackend] = None,
                  probe_seed: int = 0,
                  static_engine: str = "auto") -> LayoutDecision:
    """The full Proteus decision pipeline for one job.

    The whole-job decision is unchanged from the single-mode pipeline; when
    the workload's phases carry distinct path scopes, each scope's phase
    group is additionally reasoned over in isolation, yielding the per-scope
    assignments of the heterogeneous plan.

    ``static_engine`` selects the extraction engine: ``"auto"`` tries the
    AST/dataflow analyzer and falls back to regex for non-C inputs,
    ``"regex"`` forces the legacy extractor (the differential oracle).
    """
    kw = dict(use_runtime=use_runtime, use_app_ref=use_app_ref,
              use_mode_know=use_mode_know, backend=backend,
              probe_seed=probe_seed, static_engine=static_engine)
    decision, prompt, ctx = _decide_one(workload, **kw)
    result = LayoutDecision(workload.name, decision.mode, decision.confidence,
                            decision, prompt, ctx.to_json())

    scopes = sorted({p.scope for p in workload.phases if p.scope})
    if len(scopes) == 1 and all(p.scope == scopes[0]
                                for p in workload.phases):
        # one scope covering every phase: the whole-job decision IS the plan
        result.scope_modes[scopes[0]] = decision.mode
        result.scope_decisions[scopes[0]] = decision
    else:
        for scope in scopes:
            sub = dataclasses.replace(
                workload, phases=[p for p in workload.phases
                                  if p.scope == scope])
            d, _, _ = _decide_one(sub, **kw)
            result.scope_modes[scope] = d.mode
            result.scope_decisions[scope] = d
    return result
