"""Oracle: empirically optimal mode via exhaustive execution (§IV-C).

A copy of ``repro.core.intent.oracle``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.core.simulator import (Hardware, DEFAULT_HW, best_scope_modes,
                                  simulate)
from repro_torch.core.workloads import Workload, build_workloads


def oracle_mode(workload: Workload, hw: Hardware = DEFAULT_HW,
                seed: int = 0) -> LayoutMode:
    """Simulator-optimal layout mode for one workload."""
    times = {m: simulate(workload, m, workload.n_nodes, hw, seed).total_s
             for m in LayoutMode}
    return min(times, key=times.get)


def oracle_policy(workload: Workload, hw: Hardware = DEFAULT_HW,
                  seed: int = 0) -> LayoutPolicy:
    """Per-scope oracle: exhaustive search per scope group → LayoutPolicy.

    For single-scope workloads this degenerates to ``oracle_mode``; for
    heterogeneous workloads it is the layout a single mode cannot reach.
    """
    scope_modes = best_scope_modes(workload, workload.n_nodes, hw, seed)
    default = (scope_modes.pop("") if "" in scope_modes
               else oracle_mode(workload, hw, seed))
    return LayoutPolicy.from_scopes(scope_modes, n_nodes=workload.n_nodes,
                                    default=default)


def oracle_table(n_nodes: int = 32, hw: Hardware = DEFAULT_HW
                 ) -> Dict[str, LayoutMode]:
    """Workload-name → oracle mode over the whole suite."""
    return {w.name: oracle_mode(w, hw) for w in build_workloads(n_nodes)}


def suite_accuracy(workloads: List[Workload], hw: Hardware = DEFAULT_HW,
                   seed: int = 0, **select_kw) -> tuple:
    """(correct, total) of the pipeline against the per-workload oracle.

    ``select_kw`` is forwarded to ``select_layout`` (ablation switches,
    ``static_engine=...``), so the same scorer drives both the headline
    accuracy pins and the regex-vs-AST differential comparisons.
    """
    from repro_torch.core.intent.selector import select_layout
    correct = 0
    for w in workloads:
        decided = select_layout(w, probe_seed=seed, **select_kw).mode
        if decided == oracle_mode(w, hw, seed):
            correct += 1
    return correct, len(workloads)
