"""Prompt construction (Fig. 6, verbatim template).

The prompt is what an external LLM backend receives.  The offline
deterministic reasoner consumes the same HybridContext/KB directly, but the
prompt is always built and attached to the decision record so a hosted model
(e.g. Qwen3-235B) can be swapped in via ``ExternalLLMBackend``.

A copy of ``repro.core.intent.prompt``;
the port imports nothing of the reference.
"""
from __future__ import annotations

from repro_torch.core.intent.context import HybridContext
from repro_torch.core.intent.knowledge import app_info_text, mode_info_text

TEMPLATE = """You are an HPC I/O architecture expert.
Your task is to analyze the provided hybrid JSON context and map it to the
most suitable GekkoFS architecture mode.

### Knowledge Base
{MODE_INFO}

### Application Context
{APP_INFO}

### Hybrid Context (Static + Runtime)
{CONTEXTUAL_SUMMARY}

### Reasoning Requirements
1. Analyze topology: isolated (N-N) vs shared (N-1).
2. Analyze intensity: metadata vs bandwidth.
3. Analyze direction: read-dominant vs write-dominant.
4. Analyze phase behavior across execution.

### Reasoning Strategy
Perform step-by-step reasoning over the provided context and avoid
unsupported assumptions.
Static features carry an "evidence" block grading each field by its
extraction rule and confidence tier (ast-dataflow > script > ast-struct
> regex); weigh low-confidence hints accordingly.

### Mode Selection Task
Select the layout mode that best matches the workload characteristics.
Constraint: Select exactly one from [Mode 1, Mode 2, Mode 3, Mode 4].

### Output (JSON Only)
{{ "selected_mode": "Mode X", "confidence_score": 0.0-1.0,
"io_topology": "N-N or N-1", "primary_reason": "Step-by-step reasoning",
"risk_analysis": "Potential trade-offs" }}
"""


def build_prompt(ctx: HybridContext, *, use_app_ref: bool = True,
                 use_mode_know: bool = True) -> str:
    """Render the Fig-6 prompt for one profile (ablations drop blocks)."""
    return TEMPLATE.format(
        MODE_INFO=(mode_info_text() if use_mode_know
                   else "(mode descriptions withheld — ablation)"),
        APP_INFO=(app_info_text(ctx.app) if use_app_ref
                  else "(application reference withheld — ablation)"),
        CONTEXTUAL_SUMMARY=ctx.to_json(),
    )
