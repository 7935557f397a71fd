"""Intent analysis: hybrid static+runtime profiling → LLM-guided layout
selection (the paper's decision pipeline; ``select_layout`` is the entry
point, ``LayoutDecision`` the result carrying per-scope mode plans).

A copy of ``repro.core.intent``; the port imports nothing of the reference.
"""
from repro_torch.core.intent.selector import LayoutDecision, select_layout  # noqa: F401
