"""Real static analysis for the C-like I/O kernel corpus (§III-C.a).

A lexer + recursive-descent parser produce an AST (``cparse``); a
per-function control-flow graph with loop-nest extraction gives symbolic
trip counts and structural intensity (``cfg``); two dataflow analyses —
rank-taint propagation and offset-evolution classification (``dataflow``)
— feed the feature ``analyzer``, which emits evidence-graded
``StaticFeatures`` with per-field provenance records.

Entry point: ``analyze_source(src, features=None) -> StaticFeatures``
(raises ``StaticAnalysisError`` on inputs that are not C-like; the caller
falls back to the regex extractor, which doubles as a differential
oracle).  See docs/intent.md for the full narrative.

A copy of ``repro.core.intent.staticlib``;
the port imports nothing of the reference.
"""
from repro_torch.core.intent.staticlib.analyzer import (  # noqa: F401
    StaticAnalysisError, analyze_source, looks_like_c)
