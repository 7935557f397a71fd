"""Flight recorder: bounded ring of structured spans with fenced timing
(twin of ``repro.core.obs.recorder``).

A :class:`TraceRecorder` owns three planes of one recording: the span
ring (this module), a :class:`~.metrics.MetricsRegistry` and a
:class:`~.audit.DecisionAudit`.  Passing one to ``BBClient(trace=...)``
turns the whole exchange/adapt pipeline into an instrumented run; with
no recorder every instrumentation point is one truthiness check and a
branch: no launch, no copy, no synchronisation.

Span categories keep the reference's names:

* ``cat="trace"`` spans wrap the engine's entry points and the exchange
  pipeline (``run_exchange``: plan → pack → apply → collect → carry).  The
  reference runs that code while jax *traces*, so its spans fire once per
  jit specialization, on the first call of a shape.  The port runs eagerly,
  so they fire on **every** call: span counts of repeated calls differ
  from the reference's, while the nesting and names of one call's span
  tree, and the byte counters, are the same, but for the carry round.
  The reference traces that round inside its cond whether it runs or not,
  and plans a pipelined one before the cond, in an ``exchange.carry.plan``
  span just before ``exchange.carry``.  The port's ``exchange.carry``
  holds the round's spans, ``exchange.carry.plan`` first, only when the
  round runs.
* host-side spans (``cat="client"``, ``"adapt"``, ...) wrap dispatch sites.
  PyTorch returns before the card finishes, so a span may register a
  **fence** value: at span exit the recorder synchronises the CUDA stream
  of every CUDA tensor in it *before* taking the end timestamp (CPU tensors
  need nothing).  Fences run only while a recorder is active.

Activation is dynamically scoped: ``with activate(rec): ...`` pushes
``rec`` on a stack consulted by the module-level :func:`span` /
:func:`current_recorder` helpers, so deep library code (executors,
selectors) records into whatever client invoked it without threading a
recorder argument through every signature.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

from repro_torch.core.obs.audit import DecisionAudit
from repro_torch.core.obs.metrics import MetricsRegistry

#: dynamically scoped stack of active recorders (top = current)
_ACTIVE: List["TraceRecorder"] = []


@dataclass
class Span:
    """One completed span: name, category, start/duration (µs), depth, args.

    ``ts_us`` is relative to the owning recorder's epoch so a recording
    always starts near 0; ``depth`` is the nesting level at entry (the
    Perfetto exporter keeps all spans on one track — nesting is implied
    by timestamp containment, which a stack discipline guarantees).
    """

    name: str
    cat: str
    ts_us: float
    dur_us: float
    depth: int
    args: Dict[str, object] = field(default_factory=dict)


class SpanHandle:
    """Mutable handle yielded by :meth:`TraceRecorder.span`.

    Lets the instrumented code attach attributes discovered mid-span
    (:meth:`set`) and register the tensors whose completion defines the
    span's end (:meth:`fence`).
    """

    def __init__(self, args: Dict[str, object]) -> None:
        self.args = args
        self._fence = None

    def set(self, **attrs: object) -> None:
        """Merge ``attrs`` into the span's args."""
        self.args.update(attrs)

    def fence(self, value):
        """Register ``value`` to be waited for at span exit; returns it.

        The recorder synchronises the streams of the CUDA tensors in
        ``value`` before taking the end timestamp, so the span duration
        covers device execution, not just the launches.
        """
        self._fence = value
        return value


def _tensors(value) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(value, torch.Tensor):
        yield value
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def block_on(value):
    """Fence helper: wait until the work producing ``value`` is done.

    Synchronises the current stream of each CUDA device holding a tensor
    of ``value`` (states, tuples, None); CPU tensors need nothing.
    Returns the value, so it can wrap a return expression in timed code.
    """
    devices = {t.device for t in _tensors(value) if t.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return value


class TraceRecorder:
    """Bounded flight recorder for one client/run.

    ``capacity`` bounds the span ring (oldest spans evicted first, with
    ``dropped_spans`` counting evictions); ``metrics`` and ``audit``
    default to fresh instances and are shared with every
    instrumentation site that runs while this recorder is active.
    """

    def __init__(self, capacity: int = 8192, *,
                 metrics: Optional[MetricsRegistry] = None,
                 audit: Optional[DecisionAudit] = None) -> None:
        self.spans: deque = deque(maxlen=int(capacity))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.audit = audit if audit is not None else DecisionAudit()
        self.dropped_spans = 0
        self._depth = 0
        self._epoch = time.perf_counter()
        #: span name → premade (count_key, us_key) rollup counter keys —
        #: the rollup runs on every span exit in the client hot path, so
        #: the ``metric_key`` string build is paid once per name
        self._rollup: Dict[str, tuple] = {}

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "bb",
             **attrs: object) -> Iterator[SpanHandle]:
        """Record one span around the ``with`` body.

        The yielded :class:`SpanHandle` can attach attributes and a
        fence value; the end timestamp is taken only after the fence
        (if any) has been waited for.
        """
        handle = SpanHandle(dict(attrs))
        t0 = self._now_us()
        depth = self._depth
        self._depth += 1
        try:
            yield handle
        finally:
            self._depth -= 1
            if handle._fence is not None:
                block_on(handle._fence)
            t1 = self._now_us()
            if len(self.spans) == self.spans.maxlen:
                self.dropped_spans += 1
            self.spans.append(Span(
                name=name, cat=cat, ts_us=t0, dur_us=t1 - t0,
                depth=depth, args=handle.args))
            keys = self._rollup.get(name)
            if keys is None:
                keys = (f"span_count_total{{span={name}}}",
                        f"span_us_total{{span={name}}}")
                self._rollup[name] = keys
            counters = self.metrics.counters
            counters[keys[0]] = counters.get(keys[0], 0.0) + 1.0
            counters[keys[1]] = counters.get(keys[1], 0.0) + (t1 - t0)


# ---------------------------------------------------------------------------
# dynamic activation
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def activate(recorder: Optional[TraceRecorder]) -> Iterator[None]:
    """Make ``recorder`` the current recorder for the ``with`` body.

    ``activate(None)`` is a no-op context manager, so call sites can
    always write ``with activate(client.obs): ...`` without branching.
    """
    if recorder is None:
        yield
        return
    _ACTIVE.append(recorder)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_recorder() -> Optional[TraceRecorder]:
    """The innermost active recorder, or ``None`` outside any activation."""
    return _ACTIVE[-1] if _ACTIVE else None


def current_metrics() -> Optional[MetricsRegistry]:
    """The active recorder's metrics registry, or ``None``."""
    rec = current_recorder()
    return rec.metrics if rec is not None else None


class _NullHandle(SpanHandle):
    """Inert handle for the no-recorder path: records and retains nothing."""

    def __init__(self) -> None:
        super().__init__({})

    def set(self, **attrs: object) -> None:
        """Drop the attributes (nothing is recording)."""

    def fence(self, value):
        """Pass the value through without retaining it or waiting."""
        return value


_NULL_HANDLE = _NullHandle()


@contextlib.contextmanager
def span(name: str, cat: str = "bb", **attrs: object
         ) -> Iterator[SpanHandle]:
    """Span on the *current* recorder; near-free no-op when none is active.

    The no-op path yields a shared inert handle (its ``set``/``fence``
    still work, they just record nothing), so instrumented code never
    branches on whether tracing is on.
    """
    if not _ACTIVE:
        yield _NULL_HANDLE
        return
    with _ACTIVE[-1].span(name, cat=cat, **attrs) as handle:
        yield handle


def trace_span(name: str, cat: str = "trace"):
    """Decorator: wrap a function in a :func:`span` when tracing is on.

    Used on the burst-buffer entry points; the span nests under the
    dispatching client span.  With no active recorder the wrapper is a
    single truthiness check.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            with _ACTIVE[-1].span(name, cat=cat):
                return fn(*args, **kwargs)
        return wrapped
    return deco
