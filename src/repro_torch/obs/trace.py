"""Tracing core: spans, a typed counter/gauge registry, pluggable sinks.

Counterpart of :mod:`repro.obs.trace`, copied (it is pure Python) rather
than imported.  Sinks are registered like the formats and schedulers
(:func:`register_sink`); every instrumented site — the engine's step loop, the kernel bindings, the page
pool — talks to this registry instead of owning its own logging.

Three primitives, all a single branch when disabled (no sink registered,
or inside :func:`disabled`):

``span(name, **attrs)``    a ``with``-scoped timed region.  Disabled, it
                           returns one shared no-op singleton
                           (:data:`NULL_SPAN`): nothing is allocated.
                           Enabled, it records wall time and nesting depth
                           and emits a :class:`SpanRecord` to every sink at
                           exit, also when the body raises (the exception
                           type stamped into ``attrs``).
``counter(name, n, **lb)`` a monotone metric keyed by ``(name, sorted
                           labels)``; each increment also emits a
                           :class:`PointRecord` with the running total.
                           The port runs eagerly, so ``kernel.dispatch``
                           counts kernel executions, where the reference's
                           counts call sites at trace time.
``gauge(name, v, **lb)``   a last-value metric (pool occupancy, bytes).
``event(name, **lb)``      an instant mark: the request lifecycle stream
                           that :mod:`repro_torch.obs.metrics` turns back
                           into TTFT/TPOT.

**Spans time host work.**  The clock is ``time.perf_counter``.  CUDA work
is asynchronous, so a span covers device time only where a synchronisation
falls inside it — in the engine, the copy of each step's logits to the
host inside ``engine.decode`` (and ``engine.prefill``).  No span calls
``torch.cuda.synchronize()``: one would change the step times that the
spans are there to observe.

Sinks: :class:`NullSink` (explicit no-op), :class:`RingSink` (bounded
in-memory ring: ``ServeEngine.timeline()``), the Chrome-trace exporter
(:class:`repro_torch.obs.export.ChromeTraceSink`) and the periodic stats
line (:class:`repro_torch.obs.metrics.StatsLineSink`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple, Optional


class SpanRecord(NamedTuple):
    """One closed span: wall-clock start, duration, nesting depth, attrs.

    ``ts``/``dur`` are ``time.perf_counter`` seconds; ``depth`` is the
    span-nesting level at entry (0 = top level), which is what lets the
    Chrome exporter reconstruct the flame graph without parent pointers.
    """

    name: str
    ts: float
    dur: float
    depth: int
    attrs: dict


class PointRecord(NamedTuple):
    """One metric sample: ``kind`` is ``"counter"`` (``value`` = running
    total after the increment), ``"gauge"`` (``value`` = the new value) or
    ``"event"`` (instant mark, ``value`` = 0)."""

    kind: str
    name: str
    ts: float
    value: float
    labels: dict


class Sink:
    """Base sink: override the hooks you care about (both default no-op)."""

    def on_span(self, rec: SpanRecord) -> None:  # noqa: D102 - protocol
        pass

    def on_point(self, rec: PointRecord) -> None:  # noqa: D102 - protocol
        pass


class NullSink(Sink):
    """Explicit no-op sink (keeps tracing *enabled* — spans time and
    counters accumulate — while discarding the record stream; useful for
    measuring instrumentation overhead in isolation)."""


class RingSink(Sink):
    """Bounded in-memory ring of records, in emission order.

    Spans are recorded at *exit* (a parent closes after its children), so
    consumers that need start-ordering sort by ``ts`` — the Chrome
    exporter does.  ``capacity`` bounds memory on long-lived engines;
    the oldest records drop first.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("RingSink capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf: list = []
        self.dropped = 0

    def _push(self, rec) -> None:
        self._buf.append(rec)
        if len(self._buf) > self.capacity:
            del self._buf[0]
            self.dropped += 1

    on_span = _push
    on_point = _push

    def records(self) -> list:
        """All retained records, emission-ordered (oldest first)."""
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0


# ---------------------------------------------------------------------------
# Sink registry + global enable switch
# ---------------------------------------------------------------------------

_SINKS: list[Sink] = []
_ENABLED = True


def register_sink(sink: Sink) -> Sink:
    """Register a sink; returns it (so ``ring = register_sink(RingSink())``
    reads naturally).  The first registered sink is what flips the
    module from the zero-overhead disabled path to recording."""
    _SINKS.append(sink)
    return sink


def unregister_sink(sink: Sink) -> None:
    """Remove one registered sink (missing sink is a no-op, so teardown
    paths can call it unconditionally)."""
    try:
        _SINKS.remove(sink)
    except ValueError:
        pass


def clear_sinks() -> None:
    """Drop every sink — back to the zero-overhead path."""
    _SINKS.clear()


def sinks() -> tuple[Sink, ...]:
    return tuple(_SINKS)


def active() -> bool:
    """True when at least one sink is registered and tracing is not
    suppressed by :func:`disabled` — the single branch every primitive
    takes on its fast path."""
    return _ENABLED and bool(_SINKS)


@contextlib.contextmanager
def disabled():
    """Temporarily suppress all tracing (sinks stay registered but see
    nothing; counters do not accumulate).  Nestable."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_clock: Callable[[], float] = time.perf_counter
_depth = 0


class _NullSpan:
    """Shared disabled-path span: ``span()`` returns THIS singleton when no
    sink is registered, so the step loop performs one branch and zero
    allocations per instrumented region."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_depth")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        global _depth
        self._depth = _depth
        _depth += 1
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _depth
        dur = _clock() - self._t0
        _depth = self._depth
        if exc_type is not None:
            # exception-safe: the span still records, tagged with the error
            self.attrs = dict(self.attrs, error=exc_type.__name__)
        rec = SpanRecord(self.name, self._t0, dur, self._depth, self.attrs)
        for s in _SINKS:
            s.on_span(rec)
        return False


def span(name: str, **attrs):
    """Timed region: ``with span("engine.prefill", slots=2, tokens=17):``.

    Disabled (no sinks / inside :func:`disabled`): returns the shared
    :data:`NULL_SPAN` singleton — no allocation, no clock read.
    """
    if not (_ENABLED and _SINKS):
        return NULL_SPAN
    return _Span(name, attrs)


# ---------------------------------------------------------------------------
# Typed counter / gauge registry
# ---------------------------------------------------------------------------

_COUNTERS: dict[tuple, float] = {}
_GAUGES: dict[tuple, float] = {}


def _key(name: str, labels: dict) -> tuple:
    return (name,) + tuple(sorted(labels.items()))


def counter(name: str, value: float = 1, **labels) -> None:
    """Accumulate ``value`` into the counter keyed by ``(name, labels)``
    and emit the running total to every sink.  No-op when disabled —
    counters only count what tracing observed."""
    if not (_ENABLED and _SINKS):
        return
    key = _key(name, labels)
    total = _COUNTERS.get(key, 0) + value
    _COUNTERS[key] = total
    rec = PointRecord("counter", name, _clock(), total, labels)
    for s in _SINKS:
        s.on_point(rec)


def gauge(name: str, value: float, **labels) -> None:
    """Set the last-value metric keyed by ``(name, labels)``."""
    if not (_ENABLED and _SINKS):
        return
    _GAUGES[_key(name, labels)] = value
    rec = PointRecord("gauge", name, _clock(), value, labels)
    for s in _SINKS:
        s.on_point(rec)


def event(name: str, **labels) -> None:
    """Instant mark (the request-lifecycle stream)."""
    if not (_ENABLED and _SINKS):
        return
    rec = PointRecord("event", name, _clock(), 0.0, labels)
    for s in _SINKS:
        s.on_point(rec)


def counter_value(name: str, **labels) -> float:
    """Current accumulated total for one counter key (0 if never hit)."""
    return _COUNTERS.get(_key(name, labels), 0)


def gauge_value(name: str, **labels) -> Optional[float]:
    """Last value set for one gauge key (None if never set)."""
    return _GAUGES.get(_key(name, labels))


def counters_snapshot() -> dict[tuple, float]:
    """Copy of the full counter registry (key = (name, *sorted labels))."""
    return dict(_COUNTERS)


def gauges_snapshot() -> dict[tuple, float]:
    return dict(_GAUGES)


def reset_metrics() -> None:
    """Zero the counter/gauge registries (tests; sinks keep their
    records)."""
    _COUNTERS.clear()
    _GAUGES.clear()


def current_depth() -> int:
    """Live span-nesting depth (0 outside any span) — invariant-checked by
    the nesting/exception-safety property tests."""
    return _depth
