"""Host-side trace spans with a bounded, Chrome-trace-shaped event buffer.

The port's copy of `repro.obs.trace`:

    with trace.span("pipeline/shade"):
        ...

    @trace.traced("trainer/evaluate")   # checks the knob on every call
    def evaluate(...): ...

Events are (name, category, start, duration, thread, depth, args) tuples in
a bounded process-global ring buffer (``REPRO_OBS_BUFFER`` events, or
``configure(buffer_size=)``).  One knob gates everything: the ``REPRO_OBS``
environment variable at import, or `set_enabled` / `configure` at run
time; when it is off, `span` returns one shared no-op object and a
`traced` function is called as it is.  `clock` (an alias of
``time.perf_counter``) is the one wall clock for spans and for the
service's latency bookkeeping.  Spans time host work: a CUDA kernel runs
asynchronously, so a span around a launch measures the enqueue unless the
region ends in a synchronize.  The reference's hook into ``jax.profiler``
is left out.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from typing import NamedTuple

#: The one wall clock for spans, latencies and benchmark timings.
clock = time.perf_counter
clock_ns = time.perf_counter_ns


def _env_enabled(val: str | None) -> bool:
    return (val or "").strip().lower() not in ("", "0", "off", "false", "no")


class _State:
    __slots__ = ("enabled", "events")


_STATE = _State()
_STATE.enabled = _env_enabled(os.environ.get("REPRO_OBS"))
# bounded: a long-lived service can trace forever; deque.append is atomic
# under the GIL, so concurrent threads need no lock on the hot path
_STATE.events = deque(maxlen=int(os.environ.get("REPRO_OBS_BUFFER", 262144)))

_tls = threading.local()


class SpanEvent(NamedTuple):
    name: str
    cat: str
    ts_us: float          # start, microseconds on the perf_counter timeline
    dur_us: float | None  # None => instant event
    tid: int
    thread_name: str
    depth: int            # per-thread nesting depth at entry
    args: dict | None


def enabled() -> bool:
    return _STATE.enabled


def set_enabled(on: bool) -> None:
    _STATE.enabled = bool(on)


def configure(enabled: bool | None = None, buffer_size: int | None = None) -> None:
    """Run-time overrides of the environment's defaults; a new buffer size
    keeps the newest events that fit."""
    if enabled is not None:
        _STATE.enabled = bool(enabled)
    if buffer_size is not None:
        _STATE.events = deque(_STATE.events, maxlen=int(buffer_size))


def events() -> list[SpanEvent]:
    """Snapshot of the event buffer (oldest first)."""
    return list(_STATE.events)


def clear() -> None:
    _STATE.events.clear()


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _NullSpan()


class Span:
    __slots__ = ("name", "cat", "args", "_t0", "_depth")

    def __init__(self, name: str, cat: str = "obs", args: dict | None = None):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        depth = getattr(_tls, "depth", 0)
        _tls.depth = depth + 1
        self._depth = depth
        self._t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        _tls.depth = self._depth
        th = threading.current_thread()
        _STATE.events.append(SpanEvent(
            self.name, self.cat, self._t0 / 1e3, (t1 - self._t0) / 1e3,
            th.ident or 0, th.name, self._depth, self.args,
        ))
        return False


def span(name: str, cat: str = "obs", args: dict | None = None):
    """A context manager timing the wrapped region, or the shared no-op when
    observability is off.  `args` must be small JSON-able host values."""
    if not _STATE.enabled:
        return NULL
    return Span(name, cat, args)


def traced(name: str | None = None, cat: str = "obs"):
    """Decorator form of `span` (default name: the function's qualname).
    The knob is read on every call, so decorating while it is off freezes
    nothing."""
    def deco(fn):
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **k):
            if not _STATE.enabled:
                return fn(*a, **k)
            with Span(label, cat):
                return fn(*a, **k)

        return wrapper

    return deco


def record(name: str, start_s: float, end_s: float, cat: str = "obs",
           args: dict | None = None) -> None:
    """Append a finished span from two `clock()` readings (seconds), for a
    region that no ``with`` block can bracket; it shares the span
    timeline, so recorded and bracketed spans interleave in the trace."""
    if not _STATE.enabled:
        return
    th = threading.current_thread()
    _STATE.events.append(SpanEvent(
        name, cat, start_s * 1e6, max(0.0, end_s - start_s) * 1e6,
        th.ident or 0, th.name, getattr(_tls, "depth", 0), args,
    ))


def instant(name: str, cat: str = "obs", args: dict | None = None) -> None:
    """Zero-duration marker event."""
    if not _STATE.enabled:
        return
    th = threading.current_thread()
    _STATE.events.append(SpanEvent(
        name, cat, clock_ns() / 1e3, None, th.ident or 0, th.name,
        getattr(_tls, "depth", 0), args,
    ))
