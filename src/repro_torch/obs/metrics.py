"""Typed metrics (Counter / Gauge / Histogram) with a process-global registry.

The port's copy of `repro.obs.metrics`.  Names are dotted paths
(``serve3d.render.latency_ms``); metric objects are always live (a
`Histogram` backs `RenderService.latency_stats`), while instrumentation
sites check `trace.enabled()` before touching the global registry.
Histogram quantiles use numpy's default linear interpolation over a bounded
recent window.
"""
from __future__ import annotations

import threading
from collections import deque


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-written scalar."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = float(v)

    def snapshot(self):
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Windowed value distribution with lifetime count and sum."""

    __slots__ = ("window", "count", "total")
    kind = "histogram"

    def __init__(self, window: int = 4096):
        self.window = deque(maxlen=int(window))
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.window.append(v)
        self.count += 1
        self.total += v

    def values(self) -> list[float]:
        return list(self.window)

    def quantile(self, q: float) -> float | None:
        """numpy-default (linear) quantile over the recent window."""
        vals = sorted(self.window)
        if not vals:
            return None
        pos = (len(vals) - 1) * float(q)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def snapshot(self):
        return {
            "type": self.kind,
            "count": self.count,
            "sum": self.total,
            "window": len(self.window),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": max(self.window) if self.window else None,
        }


class Registry:
    """Named metric store; a name keeps its kind for the registry's life."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(*args)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {type(m).kind}, not a {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window)

    def get(self, name: str):
        """The metric registered under `name`, or None."""
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Deterministic flat dict: sorted names -> typed JSON-able values."""
        with self._lock:
            return {k: self._metrics[k].snapshot() for k in sorted(self._metrics)}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: The process-global registry every instrumentation site records into.
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, window: int = 4096) -> Histogram:
    return REGISTRY.histogram(name, window)


def snapshot() -> dict:
    return REGISTRY.snapshot()
