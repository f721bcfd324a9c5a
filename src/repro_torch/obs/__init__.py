"""Host-side spans and metrics: the port's own copy of `repro.obs` (same
``REPRO_OBS`` knob, no JAX profiler hook).

* `trace` -- spans (`span` context manager / `traced` decorator) in a
  bounded ring buffer, thread-aware;
* `metrics` -- Counter / Gauge / Histogram behind the process-global
  `REGISTRY`;
* `export` -- Chrome-trace / Perfetto JSON and metrics dumps.
"""
from __future__ import annotations

from . import export, metrics, trace
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry
from .trace import clock, configure, enabled, instant, set_enabled, span, traced

__all__ = [
    "export", "metrics", "trace",
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry",
    "clock", "configure", "enabled", "instant", "set_enabled", "span",
    "traced", "reset",
]


def reset() -> None:
    """Clear the span buffer and the metrics registry (test isolation)."""
    trace.clear()
    REGISTRY.reset()
