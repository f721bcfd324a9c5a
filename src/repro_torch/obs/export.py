"""Exporters: Chrome-trace JSON for spans, JSON snapshots and a terminal
printer for metrics.

The port's copy of `repro.obs.export`, over the port's `obs.trace` and
`obs.metrics`.  `chrome_trace()` emits the Trace Event Format document that
``chrome://tracing`` and Perfetto load: complete ("X") events with
``ts``/``dur`` in microseconds, instant markers (phase "i") and metadata
("M") events naming the process and every thread that emitted a span.
``tools/check_trace.py`` validates the format.
"""
from __future__ import annotations

import json
import os

from . import metrics as _metrics
from . import trace as _trace


def chrome_trace(events=None, process_name: str = "repro_torch") -> dict:
    """Render span events into a Chrome Trace Event Format document."""
    evs = _trace.events() if events is None else list(events)
    pid = os.getpid()
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
            "args": {"name": process_name}}]
    threads_seen: dict[int, str] = {}
    for e in evs:
        threads_seen.setdefault(e.tid, e.thread_name)
        rec = {"name": e.name, "cat": e.cat, "pid": pid, "tid": e.tid, "ts": e.ts_us}
        if e.dur_us is None:
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant
        else:
            rec["ph"] = "X"
            rec["dur"] = e.dur_us
        args = dict(e.args) if e.args else {}
        args["depth"] = e.depth
        rec["args"] = args
        out.append(rec)
    for tid, tname in sorted(threads_seen.items()):
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "ts": 0,
                    "args": {"name": tname}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dump_trace(path: str, events=None, process_name: str = "repro_torch") -> str:
    """Write the Chrome-trace JSON to `path`; returns the path."""
    doc = chrome_trace(events, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def metrics_snapshot(extra: dict | None = None) -> dict:
    """Exportable metrics document: the registry snapshot plus optional
    caller context under ``meta``."""
    return {"meta": dict(extra or {}), "metrics": _metrics.snapshot()}


def dump_metrics(path: str, extra: dict | None = None) -> str:
    with open(path, "w") as f:
        json.dump(metrics_snapshot(extra), f, indent=2, sort_keys=True)
    return path


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def format_metrics(doc: dict | None = None, prefix: str = "") -> str:
    """One line per metric of a metrics snapshot (a raw registry snapshot or
    the `metrics_snapshot()` document), filtered by name `prefix`."""
    if doc is None:
        doc = _metrics.snapshot()
    snap = doc.get("metrics", doc)
    lines = []
    width = max((len(n) for n in snap if n.startswith(prefix)), default=0)
    for name in sorted(snap):
        if not name.startswith(prefix):
            continue
        m = snap[name]
        if m.get("type", "?") == "histogram":
            body = (f"count={m['count']} p50={_fmt_num(m['p50'])} "
                    f"p95={_fmt_num(m['p95'])} p99={_fmt_num(m['p99'])} "
                    f"max={_fmt_num(m['max'])}")
        else:
            body = _fmt_num(m.get("value"))
        lines.append(f"  {name:<{width}}  {body}")
    return "\n".join(lines)
