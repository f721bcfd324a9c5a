"""Deterministic fault injection for chaos tests.

The port's copy of `repro.testing.faults`, with its own process-global
state: the same site names, kinds, plan format and ``REPRO_FAULTS`` knob, so
a plan written for one package drives the other.  When the knob is off,
every call site pays one attribute check (`check` returns ``None`` at
once).  Faults perturb state only at slice, publish and write boundaries.

    from repro_torch.testing import faults

    faults.configure(enabled=True)
    faults.inject("serve3d.slice", "nan_params", session="scene-001",
                  at_step=24, times=1)
    ...run the service...
    assert faults.fired_count("nan_params") == 1
    faults.reset()

======================  =====================================================
site                    kinds understood by the call site
======================  =====================================================
``serve3d.slice``       ``nan_params`` / ``inf_params`` (poison the
                        session's params after the slice), ``nan_loss``
                        (poison the reported loss only), ``loss_spike``
                        (multiply the reported loss by ``factor``, default
                        1e6), ``exception`` (raise `InjectedFault` before
                        training), ``slow`` (sleep ``seconds``, default 0.25)
``serve3d.snapshot_publish``  ``snapshot_fail`` (raise before the atomic
                        swap -- the previous snapshot stays the latest)
``serve3d.render_group``      ``render_fail`` (raise inside a group's
                        render -- requests are retried, then error out)
``checkpoint.write``    ``kill_mid_write`` (raise after the array file is
                        written, before the atomic rename), ``corrupt``
                        (flip bytes in the committed array file)
======================  =====================================================

An injection fires when the site matches, every ``match`` key equals the
call's context, the first ``skip`` matching calls have passed and fewer
than ``times`` firings have happened.  ``at_step`` matches when the
context step is >= the requested step.  Every firing is logged (site, kind,
context) and mirrored to the metrics registry (``faults.fired.{kind}``)
when observability is on.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any

import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


def _env_enabled(val: str | None) -> bool:
    return (val or "").strip().lower() not in ("", "0", "off", "false", "no")


class _State:
    __slots__ = ("enabled", "plan", "fired", "lock")


_STATE = _State()
_STATE.enabled = _env_enabled(os.environ.get("REPRO_FAULTS"))
_STATE.plan = []
_STATE.fired = []
_STATE.lock = threading.Lock()


class InjectedFault(RuntimeError):
    """Raised by call sites executing an ``exception``-style injection."""


@dataclass
class Injection:
    site: str
    kind: str
    match: dict = dc_field(default_factory=dict)
    at_step: int | None = None
    skip: int = 0                 # matching calls to let pass before firing
    times: int | None = 1         # max firings (None = unbounded)
    params: dict = dc_field(default_factory=dict)
    seen: int = 0                 # matching calls observed
    count: int = 0                # firings so far

    def matches(self, ctx: dict) -> bool:
        for k, v in self.match.items():
            if ctx.get(k) != v:
                return False
        if self.at_step is not None:
            step = ctx.get("step")
            if step is None or step < self.at_step:
                return False
        return True


def enabled() -> bool:
    return _STATE.enabled


def configure(enabled: bool | None = None) -> None:
    """Run-time override of the ``REPRO_FAULTS`` default."""
    if enabled is not None:
        _STATE.enabled = bool(enabled)


def inject(site: str, kind: str, *, at_step: int | None = None, skip: int = 0,
           times: int | None = 1, **match_and_params) -> Injection:
    """Arm an injection.  Keywords naming call-site context keys
    (``session``, ``step``, ``member``, ``request``) become match
    predicates; the rest ride along as ``params`` (``seconds``,
    ``factor``).  Arming enables the harness."""
    match_keys = {"session", "step", "member", "request"}
    match = {k: v for k, v in match_and_params.items() if k in match_keys}
    params = {k: v for k, v in match_and_params.items() if k not in match_keys}
    inj = Injection(site=site, kind=kind, match=match, at_step=at_step,
                    skip=int(skip), times=times, params=params)
    with _STATE.lock:
        _STATE.plan.append(inj)
    _STATE.enabled = True
    return inj


def reset() -> None:
    """Clear the plan and the firing log (the knob stays as it is)."""
    with _STATE.lock:
        _STATE.plan = []
        _STATE.fired = []


def check(site: str, **ctx: Any) -> Injection | None:
    """The call sites' entry point: the first armed injection matching
    (site, ctx), else None.  One attribute check when disabled."""
    if not _STATE.enabled:
        return None
    with _STATE.lock:
        for inj in _STATE.plan:
            if inj.site != site or not inj.matches(ctx):
                continue
            inj.seen += 1
            if inj.seen <= inj.skip:
                continue
            if inj.times is not None and inj.count >= inj.times:
                continue
            inj.count += 1
            _STATE.fired.append({"site": site, "kind": inj.kind, **ctx})
            if obs_trace.enabled():
                obs_metrics.counter(f"faults.fired.{inj.kind}").inc()
                obs_trace.instant(f"faults/{inj.kind}", cat="faults",
                                  args={"site": site})
            return inj
    return None


def fired() -> list[dict]:
    """Firing log (site, kind, call context), oldest first."""
    with _STATE.lock:
        return list(_STATE.fired)


def fired_count(kind: str | None = None) -> int:
    with _STATE.lock:
        if kind is None:
            return len(_STATE.fired)
        return sum(1 for f in _STATE.fired if f["kind"] == kind)


# ---- state poisoners (fault path only) ----

def poison_tree(tree, value: float):
    """A copy of `tree` (nested dicts / tuples of tensors or numpy arrays)
    with every floating leaf filled with `value` (NaN/Inf) -- the end state
    of a diverged step.  Other leaves are returned as they are."""
    if isinstance(tree, dict):
        return {k: poison_tree(v, value) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(poison_tree(v, value) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(poison_tree(v, value) for v in tree)
    x = torch.as_tensor(tree)
    if x.is_floating_point():
        return torch.full_like(x, value)
    return tree


def corrupt_file(path, n_bytes: int = 64, offset: int = 0) -> None:
    """Flip `n_bytes` bytes of the file in place (bit-rot)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(n_bytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))
