"""Fault-tolerant training driver and the straggler watchdog.

The port of `repro.runtime.driver`:

* `TrainDriver` checkpoints every `checkpoint_every` steps and at the end
  through the port's `CheckpointManager` (atomic, async); SIGTERM / SIGINT
  make it checkpoint and exit cleanly; it logs metrics as JSON lines;
* `resume_or_init` is the ``--auto-resume`` entry: the newest valid
  checkpoint (its leaves on the devices of the template's tensors) with its
  data cursor, or a fresh init;
* `StragglerStats`: a step (a scheduler slice) slower than
  ``ewma + sigma * dev`` is flagged, then the EWMA of the wall time and of
  its deviation moves by ``alpha``.  The serve3d scheduler keeps one per
  session.
"""
from __future__ import annotations

import json
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

from .. import bridge
from ..checkpoint.manager import CheckpointManager, _children, _is_namedtuple


@dataclass
class DriverConfig:
    total_steps: int = 1000
    checkpoint_every: int = 200
    log_every: int = 20
    straggler_sigma: float = 4.0
    ewma_alpha: float = 0.05
    metrics_path: str | None = None


@dataclass
class StragglerStats:
    ewma: float = 0.0
    dev: float = 0.0
    n_flagged: int = 0
    initialized: bool = False

    def update(self, dt: float, sigma: float, alpha: float) -> bool:
        if not self.initialized:
            self.ewma, self.dev, self.initialized = dt, dt * 0.1, True
            return False
        flagged = dt > self.ewma + sigma * max(self.dev, 1e-9)
        self.dev = (1 - alpha) * self.dev + alpha * abs(dt - self.ewma)
        self.ewma = (1 - alpha) * self.ewma + alpha * dt
        if flagged:
            self.n_flagged += 1
        return flagged


class TrainDriver:
    def __init__(self, cfg: DriverConfig, ckpt: CheckpointManager):
        self.cfg = cfg
        self.ckpt = ckpt
        self.straggler = StragglerStats()
        self._preempted = False
        self._metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path else None

    def _install_signals(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    def _log(self, record: dict):
        if self._metrics_f:
            self._metrics_f.write(json.dumps(record) + "\n")
            self._metrics_f.flush()

    def close(self):
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None

    def run(self, state: Any, step_fn: Callable[[Any, Any], tuple[Any, dict]],
            batch_iter: Iterator, start_step: int = 0,
            state_for_ckpt: Callable[[Any], Any] | None = None):
        """The loop: state, batch -> (state, metrics).  Returns (state, summary)."""
        cfg = self.cfg
        self._install_signals()
        to_ckpt = state_for_ckpt or (lambda s: s)
        step = start_step
        flagged_steps = []

        while step < cfg.total_steps:
            batch = next(batch_iter)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            step += 1

            if self.straggler.update(dt, cfg.straggler_sigma, cfg.ewma_alpha):
                flagged_steps.append(step)
                self._log({"event": "straggler", "step": step, "dt": dt,
                           "ewma": self.straggler.ewma})

            if step % cfg.log_every == 0:
                self._log({"event": "train", "step": step, "dt": dt, **metrics})

            if step % cfg.checkpoint_every == 0:
                self.ckpt.save(step, to_ckpt(state), extra={"data_cursor": step})

            if self._preempted:
                self.ckpt.save(step, to_ckpt(state), extra={"data_cursor": step,
                                                            "preempted": True}, block=True)
                self._log({"event": "preempt_exit", "step": step})
                return state, {"step": step, "preempted": True, "stragglers": flagged_steps}

        if step % cfg.checkpoint_every != 0 or step == start_step:
            self.ckpt.save(step, to_ckpt(state), extra={"data_cursor": step}, block=True)
        self.ckpt.wait()     # (a step just saved periodically is not written twice)
        return state, {"step": step, "preempted": False, "stragglers": flagged_steps}


def _onto(restored, template):
    """`restored` (a checkpoint's numpy tree, shaped like `template`) with
    each leaf whose template leaf is a tensor made a tensor on that
    tensor's device (bf16 from its bits)."""
    kids = _children(template)
    if kids is None:
        if isinstance(template, torch.Tensor):
            return bridge.array_to_tensor(restored).to(template.device)
        return restored
    built = [_onto(r, t) for (_, r), (_, t) in zip(_children(restored), kids)]
    if isinstance(template, dict):
        return dict(zip(sorted(template), built))
    if _is_namedtuple(template):
        return type(template)(*built)
    return type(template)(built)


def resume_or_init(ckpt: CheckpointManager, template: Any, init_fn: Callable[[], Any]):
    """--auto-resume: (the newest valid checkpoint restored into `template`'s
    structure, its data cursor), or (init_fn(), 0) when there is none.
    Leaves whose template leaf is a tensor come back as tensors of the
    template's dtype on its device; the others as numpy arrays."""
    try:
        state, meta = ckpt.restore(template)
    except FileNotFoundError:
        return init_fn(), 0
    return _onto(state, template), int(meta.get("data_cursor", meta["step"]))
