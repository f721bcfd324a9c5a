"""SessionGuard: per-slice divergence detection with checkpoint rollback.

The port of `repro.serve3d.guard`:

* **detect** -- after every slice, each advanced session's reported loss
  must be finite, and the loss's PSNR proxy (-10 log10 loss) must not fall
  more than ``collapse_db`` below the session's best.  Every
  ``deep_check_every`` slices, and on any slice that would become a
  checkpoint, its params and occupancy EMA are reduced to one finiteness
  bool (`trainer.tree_all_finite`).  An exception inside the slice fails
  every member of its cohort.
* **rollback** -- a failed session is restored to its last good host tree
  (`trainer.suspend` every ``checkpoint_every`` healthy slices, never of a
  state that failed a check), or to a fresh `init` from its seed when it
  failed before its first one.  The restore goes through the bit-exact
  resume path, so retraining the same steps reproduces the fault-free
  params bit for bit.
* **retry with backoff** -- each rollback holds the session off for
  ``backoff_base_s * 2^(failures-1)``; ``failures`` counts consecutive
  failures.  After ``max_retries`` the session is **quarantined**: its
  device state is dropped, its last-good params stay served (stale), and
  the scheduler treats it as terminal.
* **persist** -- with ``persist`` on, each last-good tree is also written
  through the session's `CheckpointManager`, so a fresh process can roll
  back too.

`stats()` and the per-session event log are always live; the global
registry mirror (``serve3d.guard.*``) and spans follow the obs knob.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

from ..core.trainer import tree_all_finite
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .session import DONE, SceneSession


@dataclass(frozen=True)
class GuardConfig:
    # slices between last-good checkpoints; also the rollback granularity
    checkpoint_every: int = 4
    # slices between deep finiteness checks (1 = every slice)
    deep_check_every: int = 1
    # consecutive failures tolerated before the session is quarantined
    max_retries: int = 3
    # hold-off before a rolled-back session is rescheduled; doubles per
    # consecutive failure (0 = immediate retry)
    backoff_base_s: float = 0.0
    # PSNR-proxy drop below the session's best that counts as divergence
    collapse_db: float = 20.0
    # healthy slices before the collapse heuristic engages
    collapse_min_history: int = 3
    # write each last-good tree through the session's CheckpointManager
    persist: bool = True


@dataclass
class _SessionRecord:
    slices: int = 0                   # slices inspected
    last_good: dict | None = None     # host tree from trainer.suspend
    last_good_step: int = 0
    best_db: float = -math.inf        # best PSNR proxy seen
    history: int = 0                  # healthy slices feeding the heuristic
    failures: int = 0                 # consecutive failures
    rollbacks: int = 0
    events: list = dc_field(default_factory=list)


class SessionGuard:
    def __init__(self, cfg: GuardConfig | None = None):
        self.cfg = cfg or GuardConfig()
        self._rec: dict[str, _SessionRecord] = {}
        self.recovery_ms = obs_metrics.Histogram(window=1024)
        self.rollbacks = 0
        self.quarantined: list[str] = []
        self.divergences: dict[str, int] = {}
        self.checkpoints = 0
        self.inspect_wall_s = 0.0

    # ---- inspection (after every quantum) ----

    def inspect(self, sessions: list[SceneSession], error: Exception | None = None,
                errors: dict[str, Exception] | None = None) -> dict[str, str]:
        """Health-check every session advanced this quantum -> a verdict
        per session id: ``ok``, ``rolled_back`` or ``quarantined``.
        `error` fails every member; `errors` (per session) takes precedence."""
        t0 = obs_trace.clock()
        verdicts = {}
        for s in sessions:
            e = errors.get(s.session_id, None) if errors is not None else error
            verdicts[s.session_id] = self._inspect_one(s, e)
        self.inspect_wall_s += obs_trace.clock() - t0
        return verdicts

    def _inspect_one(self, s: SceneSession, error: Exception | None) -> str:
        rec = self._rec.setdefault(s.session_id, _SessionRecord())
        rec.slices += 1
        failure = self._failure_kind(s, rec, error)
        if failure is not None:
            return self._handle_failure(s, rec, failure)
        rec.failures = 0
        rec.history += 1
        if rec.slices % self.cfg.checkpoint_every == 0 or s.status == DONE:
            self._checkpoint(s, rec)
        return "ok"

    def _failure_kind(self, s: SceneSession, rec: _SessionRecord,
                      error: Exception | None) -> str | None:
        cfg = self.cfg
        if error is not None:
            return "exception"
        loss = s.telemetry["loss"][-1] if s.telemetry["loss"] else None
        if loss is not None and not math.isfinite(loss):
            return "nan_loss"
        if loss is not None:
            db = -10.0 * math.log10(max(float(loss), 1e-12))
            if rec.history >= cfg.collapse_min_history and rec.best_db - db > cfg.collapse_db:
                return "collapse"
            rec.best_db = max(rec.best_db, db)
        # forced on any slice that would checkpoint, so a poisoned state
        # never becomes "last good"
        due = rec.slices % cfg.deep_check_every == 0 or \
            rec.slices % cfg.checkpoint_every == 0 or s.status == DONE
        if due and s.state is not None and not tree_all_finite(
                s.state.params, s.state.occ_state.density_ema):
            return "non_finite_state"
        return None

    # ---- recovery ----

    def _handle_failure(self, s: SceneSession, rec: _SessionRecord, kind: str) -> str:
        t0 = obs_trace.clock()
        rec.failures += 1
        self.divergences[kind] = self.divergences.get(kind, 0) + 1
        obs_on = obs_trace.enabled()
        if obs_on:
            obs_metrics.counter("serve3d.guard.divergence").inc()
            obs_metrics.counter(f"serve3d.guard.divergence.{kind}").inc()
        if rec.failures > self.cfg.max_retries:
            self._quarantine(s, rec, kind)
            return "quarantined"
        from_step = s.step
        tree = rec.last_good if rec.last_good is not None else self._init_tree(s)
        with obs_trace.span("serve3d/guard_rollback", cat="serve3d",
                            args={"session": s.session_id, "kind": kind,
                                  "from_step": int(from_step),
                                  "to_step": int(rec.last_good_step)}):
            s.rollback(tree)
        hold = self.cfg.backoff_base_s * (2.0 ** (rec.failures - 1))
        s.hold_until = obs_trace.clock() + hold
        rec.best_db = -math.inf      # the proxy baseline restarts with the state
        rec.history = 0
        rec.rollbacks += 1
        self.rollbacks += 1
        dt_ms = (obs_trace.clock() - t0) * 1e3
        self.recovery_ms.observe(dt_ms)
        rec.events.append({"event": "rollback", "kind": kind, "from_step": int(from_step),
                           "to_step": s.step, "backoff_s": hold, "recovery_ms": dt_ms})
        if obs_on:
            obs_metrics.counter("serve3d.guard.rollbacks").inc()
            obs_metrics.histogram("serve3d.guard.recovery_ms").observe(dt_ms)
        return "rolled_back"

    def _quarantine(self, s: SceneSession, rec: _SessionRecord, kind: str):
        with obs_trace.span("serve3d/guard_quarantine", cat="serve3d",
                            args={"session": s.session_id, "kind": kind}):
            tree = rec.last_good if rec.last_good is not None else self._init_tree(s)
            s.quarantine(tree)
        self.quarantined.append(s.session_id)
        rec.events.append({"event": "quarantine", "kind": kind,
                           "step": int(rec.last_good_step)})
        if obs_trace.enabled():
            obs_metrics.counter("serve3d.guard.quarantined").inc()

    def _checkpoint(self, s: SceneSession, rec: _SessionRecord):
        """Take a last-good host tree (only after the slice passed its
        checks, the forced deep check included)."""
        if s.state is None:           # already suspended (a finished member)
            rec.last_good = s._host_tree
        else:
            rec.last_good = s.trainer.suspend(s.state)
        rec.last_good_step = s.step
        self.checkpoints += 1
        if self.cfg.persist and s.ckpt is not None and s.state is not None:
            s.ckpt.save(s.step, rec.last_good)
        if obs_trace.enabled():
            obs_metrics.counter("serve3d.guard.checkpoints").inc()

    @staticmethod
    def _init_tree(s: SceneSession) -> dict:
        """The step-0 fallback: `init` from the session's own seed is the
        state the session started from, bit for bit."""
        return s.trainer.suspend(s._init_state())

    # ---- telemetry ----

    def session_events(self, session_id: str) -> list[dict]:
        rec = self._rec.get(session_id)
        return list(rec.events) if rec else []

    def stats(self) -> dict:
        return {
            "rollbacks": self.rollbacks,
            "quarantined": list(self.quarantined),
            "divergences": dict(self.divergences),
            "checkpoints": self.checkpoints,
            "recovery_ms": {"count": self.recovery_ms.count,
                            "p50": self.recovery_ms.quantile(0.50),
                            "p95": self.recovery_ms.quantile(0.95)},
            "inspect_wall_s": self.inspect_wall_s,
        }
