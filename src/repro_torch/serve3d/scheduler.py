"""Session scheduler: time-slice cards across many training sessions.

The port of `repro.serve3d.scheduler`.  Two policies over the
resident set:

* ``round_robin`` (default) -- fair rotation; every live session advances
  one slice per cycle, so an interleaved run equals sequential training
  at equal per-scene step counts;
* ``edf`` -- earliest-deadline-first; sessions carry a deadline (seconds
  since submission) and the most urgent live session trains next; ties and
  sessions without one fall back to round-robin order.

Residency: at most ``max_resident`` sessions hold device state at once;
the rest queue.  When a resident session finishes, its slot goes to the
next queued session (``start`` for a fresh job, ``resume`` for a
suspended one), the continuous-batching slot reset.

Train cohorts (``max_cohort``): sessions whose cohort keys match (same
configs, same absolute step) advance with the quantum's primary session
through `SceneSession.run_cohort_slice`, which equals time-slicing bit for
bit.  Under round-robin a session that rode along in another's cohort
holds a slice credit and skips its own next turn, so every session
advances at the same rate; under EDF the urgent session stays primary.

Faults (`serve3d.guard`): with ``capture_errors`` on, an exception inside
a slice is parked in ``last_error`` / ``last_errors`` for the guard instead
of unwinding the loop.  Sessions in guard backoff are skipped, QUARANTINED
ones are terminal, and a per-session straggler watchdog (EWMA of slice
wall time) deprioritises a flagged session one turn through the credit
mechanism.

Placement (``placement``, a `serve3d.placement.DevicePlacement`): every
admitted session gets a slot (sticky least-loaded) and is `place`d on its
device, ``max_resident`` caps residency per device, and with more than one
slot each quantum advances one cohort per slot at once, on a thread pool
(`_step_multi`, threads ``serve3d-dev_*``).  Cohort keys carry the slot,
so cohorts never straddle slots.  A fault fails only its own slot's
cohort (``last_errors`` is per session).  Each session's training math is
untouched, so every bit-identity contract of the one-card scheduler holds,
and one slot is the placement-free path bit for bit.  `close` shuts the
pool down.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime.driver import StragglerStats
from .session import ACTIVE, DONE, PENDING, QUARANTINED, SUSPENDED, SceneSession


class SessionScheduler:
    def __init__(self, slice_iters: int = 16, policy: str = "round_robin",
                 max_resident: int | None = None, max_cohort: int | None = 1,
                 straggler_sigma: float = 4.0, straggler_alpha: float = 0.25,
                 placement=None):
        """max_cohort: largest train cohort formed around a quantum's
        primary session (1 = pure time-slicing, None = no cap).
        placement: a `DevicePlacement`; ``max_resident`` is then a
        per-device cap and each quantum advances one cohort per slot."""
        if policy not in ("round_robin", "edf"):
            raise ValueError(f"unknown policy {policy!r}")
        self.slice_iters = int(slice_iters)
        self.policy = policy
        self.max_resident = max_resident
        self.max_cohort = max_cohort
        self.placement = placement
        self._pool: ThreadPoolExecutor | None = None
        self.sessions: list[SceneSession] = []
        self._rr = 0  # round-robin cursor
        # sessions advanced as non-primary cohort members hold a slice credit
        self._credit: dict[str, int] = {}
        self.last_trained: list[SceneSession] = []
        self.capture_errors = False
        self.last_error: Exception | None = None
        self.last_errors: dict[str, Exception] = {}
        self.straggler_sigma = float(straggler_sigma)
        self.straggler_alpha = float(straggler_alpha)
        self._straggler: dict[str, StragglerStats] = {}
        self.stragglers_flagged = 0

    # ---- membership ----

    def add(self, session: SceneSession):
        self.sessions.append(session)
        self._admit()

    def live(self) -> list[SceneSession]:
        # QUARANTINED is terminal: it must not keep the loop alive
        return [s for s in self.sessions if s.status not in (DONE, QUARANTINED)]

    @property
    def all_done(self) -> bool:
        return not self.live()

    # ---- slot admission ----

    def _resident_count(self, slot: int | None = None) -> int:
        return sum(1 for s in self.sessions
                   if s.resident and s.status != DONE
                   and (slot is None or s.device_slot == slot))

    def _admit(self):
        """Fill free slots with queued sessions: submission order under
        round-robin, most urgent first under EDF.  Residents are never
        preempted.  With a placement, admission assigns the session's slot
        and the cap applies per device: a full device defers only its own
        queued sessions."""
        cap = self.max_resident if self.max_resident is not None else len(self.sessions)
        queued = [s for s in self.sessions if s.status in (PENDING, SUSPENDED)]
        if self.policy == "edf":
            queued.sort(key=lambda s: (s.deadline is None,
                                       (s.submitted_at + s.deadline)
                                       if s.deadline is not None else 0.0))
        for s in queued:
            if self.placement is not None:
                slot = self.placement.assign(s.session_id)
                if self._resident_count(slot) >= cap:
                    continue
                if s.device_slot != slot:
                    s.place(self.placement.device_for_slot(slot), slot)
            elif self._resident_count() >= cap:
                break
            if s.status == PENDING:
                s.start()
            else:
                s.resume()

    # ---- selection ----

    def next_session(self) -> SceneSession | None:
        """The session to train next; None when everything is done."""
        self._admit()
        live = [s for s in self.sessions if s.status == ACTIVE]
        if not live:
            return None
        now = obs_trace.clock()
        ready = [s for s in live if s.hold_until <= now]
        if not ready:
            # every active session is in guard backoff: sleep to the
            # earliest release instead of spinning
            time.sleep(max(0.0, min(s.hold_until for s in live) - now))
            now = obs_trace.clock()
            ready = live
        return self._select(ready, now, slot=None)

    def _select(self, ready: list[SceneSession], now: float,
                slot: int | None) -> SceneSession | None:
        """Policy selection over a ready set; with `slot`, over that slot's
        sessions only (None when it has none: the slot sits the quantum
        out)."""
        if slot is not None:
            ready = [s for s in ready if s.device_slot == slot]
            if not ready:
                return None
        if self.policy == "edf":
            # deadlines outrank slice credits
            with_deadline = [s for s in ready if s.deadline is not None]
            if with_deadline:
                return min(with_deadline, key=lambda s: s.submitted_at + s.deadline)
        # fair rotation over the stable session list; one extra lap bounds
        # the case where every live session holds a credit
        for _ in range(2 * len(self.sessions)):
            s = self.sessions[self._rr % len(self.sessions)]
            self._rr += 1
            if s.status == ACTIVE and s.hold_until <= now and \
                    (slot is None or s.device_slot == slot):
                if self._credit.get(s.session_id, 0) > 0:
                    self._credit[s.session_id] -= 1
                    continue
                return s
        return ready[0]

    def cohort_for(self, primary: SceneSession) -> list[SceneSession]:
        """The primary plus every other ready ACTIVE session with a matching
        cohort key, in submission order, capped at max_cohort."""
        cap = self.max_cohort if self.max_cohort is not None else len(self.sessions)
        if cap <= 1:
            return [primary]
        key = primary.cohort_key()
        now = obs_trace.clock()
        members = [primary]
        for s in self.sessions:
            if len(members) >= cap:
                break
            if s is not primary and s.status == ACTIVE and \
                    s.hold_until <= now and s.cohort_key() == key:
                members.append(s)
        return members

    def step(self) -> SceneSession | None:
        """One scheduling quantum: pick a primary, form its cohort, advance
        it one slice, then reset the slot of any member that finished.
        Returns the primary; `last_trained` lists every advanced session.
        With more than one placement slot, one cohort per slot advances at
        once (`_step_multi`); the primary returned is the lowest slot's."""
        if self.placement is not None and self.placement.n > 1:
            return self._step_multi()
        primary = self.next_session()
        if primary is None:
            self.last_trained = []
            return None
        cohort = self.cohort_for(primary)
        if obs_trace.enabled():
            obs_metrics.gauge("serve3d.cohort_size").set(len(cohort))
        self.last_error = None
        self.last_errors = {}
        err, wall = self._run_cohort(cohort)
        if err is not None:
            self.last_error = err
            self.last_errors = {m.session_id: err for m in cohort}
        else:
            self._watch_stragglers(cohort, wall)
        self._finish_members(cohort)
        self.last_trained = cohort
        return primary

    def _run_cohort(self, cohort: list[SceneSession]) -> tuple:
        """Advance one cohort one slice -> (error, wall_s).  With
        ``capture_errors`` the error is parked for the guard, which rolls
        every member back; no rider credits, no straggler sample."""
        t0 = obs_trace.clock()
        try:
            if len(cohort) == 1:
                cohort[0].run_slice(self.slice_iters)
            else:
                SceneSession.run_cohort_slice(cohort, self.slice_iters)
                for rider in cohort[1:]:
                    self._credit[rider.session_id] = self._credit.get(rider.session_id, 0) + 1
        except Exception as e:
            if not self.capture_errors:
                raise
            return e, obs_trace.clock() - t0
        return None, obs_trace.clock() - t0

    def _finish_members(self, trained: list[SceneSession]):
        for s in trained:
            if s.status == DONE:
                self._credit.pop(s.session_id, None)
                if self.max_resident is not None and s.resident:
                    # bounded residency: a finished job releases its device
                    # memory (publish / evaluate work from the host tree)
                    s.suspend(block=False)
                if self.placement is not None:
                    # the slot's load returns to the admission pool; the
                    # mapping stays, so the scene's snapshots still render
                    self.placement.release(s.session_id)
        if any(s.status == DONE for s in trained):
            self._admit()  # slot reset

    def _step_multi(self) -> SceneSession | None:
        """The multi-device quantum: admit, pick one primary per slot, and
        advance every slot's cohort at once, one pool thread per busy slot.
        Each session's math is the one-card path's, and the draws are keyed
        by the absolute step, so the bytes equal any sequential schedule of
        the same slices."""
        self._admit()
        self.last_error = None
        self.last_errors = {}
        now = obs_trace.clock()
        live = [s for s in self.sessions if s.status == ACTIVE]
        ready = [s for s in live if s.hold_until <= now]
        if live and not ready:
            # every active session is in guard backoff
            time.sleep(max(0.0, min(s.hold_until for s in live) - now))
            now = obs_trace.clock()
            ready = live
        work: list[tuple[int, SceneSession, list[SceneSession]]] = []
        for slot in range(self.placement.n):
            primary = self._select(ready, now, slot=slot)
            if primary is not None:
                work.append((slot, primary, self.cohort_for(primary)))
        if not work:
            self.last_trained = []
            return None
        if obs_trace.enabled():
            obs_metrics.gauge("serve3d.cohort_size").set(max(len(c) for _, _, c in work))
            obs_metrics.gauge("serve3d.devices_busy").set(len(work))
        if len(work) == 1:
            outcomes = [self._run_cohort(work[0][2])]
        else:
            outcomes = list(self._ensure_pool().map(lambda w: self._run_cohort(w[2]), work))
        trained: list[SceneSession] = []
        for (_slot, _primary, cohort), (err, wall) in zip(work, outcomes):
            trained.extend(cohort)
            if err is not None:
                # the fault fails its own slot's cohort only
                self.last_errors.update({m.session_id: err for m in cohort})
                if self.last_error is None:
                    self.last_error = err
            else:
                self._watch_stragglers(cohort, wall)
        self._finish_members(trained)
        self.last_trained = trained
        return work[0][1]

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.placement.n,
                                            thread_name_prefix="serve3d-dev")
        return self._pool

    def close(self) -> None:
        """Shut the slot threads down (a later quantum starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _watch_stragglers(self, cohort: list[SceneSession], wall_s: float):
        """Per-session EWMA watchdog over slice wall time; a flagged
        session is deprioritised one turn (a slice credit), never blocked."""
        dt = wall_s / len(cohort)
        for s in cohort:
            stats = self._straggler.setdefault(s.session_id, StragglerStats())
            if stats.update(dt, self.straggler_sigma, self.straggler_alpha):
                self.stragglers_flagged += 1
                self._credit[s.session_id] = self._credit.get(s.session_id, 0) + 1
                if obs_trace.enabled():
                    obs_metrics.counter("serve3d.straggler.flagged").inc()
                    obs_trace.instant("serve3d/straggler", cat="serve3d",
                                      args={"session": s.session_id, "slice_s": dt,
                                            "ewma_s": stats.ewma})
