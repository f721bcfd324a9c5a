"""ReconstructionService: the serve3d facade.

The port of `repro.serve3d.service`.  One object owns the train -> snapshot
-> serve loop:

    service = ReconstructionService(slice_iters=16)
    sid = service.submit_scene(dataset, field_cfg, trainer_cfg, target_iters=256)
    service.request_render(sid, pose)            # answered mid-training
    telemetry = service.run()

Each `step()` is one quantum: the scheduler picks a primary live session
(round-robin or EDF) and forms its train cohort (every other active session
with matching configs at the same step; cap it with ``max_cohort``), trains
one slice, the guard inspects every advanced session, the healthy ones
publish their params and occupancy to the snapshot store, and the render
service drains every answerable request.  Renders read published snapshots,
never the live tensors, and are served through the redistributed path
(stage 2b at ``samples_per_ray`` per ray) unless ``redistributed_render``
is off.

Faults (on by default): the `SessionGuard` runs *before* publish, so a
diverged slice is rolled back and never reaches the store; after
``max_retries`` consecutive failures the session is quarantined and its
last-good snapshot is served, marked stale.  A publish that raised is
retried on the next quantum.  ``guard=None`` / ``False`` unwinds `run` on
any slice error.  ``snapshot_levels=k`` publishes level-k previews every
healthy slice until a session's first full snapshot lands.

``async_serving=True`` serves renders from the render service's serving
thread (`RenderService.start_async`): `run` starts it, each quantum hands
it the fresh snapshots (`notify`) and collects what it finished
(`poll_results`), and `run` stops it in ``finally``, delivering what came in
after the last quantum as one final hook event.  A serving thread that
raised makes `run` raise.  Trained bytes do not depend on the plane: a
render reads published host snapshots only, on its own CUDA stream.

Without ``devices``, every session trains and renders on ``device``
(``"cuda"`` unless the caller passes ``device="cpu"``).  ``devices`` shards
the sessions over a `DevicePlacement`: an int (the first n cards; more
than the machine has raises), an explicit list (``["cuda:0", "cuda:0"]``
puts two slots on one card, ``["cpu"] * 4`` four on the CPU) or None.  The
scheduler then caps residency per device and advances one cohort per slot
each quantum on its slot threads, renders run on their session's device,
and a finished or quarantined session's slot load is released.  One slot
is the placement-free service bit for bit.
"""
from __future__ import annotations

import time

from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .guard import GuardConfig, SessionGuard
from .placement import DevicePlacement
from .render import RenderService
from .scheduler import SessionScheduler
from .session import DONE, QUARANTINED, SceneSession
from .snapshot import SnapshotStore


class ReconstructionService:
    def __init__(self, slice_iters: int = 16, policy: str = "round_robin",
                 max_resident: int | None = None, persist_dir: str | None = None,
                 snapshot_every: int = 1, max_cohort: int | None = None,
                 redistributed_render: bool = True,
                 render_samples_per_ray: int | None = None,
                 guard: GuardConfig | bool | None = True,
                 render_deadline_s: float | None = None,
                 shed_threshold: int | None = None, devices=None,
                 snapshot_levels: int = 0, async_serving: bool = False,
                 device="cuda"):
        """snapshot_every: publish a session every k-th slice it trains (its
        final slice always publishes).  max_cohort: largest train cohort
        per quantum (None = unlimited, 1 = pure time-slicing).
        redistributed_render / render_samples_per_ray: serve through stage
        2b at S' per ray (default max(4, n_samples // 4), capped at
        n_samples) instead of dense.  guard: True (default `GuardConfig`),
        a `GuardConfig`, or None / False.  render_deadline_s /
        shed_threshold: forwarded to `RenderService`.  snapshot_levels: k >
        0 publishes level-k previews until the first full snapshot.
        async_serving: `run` serves renders from a serving thread.
        devices: shard sessions over a `DevicePlacement` (an int, a device
        list or None: see the module docstring); ``max_resident`` is then
        per device.  device: where every session trains and renders without
        ``devices``."""
        self.device = device
        self.placement = DevicePlacement(devices) if devices is not None else None
        self.async_serving = bool(async_serving)
        self.store = SnapshotStore(persist_dir=persist_dir)
        self.renderer = RenderService(self.store, default_deadline_s=render_deadline_s,
                                      shed_threshold=shed_threshold, device=device,
                                      placement=self.placement)
        self.scheduler = SessionScheduler(slice_iters=slice_iters, policy=policy,
                                          max_resident=max_resident, max_cohort=max_cohort,
                                          placement=self.placement)
        if guard is True:
            guard = GuardConfig()
        self.guard = SessionGuard(guard) if guard else None
        # with a guard, slice exceptions become rollbacks
        self.scheduler.capture_errors = self.guard is not None
        self.publish_failures = 0
        self._publish_retry: set[str] = set()
        self.sessions: dict[str, SceneSession] = {}
        self.snapshot_every = max(1, int(snapshot_every))
        self.snapshot_levels = max(0, int(snapshot_levels))
        self.redistributed_render = bool(redistributed_render)
        self.render_samples_per_ray = render_samples_per_ray
        # the serving clock starts at the first quantum, not construction
        self._started_at: float | None = None

    # ---- job submission ----

    def submit_scene(self, dataset, field_cfg, trainer_cfg, target_iters: int, *,
                     session_id: str | None = None, seed: int = 0,
                     deadline: float | None = None, ckpt_dir: str | None = None,
                     train_views=None) -> str:
        """Queue a scene job -> its session id.  train_views: the views its
        rays are drawn from (default all; the rest can be held out)."""
        sid = session_id if session_id is not None else f"scene-{len(self.sessions):03d}"
        if sid in self.sessions:
            raise ValueError(f"duplicate session id {sid!r}")
        sess = SceneSession(sid, dataset, field_cfg, trainer_cfg, target_iters,
                            seed=seed, ckpt_dir=ckpt_dir, deadline=deadline,
                            train_views=train_views, device=self.device)
        self.sessions[sid] = sess
        self.scheduler.add(sess)
        # redistribution reads the occupancy bitfield: a trainer without
        # occupancy would be served a uniform S' preview forever, so it
        # stays dense
        spr = None
        if self.redistributed_render and trainer_cfg.use_occupancy:
            s = trainer_cfg.render.n_samples
            spr = (self.render_samples_per_ray if self.render_samples_per_ray is not None
                   else min(s, max(4, s // 4)))
        # the session's `evaluate` marches the served path at this budget
        sess.render_spr = spr
        self.renderer.register_session(
            sid, field_cfg, trainer_cfg.render, dataset.h, dataset.w, dataset.focal,
            trainer_cfg.eval_chunk, occ_cfg=trainer_cfg.occ, samples_per_ray=spr,
            redistribute_v3=trainer_cfg.redistribute_v3)
        return sid

    def request_render(self, session_id: str, pose, deadline_s: float | None = None,
                       level: int = 0) -> int:
        """level 0 = full resolution (waits for a full snapshot); k > 0 =
        the h>>k preview."""
        return self.renderer.submit(session_id, pose, deadline_s=deadline_s, level=level)

    # ---- the serving loop ----

    def step(self) -> dict:
        """One quantum: train one cohort slice, guard-inspect every advanced
        session, publish the healthy ones, drain renders.  The guard runs
        before publish, so a diverged slice never reaches the store."""
        if self._started_at is None:
            self._started_at = obs_trace.clock()
        with obs_trace.span("serve3d/quantum", cat="serve3d",
                            args={"pending_renders": self.renderer.pending}):
            sess = self.scheduler.step()
            verdicts: dict[str, str] = {}
            if self.guard is not None and self.scheduler.last_trained:
                verdicts = self.guard.inspect(self.scheduler.last_trained,
                                              error=self.scheduler.last_error,
                                              errors=self.scheduler.last_errors or None)
            for member in self.scheduler.last_trained:
                verdict = verdicts.get(member.session_id, "ok")
                if verdict != "ok":
                    self.renderer.mark_stale(member.session_id)
                    if verdict == "quarantined":
                        # publish the restored last-good tree once, so the
                        # scene's renders are answered (stale)
                        self._publish(member)
                        self._retire(member.session_id)
                    continue
                slices = len(member.telemetry["step"])
                if (member.status == DONE or slices % self.snapshot_every == 0
                        or member.session_id in self._publish_retry):
                    self._publish(member)
                elif (self.snapshot_levels > 0
                      and self.store.latest(member.session_id, level=0) is None):
                    # progressive streaming: a preview every healthy slice
                    # until the first full snapshot lands
                    self._publish(member, level=self.snapshot_levels)
                if member.status == DONE:
                    self.store.gc_previews(member.session_id)
            if self.renderer.async_started:
                # the serving thread owns the drains: hand it the fresh
                # snapshots, collect what it finished since the last quantum
                self.renderer.notify()
                results = self.renderer.poll_results()
            else:
                results = self.renderer.drain()
        if obs_trace.enabled():
            obs_metrics.counter("serve3d.quanta").inc()
            obs_metrics.gauge("serve3d.sessions_active").set(sum(
                1 for s in self.sessions.values() if s.status not in (DONE, QUARANTINED)))
        return {
            "trained": sess.session_id if sess is not None else None,
            "cohort": [m.session_id for m in self.scheduler.last_trained],
            "step": sess.step if sess is not None else None,
            "guard": verdicts,
            "results": results,
        }

    def _publish(self, member: SceneSession, level: int = 0) -> None:
        """Publish, retrying on failure: the store's swap is atomic, so a
        raise leaves the previous snapshot the latest; a full publish that
        failed is tried again next quantum."""
        try:
            member.publish(self.store, level=level)
        except Exception:
            if self.guard is None:
                raise
            self.publish_failures += 1
            if level == 0:
                self._publish_retry.add(member.session_id)
            if obs_trace.enabled():
                obs_metrics.counter("serve3d.snapshot.publish_failures").inc()
        else:
            if level == 0:
                self._publish_retry.discard(member.session_id)
            if self.guard is None or member.session_id not in self.guard.quarantined:
                self.renderer.mark_stale(member.session_id, False)

    def _retire(self, session_id: str) -> None:
        """A quarantined session stops holding slot capacity and preview
        snapshots; its full snapshot keeps being served."""
        self.store.gc_previews(session_id)
        if self.placement is not None:
            self.placement.release(session_id)

    def run(self, hook=None, max_quanta: int = 100_000) -> dict:
        """Drive quanta until every session is done, the render queue is
        empty and (async serving) the serving thread is idle.
        `hook(service, event)` runs after each quantum -- the place to
        submit mid-training render requests or stream telemetry."""
        renderer = self.renderer
        if self.async_serving:
            renderer.start_async()
        try:
            for _ in range(max_quanta):
                if self.scheduler.all_done and renderer.pending == 0 and renderer.idle:
                    break
                if renderer.async_started and not renderer.async_active:
                    break   # the serving thread died: `finally` re-raises
                event = self.step()
                if hook is not None:
                    hook(self, event)
                if event["trained"] is None and renderer.async_started:
                    # only the serving thread has work: yield the GIL to it
                    time.sleep(0.002)
        finally:
            self.scheduler.close()    # no slot thread outlives the run
            if renderer.async_started:
                renderer.stop_async()
                final = renderer.poll_results()
                if final and hook is not None:
                    hook(self, {"trained": None, "cohort": [], "step": None,
                                "guard": {}, "results": final})
        self.store.wait()
        return self.telemetry()

    # ---- telemetry ----

    def progress(self) -> list[dict]:
        return [s.progress() for s in self.sessions.values()]

    def telemetry(self) -> dict:
        done = [s for s in self.sessions.values() if s.status == DONE]
        now = obs_trace.clock()
        wall = now - (self._started_at if self._started_at is not None else now)
        return {
            "wall_s": wall,
            "scenes_done": len(done),
            "scenes_per_sec": len(done) / wall if wall > 0 else 0.0,
            "sessions": self.progress(),
            "render": self.renderer.latency_stats(),
            "guard": self.guard.stats() if self.guard is not None else None,
            "publish_failures": self.publish_failures,
            "stragglers_flagged": self.scheduler.stragglers_flagged,
            "devices": self.placement.n if self.placement is not None else 1,
            "placement": self.placement.stats() if self.placement is not None else None,
            "async_serving": self.async_serving,
        }

    def metrics(self) -> dict:
        """The exportable metrics document: the obs registry snapshot under
        ``metrics`` and the always-on service plane (progress, snapshot
        versions, render latency) under ``meta.service``."""
        return obs_export.metrics_snapshot(extra={"service": {
            "telemetry": self.telemetry(),
            "snapshots": {sid: self.store.latest(sid).version for sid in self.store.sessions()},
        }})

    def dump_trace(self, path: str) -> str:
        """Write the span buffer as Chrome-trace JSON (Perfetto-loadable)."""
        return obs_export.dump_trace(path, process_name="repro_torch.serve3d")
