"""RenderService: batched novel-view rendering from published snapshots.

The port of `repro.serve3d.render`.  Requests target a session; the
service resolves each against the session's latest published snapshot at
drain time, so a render always sees one consistent, fully-published view.
A request whose session has not published yet stays queued.

Coalescing: pending requests are grouped by geometry (field config, render
config, image size, focal, chunk, serving path and budget, level); a group
takes the trainer's batched render entry (`repro_torch.core.trainer`) of
(chunk, its size padded to a power of two by `_pow2_bucket`), the key the
reference's vmapped entry of the padded group has.  The reference renders
the padding (repeats of the last request) and drops its pixels; the
port's entry loops over members, so only the real ones render: on a card
each member's chunks are replays of the one CUDA graph that every group
size of the chunk, budget and path shares.  A drain runs under
`torch.no_grad()`.

Serving paths: a session registered with ``samples_per_ray`` renders
through pipeline stage 2b (the snapshot's occupancy EMA rebuilds the
bitfield, S' samples per ray are shaded; with ``redistribute_v3`` the
chunk's budget is spread over its rays by their EMA-weighted live masses);
``None`` serves dense, which is also the fallback for snapshots without
occupancy.

Levels: level 0 renders full resolution from a full snapshot; level k > 0
renders at h>>k and is answerable by a preview snapshot.

Device: every group renders on the service's device (``"cuda"`` unless the
caller passes ``device="cpu"``), or, with a `DevicePlacement`, on the
device holding its sessions' training state, looked up at drain time: the
group key carries that device, so a group never straddles devices (slots
that share a card share its groups) and a moved session's renders follow
it.  On a card the service
owns one CUDA stream per device, made on the device's first group, and
every group, sync or async, runs under that device and its stream: the
kernels launch on the current stream, so a render's kernels can overlap a
training slice's (which run on the default stream), and no tensor of a
render is used on another stream.  The device copy of each session's
latest snapshot is kept per (session, device), made on that device's
stream, used only there, and kept until the session publishes a newer
one.  On the CPU there is no stream; the code path is otherwise the same.

Async serving plane (`start_async`): a serving thread drives the drain
loop, so a render need not wait for the end of the training slice in
flight.  It drains whenever work is pending -- woken by `submit` and
`notify`, and every 0.1 s, so deadlines expire while the trainer runs --
and keeps the results for `poll_results`.  The ordering contract is the
reference's: requests are answered from published snapshots only, each
drain's results are ordered by request id, and one drain runs at a time,
sync or async, so pixels are the bytes a sync drain of the same snapshot
version gives.  Where the reference's plane rests on XLA releasing the GIL
while a slice runs, here the two threads share it: PyTorch releases it
inside its ops, the Python between them does not.  A serving thread that
raises stops, and `stop_async` re-raises its exception; nothing falls back
to the sync drain.

Degradation ladder:

* deadlines -- a request still queued past ``deadline_s`` (or the
  service's ``default_deadline_s``) is answered with
  `RenderError("deadline_expired")` at the next drain;
* shedding -- past ``shed_threshold`` ready requests, a drain halves every
  redistributed session's per-ray budget (floor 2);
* retry -- an exception inside a group's render re-queues its requests;
  after ``max_attempts`` a request gets `RenderError("render_failed")`;
* staleness -- results for sessions marked with `mark_stale` carry
  ``stale=True``.

Fault site ``serve3d.render_group`` (kind ``render_fail``,
`repro_torch.testing.faults`) raises inside a group's render, which the
retry rung then handles.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import rendering
# the render caches live with the trainer's eval renderers: one entry
# serves `Instant3DTrainer.evaluate` and this service
from ..core.trainer import (
    batched_redistributed_render_fn, batched_render_fn, image_rays,
)
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..testing import faults
from .snapshot import Snapshot, SnapshotStore


def _pow2_bucket(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclass
class _SessionGeom:
    field_cfg: Any
    render_cfg: rendering.RenderConfig
    h: int
    w: int
    focal: float
    eval_chunk: int
    occ_cfg: Any = None                 # OccupancyConfig for the bitfield
    samples_per_ray: int | None = None  # None => dense serving
    redistribute_v3: bool = False       # stage 2b v3 on the redistributed path


@dataclass
class RenderRequest:
    request_id: int
    session_id: str
    pose: np.ndarray
    submitted_at: float = dc_field(default_factory=obs_trace.clock)
    deadline_s: float | None = None   # None = no per-request deadline
    attempts: int = 0                 # failed group renders so far
    level: int = 0                    # 0 = full res; k > 0 = preview at h>>k


class RenderResult(NamedTuple):
    request_id: int
    session_id: str
    rgb: np.ndarray       # (H, W, 3)
    depth: np.ndarray     # (H, W)
    snapshot_version: int
    snapshot_step: int
    latency_s: float
    stale: bool = False   # pixels valid, but the session's training is behind
    level: int = 0        # resolution level the pixels were rendered at


class RenderError(NamedTuple):
    """Typed failure answer: a request that cannot be served errors out
    instead of hanging in the queue."""
    request_id: int
    session_id: str
    error: str            # "deadline_expired" | "render_failed"
    latency_s: float


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class RenderService:
    def __init__(self, store: SnapshotStore, latency_window: int = 4096,
                 default_deadline_s: float | None = None,
                 shed_threshold: int | None = None,
                 max_attempts: int = 2, device="cuda", placement=None):
        """default_deadline_s: deadline of requests submitted without one
        (None = never expire).  shed_threshold: ready-queue depth above
        which a drain halves redistributed budgets (None = never shed).
        max_attempts: group renders per request before it errors.
        device: where every group renders without a placement.
        placement: a `DevicePlacement`; a group then renders on the device
        holding its sessions (an unplaced session's on `device`)."""
        self.store = store
        self.default_deadline_s = default_deadline_s
        self.shed_threshold = shed_threshold
        self.max_attempts = int(max_attempts)
        self.device = torch.device(device)
        self.placement = placement
        self._geom: dict[str, _SessionGeom] = {}
        self._queue: list[RenderRequest] = []
        self._next_id = 0
        self._stale: set[str] = set()
        # the queue, the async results and the latency bookkeeping are
        # shared with the serving thread under this lock
        self._lock = threading.Lock()
        self._drain_mutex = threading.Lock()   # one drain at a time
        # card -> the render stream every group on it runs on
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        # (session, device) -> (snapshot version, params, occ ema) on that
        # device, made and used on its render stream only
        self._resident: dict[tuple, tuple[int, dict, Any]] = {}
        # async serving plane
        self._async_thread: threading.Thread | None = None
        self._async_stop = threading.Event()
        self._async_wake = threading.Event()
        self._async_results: list = []
        self._async_error: BaseException | None = None
        self._draining = False
        self.expired = 0
        self.failed = 0
        self.shed_drains = 0
        self.drains = 0
        self.latency_window = int(latency_window)
        self.latencies: dict[str, obs_metrics.Histogram] = {}
        self.served: dict[str, int] = {}
        # TTFUV: register -> first served view, per session
        self._registered_at: dict[str, float] = {}
        self.ttfuv_s: dict[str, float] = {}

    # ---- registration / submission ----

    def register_session(self, session_id: str, field_cfg, render_cfg,
                         h: int, w: int, focal: float, eval_chunk: int = 4096,
                         occ_cfg=None, samples_per_ray: int | None = None,
                         redistribute_v3: bool = False):
        """samples_per_ray: serve through the redistributed path at that
        per-ray budget (needs occ_cfg to threshold the snapshot's EMA);
        None serves dense.  redistribute_v3: spend that budget
        density-weighted and unevenly across each chunk's rays (stage 2b
        v3), as a v3 trainer trains."""
        if samples_per_ray is not None and occ_cfg is None:
            raise ValueError("samples_per_ray needs occ_cfg for the bitfield")
        self._geom[session_id] = _SessionGeom(
            field_cfg, render_cfg, int(h), int(w), float(focal), int(eval_chunk),
            occ_cfg=occ_cfg,
            samples_per_ray=None if samples_per_ray is None else int(samples_per_ray),
            redistribute_v3=bool(redistribute_v3),
        )
        self._registered_at.setdefault(session_id, obs_trace.clock())

    def submit(self, session_id: str, pose: np.ndarray,
               deadline_s: float | None = None, level: int = 0) -> int:
        """Queue a render of `pose`; level k > 0 asks for the h>>k preview."""
        if session_id not in self._geom:
            raise KeyError(f"unknown session {session_id!r}")
        with self._lock:
            req = RenderRequest(self._next_id, session_id, np.asarray(pose),
                                deadline_s=(deadline_s if deadline_s is not None
                                            else self.default_deadline_s),
                                level=int(level))
            self._next_id += 1
            self._queue.append(req)
        self._async_wake.set()
        return req.request_id

    def mark_stale(self, session_id: str, stale: bool = True) -> None:
        """Results for this session carry ``stale=True`` until cleared."""
        if stale:
            self._stale.add(session_id)
        else:
            self._stale.discard(session_id)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---- async serving plane ----

    @property
    def async_active(self) -> bool:
        """The serving thread is alive."""
        return self._async_thread is not None and self._async_thread.is_alive()

    @property
    def async_started(self) -> bool:
        """`start_async` ran and `stop_async` has not: the plane owns the
        drains, even if its thread has died (`stop_async` then re-raises)."""
        return self._async_thread is not None

    @property
    def idle(self) -> bool:
        """No drain in flight and no async result undelivered."""
        with self._lock:
            return not self._draining and not self._async_results

    def start_async(self, poll_s: float = 0.002) -> None:
        """Start the serving thread: it drains whenever work is pending and
        keeps the results for `poll_results`; while requests wait for a
        snapshot it waits `poll_s` for a `notify`, then up to 0.1 s.
        Idempotent."""
        if self.async_active:
            return
        self.stop_async()   # a thread that died: re-raise what it died of
        self._async_stop.clear()

        def serve():
            try:
                while not self._async_stop.is_set():
                    self._async_wake.wait(timeout=0.1)
                    self._async_wake.clear()
                    while self.pending and not self._async_stop.is_set():
                        self._serve(collect=True)
                        if self.pending:
                            # the rest await a publish: yield until the next
                            # notify instead of spinning
                            if not self._async_wake.wait(timeout=poll_s):
                                break
                            self._async_wake.clear()
            except BaseException as e:
                # kept for stop_async to re-raise in the caller's thread;
                # raised here too, so the thread's excepthook reports it
                self._async_error = e
                raise

        self._async_thread = threading.Thread(target=serve, name="serve3d-render",
                                              daemon=True)
        self._async_thread.start()

    def notify(self) -> None:
        """Wake the serving thread: a snapshot landed, work may be ready."""
        self._async_wake.set()

    def stop_async(self, wait: bool = True) -> None:
        """Stop the serving thread (joining it when `wait`), and re-raise
        the exception it died of, if any.  Results it finished stay for
        `poll_results`."""
        if self._async_thread is None:
            return
        self._async_stop.set()
        self._async_wake.set()
        if wait:
            self._async_thread.join()
        self._async_thread = None
        err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def poll_results(self) -> list:
        """Everything the async plane finished since the last poll, each
        drain's results in request-id order."""
        with self._lock:
            out, self._async_results = self._async_results, []
        return out

    # ---- serving ----

    def drain(self) -> list:
        """Serve every pending request whose session has a published
        snapshot; the rest stay queued.  Returns `RenderResult`s and typed
        `RenderError`s, ordered by request id.  Serialized with the async
        plane's drains."""
        return self._serve(collect=False)

    def _serve(self, collect: bool) -> list:
        """One drain; with `collect`, its results join the async results
        before the drain counts as finished, so `idle` never reads true
        between the two."""
        with self._drain_mutex:
            with self._lock:
                self._draining = True
            try:
                with obs_trace.span("serve3d/render_drain", cat="serve3d",
                                    args={"pending": self.pending}), torch.no_grad():
                    results = self._drain()
                if collect and results:
                    with self._lock:
                        self._async_results.extend(results)
            finally:
                with self._lock:
                    self._draining = False
        if obs_trace.enabled():
            obs_metrics.gauge("serve3d.render.queue_depth").set(self.pending)
        return results

    def _drain(self) -> list:
        self.drains += 1
        now = obs_trace.clock()
        results: list = []
        obs_on = obs_trace.enabled()
        with self._lock:
            queue, self._queue = self._queue, []

        # expiry first: a waiting request is guaranteed to terminate
        keep: list[RenderRequest] = []
        for req in queue:
            if req.deadline_s is not None and now - req.submitted_at > req.deadline_s:
                self.expired += 1
                if obs_on:
                    obs_metrics.counter("serve3d.render.expired").inc()
                results.append(RenderError(req.request_id, req.session_id,
                                           "deadline_expired", now - req.submitted_at))
            else:
                keep.append(req)

        # full-res requests wait for a full snapshot; previews take the best
        ready: list[tuple[RenderRequest, Snapshot]] = []
        waiting: list[RenderRequest] = []
        for req in keep:
            snap = (self.store.latest(req.session_id, level=0) if req.level == 0
                    else self.store.latest(req.session_id))
            if snap is None:
                waiting.append(req)
            else:
                ready.append((req, snap))
        with self._lock:
            self._queue.extend(waiting)

        shed = self.shed_threshold is not None and len(ready) > self.shed_threshold
        if shed:
            self.shed_drains += 1
            if obs_on:
                obs_metrics.counter("serve3d.render.shed_drains").inc()
                obs_trace.instant("serve3d/render_shed", cat="serve3d",
                                  args={"ready": len(ready)})

        # coalesce by geometry, serving path, level and the device the
        # placement gives now: groups never straddle devices and a moved
        # session renders where it trains
        groups: dict[tuple, list[tuple[RenderRequest, Snapshot]]] = {}
        for req, snap in ready:
            g = self._geom[req.session_id]
            spr = g.samples_per_ray
            if shed and spr is not None:
                spr = max(2, spr // 2)
            key = (g.field_cfg, g.render_cfg, g.h, g.w, g.focal, g.eval_chunk,
                   g.occ_cfg, spr, g.redistribute_v3, req.level,
                   self._placed(req.session_id))
            groups.setdefault(key, []).append((req, snap))

        for key, items in groups.items():
            try:
                results.extend(self._render_group(*key, items))
            except Exception:
                # the group's render died: re-queue its requests, and answer
                # the ones out of attempts with a typed error
                requeue = []
                for req, _snap in items:
                    req.attempts += 1
                    if req.attempts < self.max_attempts:
                        requeue.append(req)
                        continue
                    self.failed += 1
                    if obs_on:
                        obs_metrics.counter("serve3d.render.failed").inc()
                    results.append(RenderError(
                        req.request_id, req.session_id, "render_failed",
                        obs_trace.clock() - req.submitted_at))
                with self._lock:
                    self._queue.extend(requeue)
        results.sort(key=lambda r: r.request_id)
        return results

    def _placed(self, session_id: str) -> torch.device:
        """The device a session's renders run on: its placement's, or the
        service's device without one or while unplaced."""
        if self.placement is not None:
            dev = self.placement.device(session_id)
            if dev is not None:
                return torch.device(dev)
        return self.device

    def render_stream(self, dev=None) -> torch.cuda.Stream | None:
        """The render stream of card `dev` (default: the service's device),
        made on first use; None off CUDA."""
        dev = self.device if dev is None else torch.device(dev)
        if dev.type != "cuda":
            return None
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        return stream

    def _device_ctx(self, dev: torch.device):
        """`dev` as the current device and its render stream as the current
        stream; a no-op off CUDA."""
        stream = self.render_stream(dev)
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(stream.device))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def _resident_copy(self, snap: Snapshot, dev: torch.device):
        """(params, occ ema) of `snap` on `dev`, copied once per published
        version."""
        key = (snap.session_id, dev)
        cached = self._resident.get(key)
        if cached is None or cached[0] != snap.version:
            occ = None if snap.occ is None else snap.occ[0].to(dev)
            cached = (snap.version, _to_device(snap.params, dev), occ)
            self._resident[key] = cached
        return cached[1], cached[2]

    def _render_group(self, field_cfg, render_cfg, h, w, focal, eval_chunk,
                      occ_cfg, samples_per_ray, redistribute_v3, level, device,
                      items) -> list[RenderResult]:
        with obs_trace.span("serve3d/render_group", cat="serve3d",
                            args={"group": len(items),
                                  "redistribute": samples_per_ray is not None,
                                  "v3": bool(redistribute_v3),
                                  "level": int(level), "device": str(device),
                                  "sessions": sorted({r.session_id for r, _ in items})}), \
                self._device_ctx(device):
            return self._render_group_inner(field_cfg, render_cfg, h, w, focal,
                                            eval_chunk, occ_cfg, samples_per_ray,
                                            redistribute_v3, level, device, items)

    def _render_group_inner(self, field_cfg, render_cfg, h, w, focal, eval_chunk,
                            occ_cfg, samples_per_ray, redistribute_v3, level, dev,
                            items) -> list[RenderResult]:
        inj = faults.check("serve3d.render_group", session=items[0][0].session_id)
        if inj is not None and inj.kind == "render_fail":
            raise faults.InjectedFault("injected render-group failure")
        if level > 0:
            h = max(1, h >> level)
            w = max(1, w >> level)
        g_pad = _pow2_bucket(len(items))     # the entry's key, as the reference's
        origins, dirs = [], []
        n = chunk = None
        for req, _snap in items:
            o, d, n, chunk = image_rays(req.pose, h, w, focal, eval_chunk, device=dev)
            origins.append(o)
            dirs.append(d)
        origins = torch.stack(origins)   # (G, n_pad, 3)
        dirs = torch.stack(dirs)
        resident = [self._resident_copy(snap, dev) for _req, snap in items]
        params = [p for p, _occ in resident]
        ts = rendering.sample_ts(None, chunk, render_cfg, device=dev)

        # the redistributed path needs every snapshot to carry occupancy; a
        # params-only snapshot falls back to dense
        if samples_per_ray is not None and all(occ is not None for _p, occ in resident):
            occ_ema = [occ for _p, occ in resident]
            occ_step = torch.tensor([int(snap.occ[1]) for _req, snap in items],
                                    dtype=torch.int32, device=dev)
            fn = batched_redistributed_render_fn(field_cfg, render_cfg, occ_cfg, chunk, g_pad,
                                                 samples_per_ray,
                                                 redistribute_v3=redistribute_v3)
            rgb, dep = fn(params, origins, dirs, ts, occ_ema, occ_step)
        else:
            rgb, dep = batched_render_fn(field_cfg, render_cfg, chunk, g_pad)(
                params, origins, dirs, ts)
        rgb = rgb[:, :n].cpu().numpy()
        dep = dep[:, :n].cpu().numpy()

        now = obs_trace.clock()
        obs_on = obs_trace.enabled()
        out = []
        for gi, (req, snap) in enumerate(items):
            lat = now - req.submitted_at
            sid = req.session_id
            with self._lock:
                hist = self.latencies.get(sid)
                if hist is None:
                    hist = self.latencies[sid] = obs_metrics.Histogram(
                        window=self.latency_window)
                hist.observe(lat)
                first = sid not in self.ttfuv_s
                if first and sid in self._registered_at:
                    self.ttfuv_s[sid] = now - self._registered_at[sid]
                self.served[sid] = self.served.get(sid, 0) + 1
            if obs_on:
                obs_metrics.counter("serve3d.render.served").inc()
                obs_metrics.histogram("serve3d.render.latency_ms").observe(lat * 1e3)
                if first and sid in self.ttfuv_s:
                    obs_metrics.gauge(f"serve3d.render.ttfuv_s.{sid}").set(
                        self.ttfuv_s[sid])
            out.append(RenderResult(
                request_id=req.request_id,
                session_id=sid,
                rgb=rgb[gi].reshape(h, w, 3),
                depth=dep[gi].reshape(h, w),
                snapshot_version=snap.version,
                snapshot_step=snap.step,
                latency_s=lat,
                stale=sid in self._stale,
                level=int(level),
            ))
        return out

    # ---- telemetry ----

    def latency_stats(self) -> dict:
        """Percentiles over the recent latency window; counts are lifetime."""
        with self._lock:
            windows = [hist.values() for hist in self.latencies.values()]
            served, ttfuv = dict(self.served), dict(self.ttfuv_s)
        merged = obs_metrics.Histogram(window=self.latency_window * max(1, len(windows)))
        for values in windows:
            for v in values:
                merged.observe(v)
        degraded = {
            "expired": self.expired,
            "failed": self.failed,
            "shed_fraction": self.shed_drains / self.drains if self.drains else 0.0,
            "stale_sessions": sorted(self._stale),
        }
        if merged.count == 0:
            return {"count": 0, "degraded": degraded}
        return {
            "count": sum(served.values()),
            "degraded": degraded,
            "p50_ms": merged.quantile(0.50) * 1e3,
            "p95_ms": merged.quantile(0.95) * 1e3,
            "p99_ms": merged.quantile(0.99) * 1e3,
            "max_ms": max(merged.values()) * 1e3,
            "per_session": served,
            "ttfuv_s": ttfuv,
        }
