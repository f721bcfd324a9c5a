"""Snapshot store: atomic publish of a session's params for rendering.

The port of `repro.serve3d.snapshot`.  Renders never read live training
tensors: they read the last *published* snapshot, an immutable host copy
(``.detach().cpu().clone()`` of every leaf).  Publish builds the whole
record first and swaps one dict slot under a lock, so a reader sees either
the previous or the new snapshot, never a torn mix.

Levels (progressive streaming): level 0 is the full-resolution snapshot,
level k > 0 a preview that renders at h>>k.  `latest` prefers level 0 and
falls back to the lowest preview level; `gc_previews` drops a session's
previews.  Versions are monotone per session across levels.

With ``persist_dir`` set, each full (level-0) publish also lands in a
per-session `CheckpointManager` directory (``<persist_dir>/<session>``,
the atomic tmp-then-rename protocol, ``keep_last`` steps kept), holding
``params`` and, when published, ``occ_ema`` / ``occ_step`` -- the
reference's layout, so a restarted service of either package can serve
the scene again without retraining.  `wait` blocks until those writes
have committed.

Fault site ``serve3d.snapshot_publish`` (kind ``snapshot_fail``) raises
before the swap, so the previous snapshot stays the session's latest.
"""
from __future__ import annotations

import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..testing import faults


class Snapshot(NamedTuple):
    session_id: str
    version: int        # monotone per session, starts at 1
    step: int           # training step the params were taken at
    params: Any         # host (CPU) param dict -- immutable by contract
    meta: dict
    # (density EMA (R^3,) CPU tensor, fold count) at the published step, or
    # None for a params-only publisher; the redistributed render path
    # rebuilds the occupancy bitfield from it
    occ: Any = None
    # 0 = full resolution; k > 0 = preview (renders resolve at h>>k)
    level: int = 0


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return torch.as_tensor(tree).detach().cpu().clone()


class SnapshotStore:
    def __init__(self, persist_dir: str | None = None, keep_last: int = 2):
        # session -> level -> latest snapshot at that level
        self._latest: dict[str, dict[int, Snapshot]] = {}
        self._versions: dict[str, int] = {}
        self._lock = threading.Lock()
        self.persist_dir = persist_dir
        self.keep_last = keep_last
        self._ckpts: dict[str, CheckpointManager] = {}

    def publish(self, session_id: str, params, step: int, meta: dict | None = None,
                occ=None, level: int = 0) -> Snapshot:
        """Copy params (+ occupancy (ema, step)) to the host and atomically
        make them the session's latest at `level`."""
        with obs_trace.span("serve3d/snapshot_publish", cat="serve3d",
                            args={"session": session_id, "step": int(step),
                                  "level": int(level)}):
            inj = faults.check("serve3d.snapshot_publish", session=session_id,
                               step=int(step))
            if inj is not None and inj.kind == "snapshot_fail":
                raise faults.InjectedFault(
                    f"injected publish failure for {session_id} at step {step}")
            host = _host_copy(params)
            host_occ = None if occ is None else (
                torch.as_tensor(occ[0]).detach().cpu().clone(), int(occ[1]))
            with self._lock:
                version = self._versions.get(session_id, 0) + 1
                self._versions[session_id] = version
                snap = Snapshot(session_id=session_id, version=version,
                                step=int(step), params=host, meta=dict(meta or {}),
                                occ=host_occ, level=int(level))
                self._latest.setdefault(session_id, {})[int(level)] = snap
            if self.persist_dir is not None and level == 0:
                self._persist(snap)
        if obs_trace.enabled():
            obs_metrics.counter("serve3d.snapshots_published").inc()
            if level > 0:
                obs_metrics.counter("serve3d.previews_published").inc()
        return snap

    def _persist(self, snap: Snapshot) -> None:
        ckpt = self._ckpts.get(snap.session_id)
        if ckpt is None:
            ckpt = self._ckpts[snap.session_id] = CheckpointManager(
                f"{self.persist_dir}/{snap.session_id}", keep_last=self.keep_last)
        tree = {"params": snap.params}
        if snap.occ is not None:
            tree["occ_ema"] = snap.occ[0]
            tree["occ_step"] = np.asarray(snap.occ[1], np.int32)
        ckpt.save(snap.step, tree, extra={"version": snap.version, **snap.meta})

    def latest(self, session_id: str, level: int | None = None) -> Snapshot | None:
        """The session's latest snapshot: at exactly `level` when given,
        otherwise the full one, falling back to the lowest-level preview."""
        with self._lock:
            by_level = self._latest.get(session_id)
            if not by_level:
                return None
            if level is not None:
                return by_level.get(int(level))
            return by_level.get(0) or by_level[min(by_level)]

    def gc_previews(self, session_id: str) -> int:
        """Drop every preview (level > 0) of a session; returns how many.
        The full snapshot stays."""
        with self._lock:
            by_level = self._latest.get(session_id)
            if not by_level:
                return 0
            previews = [lv for lv in by_level if lv > 0]
            for lv in previews:
                del by_level[lv]
        if previews and obs_trace.enabled():
            obs_metrics.counter("serve3d.previews_gcd").inc(len(previews))
        return len(previews)

    def levels(self, session_id: str) -> list[int]:
        with self._lock:
            return sorted(self._latest.get(session_id, {}))

    def sessions(self) -> list[str]:
        with self._lock:
            return sorted(self._latest)

    def wait(self):
        """Block until every persisted write has committed."""
        for ckpt in self._ckpts.values():
            ckpt.wait()
