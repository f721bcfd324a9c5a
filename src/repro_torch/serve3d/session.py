"""SceneSession: one scene's reconstruction job as a schedulable unit.

The port of `repro.serve3d.session`.  It wraps `Instant3DTrainer`, the
session's ray sampler and an optional `CheckpointManager` behind a
suspend/resume lifecycle, so N sessions can time-share one card:

    pending --start()--> active --run_slice(n)*--> done
                 ^            |
                 '--resume()--'--suspend()--> suspended

Two guard transitions ride on top (`serve3d.guard`): `rollback(tree)`
replaces the live state with a last-good host tree through the resume
path, and `quarantine(tree)` is a terminal failure state that keeps the
last-good tree on the host so publishing and evaluation keep working.
`run_slice` and `run_cohort_slice` carry the ``serve3d.slice`` fault site
(`repro_torch.testing.faults`).

Training streams are keyed by the absolute step and the trainer's
bookkeeping survives suspend/resume, so an interleaved schedule equals
sequential training bit for bit at equal per-scene step counts.
`suspend` moves the whole state to host numpy (and to disk when the
session has a checkpoint dir); `resume` restores from the in-memory tree,
else from the newest valid checkpoint on disk (a fresh process).

Every tensor lives on the session's ``device`` (``"cuda"`` unless the
caller passes ``device="cpu"``).  `place` pins the session to a slot of a
`DevicePlacement` while it holds no device state (before `start`, or
suspended mid-move): the trainer and the ray sampler follow the new device,
and `start` / `resume` materialize there.  Every entry point that touches
the device runs under `_device_ctx` (`torch.cuda.device` of the session's
card), so the current device is the session's in whatever thread drives
it.  The draws come from CPU generators keyed by the absolute step, so a
move is bit-transparent.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any

import torch

from ..checkpoint import CheckpointManager
from ..core import field as field_lib
from ..core.trainer import Instant3DTrainer, TrainerConfig, TrainState, train_cohort
from ..data.rays_dataset import RaySampler
from ..obs import trace as obs_trace
from ..testing import faults

PENDING = "pending"
ACTIVE = "active"
SUSPENDED = "suspended"
DONE = "done"
QUARANTINED = "quarantined"


class SceneSession:
    def __init__(self, session_id: str, dataset, field_cfg: field_lib.FieldConfig,
                 trainer_cfg: TrainerConfig, target_iters: int, *, seed: int = 0,
                 ckpt_dir: str | None = None, deadline: float | None = None,
                 train_views=None, device="cuda"):
        """train_views: the views the session's rays are drawn from (default
        all), so the others can be held out for `evaluate`."""
        self.session_id = session_id
        self.dataset = dataset
        self.field_cfg = field_cfg
        self.trainer_cfg = trainer_cfg
        self.target_iters = int(target_iters)
        self.seed = seed
        self.deadline = deadline  # seconds-since-submit budget for EDF
        self.field = field_lib.Field(field_cfg)
        self.trainer = Instant3DTrainer(self.field, trainer_cfg, device=device)
        self.sampler = RaySampler(dataset, views=train_views, device=device)
        self.ckpt = CheckpointManager(ckpt_dir, keep_last=2) if ckpt_dir else None
        self.state: TrainState | None = None
        self._host_tree: dict | None = None
        # the slot of a placed session (serve3d.placement); None unplaced
        self.device_slot: int | None = None
        # samples per ray the service serves this session's renders at
        # (None = dense); `evaluate` marches the same quadrature
        self.render_spr: int | None = None
        self.status = PENDING
        self.hold_until = 0.0  # guard backoff: the scheduler skips until then
        self.submitted_at = obs_trace.clock()
        self.train_wall_s = 0.0
        self.telemetry: dict[str, list] = {"step": [], "loss": [], "live_fraction": []}

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def place(self, device, slot: int | None = None) -> None:
        """Pin this session to a placement slot and its device.  Legal while
        the session holds no device state (before `start`, or suspended):
        the next `start` / `resume` materializes on the new device, the
        ray sampler's rays included."""
        assert self.state is None, \
            f"{self.session_id}: suspend before moving a resident session"
        self.trainer.device = torch.device(device)
        self.device_slot = slot

    def _device_ctx(self):
        """The session's card as the current device (a no-op off CUDA)."""
        dev = self.device
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def _materialize_sampler(self):
        if self.sampler.device != self.device:
            self.sampler = self.sampler.to(self.device)

    # ---- lifecycle ----

    @property
    def step(self) -> int:
        if self.state is not None:
            return self.state.step
        if self._host_tree is not None:
            return int(self._host_tree["step"])
        return 0

    @property
    def done(self) -> bool:
        return self.step >= self.target_iters

    @property
    def resident(self) -> bool:
        """Whether the session holds device state."""
        return self.state is not None

    def _init_state(self) -> TrainState:
        return self.trainer.init(torch.Generator().manual_seed(self.seed))

    def start(self):
        assert self.status == PENDING, f"cannot start from {self.status}"
        with self._device_ctx():
            self._materialize_sampler()
            self.state = self._init_state()
        self.status = ACTIVE

    def run_slice(self, n_iters: int) -> dict:
        """Advance training by up to `n_iters` steps (one time slice)."""
        assert self.status == ACTIVE, f"cannot train a {self.status} session"
        inj = faults.check("serve3d.slice", session=self.session_id, step=int(self.step))
        if inj is not None:
            self._pre_slice_fault(inj)
        n = min(int(n_iters), self.target_iters - self.step)
        if n <= 0:
            self.status = DONE
            return {}
        t0 = obs_trace.clock()
        with obs_trace.span("serve3d/slice", cat="serve3d",
                            args={"session": self.session_id, "iters": n,
                                  "step": int(self.step), "device": self.device_slot}), \
                self._device_ctx():
            self.state, hist = self.trainer.train(self.state, self.sampler, iters=n,
                                                  log_every=n)
        if inj is not None:
            self._post_slice_fault(inj, hist)
        self._record_slice(hist, obs_trace.clock() - t0)
        return hist

    # ---- fault sites (inert unless the knob is on) ----

    def _pre_slice_fault(self, inj):
        if inj.kind == "exception":
            raise faults.InjectedFault(
                f"{self.session_id}: injected exception at step {self.step}")
        if inj.kind == "slow":
            time.sleep(float(inj.params.get("seconds", 0.25)))

    def _post_slice_fault(self, inj, hist: dict):
        """Perturb the slice's end state as a diverged step would: the
        params (NaN/Inf gradients landed) or the reported loss."""
        if inj.kind in ("nan_params", "inf_params"):
            val = float("nan") if inj.kind == "nan_params" else float("inf")
            self.state = self.state._replace(params=faults.poison_tree(self.state.params, val))
        elif inj.kind == "nan_loss":
            hist["loss"][-1] = float("nan")
        elif inj.kind == "loss_spike":
            hist["loss"][-1] = float(hist["loss"][-1]) * float(inj.params.get("factor", 1e6))

    def _record_slice(self, hist: dict, wall_s: float):
        self.train_wall_s += wall_s
        self.telemetry["step"].append(self.step)
        self.telemetry["loss"].append(hist["loss"][-1])
        self.telemetry["live_fraction"].append(hist["live_fraction"][-1])
        if self.done:
            self.status = DONE

    # ---- cohort training ----

    def cohort_key(self) -> tuple:
        """Sessions with equal keys advance together through `train_cohort`:
        the same device slot, field and trainer configs (the shapes and
        the shared draw streams) and absolute step (the freeze schedule,
        the occupancy cadence and the draws are functions of it)."""
        return (self.device_slot, self.field_cfg, self.trainer_cfg, self.step)

    @staticmethod
    def run_cohort_slice(sessions: "list[SceneSession]", n_iters: int) -> int:
        """Advance a cohort of sessions in lockstep by one shared slice.

        The slice is clamped to the member with the least work left, so
        every member advances by the same count and the cohort key stays
        aligned; a member that reaches its target turns DONE.  Equal to each
        member running `run_slice` alone, bit for bit.  The wall time is
        split evenly over the members.  Returns the steps trained."""
        assert len({s.cohort_key() for s in sessions}) == 1, "cohort key mismatch"
        assert all(s.status == ACTIVE for s in sessions)
        injs = [faults.check("serve3d.slice", session=s.session_id, step=int(s.step))
                for s in sessions]
        for s, inj in zip(sessions, injs):
            if inj is not None:
                s._pre_slice_fault(inj)
        n = min(int(n_iters), min(s.target_iters - s.step for s in sessions))
        if n <= 0:
            for s in sessions:
                if s.done:
                    s.status = DONE
            return 0
        t0 = obs_trace.clock()
        with obs_trace.span("serve3d/slice", cat="serve3d",
                            args={"cohort": len(sessions), "iters": n,
                                  "step": int(sessions[0].step),
                                  "device": sessions[0].device_slot}), \
                sessions[0]._device_ctx():
            states, hists = train_cohort([s.trainer for s in sessions],
                                         [s.state for s in sessions],
                                         [s.sampler for s in sessions],
                                         iters=n, log_every=n)
        dt = (obs_trace.clock() - t0) / len(sessions)
        for s, st, hist, inj in zip(sessions, states, hists, injs):
            s.state = st
            if inj is not None:
                s._post_slice_fault(inj, hist)
            s._record_slice(hist, dt)
        return n

    # ---- suspend / resume ----

    def suspend(self, block: bool = True):
        """Move the whole training state to host (and disk if configured)."""
        assert self.state is not None, "no device state to suspend"
        self._host_tree = self.trainer.suspend(self.state)
        if self.ckpt is not None:
            self.ckpt.save(self.step, self._host_tree, block=block)
        self.state = None
        if self.status == ACTIVE:
            self.status = SUSPENDED

    def resume(self):
        """Restore device state from the in-memory tree, else from the
        newest valid checkpoint on disk (a fresh process)."""
        assert self.state is None, "already resident"
        tree = self._host_tree
        if tree is None:
            if self.ckpt is None:
                raise RuntimeError(f"{self.session_id}: nothing to resume from")
            with self._device_ctx():
                template = self.trainer.suspend(self._init_state())
            tree, _meta = self.ckpt.restore(template)
        with self._device_ctx():
            self._materialize_sampler()
            self.state = self.trainer.resume(tree)
        self._host_tree = None
        self.status = DONE if self.done else ACTIVE

    # ---- guard recovery (serve3d.guard) ----

    def rollback(self, tree: dict):
        """Replace the live state with a last-good host tree.  Whatever the
        session holds is dropped; retraining from the restored step
        reproduces the fault-free stream bit for bit."""
        self.state = None
        self._host_tree = dict(tree)
        self.resume()

    def quarantine(self, tree: dict | None = None):
        """Terminal failure state: drop the device state, keep the last-good
        host tree so `publish` and `evaluate` still expose healthy params.
        Never scheduled again; its snapshot is served, marked stale."""
        self.state = None
        if tree is not None:
            self._host_tree = dict(tree)
        self.status = QUARANTINED

    # ---- serving hooks ----

    def _current_params(self):
        """Latest params: the live tensors, or the host tree's numpy arrays
        while suspended."""
        if self.state is not None:
            return self.state.params
        if self._host_tree is not None:
            return self._host_tree["params"]
        raise RuntimeError(f"{self.session_id}: no trained state yet")

    def _current_occ(self) -> tuple:
        """(density EMA, fold count) matching `_current_params`."""
        if self.state is not None:
            occ = self.state.occ_state
            return occ.density_ema, int(occ.step)
        if self._host_tree is not None:
            return self._host_tree["occ_ema"], int(self._host_tree["occ_step"])
        raise RuntimeError(f"{self.session_id}: no trained state yet")

    def publish(self, store, level: int = 0) -> Any:
        """Publish the current params and occupancy to a SnapshotStore
        (atomic swap).  Level 0 is the full snapshot, k > 0 a preview."""
        meta = {"loss": float(self.telemetry["loss"][-1]) if self.telemetry["loss"] else None,
                "train_wall_s": self.train_wall_s}
        with self._device_ctx():
            return store.publish(self.session_id, self._current_params(), self.step, meta,
                                 occ=self._current_occ(), level=level)

    def evaluate(self, views=None) -> dict:
        """PSNR of the current params against this session's ground truth,
        through the quadrature the session is served with: with
        ``render_spr`` set, the redistributed path at that budget with the
        current occupancy -- the served renderer, so eval and served renders
        agree bit for bit.  Dense otherwise."""
        occ = None
        if self.render_spr is not None and self.trainer_cfg.use_occupancy:
            occ = self._current_occ()
        with self._device_ctx():
            return self.trainer.evaluate(self._current_params(), self.dataset, views=views,
                                         occ=occ, samples_per_ray=self.render_spr)

    def progress(self) -> dict:
        return {
            "session_id": self.session_id,
            "status": self.status,
            "device": self.device_slot,
            "step": self.step,
            "target_iters": self.target_iters,
            "loss": self.telemetry["loss"][-1] if self.telemetry["loss"] else None,
            "train_wall_s": self.train_wall_s,
        }
