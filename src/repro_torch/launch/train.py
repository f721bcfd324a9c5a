"""LM training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --steps 50 --ckpt-dir /tmp/run1 --auto-resume --device cpu

The port of `repro.launch.train`, with its flags and defaults; ``--device``
picks the device (default ``cuda``).  ``--smoke`` swaps in the reduced
config so the loop runs on the CPU; without it the full config trains
(qwen1.5-0.5b fits one H100).  The loop is `train`, which `main` calls:
AdamW under `warmup_cosine(lr, 10, steps)` with clip_norm 1.0 and weight
decay 0.01, the deterministic `SyntheticLMStream`, and `TrainDriver`'s
atomic checkpoints every ``--ckpt-every`` steps (SIGTERM-safe);
``--auto-resume`` restores params, optimizer state and the data cursor, so
a resumed run ends on the uninterrupted run's bytes wherever every op is
deterministic (on a card: with ``dedup_embed_grad=True``, the BUM-merged
embedding backward, since the default `index_add_` uses float atomics).
``--compress-grads`` and ``--coordinator`` need `parallel/`, which is not
ported yet (ROADMAP Queue 1 item 2.5): they raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import LMStreamConfig, SyntheticLMStream
from ..models.lm import LM
from ..optim import AdamW, schedule
from ..optim.adamw import tree_from_paths, tree_paths
from ..runtime import DriverConfig, TrainDriver, resume_or_init

PARALLEL_ITEM = "ROADMAP Queue 1 item 2.5 (parallel/)"


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train")


def train_step(model: LM, opt: AdamW, params: dict, opt_state, batch: dict):
    """One step: (new params, new optimizer state, loss as a 0-d tensor)."""
    paths = [p for p, _ in tree_paths(params)]
    live = tree_from_paths([(p, t.detach().requires_grad_()) for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)])
    with torch.no_grad():
        params, opt_state = opt.apply(params, tree_from_paths(zip(paths, grads)), opt_state)
    return params, opt_state, loss.detach()


def train(arch: str = "qwen1.5-0.5b", smoke: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, ckpt_dir: str | None = None,
          ckpt_every: int = 50, auto_resume: bool = False, device="cuda",
          stop_after: int | None = None, **overrides) -> dict:
    """Train `arch` (its smoke config with smoke=True; `overrides` replace
    config fields, e.g. dedup_embed_grad=True) for `steps` steps, or stop
    after `stop_after` of them (the schedule still spans `steps`).  Returns
    the final state (params, AdamW state), the driver's summary, the step it
    started from, and each step's loss and wall ms (a step's loss is read
    on the host, so its wall includes the device's work)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ckpt_dir = ckpt_dir or default_ckpt_dir()
    model = LM(cfg, device=device)
    opt = AdamW(lr=schedule.warmup_cosine(lr, 10, steps), clip_norm=1.0, weight_decay=0.01)
    stream = SyntheticLMStream(LMStreamConfig(cfg.vocab, seq, batch))
    params0 = model.init(torch.Generator(device=model.device).manual_seed(0))
    template = (params0, opt.init(params0))
    ckpt = CheckpointManager(ckpt_dir, keep_last=3)
    if auto_resume:
        state, start = resume_or_init(ckpt, template, lambda: template)
    else:
        state, start = template, 0
    history = {"step": [], "loss": [], "step_ms": []}

    def step_fn(state, b):
        params, opt_state = state
        tokens = torch.from_numpy(b["tokens"]).to(model.device)
        params, opt_state, loss = train_step(model, opt, params, opt_state, {"tokens": tokens})
        return (params, opt_state), {"loss": float(loss)}

    def timed(state, b):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        history["step_ms"].append((time.perf_counter() - t0) * 1e3)
        history["loss"].append(metrics["loss"])
        history["step"].append(start + len(history["loss"]))
        return state, metrics

    drv = TrainDriver(DriverConfig(
        total_steps=steps if stop_after is None else stop_after, checkpoint_every=ckpt_every,
        log_every=10, metrics_path=os.path.join(ckpt_dir, "metrics.jsonl")), ckpt)
    try:
        state, summary = drv.run(state, timed, stream.iterator(start_step=start),
                                 start_step=start)
    finally:
        drv.close()
    return {"cfg": cfg, "state": state, "summary": summary, "start": start, **history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_train in the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--auto-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient sync (not ported yet)")
    ap.add_argument("--coordinator", default=None, help="multi-process coordinator "
                    "(not ported yet)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.compress_grads or args.coordinator:
        raise NotImplementedError(f"--compress-grads / --coordinator: {PARALLEL_ITEM}")
    out = train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                auto_resume=args.auto_resume, device=args.device)
    print("summary:", out["summary"])
    return out


if __name__ == "__main__":
    main()
