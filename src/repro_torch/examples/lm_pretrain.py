"""Small-LM pretraining loop: synthetic data, AdamW, the fault-tolerant
driver with checkpoints and auto-resume.  The loss falls (the stream has
learnable bigram structure).

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain --arch qwen1.5-0.5b --steps 60

The port of ``examples/lm_pretrain.py``, with its flags and defaults, plus
``--device`` (default ``cuda``; a missing card raises).  The checkpoint
directory defaults to ``lm_ckpt`` in the temp dir.  The arch's smoke
config, AdamW under `warmup_cosine(3e-3, 10, steps)` with clip_norm 1.0
and weight decay 0.01, `SyntheticLMStream`, `CheckpointManager` (two kept,
written synchronously) with `resume_or_init`, and `TrainDriver` with a
checkpoint every 25 steps; the loss printed every 10 steps.  The step is
`train_step`, one `loss.backward()` and `AdamW.apply` on the params dict
(`launch.train.train_step`); the params are drawn from a `torch.Generator`
seeded 0.  `main(argv)` returns the losses, the step it started from, the
driver's summary and the final state.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_smoke_config
from ..data import LMStreamConfig, SyntheticLMStream
from ..launch import train as lm_train
from ..models.lm import LM
from ..optim import AdamW, schedule
from ..runtime import DriverConfig, TrainDriver, resume_or_init


def build(arch: str, steps: int, device) -> tuple[LM, AdamW]:
    """The model (the arch's smoke config) and the optimizer of a run of
    `steps` steps."""
    model = LM(get_smoke_config(arch), device=device)
    opt = AdamW(lr=schedule.warmup_cosine(3e-3, 10, steps), clip_norm=1.0, weight_decay=0.01)
    return model, opt


def train_step(model: LM, opt: AdamW, state: tuple, batch: dict) -> tuple[tuple, float]:
    """One step on a host batch {"tokens": int32 (B, S)}: ((params, AdamW
    state), the loss)."""
    tokens = torch.as_tensor(batch["tokens"]).to(model.device)
    params, opt_state, loss = lm_train.train_step(model, opt, state[0], state[1],
                                                  {"tokens": tokens})
    return (params, opt_state), float(loss)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, opt = build(args.arch, args.steps, torch.device(args.device))
    stream = SyntheticLMStream(LMStreamConfig(model.cfg.vocab, args.seq, args.batch))

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2, async_save=False)
    params0 = model.init(torch.Generator(device=model.device).manual_seed(0))
    template = (params0, opt.init(params0))
    state, start = resume_or_init(ckpt, template, lambda: template)
    if start:
        print(f"auto-resumed at step {start}")

    drv = TrainDriver(DriverConfig(total_steps=args.steps, checkpoint_every=25,
                                   log_every=10), ckpt)
    losses = []

    def wrapped(state, batch):
        state, loss = train_step(model, opt, state, batch)
        losses.append(loss)
        if len(losses) % 10 == 0:
            print(f"step {start + len(losses):4d}  loss {loss:.4f}")
        return state, {"loss": loss}

    try:
        state, summary = drv.run(state, wrapped, stream.iterator(start_step=start),
                                 start_step=start)
    finally:
        drv.close()
    print(f"done: {summary}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss must decrease on structured data"
    return {"losses": losses, "start": start, "summary": summary, "state": state}


if __name__ == "__main__":
    main()
