"""LM training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --steps 50 --ckpt-dir /tmp/run1 --auto-resume --device cpu

The port of `repro.launch.train`, with its flags and defaults; ``--device``
picks the device (default ``cuda``).  ``--smoke`` swaps in the reduced
config so the loop runs on the CPU; without it the full config trains
(qwen1.5-0.5b fits one H100; deepseek-v2-lite at full width with its depth
cut, ``train(..., n_layers=3)``).  The loop is `train`, which `main` calls:
AdamW under `warmup_cosine(lr, 10, steps)` with clip_norm 1.0 and weight
decay 0.01, the deterministic `SyntheticLMStream`, and `TrainDriver`'s
atomic checkpoints every ``--ckpt-every`` steps (SIGTERM-safe);
``--auto-resume`` restores params, optimizer state and the data cursor, so
a resumed run ends on the uninterrupted run's bytes wherever every op is
deterministic (on a card: with ``dedup_embed_grad=True``, the BUM-merged
embedding backward, since the default `index_add_` uses float atomics).
The model runs on `launch.mesh.make_host_mesh()`, as the reference's
does.  ``--coordinator``, ``--num-processes`` and ``--process-id`` join a
multi-process run (`launch.mesh.init_distributed`: NCCL on a card, gloo
on the CPU, at ``tcp://<coordinator>``; the group is destroyed when the
run ends).  ``--compress-grads`` adds the int8 error-feedback state
(`parallel.init_error_state`) to the state, so it is checkpointed and
restored with it; the compressed sync runs only where the mesh has a
'pod' axis, as in the reference, and the host mesh has none, so the CLI
carries a zero error state exactly as the reference's does.  The step
feeds tokens only, as the reference's does, so an encoder-decoder (whisper-medium)
raises the model's ValueError naming `encoder_embeds` at its first step;
it trains through `train_step` with a batch in `configs.shapes.
input_specs`' train layout (chip_smoke's phase 15, `smoke_whisper`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import LMStreamConfig, SyntheticLMStream
from ..models.lm import LM
from ..optim import AdamW, schedule
from ..optim.adamw import tree_from_paths, tree_paths
from ..parallel import collectives
from ..runtime import DriverConfig, TrainDriver, resume_or_init
from .mesh import init_distributed, make_host_mesh


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train")


def loss_and_grads(model: LM, params: dict, batch: dict):
    """(loss as a 0-d tensor, the gradient tree).  A leaf the loss does not
    read (an MoE router's `router_bias`, which only selects experts) gets a
    zero gradient, as JAX gives it, so the clip's norm, the moments and the
    weight decay see what the reference's do."""
    paths = [p for p, _ in tree_paths(params)]
    live = tree_from_paths([(p, t.detach().requires_grad_()) for p, t in tree_paths(params)])
    loss = model.loss(live, batch)
    grads = torch.autograd.grad(loss, [t for _, t in tree_paths(live)], allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_from_paths(zip(paths, grads))


def train_step(model: LM, opt: AdamW, params: dict, opt_state, batch: dict, err=None):
    """One step: (new params, new optimizer state, loss as a 0-d tensor),
    and the new error state after them when `err` (an error-feedback tree)
    is given: then the gradients go through `compressed_grad_sync` over the
    model's mesh's 'pod' axis, if it has one."""
    loss, grads = loss_and_grads(model, params, batch)
    mesh = model.mesh
    if err is not None and mesh is not None and "pod" in mesh.shape:
        grads, err = collectives.compressed_grad_sync(grads, err, mesh, "pod")
    with torch.no_grad():
        params, opt_state = opt.apply(params, grads, opt_state)
    return (params, opt_state, loss) if err is None else (params, opt_state, loss, err)


def train(arch: str = "qwen1.5-0.5b", smoke: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-3, ckpt_dir: str | None = None,
          ckpt_every: int = 50, auto_resume: bool = False, device="cuda",
          stop_after: int | None = None, checkpoints: bool = True,
          compress_grads: bool = False, **overrides) -> dict:
    """Train `arch` (its smoke config with smoke=True; `overrides` replace
    config fields, e.g. dedup_embed_grad=True) for `steps` steps, or stop
    after `stop_after` of them (the schedule still spans `steps`).  With
    checkpoints=False no checkpoint (nor metrics file) is written, and
    there is nothing to resume from.  The model runs on `make_host_mesh`
    on `device`; compress_grads=True adds the error-feedback tree to the
    state.  Returns the final state (params,
    AdamW state[, error state]), the driver's summary, the step it started
    from, and each step's loss and wall ms (a step's loss is read on the
    host, so its wall includes the device's work)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if auto_resume and not checkpoints:
        raise ValueError("auto_resume needs checkpoints")
    ckpt_dir = ckpt_dir or default_ckpt_dir()
    model = LM(cfg, mesh=make_host_mesh(device=device), device=device)
    opt = AdamW(lr=schedule.warmup_cosine(lr, 10, steps), clip_norm=1.0, weight_decay=0.01)
    stream = SyntheticLMStream(LMStreamConfig(cfg.vocab, seq, batch))
    params0 = model.init(torch.Generator(device=model.device).manual_seed(0))
    template = (params0, opt.init(params0))
    if compress_grads:
        template += (collectives.init_error_state(params0),)
    ckpt = CheckpointManager(ckpt_dir, keep_last=3) if checkpoints else None
    if auto_resume:
        state, start = resume_or_init(ckpt, template, lambda: template)
    else:
        state, start = template, 0
    # only the loop holds the initial state from here, so each step frees
    # the state before it
    held = [state]
    del params0, template, state
    history = {"step": [], "loss": [], "step_ms": []}

    def step_fn(state, b):
        tokens = torch.from_numpy(b["tokens"]).to(model.device)
        # (params, opt_state, loss[, err]) -> the state (params, opt_state[, err])
        out = train_step(model, opt, state[0], state[1], {"tokens": tokens}, *state[2:])
        return (out[0], out[1], *out[3:]), {"loss": float(out[2])}

    def timed(state, b):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        history["step_ms"].append((time.perf_counter() - t0) * 1e3)
        history["loss"].append(metrics["loss"])
        history["step"].append(start + len(history["loss"]))
        return state, metrics

    drv = TrainDriver(DriverConfig(
        total_steps=steps if stop_after is None else stop_after, checkpoint_every=ckpt_every,
        log_every=10,
        metrics_path=os.path.join(ckpt_dir, "metrics.jsonl") if checkpoints else None), ckpt)
    try:
        state, summary = drv.run(held.pop(), timed, stream.iterator(start_step=start),
                                 start_step=start)
    finally:
        drv.close()
    return {"cfg": cfg, "state": state, "summary": summary, "start": start, **history}


def main(argv=None, **overrides):
    """The CLI; keyword `overrides` go to `train` as config fields (e.g.
    dedup_embed_grad=True, the exact embedding backward on a card)."""
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
                    help="int8 error-feedback gradient sync over the 'pod' axis")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 of a multi-process run")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    if args.coordinator:
        init_distributed(args.coordinator, args.num_processes, args.process_id, args.device)
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                    seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, auto_resume=args.auto_resume,
                    device=args.device, compress_grads=args.compress_grads, **overrides)
    finally:
        if args.coordinator:
            dist.destroy_process_group()
    print("summary:", out["summary"])
    return out


if __name__ == "__main__":
    main()
