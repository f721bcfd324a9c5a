"""LM serving entry point: continuous-batching greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \
        --batch 4 --prompt-len 32 --max-new 64 --device cpu

The port of `repro.launch.serve`, with its flags and defaults; ``--device``
picks the device (default ``cuda``).  As in the reference, ``--smoke`` is
on by default; ``serve(smoke=False)`` serves the full config.  A small
request scheduler keeps the decode batch full: a sequence that reaches its
budget is replaced by the next queued request, whose prompt is prefilled
alone and copied into the finished sequence's slot of every layer's cache
(axis 1 of the stacked caches).  The loop is `serve`, which `main` calls.
An encoder-decoder (whisper's audio stub) is served as the reference
serves it: `batch` rows of frame embeddings drawn from the numpy generator
before the prompts, prefilled with them, each decode step handed the
encoder output; a refilled slot is prefilled with the first row of frames.
The model runs on `launch.mesh.make_host_mesh()`, as the reference's does
(`serve(..., mesh=None)` runs it without one; on a one-rank mesh the MoE
layers take the dense path either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..models.lm import LM
from ..optim.adamw import tree_paths
from .mesh import make_host_mesh


def _reset_slot(caches: dict, fresh: dict, i: int) -> None:
    """Copy a one-sequence prefill's caches into slot i of the batch's
    stacked caches, in place: KV caches, the encoder's cross keys and
    values, SSM states and the shared block's caches alike, batch being
    axis 1 of every leaf ((n_layers, B, ...) or (n_groups, B, ...))."""
    fresh_leaves = dict(tree_paths(fresh))
    for path, c in tree_paths(caches):
        if c.ndim >= 2:
            c[:, i: i + 1] = fresh_leaves[path]


@torch.no_grad()
def serve(arch: str = "qwen3-8b", smoke: bool = True, batch: int = 4, prompt_len: int = 16,
          max_new: int = 24, requests: int = 8, device="cuda", params: dict | None = None,
          mesh="host", **overrides) -> dict:
    """Serve `requests` random prompts of `prompt_len` tokens, `max_new`
    tokens each, `batch` at a time.  params: the model's params (default: a
    fresh init, seed 0); mesh: the model's ("host": `make_host_mesh` on
    `device`; None: none).  Returns the counts, the wall and the decode
    rate, whether every decode step's logits were finite, and the answers:
    each decode step's greedy tokens, (steps, batch) int32 on the host."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if isinstance(mesh, str):
        mesh = make_host_mesh(device=device)
    model = LM(cfg, mesh=mesh, device=device)
    if params is None:
        params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    b, p = batch, prompt_len
    max_seq = p + max_new + 1
    dev = model.device

    kw = {}
    if cfg.frontend == "audio_stub":
        kw["encoder_embeds"] = torch.as_tensor(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32).to(dev)
    queue = [torch.as_tensor(rng.integers(1, cfg.vocab, (p,)), dtype=torch.int32).to(dev)
             for _ in range(requests)]
    active = [queue.pop(0) for _ in range(min(b, len(queue)))]
    while len(active) < b:
        active.append(torch.zeros((p,), dtype=torch.int32, device=dev))

    logits, caches, enc_out = model.prefill(params, tokens=torch.stack(active),
                                            max_seq=max_seq, **kw)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    new_counts = [1] * b
    finite = torch.isfinite(logits).all()       # a device flag, read once at the end
    answers = []
    completed = 0
    t0 = time.perf_counter()
    steps = 0
    while completed < requests and steps < requests * max_new:
        pos = torch.tensor([[p + c - 1] for c in new_counts], dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, tok, pos, encoder_out=enc_out)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        answers.append(tok[:, 0])
        steps += 1
        for i in range(b):
            new_counts[i] += 1
            if new_counts[i] >= max_new:    # budget reached: the next request takes the slot
                completed += 1
                new_counts[i] = 1
                if queue:
                    _, fresh, _ = model.prefill(params, tokens=queue.pop(0)[None],
                                                max_seq=max_seq,
                                                **{k: v[:1] for k, v in kw.items()})
                    _reset_slot(caches, fresh, i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    out = {"name": cfg.name, "completed": completed, "requests": requests, "steps": steps,
           "batch": b, "wall_s": dt, "tok_s": steps * b / dt, "finite": bool(finite),
           "answers": torch.stack(answers).cpu() if answers else None}
    print(f"[{cfg.name}] served {completed} requests, {steps} decode steps, "
          f"{out['tok_s']:.1f} tok/s aggregate")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
                 max_new=args.max_new, requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
