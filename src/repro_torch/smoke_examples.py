"""Phase 18 of ``chip_smoke.py``: the LM example scripts on one card.

1. ``python -m repro_torch.examples.lm_pretrain`` at its defaults
   (qwen1.5-0.5b's smoke config, 60 steps of 8 x 64 tokens, a checkpoint
   every 25 steps, here into a temporary directory): the script's own
   gate, its loss falls; the first and last losses printed.
2. ``python -m repro_torch.examples.serve_lm`` at its defaults (qwen3-8b's
   smoke config, batch 4, prompts of 16, 32 greedy steps) and once with
   ``--arch whisper-medium`` (the audio stub's frame embeddings): every
   logit finite; the prefill time and tok/s printed with the card's line.

Each runs through the script's `main(argv)` in this process (the CLI's
flags and code), and the kernels' launches in them are this phase's paths
(``example_lm_pretrain``, ``example_serve_lm``).  `examples_phase(device,
card)` on the CPU is rehearsed by the CPU tests.
"""
from __future__ import annotations

import json
import tempfile
import time

import torch

from . import kernels
from .examples import lm_pretrain, serve_lm

SERVE_ARCHS = ("qwen3-8b", "whisper-medium")


def examples_phase(device, card: str) -> dict:
    """Phase 18, with its gates."""
    t_phase = time.perf_counter()
    dev = ["--device", torch.device(device).type]
    seconds, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        t0 = time.perf_counter()
        pre = lm_pretrain.main(dev + ["--ckpt-dir", tmp])
        seconds["lm_pretrain"] = time.perf_counter() - t0
        launches["example_lm_pretrain"] = dict(kernels.LAUNCHES)
    losses = pre["losses"]
    print(f"examples lm_pretrain: {len(losses)} steps from step {pre['start']}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {seconds['lm_pretrain']:.2f} s [{card}]",
          flush=True)
    served = {}
    kernels.reset_launches()
    for arch in SERVE_ARCHS:
        t0 = time.perf_counter()
        out = serve_lm.main(dev + ["--arch", arch])
        seconds[f"serve_lm {arch}"] = time.perf_counter() - t0
        served[arch] = out
        print(f"examples serve_lm {out['name']}: {out['ids'].shape[0]} x "
              f"{out['ids'].shape[1] - 1} steps, prefill {out['prefill_s'] * 1e3:.2f} ms, "
              f"decode {out['decode_s'] * 1e3:.2f} ms, {out['tok_s']:.1f} tok/s, logits finite "
              f"{out['finite']} [{card}]", flush=True)
    launches["example_serve_lm"] = dict(kernels.LAUNCHES)
    problems = [] if losses[-1] < losses[0] else [f"lm_pretrain's loss {losses}"]
    problems += [f"serve_lm {arch}: a logit is not finite"
                 for arch, out in served.items() if not out["finite"]]
    if problems:
        raise RuntimeError(f"examples phase: {problems}")
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"examples phase: {json.dumps(seconds)} [{card}]", flush=True)
    return {"pretrain": pre, "served": served, "seconds": seconds, "launches": launches}
