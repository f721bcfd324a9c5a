"""Batched LM serving: a greedy decode loop on a reduced config.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-8b --batch 4 --steps 32

The port of ``examples/serve_lm.py``, with its flags and defaults, plus
``--device`` (default ``cuda``; a missing card raises).  It takes the
chosen arch's smoke config and params drawn from a `torch.Generator`
seeded 0.  The prompts come from `np.random.default_rng(0)`, then (for
the audio stub) the frame embeddings from the same generator.  Then
prefill -> caches -> greedy `decode_step` with the encoder output; it
prints the prefill time, the decode rate and the first 16 ids of row 0.
The decode runs eagerly, where the reference jits it.  `generate` is the
loop on given params; `main(argv)` returns its result.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke_config, list_archs
from ..models.lm import LM


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(model: LM, params: dict, batch: int, prompt_len: int, steps: int) -> dict:
    """Prefill `batch` random prompts of `prompt_len` tokens, then `steps`
    greedy decode steps.  Returns the ids (batch, steps + 1) int32 on the
    host, whether every logit was finite, and the prefill and decode
    walls."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    b, p = batch, prompt_len
    max_seq = p + steps + 1

    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (b, p)), dtype=torch.int32).to(dev)
    kw = {}
    if cfg.frontend == "audio_stub":
        kw["encoder_embeds"] = torch.as_tensor(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32).to(dev)

    t0 = time.perf_counter()
    logits, caches, enc_out = model.prefill(params, tokens=prompts, max_seq=max_seq, **kw)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"[{cfg.name}] prefill {b}x{p} in {prefill_s:.2f}s")

    finite = torch.isfinite(logits).all()       # a device flag, read once at the end
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for step in range(steps):
        pos = torch.full((b, 1), p + step, dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, tok, pos, encoder_out=enc_out)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out_tokens.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    ids = torch.cat(out_tokens, dim=1).cpu()
    print(f"decoded {steps} steps x {b} seqs in {dt:.2f}s ({steps * b / dt:.1f} tok/s)")
    print("sample token ids:", ids[0, :16].numpy())
    return {"name": cfg.name, "ids": ids, "finite": bool(finite), "prefill_s": prefill_s,
            "decode_s": dt, "tok_s": steps * b / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = LM(get_smoke_config(args.arch), device=torch.device(args.device))
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    return generate(model, params, args.batch, args.prompt_len, args.steps)


if __name__ == "__main__":
    main()
