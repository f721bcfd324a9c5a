"""Phase 15 of ``chip_smoke.py``: whisper-medium's encoder-decoder.

whisper-medium (24 encoder and 24 decoder layers, d 1024, 16 heads, ff
4096 GELU, LayerNorm with biases, QKV biases, vocab 51,865, untied head,
811,579,392 params; the audio frontend a stub feeding 1500 frame
embeddings), bf16, through the entry points a user calls
(`launch.train.train_step` under `runtime.TrainDriver`,
`launch.serve.serve`):

1. #7 (`bum_scatter`) and its sort (`bum_sort`) on its embedding-gradient
   rows, each against its plain version exactly and the same bytes on two
   launches: 4 x 448 tokens of `SyntheticLMStream` at F = 1024 into
   51,865 rows (16 address bits);
2. training at full width and full depth, batch 4 x 448 tokens (448 is
   whisper's text context, `max_target_positions` in openai/whisper-medium's
   config) beside 4 x 1500 frame embeddings (`max_source_positions`) drawn
   from `FRAMES_SEED` and the step, the batch in `configs.shapes.
   input_specs`' train layout, 30 steps at `TRAIN_LR` (below phase 12's
   `smoke_lm.LM_LR`): the default run
   (``lm_encdec_train``), then two ``dedup_embed_grad=True`` runs from one
   seed (``lm_encdec_train_dedup``: #7 and `bum_sort` once a step); the
   held-out gate (`smoke_lm.trains`, `PROBE_BATCH` rows of 448 a batch,
   taken `PROBE_ROWS` at a time) on the default and the first merged run,
   the merged runs the same bytes (params and both moments); no checkpoint
   is written (a CPU test resumes one);
3. parity at f32 on a fresh init of `PARITY_LAYERS` encoder and decoder
   layers at full width (drawn on the CPU, copied to the card): `prefill`
   of `PARITY_PROMPT` tokens and three `decode_step`s against a
   teacher-forced `forward` within `smoke_lm.DECODE_ATOL`, then one row
   of 1500 frames and a `PARITY_PROMPT`-token prompt, the card's
   last-token logits against the CPU's within `smoke_lm.CPU_LOGITS_TOL`;
4. serving at full width and depth (a fresh init on the card) through
   `launch.serve.serve` (``lm_encdec_serve``): 8 requests of 16 prompt
   tokens and 24 new ones, 4 at a time, every request completing with
   finite logits, the later ones prefilled (with the first row of frames,
   as the reference refills) into freed slots.

Each function takes the device, so a CPU test can rehearse it on the smoke
config (``smoke=True``).
"""
from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import torch

from . import kernels, smoke_lm, smoke_moe
from .checkpoint import CheckpointManager
from .configs import shapes
from .data import LMStreamConfig, SyntheticLMStream
from .launch.train import train_step
from .models.lm import LM
from .optim import AdamW, schedule
from .runtime import DriverConfig, TrainDriver, resume_or_init

ARCH = "whisper-medium"
PATH = "lm_encdec"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 448, 30
# Peak learning rate (warmup 10, cosine to 0 at 30), below phase 12's
# `smoke_lm.LM_LR` (1e-3): at 1e-3 the loss turned up from step 9 (11.06 ->
# 11.43 at 11, 11.34 at 30; held-out 11.056 -> 11.337), at 5e-4 from step 11
# (held-out fall -0.0055); at 2.5e-4, also the peak rate the Whisper paper
# gives for medium, the held-out fall was 0.0328 against a spread of 0.0115
# (1e-4: 0.0209).  `tools/torch_whisper_lr_sweep.py`, NVIDIA H100 80GB HBM3,
# 700.00 W.
TRAIN_LR = 2.5e-4
# The frame embeddings of stream step k are drawn from FRAMES_SEED + k.
FRAMES_SEED = 15_000
# The held-out probe: `PROBE_BATCH` rows of 448 tokens a batch (14,336
# tokens, about phase 13's and 14's 16,384), taken `PROBE_ROWS` rows at a
# time: a pass over 64 rows would form (64, 16, 1500, 1500) f32 encoder
# scores, 9.2 GB a layer.
PROBE_BATCH, PROBE_ROWS = 32, 4
PARITY_LAYERS, PARITY_PROMPT = 2, 40
SERVE_ARGS = smoke_lm.SERVE_ARGS
# The wide-row kernel case: (label, tokens, F, vocab rows).
WIDE_CASES = (("whisper-medium embedding backward, 4 x 448 tokens", (4, 448), 1024, 51_865),)


def _config(smoke: bool, **overrides):
    return smoke_lm._config(ARCH, smoke, **overrides)


def audio_batch(cfg, tokens: np.ndarray, step: int, device) -> dict:
    """Stream step `step`'s batch in `input_specs`' train layout: its tokens
    and frame embeddings drawn on `device` from FRAMES_SEED + step (so a
    rerun or a resume sees the same frames)."""
    b, s = tokens.shape
    spec = shapes.input_specs(cfg, shapes.Shape("stream", s, b, "train"))
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED + step)
    frames = spec["encoder_embeds"]
    return {"tokens": torch.from_numpy(tokens).to(device=device, dtype=spec["tokens"].dtype),
            "encoder_embeds": torch.randn(frames.shape, generator=gen,
                                          device=device).to(frames.dtype)}


def train_run(device, ckpt_dir: str | None, smoke: bool = False, steps: int = TRAIN_STEPS,
              batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, lr: float = TRAIN_LR,
              stop_after: int | None = None, auto_resume: bool = False,
              **overrides) -> dict:
    """`launch.train`'s loop with the audio batch: AdamW under
    `warmup_cosine(lr, 10, steps)` (clip 1.0, decay 0.01), seed-0 params,
    `TrainDriver` over `SyntheticLMStream` (checkpointed every `steps`
    steps into `ckpt_dir`, none without one); each step `train_step` on
    `audio_batch`.  Launch counters zeroed just before and read just
    after; the card's peak memory over the run."""
    on_card = torch.device(device).type == "cuda"
    model = LM(_config(smoke, **overrides), device=device)
    opt = AdamW(lr=schedule.warmup_cosine(lr, 10, steps), clip_norm=1.0, weight_decay=0.01)
    stream = SyntheticLMStream(LMStreamConfig(model.cfg.vocab, seq, batch))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    params0 = model.init(torch.Generator(device=model.device).manual_seed(0))
    template = (params0, opt.init(params0))
    ckpt = CheckpointManager(ckpt_dir, keep_last=3) if ckpt_dir else None
    state, start = resume_or_init(ckpt, template, lambda: template) if auto_resume \
        else (template, 0)
    held = [state]                   # the loop alone holds the initial state from here
    del params0, template, state
    history = {"step": [], "loss": [], "step_ms": []}

    def step_fn(state, b):
        t = time.perf_counter()
        params, opt_state, loss = train_step(model, opt, *state, b)
        history["loss"].append(float(loss))
        history["step_ms"].append((time.perf_counter() - t) * 1e3)
        history["step"].append(start + len(history["loss"]))
        return (params, opt_state), {"loss": history["loss"][-1]}

    batches = (audio_batch(model.cfg, stream.batch(k), k, model.device)
               for k in itertools.count(start))
    drv = TrainDriver(DriverConfig(
        total_steps=steps if stop_after is None else stop_after, checkpoint_every=steps,
        log_every=10, metrics_path=os.path.join(ckpt_dir, "metrics.jsonl") if ckpt else None),
        ckpt)
    try:
        state, summary = drv.run(held.pop(), step_fn, batches, start_step=start)
    finally:
        drv.close()
    if on_card:
        torch.cuda.synchronize()
    return {"cfg": model.cfg, "state": state, "summary": summary, "start": start, **history,
            "wall_s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
            "peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else 0}


@torch.no_grad()
def probe_losses(device, params: dict, smoke: bool = False) -> list[float]:
    """`params`' loss on each of the `smoke_lm.PROBE_BATCHES` held-out
    batches of `PROBE_BATCH` rows of `TRAIN_SEQ` tokens (stream steps
    `smoke_lm.PROBE_STEP` on, their frames too), each the row-weighted
    mean over its `PROBE_ROWS`-row parts."""
    model = LM(_config(smoke), device=device)
    stream = SyntheticLMStream(LMStreamConfig(model.cfg.vocab, TRAIN_SEQ, PROBE_BATCH))
    out = []
    for k in range(smoke_lm.PROBE_STEP, smoke_lm.PROBE_STEP + smoke_lm.PROBE_BATCHES):
        full = audio_batch(model.cfg, stream.batch(k), k, model.device)
        parts = [(float(model.loss(params, {n: t[r: r + PROBE_ROWS] for n, t in full.items()})),
                  min(PROBE_ROWS, PROBE_BATCH - r)) for r in range(0, PROBE_BATCH, PROBE_ROWS)]
        out.append(sum(v * n for v, n in parts) / PROBE_BATCH)
    return out


def initial_probe(device, smoke: bool = False) -> dict:
    """The seed-0 init's mean held-out loss and the spread (max - min)
    between the held-out batches."""
    model = LM(_config(smoke), device=device)
    losses = probe_losses(device, model.init(torch.Generator(device=model.device).manual_seed(0)),
                          smoke)
    return {"before": float(np.mean(losses)), "spread": max(losses) - min(losses)}


def train_runs(device, smoke: bool = False, **size) -> dict:
    """The default run and two ``dedup_embed_grad=True`` runs from one seed,
    none checkpointed, each probed after; only the first merged run's
    state is kept."""
    runs = {"probe": initial_probe(device, smoke)}
    for name, kw in (("default", {}), ("dedup", {"dedup_embed_grad": True}),
                     ("dedup_again", {"dedup_embed_grad": True})):
        r = runs[name] = train_run(device, None, smoke, **size, **kw)
        r["probe_loss"] = float(np.mean(probe_losses(device, r["state"][0], smoke)))
        if name == "default":
            del r["state"]
    runs["same_seed"] = smoke_lm._same_state(runs["dedup"]["state"], runs["dedup_again"]["state"])
    del runs["dedup_again"]["state"]
    return runs


def parity(device, smoke: bool = False) -> dict:
    """At f32, params of `PARITY_LAYERS` + `PARITY_LAYERS` layers drawn on
    the CPU (the smoke config's own depth with `smoke`): prefill of
    `PARITY_PROMPT` tokens and three decode steps on `device` against its
    full forward (`smoke_lm.decode_parity`), then one row's last-token
    logits, `device` against the CPU (`smoke_lm.cpu_parity`)."""
    depth = {} if smoke else {"n_layers": PARITY_LAYERS, "n_encoder_layers": PARITY_LAYERS}
    params = LM(_config(smoke, dtype="float32", **depth), device="cpu").init(
        torch.Generator().manual_seed(0))
    dec = smoke_lm.decode_parity(device, smoke_lm._to(params, device), ARCH, smoke,
                                 prompt=PARITY_PROMPT, dtype="float32", **depth)
    cpu = smoke_lm.cpu_parity(device, ARCH, smoke, tokens=PARITY_PROMPT, params=params, **depth)
    return {"decode": dec, "cpu": cpu}


def model_runs(device, card: str, smoke: bool = False) -> dict:
    """Training (with its gates), the f32 parity, then serving."""
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    size = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR}
    runs = train_runs(device, smoke, **size)
    cfg = runs["dedup"]["cfg"]
    print(f"{PATH} train {cfg.name}: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads, ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens + {TRAIN_BATCH} x "
          f"{cfg.encoder_seq} frames, {TRAIN_STEPS} steps at peak lr {TRAIN_LR}, 3 runs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    probe = runs["probe"]
    print(f"{PATH} train held-out batches ({PROBE_BATCH} rows): initial mean loss "
          f"{probe['before']:.5f}, spread {probe['spread']:.5f}")
    for run in ("default", "dedup", "dedup_again"):
        r = runs[run]
        print(f"{PATH} train {run}: loss {r['loss'][0]:.4f} -> {r['loss'][-1]:.4f}, held-out "
              f"mean {r['probe_loss']:.5f} (fall {smoke_lm.probe_fall(probe, r):.5f}), median "
              f"step {smoke_lm._median_ms(r):.2f} ms (first {r['step_ms'][0]:.1f} ms), wall "
              f"{r['wall_s']:.2f} s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    print(f"{PATH} train losses dedup {json.dumps([round(x, 5) for x in runs['dedup']['loss']])}")
    print(f"{PATH} train two dedup runs from one seed, same bytes: "
          f"{json.dumps(runs['same_seed'])}")
    launches = {f"{PATH}_train": runs["default"]["launches"],
                f"{PATH}_train_dedup": runs["dedup"]["launches"]}
    for path, counts in launches.items():
        print(f"{path}-path launches: {json.dumps(counts)}", flush=True)
    problems = smoke_moe.check_train_runs(runs, TRAIN_STEPS, on_card)
    if problems:
        raise RuntimeError(f"{PATH} training gate failed: {problems}")
    train = {run: {"median_step_ms": smoke_lm._median_ms(runs[run]),
                   "peak_bytes": runs[run]["peak_bytes"]}
             for run in ("default", "dedup", "dedup_again")}
    del runs
    smoke_moe._free(device)

    par = parity(device, smoke)
    print(f"{PATH} prefill of {PARITY_PROMPT} + {smoke_lm.DECODE_STEPS} decode steps vs "
          f"teacher-forced forward (f32, {PARITY_LAYERS} + {PARITY_LAYERS} layers, atol = "
          f"rtol = {smoke_lm.DECODE_ATOL}): {json.dumps(par['decode'])}", flush=True)
    print(f"{PATH} f32 forward of {PARITY_PROMPT} tokens and one row of frames, card vs CPU, "
          f"last-token logits: {json.dumps(par['cpu'])}", flush=True)
    if not (par["decode"]["ok"] and par["cpu"]["ok"]):
        raise RuntimeError(f"{PATH} f32 parity failed: {par}")
    smoke_moe._free(device)

    t0 = time.perf_counter()
    served = smoke_moe.serve_run(device, ARCH, smoke, SERVE_ARGS)
    print(f"{PATH} serve {ARCH}: {served['completed']} of {served['requests']} requests, "
          f"{served['steps']} decode steps of batch {served['batch']} in "
          f"{served['wall_s']:.3f} s: {served['tok_s']:.1f} tok/s decode "
          f"({time.perf_counter() - t0:.2f} s with init and prefills), logits finite "
          f"{served['finite']}, peak memory {served['peak_bytes'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    launches[f"{PATH}_serve"] = served["launches"]
    print(f"{PATH}_serve-path launches: {json.dumps(served['launches'])}", flush=True)
    if served["completed"] < served["requests"] or not served["finite"]:
        raise RuntimeError(f"{PATH} serving: {served}")
    smoke_moe._free(device)
    return {"launches": launches, "train": train, "parity": par, "served": served}


def whisper_phase(device, card: str) -> dict:
    """Phase 15 on the card, with its gates: the wide-row kernel case, then
    `model_runs` at full width and depth."""
    from .smoke import _print_case
    t_phase = time.perf_counter()
    cases = smoke_lm.wide_cases(device, WIDE_CASES)
    failed = [c["case"] for c in cases if not (_print_case(c, card) and c["deterministic"])]
    for c in cases:
        if "distinct_rows" in c:
            print(f"{PATH} stream {c['case']}: {c['shape'][0]} tokens, {c['distinct_rows']} "
                  f"distinct rows, two launches byte-identical {c['deterministic']}", flush=True)
    if failed:
        raise RuntimeError(f"wide-row kernel parity failed: {failed}")
    out = {"cases": cases, **model_runs(device, card)}
    print(f"{PATH} phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out
