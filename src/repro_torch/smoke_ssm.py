"""Phase 14 of ``chip_smoke.py``: the SSM and hybrid decoders.

falcon-mamba-7b (64 Mamba-1 layers, d 4096, d_inner 8192, state 16, vocab
65,024) and zamba2-7b (81 Mamba-2 layers, d 3584, 112 heads of 64, state
64, a weight-shared 32-head attention block with a 14,336-wide SwiGLU
after every 6 layers, vocab 32,000), bf16, through the entry points a user
calls (`launch.train.train`, `launch.serve.serve`):

1. #7 (`bum_scatter`) and its sort (`bum_sort`) on both models'
   embedding-gradient rows, each against its plain version exactly and the
   same bytes on two launches: 4 x 256 tokens of `SyntheticLMStream` at
   F = 3584 into 32,000 rows (15 address bits) and at F = 4096 into 65,024
   rows (16 bits);
2. both models at full width with their depth cut (`TRAIN_LAYERS`:
   falcon-mamba 3 layers; zamba2 7 -- one group of 6 Mamba-2 layers, the
   shared block once, one tail layer), batch 4 x seq 256 (two chunks of
   128, so the state carried between chunks is in the backward), 30 steps
   at `TRAIN_LR` (below `smoke_lm.LM_LR`): the default run
   (``lm_ssm_train`` / ``lm_hybrid_train``), then two ``dedup_embed_grad=True`` runs from one
   seed (``*_dedup``: #7 and `bum_sort` once a step); the held-out gate
   (`smoke_lm.trains`, `PROBE_BATCH` rows of 256 a batch) on the default
   and the first merged run, the merged runs the same bytes (params and
   both moments); no checkpoint is written.  zamba2's merged run is also
   stopped at `STOP` (checkpointed there) and resumed through
   `resume_or_init`, at `RESUME_LAYERS` (one Mamba-2 layer; the shared
   block's weights ride along unread): the bytes of an uninterrupted merged
   run of that depth;
3. parity at f32 on the depth-cut models, from the first merged run's
   params cast to f32, on prompts of `PARITY_PROMPT` = 300 tokens (two
   chunks of 128 and a remainder of 44): `prefill` and three
   `decode_step`s against a teacher-forced `forward` within
   `smoke_lm.DECODE_ATOL`; the card's last-token logits against the CPU's
   within `smoke_lm.CPU_LOGITS_TOL`;
4. both models at full width and full depth (14.5 / 13.5 GB of bf16
   params, a fresh init on the card) serving 8 requests of 16 prompt
   tokens and 24 new ones, 4 at a time (``lm_ssm_serve`` /
   ``lm_hybrid_serve``): every request completes with finite logits, the
   later ones from a prefilled state copied into a freed slot.

Each function takes the device, so a CPU test can rehearse it on the
smoke configs (``smoke=True``).
"""
from __future__ import annotations

import json
import tempfile
import time

import torch

from . import smoke_lm, smoke_moe

SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "zamba2-7b"
# The depth-cut training runs at full width (bf16 params and gradients and
# f32 AdamW moments, 12 bytes a param): falcon-mamba at 3 layers is
# 848,617,472 params (~10.2 GB of training state), zamba2 at 7 layers
# 980,754,096 (~11.8 GB); the full depths would need ~87 / ~81 GB.
TRAIN_LAYERS = {SSM_ARCH: 3, HYBRID_ARCH: 7}
# zamba2's stop-and-resume pair runs at one layer (512,885,712 params, ~5.1
# GB a checkpoint): at 7 its two ~9.8 GB writes and one read took 104.9-122.8
# s of the phase (NVIDIA H100 80GB HBM3, 700 W).
RESUME_LAYERS = 1
# Path names of the `kernels` line, per arch.
PATHS = {SSM_ARCH: "lm_ssm", HYBRID_ARCH: "lm_hybrid"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, STOP = 4, 256, 30, 20
# Peak learning rate of each arch's runs (warmup 10, cosine to 0 at 30),
# below phase 12's `smoke_lm.LM_LR` (1e-3).  At 1e-3 falcon-mamba's loss
# turned up after step 21 (11.68 -> 12.17 at 30), in f32 as in bf16, and
# zamba2's gradients went NaN at step 11: the largest exponent SSD forms
# before its mask reached 98.2, past f32's 88.72 (at 5e-4: NaN at step 26;
# at 4e-4 its largest was 82.6).  falcon-mamba at 3e-4 ends above its first
# loss.  `tools/torch_ssm_lr_sweep.py`, NVIDIA H100 80GB HBM3, 700 W.
TRAIN_LR = {SSM_ARCH: 5e-4, HYBRID_ARCH: 4e-4}
# The held-out probe's rows of 256 tokens: 16,384 tokens a batch, as many as
# phase 13's probe (128 rows of 128).
PROBE_BATCH = 64
PARITY_PROMPT = 300
SERVE_ARGS = smoke_lm.SERVE_ARGS
# The wide-row kernel cases: (label, tokens, F, vocab rows).
WIDE_CASES = (("zamba2-7b embedding backward, 4 x 256 tokens", (4, 256), 3584, 32_000),
              ("falcon-mamba-7b embedding backward, 4 x 256 tokens", (4, 256), 4096, 65_024))


def _depth(arch: str, smoke: bool) -> dict:
    return {} if smoke else {"n_layers": TRAIN_LAYERS[arch]}


def _size(arch: str) -> dict:
    """`arch`'s training runs' size and peak lr (read when called, so a CPU
    rehearsal can shrink them)."""
    return {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR[arch]}


def resume_run(device, arch: str, smoke: bool = False) -> dict:
    """At `RESUME_LAYERS` (the smoke config's own depth when `smoke`): an
    uninterrupted merged run, one stopped at `STOP` (checkpointed there) and
    one resumed from its checkpoint to `TRAIN_STEPS`: where they stopped and
    started, both runs' losses, and whether the resumed state is the
    uninterrupted run's bytes."""
    common = dict(**_size(arch), ckpt_every=STOP, dedup_embed_grad=True,
                  **({} if smoke else {"n_layers": RESUME_LAYERS}))
    want = smoke_lm.train_run(device, None, arch, smoke, checkpoints=False, **common)
    with tempfile.TemporaryDirectory() as tmp:
        stopped = smoke_lm.train_run(device, f"{tmp}/part", arch, smoke, stop_after=STOP,
                                     **common)
        del stopped["state"]
        resumed = smoke_lm.train_run(device, f"{tmp}/part", arch, smoke, auto_resume=True,
                                     **common)
    return {"stopped_at": stopped["summary"]["step"], "start": resumed["start"],
            "loss": resumed["loss"], "want_loss": want["loss"],
            "layers": want["cfg"].n_layers, "median_step_ms": smoke_lm._median_ms(resumed),
            "same": smoke_lm._same_state(want["state"], resumed["state"])}


def check_resume(res: dict, want_loss: list) -> list[str]:
    if res["stopped_at"] != STOP or res["start"] != STOP or not all(res["same"].values()):
        return [f"stopped at {res['stopped_at']}, resumed from {res['start']}: {res['same']}"]
    if res["loss"] != want_loss[STOP:]:
        return ["the resumed run's losses differ from the uninterrupted run's"]
    return []


def parity(device, params: dict, arch: str, smoke: bool = False) -> dict:
    """At f32 from `params`, on prompts of `PARITY_PROMPT` tokens: prefill /
    decode against the teacher-forced forward, and the card's last-token
    logits against the CPU's."""
    depth = _depth(arch, smoke)
    f32 = smoke_lm._to(params, device, torch.float32)
    dec = smoke_lm.decode_parity(device, f32, arch, smoke, prompt=PARITY_PROMPT,
                                 dtype="float32", **depth)
    del f32
    smoke_moe._free(device)
    cpu = smoke_lm.cpu_parity(device, arch, smoke, tokens=PARITY_PROMPT, params=params, **depth)
    return {"decode": dec, "cpu": cpu}


def train_and_check(device, arch: str, card: str, smoke: bool = False) -> dict:
    """One arch's training runs (`smoke_moe.train_runs` at its training
    depth), zamba2's resume and the f32 parity, with their gates (the
    launch counts on a card only)."""
    name, on_card = PATHS[arch], torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    runs = smoke_moe.train_runs(device, arch, smoke, probe_batch=PROBE_BATCH, **_size(arch),
                                **_depth(arch, smoke))
    cfg = runs["dedup"]["cfg"]
    print(f"{name} train {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.ssm.kind} "
          f"d_state {cfg.ssm.d_state} chunk {cfg.ssm.chunk}"
          f"{f', shared attention every {cfg.hybrid_attn_every}' if cfg.hybrid_attn_every else ''}"
          f", vocab {cfg.vocab}, {cfg.dtype}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} steps at peak lr {TRAIN_LR[arch]}, 3 runs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    probe = runs["probe"]
    print(f"{name} train held-out batches: initial mean loss {probe['before']:.5f}, spread "
          f"{probe['spread']:.5f}")
    for run in ("default", "dedup", "dedup_again"):
        r = runs[run]
        print(f"{name} train {run}: loss {r['loss'][0]:.4f} -> {r['loss'][-1]:.4f}, held-out "
              f"mean {r['probe_loss']:.5f} (fall {smoke_lm.probe_fall(probe, r):.5f}), median "
              f"step {smoke_lm._median_ms(r):.2f} ms (first {r['step_ms'][0]:.1f} ms), wall "
              f"{r['wall_s']:.2f} s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    print(f"{name} train losses dedup {json.dumps([round(x, 5) for x in runs['dedup']['loss']])}")
    print(f"{name} train two dedup runs from one seed, same bytes: "
          f"{json.dumps(runs['same_seed'])}")
    launches = {f"{name}_train": runs["default"]["launches"],
                f"{name}_train_dedup": runs["dedup"]["launches"]}
    for path, counts in launches.items():
        print(f"{path}-path launches: {json.dumps(counts)}", flush=True)
    problems = smoke_moe.check_train_runs(runs, TRAIN_STEPS, on_card)
    if problems:
        raise RuntimeError(f"{name} training gate failed: {problems}")
    out = {"launches": launches,
           "train": {run: {"median_step_ms": smoke_lm._median_ms(runs[run]),
                           "peak_bytes": runs[run]["peak_bytes"]}
                     for run in ("default", "dedup", "dedup_again")}}
    dedup = runs.pop("dedup")
    del runs
    smoke_moe._free(device)
    if arch == HYBRID_ARCH:
        t0 = time.perf_counter()
        res = out["resume"] = resume_run(device, arch, smoke)
        print(f"{name} train stopped at {res['stopped_at']} (checkpointed) and resumed to "
              f"{TRAIN_STEPS} through resume_or_init at {res['layers']} layer(s), the three "
              f"runs in {time.perf_counter() - t0:.1f} s, median resumed step "
              f"{res['median_step_ms']:.2f} ms, same bytes as the uninterrupted run: "
              f"{json.dumps(res['same'])} [{card}]", flush=True)
        problems = check_resume(res, res["want_loss"])
        if problems:
            raise RuntimeError(f"{name} resume gate failed: {problems}")
    params = dedup["state"][0]
    del dedup
    smoke_moe._free(device)
    par = out["parity"] = parity(device, params, arch, smoke)
    print(f"{name} prefill of {PARITY_PROMPT} + {smoke_lm.DECODE_STEPS} decode steps vs "
          f"teacher-forced forward (f32, atol = rtol = {smoke_lm.DECODE_ATOL}): "
          f"{json.dumps(par['decode'])}", flush=True)
    print(f"{name} f32 forward of {PARITY_PROMPT} tokens, card vs CPU, last-token logits: "
          f"{json.dumps(par['cpu'])}", flush=True)
    if not (par["decode"]["ok"] and par["cpu"]["ok"]):
        raise RuntimeError(f"{name} f32 parity failed: {par}")
    del params
    smoke_moe._free(device)
    return out


def serve_and_check(device, arch: str, card: str, smoke: bool = False) -> dict:
    """`launch.serve.serve` of a fresh init (full width and depth unless
    `smoke`): every request completes with finite logits."""
    name = PATHS[arch]
    t0 = time.perf_counter()
    served = smoke_moe.serve_run(device, arch, smoke, SERVE_ARGS)
    print(f"{name} serve {arch}: {served['completed']} of {served['requests']} requests, "
          f"{served['steps']} decode steps of batch {served['batch']} in "
          f"{served['wall_s']:.3f} s: {served['tok_s']:.1f} tok/s decode "
          f"({time.perf_counter() - t0:.2f} s with init and prefills), logits finite "
          f"{served['finite']}, peak memory {served['peak_bytes'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    print(f"{name}_serve-path launches: {json.dumps(served['launches'])}", flush=True)
    if served["completed"] < served["requests"] or not served["finite"]:
        raise RuntimeError(f"{name} serving: {served}")
    smoke_moe._free(device)
    return served


def model_runs(device, card: str, smoke: bool = False) -> dict:
    """Both archs trained (with parity), then both served."""
    out = {"launches": {}, "served": {}}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        res = out[PATHS[arch]] = train_and_check(device, arch, card, smoke)
        out["launches"].update(res["launches"])
    for arch in (SSM_ARCH, HYBRID_ARCH):
        served = out["served"][arch] = serve_and_check(device, arch, card, smoke)
        out["launches"][f"{PATHS[arch]}_serve"] = served["launches"]
    return out


def ssm_phase(device, card: str) -> dict:
    """Phase 14 on the card, with its gates: the wide-row kernel cases, then
    `model_runs` at full width."""
    from .smoke import _print_case
    t_phase = time.perf_counter()
    cases = smoke_lm.wide_cases(device, WIDE_CASES)
    failed = [c["case"] for c in cases if not (_print_case(c, card) and c["deterministic"])]
    for c in cases:
        if "distinct_rows" in c:
            print(f"ssm stream {c['case']}: {c['shape'][0]} tokens, {c['distinct_rows']} "
                  f"distinct rows, two launches byte-identical {c['deterministic']}", flush=True)
    if failed:
        raise RuntimeError(f"wide-row kernel parity failed: {failed}")
    out = {"cases": cases, **model_runs(device, card)}
    print(f"ssm phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out
