"""Phase 12 of ``chip_smoke.py``: the LM substrate's dense decoders.

qwen1.5-0.5b at its full width (24 layers, d 1024, 16 heads, ff 2816,
vocab 151,936, tied embeddings, QKV bias, bf16 params), through the
entry points a user calls (`launch.train.train`, `launch.serve.serve`):

1. #7 (`bum_scatter`) and its sort (`bum_sort`) on vocab-wide rows, each
   against its plain version exactly and the same bytes on two launches:
   the embedding backward's stream of 8 x 128 tokens of `SyntheticLMStream`
   at F = 1024 into the 151,936-row table, 16,384 tokens at F = 1024, and
   1024 tokens at F = 4096 into chatglm3-6b's 65,024-row table; kernel,
   plain and library (`torch.sort` / `index_add_`) ms beside the bound.
   Then the 1-D windowed commit (`windowed_scatter_add` of one stream) on
   the card against its plain version on the CPU, exactly;
2. training, batch 8 x seq 128, 30 steps at a peak lr of 1e-3
   (`LM_LR`): once with the default config (the `index_add_` embedding
   backward), once with ``dedup_embed_grad=True`` (the BUM commit: #7 and
   `bum_sort` once a step), counters zeroed around each; loss finite and
   falling from step 1 to step 30, and the mean loss of `PROBE_BATCHES`
   held-out batches falling by more than the spread (max - min) of the
   initial params' loss over those batches (so a run whose updates are
   dropped fails); ms a step, peak memory; a second ``dedup_embed_grad=True`` run
   from the same seed ends on the same bytes (params and both moments),
   and so does a run stopped after 20 steps and resumed to 30 through
   `resume_or_init`, checkpointed every 10 (the other runs write only the
   driver's final checkpoint);
3. serving 8 requests of 16 prompt tokens, 24 new tokens each, 4 at a
   time (continuous batching), from the trained params: every request
   completes; decode tok/s; `prefill` and three `decode_step`s of 4
   prompts against a teacher-forced `forward` at the same positions within
   the reference test's atol = rtol = 2e-2;
4. the card against the CPU: one f32 forward of the full-width model
   (params drawn once on the CPU, copied to the card), the last token's
   logits within `CPU_LOGITS_TOL`.

Each function takes the device, so a CPU test can rehearse it on a smoke
config (``arch``, ``smoke=True``).
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from . import kernels
from .configs import get_config, get_smoke_config
from .data import LMStreamConfig, SyntheticLMStream
from .kernels.grid_update import kernel as gu_kernel
from .kernels.grid_update import ops as gu_ops
from .launch import serve as serve_lib
from .launch import train as train_lib
from .models.lm import LM
from .optim.adamw import tree_paths

LM_ARCH = "qwen1.5-0.5b"
LM_BATCH, LM_SEQ = 8, 128
LM_STEPS, LM_CKPT_EVERY, LM_STOP = 30, 10, 20
# Peak learning rate of the phase's runs (warmup 10 steps, cosine to 0 at
# 30).  The CLI's default 3e-3 is the reference's smoke-config rate; at
# full width it diverged from step 11 (loss 12.15 -> 12.42 at step 13,
# 12.16 at 30, NVIDIA H100 80GB HBM3, 700 W).
LM_LR = 1e-3
# The held-out batches of the loss probe: the stream's steps from
# PROBE_STEP on (training reads steps 0-29).
PROBE_STEP, PROBE_BATCHES = 10_000, 8
# The most rows of a held-out batch that one forward takes (the logits of
# 16 x 128 tokens over a 102,400-word vocabulary are 0.8 GB in f32).
PROBE_ROWS = 16
SERVE_ARGS = {"batch": 4, "prompt_len": 16, "max_new": 24, "requests": 8}
# The reference test's tolerance for prefill / decode against a full forward
# (tests/test_models_smoke.py), here at bf16 and full width.
DECODE_ATOL = DECODE_RTOL = 2e-2
DECODE_STEPS = 3
# f32 forward of the full-width model, card (TF32 off) against the CPU:
# both sum each product in f32 in their own order through 24 layers; the
# logits are O(1).
CPU_LOGITS_TOL = 1e-3
CPU_TOKENS = 16
# The wide-row kernel cases: (label, tokens, F, vocab rows).
WIDE_CASES = (("qwen1.5-0.5b embedding backward, 8 x 128 tokens", (8, 128), 1024, 151_936),
              ("16,384 tokens", (16, 1024), 1024, 151_936),
              ("chatglm3-6b width, 8 x 128 tokens", (8, 128), 4096, 65_024))
WINDOWED_CASE = ((16, 1024), 1024, 151_936, 4096)   # tokens, F, rows, window


def _config(arch: str, smoke: bool, **overrides):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _tokens(shape, vocab: int, step: int = 0) -> np.ndarray:
    batch, seq = shape
    return SyntheticLMStream(LMStreamConfig(vocab, seq, batch)).batch(step)


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def wide_cases(device, cases=WIDE_CASES, seed: int = 0) -> list[dict]:
    """#7 and `bum_sort` on each case's embedding-gradient stream (token ids
    of `SyntheticLMStream`, normal f32 rows), in the report's case format."""
    from . import smoke
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    out = []
    for label, shape, f, rows in cases:
        ids = torch.from_numpy(_tokens(shape, rows)).reshape(-1).to(device=device,
                                                                     dtype=torch.int64)
        vals = torch.randn((ids.shape[0], f), generator=gen, device=device)
        bits = rows.bit_length()
        sort = smoke._bum_sort_case(ids, vals, bits, f"{label}, F={f}")
        first, again = gu_kernel.bum_sort(ids, vals, bits), gu_kernel.bum_sort(ids, vals, bits)
        sort["deterministic"] = all(_same_bytes(x, y) for x, y in zip(first, again))
        sort["distinct_rows"] = int(gu_ops.num_unique_addresses(ids))
        commit = smoke._bum_scatter_stream_case(first[0], first[1], rows, f"{label}, F={f}")
        zero = torch.zeros((rows, f), device=device)
        commit["deterministic"] = _same_bytes(gu_kernel.bum_scatter(zero.clone(), *first),
                                              gu_kernel.bum_scatter(zero.clone(), *first))
        out += [sort, commit]
    return out


def windowed_commit(device, case=WINDOWED_CASE, seed: int = 0) -> dict:
    """The 1-D windowed commit of one token stream on `device` against its
    plain version on CPU copies: exact, and its launches."""
    shape, f, rows, window = case
    ids = torch.from_numpy(_tokens(shape, rows, step=1)).reshape(-1).to(torch.int64)
    vals = torch.randn((ids.shape[0], f), generator=torch.Generator().manual_seed(seed))
    zero = torch.zeros((rows, f))
    kernels.reset_launches()
    got = gu_ops.windowed_scatter_add(zero.to(device), ids.to(device), vals.to(device),
                                      window=window)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = gu_ops.windowed_scatter_add(zero, ids, vals, window=window)
    return {"tokens": ids.shape[0], "window": window, "windows": -(-ids.shape[0] // window),
            "exact": _same_bytes(got.cpu(), want), "launches": launches}


def _same_tree(a: dict, b: dict) -> bool:
    return all(_same_bytes(x, y) for (_, x), (_, y) in zip(tree_paths(a), tree_paths(b)))


def _same_state(a, b) -> dict:
    """Whether two training states (params, AdamW state) hold the same
    bytes: params, both moments, and the step."""
    return {"params": _same_tree(a[0], b[0]),
            "moments": _same_tree(a[1].m, b[1].m) and _same_tree(a[1].v, b[1].v),
            "step": int(a[1].step) == int(b[1].step)}


def train_run(device, ckpt_dir: str | None, arch: str = LM_ARCH, smoke: bool = False,
              steps: int = LM_STEPS, batch: int = LM_BATCH, seq: int = LM_SEQ,
              lr: float = LM_LR, ckpt_every: int = LM_CKPT_EVERY,
              stop_after: int | None = None, auto_resume: bool = False,
              checkpoints: bool = True, **overrides) -> dict:
    """`launch.train.train` on `device`, launch counters zeroed just before
    and read just after, the card's peak memory over the run."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = train_lib.train(arch, smoke=smoke, steps=steps, batch=batch, seq=seq, lr=lr,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, auto_resume=auto_resume,
                          device=device, stop_after=stop_after, checkpoints=checkpoints,
                          **overrides)
    if on_card:
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = dict(kernels.LAUNCHES)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    return out


def _median_ms(run: dict, skip: int = 2) -> float:
    ms = run["step_ms"][skip:] or run["step_ms"]
    return float(np.median(ms))


@torch.no_grad()
def probe_losses(device, params: dict, arch: str = LM_ARCH, smoke: bool = False,
                 batch: int = LM_BATCH, seq: int = LM_SEQ, batches: int = 1,
                 **overrides) -> list[float]:
    """`params`' loss on each of the first `batches` held-out batches, a
    batch of more than PROBE_ROWS rows taken PROBE_ROWS rows at a time (its
    loss the mean of theirs, weighted by rows)."""
    model = LM(_config(arch, smoke, **overrides), device=device)
    stream = SyntheticLMStream(LMStreamConfig(model.cfg.vocab, seq, batch))

    def loss(tokens: np.ndarray) -> float:
        return float(model.loss(params, {"tokens": torch.from_numpy(tokens).to(model.device)}))

    out = []
    for s in range(PROBE_STEP, PROBE_STEP + batches):
        toks = stream.batch(s)
        if batch <= PROBE_ROWS:
            out.append(loss(toks))
        else:
            parts = [(loss(toks[r: r + PROBE_ROWS]), len(toks[r: r + PROBE_ROWS]))
                     for r in range(0, batch, PROBE_ROWS)]
            out.append(sum(v * n for v, n in parts) / batch)
    return out


def probe_loss(device, params: dict, arch: str = LM_ARCH, smoke: bool = False,
               batch: int = LM_BATCH, seq: int = LM_SEQ, **overrides) -> float:
    """`params`' mean loss over the PROBE_BATCHES held-out batches."""
    return float(np.mean(probe_losses(device, params, arch, smoke, batch, seq, PROBE_BATCHES,
                                      **overrides)))


def initial_probe(device, arch: str = LM_ARCH, smoke: bool = False, batch: int = LM_BATCH,
                  seq: int = LM_SEQ, **overrides) -> dict:
    """The initial params' (`launch.train.train`'s init, seed 0) mean loss
    over the PROBE_BATCHES held-out batches, and its spread (max - min)
    between them."""
    model = LM(_config(arch, smoke, **overrides), device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    losses = probe_losses(device, params, arch, smoke, batch, seq, PROBE_BATCHES, **overrides)
    return {"before": float(np.mean(losses)), "spread": max(losses) - min(losses)}


def probe_fall(probe: dict, run: dict) -> float:
    """How far a run lowered the held-out batches' mean loss."""
    return probe["before"] - run["probe_loss"]


def trains(probe: dict, run: dict, steps: int) -> bool:
    """The training gate of one run: `steps` finite losses, the last below
    the first, and the held-out batches' mean loss fallen by more than
    the initial spread between them."""
    loss = run["loss"]
    return (len(loss) == steps and bool(np.all(np.isfinite(loss))) and loss[-1] < loss[0]
            and probe_fall(probe, run) > probe["spread"])


def train_runs(device, arch: str = LM_ARCH, smoke: bool = False, steps: int = LM_STEPS,
               batch: int = LM_BATCH, seq: int = LM_SEQ, lr: float = LM_LR) -> dict:
    """The default run, the `dedup_embed_grad=True` run, a second one from
    the same seed, and one stopped at LM_STOP and resumed.  Only the
    stopped / resumed pair writes checkpoints (every LM_CKPT_EVERY steps,
    into a directory removed after); the others write none (a 4.6 GB
    final checkpoint each at full width, which no gate reads).  Only the
    states compared are kept."""
    size = {"steps": steps, "batch": batch, "seq": seq, "lr": lr}
    runs = {"probe": initial_probe(device, arch, smoke, batch, seq)}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, ckpt_dir=None, **kw):
            r = runs[name] = train_run(device, ckpt_dir, arch, smoke, **size,
                                       checkpoints=ckpt_dir is not None, **kw)
            r["probe_loss"] = probe_loss(device, r["state"][0], arch, smoke, batch, seq)
            return r
        del run("default")["state"]
        run("dedup", dedup_embed_grad=True)
        run("dedup_again", dedup_embed_grad=True)
        runs["same_seed"] = _same_state(runs["dedup"]["state"], runs["dedup_again"]["state"])
        del runs["dedup_again"]["state"]
        del run("stopped", f"{tmp}/stopped", ckpt_every=LM_CKPT_EVERY, dedup_embed_grad=True,
                stop_after=LM_STOP)["state"]
        run("resumed", f"{tmp}/stopped", ckpt_every=LM_CKPT_EVERY, auto_resume=True,
            dedup_embed_grad=True)
    runs["stopped_at"] = runs["stopped"]["summary"]["step"]
    runs["resume"] = _same_state(runs["dedup"]["state"], runs["resumed"]["state"])
    del runs["resumed"]["state"]
    return runs


def check_train_runs(runs: dict, steps: int = LM_STEPS, on_card: bool = True) -> list[str]:
    """The training gates (the launch counts on a card only)."""
    problems = []
    probe = runs["probe"]
    for name in ("default", "dedup", "dedup_again"):
        if not trains(probe, runs[name], steps):
            problems.append(f"{name}: loss not finite and falling over {steps} steps: "
                            f"{runs[name]['loss']}; held-out batches {probe['before']} -> "
                            f"{runs[name]['probe_loss']}, spread {probe['spread']}")
    dedup = runs["dedup"]["launches"]
    if on_card and (dedup["bum_sort"] != steps or dedup["bum_scatter"] != steps):
        problems.append(f"dedup run: bum_sort / bum_scatter launched {dedup['bum_sort']} / "
                        f"{dedup['bum_scatter']} times, expected once a step ({steps})")
    if runs["default"]["launches"]["bum_scatter"]:
        problems.append("default run launched bum_scatter (its backward is index_add_)")
    if not all(runs["same_seed"].values()):
        problems.append(f"two dedup runs from one seed differ: {runs['same_seed']}")
    resumed = runs["resumed"]
    if runs["stopped_at"] != LM_STOP or resumed["start"] != LM_STOP \
            or not all(runs["resume"].values()):
        problems.append(f"stopped at {runs['stopped_at']}, resumed from {resumed['start']}: "
                        f"{runs['resume']}")
    if resumed["loss"] != runs["dedup"]["loss"][LM_STOP:]:
        problems.append("the resumed run's losses differ from the uninterrupted run's")
    return problems


@torch.no_grad()
def decode_parity(device, params: dict, arch: str = LM_ARCH, smoke: bool = False,
                  batch: int = 4, prompt: int = 16, steps: int = DECODE_STEPS,
                  seed: int = 0, **overrides) -> dict:
    """`prefill` of `prompt` tokens and `steps` decode steps (teacher-forced
    tokens) against one full `forward` over the same tokens, at the same
    positions: the largest |error| less the tolerance's allowance (<= 0
    passes), per position.  An encoder-decoder takes frame embeddings
    drawn after the tokens from the same seed."""
    model = LM(_config(arch, smoke, **overrides), device=device)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, model.cfg.vocab, (batch, prompt + steps)),
                           dtype=torch.int32).to(model.device)
    kw = _frames(model.cfg, rng, batch, model.device)
    want, _ = model.forward(params, tokens=toks, **kw)
    logits, caches, enc_out = model.prefill(params, tokens=toks[:, :prompt],
                                            max_seq=prompt + steps + 1, **kw)
    got = [logits]
    for k in range(steps):
        pos = torch.full((batch, 1), prompt + k, dtype=torch.int32, device=model.device)
        logits, caches = model.decode_step(params, caches, toks[:, prompt + k: prompt + k + 1],
                                           pos, encoder_out=enc_out)
        got.append(logits)
    rows = []
    for k, g in enumerate(got):
        w = want[:, prompt - 1 + k]
        excess = (g - w).abs() - (DECODE_ATOL + DECODE_RTOL * w.abs())
        rows.append({"position": prompt - 1 + k, "max_abs_err": float((g - w).abs().max()),
                     "worst_excess": float(excess.max())})
    return {"positions": rows, "ok": all(r["worst_excess"] <= 0 for r in rows)}


@torch.no_grad()
def cpu_parity(device, arch: str = LM_ARCH, smoke: bool = False, tokens: int = CPU_TOKENS,
               seed: int = 0, params: dict | None = None, **overrides) -> dict:
    """One f32 forward of `arch` on `device` and on the CPU with the same
    params (`params` cast to f32, or drawn on the CPU; copied to each
    side): the last token's logits' largest |difference|.  An
    encoder-decoder takes one row of frame embeddings drawn from `seed`."""
    cfg = _config(arch, smoke, dtype="float32", **overrides)
    cpu = LM(cfg, device="cpu")
    if params is None:
        params = cpu.init(torch.Generator().manual_seed(seed))
    params = _to(params, "cpu", torch.float32)
    toks = torch.from_numpy(_tokens((1, tokens), cfg.vocab, step=2))
    kw = _frames(cfg, np.random.default_rng(seed), 1, "cpu")
    want = cpu.forward(params, tokens=toks, **kw)[0][:, -1]
    card = LM(cfg, device=device)
    got = card.forward(_to(params, device), tokens=toks.to(card.device),
                       **_to(kw, card.device))[0][:, -1].cpu()
    return {"max_abs_err": float((got - want).abs().max()),
            "logit_scale": float(want.abs().max()), "tol": CPU_LOGITS_TOL,
            "ok": bool((got - want).abs().max() <= CPU_LOGITS_TOL)}


def _frames(cfg, rng: np.random.Generator, batch: int, device) -> dict:
    """An encoder-decoder's `encoder_embeds` (normal draws of the audio
    stub's shape) as keyword arguments; none for a decoder."""
    if not cfg.enc_dec:
        return {}
    return {"encoder_embeds": torch.as_tensor(
        rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32).to(device)}


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def serve_run(device, params: dict, arch: str = LM_ARCH, smoke: bool = False,
              serve_args: dict = SERVE_ARGS) -> dict:
    kernels.reset_launches()
    out = serve_lib.serve(arch, smoke=smoke, device=device, params=params, **serve_args)
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def lm_phase(device, card: str) -> dict:
    """Phase 12 on the card, with its gates: the wide-row kernel cases, the
    training runs, serving, the decode parity and the CPU parity."""
    from .smoke import _print_case
    t_phase = time.perf_counter()
    cases = wide_cases(device)
    failed = [c["case"] for c in cases if not (_print_case(c, card) and c["deterministic"])]
    for c in cases:
        if "distinct_rows" in c:
            print(f"lm stream {c['case']}: {c['shape'][0]} tokens, {c['distinct_rows']} "
                  f"distinct rows, two launches byte-identical {c['deterministic']}")
    win = windowed_commit(device)
    print(f"lm windowed commit (one stream of {win['tokens']} tokens, {win['windows']} windows "
          f"of {win['window']}) on the card == plain on the CPU: {win['exact']}, launches "
          f"{json.dumps(win['launches'])}", flush=True)
    if failed or not win["exact"] or win["launches"].get("bum_sort") != win["windows"]:
        raise RuntimeError(f"wide-row kernel parity failed: {failed}, windowed {win}")

    t0 = time.perf_counter()
    runs = train_runs(device)
    cfg = runs["dedup"]["cfg"]
    print(f"lm train {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, batch {LM_BATCH} x seq {LM_SEQ}, {LM_STEPS} steps at peak lr {LM_LR}, "
          f"5 runs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    probe = runs["probe"]
    print(f"lm train held-out batches (stream steps {PROBE_STEP}-"
          f"{PROBE_STEP + PROBE_BATCHES - 1}): initial mean loss {probe['before']:.5f}, "
          f"spread between them {probe['spread']:.5f}")
    for name in ("default", "dedup", "dedup_again", "stopped", "resumed"):
        r = runs[name]
        print(f"lm train {name}: steps {r['step'][0]}-{r['step'][-1]}, loss "
              f"{r['loss'][0]:.4f} -> {r['loss'][-1]:.4f}, held-out mean "
              f"{r['probe_loss']:.5f} (fall {probe_fall(probe, r):.5f}), median step "
              f"{_median_ms(r):.2f} ms (first {r['step_ms'][0]:.1f} ms), wall "
              f"{r['wall_s']:.2f} s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    print(f"lm train losses default {json.dumps([round(x, 5) for x in runs['default']['loss']])}")
    print(f"lm train losses dedup {json.dumps([round(x, 5) for x in runs['dedup']['loss']])}")
    print(f"lm train two dedup runs from one seed, same bytes: {json.dumps(runs['same_seed'])}; "
          f"stopped at {runs['stopped_at']} and resumed to {LM_STEPS}, same bytes: "
          f"{json.dumps(runs['resume'])}", flush=True)
    for name in ("default", "dedup"):
        print(f"lm_train{'_dedup' if name == 'dedup' else ''}-path launches: "
              f"{json.dumps(runs[name]['launches'])}")
    problems = check_train_runs(runs)
    if problems:
        raise RuntimeError(f"lm training gate failed: {problems}")

    params = runs["dedup"]["state"][0]
    t0 = time.perf_counter()
    served = serve_run(device, params)
    print(f"lm serve: {served['completed']} of {served['requests']} requests, "
          f"{served['steps']} decode steps of batch {served['batch']} in "
          f"{served['wall_s']:.3f} s: {served['tok_s']:.1f} tok/s decode "
          f"({time.perf_counter() - t0:.2f} s with prefills) [{card}]", flush=True)
    if served["completed"] < served["requests"]:
        raise RuntimeError(f"lm serving completed {served['completed']} of "
                           f"{served['requests']} requests")
    dec = decode_parity(device, params)
    print(f"lm prefill + {DECODE_STEPS} decode steps vs teacher-forced forward (bf16, atol = "
          f"rtol = {DECODE_ATOL}): {json.dumps(dec)}", flush=True)
    if not dec["ok"]:
        raise RuntimeError(f"prefill / decode disagree with the full forward: {dec}")
    launches = {"lm_train": runs["default"]["launches"],
                "lm_train_dedup": runs["dedup"]["launches"], "lm_serve": served["launches"]}
    summary = {name: {"median_step_ms": _median_ms(runs[name]),
                      "peak_bytes": runs[name]["peak_bytes"]}
               for name in ("default", "dedup", "dedup_again", "stopped", "resumed")}
    del runs, params
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cpu = cpu_parity(device)
    print(f"lm f32 forward, card vs CPU, last-token logits: {json.dumps(cpu)}", flush=True)
    if not cpu["ok"]:
        raise RuntimeError(f"the card's f32 forward disagrees with the CPU's: {cpu}")
    print(f"lm phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"cases": cases, "launches": launches, "served": served, "train": summary,
            "decode": dec, "cpu": cpu}
