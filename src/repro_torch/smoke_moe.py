"""Phase 13 of ``chip_smoke.py``: DeepSeek's MLA attention, its
mixture-of-experts and the multi-token-prediction head.

deepseek-v2-lite (d 2048, 16 heads, MLA kv_lora 512, 64 routed + 2 shared
experts top-6, vocab 102,400, bf16) and deepseek-v3's smoke config, through
the entry points a user calls (`launch.train.train`, `launch.serve.serve`):

1. #7 (`bum_scatter`) and its sort (`bum_sort`) on the embedding-gradient
   rows of both vocabularies, each against its plain version exactly and the
   same bytes on two launches: 4 x 128 tokens of `SyntheticLMStream` at
   F = 2048 into 102,400 rows, 8 x 128 at F = 7168 into 129,280 rows;
2. deepseek-v2-lite at full width with its depth cut to `TRAIN_LAYERS` (one
   `mla_dense`, two `mla_moe`), batch 4 x seq 128, 30 steps at
   `smoke_lm.LM_LR`: the default run (``lm_moe_train``), then two
   ``dedup_embed_grad=True`` runs from one seed (``lm_moe_train_dedup``: #7
   and `bum_sort` once a step); the held-out gate of phase 12
   (`smoke_lm.trains`, its held-out batches `PROBE_BATCH` x 128) on the
   default and the first merged run, the two merged runs the same bytes
   (params and both moments); no checkpoint is written;
3. deepseek-v3's smoke config (q_lora, sigmoid scores with a selection bias,
   route_scale 2.5, the MTP head) with ``dedup_embed_grad=True``, batch 8 x
   seq 64, 20 steps at peak lr 3e-3 (``lm_mtp_train_dedup``: #7 and
   `bum_sort` twice a step, the MTP head's `embed` being the second); the
   held-out gate; a run stopped at 10 and resumed through `resume_or_init`
   ends on the uninterrupted run's bytes;
4. deepseek-v2-lite at full width and full depth (27 layers, 31.4 GB of bf16
   params, a fresh init on the card) serving 8 requests of 16 prompt tokens
   and 24 new ones, 4 at a time (``lm_moe_serve``): every request completes
   with finite logits;
5. parity at f32 on the depth-cut model (the first merged run's params cast
   to f32): `prefill` and three `decode_step`s against a teacher-forced
   `forward` within the reference test's atol = rtol = 2e-2; the card's
   last-token logits against the CPU's from the same params within
   `smoke_lm.CPU_LOGITS_TOL`; deepseek-v3's smoke config's step-1 loss, card
   against CPU, within `MTP_LOSS_TOL`.  Each prints how many routing
   decisions (a token's selected expert set in one MoE layer) differ
   between the two sides, with the smallest k-th to (k+1)-th selection
   margin among them: near a tie a rounding difference swaps an expert,
   which is reported, not absorbed by a tolerance.

Each function takes the device, so a CPU test can rehearse it on the smoke
configs (``smoke=True``).
"""
from __future__ import annotations

import json
import math
import tempfile
import time

import numpy as np
import torch

from . import smoke_lm
from .data import LMStreamConfig, SyntheticLMStream
from .models import moe
from .models.lm import LM

MOE_ARCH = "deepseek-v2-lite-16b"
MTP_ARCH = "deepseek-v3-671b"
# deepseek-v2-lite's training runs: full width, one dense and two MoE layers
# (1,670,135,424 params, ~20 GB with AdamW's f32 moments; the full 27 layers
# would need ~188 GB).
TRAIN_LAYERS = 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 128, 30
TRAIN_LR = smoke_lm.LM_LR
# The held-out probe's batch (stream steps smoke_lm.PROBE_STEP on, 128
# tokens a row): as many tokens as the whole run trains on (30 x 4 x 128 =
# 15,360).  At 4 rows the spread between the 8 held-out batches' initial
# losses was 0.126 and at 32 rows 0.053, against a fall of 0.071 / 0.050
# over the 30 steps (NVIDIA H100 80GB HBM3, 700 W): the data is a random
# bigram process over 102,400 tokens, so 30 steps learn ~0.05 nats, and a
# small batch's draw moves its loss by more.  The fall is a mean over the
# same tokens before and after; an lr-0 run still falls by exactly 0.
PROBE_BATCH = 128
# deepseek-v3's smoke-config runs (683 B params at full width fit no card).
MTP_BATCH, MTP_SEQ, MTP_STEPS, MTP_STOP, MTP_LR = 8, 64, 20, 10, 3e-3
# The step-1 loss of deepseek-v3's f32 smoke config, card (TF32 off)
# against the CPU: both sum in f32 in their own orders; the loss is ~5.5.
MTP_LOSS_TOL = 1e-4
SERVE_ARGS = smoke_lm.SERVE_ARGS
# The wide-row kernel cases: (label, tokens, F, vocab rows).
WIDE_CASES = (("deepseek-v2-lite embedding backward, 4 x 128 tokens", (4, 128), 2048, 102_400),
              ("deepseek-v3 embedding backward, 8 x 128 tokens", (8, 128), 7168, 129_280))


def n_moe_layers(cfg) -> int:
    return sum(n for kind, n in LM(cfg, device="meta").segs if kind.endswith("moe"))


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.to(torch.float32) for k, v in tree.items()}


# --- routing decisions ----------------------------------------------------------------

def _path_routes(log: list, layers: int) -> list:
    """A prefill's routes followed by its decode steps' (`layers` MoE layers
    each, in call order) -> per layer (sel (B, S, E), ids (B, S, k)), each
    call's tokens at their positions."""
    prefill, steps = log[:layers], log[layers:]
    b = steps[0][1].shape[0] if steps else 1
    out = []
    for layer in range(layers):
        calls = [prefill[layer]] + steps[layer::layers]
        out.append(tuple(torch.cat([c[i].reshape(b, -1, c[i].shape[-1]) for c in calls], dim=1)
                         for i in (0, 1)))
    return out


def route_flips(want: list, got: list) -> dict:
    """Routing decisions of two runs over the same tokens (per MoE layer,
    (sel, ids)): how many (layer, token) selected expert sets differ, and
    the k-th to (k+1)-th selection margin (from `want`) -- the smallest
    among the differing decisions and over all of them."""
    total = flips = 0
    flipped_margin, least = math.inf, math.inf
    for (w_sel, w_ids), (_, g_ids) in zip(want, got):
        k = w_ids.shape[-1]
        w_set = torch.sort(w_ids.reshape(-1, k).cpu(), dim=-1).values
        g_set = torch.sort(g_ids.reshape(-1, k).cpu(), dim=-1).values
        differ = (w_set != g_set).any(dim=-1)
        top = torch.sort(w_sel.reshape(-1, w_sel.shape[-1]).cpu().to(torch.float64), dim=-1,
                         descending=True).values
        margin = top[:, k - 1] - top[:, k]
        total += differ.numel()
        flips += int(differ.sum())
        least = min(least, float(margin.min()))
        if differ.any():
            flipped_margin = min(flipped_margin, float(margin[differ].min()))
    return {"decisions": total, "flips": flips,
            "min_margin_flipped": None if flips == 0 else flipped_margin, "min_margin": least}


# --- training -------------------------------------------------------------------------

def train_runs(device, arch: str = MOE_ARCH, smoke: bool = False, steps: int = TRAIN_STEPS,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ, lr: float = TRAIN_LR,
               probe_batch: int = PROBE_BATCH, **overrides) -> dict:
    """The default run and two ``dedup_embed_grad=True`` runs from one seed,
    none checkpointed; the held-out probe (`probe_batch` rows a batch)
    before and after each.  Only the first merged run's state is kept."""
    if not smoke:
        overrides = {"n_layers": TRAIN_LAYERS, **overrides}
    probe = {"batch": probe_batch, "seq": seq}
    runs = {"probe": smoke_lm.initial_probe(device, arch, smoke, **probe, **overrides)}
    for name, kw in (("default", {}), ("dedup", {"dedup_embed_grad": True}),
                     ("dedup_again", {"dedup_embed_grad": True})):
        r = runs[name] = smoke_lm.train_run(device, None, arch, smoke, steps=steps,
                                            batch=batch, seq=seq, lr=lr, checkpoints=False,
                                            **overrides, **kw)
        r["probe_loss"] = smoke_lm.probe_loss(device, r["state"][0], arch, smoke, **probe,
                                              **overrides)
        if name == "default":
            del r["state"]
    runs["same_seed"] = smoke_lm._same_state(runs["dedup"]["state"], runs["dedup_again"]["state"])
    del runs["dedup_again"]["state"]
    return runs


def check_train_runs(runs: dict, steps: int = TRAIN_STEPS, on_card: bool = True) -> list[str]:
    """The gates of `train_runs` (the launch counts on a card only)."""
    problems = []
    probe = runs["probe"]
    for name in ("default", "dedup"):
        if not smoke_lm.trains(probe, runs[name], steps):
            problems.append(f"{name}: loss not finite and falling over {steps} steps: "
                            f"{runs[name]['loss']}; held-out batches {probe['before']} -> "
                            f"{runs[name]['probe_loss']}, spread {probe['spread']}")
    if not all(np.isfinite(runs["dedup_again"]["loss"])):
        problems.append(f"dedup_again: loss not finite: {runs['dedup_again']['loss']}")
    for name in ("dedup", "dedup_again"):
        got = runs[name]["launches"]
        if on_card and (got["bum_sort"] != steps or got["bum_scatter"] != steps):
            problems.append(f"{name}: bum_sort / bum_scatter launched {got['bum_sort']} / "
                            f"{got['bum_scatter']} times, expected once a step ({steps})")
    default = runs["default"]["launches"]
    if default["bum_scatter"] or default["bum_sort"]:
        problems.append(f"default run launched bum_sort / bum_scatter: {default}")
    if not all(runs["same_seed"].values()):
        problems.append(f"two dedup runs from one seed differ: {runs['same_seed']}")
    return problems


def mtp_runs(device, arch: str = MTP_ARCH, smoke: bool = True, steps: int = MTP_STEPS,
             batch: int = MTP_BATCH, seq: int = MTP_SEQ, lr: float = MTP_LR,
             stop: int = MTP_STOP) -> dict:
    """deepseek-v3 with ``dedup_embed_grad=True``: an uninterrupted run (not
    checkpointed), one stopped at `stop` (checkpointed every `stop` steps)
    and one resumed from its checkpoint to `steps`; the held-out probe
    before and after the uninterrupted run."""
    size = {"batch": batch, "seq": seq}
    runs = {"probe": smoke_lm.initial_probe(device, arch, smoke, **size)}
    common = dict(steps=steps, lr=lr, dedup_embed_grad=True, **size)
    runs["dedup"] = smoke_lm.train_run(device, None, arch, smoke, checkpoints=False, **common)
    runs["dedup"]["probe_loss"] = smoke_lm.probe_loss(device, runs["dedup"]["state"][0],
                                                      arch, smoke, **size)
    with tempfile.TemporaryDirectory() as tmp:
        runs["stopped"] = smoke_lm.train_run(device, f"{tmp}/part", arch, smoke,
                                             ckpt_every=stop, stop_after=stop, **common)
        runs["resumed"] = smoke_lm.train_run(device, f"{tmp}/part", arch, smoke,
                                             ckpt_every=stop, auto_resume=True, **common)
    runs["stopped_at"] = runs["stopped"]["summary"]["step"]
    runs["resume"] = smoke_lm._same_state(runs["dedup"]["state"], runs["resumed"]["state"])
    for name in ("dedup", "stopped", "resumed"):
        del runs[name]["state"]
    return runs


def check_mtp_runs(runs: dict, steps: int = MTP_STEPS, stop: int = MTP_STOP,
                   on_card: bool = True) -> list[str]:
    problems = []
    probe, full = runs["probe"], runs["dedup"]
    if not smoke_lm.trains(probe, full, steps):
        problems.append(f"mtp dedup: loss not finite and falling over {steps} steps: "
                        f"{full['loss']}; held-out batches {probe['before']} -> "
                        f"{full['probe_loss']}, spread {probe['spread']}")
    got = full["launches"]
    if on_card and (got["bum_sort"] != 2 * steps or got["bum_scatter"] != 2 * steps):
        problems.append(f"mtp dedup: bum_sort / bum_scatter launched {got['bum_sort']} / "
                        f"{got['bum_scatter']} times, expected twice a step ({2 * steps})")
    resumed = runs["resumed"]
    if runs["stopped_at"] != stop or resumed["start"] != stop or not all(runs["resume"].values()):
        problems.append(f"stopped at {runs['stopped_at']}, resumed from {resumed['start']}: "
                        f"{runs['resume']}")
    if resumed["loss"] != full["loss"][stop:]:
        problems.append("the resumed run's losses differ from the uninterrupted run's")
    return problems


# --- parity ---------------------------------------------------------------------------

def decode_parity(device, params: dict, arch: str = MOE_ARCH, smoke: bool = False,
                  **overrides) -> dict:
    """`smoke_lm.decode_parity` (prefill and three decode steps against a
    teacher-forced forward) with the routing decisions of both sides."""
    if not smoke:
        overrides = {"n_layers": TRAIN_LAYERS, **overrides}
    cfg = smoke_lm._config(arch, smoke, **overrides)
    layers = n_moe_layers(cfg)
    with moe.record_routes() as log:
        dec = smoke_lm.decode_parity(device, params, arch, smoke, **overrides)
    dec["routes"] = route_flips(log[:layers], _path_routes(log[layers:], layers))
    return dec


def cpu_parity(device, params: dict, arch: str = MOE_ARCH, smoke: bool = False,
               tokens: int = smoke_lm.CPU_TOKENS, **overrides) -> dict:
    """`smoke_lm.cpu_parity` from `params` (the CPU's forward, then the
    card's), with the routing decisions that differ between the two."""
    if not smoke:
        overrides = {"n_layers": TRAIN_LAYERS, **overrides}
    with moe.record_routes() as log:
        out = smoke_lm.cpu_parity(device, arch, smoke, tokens=tokens, params=params,
                                  **overrides)
    half = len(log) // 2
    out["routes"] = route_flips(log[:half], log[half:])
    return out


@torch.no_grad()
def mtp_loss_parity(device, arch: str = MTP_ARCH, smoke: bool = True, batch: int = MTP_BATCH,
                    seq: int = MTP_SEQ, seed: int = 0) -> dict:
    """deepseek-v3's step-1 loss (the training stream's first batch, params
    drawn once on the CPU and copied) at f32 on `device` and on the CPU,
    with the routing decisions that differ."""
    cfg = smoke_lm._config(arch, smoke, dtype="float32")
    cpu = LM(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(seed))
    toks = torch.from_numpy(SyntheticLMStream(LMStreamConfig(cfg.vocab, seq, batch)).batch(0))
    with moe.record_routes() as want_routes:
        want = float(cpu.loss(params, {"tokens": toks}))
    card = LM(cfg, device=device)
    with moe.record_routes() as got_routes:
        got = float(card.loss(smoke_lm._to(params, device), {"tokens": toks.to(card.device)}))
    return {"card": got, "cpu": want, "abs_err": abs(got - want), "tol": MTP_LOSS_TOL,
            "ok": abs(got - want) <= MTP_LOSS_TOL,
            "routes": route_flips(want_routes, got_routes)}


# --- serving --------------------------------------------------------------------------

def serve_run(device, arch: str = MOE_ARCH, smoke: bool = False,
              serve_args: dict = SERVE_ARGS) -> dict:
    """`launch.serve.serve` of a fresh init (full width and depth unless
    `smoke`), counters zeroed just before, the card's peak memory over the
    run."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    out = smoke_lm.serve_run(device, None, arch, smoke, serve_args)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    return out


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def moe_phase(device, card: str) -> dict:
    """Phase 13 on the card, with its gates: the wide-row kernel cases, the
    deepseek-v2-lite and deepseek-v3 training runs, the f32 parity checks and
    the full-depth serve."""
    from .smoke import _print_case
    t_phase = time.perf_counter()
    cases = smoke_lm.wide_cases(device, WIDE_CASES)
    failed = [c["case"] for c in cases if not (_print_case(c, card) and c["deterministic"])]
    for c in cases:
        if "distinct_rows" in c:
            print(f"moe stream {c['case']}: {c['shape'][0]} tokens, {c['distinct_rows']} "
                  f"distinct rows, two launches byte-identical {c['deterministic']}", flush=True)
    if failed:
        raise RuntimeError(f"wide-row kernel parity failed: {failed}")

    t0 = time.perf_counter()
    runs = train_runs(device)
    cfg = runs["dedup"]["cfg"]
    print(f"moe train {cfg.name}: {cfg.n_layers} layers (depth cut), d {cfg.d_model}, "
          f"{cfg.moe.n_routed} + {cfg.moe.n_shared} experts top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps at peak lr {TRAIN_LR}, 3 runs in {time.perf_counter() - t0:.1f} s [{card}]")
    probe = runs["probe"]
    print(f"moe train held-out batches: initial mean loss {probe['before']:.5f}, spread "
          f"{probe['spread']:.5f}")
    for name in ("default", "dedup", "dedup_again"):
        r = runs[name]
        print(f"moe train {name}: loss {r['loss'][0]:.4f} -> {r['loss'][-1]:.4f}, held-out mean "
              f"{r['probe_loss']:.5f} (fall {smoke_lm.probe_fall(probe, r):.5f}), median step "
              f"{smoke_lm._median_ms(r):.2f} ms (first {r['step_ms'][0]:.1f} ms), wall "
              f"{r['wall_s']:.2f} s, peak memory {r['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    print(f"moe train losses dedup {json.dumps([round(x, 5) for x in runs['dedup']['loss']])}")
    print(f"moe train two dedup runs from one seed, same bytes: {json.dumps(runs['same_seed'])}")
    launches = {"lm_moe_train": runs["default"]["launches"],
                "lm_moe_train_dedup": runs["dedup"]["launches"]}
    for name, counts in launches.items():
        print(f"{name}-path launches: {json.dumps(counts)}", flush=True)
    problems = check_train_runs(runs)
    if problems:
        raise RuntimeError(f"moe training gate failed: {problems}")

    # parity at f32 on the depth-cut model, from the trained params
    summary = {name: {"median_step_ms": smoke_lm._median_ms(runs[name]),
                      "peak_bytes": runs[name]["peak_bytes"]}
               for name in ("default", "dedup", "dedup_again")}
    params = runs.pop("dedup")["state"][0]
    del runs
    _free(device)
    dec = decode_parity(device, _f32(params), dtype="float32")
    print(f"moe prefill + {smoke_lm.DECODE_STEPS} decode steps vs teacher-forced forward (f32, "
          f"atol = rtol = {smoke_lm.DECODE_ATOL}): {json.dumps(dec)}", flush=True)
    cpu = cpu_parity(device, params)
    print(f"moe f32 forward, card vs CPU, last-token logits: {json.dumps(cpu)}", flush=True)
    del params
    _free(device)
    mtp_loss = mtp_loss_parity(device)
    print(f"mtp f32 step-1 loss, card vs CPU: {json.dumps(mtp_loss)}", flush=True)
    if not (dec["ok"] and cpu["ok"] and mtp_loss["ok"]):
        raise RuntimeError(f"f32 parity failed: decode {dec}, cpu {cpu}, mtp loss {mtp_loss}")

    t0 = time.perf_counter()
    mtp = mtp_runs(device)
    print(f"mtp train {MTP_ARCH} smoke config, dedup_embed_grad, batch {MTP_BATCH} x seq "
          f"{MTP_SEQ}, {MTP_STEPS} steps at peak lr {MTP_LR}: 3 runs in "
          f"{time.perf_counter() - t0:.1f} s; held-out {mtp['probe']['before']:.5f} -> "
          f"{mtp['dedup']['probe_loss']:.5f} (spread {mtp['probe']['spread']:.5f}), loss "
          f"{mtp['dedup']['loss'][0]:.4f} -> {mtp['dedup']['loss'][-1]:.4f}, median step "
          f"{smoke_lm._median_ms(mtp['dedup']):.2f} ms; stopped at {mtp['stopped_at']} and "
          f"resumed to {MTP_STEPS}, same bytes: {json.dumps(mtp['resume'])} [{card}]")
    launches["lm_mtp_train_dedup"] = mtp["dedup"]["launches"]
    print(f"lm_mtp_train_dedup-path launches: {json.dumps(launches['lm_mtp_train_dedup'])}",
          flush=True)
    problems = check_mtp_runs(mtp)
    if problems:
        raise RuntimeError(f"mtp training gate failed: {problems}")
    _free(device)

    t0 = time.perf_counter()
    served = serve_run(device)
    print(f"moe serve {MOE_ARCH} full width and depth: {served['completed']} of "
          f"{served['requests']} requests, {served['steps']} decode steps of batch "
          f"{served['batch']} in {served['wall_s']:.3f} s: {served['tok_s']:.1f} tok/s decode "
          f"({time.perf_counter() - t0:.2f} s with init and prefills), logits finite "
          f"{served['finite']}, peak memory {served['peak_bytes'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    launches["lm_moe_serve"] = served["launches"]
    if served["completed"] < served["requests"] or not served["finite"]:
        raise RuntimeError(f"moe serving: {served}")
    _free(device)
    print(f"moe phase: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"cases": cases, "launches": launches, "served": served, "train": summary,
            "decode": dec, "cpu": cpu, "mtp_loss": mtp_loss}
