"""Where one LM training step and one decode step spend their time on the card.

qwen1.5-0.5b at full width (the configuration of chip_smoke.py's phase 12:
batch 8 x seq 128 of `SyntheticLMStream`, bf16 params, remat, AdamW with
clip_norm 1.0 and weight decay 0.01, the BUM-merged embedding backward)
trains 3 warm-up steps through `launch.train.train_step`, then 3 steps
under torch.profiler, each ended by its loss on the host as the training
loop reads it; then 3 unprofiled steps for the wall.  Then the served
model (batch 4, a 16-token prompt) decodes 3 warm-up and 8 profiled steps.
Prints one JSON line: per step the wall (profiled and unprofiled), the
device busy time (sum of device kernel and copy time), the idle share
against the unprofiled wall, the host-side operator calls, the device
kernels launched, and the top device kernels by time.  Needs a CUDA card:

    python3 tools/torch_lm_profile.py
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import LMStreamConfig, SyntheticLMStream  # noqa: E402
from repro_torch.launch.train import train_step  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import AdamW, schedule  # noqa: E402

WARMUP, PROFILED, UNPROFILED = 3, 3, 3
DECODE_WARMUP, DECODE_PROFILED = 3, 8


def _summary(prof, wall_ms: float, host_ms: float, n: int) -> dict:
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    cpu_ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms_profiled": wall_ms / n, "wall_ms": host_ms / n, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / (host_ms / n)),
            "aten_ops": cpu_ops // n, "device_kernels": sum(e.count for e in dev) // n,
            "top_device_ms": {e.key[:60]: round(e.self_device_time_total / 1e3 / n, 3)
                              for e in top}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_lm_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-0.5b", dedup_embed_grad=True)
    model = LM(cfg, device=dev)
    opt = AdamW(lr=schedule.warmup_cosine(1e-3, 10, 30), clip_norm=1.0, weight_decay=0.01)
    stream = SyntheticLMStream(LMStreamConfig(cfg.vocab, 128, 8)).iterator()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = opt.init(params)

    def step():
        nonlocal params, state
        tokens = torch.from_numpy(next(stream)["tokens"]).to(dev)
        params, state, loss = train_step(model, opt, params, state, {"tokens": tokens})
        return float(loss)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(UNPROFILED):
        step()
    host = (time.perf_counter() - t0) * 1e3
    out = {"card": smoke.card_line(), "train_step": _summary(prof, wall, host, PROFILED)}

    with torch.no_grad():
        toks = torch.randint(1, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(0))
        _, caches, _ = model.prefill(params, tokens=toks.to(dev), max_seq=16 + 32)
        tok = toks[:, -1:].to(dev)

        def decode(k):
            nonlocal caches, tok
            pos = torch.full((4, 1), 16 + k, dtype=torch.int32, device=dev)
            logits, caches = model.decode_step(params, caches, tok, pos)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            return int(tok[0, 0])

        for k in range(DECODE_WARMUP):
            decode(k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(DECODE_PROFILED):
                decode(DECODE_WARMUP + k)
            wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for k in range(DECODE_PROFILED):
            decode(DECODE_WARMUP + DECODE_PROFILED + k)
        host = (time.perf_counter() - t0) * 1e3
    out["decode_step"] = _summary(prof, wall, host, DECODE_PROFILED)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
