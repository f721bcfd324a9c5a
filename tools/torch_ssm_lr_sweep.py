"""How the SSM decoders' 30-step training runs fare at each peak learning rate.

falcon-mamba-7b and zamba2-7b at full width with chip_smoke.py's phase-14
depth cuts (3 / 7 layers), batch 4 x seq 256 of `SyntheticLMStream`, 30
steps of `launch.train.train` (warmup 10, cosine to 0; clip 1.0, weight
decay 0.01), no checkpoint: for each (arch, peak lr, dtype) the step
losses, the held-out probe of phase 14 (`PROBE_BATCH` rows of 256 on 8
held-out batches: the initial params' mean loss and spread, and the mean
after the run), and, for zamba2's Mamba-2 layers, the largest masked
exponent of each step: SSD forms ``exp(cum_i - cum_j)`` over the whole
chunk before its lower-triangular mask (`models/ssm.py`, as the
reference's `ssm.py:196`), and the largest one above the diagonal is
``cum_0 - cum_{Q-1}``; past 88.72 it overflows f32, and the backward's
``0 * inf`` turns the gradient to NaN.  Prints one JSON line per run.
Needs a CUDA card:

    python3 tools/torch_ssm_lr_sweep.py
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import kernels, smoke, smoke_lm, smoke_ssm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

RUNS = [("falcon-mamba-7b", 1e-3, "bfloat16"), ("falcon-mamba-7b", 1e-3, "float32"),
        ("falcon-mamba-7b", 5e-4, "bfloat16"), ("falcon-mamba-7b", 3e-4, "bfloat16"),
        ("zamba2-7b", 1e-3, "bfloat16"), ("zamba2-7b", 5e-4, "bfloat16"),
        ("zamba2-7b", 4e-4, "bfloat16"), ("zamba2-7b", 3e-4, "bfloat16")]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssm_lr_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    kernels.build()
    exponents: list[float] = []
    chunk = ssm._ssd_chunk

    def recording(h, dt_q, dta_q, b_q, c_q, x_q):
        if torch.is_grad_enabled():    # training passes only, not the probes
            cum = torch.cumsum(dta_q.detach(), dim=1)
            exponents.append(float((cum[:, 0] - cum[:, -1]).max()))
        return chunk(h, dt_q, dta_q, b_q, c_q, x_q)

    ssm._ssd_chunk = recording
    size = {"batch": smoke_ssm.TRAIN_BATCH, "seq": smoke_ssm.TRAIN_SEQ}
    steps = smoke_ssm.TRAIN_STEPS
    try:
        for arch, lr, dtype in RUNS:
            over = {"n_layers": smoke_ssm.TRAIN_LAYERS[arch], "dtype": dtype}
            t0 = time.perf_counter()
            probe = smoke_lm.initial_probe("cuda", arch, False, smoke_ssm.PROBE_BATCH,
                                           size["seq"], **over)
            exponents.clear()
            run = smoke_lm.train_run("cuda", None, arch, False, steps=steps, lr=lr,
                                     checkpoints=False, **size, **over)
            per = len(exponents) // steps
            after = smoke_lm.probe_loss("cuda", run["state"][0], arch, False,
                                        smoke_ssm.PROBE_BATCH, size["seq"], **over)
            print(json.dumps({
                "arch": arch, "lr": lr, "dtype": dtype, "loss": run["loss"],
                "held_out_before": probe["before"], "spread": probe["spread"],
                "held_out_after": after, "fall": probe["before"] - after,
                "gate": smoke_lm.trains(probe, {**run, "probe_loss": after}, steps),
                "max_masked_exponent": [max(exponents[i * per:(i + 1) * per])
                                        for i in range(steps)] if per else None,
                "median_step_ms": smoke_lm._median_ms(run), "peak_bytes": run["peak_bytes"],
                "s": time.perf_counter() - t0, "card": card}), flush=True)
            del run
            torch.cuda.empty_cache()
    finally:
        ssm._ssd_chunk = chunk
    return 0


if __name__ == "__main__":
    sys.exit(main())
