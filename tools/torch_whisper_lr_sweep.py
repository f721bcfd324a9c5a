"""How whisper-medium's 30-step training run fares at each peak learning rate.

whisper-medium at full width and depth (24 + 24 layers, bf16), chip_smoke.py
phase 15's batch (4 x 448 tokens of `SyntheticLMStream` beside 4 x 1500
frame embeddings, `smoke_whisper.audio_batch`), 30 steps of
`smoke_whisper.train_run` (`train_step` under `TrainDriver`; warmup 10,
cosine to 0; clip 1.0, weight decay 0.01), the default embedding backward,
no checkpoint: for each peak lr the step losses and the held-out probe of
phase 15 (the initial params' mean loss and spread over its 8 held-out
batches, and the mean after the run).  Prints one JSON line per run.
Needs a CUDA card:

    python3 tools/torch_whisper_lr_sweep.py [lr ...]
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import smoke, smoke_lm, smoke_whisper  # noqa: E402

LRS = (5e-4, 2.5e-4, 1e-4)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_whisper_lr_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    lrs = [float(a) for a in (sys.argv[1:] if argv is None else argv)] or LRS
    probe = smoke_whisper.initial_probe("cuda")
    for lr in lrs:
        t0 = time.perf_counter()
        run = smoke_whisper.train_run("cuda", None, lr=lr)
        run["probe_loss"] = float(np.mean(smoke_whisper.probe_losses("cuda", run["state"][0])))
        print(json.dumps({
            "arch": smoke_whisper.ARCH, "lr": lr, "loss": run["loss"],
            "held_out_before": probe["before"], "spread": probe["spread"],
            "held_out_after": run["probe_loss"], "fall": smoke_lm.probe_fall(probe, run),
            "gate": smoke_lm.trains(probe, run, smoke_whisper.TRAIN_STEPS),
            "median_step_ms": smoke_lm._median_ms(run), "peak_bytes": run["peak_bytes"],
            "s": time.perf_counter() - t0, "card": card}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
