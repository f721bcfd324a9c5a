"""Quickest proof that the PyTorch/CUDA port trains and serves on an H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the main paths' shapes, trains
``TrainerConfig()`` for 400 steps on the paper's Instant-3D field and on
its Instant-NGP baseline, serves 800x800 novel-view requests through
``repro_torch.serve3d.RenderService`` from the trained snapshot, runs the
multi-scene ``repro_torch.serve3d.ReconstructionService`` on four scenes
and holds its bit-identity contracts, trains the uniform sampler, stage 2b
v2 and v3 under a ceiling of 4096 points a step and serves v3 at 800x800,
runs the service again with the async serving plane off and on and holds
the two byte for byte, runs the training CLI (resumed against
uninterrupted), the quickstart and the service demo, profiles one async
quantum (``tools/torch_service_profile.py``), runs the service again over
two slots of the card (``devices=["cuda:0", "cuda:0"]``: two driver
threads) and with ``devices=1`` and holds both to the placement-free bytes,
moves a suspended session between the slots bit for bit and from the CPU
to the card (against a session resumed on the card from the CPU run's
host tree), trains the field's ``residual_policy="stash"`` (the default's
bytes: on the card both policies run the same kernels) and
``merged_backward=False`` options, holds the table-reading kernels on bf16
and f16 tables to themselves on the tables' f32 copies and to their plain
versions, trains both fields with ``FieldConfig(grid_dtype="bfloat16")``,
serves from the trained bf16 snapshot (eval == served), runs two bf16
sessions as one cohort of the service (cohort == sequential) and holds the
service's four bit-identity contracts at bf16 -- every training step of
all of it a replay of a CUDA graph captured once per step variant -- then
trains four paths (both fields, v3 at 4096, bf16) captured and under
``eager_steps()`` and holds each pair to the same bytes, with capture
times, step times of both, the graphs' memory and a profiled replay
(``tools/torch_train_profile.py``) -- every chunk of every render of all
of it a replay of a CUDA graph captured once per render key -- then
serves four routes (redistributed, dense, v3, bf16) from the trained
snapshots captured and under ``eager_steps()`` and holds each pair to the
same bytes, with capture times, latencies of both and the graphs' memory,
then trains qwen1.5-0.5b at full width through the LM substrate's
``launch.train`` (its vocab-embedding backward through #7 and its sort on
1024-wide rows, the merged runs byte-identical from one seed and across a
resume) and serves it through ``launch.serve``, and prints
one JSON line with every kernel's report and, last, the device line.  It exits non-zero,
with no result, on any failure, and when no CUDA card is present.  The phases live in ``src/repro_torch/smoke.py``.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import smoke  # noqa: E402

if __name__ == "__main__":
    sys.exit(smoke.main())
