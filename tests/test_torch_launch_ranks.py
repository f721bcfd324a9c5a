"""The placed steps of the port's `launch.steps` across gloo ranks on the
CPU, against the same steps unplaced on the same mesh.

On four ranks, a ('data', 'model') = (2, 2) mesh:

* qwen3-8b's smoke config widened (d_model 128, d_ff 512, so the FFN and
  attention leaves pass the partition rules' FSDP size and split over
  both axes) trained one step under the FSDP-pure policy: each block's
  params gathered before it runs, the batch split over both axes, the
  embedding's table gradient a partial sum laid out as the table, AdamW
  on the local shards; then at batch 2, where the residual stream splits
  its sequence over 'model' (`attention._sdpa_on_shards`: each rank's
  query block against the gathered keys and values);
* deepseek-v2-lite's smoke config trained one step: the MoE layers'
  DTensor route through `moe_ep` (2 EP ranks of 8 routed experts, each
  rank's own experts gathered only over 'data');
* qwen3-8b's smoke config decoding one token under the TP policy (heads
  over 'model', the batch over 'data': `attention._decode_on_shards`),
  its caches random.
* the routes that run on each rank's local tensors (`models/shards.py`):
  falcon-mamba-7b's and zamba2-7b's smoke configs decoding one token
  under the TP policy (`ssm._ssm_on_shards`: the projections on the
  weights' blocks over 'model', the scan on the state's block of
  channels; zamba2's shared attention block beside it), deepseek-v2-lite's
  absorbed MLA decode (`attention.mla_decode_attention` on a DTensor
  cache: the heads and the latent cache's sequence over 'model'), and
  falcon-mamba-7b's and zamba2-7b's smoke configs widened (as qwen3-8b's,
  so the projections and zamba2's shared block split over both axes)
  trained one step under the FSDP-pure policy (Mamba-1's scan and SSD's
  chunks on each rank's rows, the weights' gradients partial sums).

The oracle is the port's unplaced SPMD step on the same mesh, on each
rank (every rank the whole params and batch: `LM(cfg, mesh)` and
`launch.train.train_step`, held to JAX across ranks by
`test_torch_lm_ep.py`; its MoE layers drop the same assignments).  Every
rank's loss, params and gradient moments after the step, or logits and
new caches, within `RANK_TOL` times the largest magnitude of the
oracle's (f32; the placed step's partial sums reduce in another order).
Params from a torch seed, the batch from a numpy seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import Shape, input_specs
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import tree_paths

RANK_TOL = 1e-5
SEQ = 16
WIDE = {"d_model": 128, "d_ff": 512}
CASES = {   # name: (arch, config overrides, kind, batch)
    "fsdp_train": ("qwen3-8b", WIDE, "train", 4),
    "fsdp_train_seq": ("qwen3-8b", WIDE, "train", 2),
    "moe_train": ("deepseek-v2-lite-16b", {}, "train", 4),
    "tp_decode": ("qwen3-8b", {}, "decode", 4),
    "mamba1_tp_decode": ("falcon-mamba-7b", {}, "decode", 4),
    "mla_tp_decode": ("deepseek-v2-lite-16b", {}, "decode", 4),
    "mamba1_train": ("falcon-mamba-7b", WIDE, "train", 4),
    "ssd_train": ("zamba2-7b", WIDE, "train", 4),
    "hybrid_tp_decode": ("zamba2-7b", {}, "decode", 4),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(arch, overrides, kind, n_batch, rng, seq=SEQ):
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {}
    for path, t in tree_paths(input_specs(cfg, Shape("t", seq, n_batch, kind))):
        if t.dtype.is_floating_point:
            a = (0.1 * rng.standard_normal(tuple(t.shape))).astype(np.float32)
            batch[path] = torch.from_numpy(a).to(t.dtype)
        else:
            hi = cfg.vocab if path[-1] == "tokens" else seq
            batch[path] = torch.from_numpy(rng.integers(0, hi, tuple(t.shape)).astype(np.int32))
    from repro_torch.optim.adamw import tree_from_paths
    return cfg, params, tree_from_paths(batch.items())


def _flat(prefix, tree) -> dict:
    return {f"{prefix}/" + "/".join(p): t.to(torch.float32).numpy() if t.is_floating_point()
            else t.numpy() for p, t in tree_paths(tree)}


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(np.asarray(got, np.float32) - want))) <= RANK_TOL * scale, what


@pytest.mark.parametrize("name", list(CASES))
def test_placed_steps_on_four_ranks_equal_the_unplaced_ones(name, tmp_path):
    arch, overrides, kind, n_batch = CASES[name]
    _, params, batch = _inputs(arch, overrides, kind, n_batch, np.random.default_rng(0))
    path = tmp_path / f"{name}.npz"
    np.savez(path, **_flat("params", params), **_flat("batch", batch))
    job = ("placed_step", (str(path), arch, overrides, kind, SEQ, n_batch, (2, 2),
                           ("data", "model")))
    for rank, (got,) in enumerate(_torch_ranks.start_ranks("run_jobs", 4, [job],
                                                           timeout=240.0).result()):
        for key, want in got["plain"].items():
            if isinstance(want, dict):
                for p, w in want.items():
                    _close(got["placed"][key][p], w, (rank, name, key, p))
            else:
                _close(got["placed"][key], want, (rank, name, key))
