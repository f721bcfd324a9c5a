"""The placed steps of the port's `launch.steps` on four gloo ranks where
the residual stream splits along its sequence, and under the TP policy's
training, against the same steps unplaced on the same mesh.

On a ('data', 'model') = (2, 2) mesh, batch 2 puts the batch on 'data'
and the sequence on 'model' under the FSDP-pure policy (the reference's
`_act_spec`), so each block's per-token work runs on each rank's own
tokens (`shards.tokens`: the projections, norms and FFN on the local
(B, S) block, attention's keys and values gathered along the sequence,
the loss on the local positions):

* deepseek-v2-lite's smoke config prefilling 2 x 16 tokens: MLA's
  projections and its latent cache, the MoE layers' shared experts on
  the local tokens beside `moe_ep`'s routed ones, the last token's logits
  from the block that holds it;
* whisper-medium's prefilling 2 x 16 tokens over 2 x 32 frames: the
  encoder's frames split along their sequence too, so its self-attention
  and the decoder's cross-attention keys and values run on each rank's
  frames and are gathered for the queries;
* falcon-mamba-7b's smoke config widened (as the rank file's) trained one
  step under the baseline (TP) policy, batch 4: its projections split
  over 'model' (in_proj column-parallel, out_proj row-parallel), so the
  column-parallel `Ranks.mm`'s activation gradient is a partial sum over
  'model' (Megatron's f), and the params gathered over 'data' (FSDP);
  qwen3-8b's likewise, its attention heads over 'model' and their output
  projected on each rank's heads (`attention._out_proj`, Megatron's g);
  both score their logits, split along the vocab over 'model', on each
  rank's vocab block (`lm._vocab_parallel_nll`), as does deepseek-v3's
  smoke config trained likewise at batch 4, its multi-token-prediction
  head's loss too;
* deepseek-v3's smoke config widened (d_model 256, so the MTP head's
  projection splits over the FSDP axes along its contracted dim) trained
  one step under the FSDP-pure policy at batch 2: the main stack's stream
  split along its sequence, the MTP head's block on each rank's batch rows
  with its projection gathered (`LM._mtp_loss`);
* qwen3-8b's smoke config decoding one token under the TP policy from a
  cache split along its sequence (`attention._decode_on_shards`: each
  block's scores gathered for the softmax, its share of the output a
  partial sum): with one kv head at batch 4 (the sequence over 'model',
  as the production GQA archs whose kv heads do not divide it), and at
  batch 1 (the batch whole, the sequence over 'data' and the kv heads over
  'model', as `long_500k`'s).

The oracle and the tolerance are `test_torch_launch_ranks.py`'s. All
the cases run on one four-rank world (one spawn), each test reads its
case.
"""
import numpy as np
import pytest
import torch

import _torch_ranks
from test_torch_launch_ranks import SEQ, WIDE, _close, _flat, _inputs

CASES = {   # name: (arch, config overrides, kind, batch, policy)
    "mla_moe_prefill_seq": ("deepseek-v2-lite-16b", {}, "prefill", 2, "optimized"),
    "whisper_prefill_seq": ("whisper-medium", {}, "prefill", 2, "optimized"),
    "mamba1_tp_train": ("falcon-mamba-7b", WIDE, "train", 4, "baseline"),
    "tp_train": ("qwen3-8b", WIDE, "train", 4, "baseline"),
    "mtp_tp_train": ("deepseek-v3-671b", {}, "train", 4, "baseline"),
    "mtp_fsdp_train_seq": ("deepseek-v3-671b", {"d_model": 256}, "train", 2, "optimized"),
    "seq_tp_decode": ("qwen3-8b", {"n_kv_heads": 1}, "decode", 4, "optimized"),
    "long_tp_decode": ("qwen3-8b", {}, "decode", 1, "optimized"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case's placed and plain results, per rank: [{name: ...}]."""
    tmp = tmp_path_factory.mktemp("seq")
    jobs = []
    for name, (arch, overrides, kind, n_batch, policy) in CASES.items():
        _, params, batch = _inputs(arch, overrides, kind, n_batch, np.random.default_rng(0))
        path = tmp / f"{name}.npz"
        np.savez(path, **_flat("params", params), **_flat("batch", batch))
        jobs.append(("placed_step", (str(path), arch, overrides, kind, SEQ, n_batch, (2, 2),
                                     ("data", "model"), policy)))
    return [dict(zip(CASES, got)) for got in
            _torch_ranks.start_ranks("run_jobs", 4, jobs, timeout=240.0).result()]


@pytest.mark.parametrize("name", list(CASES))
def test_placed_steps_split_along_the_sequence_equal_the_unplaced_ones(name, ranks_out):
    for rank, out in enumerate(ranks_out):
        got = out[name]
        for key, want in got["plain"].items():
            if isinstance(want, dict):
                assert set(got["placed"][key]) == set(want), (rank, name, key)
                for p, w in want.items():
                    _close(got["placed"][key][p], w, (rank, name, key, p))
            else:
                _close(got["placed"][key], want, (rank, name, key))
