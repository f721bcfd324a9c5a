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
* zamba2-7b's smoke config widened trained one step under the TP policy
  (`ssd_tp_train`): SSD's chunks and its f32 gate on each rank's block of
  the state's channels over 'model' (`ssm._scan_layout`, the reference's
  state rule), B and C read whole by every block (their gradients
  all-reduced); and falcon-mamba-7b's prefilling under it
  (`mamba1_tp_prefill`): the scan on each rank's block of di, the new state
  left in that layout; and zamba2's at 3 heads of 64, prefilling
  (`ssd_tp_prefill_odd_heads`) and trained (`ssd_tp_train_odd_heads`):
  the heads do not divide over 'model', so the scan runs on each rank's
  block of the head dims, and dt, its decay and D, read whole by each
  block, get their gradients all-reduced;
* deepseek-v3's smoke config widened as above trained at 24 tokens
  (`mtp_fsdp_train_uneven`): the MTP head's z, 23 tokens, laid out along
  the stream's sequence split in DTensor's uneven blocks (12 and 11 over
  'model'), so its block runs on each rank's own tokens: the causal mask
  at the blocks' boundary, the positions and the loss's token count;
* qwen3-8b's smoke config decoding one token under the TP policy from a
  cache split along its sequence (`attention._decode_on_shards`: each
  block's scores gathered for the softmax, its share of the output a
  partial sum): with one kv head at batch 4 (the sequence over 'model',
  as the production GQA archs whose kv heads do not divide it), and at
  batch 1 (the batch whole, the sequence over 'data' and the kv heads over
  'model', as `long_500k`'s).

The oracle and the tolerance are `test_torch_launch_ranks.py`'s, with one
exception: the SSD training cases' conv bias is held by its gradient
moment everywhere, but by its value after the step only on the entries
whose gradient a rounding cannot move past the tolerance.  It starts at
zero, so the step sets each entry to -lr g / (|g| + eps), Adam's first
update, and a gradient off by d moves it by lr d eps / (|g| + eps)^2.
With d one f32 rounding of the leaf's largest gradient (2.3e-2), that
passes RANK_TOL of lr where |g| is below ~1.6e-6: the B and C channels,
whose gradients reach the loss only through the products C.B and h.C of
two small activations (|g| 3e-9 to 8e-6), and the odd x channel whose
sum over the tokens nearly cancels (one of `ssd_tp_train`'s 1280, |g|
1.5e-7).  Those entries are printed.  All the cases run on
one four-rank world (one spawn), each test reads its case.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import make_optimizer
from test_torch_launch_ranks import RANK_TOL, SEQ, WIDE, _close, _flat, _inputs

# zamba2's smoke config at 3 heads of 64: the heads do not divide over 'model'
ODD_HEADS = {"d_model": 96, "ssm": dataclasses.replace(get_smoke_config("zamba2-7b").ssm,
                                                         headdim=64)}
CASES = {   # name: (arch, config overrides, kind, batch, policy[, seq])
    "mla_moe_prefill_seq": ("deepseek-v2-lite-16b", {}, "prefill", 2, "optimized"),
    "whisper_prefill_seq": ("whisper-medium", {}, "prefill", 2, "optimized"),
    "mamba1_tp_train": ("falcon-mamba-7b", WIDE, "train", 4, "baseline"),
    "tp_train": ("qwen3-8b", WIDE, "train", 4, "baseline"),
    "mtp_tp_train": ("deepseek-v3-671b", {}, "train", 4, "baseline"),
    "mtp_fsdp_train_seq": ("deepseek-v3-671b", {"d_model": 256}, "train", 2, "optimized"),
    "seq_tp_decode": ("qwen3-8b", {"n_kv_heads": 1}, "decode", 4, "optimized"),
    "long_tp_decode": ("qwen3-8b", {}, "decode", 1, "optimized"),
    "ssd_tp_train": ("zamba2-7b", WIDE, "train", 4, "baseline"),
    "mamba1_tp_prefill": ("falcon-mamba-7b", {}, "prefill", 4, "baseline"),
    "mtp_fsdp_train_uneven": ("deepseek-v3-671b", {"d_model": 256}, "train", 2, "optimized", 24),
    "ssd_tp_prefill_odd_heads": ("zamba2-7b", ODD_HEADS, "prefill", 4, "baseline"),
    "ssd_tp_train_odd_heads": ("zamba2-7b", ODD_HEADS, "train", 4, "baseline"),
}
# zero-initialised leaves whose value after the step is held only where a
# rounding of the gradient cannot move it past the tolerance (see above)
ROUNDING = {name: "seg0_mamba2/ssm/conv_b" for name in ("ssd_tp_train", "ssd_tp_train_odd_heads")}


def _rounding_level(m, opt):
    """The entries of a zero-initialised leaf, of first moment `m` after
    one step of `opt`, whose value one f32 rounding of the leaf's largest
    gradient moves by more than RANK_TOL of the step's size."""
    g = np.abs(m) / (1 - opt.b1)
    d = np.finfo(np.float32).eps * g.max()
    return d * opt.eps / (g + opt.eps) ** 2 > RANK_TOL


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case's placed and plain results, per rank: [{name: ...}]."""
    tmp = tmp_path_factory.mktemp("seq")
    jobs = []
    for name, (arch, overrides, kind, n_batch, policy, *seq) in CASES.items():
        seq = seq[0] if seq else SEQ
        _, params, batch = _inputs(arch, overrides, kind, n_batch, np.random.default_rng(0), seq)
        path = tmp / f"{name}.npz"
        np.savez(path, **_flat("params", params), **_flat("batch", batch))
        jobs.append(("placed_step", (str(path), arch, overrides, kind, seq, n_batch, (2, 2),
                                     ("data", "model"), policy)))
    return [dict(zip(CASES, got)) for got in
            _torch_ranks.start_ranks("run_jobs", 4, jobs, timeout=360.0).result()]


@pytest.mark.parametrize("name", list(CASES))
def test_placed_steps_split_along_the_sequence_equal_the_unplaced_ones(name, ranks_out):
    for rank, out in enumerate(ranks_out):
        got = out[name]
        for key, want in got["plain"].items():
            if isinstance(want, dict):
                assert set(got["placed"][key]) == set(want), (rank, name, key)
                for p, w in want.items():
                    held = np.ones(np.shape(w), bool)
                    if key == "params" and p == ROUNDING.get(name):
                        held = ~_rounding_level(got["plain"]["m"][p], make_optimizer(None))
                        if rank == 0:
                            print(name, p, "value unheld at", np.argwhere(~held).tolist())
                        assert held.mean() > 0.5, (rank, name, p)
                    _close(np.asarray(got["placed"][key][p])[held], np.asarray(w)[held],
                           (rank, name, key, p))
            else:
                _close(got["placed"][key], want, (rank, name, key))
