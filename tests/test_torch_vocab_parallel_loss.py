"""The next-token loss of logits split along the vocab
(`repro_torch.models.lm._vocab_parallel_nll`, the TP policy's logits) on
2 and 4 gloo ranks, against `lm._nll` and its autograd on the whole
tensor in this process.

Each rank holds its block of the (B, S, V) f32 logits, laid out by the
case's placements: the vocab alone over 2 and 4 ranks, over two mesh dims
at once (nested blocks), beside an uneven batch split (3 rows over 2) and
beside an uneven sequence split (7 positions over 2).  The targets hit
the first and the last id of every rank's vocab block.  The loss equals
`_nll(logits[:, :-1], tokens[:, 1:])` within rel 1e-6 and leaves
replicated; the logits' gradient (each rank's block, gathered) equals the
whole tensor's within rel 1e-5 of its largest magnitude.
"""
import numpy as np
import pytest
import torch

import _torch_ranks
from repro_torch.models.lm import _nll

V = 16
CASES = {   # name: (ranks, mesh shape, mesh names, placements, (B, S))
    "vocab_2": (2, (2,), ("model",), [("shard", 2)], (2, 5)),
    "vocab_4": (4, (4,), ("model",), [("shard", 2)], (2, 5)),
    "vocab_nested_4": (4, (2, 2), ("data", "model"), [("shard", 2), ("shard", 2)], (2, 5)),
    "batch_uneven_vocab_4": (4, (2, 2), ("data", "model"), [("shard", 0), ("shard", 2)], (3, 5)),
    "seq_uneven_vocab_4": (4, (2, 2), ("data", "model"), [("shard", 1), ("shard", 2)], (2, 7)),
    "replicated_vocab_4": (4, (2, 2), ("data", "model"), [("replicate", 0), ("shard", 2)], (2, 5)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case_inputs(name, rng):
    _, mesh_shape, _, placements, (b, s) = CASES[name]
    logits = (3.0 * rng.standard_normal((b, s, V))).astype(np.float32)
    blocks = int(np.prod([n for n, (kind, d) in zip(mesh_shape, placements)
                          if (kind, d) == ("shard", 2)]))
    edges = [i * (V // blocks) + j for i in range(blocks) for j in (0, V // blocks - 1)]
    tokens = rng.integers(0, V, (b, s)).astype(np.int32)
    targets = tokens[:, 1:].reshape(-1)
    assert targets.size >= len(edges)
    targets[:len(edges)] = edges                          # every block's first and last id
    tokens[:, 1:] = targets.reshape(b, s - 1)
    return logits, tokens


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """{name: each rank's result}: one spawn a world size."""
    tmp = tmp_path_factory.mktemp("vp")
    rng = np.random.default_rng(0)
    arrays, jobs = {}, {2: [], 4: []}
    for name, (n, shape, names, placements, _) in CASES.items():
        arrays[f"{name}/logits"], arrays[f"{name}/tokens"] = _case_inputs(name, rng)
        jobs[n].append((name, shape, names, placements))
    path = tmp / "inputs.npz"
    np.savez(path, **arrays)
    started = {n: _torch_ranks.start_ranks("vocab_parallel_nll", n, str(path), cases,
                                           timeout=120.0) for n, cases in jobs.items()}
    out = {name: [] for name in CASES}
    for n, ranks in started.items():
        for got in ranks.result():
            for name, r in got.items():
                out[name].append(r)
    return arrays, out


@pytest.mark.parametrize("name", list(CASES))
def test_vocab_parallel_loss_and_gradient_equal_the_whole_tensors(name, ranks_out):
    arrays, out = ranks_out
    logits = torch.from_numpy(arrays[f"{name}/logits"]).requires_grad_()
    tokens = torch.from_numpy(arrays[f"{name}/tokens"])
    want = _nll(logits[:, :-1], tokens[:, 1:])
    want.backward()
    grad = logits.grad.numpy()
    assert len(out[name]) == CASES[name][0]
    for rank, got in enumerate(out[name]):
        assert got["replicated"], rank
        np.testing.assert_allclose(got["loss"], want.detach().numpy(), rtol=1e-6, atol=0,
                                   err_msg=f"rank {rank}")
        assert np.abs(got["grad"] - grad).max() <= 1e-5 * np.abs(grad).max(), rank
