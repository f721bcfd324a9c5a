"""Mamba-1's grouped chunk scans (`ssm.SCAN_GROUP` chunks' scans as one
batch of ops) against one chunk at a time: the same bits.

A chunk's `associative_scan` does not read the carried state, so running
the scans of several chunks as one batch applies the same elementwise ops
to the same values; only the carry's combination and the output product
walk the chunks.  The output, the new state and the input's gradient of
`ssm.mamba1` at SCAN_GROUP = 1 (the chunk loop as the reference writes
it) and at the group the port runs, on sequences of whole groups, of a
partial last group and of a remainder chunk, in f32 and bf16, with and
without a carried state.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _run(cfg, params, x, state, group, monkeypatch):
    monkeypatch.setattr(ssm, "SCAN_GROUP", group)
    x = x.clone().requires_grad_()
    y, new = ssm.mamba1(params, cfg, x, state)
    (g,) = torch.autograd.grad(y.float().square().sum(), x)
    return y.detach(), new["h"].detach(), g


@pytest.mark.parametrize("n_chunks,rem,dtype,carried", [
    (8, 0, torch.float32, False),          # two whole groups
    (6, 3, torch.float32, True),           # a partial group, a remainder chunk, a state
    (5, 0, torch.bfloat16, False),
])
def test_grouped_chunk_scans_are_the_chunk_loops_bits(n_chunks, rem, dtype, carried,
                                                       monkeypatch):
    cfg = get_smoke_config("falcon-mamba-7b")
    params = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, dtype)
    rng = np.random.default_rng(0)
    seq = n_chunks * cfg.ssm.chunk + rem
    x = torch.from_numpy(rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)).to(dtype)
    state = None
    if carried:
        state = ssm.init_ssm_state(cfg, 2, dtype)
        state = {k: torch.from_numpy(0.1 * rng.standard_normal(tuple(t.shape))
                                     .astype(np.float32)).to(t.dtype) for k, t in state.items()}
    group = ssm.SCAN_GROUP
    assert group > 1
    want = _run(cfg, params, x, state, 1, monkeypatch)
    got = _run(cfg, params, x, state, group, monkeypatch)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
