"""The LM substrate's shared layers in the port (`repro_torch.models.layers`,
`ffn`) against the JAX package's on the CPU, on the same numpy inputs made
from a seed.

Tolerances: f32 norms, RoPE and FFNs within 2e-6 abs (the same f32
operations; sin / cos and rsqrt may differ by an ulp between the two
libraries); at bf16 within one bf16 ulp of the output's scale (4e-3
relative, both round the same f32 result once).  The embedding lookups:
the forward is a gather (exact); the table gradient of the 'merged' and
'windowed' routes is JAX's bit for bit (both sum each run in stream order
from zero in f32 and add once), and the 'naive' route's within 1e-6 (two
scatter-adds of the same updates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as j_ffn
from repro.models import layers as j_layers
from repro_torch.models import ffn as t_ffn
from repro_torch.models import layers as t_layers

BF16_REL = 4e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_REL * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype, rng):
    x = rng.normal(size=(2, 5, 48)) * 3 + 1
    scale, bias = rng.normal(size=48), rng.normal(size=48)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    _close(t_layers.rms_norm(_t(x, td), _t(scale, td)),
           j_layers.rms_norm(_j(x, jd), _j(scale, jd)), dtype)
    _close(t_layers.layer_norm(_t(x, td), _t(scale, td), _t(bias, td)),
           j_layers.layer_norm(_j(x, jd), _j(scale, jd), _j(bias, jd)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_variants_match_jax(dtype, rng):
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    b, s, h, hd = 2, 7, 3, 16
    x = rng.normal(size=(b, s, h, hd))
    pos = rng.integers(0, 4000, size=(b, s)).astype(np.int32)
    pos3 = rng.integers(0, 4000, size=(3, b, s)).astype(np.int32)
    # the thetas the configs use: 1e6 (qwen), 1e4 (chatglm3's 2D RoPE)
    _close(t_layers.apply_rope(_t(x, td), torch.from_numpy(pos), 1e6),
           j_layers.apply_rope(_j(x, jd), jnp.asarray(pos), 1e6), dtype)
    _close(t_layers.apply_rope_2d(_t(x, td), torch.from_numpy(pos), 1e4),
           j_layers.apply_rope_2d(_j(x, jd), jnp.asarray(pos), 1e4), dtype)
    _close(t_layers.apply_mrope(_t(x, td), torch.from_numpy(pos3), (4, 2, 2), 1e6),
           j_layers.apply_mrope(_j(x, jd), jnp.asarray(pos3), (4, 2, 2), 1e6), dtype)
    with pytest.raises(ValueError, match="sum"):
        t_layers.apply_mrope(_t(x), torch.from_numpy(pos3), (4, 2, 1))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches_jax(act, dtype, rng):
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    d, f = 32, 48
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d), "b_up": (f,), "b_down": (d,)}
    keys = ("w_gate", "w_up", "w_down") if act == "swiglu" else ("w_up", "b_up", "w_down",
                                                                  "b_down")
    p = {k: rng.normal(size=shapes[k]) * 0.2 for k in keys}
    x = rng.normal(size=(2, 5, d))
    _close(t_ffn.ffn({k: _t(v, td) for k, v in p.items()}, _t(x, td), act),
           j_ffn.ffn({k: _j(v, jd) for k, v in p.items()}, _j(x, jd), act), dtype)


@pytest.mark.parametrize("mode", ["naive", "merged", "windowed"])
@pytest.mark.parametrize("f", [1, 64])
def test_embedding_lookups_forward_and_backward_match_jax(mode, f, rng):
    vocab = 97
    table = rng.normal(size=(vocab, f)).astype(np.float32)
    # heavy duplication, and more tokens than one 4096-entry window
    ids = np.where(rng.uniform(size=(5, 1000)) < 0.5, rng.integers(0, 4, size=(5, 1000)),
                   rng.integers(0, vocab, size=(5, 1000))).astype(np.int32)
    g = (rng.normal(size=(5, 1000, f)) * 10.0 ** rng.uniform(-2, 2, size=(5, 1000, 1))
         ).astype(np.float32)
    j_lookup = j_layers.make_embed_lookup(mode)
    want_out, vjp = jax.vjp(lambda t: j_lookup(t, jnp.asarray(ids)), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_()
    out = t_layers.make_embed_lookup(mode)(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    (grad,) = torch.autograd.grad(out, tt, torch.from_numpy(g))
    if mode == "naive":
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-6 * np.abs(
            np.asarray(want_grad)).max(), rtol=0)
    else:
        np.testing.assert_array_equal(grad.numpy(), np.asarray(want_grad))
    # a bf16 table's gradient leaves in bf16, the f32 gradient cast once
    tb = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    out = t_layers.make_embed_lookup(mode)(tb, torch.from_numpy(ids))
    (gb,) = torch.autograd.grad(out, tb, torch.from_numpy(g).to(torch.bfloat16))
    assert gb.dtype == torch.bfloat16


def test_embed_lookup_modes():
    assert t_layers.make_embed_lookup(True) is not None
    with pytest.raises(ValueError, match="dedup_grad"):
        t_layers.make_embed_lookup("sorted")
