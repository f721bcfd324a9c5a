"""The parallel substrate in the port (`repro_torch.parallel`,
`repro_torch.launch.mesh`) against the JAX package on the CPU.

Specs: for every arch of `list_archs()` at its full config, `param_specs`
of the port's meta-device params equals JAX's of `init_abstract()` leaf for
leaf, exactly (path and entries), under `ShardingPolicy()`,
`ShardingPolicy(tp=True, fsdp=True)` and `FSDP_PURE`, on abstract meshes
(1, 2), (1, 8), (2, 2, 2), (16, 16) and (2, 16, 16); `batch_specs` likewise
on the train, prefill and decode inputs of `configs/shapes.py` (every suite
that applies, caches included).

Placements: on a 2 x 2 mesh of four gloo ranks, each rank's local shard of
a sample of smoke-config leaves (heads, FFN, vocab, experts, experts with
an FSDP dim, a vocab dim over ('data', 'model')), through `param_specs` ->
`to_named` -> `distribute_tensor`, equals the numpy slice JAX's
`NamedSharding(...).devices_indices_map` gives the device at that mesh
position; `to_named` raises on an axis tuple out of mesh order.

Collectives: `_quantize`'s int8 output and scale are JAX's bit for bit;
`compressed_psum_mean` on 2 and 4 gloo ranks against JAX's under
`shard_map` on 2 / 4 host devices: both int8 payloads of every rank (the
chunks sent and the reduced chunk gathered) bit for bit, the first scale
bit for bit and the reduced chunk's within one ulp, the mean and the new
error within `SYNC_TOL`.  XLA contracts g' - q * scale and the dequant-sum
into fused multiply-adds as its fusion decides (the probe that records
JAX's payloads moves that decision), where the port rounds each product:
up to one ulp seen;
the reference test's 50-step error-feedback loop on 4 ranks (each its own
gradient) within its 0.01.  The JAX side runs in a subprocess with four
host devices (the suite itself still sees one), the port's on gloo ranks
(`_torch_ranks`), at the same time.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import shapes as j_shapes
from repro.models.lm import LM as JLM
from repro.parallel import collectives as j_col
from repro.parallel import sharding as j_shd
from repro_torch.configs import get_config, get_smoke_config, shapes as t_shapes
from repro_torch.launch import mesh as t_mesh
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import tree_paths
from repro_torch.parallel import collectives as t_col
from repro_torch.parallel import sharding as t_shd

SYNC_TOL = 5e-7          # two f32 ulps at these magnitudes (|g| < 4)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = [((1, 2), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
POLICIES = {"tp": (j_shd.ShardingPolicy(), t_shd.ShardingPolicy()),
            "tp_fsdp": (j_shd.ShardingPolicy(tp=True, fsdp=True),
                        t_shd.ShardingPolicy(tp=True, fsdp=True)),
            "fsdp_pure": (j_shd.FSDP_PURE, t_shd.FSDP_PURE)}
# (key, arch, policy, path) on a 2 x 2 ('data', 'model') mesh
SAMPLES = [("heads", "qwen3-8b", "tp", "seg0_attn_dense/attn/wq"),
           ("ffn", "qwen3-8b", "tp", "seg0_attn_dense/ffn/w_gate"),
           ("vocab", "qwen3-8b", "tp", "embed"),
           ("experts", "deepseek-v2-lite-16b", "tp", "seg1_mla_moe/moe/w_gate"),
           ("experts_fsdp", "deepseek-v2-lite-16b", "tp_fsdp", "seg1_mla_moe/moe/w_down"),
           ("vocab_two_axes", "qwen3-8b", "fsdp_pure", "lm_head")]
SYNC_SIZE = 1001          # padded to a multiple of 2 and of 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _j_flat(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    # a dict key, or a NamedTuple field (JAX's SSM state; the port's is a dict)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(s)
            for path, s in leaves}


def _t_flat(specs) -> dict:
    return {"/".join(p): tuple(s) for p, s in tree_paths(specs)}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    j_params, t_params = JLM(jcfg).init_abstract(), LM(tcfg, device="meta").init(None)
    for shape, names in MESHES:
        j_mesh, t_mesh_ = jax.sharding.AbstractMesh(shape, names), t_mesh.AbstractMesh(shape, names)
        for name, (j_pol, t_pol) in POLICIES.items():
            want = _j_flat(j_shd.param_specs(jcfg, j_params, j_mesh, j_pol))
            got = _t_flat(t_shd.param_specs(tcfg, t_params, t_mesh_, t_pol))
            assert got == want, (shape, name)
            assert any(any(e is not None for e in s) for s in got.values()) or shape == (1, 2)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_equal_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for suite in j_shapes.SHAPES:
        if not j_shapes.applicable(jcfg, suite)[0]:
            continue
        j_batch = j_shapes.input_specs(jcfg, j_shapes.SHAPES[suite])
        t_batch = t_shapes.input_specs(tcfg, t_shapes.SHAPES[suite])
        for shape, names in MESHES:
            j_mesh = jax.sharding.AbstractMesh(shape, names)
            t_mesh_ = t_mesh.AbstractMesh(shape, names)
            for name, (j_pol, t_pol) in POLICIES.items():
                want = _j_flat(j_shd.batch_specs(jcfg, j_batch, j_mesh, j_pol))
                got = _t_flat(t_shd.batch_specs(tcfg, t_batch, t_mesh_, t_pol))
                assert got == want, (suite, shape, name)
            assert tuple(t_shd.activation_spec(t_mesh_, t_pol)) == \
                tuple(j_shd.activation_spec(j_mesh, j_pol))


def test_to_named_placements_and_axis_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = t_mesh.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    named = t_shd.to_named({"a": t_shd.P(None, "model"), "b": {"c": t_shd.P(("pod", "data"))},
                            "d": t_shd.P()}, mesh)
    assert named["a"] == (Replicate(), Replicate(), Shard(1))
    assert named["b"]["c"] == (Shard(0), Shard(0), Replicate())
    assert named["d"] == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        t_shd.to_named({"a": t_shd.P(("model", "data"))}, mesh)


def test_meshes_without_a_world():
    host = t_mesh.make_host_mesh(model=2, data=2, device="cpu")   # more than the world
    assert host.shape == {"data": 1, "model": 1} and host.group(("data", "model")) is None
    assert host.coordinate() == {"data": 0, "model": 0} and host.index(("data", "model")) == 0
    with pytest.raises(ValueError, match="256"):
        t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        t_mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="launch 4 processes"):
        t_mesh.Mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="mesh order"):
        host.group(("model", "data"))
    assert t_mesh.session_mesh().shape == {"session": torch.cuda.device_count()}


def test_quantize_matches_jax(rng):
    for g in (rng.normal(size=(1000,)).astype(np.float32),
              np.linspace(-1, 1, 64, dtype=np.float32),             # exact halves round to even
              np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)):
        q, s = t_col._quantize(torch.from_numpy(g))
        jq, js = jax.jit(j_col._quantize)(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        deq = t_col._dequantize(q, s).numpy()
        assert np.array_equal(deq, np.asarray(j_col._dequantize(jq, js)))


_JAX_SIDE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.models.lm import LM
    from repro.parallel import collectives as col, sharding as shd

    auto = jax.sharding.AxisType.Auto
    policies = {{"tp": shd.ShardingPolicy(), "tp_fsdp": shd.ShardingPolicy(tp=True, fsdp=True),
                "fsdp_pure": shd.FSDP_PURE}}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
    slices = {{}}
    for key, arch, policy, path in json.loads({samples!r}):
        cfg = get_smoke_config(arch)
        abstract = LM(cfg).init_abstract()
        spec, leaf = shd.param_specs(cfg, abstract, mesh, policies[policy]), abstract
        for k in path.split("/"):
            spec, leaf = spec[k], leaf[k]
        index = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
        slices[key] = [[list(s.indices(n))[:2] for s, n in zip(index[d], leaf.shape)]
                       for d in mesh.devices.flat]

    flat = dict(np.load({inputs!r}))
    out = {{}}
    orig, rec = col._quantize, {{}}
    def tap(g):
        q, s = orig(g)
        jax.debug.callback(lambda i, q, s: rec.setdefault(int(i), []).append(
            (np.asarray(q), np.asarray(s))), jax.lax.axis_index("pod"), q, s)
        return q, s
    col._quantize = tap
    for n in (2, 4):
        m = jax.make_mesh((n,), ("pod",), axis_types=(auto,), devices=jax.devices()[:n])
        fn = jax.shard_map(
            lambda gg, ee: tuple(t[None] for t in col.compressed_psum_mean(gg[0], ee[0], "pod")),
            mesh=m, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
            check_vma=False)
        rec.clear()
        mean, err = jax.jit(fn)(jnp.asarray(flat["g%d" % n]), jnp.asarray(flat["e%d" % n]))
        jax.effects_barrier()
        out["mean%d" % n], out["err%d" % n] = np.asarray(mean), np.asarray(err)
        for r in range(n):
            big, small = sorted(rec[r], key=lambda qs: -qs[0].size)
            out["q%d_%d" % (n, r)], out["s%d_%d" % (n, r)] = big
            out["q2%d_%d" % (n, r)], out["s2%d_%d" % (n, r)] = small
    np.savez({out!r}, **out)
    print(json.dumps(slices))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    flat = {}
    for n in (2, 4):
        flat[f"g{n}"] = rng.normal(size=(n, SYNC_SIZE)).astype(np.float32)
        flat[f"e{n}"] = (rng.normal(size=(n, SYNC_SIZE)) * 0.01).astype(np.float32)
    inputs, out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    np.savez(inputs, **flat)
    script = _JAX_SIDE.format(src=SRC, samples=json.dumps(SAMPLES), inputs=inputs, out=out)
    jax_side = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    four = _torch_ranks.start_ranks("run_jobs", 4, [
        ("to_named_shards", (SAMPLES, (2, 2))), ("psum_payloads", (inputs, 4)),
        ("error_feedback_steps", (50,))])
    two = _torch_ranks.start_ranks("psum_payloads", 2, inputs, 2)
    four_res, two_res = four.result(), two.result()
    stdout, stderr = jax_side.communicate(timeout=300)
    assert jax_side.returncode == 0, stderr[-3000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return {"slices": json.loads(stdout.strip().splitlines()[-1]), "jax": want,
            "named": [r[0] for r in four_res], "psum": {4: [r[1] for r in four_res], 2: two_res},
            "feedback": [r[2] for r in four_res]}


@pytest.mark.parametrize("sample", SAMPLES, ids=[s[0] for s in SAMPLES])
def test_to_named_local_shards_match_jax_device_slices(ranks, sample):
    key, arch, _, path = sample
    slices = ranks["slices"][key]
    assert len(slices) == len(ranks["named"]) == 4
    shape = tuple(dict(tree_paths(LM(get_smoke_config(arch), device="meta").init(None)))[
        tuple(path.split("/"))].shape)
    full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    sharded = False
    for rank, got in enumerate(ranks["named"]):
        want = full[tuple(slice(lo, hi) for lo, hi in slices[rank])]
        assert np.array_equal(got[key]["local"], want), (key, rank, got[key]["placements"])
        sharded |= want.shape != full.shape
    assert sharded


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_mean_matches_jax(ranks, n):
    want = ranks["jax"]
    for r, got in enumerate(ranks["psum"][n]):
        (q, s), (q2, s2) = got["q"], got["q2"]
        assert q.dtype == np.int8 and np.array_equal(q, want[f"q{n}_{r}"])
        assert np.array_equal(q2, want[f"q2{n}_{r}"])
        assert s.tobytes() == want[f"s{n}_{r}"].tobytes()
        np.testing.assert_allclose(s2, want[f"s2{n}_{r}"], rtol=1.2e-7, atol=0)   # one ulp
        np.testing.assert_allclose(got["mean"], want[f"mean{n}"][r], rtol=0, atol=SYNC_TOL)
        np.testing.assert_allclose(got["err"], want[f"err{n}"][r], rtol=0, atol=SYNC_TOL)
        assert got["tree_ok"]
    means = [got["mean"] for got in ranks["psum"][n]]
    assert all(np.array_equal(m, means[0]) for m in means)


def test_error_feedback_converges_on_four_ranks(ranks):
    rels = ranks["feedback"]
    assert len(rels) == 4 and len(set(rels)) == 1
    assert rels[0] < 0.01, rels
