"""Multi-rank helpers of the port's CPU tests.

`start_ranks(fn_name, n, *args)` runs `fn_name` (a function of this
module) on n gloo ranks: spawned by `torch.multiprocessing`, joined through
one `FileStore` in a temporary directory, one thread each.  `.result()`
waits (under a timeout, killing the ranks when it passes) and returns each
rank's return value in rank order.  This module imports no JAX: every rank
is a port process.  Inputs cross as ``.npz`` files written by the test.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank, n, store_path, out_dir, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n)
    try:
        result = globals()[fn_name](rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


class Ranks:
    def __init__(self, fn_name: str, n: int, args: tuple, timeout: float):
        self._tmp = tempfile.TemporaryDirectory()
        self.n, self.fn_name, self.deadline = n, fn_name, time.monotonic() + timeout
        self._ctx = mp.start_processes(
            _child, args=(n, os.path.join(self._tmp.name, "store"), self._tmp.name, fn_name,
                          args), nprocs=n, join=False, start_method="spawn")

    def result(self) -> list:
        try:
            while not self._ctx.join(timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() > self.deadline:
                    for p in self._ctx.processes:
                        p.kill()
                    raise TimeoutError(f"{self.fn_name} on {self.n} ranks timed out")
            out = []
            for r in range(self.n):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._tmp.cleanup()


def start_ranks(fn_name: str, n: int, *args, timeout: float = 180.0) -> Ranks:
    return Ranks(fn_name, n, args, timeout)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict of torch tensors under `prefix/` in a flat npz dict."""
    from repro_torch.optim.adamw import tree_from_paths
    return tree_from_paths([(tuple(k[len(prefix) + 1:].split("/")), torch.from_numpy(v))
                            for k, v in flat.items() if k.startswith(prefix + "/")])


def run_jobs(rank, jobs: list) -> list:
    """Several (function name, args) jobs in order on one world."""
    return [globals()[fn](rank, *args) for fn, args in jobs]


# ---- moe_ep and the LM on a mesh (tests/test_torch_lm_ep.py) -------------------

def moe_cases(rank, inputs: str, cases: list, cfg_name: str = "deepseek-v2-lite-16b"):
    """Each case (name, mesh shape, ep_axes, capacity factor, decode) on this
    rank: moe_ep's output, the gradients of sum(y * w) with respect to x and
    every param, and the kept assignments."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_from_paths, tree_paths

    flat = _load(inputs)
    cfg = get_smoke_config(cfg_name)
    out = {}
    for name, shape, ep, cf, decode in cases:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ep_axes=tuple(ep)))
        mesh = Mesh(shape, ("data", "model"), "cpu")
        params = tree_from_paths([(p, t.clone().requires_grad_())
                                  for p, t in tree_paths(_tree(flat, "p"))])
        x = torch.from_numpy(flat["x"][:, :1] if decode else flat["x"]).requires_grad_()
        w = torch.from_numpy(flat["w"][:, :1] if decode else flat["w"])
        with moe.record_drops() as drops:
            y = moe.moe_ep(params, x, c, mesh, capacity_factor=cf)
        leaves = [t for _, t in tree_paths(params)]
        grads = torch.autograd.grad((y * w).sum(), [x] + leaves, allow_unused=True,
                                    materialize_grads=True)
        out[name] = {"y": _np(y), "kept": _np(drops[0]), "dx": _np(grads[0]),
                     "grads": {"/".join(p): _np(g)
                               for (p, _), g in zip(tree_paths(params), grads[1:])}}
    return out


def moe_layer_vs_moe_ep(rank, inputs: str, n_shared_values: tuple):
    """On a ('data', 'model') = (1, 2) mesh: moe_layer's output and moe_ep's,
    for each n_shared."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    flat = _load(inputs)
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    mesh = make_host_mesh(model=2, device="cpu")
    out = {}
    for n_shared in n_shared_values:
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=n_shared))
        params = _tree(flat, f"p{n_shared}")
        x = torch.from_numpy(flat["x"])
        out[n_shared] = {"layer": _np(moe.moe_layer(params, x, c, mesh)),
                         "ep": _np(moe.moe_ep(params, x, c, mesh)), "mesh": dict(mesh.shape)}
    return out


def lm_loss_and_grads(rank, inputs: str, arch: str, model_axis: int):
    """LM(cfg, mesh=make_host_mesh(model=model_axis)): the loss of a token
    batch and every gradient, with the MoE layers' kept assignments."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_paths

    flat = _load(inputs)
    mesh = make_host_mesh(model=model_axis, device="cpu")
    model = LM(get_smoke_config(arch), mesh=mesh, device="cpu")
    with moe.record_drops() as drops:
        loss, grads = loss_and_grads(model, _tree(flat, "lm"),
                                     {"tokens": torch.from_numpy(flat["tokens"])})
    return {"loss": float(loss), "mesh": dict(mesh.shape), "dropped": [int((~d).sum())
                                                                        for d in drops],
            "grads": {"/".join(p): _np(g) for p, g in tree_paths(grads)}}


# ---- partition placements and the compressed sync (tests/test_torch_parallel.py) --

def to_named_shards(rank, samples: list, mesh_shape: tuple) -> dict:
    """Each sample (key, arch, policy name, path) on a ('data', 'model')
    mesh: this rank's local shard of the leaf (values arange(size)), through
    `param_specs` -> `to_named` -> `distribute_tensor`."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_paths
    from repro_torch.parallel import sharding as shd

    policies = {"tp": shd.ShardingPolicy(), "tp_fsdp": shd.ShardingPolicy(tp=True, fsdp=True),
                "fsdp_pure": shd.FSDP_PURE}
    mesh = Mesh(mesh_shape, ("data", "model"), "cpu")
    out = {}
    for key, arch, policy, path in samples:
        cfg = get_smoke_config(arch)
        abstract = dict(tree_paths(LM(cfg, device="meta").init(None)))
        placements = dict(tree_paths(shd.to_named(
            shd.param_specs(cfg, LM(cfg, device="meta").init(None), mesh, policies[policy]),
            mesh)))[tuple(path.split("/"))]
        shape = tuple(abstract[tuple(path.split("/"))].shape)
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        out[key] = {"local": distribute_tensor(full, mesh.device_mesh, placements).to_local()
                    .numpy(), "placements": [str(p) for p in placements]}
    return out


def psum_payloads(rank, inputs: str, n: int) -> dict:
    """`compressed_psum_mean` of this rank's row of g{n} / e{n} over a
    ('pod',) mesh of n ranks, with the int8 payloads it quantized (the sent
    chunks, then the reduced chunk) and their scales; and the same through
    `compressed_grad_sync` on a two-leaf tree."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives as col

    flat = _load(inputs)
    g, e = torch.from_numpy(flat[f"g{n}"][rank]), torch.from_numpy(flat[f"e{n}"][rank])
    mesh = Mesh((n,), ("pod",), "cpu")
    rec, orig = [], col._quantize

    def tap(t):
        q, s = orig(t)
        rec.append((q.numpy().copy(), s.numpy().copy()))
        return q, s

    col._quantize = tap
    try:
        mean, err = col.compressed_psum_mean(g, e, mesh.group(("pod",)))
    finally:
        col._quantize = orig
    half = g.shape[0] // 2
    tg, te = col.compressed_grad_sync({"a": g[:half], "b": {"c": g[half:]}},
                                      {"a": e[:half], "b": {"c": e[half:]}}, mesh)
    ta, tb = col.compressed_psum_mean(g[:half], e[:half], mesh.group("pod")), \
        col.compressed_psum_mean(g[half:], e[half:], mesh.group("pod"))
    tree_ok = all(torch.equal(x, y) for x, y in
                  ((tg["a"], ta[0]), (te["a"], ta[1]), (tg["b"]["c"], tb[0]), (te["b"]["c"], tb[1])))
    return {"mean": mean.numpy(), "err": err.numpy(), "q": rec[0], "q2": rec[1],
            "tree_ok": tree_ok}


def error_feedback_steps(rank, steps: int) -> float:
    """The reference test's error-feedback loop over a ('pod',) mesh of the
    whole world, each rank its own g: the relative distance of the summed
    compressed means from the summed exact means after `steps` steps."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import collectives as col

    n = dist.get_world_size()
    mesh = Mesh((n,), ("pod",), "cpu")
    base = torch.linspace(-1, 1, 64)
    g = base * (1 + rank)
    exact_mean = base * (1 + (n - 1) / 2)
    err = torch.zeros_like(g)
    total, exact = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(steps):
        out, err = col.compressed_psum_mean(g, err, mesh.group("pod"))
        total, exact = total + out, exact + exact_mean
    return float(torch.linalg.norm(total - exact) / torch.linalg.norm(exact))


# ---- the placed steps of launch.steps (tests/test_torch_launch_ranks.py) --------

def placed_step(rank, inputs: str, arch: str, overrides: dict, kind: str, seq: int,
                batch: int, mesh_shape: tuple, names: tuple, variant: str = "optimized") -> dict:
    """`launch.steps`' step of `kind` under the policy `variant` on a mesh
    over the whole world, its params and batch placed as DTensors, and the
    same step unplaced on the same mesh (every rank the whole params and
    batch, the port's SPMD convention: `LM(cfg, mesh)` as the training CLI
    runs it): the loss, the whole params and moments after one step
    (train), the last token's logits and the caches (prefill), or the
    logits and the new caches (decode), of both."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_paths

    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    mesh = Mesh(mesh_shape, names, "cpu")
    (fn, _), _, _ = steps.build_step_cfg(cfg, Shape("t", seq, batch, kind), mesh, variant)
    opt = steps.make_optimizer(cfg)
    model = LM(cfg, mesh=mesh, device="cpu")
    whole = lambda tree: {"/".join(p): _np(getattr(t, "full_tensor", lambda: t)())  # noqa: E731
                          for p, t in tree_paths(tree)}
    out = {}
    for route in ("placed", "plain"):
        flat = _load(inputs)      # afresh: the placed step updates its arguments in place
        params, b = _tree(flat, "params"), _tree(flat, "batch")
        if kind == "train":
            if route == "placed":
                new_p, state, loss = fn(params, opt.init(params), b)
                loss = loss.full_tensor()
            else:
                new_p, state, loss = train.train_step(model, opt, params, opt.init(params), b)
            out[route] = {"loss": _np(loss), "params": whole(new_p), "m": whole(state.m)}
        elif route == "placed":
            logits, caches = fn(params, b)
            out[route] = {"logits": _np(logits.full_tensor()), "caches": whole(caches)}
        elif kind == "prefill":
            with torch.no_grad():
                logits, caches, _ = model.prefill(params, tokens=b.get("tokens"),
                                                  embeds=b.get("embeds"),
                                                  positions=b.get("positions"),
                                                  encoder_embeds=b.get("encoder_embeds"))
            out[route] = {"logits": _np(logits), "caches": whole(caches)}
        else:
            with torch.no_grad():
                logits, caches = model.decode_step(params, b["caches"], b["tokens"], b["pos"])
            out[route] = {"logits": _np(logits), "caches": whole(caches)}
    return out


# ---- the vocab-parallel loss (tests/test_torch_vocab_parallel_loss.py) ----------

def vocab_parallel_nll(rank, inputs: str, cases: list) -> dict:
    """Each case (name, mesh shape, mesh names, placements as (kind, dim)
    pairs) on this rank: `lm._next_token_nll` of the logits of `inputs`
    laid out by the placements as a DTensor, and the whole gradient of the
    loss with respect to them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import _next_token_nll

    flat = _load(inputs)
    out = {}
    for name, mesh_shape, names, placements in cases:
        mesh = Mesh(mesh_shape, names, "cpu")
        pl = [Shard(d) if kind == "shard" else Replicate() for kind, d in placements]
        logits = distribute_tensor(torch.from_numpy(flat[f"{name}/logits"]), mesh.device_mesh,
                                   pl).requires_grad_()
        loss = _next_token_nll(logits, torch.from_numpy(flat[f"{name}/tokens"]))
        loss.backward()
        out[name] = {"loss": _np(loss.full_tensor()), "grad": _np(logits.grad.full_tensor()),
                     "replicated": all(p.is_replicate() for p in loss.placements)}
    return out
