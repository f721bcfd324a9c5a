"""The LM launchers' arithmetic and tables in the port
(`repro_torch.launch.{roofline,dryrun,report}`) against the JAX package on
the CPU.

* `model_flops_for` equals JAX's exactly for every arch of `list_archs()`
  and every suite of `SHAPES`; `roofline()` on the same cost / collective
  dicts: each term times the port's peak equals JAX's term times JAX's
  peak (rel 1e-12; the constants differ: the port's are an H100's), the
  bound is the argmax of the port's terms and every other field is equal;
  `_RING_FACTOR` equals JAX's on a grid of sizes and group sizes;
  `collective_stats` of recorded ops gives the `ops` dict JAX's HLO sweep
  gives for the matching HLO lines.
* `probe_variants` equals JAX's for every arch (variant configs field by
  field, coefficient rows, full counts).
* `report.dryrun_table`, `roofline_table` and `summarize` give JAX's
  strings byte for byte on the same rows (made from a numpy seed).
* One ``python -m repro_torch.launch.dryrun`` subprocess on the smallest
  production cell (qwen1.5-0.5b x decode_32k on a fake world of 256, fake
  tensors on the CPU) writes a JSON row with the reference's keys; it
  starts with the module's first test and runs beside the others.
* The embedding's table gradient on fake tensors takes its fake
  implementation: no kernel launches and no ctypes entry point is
  fetched; on real CPU tensors it is the plain commit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import shapes as j_shapes
from repro.launch import dryrun as j_dryrun
from repro.launch import report as j_report
from repro.launch import roofline as j_roof
from repro_torch.configs import get_config
from repro_torch.configs import shapes as t_shapes
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import report as t_report
from repro_torch.launch import roofline as t_roof
from repro_torch.models import layers as t_layers

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
CLI_KEYS = {"arch", "shape", "multi_pod", "policy", "status", "n_devices", "compile_s",
            "memory", "collectives", "raw_scan_metrics", "roofline_raw"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cli_cell(tmp_path_factory):
    """The dry-run CLI on the smallest production cell, started with the
    module and read by its test."""
    out = tmp_path_factory.mktemp("dryrun_cli")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1_5-0_5b",
         "--shape", "decode_32k", "--device", "cpu", "--no-probes", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# --- roofline arithmetic ---------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_for_equals_jax(arch, cli_cell):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    n_active = jcfg.active_param_count()     # JAX counts by tracing its init: once
    assert tcfg.active_param_count() == n_active
    j_counted = SimpleNamespace(active_param_count=lambda: n_active)
    for name in j_shapes.SHAPES:
        want = j_roof.model_flops_for(j_counted, j_shapes.SHAPES[name])
        assert t_roof.model_flops_for(tcfg, t_shapes.SHAPES[name]) == want, name


@pytest.mark.parametrize("seed", range(4))
def test_roofline_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        cost = {"flops": float(rng.uniform(0, 1e15)), "bytes accessed": float(rng.uniform(0, 1e12))}
        coll = {"wire_bytes_per_device": float(rng.uniform(0, 1e11))}
        n, mf, mb = int(rng.integers(1, 513)), float(rng.uniform(0, 1e17)), float(rng.uniform(0, 1e11))
        j = j_roof.roofline(cost, coll, n, mf, mb).to_dict()
        t = t_roof.roofline(cost, coll, n, mf, mb).to_dict()
        assert set(j) == set(t)
        for key, tp, jp in (("compute_s", t_roof.PEAK_FLOPS, j_roof.PEAK_FLOPS),
                            ("memory_s", t_roof.HBM_BW, j_roof.HBM_BW),
                            ("memory_upper_s", t_roof.HBM_BW, j_roof.HBM_BW),
                            ("collective_s", t_roof.LINK_BW, j_roof.ICI_BW)):
            assert t[key] * tp == pytest.approx(j[key] * jp, rel=1e-12, abs=0), key
        terms = {"compute": t["compute_s"], "memory": t["memory_s"],
                 "collective": t["collective_s"]}
        assert t["bound"] == max(terms, key=terms.get)
        for key in ("flops_per_device", "hlo_bytes_per_device", "min_bytes_per_device",
                    "wire_bytes_per_device", "model_flops", "useful_ratio"):
            assert t[key] == j[key], key


def test_ring_factors_equal_jax():
    assert set(t_roof._RING_FACTOR) == set(j_roof._RING_FACTOR)
    for kind, fn in t_roof._RING_FACTOR.items():
        for s in (0, 1, 7, 4096, 3.5e9):
            for n in (0, 1, 2, 3, 8, 16, 256, 512):
                assert fn(s, n) == j_roof._RING_FACTOR[kind](s, n), (kind, s, n)


def test_collective_stats_match_the_hlo_sweep():
    # (torch op name, result bytes, group size) and its HLO line
    ops = [
        ("all_reduce", 4096, 4, "%a = f32[1024]{0} all-reduce(%p), replica_groups=[2,4]<=[8], "
                                "to_apply=%add"),
        ("allreduce_", 96, 2, "%b = bf16[48]{0} all-reduce(%q), replica_groups={{0,1},{2,3}}, "
                              "to_apply=%add"),
        ("all_gather_into_tensor", 8192, 2, "%c = bf16[4096]{0} all-gather(%r), "
                                            "replica_groups=[4,2]<=[8], dimensions={0}"),
        ("reduce_scatter_tensor", 1024, 8, "%d = f32[256]{0} reduce-scatter(%s), "
                                           "replica_groups=[1,8]<=[8], dimensions={0}, "
                                           "to_apply=%add"),
        ("all_to_all_single", 2048, 4, "%e = s8[2048]{0} all-to-all(%t), "
                                       "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}"),
        ("alltoall_base_", 512, None, "%f = f32[128]{0} all-to-all(%u), dimensions={0}"),
        ("send", 512, None, "%g = f32[128]{0} collective-permute(%v), "
                            "source_target_pairs={{0,1},{1,0}}"),
    ]
    want = j_roof.collective_stats("\n".join(line for *_, line in ops), default_group=2)
    got = t_roof.collective_stats([(k, b, n) for k, b, n, _ in ops], default_group=2)
    assert got == want
    assert set(got["ops"]) == {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                               "collective-permute"}


# --- probes and policies -----------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_probe_variants_equal_jax(arch):
    jv, jrows, jfull = j_dryrun.probe_variants(j_get_config(arch))
    tv, trows, tfull = t_dryrun.probe_variants(get_config(arch))
    assert [dataclasses.asdict(v) for v in tv] == [dataclasses.asdict(v) for v in jv]
    assert trows == jrows and tfull == jfull


# --- report tables -------------------------------------------------------------------

def _rows(rng) -> list:
    rows = []
    for i in range(12):
        status = ["ok", "ok", "ok", "skipped", "error", "timeout"][int(rng.integers(0, 6))]
        row = {"arch": f"arch{i % 5}", "shape": ["train_4k", "decode_32k", "long_500k"][i % 3],
               "multi_pod": bool(rng.integers(0, 2)), "status": status}
        if status == "ok":
            row["compile_s"] = round(float(rng.uniform(0, 100)), 1)
            row["memory"] = {"argument_bytes_per_device": int(rng.integers(0, 1 << 36)),
                             "temp_bytes_per_device": int(rng.integers(0, 1 << 34)),
                             "peak_estimate_gib": round(float(rng.uniform(0, 90)), 3)}
            kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all"]
            row["collectives"] = {k: {"count": int(rng.integers(1, 300))}
                                  for k in kinds if rng.integers(0, 2)}
            if rng.integers(0, 3):
                row["roofline"] = {"flops_per_device": float(rng.uniform(0, 1e15)),
                                   "wire_bytes_per_device": float(rng.uniform(0, 1e11)),
                                   "compute_s": float(rng.uniform(0, 3)),
                                   "memory_s": float(rng.uniform(0, 3)),
                                   "collective_s": float(rng.uniform(0, 3)),
                                   "bound": ["compute", "memory", "collective"][i % 3],
                                   "useful_ratio": float(rng.uniform(0, 1))}
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_report_tables_equal_jax(seed, tmp_path):
    rows = _rows(np.random.default_rng(seed))
    for multi_pod in (False, True):
        assert t_report.dryrun_table(rows, multi_pod) == j_report.dryrun_table(rows, multi_pod)
    assert t_report.roofline_table(rows) == j_report.roofline_table(rows)
    assert t_report.summarize(rows) == j_report.summarize(rows)
    for i, r in enumerate(rows):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    assert t_report.load(tmp_path) == j_report.load(tmp_path) == rows
    for b in (0, 1, 2**20 - 1, 2**30 - 1, 2**30, 3 * 2**33 + 5):
        assert t_report.fmt_bytes(b) == j_report.fmt_bytes(b)


# --- the dry-run CLI ----------------------------------------------------------------

def test_dryrun_cli_writes_the_reference_keys(cli_cell):
    proc, out = cli_cell
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    row = json.loads((out / "qwen1_5-0_5b__decode_32k__pod1.json").read_text())
    assert set(row) == CLI_KEYS and row["status"] == "ok" and row["n_devices"] == 256
    assert set(row["memory"]) == {"argument_bytes_per_device", "output_bytes_per_device",
                                  "temp_bytes_per_device", "alias_bytes_per_device",
                                  "peak_estimate_gib"}
    assert set(row["roofline_raw"]) == set(j_roof.Roofline.__dataclass_fields__)
    assert row["memory"]["alias_bytes_per_device"] > 0      # the caches, updated in place
    assert row["roofline_raw"]["flops_per_device"] > 0 and row["collectives"]
    assert "compute=" in stdout


# --- no kernel on a fake tensor ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["naive", "merged", "windowed"])
def test_embedding_grad_on_fake_tensors_reaches_no_kernel(mode, monkeypatch):
    """On fake CUDA tensors the op takes its fake implementation (the CPU
    build cannot run autograd's CUDA device thread, so the lookup's
    backward runs on fake CPU tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import repro_torch.kernels as k

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was reached on a fake tensor")
    monkeypatch.setattr(k, "function", refuse)
    monkeypatch.setattr(k, "count_launch", refuse)
    before = dict(k.LAUNCHES)
    with FakeTensorMode():
        ids = torch.zeros((4, 1024), dtype=torch.int64, device="cuda")
        g = torch.empty((4, 1024, 96), dtype=torch.bfloat16, device="cuda")
        direct = t_layers.embed_table_grad(ids, g, 5000, mode)
        table = torch.empty((5000, 96), dtype=torch.bfloat16, requires_grad=True)
        out = t_layers.make_embed_lookup(mode)(table, ids.cpu())
        (grad,) = torch.autograd.grad(out.sum(), [table])
    assert tuple(direct.shape) == (5000, 96) and direct.dtype == torch.float32
    assert direct.device.type == "cuda"
    assert tuple(grad.shape) == (5000, 96) and grad.dtype == torch.bfloat16
    assert dict(k.LAUNCHES) == before


def test_embedding_grad_op_is_the_plain_commit_on_the_cpu():
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 50, (3, 40)))
    g = torch.from_numpy(rng.standard_normal((3, 40, 8)).astype(np.float32))
    naive = torch.zeros((50, 8)).index_add_(0, ids.reshape(-1), g.reshape(-1, 8))
    for mode in ("naive", "merged", "windowed"):
        got = t_layers.embed_table_grad(ids, g, 50, mode)
        assert torch.allclose(got, naive, rtol=1e-6, atol=1e-6), mode
    assert torch.equal(t_layers.embed_table_grad(ids, g, 50, "naive"), naive)


def test_fake_world_refuses_a_second_group(tmp_path):
    with t_dryrun.fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already initialised"):
            with t_dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()
