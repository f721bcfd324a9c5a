"""Trace many shallow dry-run cells at once, to try a route on a torch
version in minutes rather than the whole table's half hour.

    PYTHONPATH=src python tools/torch_dryrun_probe.py [--mini] [--prod]
        [--arch a,b] [--shape s,t] [--pods 1,2] [--policy optimized]
        [--layers N] [--attribute K] [--jobs 8] [--out probe.jsonl]
        [--redo probe.jsonl]

Each job runs in a subprocess of its own (fake tensors on the CPU) and
prints one line: status, the job, the seconds it took (process start
included) and its argument bytes a device; `--out` keeps every job's JSON
(status, seconds, argument / temp bytes, flops, wire bytes by kind, the
end of the errors).  `--prod` jobs are production cells at full width on
the production mesh (256 / 512 fake ranks), cut to the arch's deepest
`launch.dryrun.probe_variants` config (every block kind of the arch, 1-6
layers) or to `--layers` layers; `--mini` jobs are the smoke configs at
Shape("t", 32, batch, kind) on a fake (2, 2, 2) world: train and prefill
at a batch that splits the sequence (2, or 4 for the MoE archs, whose
reference `moe_ep` needs the batch to divide over ('pod', 'data')), and
train at batch 8 under the baseline policy on a (4, 2) ('data', 'model')
world.  `--redo FILE` runs again the jobs of FILE that did not end `ok`.

`--attribute K` attributes each job's peak: the K largest storages live
at it, each with its bytes, shape, dtype, the op that made it and the
innermost lines of the port's source on its stack (`dryrun.StepTrace`;
a backward op's lines are those of the call that ran the backward),
printed under the job's line and kept in `--out` (`at_peak`).  The trace
then walks the stack at every op and runs slower.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ARCHS = ("qwen1_5-0_5b", "qwen2-vl-2b", "whisper-medium", "chatglm3-6b", "qwen3-8b", "yi-9b",
         "falcon-mamba-7b", "zamba2-7b", "deepseek-v2-lite-16b", "deepseek-v3-671b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

CHILD = r'''
import dataclasses, json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.shapes import Shape, applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
kind, arch, a, b, variant, layers, attribute = sys.argv[1:7] + [int(sys.argv[7])]
t0 = time.time()
if kind == "mini":
    mesh_shape = ((2, 2, 2), ("pod", "data", "model")) if variant == "optimized" \
        else ((4, 2), ("data", "model"))
    with dryrun.fake_world(8):
        mesh = Mesh(*mesh_shape, device="cpu")
        mem, m, coll, _, trace = dryrun.trace_cell(get_smoke_config(arch),
                                                   Shape("t", 32, int(b), a), mesh, variant,
                                                   attribute)
else:
    cfg = get_config(arch)
    cfg = dryrun.probe_variants(cfg)[0][-1] if layers == "0" \
        else dataclasses.replace(cfg, n_layers=int(layers))
    with dryrun.fake_world(512 if b == "2" else 256):
        mesh = make_production_mesh(multi_pod=b == "2", device="cpu")
        mem, m, coll, _, trace = dryrun.trace_cell(cfg, a, mesh, variant, attribute)
print(json.dumps({"args": mem.argument_size_in_bytes, "temp": mem.temp_size_in_bytes,
                  "flops": m["flops"], "wire": m["wire"], "trace_s": time.time() - t0,
                  "by_kind": {k: v["wire_bytes"] for k, v in sorted(coll["ops"].items())},
                  "at_peak": trace.at_peak()}))
'''


def _run(job, timeout: int, attribute: int) -> dict:
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-c", CHILD, *job, str(attribute)],
                           capture_output=True, text=True,
                           timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))
    except subprocess.TimeoutExpired:
        return {"job": job, "status": "timeout", "s": time.time() - t0}
    if r.returncode != 0:
        return {"job": job, "status": "error", "s": time.time() - t0, "err": r.stderr[-1500:]}
    return {"job": job, "status": "ok", "s": time.time() - t0,
            **json.loads(r.stdout.strip().splitlines()[-1])}


def jobs_of(args) -> list[tuple]:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import applicable
    pick = lambda v, all_: v.split(",") if v else list(all_)  # noqa: E731
    archs, shapes, pods = pick(args.arch, ARCHS), pick(args.shape, SHAPES), pick(args.pods, "12")
    jobs = []
    if args.mini:
        for a in archs:
            b = "4" if get_config(a).moe is not None else "2"
            jobs += [("mini", a, "train", b, "optimized", "0"),
                     ("mini", a, "prefill", b, "optimized", "0"),
                     ("mini", a, "train", "8", "baseline", "0")]
    if args.prod:
        jobs += [("prod", a, s, p, args.policy, str(args.layers))
                 for a in archs for s in shapes for p in pods
                 if applicable(get_config(a), s)[0]]
    return jobs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mini", action="store_true")
    ap.add_argument("--prod", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--pods")
    ap.add_argument("--policy", default="optimized", choices=["baseline", "optimized"])
    ap.add_argument("--layers", type=int, default=0, help="0: the deepest probe variant")
    ap.add_argument("--attribute", type=int, default=0,
                    help="list the K largest storages live at each job's peak")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--out")
    ap.add_argument("--redo", help="a previous --out: its jobs that did not end ok")
    args = ap.parse_args(argv)
    if args.redo:
        with open(args.redo) as f:
            jobs = [tuple(r["job"]) for r in map(json.loads, f) if r["status"] != "ok"]
    else:
        jobs = jobs_of(args)
    import torch
    print(f"torch {torch.__version__}, {len(jobs)} jobs, {args.jobs} at once", flush=True)
    out = open(args.out, "w") if args.out else None
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for r in pool.map(lambda job: _run(job, args.timeout, args.attribute), jobs):
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
            last = (r.get("err") or "").strip().splitlines()[-1:]
            print(r["status"], " ".join(r["job"]), f"{r['s']:.1f} s", r.get("args", ""),
                  r.get("temp", ""), *last, flush=True)
            for w in r.get("at_peak", []):
                print(f"    {w['bytes']} B {w['dtype']} {w['shape']} {w['op']} <- "
                      f"{' < '.join(w['source'])}", flush=True)
    if out:
        out.close()


if __name__ == "__main__":
    main()
