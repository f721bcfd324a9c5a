"""Condense the port's dry-run rows (`python -m repro_torch.launch.dryrun
--all`) into one line per arch and shape, and compare two runs of the
same cells.

    PYTHONPATH=src python tools/torch_dryrun_table.py results/dryrun_torch
    PYTHONPATH=src python tools/torch_dryrun_table.py RUN_A --against RUN_B

The table: each pod's status and trace seconds (`compile_s`; `probe_s`
beside it where the probes ran), its peak GiB a device, and its roofline
bound with its largest term (the probe-corrected `roofline` of a single
pod, `roofline_raw` otherwise).  `--against` lists, for every cell that
ended `ok` in both runs, whether the argument bytes a device, the flops
a device and each collective kind's wire bytes are equal, the
differences where they are not, and both runs' trace seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(dir_: str) -> dict:
    """{(arch, shape, pod): row} of a results directory."""
    rows = {}
    for f in sorted(Path(dir_).glob("*.json")):
        r = json.loads(f.read_text())
        rows[(r["arch"], r["shape"], 2 if r["multi_pod"] else 1)] = r
    return rows


def _cell(r: dict | None) -> tuple[str, str, str]:
    """(status and seconds, peak GiB, bound and its term) of one row."""
    if r is None:
        return "not run", "", ""
    if r["status"] != "ok":
        return r["status"], "", ""
    secs = f"{r['compile_s']}" + (f" + {r['probe_s']}" if "probe_s" in r else "")
    rl = r.get("roofline") or r["roofline_raw"]
    term = max(("compute_s", "memory_s", "collective_s"), key=lambda k: rl[k])
    return f"ok {secs} s", f"{r['memory']['peak_estimate_gib']}", \
        f"{rl['bound']} {rl[term] * 1e3:.1f} ms"


def table(rows: dict) -> str:
    out = ["| arch | shape | pod1 (trace s) | pod2 (trace s) | peak GiB pod1 / pod2 "
           "| bound pod1 / pod2 (largest term) |", "|---|---|---|---|---|---|"]
    archs = sorted({a for a, _, _ in rows}, key=lambda a: [k[0] for k in rows].index(a))
    for arch in archs:
        for shape in SHAPES:
            (s1, p1, b1), (s2, p2, b2) = (_cell(rows.get((arch, shape, pod))) for pod in (1, 2))
            if s1 == s2 == "not run":
                continue
            out.append(f"| {arch} | {shape} | {s1} | {s2} | {p1} / {p2} | {b1} / {b2} |")
    return "\n".join(out)


def _counts(r: dict) -> dict:
    raw = r["raw_scan_metrics"]
    return {"args": r["memory"]["argument_bytes_per_device"], "flops": raw["flops"],
            **{f"wire {k}": v["wire_bytes"] for k, v in sorted(r["collectives"].items())}}


def compare(a: dict, b: dict) -> str:
    out = ["| cell | args, flops, wire by kind | trace s (A / B) |", "|---|---|---|"]
    for key in sorted(set(a) & set(b)):
        ra, rb = a[key], b[key]
        if ra["status"] != "ok" or rb["status"] != "ok":
            continue
        ca, cb = _counts(ra), _counts(rb)
        diff = [f"{k} {ca.get(k, 0):.0f} / {cb.get(k, 0):.0f}" for k in sorted(set(ca) | set(cb))
                if ca.get(k, 0) != cb.get(k, 0)]
        out.append(f"| {key[0]} {key[1]} pod{key[2]} | {'equal' if not diff else '; '.join(diff)} "
                   f"| {ra['compile_s']} / {rb['compile_s']} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--against", help="a second results directory to compare with")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.against:
        print(compare(rows, load(args.against)))
        return
    print(table(rows))
    bad = [k for k, r in rows.items() if r["status"] not in ("ok", "skipped")]
    print(f"\n{sum(r['status'] == 'ok' for r in rows.values())} ok, "
          f"{sum(r['status'] == 'skipped' for r in rows.values())} skipped, {len(bad)} other: "
          f"{bad}", file=sys.stderr)


if __name__ == "__main__":
    main()
