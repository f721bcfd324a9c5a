"""Render the dry run's tables from results/dryrun_torch/*.json.

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun_torch

The port of `repro.launch.report`: the same rows give the same tables; the
section headings of `main` count ranks, one H100 each, where the
reference's count chips.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(dir_: Path):
    rows = []
    for f in sorted(dir_.glob("*.json")):
        rows.append(json.loads(f.read_text()))
    return rows


def fmt_bytes(b):
    if b >= 2**30:
        return f"{b / 2**30:.2f} GiB"
    return f"{b / 2**20:.1f} MiB"


def dryrun_table(rows, multi_pod):
    out = ["| arch | shape | status | compile s | args/dev | temp/dev | peak/dev | collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["multi_pod"] != multi_pod:
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | skipped¹ | – | – | – | – | – |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | **{r['status']}** | – | – | – | – | – |")
            continue
        m = r["memory"]
        colls = ", ".join(f"{k}×{v['count']}" for k, v in sorted(r["collectives"].items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']} | "
            f"{fmt_bytes(m['argument_bytes_per_device'])} | {fmt_bytes(m['temp_bytes_per_device'])} | "
            f"{m['peak_estimate_gib']} GiB | {colls or '—'} |")
    return "\n".join(out)


def roofline_table(rows):
    out = ["| arch | shape | flops/dev | wire/dev | compute s | memory s (lb) | collective s | bound | useful |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["multi_pod"] or r["status"] != "ok" or "roofline" not in r:
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rl['flops_per_device']:.3g} | "
            f"{rl['wire_bytes_per_device']:.3g} | {rl['compute_s']:.4f} | "
            f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
            f"**{rl['bound']}** | {rl['useful_ratio']:.1%} |")
    return "\n".join(out)


def summarize(rows):
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skipped")
    bad = [r for r in rows if r["status"] not in ("ok", "skipped")]
    lines = [f"{ok} compiled ok, {sk} skipped (per applicability rules), {len(bad)} failed."]
    for r in bad:
        lines.append(f"  FAILED: {r['arch']} {r['shape']} pod{2 if r['multi_pod'] else 1}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    rows = load(Path(args.dir))
    print("## Summary\n")
    print(summarize(rows))
    print("\n## Dry-run, single pod (16×16 = 256 ranks, one H100 each)\n")
    print(dryrun_table(rows, False))
    print("\n## Dry-run, multi-pod (2×16×16 = 512 ranks, one H100 each)\n")
    print(dryrun_table(rows, True))
    print("\n## Roofline (single pod, H100 constants; probe-corrected per-layer costs)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
