"""Render the dry run's tables (roofline and summary) from results/dryrun JSON.

The counterpart of ``src/repro/analysis/report.py``, over the records of
``repro_torch.launch.dryrun``: the roofline is the H100's, the FLOPs column
is FlopCounterMode's count of one rank's step, and the keys the port leaves
null (``lower_s``, ``compile_s``, ``bytes accessed``) print as a dash.

  PYTHONPATH=src python -m repro_torch.analysis.report [results/dryrun]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def load(out_dir="results/dryrun"):
    recs = []
    for f in sorted(Path(out_dir).glob("*.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def fmt_s(x):
    if x is None:
        return "—"
    if x == 0:
        return "0"
    return f"{x:.2e}"


def roofline_table(recs, multi_pod=False) -> str:
    rows = [
        "| arch | shape | dom | compute s | memory s | collective s | IB GB | "
        "MODEL_TF | useful | MFU-bound | mem GB | fits 16GB | fits 80GB |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("multi_pod") != multi_pod:
            continue
        if r.get("skipped"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | SKIP | — | — | — | — | — | — | — | — | — | — |")
            continue
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | | | | |")
            continue
        rf = r["roofline"]
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['dominant']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"{rf['dcn_bytes_per_dev']/1e9:.2f} | {rf['model_flops']/1e12:.0f} | "
            f"{rf['hlo_useful_ratio']:.2f} | {rf['mfu']:.2f} | "
            f"{m['per_device_total']/1e9:.1f} | {'Y' if m['fits_16GB'] else 'N'} | "
            f"{'Y' if m['fits_device'] else 'N'} |")
    return "\n".join(rows)


def dryrun_summary(recs) -> str:
    ok = sum(1 for r in recs if not r.get("skipped") and "error" not in r)
    skip = sum(1 for r in recs if r.get("skipped"))
    err = sum(1 for r in recs if "error" in r)
    lines = [f"priced OK: {ok}, skipped (recorded): {skip}, failed: {err}", ""]
    lines.append("| arch | shape | mesh | count s | counted flops/dev | bytes/dev | "
                 "coll ops |")
    lines.append("|---|---|---|---|---|---|---|")
    for r in recs:
        if r.get("skipped") or "error" in r:
            continue
        mesh = "2x16x16" if r["multi_pod"] else "16x16"
        ca = r.get("cost_analysis", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | {r['count_s']} | "
            f"{fmt_s(ca.get('flops'))} | {fmt_s(ca.get('bytes accessed'))} | "
            f"{r['roofline']['coll_bytes_per_dev']/1e9:.2f} GB |")
    return "\n".join(lines)


if __name__ == "__main__":
    recs = load(*sys.argv[1:2])
    print(dryrun_summary(recs))
    print("\n## Single-pod (16x16)\n")
    print(roofline_table(recs, multi_pod=False))
    print("\n## Multi-pod (2x16x16)\n")
    print(roofline_table(recs, multi_pod=True))
