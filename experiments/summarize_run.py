"""Summarize a training run + its snapshot evals into one table.

Reads <out_dir>/metrics.jsonl (train loss curve) and any
output/eval_syn_<iter>/eval.json produced by the phase-B runbook, and
prints a markdown table + one JSON line for the artifacts.

  python experiments/summarize_run.py output/lov_syn_r2
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

import numpy as np


def main(out_dir: str) -> int:
    rows = []
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    rows.sort(key=lambda r: r["iter"])
    # training loss trend: median over a +-250-iter window at probes
    probes = [r["iter"] for r in rows][:: max(1, len(rows) // 8)]
    print("## train loss curve")
    print("| iter | loss (med±500) | loss_cls | loss_vertex | loss_pose | lr |")
    print("|---|---|---|---|---|---|")
    curve = []
    for p in probes:
        win = [r for r in rows if abs(r["iter"] - p) <= 250]
        med = lambda k: float(np.median([r[k] for r in win if k in r]))
        curve.append({"iter": p, "loss": round(med("loss"), 3)})
        print(
            f"| {p} | {med('loss'):.3f} | {med('loss_cls'):.3f} | "
            f"{med('loss_vertex'):.3f} | {med('loss_pose'):.3f} | {med('lr'):.2e} |"
        )

    evals = []
    # accept both the r2 (eval_syn_<it>) and r3 (r3_eval_syn_<it>)
    # eval-dir naming; prefer the newer runs when both exist
    paths = sorted(glob.glob("output/r3_eval_syn_*/eval.json")) or sorted(
        glob.glob("output/eval_syn_*/eval.json")
    )
    for path in paths:
        m = re.search(r"eval_syn_(\d+)", path)
        with open(path) as f:
            d = json.load(f)
        evals.append(
            {
                "iter": int(m.group(1)),
                "seg_mean_iou": round(d.get("seg_mean_iou", float("nan")), 4),
                "adds_auc": round(d.get("adds_auc", float("nan")), 4),
                "add_auc": round(d.get("add_auc", float("nan")), 4),
            }
        )
    evals.sort(key=lambda e: e["iter"])
    if evals:
        print("\n## held-out synthetic eval curve (30 scenes, seed 4242)")
        print("| iter | seg mean IoU | ADD-S AUC | ADD AUC |")
        print("|---|---|---|---|")
        for e in evals:
            print(f"| {e['iter']} | {e['seg_mean_iou']} | {e['adds_auc']} | {e['add_auc']} |")

    print()
    print(json.dumps({"metric": "train_run_summary", "loss_curve": curve, "evals": evals}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else "output/lov_syn_r2"))
