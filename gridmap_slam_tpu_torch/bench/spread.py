"""The benchmark's spread between processes, its ATE over seeds, and its
controls.

Runs `python -m gridmap_slam_tpu_torch.bench --seed S` once for each seed
of --seeds (a seed may repeat: each run is a process of its own, one after
the other), then `--control --seed S --reps 3 --min-seconds 0` for each
seed of --control-seeds, keeps each run's output in --out, and prints for
every cell each run's record, then, over the runs: the largest gap between
two runs' scans/s (all scans over all seconds) as a share of the smallest,
among the runs of one seed and among all, the same of the runs' medians,
the range of setup_s and peak_device_gb, the ATE of each seed, each
kernel's worst share of an output beyond its tolerance, and each control's
ATE, shares and verdict.  A cell's scans_per_sec bound is the larger of 3 %
and twice the largest gap.

Usage (on the card):
    python -m gridmap_slam_tpu_torch.bench.spread --seeds 0,0,0,1,2,3,4 \\
        --control-seeds 0,1,2,3,4 --out out/spread \\
        [-- extra arguments of the benchmark]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _run(out: Path, tag: str, argv: list) -> tuple:
    """One benchmark process: (exit code, its cell records by name)."""
    cmd = [sys.executable, "-m", "gridmap_slam_tpu_torch.bench", *argv]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"{tag}.txt").write_text(proc.stdout)
    (out / f"{tag}.err").write_text(proc.stderr)
    recs = {}
    for line in proc.stdout.splitlines():
        if line.startswith('{"cell"'):
            rec = json.loads(line)
            recs[rec["cell"]] = rec
    return proc.returncode, recs


def _gap(values) -> float:
    return (max(values) - min(values)) / min(values) if values else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,0,0")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("extra", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    extra = [a for a in args.extra if a != "--"]
    runs, controls, rc = [], [], 0
    for i, seed in enumerate(_seeds(args.seeds)):
        code, recs = _run(args.out, f"run{i}_seed{seed}",
                          ["--seed", str(seed), *extra])
        print(json.dumps({"run": i, "seed": seed, "rc": code, "cells": {
            c: {"scans_per_sec": r["scans_per_sec"], "setup_s": r["setup_s"],
                "ate_m": r["ate_m"]["max"], "agreement": r["agreement"],
                "correct": r["correct"]} for c, r in recs.items()}}),
            flush=True)
        rc = rc or code
        runs.append((seed, recs))
    for seed in _seeds(args.control_seeds):
        code, recs = _run(args.out, f"control_seed{seed}",
                          ["--control", "--seed", str(seed), *extra,
                           "--reps", "3", "--min-seconds", "0"])
        controls.append((seed, code, recs))
    for cell in sorted({c for _, recs in runs for c in recs}
                       | {c for _, _, recs in controls for c in recs}):
        rows = [(seed, recs[cell]) for seed, recs in runs if cell in recs]
        by_seed = {}
        for seed, r in rows:
            by_seed.setdefault(seed, []).append(r)

        def gaps(key):
            return {
                "one_seed": max((_gap([r["scans_per_sec"][key] for r in v])
                                 for v in by_seed.values() if len(v) > 1),
                                default=None),
                "all": _gap([r["scans_per_sec"][key] for _, r in rows])}
        peak = [r["peak_device_gb"] for _, r in rows
                if r["peak_device_gb"] is not None]
        setup = [r["setup_s"] for _, r in rows]
        print(json.dumps({
            "cell": cell, "runs": len(rows),
            "scans_per_sec": [r["scans_per_sec"]["value"] for _, r in rows],
            "medians": [r["scans_per_sec"]["median"] for _, r in rows],
            "gap_share": gaps("value"), "gap_share_of_medians": gaps("median"),
            "setup_s": [min(setup), max(setup)] if setup else None,
            "peak_device_gb": [min(peak), max(peak)] if peak else None,
            "ate_m_by_seed": [[seed, r["ate_m"]["max"]] for seed, r in rows],
            "worst_share_beyond_tolerance": {
                k: max(r["agreement"][k]["share"] for _, r in rows)
                for k in rows[0][1]["agreement"]} if rows else None,
            "correct": all(r["correct"] for _, r in rows),
            "controls": [[seed, code, recs[cell]["ate_m"]["max"],
                          {k: v["share"] for k, v in
                           recs[cell]["agreement"].items()},
                          recs[cell]["correct"]]
                         for seed, code, recs in controls if cell in recs],
        }), flush=True)
    # every run sound, every control failed
    return rc or int(any(code == 0 for _, code, _ in controls))


if __name__ == "__main__":
    sys.exit(main())
