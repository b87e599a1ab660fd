"""The benchmark entry point: `python -m gridmap_slam_tpu_torch.bench`.

For each cell (cells/*.json; by default all of them, in one process):
build the kernels (on the card), make the log from --seed, make the
preset's engine and its captured replay, and

1. call it once: the warm-up and the capture, `setup_s`;
2. replay the whole log at least --reps times and for at least
   --min-seconds, each replay timed alone (a host clock around the call,
   closed by torch.cuda.synchronize(); the host loop is inside), from an
   initial state and a generator seeded with (--seed, rep) made before its
   window; after each window the weighted poses are read back for ATE and
   the state is checked finite.  `scans_per_sec` is all the replays' scans
   over all their seconds; the median and quartiles of the replays' own
   rates stand beside it;
3. replay rep 0's seed again: it must equal rep 0 in every bit;
4. replay rep 0's seed once more, eagerly, each kernel call beside its
   plain PyTorch version on the same arguments (kernels.Agreement): every
   call must keep its kernel's tolerance;
5. on the card, the per-layer metrics (layers.py) from other replays
   (not under --control, whose run is a check).

With --control each cell runs its control instead (the cell file's
`control`: the kernels named in `round_bf16` read their first argument
rounded to bf16), a kernel that is wrong on purpose, which the agreement
check must fail.

Every metric is printed by name with its unit on lines before the last;
each cell also prints one JSON line `{"cell": ...}` and its breakdown.  The
last line is one compact JSON object: `metric`, `value` and `unit` (the
scans/s of the head cell: the cell of most particles, among equal counts
the fastest, as bench.py's ladder heads its line, bench.py:530-533),
bench.py's baseline fields at the head cell's particles (baseline.py:
`vs_baseline` and the rates it divides by), `correct`, and each cell's
end-to-end metrics.  The run fails (exit 1, `"correct": false`) where an
ATE passes its limit, the state is not finite, the repeated replay differs
or a kernel call leaves its tolerance; asking for --device cuda without a
card exits 2 before anything runs.  Nothing falls back to the CPU: the engines
run where --device says.

bench.py's one-measurement flags (--preset, --set, --chunk, --map-size,
--shared-map, --surface, --crop, --refine-steps, --blocked; measure.py)
run one in-memory cell of that configuration in place of the cell files,
through the same timed replays, checks and last line.

Usage:
    python -m gridmap_slam_tpu_torch.bench                    # every cell
    python -m gridmap_slam_tpu_torch.bench --cell parity --seed 3
    python -m gridmap_slam_tpu_torch.bench --control          # must fail
    python -m gridmap_slam_tpu_torch.bench --preset pr1 \
        --set matcher.coarse_halfres=false                    # bench.py's
    python -m gridmap_slam_tpu_torch.bench --particles 1000000 \
        --chunk 0 --map-size 20 --surface --crop 256          # flags
    python -m gridmap_slam_tpu_torch.bench --device cpu --particles 16 \\
        --scans 4 --reps 2 --min-seconds 0                    # a CPU smoke
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..io import frames_to_device
from ..models import captured
from ..utils.metrics import ate_rmse
from . import baseline
from . import cells as C
from . import kernels as K
from . import layers, measure

MAX_REPS = 10_000
LINE_LIMIT = 2048           # bytes of the last line


def rep_seed(seed: int, rep: int) -> int:
    """The generator seed of replay `rep` of a run seeded with `seed`."""
    return int(np.random.SeedSequence([seed, rep]).generate_state(1)[0])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in captured.leaves(tree)
               if x.is_floating_point())


def _same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(captured.leaves(a), captured.leaves(b)))


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive") \
        if len(xs) > 1 else (xs[0],) * 3
    return q1, q2, q3


def _suffix(device) -> str:
    """The entry points an engine on `device` calls: the kernels on the
    card, the plain versions on the CPU."""
    return "cuda" if device.type == "cuda" else "plain"


def control(cell: C.Cell, kernels: dict, device):
    """The context of the cell's control: each kernel it names in
    `round_bf16` reads its first argument rounded to bf16."""
    def wrap(_, entry, real):
        def call(first, *args, **kw):
            return real(first.to(torch.bfloat16).to(first.dtype), *args, **kw)
        return call
    return K.patched([kernels[k] for k in cell.control["round_bf16"]], wrap,
                     _suffix(device))


def run_cell(cell: C.Cell, preset: C.Preset, args, device, kernels: dict,
             spans: dict) -> dict:
    """One cell: the timed replays, the checks and (on the card) the
    per-layer metrics.  Returns the cell's record."""
    cfg = cell.make_config(preset)
    if args.particles:
        cfg = cfg.replace(num_particles=args.particles)
    frames, gt = C.build_log(args.scans or cell.log["scans"],
                             args.beams or cell.log["beams"], args.seed)
    n = len(frames)
    base = 0
    if device.type == "cuda":
        gc.collect()            # an earlier cell's engine and graph
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=device)
    span_nodes = layers.SpanNodes(
        spans[s] for s in layers.parts(cell, "device_ms_a_scan")
        if s in spans)
    per_layer = breakdown = None
    agreement = K.Agreement(kernels)
    with control(cell, kernels, device) if args.control \
            else contextlib.nullcontext():
        eng, replay, eager = preset.make(cfg, device)

        def inputs(rep):
            return (eng.init(),
                    torch.Generator(device=device).manual_seed(
                        rep_seed(args.seed, rep)))

        s0, g = inputs(0)
        _sync(device)
        with span_nodes.record() if device.type == "cuda" \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            replay(s0, batch, g)
            _sync(device)
            setup_s = time.perf_counter() - t0

        t_timed = time.perf_counter()
        seconds, ates, finite, first = [], [], True, None
        while len(seconds) < MAX_REPS and (
                len(seconds) < args.reps or sum(seconds) < args.min_seconds):
            s0, g = inputs(len(seconds))
            _sync(device)
            t0 = time.perf_counter()
            state, infos = replay(s0, batch, g)
            _sync(device)
            seconds.append(time.perf_counter() - t0)
            ates.append(ate_rmse(infos.weighted_pose.cpu().numpy(), gt[:n]))
            finite = finite and _finite(state)
            if first is None:
                first = (state, infos)
            del state, infos
        peak_gb = ((torch.cuda.max_memory_allocated(device) - base) / 1e9
                   if device.type == "cuda" else None)
        stage = {"setup": setup_s, "timed": time.perf_counter() - t_timed}
        t0 = time.perf_counter()
        s0, g = inputs(0)
        repeated = _same_bits(first, replay(s0, batch, g))
        del first
        stage["repeat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s0, g = inputs(0)
        with K.patched(kernels.values(), agreement.wrap, _suffix(device)):
            eager(s0, batch, g)
        _sync(device)
        stage["agreement"] = time.perf_counter() - t0
        if device.type == "cuda" and not args.control:
            t0 = time.perf_counter()
            per_layer, breakdown = layers.measure(
                cell, kernels, span_nodes, replay, eager, batch, inputs, n,
                sum(seconds) / (n * len(seconds)))
            stage["layers"] = time.perf_counter() - t0
        del eng, replay, eager

    rates = [n / s for s in seconds]
    q1, med, q3 = quartiles(rates)
    limits = cell.limits
    ate_max = max(ates)
    agree = bool(agreement.rows) and all(
        row["ok"] for row in agreement.rows.values())
    correct = ate_max <= limits["ate_m"] and finite and repeated and agree
    return dict(
        cell=cell.name, config=cell.config, control=args.control,
        overrides=cell.overrides, particles=cfg.num_particles, scans=n,
        seed=args.seed,
        bounds=cell.bounds, limits=limits, device=device_name(device),
        scans_per_sec=dict(value=n * len(seconds) / sum(seconds),
                           median=med, q1=q1, q3=q3, count=len(rates),
                           seconds=sum(seconds)),
        setup_s=setup_s, peak_device_gb=peak_gb,
        ate_m=dict(max=ate_max, median=statistics.median(ates)),
        kernels_agree=agree, agreement=agreement.rows,
        finite=finite, repeat_bits_equal=repeated, correct=correct,
        stage_seconds=stage, per_layer=per_layer, breakdown=breakdown)


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def device_line(device) -> dict:
    """The device the run measures: the card's name, the count and
    nvidia-smi's name and power limit (or the CPU)."""
    if device.type != "cuda":
        return dict(name="cpu", count=0, nvidia_smi=None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return dict(name=device_name(device), count=torch.cuda.device_count(),
                nvidia_smi=smi, torch=torch.__version__,
                cuda=torch.version.cuda)


def print_cell(rec: dict, cell: C.Cell) -> None:
    """The cell's metrics by name with their units, then its JSON lines."""
    name = rec["cell"]
    sps = rec["scans_per_sec"]
    print(f"{name} scans_per_sec {sps['value']:.6g} scans/s (the scans of "
          f"{sps['count']} replays of {rec['scans']} over their "
          f"{sps['seconds']:.6g} s; the replays' median {sps['median']:.6g},"
          f" quartiles {sps['q1']:.6g} / {sps['q3']:.6g})")
    print(f"{name} setup_s {rec['setup_s']:.6g} s (the first replay: "
          f"warm-up and capture)")
    peak = rec["peak_device_gb"]
    print(f"{name} peak_device_gb "
          + ("not measured (cpu)" if peak is None else f"{peak:.6g} GB"))
    lim = rec["limits"]
    print(f"{name} ate_m {rec['ate_m']['max']:.6g} m (largest of the timed "
          f"replays; limit {lim['ate_m']:.6g} m)")
    for kernel, row in rec["agreement"].items():
        print(f"{name} agreement.{kernel} {row['share']:.6g} of an output "
              f"beyond the tolerance at worst (max abs err "
              f"{row['max_abs_err']:.6g}; {row['calls']} calls; within the "
              f"limit: {row['ok']})")
    print(f"{name} finite {rec['finite']}; repeat_bits_equal "
          f"{rec['repeat_bits_equal']}; control {rec['control']}; correct "
          f"{rec['correct']}")
    print(f"{name} stage_seconds " + ", ".join(
        f"{k} {v:.4g}" for k, v in rec["stage_seconds"].items())
        + " s (the cell's wall time by stage; not a metric)")
    layer = rec["per_layer"] or {}
    for metric, unit in cell.per_layer.items():
        v = layer.get(metric)
        print(f"{name} {metric} "
              + ("not measured" if v is None else f"{v:.6g} {unit}"))
    print(json.dumps({k: v for k, v in rec.items() if k != "breakdown"},
                     separators=(",", ":")))
    if rec["breakdown"] is not None:
        print(json.dumps({"breakdown": name, **rec["breakdown"]},
                         separators=(",", ":")))
    sys.stdout.flush()


def _number(x):
    """x, or None where it is not finite (the last line is strict JSON)."""
    return x if math.isfinite(x) else None


def head_cell(records: Sequence[dict]) -> Optional[dict]:
    """The record the line heads with: of most particles, among equal
    counts the fastest (bench.py:530-533: city at 1M must not displace
    mega's number); None where no cell ran."""
    done = [r for r in records if "scans_per_sec" in r]
    return max(done, key=lambda r: (r["particles"],
                                    r["scans_per_sec"]["value"]),
               default=None)


def last_line(records: Sequence[dict], device, control: bool) -> dict:
    """The run's result: the head cell's scans/s (head_cell) and bench.py's
    baseline fields at its particles, `correct`, and each cell's
    end-to-end metrics and correctness."""
    head = head_cell(records)
    return {
        "metric": "scans_per_sec", "unit": "scans/s",
        "value": head and head["scans_per_sec"]["value"],
        "cell": head and head["cell"],
        **(baseline.baseline_fields(head["scans_per_sec"]["value"],
                                    head["particles"])
           if head else dict.fromkeys(baseline.FIELDS)),
        "correct": bool(records) and all(r["correct"] for r in records),
        "control": control,
        "device": device_name(device),
        "units": {**{k: unit for k, (unit, _) in C.END_TO_END.items()},
                  "ate_m": "m"},
        "cells": {r["cell"]: (
            {"scans_per_sec": r["scans_per_sec"]["value"],
             "setup_s": r["setup_s"], "peak_device_gb": r["peak_device_gb"],
             "ate_m": _number(r["ate_m"]["max"]),
             "kernels_agree": r["kernels_agree"], "correct": r["correct"]}
            if "scans_per_sec" in r else
            {"correct": False, "error": r["error"][:200]})
            for r in records},
    }


def build_parser(cells: Sequence[str],
                 presets: Sequence[str]) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gridmap_slam_tpu_torch.bench",
        description="Scans/s of the port's captured replays, with ATE, "
                    "reproducibility, the kernels' agreement with their "
                    "plain versions and per-layer metrics")
    ap.add_argument("--cell", action="append", default=None, choices=cells,
                    help="a cell (repeatable; default: every cell)")
    one = ap.add_argument_group(
        "one measurement (bench.py's flags; not with --cell)")
    one.add_argument("--preset", default=None, choices=presets,
                     help="bench.py's preset (presets/<name>.json)")
    one.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                     dest="overrides",
                     help="dotted-key SlamConfig override, e.g. --set "
                          "matcher.coarse_halfres=false (repeatable)")
    one.add_argument("--chunk", type=int, default=None,
                     help="particle_chunk (bench.py's default 2048)")
    one.add_argument("--map-size", type=float, default=None,
                     help="a square map of this many metres, centred on "
                          "the origin (bench.py's default 6)")
    one.add_argument("--shared-map", action="store_true",
                     help="the shared-map filter, per-particle matcher")
    one.add_argument("--surface", action="store_true",
                     help="the shared-map filter in surface mode")
    one.add_argument("--crop", type=int, default=0,
                     help="surface-volume crop in cells (0: the preset's)")
    one.add_argument("--refine-steps", type=int, default=-1,
                     help="surface hill-climb steps (-1: the preset's)")
    one.add_argument("--blocked", type=int, default=-1, metavar="BLOCK",
                     help="the shared-map filter's matcher in blocks of "
                          "BLOCK particles (0: from the config; -1: off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the log and the particles' generator")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--control", action="store_true",
                    help="run each cell's control, which must fail")
    ap.add_argument("--scans", type=int, default=0,
                    help="scans of the log in place of the cell's "
                         "(bench.py's --frames)")
    ap.add_argument("--beams", type=int, default=0,
                    help="beams a scan of the log in place of the cell's")
    ap.add_argument("--particles", type=int, default=0,
                    help="particles in place of the preset's (small runs)")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed replays at least")
    ap.add_argument("--min-seconds", type=float, default=8.0,
                    help="seconds of timed replays at least")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cells, presets = C.load_cells(), C.load_presets()
    ap = build_parser(sorted(cells), sorted(presets))
    args = ap.parse_args(argv)
    if measure.requested(args):
        if args.cell:
            ap.error("--cell runs cell files; --preset, --set, --chunk, "
                     "--map-size, --crop, --refine-steps and the engine "
                     "flags make one measurement of their own")
        cell, preset = measure.measurement(args, presets, argv)
        todo = [(cell, preset)]
        # the cell's overrides hold --particles
        args = argparse.Namespace(**{**vars(args), "particles": 0})
    else:
        todo = [(cells[name], presets[cells[name].preset])
                for name in args.cell or sorted(cells)]
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card unless "
              "--device cpu is given", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    kernels, spans = K.load(), C.load_spans()
    print("device " + json.dumps(device_line(device)), flush=True)
    if device.type == "cuda":
        from ..ops.cuda import _build
        t0 = time.perf_counter()
        torch.zeros(1, device=device)   # the context, before any cell
        _build.library()
        print(f"build {time.perf_counter() - t0:.6g} s (the CUDA context, "
              f"nvcc and load; not a metric)", flush=True)
    records = []
    for cell, preset in todo:
        try:
            rec = run_cell(cell, preset, args, device, kernels, spans)
        except Exception as e:  # noqa: BLE001 - a failed cell fails the run,
            import traceback    # and the cells after it still run
            traceback.print_exc()
            rec = dict(cell=cell.name, correct=False, error=repr(e))
            print(json.dumps(rec, separators=(",", ":")), flush=True)
        else:
            print_cell(rec, cell)
        records.append(rec)
    line = json.dumps(last_line(records, device, args.control),
                      separators=(",", ":"))
    print(f"run_seconds {time.perf_counter() - t_run:.6g} s (the whole run, "
          f"the build included; not a metric)")
    if len(line.encode()) > LINE_LIMIT:
        raise AssertionError(f"the last line is {len(line)} bytes")
    print(line, flush=True)
    return 0 if json.loads(line)["correct"] else 1
