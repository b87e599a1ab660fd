"""K1 of this tree against an earlier commit's, on the calls of real scans,
in one process on one card.

Records every K1 call (its arguments, cloned) of an eager replay of the
benchmark's 12-scan log (bench/cells.build_log, RBPF.replay from the
benchmark's rep-0 generator seed) at `parity_fullres` (the parity preset
with `matcher.coarse_halfres=false`: 6 calls a scan, 2 of them nearest, the
shared variant) and at `pr1` with the same override (3 a scan, 1 nearest,
the global variant).  Builds the kernel library of --root (an unpacked
earlier commit, into its own build directory) beside this tree's, then
runs the recorded calls on A (this tree) and B (--root) in turns, A B B A
TURNS times over: each turn runs every call REPS times under
torch.profiler and reads the kernels' device time, so that K1's device ms
a scan, a nearest call's and a bilinear call's device ms come from one
process and the card's state of the moment is shared.  Beside them, the
nearest calls' milliseconds by CUDA events around calls from Python (host
launch time included), and each nearest call's bound
(bench/kernels/k1.k1_bound) over its device time.

Checks, on every recorded call: the bilinear calls' scores of A and B are
equal in every bit; A's nearest scores have no score beyond K1's rtol /
atol of the plain version's, and B's count is printed.

Prints the card's name and power limit, a JSON line a turn, then the
summary line.

Usage (needs a GPU; ~3 min with both builds):
    python scripts/k1_ab.py --root DIR [--presets parity,pr1] [--turns 4]
        [--reps 20]
"""

import argparse
import contextlib
import importlib.util
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms  # noqa: E402
from gridmap_slam_tpu_torch import RBPF  # noqa: E402
from gridmap_slam_tpu_torch.bench import cells as C  # noqa: E402
from gridmap_slam_tpu_torch.bench.kernels import k1  # noqa: E402
from gridmap_slam_tpu_torch.bench.run import rep_seed  # noqa: E402
from gridmap_slam_tpu_torch.io import frames_to_device  # noqa: E402
from gridmap_slam_tpu_torch.ops.cuda import _build  # noqa: E402
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch  # noqa: E402

SCANS = 12
# a K1 instantiation's name, demangled or not: <shared, nearest, run, tiled>
NAME = re.compile(r"stage_scores_kernel<(\w+), (\w+), (\d+), (\w+)>"
                  r"|stage_scores_kernelILb([01])ELb([01])ELi(\d+)ELb([01])E")


def load_build(root: Path):
    """ops/cuda/_build.py of the checkout at `root`, as a module of its own
    (it imports nothing of its package): its library() builds and loads
    that checkout's kernels."""
    path = root / "gridmap_slam_tpu_torch" / "ops" / "cuda" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def library(build):
    """K1's wrappers launch from `build`'s library while inside."""
    real = kmatch._build
    kmatch._build = build
    try:
        yield
    finally:
        kmatch._build = real


def record(preset: str, seed: int = 0):
    """Every K1 call of the eager replay of `preset` with its coarse stage
    on nearest cells: [(args, kw)], cloned."""
    cfg = C.load_presets()[preset].config.with_overrides(
        {"matcher.coarse_halfres": False})
    frames, _ = C.build_log(SCANS, 180, seed)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    eng = RBPF(cfg, device="cuda")
    real, calls = kmatch.stage_scores_batch_cuda, []

    def wrapped(*args, **kw):
        calls.append((tuple(a.clone() for a in args), dict(kw)))
        return real(*args, **kw)

    kmatch.stage_scores_batch_cuda = wrapped
    try:
        g = torch.Generator(device="cuda").manual_seed(rep_seed(seed, 0))
        eng.replay(eng.init(), batch, g)
        torch.cuda.synchronize()
    finally:
        kmatch.stage_scores_batch_cuda = real
    return calls


def device_ms(calls, reps: int) -> dict:
    """Every call `reps` times under torch.profiler: K1's device ms summed
    over the calls a rep, and a nearest and a bilinear call's mean."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args, kw in calls:
                kmatch.stage_scores_batch_cuda(*args, **kw)
        torch.cuda.synchronize()
    total = {True: 0.0, False: 0.0}
    for e in prof.key_averages():
        m = NAME.search(e.key)
        if not m:
            continue
        _, nearest, _, tiled = (a or b for a, b in zip(m.groups()[:4],
                                                        m.groups()[4:]))
        if tiled in ("false", "0"):
            us = float(getattr(e, "self_device_time_total", 0.0)
                       or getattr(e, "self_cuda_time_total", 0.0))
            total[nearest in ("true", "1")] += us / 1e3 / reps
    n_near = sum(bool(kw["nearest"]) for _, kw in calls)
    return dict(k1_ms_a_rep=total[True] + total[False],
                nearest_ms_a_call=total[True] / max(n_near, 1),
                bilinear_ms_a_call=total[False] / max(len(calls) - n_near,
                                                      1))


def check(calls, other) -> dict:
    """Bits of A against B on the bilinear calls, and each side's nearest
    scores beyond the tolerance of the plain version's."""
    bilinear_equal, beyond = True, {"A": 0, "B": 0}
    scores = 0
    for args, kw in calls:
        a = kmatch.stage_scores_batch_cuda(*args, **kw)
        with library(other):
            b = kmatch.stage_scores_batch_cuda(*args, **kw)
        if not kw["nearest"]:
            bilinear_equal &= bool(torch.equal(a, b))
            continue
        ref = kmatch.stage_scores_batch_plain(*args, **kw)
        tol = k1.K1_ATOL + k1.K1_RTOL * ref.abs()
        beyond["A"] += int(((a - ref).abs() > tol).sum())
        beyond["B"] += int(((b - ref).abs() > tol).sum())
        scores += a.numel()
    return dict(bilinear_bits_equal=bilinear_equal,
                nearest_beyond=beyond, nearest_scores=scores)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--presets", default="parity,pr1")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = load_build(args.root.resolve())
    built = threading.Thread(target=other.build)   # both nvcc at once
    built.start()
    _build.build()
    built.join()
    other.library()
    summary = {}
    for preset in args.presets.split(","):
        calls = record(preset)
        nearest = [(a, kw) for a, kw in calls if kw["nearest"]]
        bounds = [k1.k1_bound(a, kw)[0] for a, kw in nearest]
        rows = {"A": [], "B": []}
        for turn in range(args.turns):
            for side in ("AB" if turn % 2 == 0 else "BA"):
                with library(_build if side == "A" else other):
                    row = device_ms(calls, args.reps)
                    row["k1_ms_a_scan"] = row.pop("k1_ms_a_rep") / SCANS
                    row["nearest_ev_ms"] = [cuda_ms(
                        lambda: kmatch.stage_scores_batch_cuda(*a, **kw),
                        args.reps) for a, kw in nearest[:2]]
                row["nearest_share_of_bound"] = (
                    sum(bounds) / len(bounds) / row["nearest_ms_a_call"])
                rows[side].append(row)
                print(json.dumps(dict(preset=preset, turn=turn, side=side,
                                      **row)), flush=True)
        summary[preset] = dict(
            calls=len(calls), nearest_calls=len(nearest),
            nearest_bound_ms=[min(bounds), max(bounds)],
            **check(calls, other),
            **{f"{key} {side}": [min(r[key] for r in rows[side]),
                                 max(r[key] for r in rows[side])]
               for side in "AB" for key in ("k1_ms_a_scan",
                                            "nearest_ms_a_call",
                                            "bilinear_ms_a_call",
                                            "nearest_share_of_bound")})
        del calls, nearest
        torch.cuda.empty_cache()
    print(json.dumps({"root_b": str(args.root), "summary": summary}))
    ok = all(s["bilinear_bits_equal"] and s["nearest_beyond"]["A"] == 0
             for s in summary.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
