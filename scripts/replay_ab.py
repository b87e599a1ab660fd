"""This tree's captured replay against another commit's, in turns, in one
process on one card.

The engines' captured replays are `models/captured.replay_fn(Captured(step,
draw, device))`.  This script builds the parity and the mega preset's
engines from this tree, and two replays of each over the 12-scan log: this
tree's `Captured`, and the `Captured` of models/captured.py under --root (an
unpacked earlier commit, e.g. the graph a scan before the whole log was one
graph), on the same engine's step and draws.  It checks that both give the
same bits from one seed, then times them in turns (A B B A, TURNS times
over), each turn as the benchmark times a cell: replays from a seeded
generator, each ended by torch.cuda.synchronize(), for TURN_SECONDS; it
prints each turn's scans/s, then each design's scans over all its seconds.
The card alternates between a fast and a slow state for stretches of
seconds, so turns of about a second, many of them, keep the comparison
inside one process and one state's share.

Usage: python scripts/replay_ab.py --root DIR      (needs a GPU; ~90 s)
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

TURNS = 8
TURN_SECONDS = 1.0


def load_captured(root: Path):
    """models/captured.py of the checkout at `root`, as a module of its
    own (it imports nothing of its package)."""
    path = root / "gridmap_slam_tpu_torch" / "models" / "captured.py"
    spec = importlib.util.spec_from_file_location("other_captured", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(replay, init, batch, n: int, seed: int):
    scans = 0
    seconds = 0.0
    while seconds < TURN_SECONDS:
        s0 = init()
        g = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(s0, batch, g)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        scans += n
    return scans, seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, SlamConfig,
                                        mega_config)
    from gridmap_slam_tpu_torch.config import MapConfig
    from gridmap_slam_tpu_torch.io import frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     default_world,
                                                     simulate_log,
                                                     square_path_controls)
    from gridmap_slam_tpu_torch.models import captured

    other = load_captured(args.root.resolve())
    frames, _ = simulate_log(default_world(), square_path_controls(12),
                             params=SimParams(beams_per_rev=180), seed=0)
    parity = RBPF(SlamConfig(num_particles=500, max_beams=192,
                             particle_chunk=250,
                             map=MapConfig(width_m=6.0, height_m=6.0,
                                           resolution=0.05,
                                           origin=(-3.0, -3.0))),
                  device="cuda")
    mega = SharedMapSLAM(mega_config(), device="cuda")
    for name, eng, step, draw in (
            ("parity", parity, parity._scan_step, parity._draws),
            ("mega", mega, mega._surface_scan_step, mega._draw)):
        batch = frames_to_device(frames, eng.config.max_beams,
                                 eng.config.sensor.max_range, device="cuda")
        n = len(frames)
        replays = {
            "this": captured.replay_fn(captured.Captured(step, draw,
                                                         eng.device)),
            "other": other.replay_fn(other.Captured(step, draw, eng.device))}
        outs = {}
        for which, replay in replays.items():
            g = torch.Generator(device="cuda").manual_seed(0)
            outs[which] = replay(eng.init(), batch, g)
        same = all(torch.equal(a, b) for a, b in zip(
            captured.leaves(outs["this"]), captured.leaves(outs["other"])))
        del outs
        totals = {k: [0, 0.0] for k in replays}
        for i in range(TURNS):
            for which in (("this", "other") if i % 2 == 0
                          else ("other", "this")):
                scans, seconds = turn(replays[which], eng.init, batch, n, i)
                totals[which][0] += scans
                totals[which][1] += seconds
                print(json.dumps(dict(preset=name, turn=i, replay=which,
                                      scans_per_sec=scans / seconds)),
                      flush=True)
        print(json.dumps(dict(preset=name, same_bits=same, scans_per_sec={
            k: s / t for k, (s, t) in totals.items()})), flush=True)
        del replays
    return 0


if __name__ == "__main__":
    sys.exit(main())
