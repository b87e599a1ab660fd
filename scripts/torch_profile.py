"""Where the time of one of the PyTorch port's presets goes, on one NVIDIA GPU.

Runs a preset over the 12-scan synthetic square-path log of bench.py
(seed 0) once to warm up, then once under torch.profiler:

- parity: RBPF, 500 particles, 120 x 120 maps, particle_chunk 250;
- mega:   SharedMapSLAM.step_surface, 1M particles, one 120 x 120 map;
- city:   SharedMapSLAM.step_surface, 1M particles, one 4000 x 4000 map,
          the volume over a 512-cell crop;
- mega_blocked: SharedMapSLAM.replay, 1M particles each running the full
          matcher on one 120 x 120 map, in blocks of matcher_block_size;
- chip:   RBPF, 10 000 particles in chunks of 500 on the parity map;
- multi:  MultiRobotSLAM.replay, scripts/config5_demo.py's two robots on
          14 x 8 m at 0.1 m, 96 beams, 20 ticks, 10 000 particles a robot.

Prints one JSON line: wall time of the run (host clock, ending in a
synchronize), the summed device time of all kernels and its share of the
wall time, the device events per scan, the host waits on the device per
scan (CUDA runtime synchronize calls, the run's closing one left out), and
the top operations by device time.  With --trace PATH the Chrome trace of
the profiled run is written there.  With --root DIR the package (and
chip_smoke.py) of the checkout unpacked at DIR are profiled instead of this
one's, to compare two commits on one card.

Usage: python scripts/torch_profile.py
           [--preset parity|mega|city|mega_blocked|chip|multi] [--root DIR]
           [--trace PATH]                                   (needs a GPU)
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# preset -> (engine, the parity config's particles and chunk, or the
# package's own config function)
PRESETS = {"parity": ("RBPF", (500, 250)),
           "mega": ("SharedMapSLAM", "mega_config"),
           "city": ("SharedMapSLAM", "city_config"),
           "mega_blocked": ("SharedMapSLAM", (1_000_000, 0)),  # bench.py:641
           "chip": ("RBPF", (10_000, 500)),                   # bench.py:623
           "multi": ("MultiRobotSLAM", 10_000)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="parity")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="profile the checkout unpacked here")
    ap.add_argument("--trace", type=Path, default=None,
                    help="write the profiled run's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    sys.path.insert(0, str(args.root.resolve()))
    import gridmap_slam_tpu_torch as pkg
    from chip_smoke import parity_config, parity_log
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    engine, config = PRESETS[args.preset]
    if args.preset == "multi":
        return profile_run(args, *multi_run(pkg, config))
    if isinstance(config, str):
        cfg = getattr(pkg, config)()
    else:
        cfg = parity_config().replace(num_particles=config[0],
                                      particle_chunk=config[1])
    frames, _ = parity_log()
    eng = getattr(pkg, engine)(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    seq = [frame_at(batch, i) for i in range(len(frames))]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        if args.preset == "mega_blocked":
            eng.replay(eng.init(), seq, gen,
                       block=pkg.matcher_block_size(cfg))
        else:
            eng.run_log(eng.init(), seq, gen)
        torch.cuda.synchronize()

    profile_run(args, run, cfg.num_particles, len(seq))


def multi_run(pkg, particles):
    """chip_smoke.py's multi path: (run, particles a robot, ticks)."""
    import math

    from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     multi_room_world,
                                                     simulate_log)
    from gridmap_slam_tpu_torch.models.multi import stack_frames

    revs = 20
    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, math.pi)]
    logs = [simulate_log(world, [(0.25, 0.0)] * revs, params=params,
                         seed=11 + i, start_pose=starts[i]) for i in range(2)]
    cfg = pkg.SlamConfig(num_particles=particles, max_beams=96,
                         sensor=SensorConfig(max_range=8.0),
                         map=MapConfig(width_m=14.0, height_m=8.0,
                                       resolution=0.1, origin=(-7.0, -4.0)))
    eng = pkg.MultiRobotSLAM(cfg, num_robots=2, device="cuda")
    batches = [frames_to_device(f, cfg.max_beams, cfg.sensor.max_range,
                                device="cuda") for f, _ in logs]
    ticks = [stack_frames([frame_at(b, i) for b in batches])
             for i in range(revs)]

    def run():
        eng.replay(eng.init(starts), ticks,
                   torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()

    return run, particles, revs


def profile_run(args, run, particles, n):
    """Warm up, time one run, profile one run, print the JSON line."""
    run()                                   # builds the kernels, warms up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    syncs = sum(1 for e in events if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")) - 1
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    avg = sorted(prof.key_averages(), key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "count": e.count,
            "device_ms": _device_us(e) / 1e3} for e in avg[:15]
           if _device_us(e) > 0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "preset": args.preset,
        "root": str(args.root),
        "particles": particles, "scans": n,
        "wall_s_unprofiled": wall_plain, "scans_per_sec": n / wall_plain,
        "wall_s_profiled": wall, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_events_per_scan": len(kernels) / n,
        "host_syncs_per_scan": syncs / n,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "top_by_device_time": top}))


if __name__ == "__main__":
    main()
