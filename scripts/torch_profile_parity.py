"""Where the time of the PyTorch port's parity step goes, on one NVIDIA GPU.

Runs the parity preset (500 particles, 120 x 120 maps, particle_chunk 250,
180 beams in 192 slots, the 12-scan synthetic square-path log of bench.py,
seed 0) through gridmap_slam_tpu_torch's RBPF once to warm up, then once
under torch.profiler.  Prints one JSON line: wall time of the run (host
clock, ending in a synchronize), the summed device time of all kernels and
its share of the wall time, the device events per scan, and the
top operations by device time.  With --trace PATH the Chrome trace of the
profiled run is written there.

Usage: python scripts/torch_profile_parity.py [--trace PATH]   (needs a GPU)
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

from chip_smoke import parity_config, parity_log  # noqa: E402
from gridmap_slam_tpu_torch import RBPF  # noqa: E402
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=None,
                    help="write the profiled run's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    cfg = parity_config()
    frames, _ = parity_log()
    eng = RBPF(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    seq = [frame_at(batch, i) for i in range(len(frames))]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        eng.run_log(eng.init(), seq, gen)
        torch.cuda.synchronize()

    run()                                   # builds the kernels, warms up
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

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    avg = sorted(prof.key_averages(), key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "count": e.count,
            "device_ms": _device_us(e) / 1e3} for e in avg[:15]
           if _device_us(e) > 0]
    n = len(seq)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scans": n,
        "wall_s_unprofiled": wall_plain, "scans_per_sec": n / wall_plain,
        "wall_s_profiled": wall, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_events_per_scan": len(kernels) / n,
        "top_by_device_time": top}))


if __name__ == "__main__":
    main()
