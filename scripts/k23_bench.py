"""Time kernels K2 (map update) and K3 (likelihood field) on one NVIDIA GPU.

Builds the kernels of the package found under --root (default: this
checkout; point it at an unpacked earlier commit to time that commit's
kernels on the same inputs) and times `integrate_scan_batch_cuda` and
`log_likelihood_field_batch_cuda` with CUDA events at the shapes of
PERF.md's table:

- K2: parity (500, 120, 120); the pose-graph filter (200, 280, 280); cone
  fill with a bin table a map (32, 280, 280); city's integration crop
  (1, 412, 412);
- K3 at radius 3: (500, 120, 120), (200, 280, 280), (32, 280, 280), city's
  (1, 518, 518); at radius 12, 30, 60 and 180 (sigma a third of it):
  (500, 120, 120); at radius 12 and 30 on one map, (1, 120, 120), as
  surface relocalization calls it.

Inputs are made from a seed, so two runs (two --root) see the same
numbers.

Prints the card's name and power limit, then one JSON line a case: its
milliseconds a call (CUDA events around back-to-back calls, so the host's
launch time where it is the larger), the kernel's own device time a call
(torch.profiler), the sum of the output, and against the plain version the
largest error and the fraction of cells beyond atol 1e-5.

With --plan, K3's generic variant runs the given tile and threads in place
of the planner's (to try a plan by hand; this checkout's kernels only).

Usage: python scripts/k23_bench.py [--root DIR] [--kernel k2,k3] [--reps N]
                                   [--plan tile_h=N,tile_w=N,threads=N]
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--kernel", default="k2,k3")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--plan", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _test_maps, cuda_ms, parity_config, parity_log
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel
    from gridmap_slam_tpu_torch.types import Scan

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)

    if args.plan:
        forced = {k: int(v) for k, v in
                  (kv.split("=") for kv in args.plan.split(","))}
        planner = likelihood.launch_plan

        def launch_plan(radius, p, h, w, **limits):
            plan = planner(radius, p, h, w, **limits)
            if plan is None or plan.variant != "generic":
                return plan
            plan = plan._replace(**forced)
            return plan._replace(
                bands=-(-h // plan.tile_h), tiles=-(-w // plan.tile_w),
                smem_bytes=likelihood._generic_smem(radius, h, w, plan.tile_h,
                                                    plan.tile_w))

        likelihood.launch_plan = launch_plan

    dev = "cuda"
    cfg = parity_config()
    res, maxr = cfg.map.resolution, cfg.sensor.max_range
    frames, _ = parity_log()
    batch = frames_to_device(frames, cfg.max_beams, maxr, device=dev)
    scans = [deskew_scan(frame_at(batch, i).scan, frame_at(batch, i).odom)
             for i in range(len(frames))]
    rng = np.random.default_rng(0)

    def poses(n, half):
        return torch.as_tensor(np.stack(
            [rng.uniform(-half, half, n), rng.uniform(-half, half, n),
             rng.uniform(-math.pi, math.pi, n)], 1).astype(np.float32),
            device=dev)

    def timed(case, kernel_name, fn, plain, extra):
        out = fn()
        want = plain()
        torch.cuda.synchronize()
        diff = (out - want).abs()
        ms = cuda_ms(fn, args.reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        device_ms = sum(_device_us(e) for e in prof.key_averages()
                        if kernel_name in e.key) / 1e3 / args.reps
        print(json.dumps({
            "case": case, "root": str(args.root), "ms": ms,
            "device_ms": device_ms, "out_sum": float(out.double().sum()),
            "max_abs_err": float(diff.max()),
            "frac_beyond_1e-5": float((diff > 1e-5).float().mean()),
            **extra}), flush=True)

    if "k2" in args.kernel:
        one = torch.ones((), device=dev)
        kw = dict(resolution=res, l_free=cfg.sensor.l_free,
                  l_occ=cfg.sensor.l_occ,
                  tol_cells=cfg.sensor.hit_tolerance_cells)
        table = grid_update.scan_bin_tables(scans[3], cfg.beam_lut_bins)
        stacked = Scan(*(torch.stack([getattr(scans[i % len(scans)], f)
                                      for i in range(32)])
                         for f in ("angle", "dist", "hit", "valid")))
        tables32 = grid_update.scan_bin_tables(stacked, cfg.beam_lut_bins)
        for case, shape, origin, tabs, half, cone in (
                ("K2 parity", (500, 120, 120), (-3.0, -3.0), table, 1.5,
                 False),
                ("K2 filter", (200, 280, 280), (-7.0, -7.0), table, 3.0,
                 False),
                ("K2 cone fill", (32, 280, 280), (-7.0, -7.0), tables32, 0.3,
                 True),
                ("K2 city crop", (1, 412, 412), (-10.3, -10.3), table, 1.0,
                 False)):
            lo = (torch.zeros(shape, device=dev) if cone
                  else _test_maps(*shape, rng, dev))
            ps = poses(shape[0], half)
            k = dict(kw, origin=origin, cone_fill=cone)
            timed(case, "grid_update",
                  lambda: grid_update.integrate_scan_batch_cuda(
                      lo, ps, one, *tabs, **k),
                  lambda: grid_update.integrate_scan_batch_plain(
                      lo, ps, one, *tabs, **k),
                  {"shape": list(shape), "cone_fill": cone})

    if "k3" in args.kernel:
        kw = dict(z_hit=cfg.matcher.z_hit, max_range=maxr)
        cases = [(3, (500, 120, 120)), (3, (200, 280, 280)),
                 (3, (32, 280, 280)), (3, (1, 518, 518))]
        cases += [(r, (500, 120, 120)) for r in (12, 30, 60, 180)]
        cases += [(12, (1, 120, 120)), (30, (1, 120, 120))]
        for radius, shape in cases:
            lo = _test_maps(*shape, rng, dev)
            taps = torch.as_tensor(gaussian_kernel(radius / 3.0, radius),
                                   device=dev)
            plan = getattr(likelihood, "plan_for", None)
            extra = {"shape": list(shape), "radius": radius}
            if plan is not None:
                extra["plan"] = plan(lo, taps)._asdict()
            timed(f"K3 radius {radius}", "ll_field",
                  lambda: likelihood.log_likelihood_field_batch_cuda(
                      lo, taps, **kw),
                  lambda: likelihood.log_likelihood_field_batch_plain(
                      lo, taps, **kw), extra)


if __name__ == "__main__":
    main()
