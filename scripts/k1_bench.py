"""Time kernel K1 (the matcher's stage scores) on one NVIDIA GPU.

Builds the kernels of the package found under --root (default: this
checkout; point it at an unpacked earlier commit to time that commit's K1
on the same inputs) and times `stage_scores_batch_cuda` with CUDA events at
the shapes of PERF.md's table:

- parity: 500 particles, a map each, the coarse stage on the 60 x 60 pooled
  fields (48 beams, 11 x 9 x 9 candidates) and two 5 x 5 x 5 refinement
  stages on 120 x 120 (192 beams);
- shared: one 120 x 120 field for 2048 particles, coarse and fine;
- closures: 32 fields of 280 x 280 with a scan each, the frontend's window
  (13 x 15 x 15, then 5 x 5 x 5);
- block: one shared 120 x 120 field for the 500 000 particles of a
  mega_blocked block, coarse and fine (synthetic poses, the parity scan).

Inputs are made from a seed, so two runs (two --root) see the same
numbers.

Prints the card's name and power limit, then one JSON line a shape:
its milliseconds a call (CUDA events around back-to-back calls, so the
host's launch time where it is the larger), the kernel's own device time a
call (torch.profiler), and the sum and largest magnitude of the scores.

Usage: python scripts/k1_bench.py [--root DIR]
                                  [--only parity,shared,closures,block]
                                  [--stage coarse,fine] [--reps N]
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
    ap.add_argument("--only", default="parity,shared,closures,block")
    ap.add_argument("--stage", default="coarse,fine")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _test_maps, cuda_ms, parity_config, parity_log
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)

    dev = "cuda"
    cfg = parity_config()
    mc = cfg.matcher
    res, maxr = cfg.map.resolution, cfg.sensor.max_range
    frames, _ = parity_log()
    batch = frames_to_device(frames, cfg.max_beams, maxr, device=dev)
    scan = deskew_scan(frame_at(batch, 3).scan, frame_at(batch, 3).odom)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    stride = mc.coarse_beam_stride
    taps = torch.as_tensor(gaussian_kernel(cfg.map.likelihood_sigma,
                                           cfg.map.likelihood_radius),
                           device=dev)
    rng = np.random.default_rng(0)

    def llf(g, h, w):
        lo = _test_maps(g, h, w, rng, dev)
        return likelihood.log_likelihood_field_batch(
            lo, taps, z_hit=mc.z_hit, max_range=maxr)

    def pooled(f):
        g, h, w = f.shape
        return f.reshape(g, h // 2, 2, w // 2, 2).mean((2, 4)).contiguous()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(n, half):
        return t(np.stack([rng.uniform(-half, half, n),
                           rng.uniform(-half, half, n),
                           rng.uniform(-math.pi, math.pi, n)], 1))

    def offsets(n, span, k, jitter):
        base = np.linspace(-span, span, k)
        return t(base[None] + rng.uniform(-jitter, jitter, (n, 1)))

    wt = math.radians(mc.window_theta_deg)

    def stages(field, sx, sy, su, pose, origin, coarse=(9, 11),
               window=(mc.window_xy, wt)):
        """Coarse on the pooled field over every 4th beam, then a 5 x 5 x 5
        refinement around a jittered center, as the matcher runs them."""
        n = pose.shape[0]
        cxy = offsets(n, window[0], coarse[0], 0.0)
        ct = offsets(n, window[1], coarse[1], 0.0)
        fxy = offsets(n, window[0] / 8, 5, window[0])
        ft = offsets(n, window[1] / 10, 5, window[1])
        args_c = (pooled(field), sx[..., ::stride].contiguous(),
                  sy[..., ::stride].contiguous(),
                  su[..., ::stride].contiguous(), pose, cxy, cxy, ct)
        args_f = (field, sx, sy, su, pose, fxy, fxy, ft)
        return [("coarse", args_c, 2 * res, origin),
                ("fine", args_f, res, origin)]

    cases = {}
    origin = cfg.map.origin
    if "parity" in args.only:
        cases["parity"] = stages(llf(500, 120, 120), px, py, use,
                                 poses(500, 1.5), origin)
    if "shared" in args.only:
        cases["shared"] = stages(llf(1, 120, 120), px, py, use,
                                 poses(2048, 1.5), origin)
    if "closures" in args.only:
        c = 32
        cpx, cpy, cuse = (a[None].expand(c, -1).contiguous()
                          for a in (px, py, use))
        cases["closures"] = stages(llf(c, 280, 280), cpx, cpy, cuse,
                                   poses(c, 0.5), (-7.0, -7.0), (15, 13),
                                   (1.0, math.radians(30.0)))
    if "block" in args.only:
        cases["block"] = stages(llf(1, 120, 120), px, py, use,
                                poses(500_000, 1.5), origin)

    for case, rows in cases.items():
        for name, a, r, org in rows:
            if name not in args.stage:
                continue
            kw = dict(resolution=r, origin=org, max_range=maxr)
            out = kmatch.stage_scores_batch_cuda(*a, **kw)
            torch.cuda.synchronize()
            reps = max(3, args.reps // (10 if case == "block" else 1))
            ms = cuda_ms(lambda: kmatch.stage_scores_batch_cuda(*a, **kw),
                         reps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    kmatch.stage_scores_batch_cuda(*a, **kw)
                torch.cuda.synchronize()
            device = [e for e in prof.key_averages()
                      if "stage_scores" in e.key]
            device_ms = sum(_device_us(e) for e in device) / 1e3 / reps
            plan = getattr(kmatch, "launch_plan", None)
            f = a[0]
            info = {}
            if plan is not None:
                info = plan(a[4].shape[0], f.shape[0], f.shape[1],
                            f.shape[2], a[1].shape[-1], a[7].shape[1],
                            a[6].shape[1], a[5].shape[1],
                            **kmatch.device_limits(0))._asdict()
            print(json.dumps({
                "case": case, "stage": name, "root": str(args.root),
                "particles": int(a[4].shape[0]), "field": list(f.shape),
                "beams": int(a[1].shape[-1]), "ms": ms,
                "device_ms": device_ms,
                "score_sum": float(out.double().sum()),
                "score_abs_max": float(out.abs().max()), "plan": info}),
                flush=True)
            del out


if __name__ == "__main__":
    main()
