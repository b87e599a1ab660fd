"""Time kernel K4 (the bf16 surface correlation) on one NVIDIA GPU.

Times `surface_corr_bf16_cuda` of the package found under --root (default:
this checkout; point it at an unpacked earlier commit to time that commit's
K4 on the same inputs) at three cases:

- "mega_bf16 step": the arguments the fourth step of a mega_bf16 engine
  (chip_smoke.bf16_config(), 1M particles, the scans of
  chip_smoke.parity_log()) passes K4: 25 bins of 405 x 405 taps over a
  524 x 524 padded field;
- "city_bf16 step": those of the second step of a city_bf16 engine
  (chip_smoke.city_bf16_config()): the same taps over a 916 x 916 field;
- "dense 16x64x128x128": 16 bins of 64 x 64 taps, one in ten nonzero, over
  a 128 x 128 volume (chip_smoke's dense K4_SHAPES case), from a seed.

The run that finds no file at --inputs makes the inputs with the package
under its --root and saves them there; every later run reads them, so two
runs (two --root) time the same tensors.

Prints the card's name and power limit, then one JSON line a case: twice
in turns, ms a call (CUDA events around back-to-back calls from Python)
and device ms a call inside a CUDA graph of such calls (the launches' host
time left out); each of K4's kernels' device ms a call (torch.profiler);
the largest difference from the plain version and a digest of the
volume's bits.

Usage: python scripts/k4_bench.py --inputs FILE [--root DIR]
"""

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _make_inputs(smoke) -> dict:
    """K4's arguments in a mega_bf16 and a city_bf16 step (recorded from
    the engine), and the dense case."""
    import numpy as np
    import torch

    from gridmap_slam_tpu_torch import SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4

    frames, _ = smoke.parity_log()
    cases = {}
    for name, cfg, warm in (("mega_bf16 step", smoke.bf16_config(), 3),
                            ("city_bf16 step", smoke.city_bf16_config(), 1)):
        eng = SharedMapSLAM(cfg, device="cuda")
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
        state = eng.init()
        for i in range(warm):
            state, _ = eng.step_surface(state, frame_at(batch, i), gen)
        real, seen = k4.surface_corr_bf16_cuda, []

        def record(fpad, e, shift, mass):
            seen.append(tuple(t.clone() if torch.is_tensor(t) else t
                              for t in (fpad, e, shift, mass)))
            return real(fpad, e, shift, mass)

        k4.surface_corr_bf16_cuda = record
        try:
            eng.step_surface(state, frame_at(batch, warm), gen)
        finally:
            k4.surface_corr_bf16_cuda = real
        cases[name] = seen[0]
        del eng, batch, state
        torch.cuda.empty_cache()
    cases["dense 16x64x128x128"] = smoke._k4_inputs(
        16, 64, 128, 128, "random", np.random.default_rng(smoke.SEED + 4))
    return {name: tuple(t.cpu() if torch.is_tensor(t) else t for t in a)
            for name, a in cases.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", type=Path, required=True)
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    # this checkout's chip_smoke.py, whichever package --root holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    if not args.inputs.exists():
        torch.save(_make_inputs(smoke), args.inputs)
    cases = torch.load(args.inputs)

    for name, cpu_args in cases.items():
        a = tuple(t.cuda() if torch.is_tensor(t) else t for t in cpu_args)
        out = k4.surface_corr_bf16_cuda(*a)
        err = float((out - k4.surface_corr_bf16_plain(*a)).abs().max())
        reps = 10 if a[0].shape[0] > 600 else 50
        ms, graph = [], []
        for _ in range(2):
            ms.append(smoke.cuda_ms(lambda: k4.surface_corr_bf16_cuda(*a),
                                    reps))
            graph.append(smoke.graph_ms(
                lambda: k4.surface_corr_bf16_cuda(*a), reps))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                k4.surface_corr_bf16_cuda(*a)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            m = re.search(r"surface_corr_\w+", e.name)
            if m and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[m.group(0)] = (kernels.get(m.group(0), 0.0)
                                       + e.time_range.elapsed_us() / 1e3
                                       / reps)
        print(json.dumps({
            "case": name, "root": str(args.root), "ms": ms,
            "graph_ms": graph, "kernels_ms": kernels, "max_abs_err": err,
            "bits": hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]}), flush=True)
        del a, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
