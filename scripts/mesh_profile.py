"""Where the mesh (1, 1) steps of the distributed engines lose time against
their single-device engines, on one NVIDIA GPU.

For `surface_sharded` (city_config(): 1M particles, 4000 x 4000 map) and
`sharded` (the parity preset's RBPF, 500 particles) over the 12-scan
synthetic square-path log (seed 0), in a world of one over NCCL, eager:

- single: the single-device engine's run_log (step_surface / RBPF.step);
- mesh: the distributed step as it is;
- mesh_no_nccl: the same with dist.all_reduce a no-op and the all_gather a
  copy on the card (what NCCL does at a world of one, without NCCL's host
  path: the ProcessGroup call, its stream and event handshake);
- mesh_no_copies: the same with psum / pmax / all_gather returning their
  input (no clone, no allocation, no collective at all).

At a world of one all four give the same bits (checked).  Each variant runs
once to warm up, then REPEATS times timed by CUDA events (host loop
included), the four variants in turns, and once under torch.profiler:
device ms, host launches a scan (kernels, copies, sets), and the host ms a
scan inside the c10d calls.  The differences of the median times split the
mesh step's extra time into NCCL's calls (mesh - mesh_no_nccl), the
collectives' clones, allocations and Python (mesh_no_nccl -
mesh_no_copies) and the rest of the step's code (mesh_no_copies -
single).  An eager loop's time moves by several percent between runs (the
host's other work only adds), so the split is printed from the medians
and from the minima, and the spread (min, max) beside each median.

Usage: python scripts/mesh_profile.py          (needs a GPU; ~2 minutes)
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
SEED = 0
REPEATS = 7
VARIANTS = ("single", "mesh", "mesh_no_nccl", "mesh_no_copies")


@contextlib.contextmanager
def variant(name):
    """The collectives as the variant `name` runs them (module
    docstring)."""
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh
    from gridmap_slam_tpu_torch.parallel import shmap, surface_sharded
    saved = [(dist, "all_reduce", dist.all_reduce),
             (pmesh, "_gather_into", pmesh._gather_into),
             (pmesh, "_reduce", pmesh._reduce),
             (shmap, "all_gather", shmap.all_gather),
             (surface_sharded, "all_gather", surface_sharded.all_gather)]
    if name == "mesh_no_nccl":
        dist.all_reduce = lambda t, op=None, group=None: None
        pmesh._gather_into = lambda out, x, group=None: out.copy_(
            x.reshape(out.shape))
    elif name == "mesh_no_copies":
        pmesh._reduce = lambda x, mesh, axis, op, kind: x
        same = (lambda x, mesh, axis, tiled=False:
                x if tiled else x[None])
        shmap.all_gather = surface_sharded.all_gather = same
    try:
        yield
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def timed(run):
    """(result, seconds) of run() by CUDA events."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def profiled(run, n):
    """run() under torch.profiler: figures a scan."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    c10d = [e for e in events if e.name.startswith("c10d::")]
    return dict(
        device_ms_a_scan=sum(e.time_range.elapsed_us() for e in dev)
        / 1e3 / n,
        host_launches_a_scan=sum(e.name in LAUNCH_CALLS
                                 for e in events) / n,
        c10d_calls_a_scan=len(c10d) / n,
        c10d_host_ms_a_scan=sum(e.time_range.elapsed_us()
                                for e in c10d) / 1e3 / n,
        nccl_device_events_a_scan=sum("nccl" in e.name.lower()
                                      for e in dev) / n)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    from chip_smoke import parity_config, parity_log
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM, city_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh
    from gridmap_slam_tpu_torch.parallel.sharded import (init_sharded,
                                                         make_sharded_step)
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        init_surface_sharded, make_surface_sharded_step)

    frames, _ = parity_log()
    pmesh.init_world("cuda")
    mesh = pmesh.make_mesh(1, device="cuda")
    ok = True
    for name, eng, make, init, single in (
            ("surface_sharded", SharedMapSLAM(city_config(), device="cuda"),
             make_surface_sharded_step, init_surface_sharded, "step_surface"),
            ("sharded", RBPF(parity_config(), device="cuda"),
             make_sharded_step, init_sharded, "step")):
        cfg = eng.config
        b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
        seq = [frame_at(b, i) for i in range(len(frames))]
        n = len(seq)

        def loop(step, start):
            def run():
                g = torch.Generator(device="cuda").manual_seed(SEED)
                st = start
                for f in seq:
                    st, _ = step(st, f, g)
                return st
            return run

        step = make(eng, mesh)
        start = init(eng, mesh)
        runs = {"single": loop(getattr(eng, single), eng.init())}
        runs.update({v: loop(step, start) for v in VARIANTS[1:]})
        rows = {v: {} for v in VARIANTS}
        secs = {v: [] for v in VARIANTS}
        finals = {}
        for r in range(1 + REPEATS):          # a warm-up, then in turns
            for v in VARIANTS:
                with variant(v):
                    finals[v], sec = timed(runs[v])
                if r:
                    secs[v].append(sec)
        for v in VARIANTS:
            with variant(v):
                rows[v] = profiled(runs[v], n)
            ms = sorted(1e3 * t / n for t in secs[v])
            rows[v].update(ms_a_scan=ms[len(ms) // 2],
                           ms_a_scan_min_max=[ms[0], ms[-1]],
                           scans_per_sec=1e3 / ms[len(ms) // 2])
            rows[v]["busy_pct"] = (100 * rows[v]["device_ms_a_scan"]
                                   / rows[v]["ms_a_scan"])
            if v != "single":
                rows[v]["bits_equal_mesh"] = bool(
                    torch.equal(finals[v].logodds, finals["mesh"].logodds)
                    and torch.equal(finals[v].poses, finals["mesh"].poses))
                ok = ok and rows[v]["bits_equal_mesh"]
        rows["mesh"]["bits_equal_single"] = bool(
            torch.equal(finals["mesh"].poses, finals["single"].poses))
        splits = {}
        for how, pick in (("median", lambda r: r["ms_a_scan"]),
                          ("min", lambda r: r["ms_a_scan_min_max"][0])):
            ms = {k: pick(r) for k, r in rows.items()}
            splits[how] = dict(
                extra_ms_a_scan=ms["mesh"] - ms["single"],
                nccl_calls_ms=ms["mesh"] - ms["mesh_no_nccl"],
                clones_and_allocations_ms=ms["mesh_no_nccl"]
                - ms["mesh_no_copies"],
                rest_of_the_step_ms=ms["mesh_no_copies"] - ms["single"],
                mesh_over_single=ms["single"] / ms["mesh"])
        print(json.dumps({"engine": name, "scans": n, "repeats": REPEATS,
                          "particles": cfg.num_particles, "split": splits,
                          **rows}), flush=True)
        del eng, step, start, finals, runs
        torch.cuda.empty_cache()
    pmesh.close_world()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "all_bits_equal": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
