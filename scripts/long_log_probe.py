"""A long log through the captured replay, on the card: the eager loop, one
graph of the whole log, and graphs of CHUNK_SCANS scans launched in turn.

Two engines (--engine):

- `rbpf` (default): the RBPF at --particles in chunks of --chunk replays
  the 216 scans of maps/grand_tour_216.rec on chip_smoke.py's posegraph
  map and beam slots (14 x 14 m at 5 cm, 360 slots);
- `mega`: SharedMapSLAM in surface mode at config.mega_config() (1M
  particles, or --particles) replays the 40 scans of
  maps/room_loop_40.rec, as chip_smoke.py's `mega room_loop_40` path.

Three forms of one replay:

- `eager`: the engine's eager replay (RBPF.replay, SharedMapSLAM.
  replay_surface);
- `one_graph`: its captured replay (replay_jit, replay_surface_jit) with
  models/captured.CHUNK_SCANS set past the log's length while it runs:
  one graph of all the scans, one launch (the design before chunks);
- `chunked`: the captured replay as it is: ceil(n / CHUNK_SCANS) launches
  of the graph of CHUNK_SCANS scans and of the rest.

For each captured form it prints one JSON line: each graph's kernel nodes
(read from the graph), capture and instantiation seconds summed over its
graphs, the first call's seconds, the host's resident memory growth over
the first call (VmRSS of /proc/self/status), the device bytes of the
replay's graph memory pool (the caching allocator's segments in it) and
the growth of reserved device memory over the first call, graph launches
a call, and whether its first call gave the eager run's bits in every
state and info field and the generator's next draw.  Then the warm calls'
scans/s of every form, timed by CUDA events in turns (eager once, each
captured form --reps times), and last one JSON line of the results with
the card's name and power limit.

Usage (on the card; ~4 minutes at the defaults):
    python scripts/long_log_probe.py [--engine rbpf] [--particles 10000] \\
        [--chunk 500] [--scans 216] [--reps 3] [--forms one_graph,chunked]
    python scripts/long_log_probe.py --particles 200 --chunk 0 --reps 10
    python scripts/long_log_probe.py --engine mega --reps 10
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM,  # noqa: E402
                                    SlamConfig, mega_config)
from gridmap_slam_tpu_torch.config import MapConfig  # noqa: E402
from gridmap_slam_tpu_torch.io import (frames_to_device,  # noqa: E402
                                       read_recording)
from gridmap_slam_tpu_torch.models import captured  # noqa: E402

LOGS = {"rbpf": ROOT / "maps" / "grand_tour_216.rec",
        "mega": ROOT / "maps" / "room_loop_40.rec"}
SEED = 0
FORMS = ("one_graph", "chunked")


def rss_bytes() -> int:
    """The process's resident set (VmRSS), in bytes."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def pool_bytes(pool) -> int | None:
    """The bytes of the caching allocator's segments in graph memory pool
    `pool`; None where the snapshot does not name the pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


@contextlib.contextmanager
def chunk_scans(n: int | None):
    """models/captured.CHUNK_SCANS set to n while the context lasts (None:
    as it is)."""
    saved = captured.CHUNK_SCANS
    if n is not None:
        captured.CHUNK_SCANS = n
    try:
        yield
    finally:
        captured.CHUNK_SCANS = saved


def timed(fn):
    """(result, seconds) of fn() on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def differing(a, b) -> list:
    """The fields of two states or infos whose tensors differ in bits."""
    return [f.name for f in dataclasses.fields(a)
            if not (getattr(a, f.name).dtype == getattr(b, f.name).dtype
                    and torch.equal(getattr(a, f.name), getattr(b, f.name)))]


def next_draw(g):
    return torch.randn(8, generator=g, device="cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="rbpf", choices=sorted(LOGS))
    ap.add_argument("--particles", type=int, default=0,
                    help="particles (default: rbpf 10 000, mega 1M)")
    ap.add_argument("--chunk", type=int, default=500,
                    help="the RBPF's particle chunk (0: none)")
    ap.add_argument("--scans", type=int, default=216)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--forms", default=",".join(FORMS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    forms = [f for f in args.forms.split(",") if f]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    frames = read_recording(str(LOGS[args.engine]))[:args.scans]
    n = len(frames)
    if args.engine == "rbpf":
        cfg = SlamConfig(num_particles=args.particles or 10_000,
                         max_beams=360, particle_chunk=args.chunk,
                         map=MapConfig(width_m=14.0, height_m=14.0,
                                       resolution=0.05,
                                       origin=(-7.0, -7.0)))
        eng = RBPF(cfg, device="cuda")
        replay_eager, replay_jit = eng.replay, eng.replay_jit
    else:
        cfg = mega_config()
        if args.particles:
            cfg = cfg.replace(num_particles=args.particles)
        eng = SharedMapSLAM(cfg, device="cuda")
        replay_eager, replay_jit = (eng.replay_surface,
                                    eng.replay_surface_jit)
    particles = cfg.num_particles
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def eager():
        return replay_eager(eng.init(), batch, gen())

    g = gen()
    (st_e, inf_e), first_eager_s = timed(
        lambda: replay_eager(eng.init(), batch, g))
    next_e = next_draw(g)
    print(json.dumps({"form": "eager", "engine": args.engine, "scans": n,
                      "particles": particles,
                      "first_call_s": first_eager_s}), flush=True)

    limits = {"one_graph": n + 1, "chunked": None}
    spent = []          # each capture's seconds (capture and instantiation)
    real_capture = captured.Graphed.capture

    def capture(self, *a, **kw):
        real_capture(self, *a, **kw)
        spent.append(self.capture_seconds)
    captured.Graphed.capture = capture
    replays, rows = {}, {}
    for form in forms:
        replay = replay_jit()
        torch.cuda.synchronize()
        rss0, res0 = rss_bytes(), torch.cuda.memory_reserved()
        g = gen()
        spent.clear()
        with chunk_scans(limits[form]):
            (st_c, inf_c), first_s = timed(
                lambda: replay(eng.init(), batch, g))
        next_c = next_draw(g)
        cap = replay.captured
        graphs = {m: len(graph_names) for m, graph_names in (
            (key[0], captured.graph_kernel_names(gr.raw_cuda_graph()))
            for key, gr in cap.graphs.items())}
        rows[form] = dict(
            form=form, engine=args.engine, scans=n, particles=particles,
            chunk_scans=limits[form] or captured.CHUNK_SCANS,
            launches_a_call=cap.launches,
            kernel_nodes_by_graph_scans=graphs,
            largest_graph_kernel_nodes=max(graphs.values()),
            capture_seconds=sum(spent), captures=cap.captures,
            first_call_s=first_s,
            host_rss_growth_bytes=rss_bytes() - rss0,
            graph_pool_bytes=pool_bytes(cap._pool),
            reserved_growth_bytes=torch.cuda.memory_reserved() - res0,
            bits_differing={"state": differing(st_e, st_c),
                            "infos": differing(inf_e, inf_c),
                            "next_draw": not torch.equal(next_e, next_c)})
        print(json.dumps(rows[form]), flush=True)
        replays[form] = replay
        del st_c, inf_c

    _, eager_s = timed(eager)
    rates = {"eager": [n / eager_s]}
    for _ in range(args.reps):
        for form in forms:
            g = gen()
            with chunk_scans(limits[form]):
                _, sec = timed(lambda: replays[form](eng.init(), batch, g))
            rates.setdefault(form, []).append(n / sec)
    print(json.dumps({"scans_per_sec": rates}), flush=True)
    ok = all(not any(r["bits_differing"].values()) for r in rows.values())
    if "chunked" in rows:
        big = rows["chunked"]["largest_graph_kernel_nodes"]
        one = rows.get("one_graph", {}).get("largest_graph_kernel_nodes")
        ok = ok and rows["chunked"]["launches_a_call"] == -(
            -n // captured.CHUNK_SCANS)
        ok = ok and (one is None or big < one or n <= captured.CHUNK_SCANS)
    print(json.dumps({"ok": ok, "engine": args.engine, "scans": n,
                      "particles": particles, "nvidia_smi": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "scans_per_sec_median": {
                          k: float(np.median(v)) for k, v in rates.items()},
                      **{k: {kk: v[kk] for kk in (
                          "largest_graph_kernel_nodes", "capture_seconds",
                          "first_call_s", "host_rss_growth_bytes",
                          "graph_pool_bytes", "launches_a_call")}
                         for k, v in rows.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
