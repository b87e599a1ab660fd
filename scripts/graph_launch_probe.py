"""What launching one large CUDA graph costs the host and the card.

A captured replay (gridmap_slam_tpu_torch/models/captured.py) launches one
graph of a whole log: ~5 600 kernel nodes at the parity preset's 12 scans,
~40 000 at `chip`'s.  This script captures chains of N small kernels (an
in-place add on a 4096-float tensor, N = 500, 5 000, 40 000), as a graph
of N nodes and as N / CHUNK graphs of CHUNK nodes, and for each form,
after warm-up replays, times REPS replays: the host's seconds inside the
launch calls (no sync), the wall seconds to the end of the work
(torch.cuda.synchronize), and the card's seconds (CUDA events around the
replays).  The same with a copy or a set node every COPY_EVERY nodes.
Each form runs twice as captured, then twice after cuGraphUpload of its
executable graphs into the stream that launches them (the driver API,
through ctypes).  Then the graph of the parity and the mega preset's
12-scan log (the replays' own), its launch alone and the replay call,
timed the same way, then, launched into the default stream, a stream of
its own and one of the highest priority in turns, timed again and six of
its launches under torch.profiler: each launch's records' span on the
card, their sum and the idle time between them, and that idle time by the
record after it.  One JSON line a case;
nvidia-smi's name, power limit and driver version first.

Usage: python scripts/graph_launch_probe.py            (needs a GPU; ~60 s)
       python scripts/graph_launch_probe.py --engines [--upload]
                                    (the presets' graphs alone, uploaded)
       python scripts/graph_launch_probe.py --patterns
                 (parity's log graph against its one-scan graph 12 times)
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

SIZES = (500, 5_000, 40_000)
CHUNK = 465             # the parity preset's kernel nodes a scan
COPY_EVERY = 33         # a copy or a set node, as ~7 + 7 of parity's scan
REPS = 20


def capture(x, n: int, copy_every: int = 0):
    """A graph of n in-place adds on x, captured on a side stream; with
    copy_every, every copy_every-th node a copy of x into a buffer of its
    own (a memcpy node) or, in turn, the buffer zeroed (a memset node)."""
    y = torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for i in range(n):
            if copy_every and i % copy_every == copy_every - 1:
                if (i // copy_every) % 2:
                    y.zero_()
                else:
                    y.copy_(x)
            else:
                x.add_(1.0)
    g.buffer = y
    return g


def upload(graphs) -> None:
    cu = ctypes.CDLL("libcuda.so.1")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for g in graphs:
        code = cu.cuGraphUpload(ctypes.c_void_p(g.raw_cuda_graph_exec()),
                                stream)
        if code != 0:
            raise RuntimeError(f"cuGraphUpload failed with CUresult {code}")


def timed(graphs) -> dict:
    """REPS replays of the graphs in order, each replay ended by a sync."""
    for _ in range(3):
        for g in graphs:
            g.replay()
    torch.cuda.synchronize()
    host = wall = dev = 0.0
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for g in graphs:
            g.replay()
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host += t1 - t0
        wall += t2 - t0
        dev += start.elapsed_time(end) / 1e3
    return dict(host_ms_a_replay=host / REPS * 1e3,
                wall_ms_a_replay=wall / REPS * 1e3,
                events_ms_a_replay=dev / REPS * 1e3)


def gaps(cap, reps: int = 6) -> dict:
    """`reps` launches of a captured log graph under torch.profiler, one
    at a time: for each, its records' span on the card, their sum and the
    idle time between them, and over all, that idle time summed by the
    record that follows it (its name cut to 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cap.graph.replay()
            torch.cuda.synchronize()
    events = prof.events()
    launches = {e.id for e in events
                if e.name.startswith("cudaGraphLaunch")}
    runs, by_next = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.id in launches:
            runs.setdefault(e.id, []).append(e)
    rows = []
    for recs in runs.values():
        recs.sort(key=lambda e: e.time_range.start)
        busy = sum(e.time_range.elapsed_us() for e in recs)
        idle, end = 0.0, recs[0].time_range.end
        for e in recs[1:]:
            gap = max(0.0, e.time_range.start - end)
            idle += gap
            key = e.name[:60]
            by_next[key] = by_next.get(key, 0.0) + gap
            end = max(end, e.time_range.end)
        rows.append(dict(records=len(recs), busy_ms=busy / 1e3,
                         idle_ms=idle / 1e3,
                         span_ms=(end - recs[0].time_range.start) / 1e3))
    top = sorted(by_next.items(), key=lambda kv: -kv[1])[:8]
    return dict(launches=rows, idle_ms_by_next_record=[
        [k, v / 1e3 / max(len(rows), 1)] for k, v in top])


def engines(upload_first: bool = False) -> None:
    """The graph of a whole log of the parity and mega presets
    (RBPF.replay_jit, SharedMapSLAM.replay_surface_jit on the 12-scan log),
    timed as the chains are: its launch alone, then the replay call; with
    upload_first, after cuGraphUpload of the graph."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, SlamConfig,
                                        mega_config)
    from gridmap_slam_tpu_torch.config import MapConfig
    from gridmap_slam_tpu_torch.io import frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     default_world,
                                                     simulate_log,
                                                     square_path_controls)

    frames, _ = simulate_log(default_world(), square_path_controls(12),
                             params=SimParams(beams_per_rev=180), seed=0)
    for name, eng, fn in (
            ("parity", RBPF(SlamConfig(
                num_particles=500, max_beams=192, particle_chunk=250,
                map=MapConfig(width_m=6.0, height_m=6.0, resolution=0.05,
                              origin=(-3.0, -3.0))), device="cuda"),
             "replay_jit"),
            ("mega", SharedMapSLAM(mega_config(), device="cuda"),
             "replay_surface_jit")):
        cfg = eng.config
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device="cuda")
        replay = getattr(eng, fn)()
        gen = torch.Generator(device="cuda").manual_seed(0)
        s0 = eng.init()
        replay(s0, batch, gen)
        cap = replay.captured
        if upload_first:
            upload([cap.graph])

        def call():
            replay(s0, batch, gen)
        rows = dict(launch=timed([cap.graph]),
                    call=timed([SimpleNamespace(replay=call)]))
        print(json.dumps(dict(engine=name, nodes=cap.node_types(),
                              uploaded=upload_first, **rows)), flush=True)
        # the graph launched into the current (default) stream, a stream of
        # its own and one of the highest priority, in turns
        streams = {"default": torch.cuda.current_stream(),
                   "side": torch.cuda.Stream(),
                   "high": torch.cuda.Stream(priority=-1)}
        for which in ("default", "side", "high", "high", "side", "default"):
            stream = streams[which]
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                row = dict(launch=timed([cap.graph]), gaps=gaps(cap))
            torch.cuda.current_stream().wait_stream(stream)
            print(json.dumps(dict(engine=name, stream=which, **row)),
                  flush=True)
        del replay, cap, eng


def patterns(turns: int = 6, reps: int = 40) -> None:
    """The parity preset's 12 scans as its log's graph launched once, and
    as the same replay's one-scan graph launched 12 times (the graph a scan
    before a log was one graph; it reads frame 0 each time, the same work),
    in turns: the card's ms (CUDA events) a 12-scan replay, each replay
    ended by a sync, the mean of `reps`."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gridmap_slam_tpu_torch import RBPF, SlamConfig
    from gridmap_slam_tpu_torch.config import MapConfig
    from gridmap_slam_tpu_torch.io import frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     default_world,
                                                     simulate_log,
                                                     square_path_controls)
    from gridmap_slam_tpu_torch.models.captured import tree_map

    frames, _ = simulate_log(default_world(), square_path_controls(12),
                             params=SimParams(beams_per_rev=180), seed=0)
    eng = RBPF(SlamConfig(num_particles=500, max_beams=192,
                          particle_chunk=250,
                          map=MapConfig(width_m=6.0, height_m=6.0,
                                        resolution=0.05,
                                        origin=(-3.0, -3.0))), device="cuda")
    batch = frames_to_device(frames, 192, eng.config.sensor.max_range,
                             device="cuda")
    replay = eng.replay_jit()
    gen = torch.Generator(device="cuda").manual_seed(0)
    replay(eng.init(), batch, gen)       # the log's graph, then beside it
    replay(eng.init(), tree_map(lambda x: x[:1], batch), gen)
    cap = replay.captured
    forms = {"log_graph": [cap.graphs[(12, False)]],
             "scan_graph_x12": [cap.graphs[(1, False)]] * 12}
    for i in range(turns):
        for form in (("log_graph", "scan_graph_x12") if i % 2 == 0
                     else ("scan_graph_x12", "log_graph")):
            row = timed(forms[form])
            print(json.dumps(dict(turn=i, form=form,
                                  events_ms_a_replay=row[
                                      "events_ms_a_replay"],
                                  host_ms_a_replay=row["host_ms_a_replay"])),
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    if "--engines" in sys.argv:
        engines("--upload" in sys.argv)
        return 0
    if "--patterns" in sys.argv:
        patterns()
        return 0
    x = torch.zeros(4096, device="cuda")
    for n in SIZES:
        forms = {"one_graph": [capture(x, n)],
                 "chunks": [capture(x, CHUNK) for _ in range(n // CHUNK)],
                 "one_graph_with_copies": [capture(x, n, COPY_EVERY)],
                 "chunks_with_copies": [capture(x, CHUNK, COPY_EVERY)
                                        for _ in range(n // CHUNK)]}
        for form, graphs in forms.items():
            rows = {}
            for turn in ("captured", "captured_again", "uploaded",
                         "uploaded_again"):
                if turn == "uploaded":
                    upload(graphs)
                rows[turn] = timed(graphs)
            print(json.dumps(dict(nodes=n, form=form, graphs=len(graphs),
                                  **rows)), flush=True)
        del forms
    engines()
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
