"""What holds a captured replay's peak device memory: the allocations live
at the peak, by the line of the package that made them.

For a path of scripts/cond_ab.py (its `setup`: the engine, its captured
replay and log), the process builds the kernels of its tree (this one, or
--root: an unpacked earlier commit), records the CUDA caching allocator's
history (torch.cuda.memory._record_memory_history, Python stacks) over the
two calls cond_ab.py measures (warm-up and capture, then a warm replay),
and replays the trace: bytes allocated since the recording began, after
each allocation and free.  It prints one JSON line: the peak as cond_ab.py
reads it (max_memory_allocated after reset_peak_memory_stats, less what was
allocated before), the trace's own peak, and the allocations live at the
trace's peak grouped by the innermost frame in gridmap_slam_tpu_torch
(file:line function, with the next package frame out), largest first.

Usage (needs a GPU; ~1 min a path with the build):
    python scripts/peak_probe.py [--root DIR] [--paths city,mega]
Run it once for each tree, in turn, to compare two commits.
"""

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "gridmap_slam_tpu_torch"
TOP = 30


def _where(frames) -> str:
    """The innermost two frames of the package among `frames` (innermost
    first), as file:line function."""
    ours = [f for f in frames if PACKAGE in f["filename"]
            and "/bench/" not in f["filename"]]
    return " <- ".join(
        f"{f['filename'].split(PACKAGE + '/')[-1]}:{f['line']} {f['name']}"
        for f in ours[:2]) or "outside the package"


def live_at_peak(trace) -> tuple:
    """(peak bytes, {where: [bytes, count]} of the allocations live then)
    of one device's allocator trace, counted from its first event (frees
    of blocks allocated before it are left out)."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        action = ev["action"]
        if action == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif action in ("free_requested", "free_completed"):
            block = live.pop(ev["addr"], None)
            if block is not None:
                cur -= block[0]
    groups = collections.defaultdict(lambda: [0, 0])
    for size, frames in at_peak.values():
        g = groups[_where(frames)]
        g[0] += size
        g[1] += 1
    return peak, dict(groups)


def probe(name: str, tree: Path) -> dict:
    import torch
    import cond_ab

    eng, init, replay, frames, n, _ = cond_ab.setup(name)

    def gen():
        return torch.Generator(device="cuda").manual_seed(cond_ab.SEED)

    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="all", stacks="python", max_entries=4_000_000)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    replay(init(), frames, gen())               # warm-up and capture
    replay(init(), frames, gen())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    trace_peak, groups = live_at_peak(trace)
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(path=name, tree=str(tree), scans=n, peak_bytes=peak,
                trace_peak_bytes=trace_peak, events=len(trace),
                live_at_peak=[dict(where=w, bytes=b, count=c)
                              for w, (b, c) in top])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="an unpacked earlier commit")
    ap.add_argument("--paths", default="city")
    args = ap.parse_args()
    tree = Path(args.root or ROOT).resolve()
    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT / "scripts"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("peak_probe: no CUDA device")
    from gridmap_slam_tpu_torch.ops.cuda import _build
    _build.library()
    for name in args.paths.split(","):
        print(json.dumps(probe(name, tree)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
