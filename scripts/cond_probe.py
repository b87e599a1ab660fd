"""CUDA-graph conditional nodes as models/captured.cond makes them, probed
on one card.

Prints the card's name and power limit, torch's and CUDA's versions, the
CUDA driver's, whether torch has CUDAGraph.get_currently_capturing_graph and
begin_capture_to_if_node (PyTorch's own route to an IF node) and which of
the CUDA driver's calls captured.conditional_capture needs it exports (and
cuGraphNodeGetParams).  Then, at P particles, a graph of SCANS scans, each:
log-weights drawn from a registered generator, a gate on the card (Neff <
FRACTION P, as the filters' resample gate), the gate through
captured.cond (body: the systematic-resampling indices into a buffer that
holds the identity), and a gather of a (P, 64) table at those indices.
Checks that every replay gives, scan by scan, the indices and rows of the
same loop run eagerly with the gate read on the host, and leaves the
generator where that loop leaves it.  Reads the graph's nodes by type,
its conditional nodes and the kernels in their bodies
(captured.graph_conditional_bodies, graph_kernel_nodes) and the pool's
reserved bytes the capture added.  Then device ms a scan (CUDA events
over REPS replays) of the graph with the gate never firing, always
firing, and of the select form (captured.cond's eager form, captured:
the indices every scan); and what torch.profiler records of one replay
(kernel records against the graph's top-level kernels, with and without
the bodies of the scans that fired).

Usage (needs a GPU; ~1 min):  python scripts/cond_probe.py [--particles N]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gridmap_slam_tpu_torch.models import captured  # noqa: E402
from gridmap_slam_tpu_torch.ops.resample import (neff,  # noqa: E402
                                                 systematic_indices)

SCANS = 16
FRACTION = 0.5
REPS = 20
WIDTH = 64


def say(**fields):
    print(json.dumps(fields), flush=True)


def probe_api() -> dict:
    cu = ctypes.CDLL("libcuda.so.1")
    version = ctypes.c_int()
    cu.cuDriverGetVersion(ctypes.byref(version))
    g = torch.cuda.CUDAGraph
    return dict(torch=torch.__version__, cuda=torch.version.cuda,
                cuda_driver=version.value,
                get_currently_capturing_graph=hasattr(
                    g, "get_currently_capturing_graph"),
                begin_capture_to_if_node=hasattr(
                    g, "begin_capture_to_if_node"),
                driver_calls={f: hasattr(cu, f) for f in (
                    "cuGraphNodeGetParams", "cuGraphAddNode",
                    "cuGraphConditionalHandleCreate",
                    "cuGraphKernelNodeCopyAttributes",
                    "cuStreamGetCaptureInfo_v2")})


class Probe:
    """The static buffers and one scan of the probe's graph."""

    def __init__(self, p: int, spread: float, device="cuda"):
        self.p, self.spread, self.dev = p, spread, device
        self.gen = torch.Generator(device=device)
        self.table = torch.randn((p, WIDTH), device=device,
                                 generator=self.gen.manual_seed(0))
        self.idx = torch.empty((SCANS, p), dtype=torch.int64, device=device)
        self.rows = torch.empty((SCANS, p, WIDTH), device=device)
        self.fired = torch.empty((SCANS,), dtype=torch.bool, device=device)

    def scan(self, i: int, form: str):
        p, dev = self.p, self.dev
        # Neff / P is about exp(-scale^2): scales 0.5, 1 and 1.5 times the
        # spread, so that at spreads near 1 some scans fire and some not
        scale = self.spread * (0.5 + 0.5 * (i % 3))
        lw = scale * torch.randn((p,), generator=self.gen, device=dev)
        u0 = torch.rand((), generator=self.gen, device=dev) / p
        pred = neff(lw) < FRACTION * p
        idx = self.idx[i]
        idx.copy_(torch.arange(p, device=dev))

        def body():
            idx.copy_(systematic_indices(lw, u0))

        if form == "cond":
            captured.cond(pred, body, [idx])
        elif form == "select":
            captured.cond(pred, body, [idx], select=True)
        else:                           # "host": the gate read on the host
            if bool(pred):
                body()
        torch.index_select(self.table, 0, idx, out=self.rows[i])
        self.fired[i].copy_(pred)

    def run(self, form: str):
        for i in range(SCANS):
            self.scan(i, form)

    def capture(self, form: str, pool=None):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.run("select")
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(self.gen)
        reserved = torch.cuda.memory_reserved()
        with captured.conditional_capture(graph):
            with torch.cuda.graph(graph, pool=pool, stream=side):
                self.run(form)
        graph.instantiate()
        torch.cuda.synchronize()
        return graph, torch.cuda.memory_reserved() - reserved


def outputs(pr: Probe):
    return pr.idx.clone(), pr.rows.clone(), pr.fired.clone()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--cpu-check", action="store_true",
                    help="the forms against each other on the CPU, no card")
    args = ap.parse_args()
    if args.cpu_check:
        got = {}
        for form in ("host", "cond", "select"):
            pr = Probe(args.particles, 1.0, device="cpu")
            pr.gen.manual_seed(0)
            pr.run(form)
            got[form] = outputs(pr)
        same = all(torch.equal(a, b) for f in ("cond", "select")
                   for a, b in zip(got[f], got["host"]))
        say(phase="cpu_check", fired=int(got["host"][2].sum()), same=same)
        sys.exit(0 if same else 1)
    if not torch.cuda.is_available():
        sys.exit("cond_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    api = probe_api()
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True).stdout
    say(phase="api", nvcc=nvcc.strip().splitlines()[-1:], **api)
    from gridmap_slam_tpu_torch.ops.cuda import _build
    _build.library()
    p = args.particles
    rows = {}
    # spreads whose gate fires on some scans and not on others
    for spread in (0.8, 1.0):
        pr = Probe(p, spread)
        graph, grew = pr.capture("cond")
        conds = captured.graph_conditional_bodies(graph.raw_cuda_graph())
        in_bodies = [len(captured.graph_kernel_nodes(b))
                     for _, bs in conds for b in bs]
        checks = []
        for seed in (1, 2, 3):
            pr.gen.manual_seed(seed)
            graph.replay()
            got = outputs(pr)
            next_g = torch.rand(4, generator=pr.gen, device="cuda")
            pr.gen.manual_seed(seed)
            pr.run("host")
            want = outputs(pr)
            next_h = torch.rand(4, generator=pr.gen, device="cuda")
            checks.append(dict(
                seed=seed, fired=int(want[2].sum()),
                equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                next_draw_equal=torch.equal(next_g, next_h)))
        # what torch.profiler (CUPTI) records of one replay: the top-level
        # kernels, and the bodies' of the scans that fired or not
        pr.gen.manual_seed(1)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        recs = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset", "memcpy",
                                           "memset"))]
        top = captured.graph_node_types(graph.raw_cuda_graph())["kernel"]
        profiled = dict(kernel_records=len(recs), top_level_kernels=top,
                        with_fired_bodies=top + in_bodies[0] * int(
                            pr.fired.sum()),
                        correlation_ids=len({e.id for e in recs}))
        times = {}
        for form in ("cond", "select"):
            g = graph if form == "cond" else pr.capture("select")[0]
            for fire in ((True, False) if form == "cond" else (None,)):
                saved = pr.spread
                if fire is not None:    # a spread that always / never fires
                    pr.spread = 3.0 if fire else 0.01
                    g = pr.capture("cond")[0]
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                g.replay()
                start.record()
                for _ in range(REPS):
                    g.replay()
                end.record()
                torch.cuda.synchronize()
                key = form if fire is None else f"cond_fires_{fire}"
                times[key] = dict(
                    ms_a_scan=start.elapsed_time(end) / REPS / SCANS,
                    fired_last=int(pr.fired.sum()))
                pr.spread = saved
        rows[spread] = dict(
            particles=p, scans=SCANS,
            nodes_by_type=captured.graph_node_types(graph.raw_cuda_graph()),
            conditional_nodes=len(conds),
            bodies_a_node=sorted({len(bs) for _, bs in conds}),
            kernels_in_bodies=in_bodies[:2], all_kernel_nodes=len(
                captured.graph_kernel_nodes(graph.raw_cuda_graph())),
            graph_is_a_chain=captured.graph_chain(
                graph.raw_cuda_graph()) is not None,
            replays=checks, profiler=profiled,
            reserved_bytes_grown=grew,
            device_ms=times)
        say(phase="graph", spread=spread, **rows[spread])
    ok = all(c["equal"] and c["next_draw_equal"]
             for r in rows.values() for c in r["replays"])
    say(phase="summary", ok=ok)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
