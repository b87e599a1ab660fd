"""A cell's per-layer metrics on the card, from replays apart from the
timed ones.  The cell file names the metrics; each `<kind>.<part>` is read
here, a part being a kernel (kernels/) or a span (spans/).

- device_ms_a_scan.<kernel>: PROFILED_REPLAYS captured replays under
  torch.profiler.  A replay of a cell's log (no more scans than
  models/captured.CHUNK_SCANS) is one graph launch that holds the whole
  log (models/captured.Captured: `scans` scans), so the graph's counts are
  divided by the scans it holds.  The profiler's records of graph kernels
  can drop a few hundredths of a busy run, so a kernel's time a scan is the
  mean of its records times its nodes a scan (models/captured.
  graph_kernel_names, read from the graph itself).
- device_ms_a_scan.<span>: the same profiled replays.  While the graph was
  captured (the cell's first replay), SpanNodes noted the nodes each call
  of the span added; the graph's kernel nodes in the order they run
  (kernel_run_order) then say which of each launch's kernel records are
  the span's (launches_by_id), less those of a kernel the cell names: the
  mean over the launches whose records are the graph's kernels (align;
  the profiler may drop a record), over the scans a launch holds.  Not
  measured (nor the glue) where no launch is whole.  A conditional IF
  node (a resample gate) is one node of the chain: the records of its
  body that the profiler files under the launch stand there, known by
  their names (it gives others correlation ids of their own), or by the
  name of a kernel of another conditional body made in this process
  (models/captured.body_kernel_names): CUPTI names some body records after
  a body kernel of a graph captured earlier.
- device_ms_a_scan.glue: the rest of those replays' device time (every
  device record, the eager ones around the graph launches too), a scan.
- host_launches_a_scan: the runtime calls of those replays that put work
  on the card (kernels, copies, sets, graph launches), over their scans.
- device_busy_share: their device ms a scan over the timed replays' wall
  ms a scan.
- share_of_bound.<kernel>: the kernel's bounds (kernels/<kernel>.py) summed
  over the calls of one eager replay (its entry points wrapped while it
  runs), a scan, over its device ms a scan.
- The breakdown: the device operations of most time in the profiled
  replay, and its longest idle gaps on the card with what the host was
  doing then (the innermost host event around the gap).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import importlib

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models import captured
from . import kernels as K

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
TOP_OPS, TOP_GAPS = 8, 5
# replays of the log under the profiler: a graph launch holds the whole
# log, and a launch of which the profiler dropped a record is not whole
PROFILED_REPLAYS = 3
# device records that are no kernel node: copies and sets (a graph's copy
# node runs as the driver's memcpy32_post kernel)
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def parts(cell, kind: str) -> list:
    """The parts the cell's `<kind>.<part>` metrics name, in order."""
    return [m.split(".", 1)[1] for m in cell.per_layer
            if m.startswith(kind + ".")]


def _capture_nodes() -> set:
    """The nodes so far of the graph the current stream captures."""
    cu = ctypes.CDLL("libcuda.so.1")
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_size_t()
    captured._cu(cu, "cuStreamGetCaptureInfo_v2",
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                 ctypes.byref(status), ctypes.byref(cid), ctypes.byref(graph),
                 ctypes.byref(deps), ctypes.byref(n_deps))
    return {node for node, _ in captured._graph_nodes(cu, graph.value)}


class SpanNodes:
    """The graph nodes each span's calls add while a stream captures: with
    record() around the call that captures, `nodes[span]` holds them.
    Outside a capture the calls run as they are."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.nodes = {s.name: set() for s in self.spans}

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)
            before = _capture_nodes()
            out = fn(*args, **kw)
            self.nodes[name] |= _capture_nodes() - before
            return out
        return call

    @contextlib.contextmanager
    def record(self):
        saved = []
        try:
            for span in self.spans:
                mod = importlib.import_module(span.module)
                for attr in span.calls:
                    real = getattr(mod, attr)
                    saved.append((mod, attr, real))
                    setattr(mod, attr, self._wrap(span.name, real))
            yield self
        finally:
            for mod, attr, real in reversed(saved):
                setattr(mod, attr, real)


def demangle(name: str) -> str:
    """A kernel's mangled name as the profiler gives it (the C++ runtime's
    __cxa_demangle); the name itself where it is not mangled."""
    cxx = ctypes.CDLL("libstdc++.so.6")
    cxx.__cxa_demangle.restype = ctypes.c_void_p
    status = ctypes.c_int(0)
    out = cxx.__cxa_demangle(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name
    try:
        return ctypes.string_at(out).decode()
    finally:
        ctypes.CDLL(None).free(ctypes.c_void_p(out))


def kernel_run_order(graph_handle: int):
    """(function name, node) of every kernel node of a graph, in the order
    they run, and (None, node, the profiler's names of its body's kernels)
    of every conditional IF node; None where its nodes do not form one
    chain."""
    chain = captured.graph_chain(graph_handle)
    if chain is None:
        return None
    names = dict(captured.graph_kernel_nodes(graph_handle))
    bodies = dict(captured.graph_conditional_bodies(graph_handle))
    return [(None, node, [demangle(name) for b in bodies[node]
                          for name in captured.graph_kernel_names(b)])
            if node in bodies else (names[node], node)
            for node in chain if node in names or node in bodies]


def _dur_us(e) -> float:
    return e.time_range.elapsed_us()


def _profiled(run):
    """run() under torch.profiler, the card synchronized before and after:
    (the profiler's events on the card in start order, those on the
    host)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    return dev, host


def _is_kernel(e) -> bool:
    return not e.name.startswith(NOT_KERNELS)


def launches_by_id(dev, host, kernels):
    """The kernel records of each graph launch of a profiled replay, as
    (name, kernel or None, us), grouped by the correlation id of the host's
    cudaGraphLaunch that they share, in launch order."""
    starts = {e.id: e.time_range.start for e in host
              if e.name.startswith("cudaGraphLaunch")}
    runs = collections.defaultdict(list)
    for e in dev:
        if _is_kernel(e) and e.id in starts:
            runs[e.id].append((e.name, K.kernel_of(kernels, e.name),
                               _dur_us(e)))
    return [runs[i] for i in sorted(starts, key=starts.get)]


def align(run, order, kernels, foreign=frozenset(), why=None):
    """The kernel node of each of a launch's kernel records (`run`, as
    launches_by_id gives them) in kernel_run_order's `order`, None for a
    record of an IF node's body; None where the records are not the
    graph's kernels (the profiler dropped one).  The profiler files some
    of a body's kernels under the launch and gives others correlation ids
    of their own: those it files stand where the IF node does, in the
    body's order, and are known by their names, or by a name of `foreign`
    (the kernels of every conditional body made in this process, after
    one of which CUPTI may name a record) that is not the next kernel
    node's.  A kernel node's record is known by its kernel (kernels/), or
    by a name of `foreign`.  `why`, a list where given, gets where the
    records and the nodes first part (record index, node, record name)."""
    out, i = [], 0
    for at, entry in enumerate(order):
        if entry[0] is None:
            nxt = next((demangle(e[0]) for e in order[at + 1:]
                        if e[0] is not None), None)
            for name in entry[2]:
                if i < len(run) and (run[i][0] == name or (
                        run[i][0] in foreign and run[i][0] != nxt)):
                    out.append(None)
                    i += 1
            continue
        if i >= len(run) or (run[i][1] != K.kernel_of(kernels, entry[0])
                             and run[i][0] not in foreign):
            if why is not None:
                why.append(dict(record=i, node=demangle(entry[0])[:80],
                                got=run[i][0][:80] if i < len(run)
                                else None))
            return None
        out.append(entry)
        i += 1
    if i != len(run) and why is not None:
        why.append(dict(record=i, node=None, got=run[i][0][:80]))
    return out if i == len(run) else None


def _bounds_a_scan(kernels, eager, inputs, batch, n: int) -> dict:
    """Each kernel's bound ms a scan over one eager replay."""
    sums = collections.defaultdict(float)

    def wrap(kernel, entry, real):
        def call(*args, **kw):
            sums[kernel] += entry.bound(args, kw)[0]
            return real(*args, **kw)
        return call

    with K.patched(kernels, wrap):
        s0, g = inputs(0)
        eager(s0, batch, g)
        torch.cuda.synchronize()
    return {k: v / n for k, v in sums.items()}


def _breakdown(dev, host, n: int) -> dict:
    """The device operations of most time a scan, and the longest idle
    gaps between device events with the host's innermost event then."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        row = by_name[e.name[:80]]
        row[0] += _dur_us(e)
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    gaps, end = [], None
    for e in dev:
        if end is not None and e.time_range.start > end:
            gaps.append((e.time_range.start - end, end))
        end = (e.time_range.end if end is None
               else max(end, e.time_range.end))
    out = []
    for gap, at in sorted(gaps, reverse=True)[:TOP_GAPS]:
        mid = at + gap / 2
        around = [h for h in host
                  if h.time_range.start <= mid <= h.time_range.end]
        inner = min(around, key=_dur_us) if around else None
        out.append({"gap_ms": gap / 1e3,
                    "host": inner.name[:60] if inner else None})
    return {"top_device_ms_a_scan": [
                {"op": k, "ms": v[0] / n / 1e3, "count": v[1] / n}
                for k, v in top],
            "longest_idle_gaps": out}


def read_replays(kernels: dict, named, span_nodes: dict, nodes, order,
                 scans: int, dev, host, scans_run: int,
                 foreign=frozenset()) -> dict:
    """The per-layer readings a scan of profiled replays of one graph that
    holds `scans` scans (one launch a replay of the whole log): `nodes` the
    function names of its kernel nodes (its IF nodes' bodies' too),
    `order` kernel_run_order's or None, `span_nodes` each span's nodes;
    `dev` and `host` the profiler's records of replays of `scans_run`
    scans in all; `foreign` align's.  A graph's counts and a whole launch's records cover
    `scans` scans, and are divided by them; the records of all the
    replays, by scans_run."""
    in_graph = collections.Counter(K.kernel_of(kernels, name)
                                   for name in nodes)
    recs = [(e.name, K.kernel_of(kernels, e.name), _dur_us(e)) for e in dev
            if _is_kernel(e)]
    rec_us = collections.Counter()
    rec_n = collections.Counter()
    for _, grp, us in recs:
        rec_us[grp] += us
        rec_n[grp] += 1
    ms = {k: (rec_us[k] / rec_n[k] * in_graph[k] / scans / 1e3
              if rec_n[k] else None) for k in named}
    span_ms = dict.fromkeys(span_nodes)
    launches = (launches_by_id(dev, host, kernels)
                if order and span_nodes else [])
    why = []
    whole = [(run, nodes_of) for run in launches
             for nodes_of in [align(run, order, kernels, foreign, why)]
             if nodes_of is not None]
    if whole:           # a launch a log of `scans` scans
        for s, own in span_nodes.items():
            span_ms[s] = sum(
                run[i][2] for run, nodes_of in whole
                for i, e in enumerate(nodes_of)
                if e is not None and e[1] in own
                and K.kernel_of(kernels, e[0]) not in named
            ) / len(whole) / scans / 1e3
    out = {f"device_ms_a_scan.{k}": v for k, v in ms.items()}
    out.update({f"device_ms_a_scan.{s}": v for s, v in span_ms.items()})
    parts_ms = list(ms.values()) + list(span_ms.values())
    total = sum(_dur_us(e) for e in dev) / scans_run / 1e3
    out.update({
        "device_ms_a_scan.glue": (None if None in parts_ms
                                  else total - sum(parts_ms)),
        "device_ms_a_scan.total": total,
        "host_launches_a_scan": sum(e.name in LAUNCH_CALLS
                                    for e in host) / scans_run,
        "kernels_a_scan": {**{k: in_graph[k] / scans for k in named},
                           "all": len(nodes) / scans},
        "scans_in_graph": scans,
        "profiler_records_a_scan": {k: rec_n[k] / scans_run for k in named},
        "graph_is_a_chain": order is not None,
        "launches_whole": [len(whole), len(launches)],
        "launches_not_whole_at": why,
        "launch_records": sorted({len(run) for run in launches}),
        "kernels_run": sum(e[0] is not None for e in order or ()),
    })
    return out


def measure(cell, kernels: dict, span_nodes: SpanNodes, replay, eager,
            batch, inputs, n: int, wall_s_a_scan: float):
    """(per-layer metrics, breakdown) of a cell whose captured replay
    `replay` has run (its capture recorded by span_nodes), from
    PROFILED_REPLAYS replays of its log of n scans under the profiler
    (read_replays): the cell's metrics, and `kernels_a_scan` and
    `profiler_records_a_scan`."""
    named = [k for k in dict.fromkeys(parts(cell, "device_ms_a_scan")
                                      + parts(cell, "share_of_bound"))
             if k in kernels]
    spans = {s: span_nodes.nodes[s] for s in parts(cell, "device_ms_a_scan")
             if s in span_nodes.nodes}
    cap = replay.captured
    graph = cap.graph.raw_cuda_graph()
    nodes = [name for _, name in captured.graph_kernel_nodes(graph)]
    order = kernel_run_order(graph)

    s0, g = inputs(0)
    dev, host = _profiled(lambda: [replay(s0, batch, g)
                                   for _ in range(PROFILED_REPLAYS)])
    scans_run = n * PROFILED_REPLAYS
    foreign = frozenset(demangle(name)
                        for name in captured.body_kernel_names)
    out = read_replays(kernels, named, spans, nodes, order, cap.scans, dev,
                       host, scans_run, foreign)
    out["device_busy_share"] = (out["device_ms_a_scan.total"]
                                / (wall_s_a_scan * 1e3))
    bound_ms = _bounds_a_scan([kernels[k] for k in named], eager, inputs,
                              batch, n)
    for k in named:
        v = out[f"device_ms_a_scan.{k}"]
        if v and k in bound_ms:
            out[f"bound_ms_a_scan.{k}"] = bound_ms[k]
            out[f"share_of_bound.{k}"] = bound_ms[k] / v
    return out, _breakdown(dev, host, scans_run)
