"""Whole-log replays: the eager scan and its captured form, CUDA graphs of
at most CHUNK_SCANS scans launched in turn.

Counterpart of the JAX package's `jax.lax.scan` of a step over a stacked
`Frame` batch (models/rbpf.py:293-306) and of `jax.jit(..., donate_argnums=
(0,))` around it: one dispatch for the whole log.  The engines share it.

A step here is `step(state, frame, draws, out) -> (state, info)`: `draws`
are one scan's random draws, and `out`, when given, is a state whose
tensors receive the new state (the step then returns `out`).  The state
may be `out` itself: every engine writes a field of `out` only after its
last read of that field.

`scan` is the eager loop: frame i of the batch, scan i's draws (drawn from
the generator in the calls and order of the eager step, or taken from
`draws` stacked with a leading frame axis), and the infos stacked along a
leading frame axis (`stack_steps`).

`Captured` is the same loop with a whole log of n scans replayed as
ceil(n / CHUNK_SCANS) launches of at most two graphs: a log of n <=
CHUNK_SCANS scans is one graph of n scans and one launch; a longer one
launches the graph of CHUNK_SCANS scans floor(n / CHUNK_SCANS) times,
then the graph of the n mod CHUNK_SCANS scans left once.  So a graph
holds at most CHUNK_SCANS scans' nodes whatever the log's length (JAX
compiles one scan body for any length; a graph unrolled over a log of
thousands of scans would take seconds to capture and host memory to
hold).  It keeps static buffers: the state, the frames of up to
`capacity` scans, one scan's draws, injected draws of up to `capacity`
scans (where a call gives them), the stacked infos and a scan counter
on the device; `capacity` is min(n, CHUNK_SCANS).  A scan of a graph
reads the frame at the counter, draws its draws into the static draws
from a generator the `Captured` owns (the eager step's calls, in its
order; injected draws are read at the counter instead), runs the step
with `out=` the static state (the resample gather writes straight into
it, so a scan copies no map beyond what the eager step copies), writes
the info at the counter and adds one to it; the graph zeroes the counter
first and holds its m scans in a row.  Before each launch the chunk's
frames (and injected draws) are copied into the buffers, after it the
chunk's infos out of them; the state stays in its buffer from one launch
to the next.  The owned generator is registered with every graph
(CUDAGraph.register_generator_state): a launch draws from the Philox
seed and offset the generator holds when it starts, and advances the
offset by the graph's draws, so chunk i + 1 draws on where chunk i
stopped.  Before the first launch the caller's generator state (or the
default generator's, where the caller gives none) is handed to the owned
generator, after the last handed back, so a captured run gives the eager
run's bits in every draw and leaves the caller's generator where the
eager run leaves it (scripts/graph_rng_probe.py checks this on the card).
A replay of n <= CHUNK_SCANS scans then launches from the host: the
state and frames copied in, the owned generator's seed and offset set,
one graph launch, and the infos copied out.

On a CUDA engine a graph is captured at the first call that needs its
length (and, injected draws or not, for each), before the call's first
launch: a `Captured` holds at most 2 CHUNK_SCANS graphs.  Every graph is
dropped when the shapes change or a log of more scans than the buffers
hold comes (the buffers are made anew, of min(n, CHUNK_SCANS) scans).
Before a capture, warm-up scans of the one-scan body on a side stream
build the kernel library and fill every cache a step reads (the kernels'
launch plans, the matcher's offsets, cuFFT's plans, cuBLAS's workspace);
capture runs on that same stream.  The graphs of one `Captured` share one
memory pool: no tensor a capture allocates outlives it (every result goes
to the static buffers), and they replay one at a time on one stream.  A
capture or a generator handoff that fails raises: there is no fallback
to the eager loop or to draws on the host.  On a CPU engine the same
static-buffer loop runs the n scans, chunk by chunk, with the handoff
around it.  `Captured.kernel_names` lists the kernels the graph of the
last call's first chunk holds, one entry a kernel node, read from the
graph itself; `launches` counts the last call's chunks.

`cond` is the counterpart of `jax.lax.cond` for the steps' resample
gates: under a capture it makes a CUDA-graph conditional IF node (torch
2.11 has no call for one, so `conditional_capture` builds it with the
CUDA driver's graph calls around each capture `Graphed` makes), so that a
replay runs a gate's body only on the scans where it fires; eagerly on
the card it is a select, and on the CPU a Python branch.  The graph walks
(`graph_kernel_nodes`, `graph_conditional_bodies`) read the bodies'
kernels where their IF node stands.

`Graphed` is that capture for any body over static buffers: `Captured`
is one, and so are the pose-graph frontend's three compiled pieces (the
closure verifier, Gauss-Newton and the map rebuild, models/frontend.py and
models/posegraph.py) and the distributed engines' steps (parallel/), whose
bodies hold NCCL collectives: the warm-up creates the communicator at the
first collective, and torch.cuda.graph synchronizes the card, so every
collective of the warm-up has finished, before the capture begins.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import time
from typing import Callable, Optional, Sequence

import torch

# eager steps on the side stream before capture: the first builds the
# kernel library and fills the caches, the second runs on them as warm
WARMUP_STEPS = 2
# the most scans a captured graph holds: a longer log is replayed in
# chunks of this many scans (models/captured.Captured)
CHUNK_SCANS = 16


def tree_map(fn, tree, *rest):
    """fn over the tensors of a tree of dataclasses, tuples and lists
    (None stays None); `rest` are trees of the same structure whose
    tensors are passed beside."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def leaves(tree) -> list:
    """The tensors of a tree, in tree_map's order."""
    out = []
    tree_map(out.append, tree)
    return out


def stack_steps(infos: Sequence):
    """The per-scan infos (StepInfo, MultiStepInfo) as one of the same
    type, each field stacked along a leading frame axis (what lax.scan
    returns)."""
    if not infos:
        raise ValueError("no steps to stack")
    return tree_map(lambda *xs: torch.stack(xs), *infos)


def num_frames(frames) -> int:
    """The length of a stacked Frame batch's leading frame axis."""
    return frames.t.shape[0]


def check_draws(draws, n: int) -> None:
    """Raise ValueError unless every tensor of the stacked `draws` has a
    leading frame axis of length n."""
    for x in leaves(draws):
        if x.dim() == 0 or x.shape[0] != n:
            raise ValueError(f"injected draws need a leading frame axis of "
                             f"{n}, got shape {tuple(x.shape)}")


def _check_shape(buf, x):
    if tuple(x.shape[1:]) != tuple(buf.shape):
        raise ValueError(f"injected draws of shape {tuple(x.shape[1:])} a "
                         f"scan, the step draws {tuple(buf.shape)}")


def copy_into(dst, src):
    """dst.copy_(src) unless the two are one tensor; returns dst."""
    if dst.data_ptr() != src.data_ptr():
        dst.copy_(src)
    return dst


def scan(step: Callable, draw: Callable, state, frames, generator=None,
         draws=None):
    """The eager replay of a stacked Frame batch: returns (final state,
    the infos stacked along a leading frame axis).  draw(generator) gives
    one scan's draws; `draws` replaces them, stacked."""
    n = num_frames(frames)
    if n == 0:
        raise ValueError("no frames to replay")
    if draws is not None:
        check_draws(draws, n)
    infos = []
    for i in range(n):
        d = (draw(generator) if draws is None
             else tree_map(lambda x, i=i: x[i], draws))
        state, info = step(state, tree_map(lambda x, i=i: x[i], frames), d,
                           None)
        infos.append(info)
    return state, stack_steps(infos)


def cond(pred, body: Callable, outs: Sequence, select: Optional[bool] = None
         ) -> None:
    """`jax.lax.cond(pred, body, identity)` for a body that overwrites the
    tensors `outs`, which hold the identity's result when it is called
    (the resample gates: the indices, poses and weights a resample
    replaces).  `pred` is a 0-dim bool tensor.

    - Under a capture by `Graphed` (conditional_capture): a CUDA-graph
      conditional IF node whose body holds body()'s work, so that a replay
      runs it only where `pred` holds then (see conditional_capture).  A
      capture that is not conditional_capture's raises: no capture falls
      back to the select.
    - Eagerly on the card: the select form, with no host read: body() runs
      with copies of `outs` kept aside, then each out is
      torch.where(pred, its new value, its old one).
    - On the CPU: body() where bool(pred), in Python: the CPU runs the
      bodies the card's IF nodes hold.

    `select=True` asks for the select form on any device (the tests hold
    it against the branch)."""
    if select is None:
        select = pred.is_cuda and not torch.cuda.is_current_stream_capturing()
    if select:
        kept = [x.clone() for x in outs]
        body()
        for x, old in zip(outs, kept):
            torch.where(pred, x, old, out=x)
    elif not pred.is_cuda:
        if bool(pred):
            body()
    else:
        _capture_if(pred, body)


# the conditionals captured so far in the running conditional_capture:
# (the node that sets the handle, the body's last node, handle, context)
_segments: Optional[list] = None
# conditional node -> its body graphs, for the conditional nodes made here
# (the CUDA driver has no call that reads a conditional node's bodies
# back)
_bodies: dict = {}
# the (mangled) names of the kernels of every conditional body made in this
# process, kept past their graphs: the profiler may name a body's record
# after one of another graph (bench/layers.align)
body_kernel_names: set = set()


def _capture_state(cu, stream: int):
    """(the graph a stream captures into, its capture's current
    dependencies)."""
    status, cid = ctypes.c_int(), ctypes.c_uint64()
    graph, n = ctypes.c_void_p(), ctypes.c_size_t()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    _cu(cu, "cuStreamGetCaptureInfo_v2", ctypes.c_void_p(stream),
        ctypes.byref(status), ctypes.byref(cid), ctypes.byref(graph),
        ctypes.byref(deps), ctypes.byref(n))
    return graph.value, [deps[i] for i in range(n.value)]


def _capture_if(pred, body: Callable) -> None:
    """cond's captured form: a conditional handle of the graph being
    captured, the kernel that sets it from `pred` (csrc/conditional.cu),
    then body()'s work, noted for conditional_capture to move into the
    body of an IF node after that kernel."""
    from ..ops.cuda import _build
    if _segments is None:
        raise RuntimeError("captured.cond under a capture that is not "
                           "captured.conditional_capture's (Graphed.capture)")
    cu = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    graph, _ = _capture_state(cu, stream)
    ctx, handle = ctypes.c_void_p(), ctypes.c_uint64()
    _cu(cu, "cuCtxGetCurrent", ctypes.byref(ctx))
    _cu(cu, "cuGraphConditionalHandleCreate", ctypes.byref(handle),
        ctypes.c_void_p(graph), ctx, ctypes.c_uint(0), ctypes.c_uint(0))
    _build.check("gs_set_conditional", _build.library().gs_set_conditional(
        handle.value, pred.data_ptr(), stream))
    _, head = _capture_state(cu, stream)
    body()
    _, tail = _capture_state(cu, stream)
    if len(head) != 1 or len(tail) != 1:
        raise RuntimeError(f"a conditional's body must be captured as one "
                           f"chain: {len(head)} and {len(tail)} dependencies")
    _segments.append((head[0], tail[0], handle.value, ctx.value))


class _CondNodeParams(ctypes.Structure):
    """The CUDA driver's CUgraphNodeParams (256 bytes) with its union read as
    CUDA_CONDITIONAL_NODE_PARAMS."""
    _fields_ = [("type", ctypes.c_int), ("reserved0", ctypes.c_int * 3),
                ("handle", ctypes.c_uint64), ("cond_type", ctypes.c_int),
                ("size", ctypes.c_uint),
                ("graphs", ctypes.POINTER(ctypes.c_void_p)),
                ("ctx", ctypes.c_void_p),
                ("reserved1", ctypes.c_longlong * 25),
                ("reserved2", ctypes.c_longlong)]


def _dependents(cu, node) -> list:
    n = ctypes.c_size_t(0)
    _cu(cu, "cuGraphNodeGetDependentNodes", ctypes.c_void_p(node), None,
        ctypes.byref(n))
    if not n.value:         # the graph's last node (the driver refuses an
        return []           # array for none)
    out = (ctypes.c_void_p * n.value)()
    _cu(cu, "cuGraphNodeGetDependentNodes", ctypes.c_void_p(node), out,
        ctypes.byref(n))
    return list(out)


def _clone_node(cu, node, graph, prev, ctx):
    """A copy of a kernel, copy or set node in `graph`, after `prev`."""
    kind = ctypes.c_int(-1)
    _cu(cu, "cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
    new = ctypes.c_void_p()
    deps = (ctypes.c_void_p * 1)(prev) if prev else None
    args = (ctypes.byref(new), ctypes.c_void_p(graph), deps,
            ctypes.c_size_t(1 if prev else 0))
    if kind.value == 0:                               # kernel
        params = _KernelNodeParams()
        _cu(cu, "cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
            ctypes.byref(params))
        _cu(cu, "cuGraphAddKernelNode_v2", *args, ctypes.byref(params))
        _cu(cu, "cuGraphKernelNodeCopyAttributes", new,
            ctypes.c_void_p(node))
    elif kind.value in (1, 2):                        # memcpy, memset
        what = "Memcpy" if kind.value == 1 else "Memset"
        params = (ctypes.c_char * 512)()            # CUDA_MEMCPY3D / ..._SET
        _cu(cu, f"cuGraph{what}NodeGetParams", ctypes.c_void_p(node), params)
        _cu(cu, f"cuGraphAdd{what}Node", *args, params, ctypes.c_void_p(ctx))
    else:
        raise RuntimeError(f"a {NODE_TYPES[kind.value]} node in a "
                           f"conditional's body")
    return new.value


def _make_if_node(cu, graph: int, head, tail, handle: int, ctx) -> None:
    """Move the chain of nodes after `head` up to `tail` into the body of a
    new IF node on `handle`, which stands between `head` and what followed
    `tail`."""
    chain, node = [], head
    while node != tail:
        nxt = _dependents(cu, node)
        if len(nxt) != 1:
            raise RuntimeError("a conditional's body is not one chain")
        node = nxt[0]
        chain.append(node)
    after = _dependents(cu, tail)
    params = _CondNodeParams(type=CONDITIONAL, handle=handle, cond_type=0,
                             size=1, ctx=ctx)        # CU_GRAPH_COND_TYPE_IF
    cnode = ctypes.c_void_p()
    _cu(cu, "cuGraphAddNode", ctypes.byref(cnode), ctypes.c_void_p(graph),
        (ctypes.c_void_p * 1)(head), ctypes.c_size_t(1),
        ctypes.byref(params))
    body = params.graphs[0]
    prev = None
    for node in chain:
        prev = _clone_node(cu, node, body, prev, ctx)
    for node in chain:
        _cu(cu, "cuGraphDestroyNode", ctypes.c_void_p(node))
    for node in after:
        _cu(cu, "cuGraphAddDependencies", ctypes.c_void_p(graph),
            (ctypes.c_void_p * 1)(cnode.value),
            (ctypes.c_void_p * 1)(node), ctypes.c_size_t(1))
    _bodies[cnode.value] = [body]
    body_kernel_names.update(graph_kernel_names(body))


@contextlib.contextmanager
def conditional_capture(graph):
    """Around the capture of `graph` (a torch.cuda.CUDAGraph made with
    keep_graph=True, not yet instantiated): every cond() the capture meets
    becomes a conditional IF node.  torch 2.11 has no call that captures
    one (PyTorch's CUDAGraph.begin_capture_to_if_node came later), so it is
    made with the CUDA driver's graph calls: while the capture runs, cond()
    creates a conditional handle of the graph, captures the kernel that
    sets it from `pred` and then the body's work into the graph in line,
    from the graph's own memory pool like every other node; when the
    capture has ended, each body's nodes (kernels, copies and sets, one
    chain) are copied into the body graph of a new IF node placed after
    that kernel, and removed from the graph."""
    global _segments
    if _segments is not None:
        raise RuntimeError("conditional_capture does not nest")
    _segments = []
    try:
        yield
        segments = _segments
    finally:
        _segments = None
    if segments:
        cu = ctypes.CDLL("libcuda.so.1")
        for head, tail, handle, ctx in segments:
            if head != tail:        # an empty body gates nothing
                _make_if_node(cu, graph.raw_cuda_graph(), head, tail,
                              handle, ctx)


def copy_from_host(buf, x):
    """buf.copy_(x) for a host tensor x with no wait on the card: on a CUDA
    buffer x goes through pinned memory, whose block PyTorch's host
    allocator keeps until the copy has run."""
    if buf.is_cuda:
        x = x.pin_memory()
    buf.copy_(x, non_blocking=True)


class Graphed:
    """A body over static buffers, run as one CUDA graph on the card.

    body() reads and writes only tensors that outlive it (the static
    buffers, which its owner fills before a run and reads after).
    `capture()` captures it anew and counts that in `captures`; `run()`
    replays it.  On a CPU device capture() does nothing and run() calls the
    body: the same static-buffer code, with no graph.  A `generator` set
    on the instance is registered with every graph captured, so that the
    draws the body makes from it are drawn anew at each replay (from the
    seed and offset it holds then)."""

    def __init__(self, body: Callable, device,
                 reset: Optional[Callable] = None):
        self.body = body
        self.device = torch.device(device)
        self._reset = reset
        self._side = None
        self.generator = None
        self.graph = None
        self.captures = 0
        self.capture_seconds = None

    def capture(self, captured: Optional[Callable] = None,
                pool=None) -> None:
        """WARMUP_STEPS eager calls of the body on a side stream (reset()
        before each and after the last), which build the kernel library
        and fill every cache the body reads (the kernels' launch plans,
        the matcher's offsets, cuFFT's plans, the cuBLAS and cuSOLVER
        handles and workspaces), then the capture on that stream of
        `captured` (by default the body), in memory pool `pool` where one
        is given.  Every capture of an instance runs on the same side
        stream.  The graph is kept beside its instance, for
        kernel_names; `capture_seconds` is the capture's and the
        instantiation's host time.  A capture that fails raises."""
        self.graph = None
        if self.device.type != "cuda":
            return
        # one side stream for every capture: the caching allocator reuses a
        # freed block only on the stream it was allocated on, so graphs
        # captured on one stream into one pool share its blocks
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                if self._reset is not None:
                    self._reset()
                self.body()
            if self._reset is not None:
                self._reset()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        # no cyclic garbage collection while the capture runs: a collection
        # that frees an unreachable CUDAGraph (a Graphed's reset lambda
        # makes a cycle) destroys it, which a capture in the default global
        # mode does not permit, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            with conditional_capture(graph):
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    (captured or self.body)()
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        self.captures += 1

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        elif self.device.type == "cuda":
            raise RuntimeError("run() before capture() on a CUDA device")
        else:
            self.body()

    def kernel_names(self) -> list:
        """The function name of every kernel node of the captured graph
        (one entry a launch a replay)."""
        if self.graph is None:
            raise RuntimeError("no graph captured yet")
        return graph_kernel_names(self.graph.raw_cuda_graph())

    def node_types(self) -> dict:
        """The captured graph's nodes counted by type (graph_node_types)."""
        if self.graph is None:
            raise RuntimeError("no graph captured yet")
        return graph_node_types(self.graph.raw_cuda_graph())


def default_generator(device: torch.device) -> torch.Generator:
    """The generator a draw on `device` with generator=None takes."""
    if device.type != "cuda":
        return torch.default_generator
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch.cuda.default_generators[index]


def chunks(n: int) -> list:
    """(first scan, scans) of each launch of a replay of n scans: chunks of
    CHUNK_SCANS scans, the last one the rest."""
    return [(a, min(CHUNK_SCANS, n - a)) for a in range(0, n, CHUNK_SCANS)]


class Captured(Graphed):
    """A whole log's filter steps captured as graphs of at most CHUNK_SCANS
    scans, replayed in turn (see the module docstring).  Calling it with
    (state, stacked frames, generator, draws) returns (the static state,
    the infos stacked over the scans): the static state is the capture's
    own buffer, which the next call overwrites (the counterpart of
    donation); the infos are fresh.  `scans` is the number of scans the
    graph of the last call's first chunk holds (`graph`), `launches` the
    last call's chunks."""

    def __init__(self, step: Callable, draw: Callable, device):
        """step(state, frame, draws, out) -> (state, info);
        draw(generator, out=None) -> one scan's draws, into `out`'s tensors
        where it is given."""
        super().__init__(self._body, device,
                         reset=lambda: self.counter.zero_())
        self._step = step
        self._draw = draw
        self._key = None
        self._inject = False
        self._pool = None
        self.capacity = self.scans = self.launches = 0
        self.graphs = {}
        self.state = self.frames = self.draws = self.injected = None
        self.infos = self.counter = None

    def _body(self):
        """One scan on the static buffers."""
        t = self.counter
        frame = tree_map(lambda x: x.index_select(0, t)[0], self.frames)
        if self._inject:
            draws = tree_map(lambda x: x.index_select(0, t)[0],
                             self.injected)
        else:                   # the eager step's calls, in its order
            draws = self._draw(self.generator, self.draws)
        _, info = self._step(self.state, frame, draws, self.state)
        if self.infos is None:
            self.infos = tree_map(
                lambda x: x.new_empty((self.capacity,) + tuple(x.shape)),
                info)
        tree_map(lambda buf, x: buf.index_copy_(0, t, x[None]), self.infos,
                 info)
        t.add_(1)

    def _scans(self, n: int):
        """n scans from the first: what a graph holds."""
        self.counter.zero_()
        for _ in range(n):
            self._body()

    def _prepare(self, state, frames, n: int):
        """Static buffers for min(n, CHUNK_SCANS) scans of these shapes:
        kept from the last call where they fit, else made anew (and every
        graph dropped)."""
        def sig(tree, lead):
            return tuple((tuple(x.shape[lead:]), x.dtype, x.device)
                         for x in leaves(tree))
        key = (sig(state, 0), sig(frames, 1))
        m = min(n, CHUNK_SCANS)
        if key == self._key and m <= self.capacity:
            return
        self._key, self.capacity = key, m
        self.graphs, self.graph, self._pool = {}, None, None
        self.infos = self.injected = None
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
        self.state = tree_map(torch.clone, state)
        self.frames = tree_map(lambda x: x.new_empty((m,) + x.shape[1:]),
                               frames)
        # one scan's draws (the warm-up's, and each scan's in the graph)
        self.draws = self._draw(self.generator)
        self.counter = torch.zeros((1,), dtype=torch.int64,
                                   device=self.device)

    def _fill_chunk(self, frames, draws, a: int, m: int):
        """The frames (and injected draws) of scans [a, a + m) into the
        buffers' first m scans."""
        tree_map(lambda buf, x: copy_into(buf[:m], x[a:a + m]), self.frames,
                 frames)
        if draws is not None:
            tree_map(lambda buf, x: copy_into(buf[:m], x[a:a + m]),
                     self.injected, draws)

    def _fill(self, state, frames, draws, m: int):
        """The state and the first chunk of m scans into the buffers."""
        tree_map(copy_into, self.state, state)
        self._fill_chunk(frames, draws, 0, m)

    def _capture(self, m: int):
        """The graph of m scans (with injected draws or not), after warm-up
        scans of one scan each on the buffers as they are filled (the
        caller fills them anew), kept in `graphs`."""
        self.capture(lambda: self._scans(m), pool=self._pool)
        self._pool = self.graph.pool()
        self.graphs[(m, self._inject)] = self.graph

    def __call__(self, state, frames, generator=None, draws=None):
        n = num_frames(frames)
        if n == 0:
            raise ValueError("no frames to replay")
        if draws is not None:
            check_draws(draws, n)
        self._prepare(state, frames, n)
        self._inject = draws is not None
        if draws is not None:
            tree_map(_check_shape, self.draws, draws)
            if self.injected is None:
                self.injected = tree_map(
                    lambda x: x.new_empty((self.capacity,) + x.shape),
                    self.draws)
        parts = chunks(n)
        self._fill(state, frames, draws, parts[0][1])
        caller = None
        if draws is None:
            caller = default_generator(self.device) if generator is None \
                else generator
            if caller.device.type != self.device.type:
                raise ValueError(f"a generator on {caller.device} for an "
                                 f"engine on {self.device}")
        graphs = {}
        if self.device.type == "cuda":
            lengths = {m for _, m in parts}
            missing = sorted((m for m in lengths
                              if (m, self._inject) not in self.graphs),
                             reverse=True)
            for m in missing:
                self._capture(m)
            if missing:     # the warm-up scans changed the buffers
                self._fill(state, frames, draws, parts[0][1])
            graphs = {m: self.graphs[(m, self._inject)] for m in lengths}
            self.graph = graphs[parts[0][1]]
        self.scans, self.launches = parts[0][1], len(parts)
        if caller is not None:
            self.generator.set_state(caller.get_state())
        out = []
        for i, (a, m) in enumerate(parts):
            if i:
                self._fill_chunk(frames, draws, a, m)
            if graphs:
                graphs[m].replay()
            else:
                self._scans(m)
            out.append(tree_map(lambda buf, m=m: buf[:m].clone(),
                                self.infos))
        if caller is not None:
            caller.set_state(self.generator.get_state())
        return self.state, (out[0] if len(out) == 1 else
                            tree_map(lambda *xs: torch.cat(xs), *out))


class _KernelNodeParams(ctypes.Structure):
    """The driver's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _cu(lib, fn: str, *args) -> None:
    code = getattr(lib, fn)(*args)
    if code != 0:
        raise RuntimeError(f"{fn} failed with CUresult {code}")


# CUgraphNodeType of the CUDA driver API, by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")
CONDITIONAL = NODE_TYPES.index("conditional")


def _graph_nodes(cu, graph_handle: int) -> list:
    graph = ctypes.c_void_p(graph_handle)
    count = ctypes.c_size_t(0)
    _cu(cu, "cuGraphGetNodes", graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    _cu(cu, "cuGraphGetNodes", graph, nodes, ctypes.byref(count))
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _cu(cu, "cuGraphNodeGetType", ctypes.c_void_p(node),
            ctypes.byref(kind))
        out.append((node, kind.value))
    return out


def _chain(cu, graph_handle: int, nodes: list) -> Optional[list]:
    graph = ctypes.c_void_p(graph_handle)
    count = ctypes.c_size_t(0)
    _cu(cu, "cuGraphGetEdges", graph, None, None, ctypes.byref(count))
    src = (ctypes.c_void_p * count.value)()
    dst = (ctypes.c_void_p * count.value)()
    _cu(cu, "cuGraphGetEdges", graph, src, dst, ctypes.byref(count))
    after = dict(zip(src, dst))
    targets = set(dst)
    if len(after) != count.value or len(targets) != count.value:
        return None
    heads = [node for node in nodes if node not in targets]
    if len(heads) != 1:
        return None
    order = [heads[0]]
    while order[-1] in after:
        order.append(after[order[-1]])
    return order if len(order) == len(nodes) else None


def _run_order(cu, graph_handle: int) -> list:
    """(node, type) of a graph's nodes in the order they run where they form
    one chain, else in the CUDA driver's order (the order they were made: a
    conditional node made after its capture comes last there)."""
    nodes = _graph_nodes(cu, graph_handle)
    chain = _chain(cu, graph_handle, [node for node, _ in nodes])
    if chain is None:
        return nodes
    kind = dict(nodes)
    return [(node, kind[node]) for node in chain]


def graph_conditional_bodies(graph_handle: int) -> list:
    """(conditional node, its body graphs) of every conditional node of a
    cudaGraph_t's top level, in _run_order."""
    cu = ctypes.CDLL("libcuda.so.1")
    return [(node, _bodies[node]) for node, kind in _run_order(
        cu, graph_handle) if kind == CONDITIONAL]


def graph_node_types(graph_handle: int) -> dict:
    """The top-level nodes of a cudaGraph_t counted by their CUDA node type
    (NODE_TYPES): a collective of a world of one may be a copy node and
    not a kernel, so collectives are counted by type, not by name.  A
    conditional node counts as one; its bodies' kernels are in
    graph_kernel_nodes."""
    counts: dict = {}
    for _, kind in _graph_nodes(ctypes.CDLL("libcuda.so.1"), graph_handle):
        name = NODE_TYPES[kind] if 0 <= kind < len(NODE_TYPES) else str(kind)
        counts[name] = counts.get(name, 0) + 1
    return counts


def graph_chain(graph_handle: int) -> Optional[list]:
    """The nodes of a cudaGraph_t in the order they run, where they form
    one chain (each node at most one edge in and one out, as a capture of
    one stream gives; a conditional node is one node of it); None where
    they do not."""
    cu = ctypes.CDLL("libcuda.so.1")
    return _chain(cu, graph_handle,
                  [node for node, _ in _graph_nodes(cu, graph_handle)])


def graph_kernel_nodes(graph_handle: int) -> list:
    """(node, mangled function name) of every kernel node of a cudaGraph_t,
    in _run_order, read through its API; the kernels of a conditional
    node's bodies stand where the conditional node does.  A node holds a
    CUfunction or, for a kernel the runtime loaded as a CUkernel, that;
    each has its name call."""
    cu = ctypes.CDLL("libcuda.so.1")
    out = []
    for node, kind in _run_order(cu, graph_handle):
        if kind == CONDITIONAL:
            for body in _bodies[node]:
                out += graph_kernel_nodes(body)
            continue
        if kind != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        _cu(cu, "cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
            ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            _cu(cu, "cuFuncGetName", ctypes.byref(name),
                ctypes.c_void_p(params.func))
        else:
            _cu(cu, "cuKernelGetName", ctypes.byref(name),
                ctypes.c_void_p(params.kern))
        out.append((node, name.value.decode()))
    return out


def graph_kernel_names(graph_handle: int) -> list:
    """The (mangled) function name of every kernel node of a cudaGraph_t,
    in graph_kernel_nodes' order."""
    return [name for _, name in graph_kernel_nodes(graph_handle)]


def replay_fn(captured: Captured):
    """The captured replay: (state, frames, generator=None, draws=None) ->
    (final state, stacked infos), the final state a copy of the static
    one (so that a later call leaves it as it is)."""
    def replay(state, frames, generator: Optional[torch.Generator] = None,
               draws=None):
        out, infos = captured(state, frames, generator, draws)
        return tree_map(torch.clone, out), infos
    replay.captured = captured
    return replay


def step_fn(captured: Captured):
    """The captured single step: (state, frame, generator=None, draws=None)
    -> (state, info).  The state returned is the capture's static buffer:
    the next call consumes it (pass it back, or any state of the same
    shapes) and overwrites it, the counterpart of donating the input
    state to a jitted step.  Clone it to keep it."""
    def step(state, frame, generator: Optional[torch.Generator] = None,
             draws=None):
        one = tree_map(lambda x: x[None], frame)
        if draws is not None:
            draws = tree_map(lambda x: x[None], draws)
        out, infos = captured(state, one, generator, draws)
        return out, tree_map(lambda x: x[0], infos)
    step.captured = captured
    return step
