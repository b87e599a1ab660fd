"""Draw random numbers inside a CUDA graph with the bits of the eager draws.

The captured replays (gridmap_slam_tpu_torch/models/captured.py) capture a
whole log's scans in one CUDA graph, each scan's draws (torch.randn,
torch.rand, as RBPF._draws makes them) inside it.  The graph draws from a
generator its replay owns and registers with the graph
(CUDAGraph.register_generator_state); before a replay the caller's
generator state is handed to that generator, after it handed back.  This
script checks that design on the card, part by part:

- `handoff`: get_state/set_state around the replay.  The bits of every
  draw of every scan equal the eager draws from the caller's state, over
  several replays from changing caller states (so the graph reads the state
  set before each replay, not the one at capture), and the caller's next
  randn after the replay equals its next draw after the eager run;
- `default`: the same with the default CUDA generator as the caller (a
  step called with generator=None);
- `graphsafe`: graphsafe_set_state(caller.graphsafe_get_state()) on the
  owned generator in place of set_state (the owned generator then shares
  the caller's state object, which is not the one registered), reported;
- `unregistered`: a generator not registered with the graph, drawn from
  inside the capture: whether the capture raises, and if it does not,
  whether two replays draw the same numbers.  Last, since a failed capture
  may leave the process unable to capture again.

Each part prints one JSON line; the last line says whether the design
(handoff and default) held.

Usage: python scripts/graph_rng_probe.py            (needs a GPU; ~20 s)
"""

import json
import subprocess
import sys
import traceback

import torch

P = 1_000_000           # draws a scan: mega's particles
SCANS = 12
REPLAYS = 4


def draws(gen, normals, u0):
    """One scan's draws, as RBPF._draws makes them into its static
    buffers."""
    torch.randn(normals.shape, generator=gen, device="cuda", out=normals)
    torch.rand((), generator=gen, device="cuda", out=u0)
    torch.mul(u0, 1.0 / P, out=u0)


def capture(gen, register=True):
    """A graph of SCANS scans' draws from `gen` into a stacked buffer,
    after two eager warm-up scans on the side stream: (graph, buffers)."""
    normals = torch.empty((SCANS, P, 2), device="cuda")
    u0 = torch.empty((SCANS,), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            draws(gen, normals[0], u0[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if register:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=side):
        for i in range(SCANS):
            draws(gen, normals[i], u0[i])
    return graph, normals, u0


def eager(state):
    """The eager draws from a generator at `state`: (normals, u0, the next
    randn after them)."""
    g = torch.Generator(device="cuda")
    g.set_state(state)
    n = torch.empty((SCANS, P, 2), device="cuda")
    u = torch.empty((SCANS,), device="cuda")
    for i in range(SCANS):
        draws(g, n[i], u[i])
    return n, u, torch.randn(8, generator=g, device="cuda")


def check(name, hand_in, hand_out, caller_of):
    """REPLAYS replays, each from a caller's state moved on by a few
    draws: bits of every draw and the caller's next randn against eager."""
    own = torch.Generator(device="cuda")
    graph, normals, u0 = capture(own)
    rows = []
    for r in range(REPLAYS):
        caller = caller_of(r)
        torch.randn(1000 * r + 1, generator=caller, device="cuda")
        state = caller.get_state()
        want_n, want_u, want_next = eager(state)
        hand_in(own, caller)
        graph.replay()
        hand_out(own, caller)
        nxt = torch.randn(8, generator=caller, device="cuda")
        torch.cuda.synchronize()
        rows.append(dict(
            replay=r,
            normals_equal=bool(torch.equal(normals, want_n)),
            u0_equal=bool(torch.equal(u0, want_u)),
            next_draw_equal=bool(torch.equal(nxt, want_next)),
            scans_differ=bool(not torch.equal(normals[0], normals[1]))))
    ok = all(all(v for k, v in row.items() if k != "replay") for row in rows)
    print(json.dumps(dict(part=name, ok=ok, replays=rows)), flush=True)
    return ok


def seeded(r):
    return torch.Generator(device="cuda").manual_seed(1234 + r)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())

    def set_in(own, caller):
        own.set_state(caller.get_state())

    def set_out(own, caller):
        caller.set_state(own.get_state())

    results = {}
    for name, hand_in, hand_out, caller_of in (
            ("handoff", set_in, set_out, seeded),
            ("default", set_in, set_out,
             lambda r: torch.cuda.default_generators[
                 torch.cuda.current_device()]),
            ("graphsafe",
             lambda own, c: own.graphsafe_set_state(c.graphsafe_get_state()),
             lambda own, c: None, seeded)):
        try:
            results[name] = check(name, hand_in, hand_out, caller_of)
        except Exception as e:      # a probe: each part is reported
            results[name] = False
            print(json.dumps(dict(part=name, ok=False, error=repr(e)[:400],
                                  trace=traceback.format_exc()[-800:])),
                  flush=True)
    row = dict(part="unregistered")
    try:
        graph, normals, _ = capture(torch.Generator(device="cuda"),
                                    register=False)
        graph.replay()
        first = normals.clone()
        graph.replay()
        torch.cuda.synchronize()
        row.update(capture_raised=False,
                   same_draws_each_replay=bool(torch.equal(first, normals)))
    except Exception as e:          # what the capture does is the finding
        row.update(capture_raised=True, error=repr(e)[:400])
    print(json.dumps(row), flush=True)
    ok = results["handoff"] and results["default"]
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          design_ok=ok, **{k: v for k, v in results.items()})),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
