"""Capture NCCL collectives of a world of one inside a CUDA graph.

The distributed engines' compiled steps (gridmap_slam_tpu_torch/parallel/)
capture bodies that call `mesh.psum`, `mesh.pmax` and `mesh.all_gather`
(dist.all_reduce and all_gather_into_tensor over NCCL).  This script
captures such bodies with `models/captured.Graphed` (the default "global"
capture error mode) with collectives of an eager run still queued for
ProcessGroupNCCL's watchdog thread, replays each graph REPLAYS times on changing
inputs and holds the outputs to the eager ones.  For each body it prints
the graph's nodes by type and its kernel names: at a world of one a
collective may lower to a copy node, or to no node at all.

Usage: python scripts/nccl_graph_probe.py            (needs a GPU; ~20 s)
"""

import json
import subprocess
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

REPLAYS = 200


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    from gridmap_slam_tpu_torch.models.captured import Graphed
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh

    pmesh.init_world("cuda")
    mesh = pmesh.make_mesh(1, device="cuda")
    x = torch.randn(4096, device="cuda")
    # each body writes into a static buffer of its own, which the graph and
    # the eager call after it both fill
    bufs = {"clone_only": 4096, "psum": 4096, "pmax": 1, "all_gather": 5,
            "all_three": 4096 + 1 + 5}
    bufs = {k: torch.empty(n, device="cuda") for k, n in bufs.items()}
    bodies = {
        "clone_only": lambda: bufs["clone_only"].copy_(x.clone() * 2.0),
        "psum": lambda: bufs["psum"].copy_(pmesh.psum(x, mesh, "p") * 2.0),
        "pmax": lambda: bufs["pmax"].copy_(pmesh.pmax(x.max(), mesh, "p")
                                           * 2.0),
        "all_gather": lambda: bufs["all_gather"].copy_(
            pmesh.all_gather(x[:5], mesh, "p").reshape(-1) * 2.0),
        "all_three": lambda: bufs["all_three"].copy_(torch.cat([
            pmesh.psum(x, mesh, "p"),
            pmesh.pmax(x.max(), mesh, "p")[None],
            pmesh.all_gather(x[:5], mesh, "p").reshape(-1)]) * 2.0),
    }
    rows = []
    ok = True
    for name, body in bodies.items():
        row = dict(body=name)
        try:
            # collectives the watchdog still tracks when capture begins
            for _ in range(20):
                pmesh.psum(x, mesh, "p")
            g = Graphed(body, "cuda")
            g.capture()
            worst = 0.0
            for i in range(REPLAYS):
                x.copy_(torch.randn(4096, device="cuda"))
                g.run()
                got = bufs[name].clone()
                body()                       # eager, same inputs
                worst = max(worst, float((got - bufs[name]).abs().max()))
            torch.cuda.synchronize()
            row.update(captured=True, replays=REPLAYS,
                       max_abs_diff_vs_eager=worst,
                       node_types=g.node_types(), kernels=g.kernel_names())
            ok = ok and worst == 0.0
        except Exception as e:          # a probe: each body is reported
            row.update(captured=False, error=repr(e)[:400],
                       trace=traceback.format_exc()[-800:])
            ok = False
        rows.append(row)
        print(json.dumps(row), flush=True)
    pmesh.close_world()
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "all_ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
