"""Capture the distributed resample's collectives inside captured.cond.

At more than one 'p' rank, parallel/shmap.finish_step's resample gate is a
captured.cond whose body calls NCCL collectives: the all_gather of every
rank's (log-weight, pose) rows, the all_gather of the sharded RBPF's map
tiles and the pmax of the new log-weights' maximum.  Under a capture,
models/captured.conditional_capture moves a body's nodes into a CUDA-graph
IF node, and raises for a node it cannot move (a host node, a body that is
not one chain).  One card cannot hold two NCCL ranks, so this script
forces that body on a world of one: it calls the collectives the body
calls at n_p > 1, on the rows of a rank of P particles, in the body's
order.

For the body it prints the nodes a capture of it alone makes, by type
(at a world of one NCCL's all_gather is a copy node and an all_reduce in
place no node at all: a world of one cannot show two ranks' NCCL kernels
or what NCCL adds for them), then whether conditional_capture moves them
into an IF node, the IF node's body by type, and the replayed results with
the gate shut and open against the eager body's.

Usage: python scripts/nccl_cond_probe.py            (needs a GPU; ~20 s)
"""

import json
import subprocess
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

P, H, W = 64, 120, 120


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    from gridmap_slam_tpu_torch.models import captured
    from gridmap_slam_tpu_torch.ops.resample import systematic_indices
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh

    pmesh.init_world("cuda")
    mesh = pmesh.make_mesh(1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    lw = torch.randn(P, device="cuda", generator=g)
    poses = torch.randn(P, 3, device="cuda", generator=g)
    maps = torch.randn(P, H, W, device="cuda", generator=g)
    u0 = torch.rand((), device="cuda", generator=g) / P
    pred = torch.zeros((), dtype=torch.bool, device="cuda")
    # the identity's rows, which the body overwrites (finish_step's outs)
    outs = [torch.empty_like(poses), torch.empty_like(lw),
            torch.empty_like(maps), torch.empty((), device="cuda")]

    def reset():
        for o, x in zip(outs, (poses, lw, maps, lw.max())):
            o.copy_(x)

    def body():
        new_poses, new_lw, new_maps, best_lw = outs
        rows = pmesh.all_gather(torch.cat([lw[:, None], poses], 1), mesh,
                                "p", tiled=True)
        maps_all = pmesh.all_gather(maps, mesh, "p", tiled=True)
        idx = systematic_indices(rows[:, 0], u0)[:P]
        torch.index_select(rows[:, 1:], 0, idx, out=new_poses)
        torch.index_select(maps_all, 0, idx, out=new_maps)
        torch.index_select(rows[:, 0], 0, idx, out=new_lw)
        best_lw.copy_(pmesh.pmax(new_lw.max(), mesh, "p"))

    reset()
    body()
    want = [o.clone() for o in outs]
    reset()
    kept = [o.clone() for o in outs]

    plain = captured.Graphed(body, "cuda", reset=reset)
    plain.capture()
    row = dict(body_nodes_captured_alone=plain.node_types(),
               body_kernels_alone=plain.kernel_names())
    gated = captured.Graphed(lambda: captured.cond(pred, body, outs), "cuda",
                             reset=reset)
    try:
        gated.capture()
    except RuntimeError as e:
        row.update(moved_into_if_node=False, error=str(e),
                   trace=traceback.format_exc()[-1500:])
        print(json.dumps({"nccl_cond_probe": row}))
        return 1
    bodies = captured.graph_conditional_bodies(gated.graph.raw_cuda_graph())
    row.update(moved_into_if_node=True,
               graph_nodes=gated.node_types(),
               conditional_nodes=len(bodies),
               if_body_nodes=[captured.graph_node_types(b)
                              for _, bs in bodies for b in bs])
    results = {}
    for fire in (False, True):
        reset()
        pred.fill_(fire)
        gated.run()
        torch.cuda.synchronize()
        ref = want if fire else kept
        results["open" if fire else "shut"] = all(
            torch.equal(a, b) for a, b in zip(outs, ref))
    row.update(replay_equals_eager=results,
               ok=bool(len(bodies) == 1 and all(results.values())))
    print(json.dumps({"nccl_cond_probe": row}))
    pmesh.close_world()
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
