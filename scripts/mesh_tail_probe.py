"""F7's and F8's mesh forms (the distributed engines' weights tail) on the
card, alone.

Builds the kernels with `-Xptxas -v` and prints the registers and spills of
F7's mesh passes (csrc/fusions.cu fusion_mesh_*) and F8's kernels; runs
chip_smoke.py's planted mesh-form calls (`_mesh_edges`: 8 to 1 048 576
weights over 2 and 4 ranks emulated by threads) against their plain
versions in every bit; then in a world of one over NCCL (mesh (1, 1))
times, at P = 500, 10 000 and 1 048 576 weights:

- the tail (`weights_mesh` with the epilogue, the recovery EMAs and the
  map update's crop) on the kernels, its plain version (the op sequence
  parallel/shmap.finish_step ran before the kernels: ops/resample's fixed
  order in tensor ops) and the single-device F7 (`weights`, the same
  options), each held to the next in every output bit;
- the center call (`weights_mesh(center=True)` with the surface volume's
  window) the same three ways;
- F8's mesh form (`walk_mesh`) on the gathered rows, the second half of
  the slots (a rank's of two), against its plain version;

each by CUDA events around 20 calls after warm-up ("ev", host time
included) and inside a CUDA graph of 20 calls ("graph", device time; the
plain versions 3 and 5), with torch.softmax of the weights beside (the
library call for the normalized weights).  One JSON line a row, then a
summary line; exits 1 on any differing bit.

Usage (needs a GPU; ~1 min with the build):
    python scripts/mesh_tail_probe.py
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TIMED = (500, 10_000, 1_048_576)
SEED = 0


def say(**fields):
    print(json.dumps(fields), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("mesh_tail_probe: no CUDA device")
    import chip_smoke as cs
    from gridmap_slam_tpu_torch.ops.cuda import _build, fusions
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh
    from gridmap_slam_tpu_torch.parallel.shmap import collectives
    from gridmap_slam_tpu_torch.types import Odom

    say(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    _, log = _build.build(verbose=True)
    _build.library()
    regs = {}
    for name, use in _build.ptxas_usage(log).items():
        m = re.search(r"fusion_((mesh|walk|weights)_\w+?)_kernel", name)
        if m:
            regs[m.group(1)] = use
    say(registers=regs)
    spilled = [k for k, v in regs.items()
               if v["spill_stores"] or v["spill_loads"]]

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    edges = cs._mesh_edges(gen)
    bad_edges = [r for r in edges if r["bits_differing"]]
    say(planted={k: dict(calls=sum(r["kernel"] == k for r in edges),
                         bits_differing=sum(r["bits_differing"]
                                            for r in edges
                                            if r["kernel"] == k))
                 for k in ("F7m", "F8m")}, differing=bad_edges)

    world = cs._world_of_one()
    rows, differing = [], 0
    try:
        mesh = pmesh.make_mesh(1, device="cuda")
        comm = collectives(mesh)
        crop = fusions.WindowSpec(crop=(412, 412), full=(4000, 4000),
                                  resolution=0.05, origin=(-100.0, -100.0))
        volume = fusions.WindowSpec(crop=(120, 120), full=(120, 120),
                                    resolution=0.05, origin=(-3.0, -3.0),
                                    volume=True, radius=2, ext=(120, 120),
                                    nt=25, t_off=-0.3, dtheta=0.025)
        odom = Odom(torch.tensor(0.12, device="cuda"),
                    torch.tensor(-0.2, device="cuda"))
        for p in TIMED:
            lw = torch.randn(p, generator=gen, device="cuda") * 3.0 - 50.0
            poses = (torch.rand((p, 3), generator=gen, device="cuda")
                     - 0.5) * 6.0
            tail_kw = dict(resample_fraction=0.5,
                           recov=torch.tensor([-52.0, -51.0],
                                              device="cuda"),
                           step=torch.tensor(3, dtype=torch.int32,
                                             device="cuda"),
                           reinject=(0.05, 0.6), window=crop)
            for call, kw in (("tail", tail_kw),
                             ("center", dict(window=volume, odom=odom))):
                mesh_kw = dict(kw, center=True) if call == "center" else kw
                forms = {
                    "kernels": lambda: fusions.weights_mesh_cuda(
                        lw, poses, comm, **mesh_kw),
                    "plain": lambda: fusions.weights_mesh_plain(
                        lw, poses, comm, **mesh_kw),
                    "single_device_f7": lambda: fusions.weights_cuda(
                        lw, poses, **kw)}
                outs = {k: fn() for k, fn in forms.items()}
                got = cs._outputs(outs["kernels"])
                want = cs._outputs(outs["plain"])
                bits = (sum(map(cs._bits_differing, got, want))
                        if len(got) == len(want) else -1)
                # the single-device F7: the same values where it has them
                one = outs["single_device_f7"]
                fields = (("max", "total", "weighted") if call == "center"
                          else fusions.Tail._fields[:10])
                vs_f7 = sum(cs._bits_differing(getattr(outs["kernels"], f),
                                               getattr(one, f).reshape(
                                                   getattr(outs["kernels"],
                                                           f).shape))
                            for f in fields if getattr(one, f) is not None)
                if call == "center":
                    vs_f7 += sum(cs._bits_differing(a, b) for a, b in zip(
                        cs._outputs(outs["kernels"].volume),
                        cs._outputs(one.volume)))
                differing += bits + vs_f7
                row = dict(call=call, weights=p, bits_differing=bits,
                           bits_differing_from_single_device_f7=vs_f7)
                for k, fn in forms.items():
                    reps = 20 if k != "plain" else 3
                    row[f"{k}_ev_ms"] = cs.cuda_ms(fn, reps)
                    row[f"{k}_graph_ms"] = cs.graph_ms(fn, reps if k != "plain"
                                                       else 5)
                row["softmax_ev_ms"] = cs.cuda_ms(
                    lambda: torch.softmax(lw, -1), 20)
                row["bound_ms"], row["bound_by"] = cs.fusion_bound(
                    "F7m", (lw, poses, comm), mesh_kw)
                rows.append(row)
                say(**row)
            rows_t = torch.cat([lw[:, None], poses], 1)
            u0 = torch.rand((), generator=gen, device="cuda") / p
            kw = dict(base=p // 2, count=p - p // 2)
            got = cs._outputs(fusions.walk_mesh_cuda(rows_t, u0, **kw))
            want = cs._outputs(fusions.walk_mesh_plain(rows_t, u0, **kw))
            bits = sum(map(cs._bits_differing, got, want))
            differing += bits
            row = dict(call="walk_mesh", weights=p, slots=[kw["base"],
                                                           kw["count"]],
                       bits_differing=bits)
            for k, fn in (("kernels", lambda: fusions.walk_mesh_cuda(
                    rows_t, u0, **kw)), ("plain", lambda: fusions.
                    walk_mesh_plain(rows_t, u0, **kw))):
                reps = 20 if k == "kernels" else 3
                row[f"{k}_ev_ms"] = cs.cuda_ms(fn, reps)
                row[f"{k}_graph_ms"] = cs.graph_ms(fn, reps)
            row["bound_ms"], row["bound_by"] = cs.fusion_bound(
                "F8m", (rows_t, u0), kw)
            rows.append(row)
            say(**row)
    finally:
        cs._close_world(world)
    ok = not (spilled or bad_edges or differing)
    say(summary=dict(ok=ok, spilled=spilled, planted_differing=len(bad_edges),
                     timed_bits_differing=differing))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
