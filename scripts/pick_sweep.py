"""F3 (a matcher stage's pick) under several launch plans, on one card.

At a stage of PARTICLES particles (the 500 000 block of mega_blocked by
default), for the coarse (11 x 9 x 9, with the scan's mask) and the fine
(5 x 5 x 5) stage: the plan ops/cuda/fusions.pick_plan chooses, then each
of PLANS[stage] (lanes a particle, particles a slab, the scores staged in
shared memory or read in place), each launched as csrc/fusions.cu
gs_fusion_pick launches every plan (as many blocks as are resident): every
output equal bit for bit to the chosen plan's (else exit 1) and its device
ms inside a CUDA graph of REPS calls (chip_smoke.graph_ms), beside the
stage's byte bound (chip_smoke.fusion_bound).  Then the chosen plan at
stages past 2048 (dy, dx) cells (WIDE: a lane's cells walked in groups) at
WIDE_PARTICLES: every output equal bit for bit to the plain version's, and
its device ms beside the bound.  Prints the card's name and power limit
first and a JSON line a run.

Usage (needs a GPU; ~1 min):
    python scripts/pick_sweep.py [--particles N]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fusion_ab as ab  # noqa: E402

REPS = 10
# (lanes, particles a slab, staged): a team is max(lanes, 32) threads
PLANS = {"coarse": ((32, 1, 1), (16, 2, 1), (64, 1, 1), (128, 1, 1),
                    (32, 1, 0)),
         "fine": ((4, 8, 1), (8, 4, 1), (16, 2, 1), (32, 1, 1), (4, 8, 0))}
# stages past 2048 cells: a coarse 51 x 51 at 11 headings, a last 101 x 101
# at 3, at the RBPF's chunks
WIDE = {"coarse": (11, 51, 51), "refine": (3, 101, 101)}
WIDE_PARTICLES = (250, 500)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=500_000)
    args = ap.parse_args()
    cs.device_phase()
    from gridmap_slam_tpu_torch.config import MotionConfig
    from gridmap_slam_tpu_torch.ops.cuda import _build, fusions
    from gridmap_slam_tpu_torch.ops.cuda import stream_handle
    lib = _build.library()
    motion = MotionConfig()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    same_all = True
    for stage, plans in PLANS.items():
        call = ab.pick_inputs(args.particles, stage, gen)
        (scores, dxs, dys, dts, pose0, center, d_c, d_t, use, off_xy,
         off_t) = call
        p, nt, ny, nx = scores.shape
        kw = dict(motion=motion, prior_weight=0.7, stride=3)
        ref = fusions.pick_cuda(*call, **kw)
        chosen = fusions.pick_plan(p, nt, ny, nx)
        bound, by = cs.fusion_bound("F3", call, kw)
        dc, dt = d_c.reshape(1), d_t.reshape(1)
        for lanes, per_slab, staged in ((chosen.lanes, chosen.per_slab,
                                         int(chosen.staged)), *plans):
            outs = [torch.empty_like(r) for r in ref]

            def run():
                code = lib.gs_fusion_pick(
                    *(ab._p(t) for t in (scores, dxs, dys, dts, pose0,
                                         center, dc, dt, use, off_xy,
                                         off_t, *outs, None, None)),
                    p, nt, ny, nx, 1, 1,
                    0 if use is None else use.shape[-1], kw["stride"],
                    5, 5, lanes, per_slab, staged, kw["prior_weight"],
                    *fusions._motion_args(motion),
                    stream_handle(scores.device))
                _build.check("gs_fusion_pick", code)

            run()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(outs, ref))
            same_all &= same
            ms = cs.graph_ms(run, REPS)
            cs.say("pick_sweep", stage=stage, particles=p, lanes=lanes,
                   per_slab=per_slab, staged=bool(staged),
                   chosen=(lanes, per_slab, bool(staged)) == tuple(chosen),
                   bits_equal=same, graph_ms=ms, bound_ms=bound,
                   bound_by=by, share_of_bound=bound / ms)
        del call, ref, scores
        torch.cuda.empty_cache()
    for (stage, shape), p in ((w, p) for w in WIDE.items()
                              for p in WIDE_PARTICLES):
        call = ab.pick_inputs(p, stage, gen, shape=shape)
        kw = dict(motion=motion, prior_weight=0.7, stride=3)
        got = fusions.pick_cuda(*call, **kw)
        want = fusions.pick_plain(*call, **kw)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
        same_all &= same
        ms = cs.graph_ms(lambda: fusions.pick_cuda(*call, **kw), REPS)
        bound, by = cs.fusion_bound("F3", call, kw)
        cs.say("pick_wide", stage=stage, shape=list(shape), particles=p,
               plan=fusions.pick_plan(p, *shape)._asdict(),
               bits_equal_plain=same, graph_ms=ms, bound_ms=bound,
               bound_by=by, share_of_bound=bound / ms)
        del call, got, want
    print(json.dumps({"bits_equal": same_all}), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
