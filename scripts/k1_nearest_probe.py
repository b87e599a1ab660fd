"""K1's nearest-cell branch against its plain version on the card, each
score beyond the tolerance traced to its taps.

The benchmark holds every K1 call to its plain version
(gridmap_slam_tpu_torch/bench/kernels/k1.py): no score beyond rtol /
atol, nearest calls included (K1_NEAREST_MAX_SHARE = 0).  A nearest tap
rounds its cell coordinate, so a coordinate within a few ulps of a half
cell goes to either neighbour depending on the float order that computed
it, and with the coarse stage's cell-aligned offsets one such tap moves a
block of candidates.  The kernel and the plain version compute it in one
order (ops/cuda/matcher.cell_coords, JAX's compiled order), so such ties
should round alike and leave no score beyond.

For each preset with `matcher.coarse_halfres=false` and each seed, this
script replays the 12-scan log eagerly (RBPF.replay from the benchmark's
rep-0 generator seed, as its agreement replay does) with every nearest K1
call wrapped: the call's share of scores beyond the tolerance, those
scores' count, how many of them a tie explains (a candidate with a used
beam whose float64 cell coordinate lies within TIE_CELLS of a half cell),
and the ties (used beams' coordinates that near a half cell) in the call.

Usage (needs a GPU; ~1 min):
    python scripts/k1_nearest_probe.py [--presets pr1,parity]
        [--seeds 0,1,2,3,4]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridmap_slam_tpu_torch import RBPF  # noqa: E402
from gridmap_slam_tpu_torch.bench import cells as C  # noqa: E402
from gridmap_slam_tpu_torch.bench.kernels import k1  # noqa: E402
from gridmap_slam_tpu_torch.bench.run import rep_seed  # noqa: E402
from gridmap_slam_tpu_torch.io import frames_to_device  # noqa: E402
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch  # noqa: E402

TIE_CELLS = 1e-3


def half_cell_distance(field, px, py, use, pose0, dxs, dys, dts,
                       resolution, origin):
    """Each used beam's float64 cell coordinates' distance to the nearest
    half cell: (x (P, nt, nx, B), y (P, nt, ny, B)); unused beams inf."""
    d = torch.float64
    p = pose0.shape[0]
    if px.dim() == 2:
        px, py, use = (kmatch.per_particle(a, p)[:, None]
                       for a in (px, py, use))
    theta = pose0[:, 2, None].to(d) + dts.to(d)
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    rx = px.to(d) * c - py.to(d) * s
    ry = px.to(d) * s + py.to(d) * c
    fx = ((rx[:, :, None, :] + (pose0[:, 0, None].to(d) + dxs.to(d))
           [:, None, :, None]) - origin[0]) / resolution - 0.5
    fy = ((ry[:, :, None, :] + (pose0[:, 1, None].to(d) + dys.to(d))
           [:, None, :, None]) - origin[1]) / resolution - 0.5

    def dist(f):
        return torch.where(use[..., None, :] if use.dim() == 3 else use,
                           (f - torch.floor(f) - 0.5).abs(), float("inf"))
    return dist(fx), dist(fy)


def probe(preset: str, seed: int) -> dict:
    cfg = C.load_presets()[preset].config.with_overrides(
        {"matcher.coarse_halfres": False})
    frames, _ = C.build_log(12, 180, seed)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    eng = RBPF(cfg, device="cuda")
    real = kmatch.stage_scores_batch_cuda
    calls = []

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if kw["nearest"]:
            ref = kmatch.stage_scores_batch_plain(*args, **kw)
            beyond = (out - ref).abs() > k1.K1_ATOL + k1.K1_RTOL * ref.abs()
            dx, dy = half_cell_distance(*args, kw["resolution"], kw["origin"])
            tie_x, tie_y = dx < TIE_CELLS, dy < TIE_CELLS
            # (P, nt, ny, nx): a used beam of the candidate near a half cell
            tied = (tie_x[:, :, None, :, :] | tie_y[:, :, :, None, :]).any(-1)
            calls.append(dict(
                share=float(beyond.float().mean()),
                beyond=int(beyond.sum()),
                explained=int((beyond & tied).sum()),
                ties=int(tie_x.sum() + tie_y.sum()),
                scores=out.numel(),
                max_abs_err=float((out - ref).abs().max())))
        return out

    kmatch.stage_scores_batch_cuda = wrapped
    try:
        g = torch.Generator(device="cuda").manual_seed(rep_seed(seed, 0))
        eng.replay(eng.init(), batch, g)
        torch.cuda.synchronize()
    finally:
        kmatch.stage_scores_batch_cuda = real
    shares = [c["share"] for c in calls]
    return dict(preset=preset, particles=cfg.num_particles,
                chunk=cfg.particle_chunk, seed=seed,
                nearest_calls=len(calls), max_share=max(shares),
                calls_over_limit=sum(s > k1.K1_NEAREST_MAX_SHARE
                                     for s in shares),
                beyond=sum(c["beyond"] for c in calls),
                explained=sum(c["explained"] for c in calls),
                ties=sum(c["ties"] for c in calls),
                scores=sum(c["scores"] for c in calls),
                max_abs_err=max(c["max_abs_err"] for c in calls),
                shares=shares)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", default="pr1,parity")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_nearest_probe: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rows = [probe(p, int(s)) for p in args.presets.split(",")
            for s in args.seeds.split(",")]
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "limit": k1.K1_NEAREST_MAX_SHARE, "tie_cells": TIE_CELLS,
        "all_beyond_explained_by_ties": all(r["beyond"] == r["explained"]
                                            for r in rows),
        "runs_over_limit": {f"{r['preset']} seed {r['seed']}":
                            r["calls_over_limit"] for r in rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
