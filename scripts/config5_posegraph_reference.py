"""The JAX frontend's own Gauss-Newton on the config-5 demo's chain-broken
pose graph, on the CPU: the reference figure that `chip_smoke.py`'s
`config5_posegraph` phase holds the PyTorch port's frontend to on the card.

`scripts/config5_demo.py` builds the graph (the two robots' dead-reckoned
chains, closures over the combined keyframes, the seam edge dropped) and
optimizes it with the mesh-distributed optimizer (damping 1e-3, 8
iterations).  This script feeds the same keyframes to the same
PoseGraphSLAM and optimizes with `PoseGraphSLAM.optimize(chain_breaks=)`,
the single-device Gauss-Newton the port's frontend runs (10 iterations,
damping 1e-6), and prints one JSON line: closures (and how many join the
two robots), chi2 first and last, and each robot's ATE before and after.

    JAX_PLATFORMS=cpu python scripts/config5_posegraph_reference.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def run(num_revs: int = 20) -> dict:
    from gridmap_slam_tpu.config import MapConfig, SensorConfig, SlamConfig
    from gridmap_slam_tpu.io import frame_at, frames_to_device
    from gridmap_slam_tpu.io.synthetic import (SimParams, multi_room_world,
                                               simulate_log)
    from gridmap_slam_tpu.models.frontend import FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu.ops.geometry import deskew_scan
    from gridmap_slam_tpu.ops.motion import apply_odometry
    from gridmap_slam_tpu.utils.metrics import ate_rmse

    # scripts/config5_demo.py:62-79
    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    cfg = SlamConfig(num_particles=32, max_beams=96,
                     sensor=SensorConfig(max_range=8.0),
                     map=MapConfig(width_m=14.0, height_m=8.0, resolution=0.1,
                                   origin=(-7.0, -4.0)))
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, np.pi)]
    logs = [simulate_log(world, [(0.25, 0.0)] * num_revs, params=params,
                         seed=11 + i, start_pose=starts[i])
            for i in range(2)]
    batches = [frames_to_device(f, cfg.max_beams, cfg.sensor.max_range)
               for f, _ in logs]

    # scripts/config5_demo.py:104-135: dead-reckoned chains, one graph
    fe = PoseGraphSLAM(cfg, FrontendConfig(
        keyframe_dist=0.0, closure_min_gap=4, closure_max_dist=1.6))
    dr = np.zeros((2, num_revs, 3))
    for r in range(2):
        pose = np.asarray(starts[r], np.float64)
        for t in range(num_revs):
            f = frame_at(batches[r], t)
            pose = np.asarray(apply_odometry(jnp.asarray(pose, jnp.float32),
                                             f.odom), np.float64)
            dr[r, t] = pose
            fe.add(pose, deskew_scan(f.scan, f.odom))
    n_closures = fe.detect_closures()
    cross = sum(1 for a, b, _, _ in fe.closures
                if (a < num_revs) != (b < num_revs))
    opt, chi2 = fe.optimize(chain_breaks=(num_revs - 1,))
    gts = [gt for _, gt in logs]
    return {
        "backend": f"jax {jax.__version__} {jax.devices()[0].platform}",
        "keyframes": fe.num_keyframes, "closures": int(n_closures),
        "closures_cross_robot": int(cross),
        "chi2_first": float(chi2[0]), "chi2_last": float(chi2[-1]),
        "dead_reckoning_ate_m": [ate_rmse(dr[r], gts[r]) for r in range(2)],
        "optimized_ate_m": [ate_rmse(opt[r * num_revs:(r + 1) * num_revs],
                                     gts[r]) for r in range(2)],
    }


if __name__ == "__main__":
    print(json.dumps(run()))
