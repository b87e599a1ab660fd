"""The port's pose-graph frontend (models/frontend.py), held to the JAX
package's PoseGraphSLAM on the CPU: keyframes, closure detection, the
optimized graph with a chain break, and the rebuilt map.

Tolerances: keyframe decisions and accepted pairs exact; closure poses and
scores 1e-4 (tests/test_torch_posegraph.py); optimized poses 1e-4 and chi2
rtol 1e-4; the rebuilt map within K2's tolerance (1e-5 on all but 0.5 % of
cells, tests/test_pallas.py:124-126).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models.frontend import FrontendConfig as JFrontendConfig
from gridmap_slam_tpu.models.frontend import PoseGraphSLAM as JPoseGraphSLAM
from gridmap_slam_tpu.ops.geometry import deskew_scan as j_deskew_scan
from gridmap_slam_tpu_torch import FrontendConfig, PoseGraphSLAM
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            frontend_config_from_jax)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
from gridmap_slam_tpu_torch.ops.motion import apply_odometry

torch.set_num_threads(1)

K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3


@pytest.fixture(scope="module")
def frontends():
    """Both frontends fed the dead-reckoned poses and deskewed scans of a
    40-revolution square path with noisy encoders (the loop closes on
    itself), 6 x 6 m at 10 cm, closure batches of 8."""
    frames, _ = simulate_log(default_world(), square_path_controls(40),
                             params=SimParams(beams_per_rev=90,
                                              encoder_noise_sd=6.0), seed=5)
    jcfg = JSlamConfig(num_particles=8, max_beams=96,
                       map=JMapConfig(width_m=6.0, height_m=6.0,
                                      resolution=0.1, origin=(-3.0, -3.0)))
    fcfg = JFrontendConfig(max_candidates=8, closure_min_gap=6)
    jfe = JPoseGraphSLAM(jcfg, fcfg)
    tfe = PoseGraphSLAM(config_from_jax(jcfg), frontend_config_from_jax(fcfg),
                        device="cpu")
    jb = j_frames_to_device(frames, 96, 10.0)
    tb = frames_to_device(frames, 96, 10.0)
    pose = torch.zeros(3)
    promoted = []
    for i in range(len(frames)):
        jf, f = j_frame_at(jb, i), frame_at(tb, i)
        pose = apply_odometry(pose, f.odom)
        dr = pose.numpy().astype(np.float64)
        promoted.append((jfe.add(dr, j_deskew_scan(jf.scan, jf.odom)),
                         tfe.add(pose, deskew_scan(f.scan, f.odom))))
    return jfe, tfe, promoted


def test_frontend_config_carries_over():
    jc = JFrontendConfig(keyframe_dist=0.5, max_candidates=4)
    assert dataclasses.asdict(frontend_config_from_jax(jc)) == \
        dataclasses.asdict(jc)
    assert dataclasses.asdict(FrontendConfig()) == \
        dataclasses.asdict(JFrontendConfig())


def test_keyframes_closures_optimize_rebuild(frontends):
    jfe, tfe, promoted = frontends
    assert all(a == b for a, b in promoted)
    assert tfe.num_keyframes == jfe.num_keyframes > 15
    n_j, n_t = jfe.detect_closures(), tfe.detect_closures()
    assert n_t == n_j >= 3
    for (ai, aj, az, ascore), (bi, bj, bz, bscore) in zip(jfe.closures,
                                                          tfe.closures):
        assert (ai, aj) == (bi, bj)
        np.testing.assert_allclose(bz, az, atol=1e-4)
        assert abs(ascore - bscore) <= 1e-4
    assert jfe.detect_closures() == tfe.detect_closures() == 0   # all seen

    # the graph without one odometry edge: closures carry the loop
    brk = (5,)
    opt_j, chi_j = jfe.optimize(chain_breaks=brk)
    opt_t, chi_t = tfe.optimize(chain_breaks=brk)
    assert len(tfe.graph(brk).edge_i) == tfe.num_keyframes - 2 + n_t
    np.testing.assert_allclose(chi_t, chi_j, rtol=1e-4)
    assert chi_t[-1] < chi_t[0]
    np.testing.assert_allclose(opt_t, opt_j, atol=1e-4)

    want = np.asarray(jfe.rebuild_map())
    got = tfe.rebuild_map()
    assert got.shape == (60, 60)
    assert (want != 0).mean() > 0.3
    assert (np.abs(got.numpy() - want) > K2_ATOL).mean() <= K2_MAX_FRAC
