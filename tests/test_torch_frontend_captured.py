"""The port's pose-graph frontend on its compiled pieces (models/frontend.py's
ClosureVerifier and MapRebuild, models/posegraph.CapturedOptimize), held to
their eager forms on the CPU, where the same static-buffer code runs with
the body called where the card replays a CUDA graph; and the config-5
demo's chain-broken graph (scripts/config5_demo.py:104-135) against the
JAX frontend.

Tolerances: captured against eager exact (the same operations on the same
inputs).  The config-5 graph against JAX as tests/test_torch_frontend.py
holds the frontend: accepted pairs exact, closure poses and scores 1e-4,
optimized poses 1e-4 and chi2 rtol 1e-4.
"""

import collections
import math

import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models.frontend import FrontendConfig as JFrontendConfig
from gridmap_slam_tpu.models.frontend import PoseGraphSLAM as JPoseGraphSLAM
from gridmap_slam_tpu.ops.geometry import deskew_scan as j_deskew_scan
from gridmap_slam_tpu_torch import FrontendConfig, PoseGraphSLAM, SlamConfig
from gridmap_slam_tpu_torch.config import MapConfig
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            frontend_config_from_jax)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 multi_room_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models import posegraph as PG
from gridmap_slam_tpu_torch.models.captured import Graphed
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
from gridmap_slam_tpu_torch.ops.motion import apply_odometry
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(1)

FCFG = FrontendConfig(max_candidates=8, closure_min_gap=6)
CFG = SlamConfig(num_particles=8, max_beams=96,
                 map=MapConfig(width_m=6.0, height_m=6.0, resolution=0.1,
                               origin=(-3.0, -3.0)))


@pytest.fixture(scope="module")
def keyframes():
    """The (pose, deskewed scan) pairs a frontend promotes on the
    dead-reckoned 40-revolution square path of tests/test_torch_frontend.py
    (6 x 6 m at 10 cm, closure batches of 8): 24 keyframes, 7 candidate
    pairs, 3 of them among the first 22 keyframes."""
    frames, _ = simulate_log(default_world(), square_path_controls(40),
                             params=SimParams(beams_per_rev=90,
                                              encoder_noise_sd=6.0), seed=5)
    fe = PoseGraphSLAM(CFG, FCFG, device="cpu")
    batch = frames_to_device(frames, 96, 10.0)
    pose = torch.zeros(3)
    for i in range(len(frames)):
        f = frame_at(batch, i)
        pose = apply_odometry(pose, f.odom)
        fe.add(pose, deskew_scan(f.scan, f.odom))
    return list(zip(fe.kf_poses, fe.kf_scans))


def frontend(keyframes):
    fe = PoseGraphSLAM(CFG, FCFG, device="cpu")
    for pose, scan in keyframes:
        assert fe.add(pose, scan)
    return fe


@pytest.fixture
def captures(monkeypatch):
    """Calls of each compiled piece's capture() by class name (on the CPU
    the call makes the static buffers' graph-free run; on the card it
    captures)."""
    counts = collections.Counter()
    real = Graphed.capture

    def capture(self):
        counts[type(self).__name__] += 1
        real(self)

    monkeypatch.setattr(Graphed, "capture", capture)
    return counts


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_captured_verifier_is_the_eager_verifier_at_a_padded_batch(
        keyframes, captures):
    fe = frontend(keyframes)
    pairs, padded = fe.candidate_pairs()
    assert 0 < len(pairs) < len(padded) == FCFG.max_candidates
    got = fe.verify(padded)
    assert got[0].shape == (FCFG.max_candidates, 3)
    assert_same(got, fe.verify_eager(padded))
    assert captures == {"ClosureVerifier": 1}


def test_a_second_detection_reuses_the_capture(keyframes, captures):
    fe = frontend(keyframes[:22])
    first, _ = fe.candidate_pairs()
    assert len(first) == 3
    fe.detect_closures()
    for pose, scan in keyframes[22:]:
        fe.add(pose, scan)
    pairs, padded = fe.candidate_pairs()
    assert len(pairs) > 0 and not set(pairs) & set(first)
    assert_same(fe.verify(padded), fe.verify_eager(padded))
    assert fe.detect_closures() >= 1
    assert captures == {"ClosureVerifier": 1}
    assert fe.candidate_pairs() == ([], []) and fe.detect_closures() == 0


@pytest.mark.parametrize("chain_breaks", [(), (5,)])
def test_captured_gauss_newton_is_optimize(keyframes, captures,
                                           chain_breaks):
    fe = frontend(keyframes)
    assert fe.detect_closures() >= 3
    graph = fe.graph(chain_breaks)
    want, want_chi2 = PG.optimize(graph, iterations=FCFG.gn_iterations)
    opt, chi2 = fe.optimize(chain_breaks)
    assert np.array_equal(opt, want.nodes.numpy().astype(np.float64))
    assert np.array_equal(chi2, want_chi2.numpy())
    assert chi2[-1] < chi2[0]
    # the same size replays; a graph of another size recaptures
    again, again_chi2 = fe.solver(graph, iterations=FCFG.gn_iterations)
    assert_same((again.nodes, again_chi2), (want.nodes, want_chi2))
    assert again.edge_i is graph.edge_i
    assert captures["CapturedOptimize"] == 1
    other = fe.graph(() if chain_breaks else (5,))
    assert abs(other.edge_i.shape[0] - graph.edge_i.shape[0]) == 1
    got = fe.solver(other, iterations=FCFG.gn_iterations)
    want = PG.optimize(other, iterations=FCFG.gn_iterations)
    assert_same((got[0].nodes, got[1]), (want[0].nodes, want[1]))
    assert captures["CapturedOptimize"] == 2


def test_replayed_rebuild_is_the_eager_loop(keyframes, captures):
    fe = frontend(keyframes[:20])
    got = fe.rebuild_map()
    assert got.shape == (CFG.map.cells_y, CFG.map.cells_x)
    assert (got != 0).float().mean() > 0.3
    assert torch.equal(got, fe.rebuild_map_eager())
    assert torch.equal(fe.rebuild_map(), got)
    assert fe.rebuilder.capacity == 20 and captures == {"MapRebuild": 1}
    # a shorter list replays the same graph fewer times
    short = frontend(keyframes[:9])
    assert torch.equal(fe.rebuilder(short.kf_scans,
                                    np.asarray(short.kf_poses)),
                       short.rebuild_map_eager())
    assert captures == {"MapRebuild": 1}
    # other poses, the same keyframes
    poses = np.asarray(fe.kf_poses) + [0.05, -0.02, 0.01]
    assert torch.equal(fe.rebuild_map(poses), fe.rebuild_map_eager(poses))
    assert captures == {"MapRebuild": 1}
    # past the capacity: a new bank and a new capture
    for pose, scan in keyframes[20:]:
        fe.add(pose, scan)
    assert torch.equal(fe.rebuild_map(), fe.rebuild_map_eager())
    assert fe.rebuilder.capacity == len(keyframes)
    assert captures == {"MapRebuild": 2}


@pytest.mark.parametrize("order", ["longest_first"])
def test_rebuild_launches_a_graph_a_chunk_of_keyframes(keyframes, captures,
                                                       order):
    """The rebuild's lax.scan as graphs of CHUNK_SCANS keyframes: one bank
    of 40 keyframes (the 24 and the first 16 again, shifted), then lists of
    1, 15, 16, 17 and 40 on it: each the eager loop's bits in
    ceil(n / CHUNK_SCANS) launches, with no recapture below the bank's
    capacity."""
    from gridmap_slam_tpu_torch.models.captured import CHUNK_SCANS

    fe = frontend(keyframes)
    scans = list(fe.kf_scans) + list(fe.kf_scans[:16])
    poses = list(fe.kf_poses) + [p + [0.03, -0.02, 0.01]
                                 for p in fe.kf_poses[:16]]
    assert len(scans) == 40
    for n in (40, 1, 15, 16, 17, 40):
        fe.kf_scans, fe.kf_poses = scans[:n], poses[:n]
        got = fe.rebuild_map()
        assert torch.equal(got, fe.rebuild_map_eager()), n
        assert fe.rebuilder.launches == -(-n // CHUNK_SCANS), n
        assert fe.rebuilder.capacity == 40
    assert captures == {"MapRebuild": 1}


def test_config5_chain_broken_graph_against_jax(captures):
    """scripts/config5_demo.py's joint graph: both robots' dead-reckoned
    chains in one frontend (keyframe_dist 0, closure_min_gap 4,
    closure_max_dist 1.6), the seam edge dropped, optimized by the
    frontend's Gauss-Newton and rebuilt; the JAX demo's 32 closures, all
    cross-robot (docs/config5_demo.json)."""
    revs = 20
    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, math.pi)]
    logs = [simulate_log(world, [(0.25, 0.0)] * revs, params=params,
                         seed=11 + r, start_pose=starts[r])
            for r in range(2)]
    jcfg = JSlamConfig(num_particles=32, max_beams=96,
                       sensor=JSensorConfig(max_range=8.0),
                       map=JMapConfig(width_m=14.0, height_m=8.0,
                                      resolution=0.1, origin=(-7.0, -4.0)))
    fcfg = JFrontendConfig(keyframe_dist=0.0, closure_min_gap=4,
                           closure_max_dist=1.6)
    jfe = JPoseGraphSLAM(jcfg, fcfg)
    tfe = PoseGraphSLAM(config_from_jax(jcfg), frontend_config_from_jax(fcfg),
                        device="cpu")
    for r, (frames, _) in enumerate(logs):
        jb = j_frames_to_device(frames, 96, 8.0)
        tb = frames_to_device(frames, 96, 8.0)
        pose = torch.tensor(starts[r], dtype=torch.float32)
        for t in range(revs):
            jf, f = j_frame_at(jb, t), frame_at(tb, t)
            pose = apply_odometry(pose, f.odom)
            assert jfe.add(pose.numpy().astype(np.float64),
                           j_deskew_scan(jf.scan, jf.odom))
            assert tfe.add(pose, deskew_scan(f.scan, f.odom))
    assert jfe.detect_closures() == tfe.detect_closures() == 32
    assert sum((i < revs) != (j < revs) for i, j, _, _ in tfe.closures) == 32
    for (ai, aj, az, ascore), (bi, bj, bz, bscore) in zip(jfe.closures,
                                                          tfe.closures):
        assert (ai, aj) == (bi, bj)
        np.testing.assert_allclose(bz, az, atol=1e-4)
        assert abs(ascore - bscore) <= 1e-4

    brk = (revs - 1,)
    eager, eager_chi2 = PG.optimize(tfe.graph(brk), iterations=10)
    opt_j, chi_j = jfe.optimize(chain_breaks=brk)
    opt_t, chi_t = tfe.optimize(chain_breaks=brk)
    assert np.array_equal(opt_t, eager.nodes.numpy().astype(np.float64))
    assert np.array_equal(chi_t, eager_chi2.numpy())
    np.testing.assert_allclose(chi_t, chi_j, rtol=1e-4)
    assert np.isfinite(chi_t).all() and chi_t[-1] < chi_t[0]
    np.testing.assert_allclose(opt_t, opt_j, atol=1e-4)
    for r, (_, gt) in enumerate(logs):
        rows = slice(r * revs, (r + 1) * revs)
        assert abs(ate_rmse(opt_t[rows], gt) - ate_rmse(opt_j[rows], gt)) \
            <= 1e-4
    assert torch.equal(tfe.rebuild_map(), tfe.rebuild_map_eager())
    assert captures == {"ClosureVerifier": 1, "CapturedOptimize": 1,
                        "MapRebuild": 1}
