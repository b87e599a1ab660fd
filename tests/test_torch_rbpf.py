"""The PyTorch port's RBPF as a whole, held to the JAX package's.

torch's generators cannot reproduce JAX's threefry draws, so step parity
rebuilds JAX's exact draws from the state key and injects them into the
port's step.  Whole runs are held by the cross-backend ATE policy of
docs/DIVERGENCES.md (tests/test_backend_divergence.py): within 0.06 m of
the JAX run, and under the absolute bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu import RBPF as JRBPF
from gridmap_slam_tpu import SlamConfig as JSlamConfig
from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu_torch import RBPF
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                       read_recording, write_recording)
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(1)

K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3


@pytest.fixture(scope="module")
def small_log():
    return simulate_log(default_world(), square_path_controls(8),
                        params=SimParams(beams_per_rev=90), seed=7)


def _jax_draws(key, p):
    """The draws of gridmap_slam_tpu RBPF.step for state key `key`: split
    into (next, motion, resample) keys (rbpf.py:217-218), one key per
    particle, each split again for the distance and heading normals
    (motion.py:41-43), and u0 ~ U[0, 1/P) (resample.py:117)."""
    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jax.vmap(normals)(jax.random.split(k_motion, p))
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    return torch.from_numpy(np.array(n)), torch.tensor(float(u0))


@pytest.mark.parametrize("resample_fraction,in_place", [
    pytest.param(0.5, False, id="0.5"), pytest.param(1.0, False, id="1.0"),
    pytest.param(0.0, False, id="0.0"),
    pytest.param(1.0, True, id="1.0-out_state"),
    pytest.param(0.0, True, id="0.0-out_state")])
def test_step_parity_with_injected_draws(small_log, resample_fraction,
                                         in_place):
    """One step from the same state with the same draws, for 3 successive
    JAX states.  resample_fraction 1.0 resamples on every step, so the
    resample gather is compared too; 0.0 never does (the gate's identity).
    in_place: the step writes its new state into the state it reads
    (out=state, as the captured replays do)."""
    frames, _ = small_log
    jcfg = JSlamConfig(num_particles=8, max_beams=96, particle_chunk=4,
                       resample_fraction=resample_fraction,
                       map=JMapConfig(width_m=3.0, height_m=3.0,
                                      origin=(-1.5, -1.5)))
    jeng = JRBPF(jcfg)
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step)
    jstate = jeng.init(jax.random.key(0))
    resampled = []
    for i in range(3):
        # both sides start from the same JAX state, so nothing compounds
        state = state_from_jax_arrays(
            np.asarray(jstate.poses), np.asarray(jstate.log_weights),
            np.asarray(jstate.logodds), np.asarray(jstate.step))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        nxt, info = eng.step(state, frame_at(batch, i),
                             draws=_jax_draws(jstate.key, 8),
                             out=state if in_place else None)
        assert (nxt is state) == in_place

        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        lo_j = np.asarray(jnext.logodds)
        assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
        assert (lo_j != np.asarray(jstate.logodds)).mean() > 0.01
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        assert bool(info.resampled) == bool(jinfo.resampled)
        assert int(info.best_index) == int(jinfo.best_index)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        assert int(nxt.step) == int(jnext.step) == i + 1
        resampled.append(bool(info.resampled))
        jstate = jnext
    if resample_fraction == 1.0:   # the first step's particles are identical
        assert all(resampled[1:])
    if resample_fraction == 0.0:
        assert not any(resampled)


@pytest.mark.parametrize("resample_fraction", [0.0, 1.0])
def test_step_in_place_keeps_the_maps_storage(small_log, resample_fraction):
    """step(state, frame, out=state) writes the new maps into the state's
    own (P, H, W) tensor; on a scan whose gate does not fire they are, bit
    for bit, K2's update of the old maps at the matched poses (the maps
    move once, at the identity)."""
    from gridmap_slam_tpu_torch.ops.cuda.grid_update import (
        integrate_scan_batch, scan_bin_tables)
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    frames, _ = small_log
    jcfg = JSlamConfig(num_particles=8, max_beams=96, particle_chunk=4,
                       resample_fraction=resample_fraction,
                       map=JMapConfig(width_m=3.0, height_m=3.0,
                                      origin=(-1.5, -1.5)))
    cfg = config_from_jax(jcfg)
    eng = RBPF(cfg, device="cpu")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    state, gen = eng.init(), torch.Generator().manual_seed(0)
    state, _ = eng.step(state, frame_at(batch, 0), gen)
    ptr = state.logodds.data_ptr()
    for i in (1, 2):
        old = state.logodds.clone()
        frame = frame_at(batch, i)
        nxt, info = eng.step(state, frame, gen, out=state)
        assert nxt is state and state.logodds.data_ptr() == ptr
        assert bool(info.resampled) == (resample_fraction == 1.0)
        if resample_fraction == 0.0:
            scan = deskew_scan(frame.scan, frame.odom)
            want = integrate_scan_batch(
                old, state.poses, torch.ones(()),
                *scan_bin_tables(scan, cfg.beam_lut_bins),
                resolution=cfg.map.resolution,
                origin=tuple(float(o) for o in cfg.map.origin),
                l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
                tol_cells=cfg.sensor.hit_tolerance_cells)
            assert torch.equal(state.logodds, want)
            assert not torch.equal(state.logodds, old)


@pytest.mark.parametrize("coarse_halfres", [True, False])
def test_step_parity_at_pr1(small_log, coarse_halfres):
    """bench.py's pr1 (config.pr1_config: a 20 x 20 m map at 5 cm, 400 x
    400 cells, one chunk) at 4 particles, its coarse stage on the pooled
    200 x 200 field or (coarse_halfres=False, bench.py's parity_pallas
    rung) on nearest cells of the full field: one step from the same JAX
    state with JAX's draws, for 2 successive states, within
    test_step_parity_with_injected_draws's tolerances."""
    frames, _ = small_log
    p = 4
    jcfg = JSlamConfig(num_particles=p, max_beams=96, particle_chunk=0,
                       resample_fraction=1.0,
                       map=JMapConfig(width_m=20.0, height_m=20.0,
                                      resolution=0.05,
                                      origin=(-10.0, -10.0))
                       ).with_overrides(
        {"matcher.coarse_halfres": coarse_halfres})
    assert (jcfg.map.cells_y, jcfg.map.cells_x) == (400, 400)
    jeng = JRBPF(jcfg)
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step)
    jstate = jeng.init(jax.random.key(1))
    for i in range(2):
        state = state_from_jax_arrays(
            np.asarray(jstate.poses), np.asarray(jstate.log_weights),
            np.asarray(jstate.logodds), np.asarray(jstate.step))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        nxt, info = eng.step(state, frame_at(batch, i),
                             draws=_jax_draws(jstate.key, p))
        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        lo_j = np.asarray(jnext.logodds)
        assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
        assert (lo_j != np.asarray(jstate.logodds)).mean() > 0.002
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        assert int(info.best_index) == int(jinfo.best_index)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        jstate = jnext


def _pr1_jax_config(coarse_halfres):
    return JSlamConfig(num_particles=4, max_beams=96, particle_chunk=0,
                       map=JMapConfig(width_m=20.0, height_m=20.0,
                                      resolution=0.05, origin=(-10.0, -10.0))
                       ).with_overrides(
        {"matcher.coarse_halfres": coarse_halfres})


@pytest.mark.parametrize("coarse_halfres", [True, False])
def test_matcher_stages_at_pr1(small_log, monkeypatch, coarse_halfres):
    """Each stage of the port's correlative_match_batch against the JAX
    package's correlative_match, particle by particle, on pr1's 400 x 400
    field: the coarse stage on the 2 x 2-pooled 200 x 200 field
    (bilinear at 0.1 m) or, coarse_halfres=False, on nearest cells of the
    full field; then the two bilinear stages.  Scores within K1's
    tolerances (tests/test_pallas_matcher.py), the same best poses."""
    import gridmap_slam_tpu.ops.matcher as jm
    import gridmap_slam_tpu_torch.ops.matcher as tm

    frames, _ = small_log
    jcfg = _pr1_jax_config(coarse_halfres)
    cfg = config_from_jax(jcfg)
    m, p = jcfg.map, jcfg.num_particles
    rng = np.random.default_rng(11)
    ll_out = np.log(1.0 / jcfg.sensor.max_range)
    llf = rng.uniform(ll_out, 0.0, (m.cells_y, m.cells_x)).astype(np.float32)
    pose0 = np.stack([rng.uniform(-1.0, 1.0, p), rng.uniform(-1.0, 1.0, p),
                      rng.uniform(-np.pi, np.pi, p)], 1).astype(np.float32)
    jf = j_frame_at(j_frames_to_device(frames, jcfg.max_beams,
                                       jcfg.sensor.max_range), 3)
    tf = frame_at(frames_to_device(frames, jcfg.max_beams,
                                   jcfg.sensor.max_range), 3)
    kw = dict(resolution=m.resolution, origin=m.origin,
              max_range=jcfg.sensor.max_range)

    jax_stages = []
    real_j = jm._stage_scores

    def j_spy(*args, **k):
        out = real_j(*args, **k)
        jax_stages.append((np.asarray(out), args[0].shape, k["resolution"],
                           k["nearest"]))
        return out
    monkeypatch.setattr(jm, "_stage_scores", j_spy)
    want = []
    for i in range(p):
        best, _ = jm.correlative_match(
            jnp.asarray(llf), jf.scan, jnp.asarray(pose0[i]), jf.odom,
            matcher_cfg=jcfg.matcher, motion_cfg=jcfg.motion, **kw)
        want.append(np.asarray(best))

    port_stages = []
    real_t = tm.stage_scores_batch

    def t_spy(*args, **k):
        out = real_t(*args, **k)
        port_stages.append((out.numpy(), tuple(args[0].shape[1:]),
                            k["resolution"], k["nearest"]))
        return out
    monkeypatch.setattr(tm, "stage_scores_batch", t_spy)
    best_t, _ = tm.correlative_match_batch(
        torch.from_numpy(llf)[None], tf.scan, torch.from_numpy(pose0),
        tf.odom, matcher_cfg=cfg.matcher, motion_cfg=cfg.motion, **kw)

    coarse = ((200, 200), 0.1, False) if coarse_halfres else \
        ((400, 400), 0.05, True)
    assert [s[1:] for s in port_stages] == [
        coarse, ((400, 400), 0.05, False), ((400, 400), 0.05, False)]
    assert len(jax_stages) == 3 * p
    for k, (scores, *call) in enumerate(port_stages):
        for i in range(p):
            jscores, *jcall = jax_stages[3 * i + k]
            assert (tuple(jcall[0]), *jcall[1:]) == tuple(call)
            np.testing.assert_allclose(scores[i], jscores, rtol=2e-5,
                                       atol=2e-4)
    np.testing.assert_allclose(best_t.numpy(), np.stack(want), atol=1e-5)


def test_replay_ate_bound(small_log, tmp_path):
    """Mirror of tests/test_e2e.py::test_replay_ate_bound on the port."""
    frames, gt = small_log
    p = tmp_path / "log.rec"
    write_recording(p, frames)
    frames = read_recording(p)

    from gridmap_slam_tpu_torch import SlamConfig
    cfg = SlamConfig(num_particles=12, max_beams=96)
    eng = RBPF(cfg, device="cpu")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    state, infos = eng.run_log(eng.init(), [frame_at(batch, i)
                                            for i in range(len(frames))],
                               torch.Generator().manual_seed(0))
    traj = torch.stack([i.weighted_pose for i in infos]).numpy()
    assert np.isfinite(traj).all()
    ate = ate_rmse(traj, gt)
    assert ate < 0.25, f"ATE {ate} exceeds bound"
    m = eng.best_map(state).numpy()
    assert (m > 0).sum() > 50
    assert (m < 0).sum() > 1000
    occ = eng.combined_occupancy(state).numpy()
    assert occ.shape == m.shape and ((occ >= 0) & (occ <= 1)).all()


def test_init_from_map_matches():
    jcfg = JSlamConfig(num_particles=4, map=JMapConfig(
        width_m=2.0, height_m=1.5, origin=(-1.0, -0.75)))
    lo = np.random.default_rng(0).normal(size=(30, 40)).astype(np.float32)
    js = JRBPF(jcfg).init_from_map(jax.random.key(0), lo, pose=(0.1, 0.2, 0.3))
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    ts = eng.init_from_map(lo, pose=(0.1, 0.2, 0.3))
    for f in ("poses", "log_weights", "logodds", "step"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    with pytest.raises(ValueError, match="map shape"):
        eng.init_from_map(lo[:, :20])


def test_determinism(small_log):
    """A fixed generator seed gives bit-identical poses and maps."""
    frames, _ = small_log
    from gridmap_slam_tpu_torch import SlamConfig
    cfg = SlamConfig(num_particles=6, max_beams=96)

    def run():
        eng = RBPF(cfg, device="cpu")
        batch = frames_to_device(frames[:4], cfg.max_beams,
                                 cfg.sensor.max_range)
        state, _ = eng.run_log(eng.init(), [frame_at(batch, i)
                                            for i in range(4)],
                               torch.Generator().manual_seed(42))
        return state.poses.numpy(), state.logodds.numpy()

    p1, m1 = run()
    p2, m2 = run()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(m1, m2)


def test_cross_backend_ate_within_policy():
    """The port's ATE on maps/room_loop_40.rec lies within 0.06 m of the JAX
    gather backend's, and both under 0.25 m (tests/
    test_backend_divergence.py's policy, 48 particles, 18 scans)."""
    n_scans, particles = 18, 48
    frames = read_recording("maps/room_loop_40.rec")
    gt = np.load("maps/room_loop_40_gt.npy")[:n_scans]
    jcfg = JSlamConfig(num_particles=particles, max_beams=192).with_overrides(
        {"matcher.impl": "gather"})

    jeng = JRBPF(jcfg)
    jstate = jeng.init(jax.random.key(0))
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    step = jeng.step_jit(donate=False)
    jtraj = []
    for i in range(n_scans):
        jstate, info = step(jstate, j_frame_at(jbatch, i))
        jtraj.append(np.asarray(info.weighted_pose))

    eng = RBPF(config_from_jax(jcfg), device="cpu")
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    _, infos = eng.run_log(eng.init(), [frame_at(batch, i)
                                        for i in range(n_scans)],
                           torch.Generator().manual_seed(0))
    ttraj = torch.stack([i.weighted_pose for i in infos]).numpy()

    ate_j, ate_t = ate_rmse(np.stack(jtraj), gt), ate_rmse(ttraj, gt)
    assert abs(ate_j - ate_t) <= 0.06, (ate_j, ate_t)
    assert max(ate_j, ate_t) < 0.25, (ate_j, ate_t)
