"""The port's shared-map filter (models/shared.py), held to the JAX
package's SharedMapSLAM on the CPU: step_surface, and the per-particle
matcher step, step and step_blocked.

torch's generators cannot reproduce JAX's threefry draws, so step parity
rebuilds JAX's exact draws from the state key and injects them into the
port's step.  Tolerances are those of tests/test_torch_rbpf.py: poses
within 1e-4, log-weights within 1e-3, map cells beyond 1e-5 on at most
0.5 % of the map (tests/test_pallas.py:124-126).  Whole runs are held by
the cross-backend ATE policy of docs/DIVERGENCES.md: within 0.06 m of the
JAX run and under the absolute bound of tests/test_surface.py:279.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu import SlamConfig as JSlamConfig
from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models import shared as js
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu_torch import SharedMapSLAM
from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig, SlamConfig
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            shared_state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 multi_room_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models import shared as ts
from gridmap_slam_tpu_torch.ops import matcher as tm
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
from gridmap_slam_tpu_torch.ops.raycast import build_beam_lut, integrate_scan
from gridmap_slam_tpu_torch.types import Scan
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(1)

K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
P = 64
_INJECT = {"matcher.surface_reinject_slow": 0.05,
           "matcher.surface_reinject_fast": 0.6}


@pytest.fixture(scope="module")
def small_log():
    return simulate_log(default_world(), square_path_controls(4),
                        params=SimParams(beams_per_rev=90), seed=7)


def _jax_draws(key, p, inject):
    """The draws of gridmap_slam_tpu SharedMapSLAM.step_surface for state
    key `key`: split into (next, motion, resample) keys (shared.py:506),
    one key per particle (:507), each split for the distance and heading
    normals (motion.py:41-43); u0 ~ U[0, 1/P) from the resample key
    (resample.py:117); the injection uniforms from fold_in(resample key, 1)
    (shared.py:450, :222)."""
    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jax.vmap(normals)(jax.random.split(k_motion, p))
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    u = (torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k_resample, 1), (p, 3)))) if inject else None)
    return torch.from_numpy(np.array(n)), torch.tensor(float(u0)), u


def _small_config(case):
    """6 x 6 m at 10 cm, 4 m range (the integration crop, 92 cells, covers
    the map), except "crop": 16 x 10 m with a 48-cell volume crop, so the
    field is built crop-locally and the scan integrated into a 92-cell
    crop read back to the host."""
    over = {"matcher.surface_nt": 9}
    mp = JMapConfig(width_m=6.0, height_m=6.0, resolution=0.1,
                    origin=(-3.0, -3.0))
    if case == "crop":
        mp = JMapConfig(width_m=16.0, height_m=10.0, resolution=0.1,
                        origin=(-8.0, -5.0))
        over["matcher.surface_crop_cells"] = 48
    if case == "resample":
        over["matcher.surface_resample_fraction"] = 1.0
    if case == "inject":
        over.update(_INJECT)
    return JSlamConfig(num_particles=P, max_beams=96,
                       sensor=JSensorConfig(max_range=4.0),
                       map=mp).with_overrides(over)


@pytest.mark.parametrize("case", ["full", "crop", "resample", "inject"])
def test_step_surface_parity_with_injected_draws(small_log, case):
    """One step from the same state with the same draws, for 3 successive
    JAX states.  "resample" resamples on every step, so the gather is
    compared; "inject" sets the recovery EMAs apart before each step after
    the first, so 30 % of the slots are re-drawn uniformly."""
    frames, _ = small_log
    jcfg = _small_config(case)
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step_surface)
    jstate = jeng.init(jax.random.key(0))
    for i in range(3):
        if case == "inject" and i > 0:   # a collapsed fast EMA
            jstate = jstate.replace(recov=jnp.asarray([0.0, -5.0]))
        state = shared_state_from_jax_arrays(
            *(np.asarray(x) for x in (jstate.poses, jstate.log_weights,
                                      jstate.logodds, jstate.step,
                                      jstate.recov)))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        nxt, info = eng.step_surface(
            state, frame_at(batch, i),
            draws=_jax_draws(jstate.key, P, case == "inject"))

        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        lo_j = np.asarray(jnext.logodds)
        assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
        assert (lo_j != np.asarray(jstate.logodds)).mean() > 0.005
        np.testing.assert_allclose(nxt.recov.numpy(), np.asarray(jnext.recov),
                                   atol=1e-4)
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        # the gate compares Neff with a threshold: where the two sit
        # within float noise of each other (the first scan's identical
        # particles give Neff = P) either answer is right
        rf = jcfg.matcher.surface_resample_fraction
        if abs(float(jinfo.neff) - P * rf) > 1e-3 * P:
            assert bool(info.resampled) == bool(jinfo.resampled)
        # on the first scan the map is blank and every particle scores the
        # same, so the argmax is float noise (and unused: the map is then
        # integrated at the weighted mean)
        if float(jinfo.neff) < 0.95 * P:
            assert int(info.best_index) == int(jinfo.best_index)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        np.testing.assert_allclose(float(info.best_log_weight),
                                   float(jinfo.best_log_weight), atol=1e-3)
        assert int(nxt.step) == int(jnext.step) == i + 1
        if case in ("resample", "inject") and i > 0:
            assert bool(info.resampled)
        if case == "inject" and i > 0:       # 30 % of slots, uniform
            x = nxt.poses.numpy()
            assert (np.abs(x[:int(0.3 * P)] - x[int(0.3 * P):].mean(0))
                    .max(1) > 0.5).mean() > 0.5
        jstate = jnext


def test_surface_helpers_match():
    rng = np.random.default_rng(0)
    n = 40
    hit = rng.uniform(size=n) > 0.3
    jscan = JScan.from_arrays(np.zeros(n), np.ones(n), hit, max_beams=48)
    tscan = Scan.from_arrays(np.zeros(n), np.ones(n), hit, max_beams=48)
    scores = rng.normal(-50, 10, 200).astype(np.float32)
    for temp in (0.0, 0.5, 1.0):
        jcfg = JSlamConfig().with_overrides(
            {"matcher.surface_weight_temp": temp})
        np.testing.assert_allclose(
            ts.surface_temper(config_from_jax(jcfg).matcher, tscan,
                              torch.from_numpy(scores)).numpy(),
            np.asarray(js.surface_temper(jcfg.matcher, jscan,
                                         jnp.asarray(scores))), rtol=1e-6)

    jcfg = JSlamConfig(num_particles=200).with_overrides(_INJECT)
    tcfg = config_from_jax(jcfg)
    off = ts.SharedMapState(*(torch.zeros(1),) * 4, recov=torch.zeros(2))
    assert ts.recovery_update(config_from_jax(JSlamConfig()), off,
                              torch.tensor(1.0))[1] is None
    for step, recov, l_ref in ((0, [0.0, 0.0], -3.0), (4, [-1.0, -1.5], -2.0),
                               (4, [-1.0, -9.0], -8.0), (7, [-2.0, -1.0],
                                                         -0.5)):
        jst = js.SharedMapSLAM(jcfg).init(jax.random.key(0)).replace(
            step=jnp.asarray(step, jnp.int32),
            recov=jnp.asarray(recov, jnp.float32))
        tst = ts.SharedMapState(
            poses=None, log_weights=None, logodds=None,
            step=torch.tensor(step, dtype=torch.int32),
            recov=torch.tensor(recov, dtype=torch.float32))
        jr, jp = js.recovery_update(jcfg, jst, jnp.float32(l_ref))
        tr, tp = ts.recovery_update(tcfg, tst, torch.tensor(l_ref))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
        np.testing.assert_allclose(float(tp), float(jp), rtol=1e-6,
                                   atol=1e-7)

        poses = rng.normal(size=(200, 3)).astype(np.float32)
        key = jax.random.key(step)
        u = np.array(jax.random.uniform(key, (200, 3)))
        jpz, jtake = js.inject_uniform(jcfg, key, jnp.asarray(poses), jp)
        tpz, ttake = ts.inject_uniform(tcfg, torch.from_numpy(u),
                                       torch.from_numpy(poses), tp)
        np.testing.assert_allclose(tpz.numpy(), np.asarray(jpz),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))

    w, b = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(
        np.float32)
    for ne in (10.0, 189.0, 190.0, 200.0):
        np.testing.assert_array_equal(
            ts.integration_pose(torch.tensor(ne), 200, torch.from_numpy(w),
                                torch.from_numpy(b)).numpy(),
            np.asarray(js.integration_pose(jnp.float32(ne), 200,
                                           jnp.asarray(w), jnp.asarray(b))))


def test_init_matches():
    jcfg = JSlamConfig(num_particles=50, map=JMapConfig(
        width_m=2.0, height_m=1.5, origin=(-1.0, -0.75)))
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    lo = np.random.default_rng(0).normal(size=(30, 40)).astype(np.float32)
    key = jax.random.key(3)
    pairs = [(jeng.init(key, pose=(0.1, 0.2, 0.3)),
              eng.init(pose=(0.1, 0.2, 0.3))),
             (jeng.init_from_map(key, lo), eng.init_from_map(lo))]
    # init_uniform draws u from the second half of split(key) (shared.py:302)
    u = np.array(jax.random.uniform(jax.random.split(key)[1], (50, 3)))
    pairs.append((jeng.init_uniform(key, lo),
                  eng.init_uniform(lo, draws=torch.from_numpy(u))))
    for j, t in pairs:
        for f in ("poses", "log_weights", "logodds", "step", "recov"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), atol=1e-6)
    st = eng.init_uniform(lo, torch.Generator().manual_seed(0))
    assert st.poses.shape == (50, 3) and torch.isfinite(st.poses).all()
    assert eng.best_map(st) is st.logodds
    with pytest.raises(ValueError, match="map shape"):
        eng.init_from_map(lo[:, :20])


@pytest.mark.parametrize("bad", ["surface_bf16", "inject_accumulate"])
def test_unported_configurations_raise(bad):
    if bad == "surface_bf16":
        cfg = SlamConfig().with_overrides({"matcher.surface_bf16": True})
        match = "surface_bf16 is not ported"
    else:
        cfg = SlamConfig(accumulate_weights=True).with_overrides(_INJECT)
        match = "models/shared.py:434"
    with pytest.raises(ValueError, match=match):
        SharedMapSLAM(cfg, device="cpu")


def test_bench_log_ate_within_policy():
    """tests/test_surface.py::test_surface_mode_tracks_bench_log on both
    engines: 512 particles, the 12-scan square path with its turn, the
    FFT volume (25 bins, a 405 x 405 endpoint kernel).  Both ATEs under
    0.15 m and within 0.06 m of each other."""
    frames, gt = simulate_log(default_world(), square_path_controls(12),
                              params=SimParams(beams_per_rev=180), seed=0)
    jcfg = JSlamConfig(num_particles=512, max_beams=192)
    jeng = js.SharedMapSLAM(jcfg)
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step_surface)
    jstate = jeng.init(jax.random.key(0))
    jtraj = []
    for i in range(12):
        jstate, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        jtraj.append(np.asarray(jinfo.weighted_pose))

    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    state, infos = eng.run_log(eng.init(), [frame_at(batch, i)
                                            for i in range(12)],
                               torch.Generator().manual_seed(0))
    ttraj = torch.stack([i.weighted_pose for i in infos]).numpy()
    assert np.isfinite(ttraj).all() and torch.isfinite(state.logodds).all()
    ate_j, ate_t = ate_rmse(np.stack(jtraj), gt[:12]), ate_rmse(ttraj, gt[:12])
    assert abs(ate_j - ate_t) <= 0.06, (ate_j, ate_t)
    assert max(ate_j, ate_t) < 0.15, (ate_j, ate_t)
    assert float(infos[-1].neff) < 0.95 * jcfg.num_particles
    m = eng.best_map(state).numpy()
    assert (m > 0).sum() > 50 and (m < 0).sum() > 1000


def test_amcl_recovery_injection_detects_kidnap():
    """tests/test_shared.py::test_amcl_recovery_injection_detects_kidnap on
    the port: a mid-run kidnap into the other room of a two-room world.
    The fast/slow EMAs must detect the collapse, and only with injection
    does a substantial share of the cloud reach the true room."""
    params = SimParams(beams_per_rev=90)
    world = multi_room_world(2, 1, room=6.0)
    base = SlamConfig(
        num_particles=3000, max_beams=96, freeze_map=True,
        sensor=SensorConfig(max_range=5.0),
        map=MapConfig(width_m=14.0, height_m=8.0, resolution=0.1,
                      origin=(-7.0, -4.0)),
    ).with_overrides({"matcher.surface_nt": 16,
                      "matcher.surface_theta_span_deg": 180.0,
                      "matcher.surface_corr": "fft",
                      "map.likelihood_sigma_cells": 2.0,
                      "matcher.surface_refine_steps": 2})

    # the known map, from a coverage pass at ground-truth poses
    fa, ga = simulate_log(world, [(0.1, 0.0)] * 6, params=params, seed=0,
                          start_pose=(-3.0, 0.0, 0.0))
    fm, gm = simulate_log(world, [(0.5, 0.0)] * 20, params=params, seed=1,
                          start_pose=(-6.0, 0.0, 0.0))
    lo = torch.zeros((base.map.cells_y, base.map.cells_x))
    batch_m = frames_to_device(fm, base.max_beams, base.sensor.max_range)
    for i in range(len(fm)):
        f = frame_at(batch_m, i)
        scan = deskew_scan(f.scan, f.odom)
        lo = lo + integrate_scan(
            lo, torch.tensor(gm[i], dtype=torch.float32), scan,
            build_beam_lut(scan, base.beam_lut_bins), resolution=0.1,
            origin=(-7.0, -4.0), l_free=base.sensor.l_free,
            l_occ=base.sensor.l_occ, tol_cells=base.sensor.hit_tolerance_cells)
    # the kidnap: segment B, near-stationary, in the other room
    fb, _ = simulate_log(world, [(0.05, 0.0)] * 10, params=params, seed=2,
                         start_pose=(3.2, 0.5, 0.4))
    frames = fa + fb

    def run(reinject):
        cfg = base.with_overrides(_INJECT) if reinject else base
        eng = SharedMapSLAM(cfg, device="cpu")
        state = eng.init_from_map(lo, pose=tuple(ga[0]))
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
        gen = torch.Generator().manual_seed(5)
        gaps = []
        for i in range(len(frames)):
            state, _ = eng.step_surface(state, frame_at(batch, i), gen)
            gaps.append(float(state.recov[1] - state.recov[0]))
        return gaps, state.poses[:, 0].numpy()

    gaps0, x0 = run(False)
    gaps1, x1 = run(True)
    assert min(gaps1[len(fa):]) < -1.0, gaps1
    assert (x0 > 0.5).mean() < 0.05, (x0 > 0.5).mean()
    assert (x1 > 0.5).mean() > 0.2, (x1 > 0.5).mean()


# ------------------------------------------------ the per-particle matcher
P_MATCH, BLOCK = 32, 16


def _matcher_config(case):
    """6 x 6 m at 10 cm, 4 m range, the default matcher, 32 particles in
    blocks of 16.  "inject": every step resamples and the recovery
    injection is on; "frozen": freeze_map."""
    cfg = JSlamConfig(num_particles=P_MATCH, max_beams=96,
                      particle_chunk=BLOCK,
                      sensor=JSensorConfig(max_range=4.0),
                      map=JMapConfig(width_m=6.0, height_m=6.0,
                                     resolution=0.1, origin=(-3.0, -3.0)))
    if case == "inject":
        cfg = cfg.with_overrides(dict(_INJECT, resample_fraction=1.0))
    if case == "frozen":
        cfg = cfg.replace(freeze_map=True)
    return cfg


def _port_state(jstate):
    return shared_state_from_jax_arrays(
        *(np.asarray(x) for x in (jstate.poses, jstate.log_weights,
                                  jstate.logodds, jstate.step,
                                  jstate.recov)))


def _assert_step_matches(nxt, info, jnext, jinfo, jstate, moved=True):
    """Poses within 1e-4, log-weights within 1e-3, the map within K2's
    tolerance, the recovery EMAs, Neff and the weighted pose."""
    np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                               atol=1e-4)
    np.testing.assert_allclose(nxt.log_weights.numpy(),
                               np.asarray(jnext.log_weights), atol=1e-3)
    lo_j = np.asarray(jnext.logodds)
    assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
        <= K2_MAX_FRAC
    assert ((lo_j != np.asarray(jstate.logodds)).mean() > 0.005) == moved
    np.testing.assert_allclose(nxt.recov.numpy(), np.asarray(jnext.recov),
                               atol=1e-4)
    np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                               rtol=1e-4)
    np.testing.assert_allclose(info.weighted_pose.numpy(),
                               np.asarray(jinfo.weighted_pose), atol=1e-4)
    assert int(nxt.step) == int(jnext.step)


@pytest.mark.parametrize("case", ["chunked", "inject", "frozen"])
def test_step_parity_with_injected_draws(small_log, case):
    """SharedMapSLAM.step against the JAX step from the same state with
    JAX's draws, for 3 successive JAX states (tolerances of the module
    docstring).  "inject" sets the recovery EMAs apart before each step
    after the first, so 30 % of the slots are re-drawn uniformly."""
    frames, _ = small_log
    jcfg = _matcher_config(case)
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step)
    jstate = jeng.init(jax.random.key(1))
    for i in range(3):
        if case == "inject" and i > 0:   # a collapsed fast EMA
            jstate = jstate.replace(recov=jnp.asarray([0.0, -5.0]))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        nxt, info = eng.step(_port_state(jstate), frame_at(batch, i),
                             draws=_jax_draws(jstate.key, P_MATCH,
                                              case == "inject"))
        _assert_step_matches(nxt, info, jnext, jinfo, jstate,
                             moved=case != "frozen")
        assert bool(info.resampled) == bool(jinfo.resampled)
        if float(jinfo.neff) < 0.95 * P_MATCH:
            assert int(info.best_index) == int(jinfo.best_index)
        if case == "inject" and i > 0:       # 30 % of slots, uniform
            x = nxt.poses.numpy()
            assert (np.abs(x[:int(0.3 * P_MATCH)]
                           - x[int(0.3 * P_MATCH):].mean(0)).max(1)
                    > 0.5).mean() > 0.5
        jstate = jnext


@pytest.mark.parametrize("case", ["chunked", "inject", "frozen"])
def test_step_blocked_is_step_with_that_chunk(small_log, case):
    """step_blocked(block) gives step's bits with particle_chunk = block,
    the recovery EMAs, the injection and freeze_map included: the three
    things the JAX step_blocked drops (gridmap_slam_tpu/models/shared.py:
    577-654).  With freeze_map the JAX step_blocked changes the map where
    the JAX step does not; the port's keeps it."""
    frames, _ = small_log
    jcfg = _matcher_config(case)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    chunked = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    blocked = SharedMapSLAM(config_from_jax(jcfg.replace(particle_chunk=0)),
                            device="cpu")
    a = chunked.init(pose=(0.1, -0.2, 0.3))
    b = blocked.init(pose=(0.1, -0.2, 0.3))
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for i in range(3):
        if case == "inject" and i > 0:
            a.recov = b.recov = torch.tensor([0.0, -5.0])
        a, ia = chunked.step(a, frame_at(batch, i), ga)
        b, ib = blocked.step_blocked(b, frame_at(batch, i), BLOCK, gb)
        for f in ("poses", "log_weights", "logodds", "step", "recov"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in ("neff", "weighted_pose", "best_pose", "resampled"):
            assert torch.equal(getattr(ia, f), getattr(ib, f)), f
    if case == "inject":
        assert not torch.equal(a.recov, torch.tensor([0.0, -5.0]))
    if case == "frozen":
        assert torch.equal(b.logodds, torch.zeros_like(b.logodds))
        jeng = js.SharedMapSLAM(jcfg)
        jbatch = j_frames_to_device(frames, jcfg.max_beams,
                                    jcfg.sensor.max_range)
        j0 = jeng.init(jax.random.key(0))
        j_step, _ = jax.jit(jeng.step)(j0, j_frame_at(jbatch, 0))
        j_blocked, _ = jeng.step_blocked(j0, j_frame_at(jbatch, 0), BLOCK)
        assert (np.asarray(j_step.logodds) == 0).all()
        assert (np.asarray(j_blocked.logodds) != 0).mean() > 0.005


def test_step_blocked_matches_jax_step_blocked(small_log):
    """Where the JAX step_blocked agrees with its step (no injection, no
    freeze_map), the port's step_blocked against it with JAX's draws."""
    frames, _ = small_log
    jcfg = _matcher_config("chunked").replace(particle_chunk=0)
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstate = jeng.init(jax.random.key(2))
    for i in range(2):
        jnext, jinfo = jeng.step_blocked(jstate, j_frame_at(jbatch, i), BLOCK)
        nxt, info = eng.step_blocked(_port_state(jstate), frame_at(batch, i),
                                     BLOCK, draws=_jax_draws(jstate.key,
                                                             P_MATCH, False))
        _assert_step_matches(nxt, info, jnext, jinfo, jstate)
        jstate = jnext


def test_matcher_block_size():
    """The workspace model of the torch matcher: K1 output, prior grid and
    total of the larger stage, 3 * 11 * 81 * 4 bytes a particle with the
    default matcher; the block is the largest divisor of P within the
    budget."""
    cfg = SlamConfig(num_particles=1_000_000)
    assert ts.matcher_workspace_bytes(cfg) == 10_692
    assert ts.matcher_block_size(cfg) == 500_000
    assert ts.matcher_block_size(cfg, budget_bytes=1e8) == 8_000
    assert ts.matcher_block_size(cfg.replace(num_particles=10_000)) == 10_000
    assert ts.matcher_block_size(cfg.replace(num_particles=7),
                                 budget_bytes=5e4) == 1
    wide = cfg.with_overrides({"matcher.fine_nxy": 15, "matcher.fine_nt": 9})
    assert ts.matcher_workspace_bytes(wide) == 3 * 9 * 225 * 4
    twelve = SharedMapSLAM(cfg.replace(num_particles=12), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        twelve.step_blocked(twelve.init(), None, 5)


def test_replay_ate_within_policy():
    """Whole runs of the matcher step: SharedMapSLAM.replay (blocks of 16)
    and the JAX replay on the 12-scan square path at 32 particles, both
    ATEs under 0.15 m and within 0.06 m of each other; the offsets are
    built once for the whole run."""
    frames, gt = simulate_log(default_world(), square_path_controls(12),
                              params=SimParams(beams_per_rev=90), seed=0)
    jcfg = _matcher_config("chunked").with_overrides(
        {"map.resolution": 0.05})
    jeng = js.SharedMapSLAM(jcfg)
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    _, jinfo = jax.jit(jeng.replay)(jeng.init(jax.random.key(0)), jbatch)
    jtraj = np.asarray(jinfo.weighted_pose)

    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    tm._OFFSETS.clear()
    state, infos = eng.replay(eng.init(), [frame_at(batch, i)
                                           for i in range(12)],
                              torch.Generator().manual_seed(0), block=BLOCK)
    assert len(tm._OFFSETS) == 1
    ttraj = torch.stack([i.weighted_pose for i in infos]).numpy()
    assert np.isfinite(ttraj).all() and torch.isfinite(state.logodds).all()
    ate_j, ate_t = ate_rmse(jtraj, gt[:12]), ate_rmse(ttraj, gt[:12])
    assert abs(ate_j - ate_t) <= 0.06, (ate_j, ate_t)
    assert max(ate_j, ate_t) < 0.15, (ate_j, ate_t)
    m = eng.best_map(state).numpy()
    assert (m > 0).sum() > 50 and (m < 0).sum() > 1000
