"""The port's multi-robot SLAM (models/multi.py), held to the JAX package's
MultiRobotSLAM on the CPU.

torch's generators cannot reproduce JAX's threefry draws, so step parity
rebuilds JAX's per-robot draws from the state key (multi.py:92-97, :123,
:131) and injects them.  Tolerances are those of tests/test_torch_rbpf.py:
poses within 1e-4, log-weights within 1e-3, map cells beyond 1e-5 on at
most 0.5 % of the map.  Whole runs are held by the cross-backend ATE policy
of docs/DIVERGENCES.md: within 0.06 m of the JAX run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models.multi import MultiRobotSLAM as JMulti
from gridmap_slam_tpu_torch import MultiRobotSLAM, SlamConfig
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            multi_state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, multi_room_world,
                                                 simulate_log)
from gridmap_slam_tpu_torch.models.multi import stack_frames
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(1)

K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
R, P = 2, 12
STARTS = [(-5.2, -0.3, 0.0), (5.2, 0.3, np.pi)]


def _config(particles=P):
    """scripts/config5_demo.py's setup: 14 x 8 m at 10 cm, 96 beams, 8 m
    range."""
    return JSlamConfig(num_particles=particles, max_beams=96,
                       sensor=JSensorConfig(max_range=8.0),
                       map=JMapConfig(width_m=14.0, height_m=8.0,
                                      resolution=0.1, origin=(-7.0, -4.0)))


def _logs(revs):
    """The demo's two logs: straight runs through the door from opposite
    rooms."""
    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    return [simulate_log(world, [(0.25, 0.0)] * revs, params=params,
                         seed=11 + i, start_pose=STARTS[i])
            for i in range(R)]


def _jax_draws(key, p):
    """gridmap_slam_tpu MultiRobotSLAM.step's draws for state key `key`:
    (next, motion, resample) = split(key, 3); one motion key a robot, one
    key a particle, split for the distance and heading normals; one
    resample key a robot, u0 ~ U[0, 1/P) from each."""
    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jnp.stack([jax.vmap(normals)(jax.random.split(k, p))
                   for k in jax.random.split(k_motion, R)])
    u0 = jnp.stack([jax.random.uniform(k, (), minval=0.0, maxval=1.0 / p)
                    for k in jax.random.split(k_resample, R)])
    return torch.from_numpy(np.array(n)), torch.from_numpy(np.array(u0))


@pytest.mark.parametrize("resample_fraction,in_place", [
    pytest.param(0.5, False, id="0.5"), pytest.param(1.0, False, id="1.0"),
    pytest.param(0.0, False, id="0.0"),
    pytest.param(1.0, True, id="1.0-out_state")])
def test_step_parity_with_injected_draws(resample_fraction, in_place):
    """One tick from the same state with JAX's draws, for 3 successive JAX
    states; resample_fraction 1.0 resamples every robot on every tick, 0.0
    none; in_place writes the new state into the state the tick reads
    (out=state, as the captured replay does)."""
    logs = _logs(4)
    jcfg = _config().replace(resample_fraction=resample_fraction)
    jeng = JMulti(jcfg, num_robots=R)
    eng = MultiRobotSLAM(config_from_jax(jcfg), num_robots=R, device="cpu")
    jb = [j_frames_to_device(f, 96, 8.0) for f, _ in logs]
    jbatch = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1), *jb)
    tb = [frames_to_device(f, 96, 8.0) for f, _ in logs]
    jstep = jax.jit(jeng.step)
    jstate = jeng.init(jax.random.key(0), poses=STARTS)
    for i in range(3):
        state = multi_state_from_jax_arrays(
            *(np.asarray(x) for x in (jstate.poses, jstate.log_weights,
                                      jstate.logodds, jstate.step)))
        jnext, jinfo = jstep(jstate, jax.tree.map(lambda a: a[i], jbatch))
        nxt, info = eng.step(state, stack_frames([frame_at(b, i)
                                                  for b in tb]),
                             draws=_jax_draws(jstate.key, P),
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
        for f in ("neff", "weighted_pose", "best_pose"):
            np.testing.assert_allclose(getattr(info, f).numpy(),
                                       np.asarray(getattr(jinfo, f)),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(info.resampled.numpy(),
                                      np.asarray(jinfo.resampled))
        if resample_fraction == 0.0:
            assert not info.resampled.any()
        assert int(nxt.step) == int(jnext.step) == i + 1
        jstate = jnext


def test_replay_ate_within_policy():
    """The config5 demo's filtering stage at 12 particles a robot over 10
    revolutions on both engines: each robot's ATE under 0.10 m and within
    0.06 m of the JAX run's; a second run with the same seed repeats the
    bits."""
    revs = 10
    logs = _logs(revs)
    jcfg = _config()
    jeng = JMulti(jcfg, num_robots=R)
    jb = [j_frames_to_device(f, 96, 8.0) for f, _ in logs]
    jbatch = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1), *jb)
    _, jinfo = jax.jit(jeng.replay)(jeng.init(jax.random.key(0),
                                              poses=STARTS), jbatch)
    jtraj = np.asarray(jinfo.weighted_pose)                 # (T, R, 3)

    eng = MultiRobotSLAM(config_from_jax(jcfg), num_robots=R, device="cpu")
    tb = [frames_to_device(f, 96, 8.0) for f, _ in logs]
    ticks = [stack_frames([frame_at(b, i) for b in tb]) for i in range(revs)]

    def run():
        return eng.replay(eng.init(STARTS), ticks,
                          torch.Generator().manual_seed(0))

    state, infos = run()
    again, _ = run()
    assert torch.equal(state.poses, again.poses)
    assert torch.equal(state.logodds, again.logodds)
    ttraj = torch.stack([i.weighted_pose for i in infos]).numpy()
    for r in range(R):
        gt = logs[r][1]
        ate_j, ate_t = ate_rmse(jtraj[:, r], gt), ate_rmse(ttraj[:, r], gt)
        assert abs(ate_j - ate_t) <= 0.06, (r, ate_j, ate_t)
        assert max(ate_j, ate_t) < 0.10, (r, ate_j, ate_t)
    m = state.logodds.numpy()
    assert (m > 0).sum() > 100 and (m < 0).sum() > 1000


@pytest.mark.parametrize("bad", ["freeze_map", "matcher_disabled"])
def test_configurations_jax_ignores_raise(bad):
    """The JAX multi-robot step ignores freeze_map and matcher.enabled; the
    port refuses both, naming why."""
    cfg = SlamConfig(num_particles=4, max_beams=8)
    if bad == "freeze_map":
        cfg, match = cfg.replace(freeze_map=True), "freeze_map=True"
    else:
        cfg = cfg.with_overrides({"matcher.enabled": False})
        match = "matcher.enabled=False"
    with pytest.raises(ValueError, match=match):
        MultiRobotSLAM(cfg, num_robots=2, device="cpu")


def test_init_matches():
    jcfg = _config(particles=5)
    js = JMulti(jcfg, num_robots=R).init(jax.random.key(0), poses=STARTS)
    ts = MultiRobotSLAM(config_from_jax(jcfg), num_robots=R,
                        device="cpu").init(STARTS)
    for f in ("poses", "log_weights", "logodds", "step"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6)
    zero = MultiRobotSLAM(config_from_jax(jcfg), num_robots=3,
                          device="cpu").init()
    assert zero.poses.shape == (3, 5, 3) and not zero.poses.any()
