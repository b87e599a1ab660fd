"""The port's single-program replays (models/captured.py) on the CPU.

- `RBPF.replay`, `SharedMapSLAM.replay_surface` / `replay` (a stacked
  batch, `block=` too) and `MultiRobotSLAM.replay` (stacked ticks) give the
  bits of `run_log` / the iterable loop with one generator seed, and
  their stacked infos have the JAX replays' field names, shapes (a leading
  frame axis) and dtypes.
- `replay_jit` / `replay_surface_jit` / `step_jit` run the captured loop's
  static buffers (on a CPU engine the step is called where a CUDA engine
  replays its graph) and give the same bits.
- Against JAX's `lax.scan` replays with JAX's draws, over 3 scans, at the
  step-parity tolerances of tests/test_torch_rbpf.py and
  tests/test_torch_shared.py: poses within 1e-4, log-weights within 1e-3,
  map cells beyond 1e-5 on at most 0.5 % of the map, Neff rtol 1e-4, the
  same resample decisions and best particle.
- Injected draws with a leading axis of another length raise ValueError.

The CUDA graph itself is captured and held against the eager loop on the
card by chip_smoke.py's `captured` phase.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu import RBPF as JRBPF
from gridmap_slam_tpu import SlamConfig as JSlamConfig
from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models import shared as js
from gridmap_slam_tpu.models.multi import MultiRobotSLAM as JMulti
from gridmap_slam_tpu_torch import (RBPF, MultiRobotSLAM, SharedMapSLAM,
                                    SlamConfig)
from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            shared_state_from_jax_arrays,
                                            state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 multi_room_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models.captured import (leaves, stack_steps,
                                                    tree_map)
from gridmap_slam_tpu_torch.models.multi import stack_frames
from gridmap_slam_tpu_torch.ops import surface as tsf
from gridmap_slam_tpu_torch.ops.cuda import grid_update as k2

torch.set_num_threads(1)

K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
N = 6            # scans a replay
STARTS = [(-5.2, -0.3, 0.0), (5.2, 0.3, np.pi)]
_INJECT = {"matcher.surface_reinject_slow": 0.05,
           "matcher.surface_reinject_fast": 0.6}


@pytest.fixture(scope="module")
def small_log():
    return simulate_log(default_world(), square_path_controls(8),
                        params=SimParams(beams_per_rev=90), seed=7)


@pytest.fixture(scope="module")
def multi_logs():
    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    return [simulate_log(world, [(0.25, 0.0)] * N, params=params,
                         seed=11 + i, start_pose=STARTS[i]) for i in range(2)]


def _rbpf_config(resample_fraction=0.5):
    return JSlamConfig(num_particles=8, max_beams=96, particle_chunk=4,
                       resample_fraction=resample_fraction,
                       map=JMapConfig(width_m=3.0, height_m=3.0,
                                      origin=(-1.5, -1.5)))


def _surface_config(over=None):
    """tests/test_torch_shared.py's small surface config: 6 x 6 m at 10 cm,
    4 m range, 9 theta bins, 64 particles."""
    o = {"matcher.surface_nt": 9, **(over or {})}
    return JSlamConfig(num_particles=64, max_beams=96,
                       sensor=JSensorConfig(max_range=4.0),
                       map=JMapConfig(width_m=6.0, height_m=6.0,
                                      resolution=0.1, origin=(-3.0, -3.0))
                       ).with_overrides(o)


def _multi_config():
    """scripts/config5_demo.py's setup at 12 particles a robot."""
    return JSlamConfig(num_particles=12, max_beams=96,
                       sensor=JSensorConfig(max_range=8.0),
                       map=JMapConfig(width_m=14.0, height_m=8.0,
                                      resolution=0.1, origin=(-7.0, -4.0)))


def _gen():
    return torch.Generator().manual_seed(0)


def _first(batch, n):
    return tree_map(lambda x: x[:n], batch)


class Case:
    """One engine on one log: the engine, its JAX twin's config, the start
    state, the stacked frames, the iterable loop, the eager stacked replay
    and the captured one."""

    def __init__(self, name, small_log, multi_logs):
        self.name = name
        self.recorded, self.multi_logs = small_log[0], multi_logs
        if name == "multi":
            self.jcfg = _multi_config()
            eng = MultiRobotSLAM(config_from_jax(self.jcfg), num_robots=2,
                                 device="cpu")
            tb = [frames_to_device(f, 96, 8.0) for f, _ in multi_logs]
            ticks = [stack_frames([frame_at(b, i) for b in tb])
                     for i in range(N)]
            self.frames, self.seq = stack_frames(ticks), ticks
            self.init = lambda: eng.init(STARTS)
            self.loop = lambda s, g: eng.replay(s, self.seq, g)
            self.replay, self.jit = eng.replay, eng.replay_jit
        else:
            self.jcfg = {"rbpf": _rbpf_config(),
                         "blocked": _rbpf_config().replace(
                             num_particles=32, particle_chunk=0)
                         }.get(name) or _surface_config(
                {**_INJECT, "matcher.surface_refine_steps": 2}
                if name == "surface_inject_refine" else None)
            cfg = config_from_jax(self.jcfg)
            frames, _ = small_log
            batch = frames_to_device(frames, cfg.max_beams,
                                     cfg.sensor.max_range)
            self.frames = _first(batch, N)
            self.seq = [frame_at(batch, i) for i in range(N)]
            if name == "rbpf":
                eng = RBPF(cfg, device="cpu")
                self.loop = lambda s, g: eng.run_log(s, self.seq, g)
                self.replay, self.jit = eng.replay, eng.replay_jit
            elif name == "blocked":
                eng = SharedMapSLAM(cfg, device="cpu")
                self.loop = lambda s, g: eng.replay(s, self.seq, g, block=16)
                self.replay = lambda s, f, g=None, draws=None: eng.replay(
                    s, f, g, block=16, draws=draws)
                self.jit = lambda: eng.replay_jit(block=16)
            else:
                eng = SharedMapSLAM(cfg, device="cpu")
                self.loop = lambda s, g: eng.run_log(s, self.seq, g)
                self.replay = eng.replay_surface
                self.jit = eng.replay_surface_jit
            self.init = eng.init
        self.eng = eng


CASES = ["rbpf", "surface", "blocked", "multi"]


def _assert_same(a, b):
    """Every tensor of two states or infos equal in bits, shape and
    dtype."""
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _jax_replay_shapes(case):
    """The JAX engine's replay over the same N frames, traced for its
    output shapes and dtypes only (nothing is compiled)."""
    if case.name == "multi":
        jeng = JMulti(case.jcfg, num_robots=2)
        jb = [j_frames_to_device(f, 96, 8.0) for f, _ in
              case.multi_logs]
        frames = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=1), *jb)
        state = jeng.init(jax.random.key(0), poses=STARTS)
        fn = jeng.replay
    else:
        frames = j_frames_to_device(case.recorded, case.jcfg.max_beams,
                                    case.jcfg.sensor.max_range)
        if case.name == "rbpf":
            jeng = JRBPF(case.jcfg)
            fn = jeng.replay
        else:
            jeng = js.SharedMapSLAM(case.jcfg)
            fn = jeng.replay if case.name == "blocked" else \
                jeng.replay_surface
        state = jeng.init(jax.random.key(0))
    frames = jax.tree.map(lambda x: x[:N], frames)
    return jax.eval_shape(fn, state, frames)[1]


@pytest.mark.parametrize("name", CASES)
def test_replay_is_the_loop(small_log, multi_logs, name):
    """The eager stacked replay gives the loop's bits with one generator
    seed, and its infos the JAX replay's field names, shapes and dtypes."""
    case = Case(name, small_log, multi_logs)
    st_l, infos_l = case.loop(case.init(), _gen())
    st_r, infos_r = case.replay(case.init(), case.frames, _gen())
    _assert_same(st_l, st_r)
    _assert_same(stack_steps(infos_l), infos_r)
    want = _jax_replay_shapes(case)
    assert [f.name for f in dataclasses.fields(infos_r)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(infos_r):
        got, ref = getattr(infos_r, f.name), getattr(want, f.name)
        assert tuple(got.shape) == tuple(ref.shape), f.name
        assert got.numpy().dtype == np.dtype(ref.dtype), f.name
        assert got.shape[0] == N


@pytest.mark.parametrize("name", CASES + ["surface_inject_refine"])
def test_captured_replay_is_the_loop(small_log, multi_logs, name):
    """replay_jit / replay_surface_jit (the static-buffer loop on the CPU)
    give the eager replay's bits, twice, with one generator seed and with
    injected draws; a shorter log reuses the buffers, a longer one makes
    new ones, each with the loop's bits."""
    case = Case(name, small_log, multi_logs)
    st_e, inf_e = case.replay(case.init(), case.frames, _gen())
    fn = case.jit()
    for _ in range(2):
        st_c, inf_c = fn(case.init(), case.frames, _gen())
        _assert_same(st_e, st_c)
        _assert_same(inf_e, inf_c)
    cap = fn.captured
    assert cap.graph is None and cap.captures == 0 and cap.capacity == N
    # the returned state is a copy: a later call leaves it as it is
    again, _ = fn(case.init(), _first(case.frames, 2), _gen())
    _assert_same(st_e, st_c)
    st_2, inf_2 = case.replay(case.init(), _first(case.frames, 2), _gen())
    _assert_same(st_2, again)
    assert cap.capacity == N
    # injected draws, stacked: the generator's own draws give the same bits
    g = _gen()
    draw = case.eng._draws
    per_scan = [draw(g) if name not in ("surface", "blocked",
                                        "surface_inject_refine")
                else draw(g, None) for _ in range(N)]
    draws = tree_map(lambda *xs: torch.stack(xs), *per_scan)
    st_d, inf_d = fn(case.init(), case.frames, draws=draws)
    _assert_same(st_e, st_d)
    _assert_same(inf_e, inf_d)


def test_captured_replay_takes_a_longer_log(small_log):
    """A log longer than the capture's buffers makes new ones."""
    case = Case("rbpf", small_log, None)
    fn = case.jit()
    fn(case.init(), _first(case.frames, 2), _gen())
    assert fn.captured.capacity == 2
    st_c, inf_c = fn(case.init(), case.frames, _gen())
    assert fn.captured.capacity == N
    st_e, inf_e = case.replay(case.init(), case.frames, _gen())
    _assert_same(st_e, st_c)
    _assert_same(inf_e, inf_c)


def test_step_jit_consumes_its_state(small_log):
    """step_jit scan by scan gives run_log's bits; the state it returns is
    the capture's buffer, which the next call takes and overwrites."""
    case = Case("rbpf", small_log, None)
    st_e, infos_e = case.loop(case.init(), _gen())
    step = case.eng.step_jit()
    g = _gen()
    st, infos = case.init(), []
    first = None
    for i in range(N):
        st, info = step(st, case.seq[i], g)
        infos.append(info)
        if first is None:
            first, poses_1 = st, st.poses.clone()
        assert st is first
    assert not torch.equal(first.poses, poses_1)     # overwritten
    _assert_same(st_e, st)
    _assert_same(stack_steps(infos_e), stack_steps(infos))
    # injected draws, one scan's
    step = case.eng.step_jit()
    g = _gen()
    st_d, info_d = step(case.init(), case.seq[0],
                        draws=case.eng._draws(g))
    st_1, info_1 = case.eng.step(case.init(), case.seq[0], _gen())
    _assert_same(st_1, st_d)
    _assert_same(info_1, info_d)


@pytest.mark.parametrize("name", ["rbpf", "multi", "surface"])
@pytest.mark.parametrize("jit", [False, True])
def test_draws_of_another_length_raise(small_log, multi_logs, name, jit):
    case = Case(name, small_log, multi_logs)
    g = _gen()
    draw = case.eng._draws
    one = draw(g) if name != "surface" else draw(g, None)
    draws = tree_map(lambda x: torch.stack([x] * (N - 1)), one)
    fn = case.jit() if jit else case.replay
    with pytest.raises(ValueError, match="leading frame axis"):
        fn(case.init(), case.frames, draws=draws)


def test_iterable_replay_refuses_draws(small_log):
    case = Case("blocked", small_log, None)
    one = case.eng._draws(_gen(), None)
    with pytest.raises(ValueError, match="stacked Frame batch"):
        case.eng.replay(case.init(), case.seq, draws=one)


# ------------------------------------------------------- against JAX replays
def _rbpf_jax_draws(key, p):
    """JAX RBPF.step's draws for state key `key` (tests/test_torch_rbpf.py):
    (next, motion, resample) = split(key, 3), a key a particle split for
    the two normals, u0 ~ U[0, 1/P)."""
    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jax.vmap(normals)(jax.random.split(k_motion, p))
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    return torch.from_numpy(np.array(n)), torch.tensor(float(u0))


def _surface_jax_draws(key, p, inject):
    """JAX SharedMapSLAM.step_surface's draws (tests/test_torch_shared.py):
    the RBPF's, plus the injection uniforms from fold_in(resample key,
    1)."""
    n, u0 = _rbpf_jax_draws(key, p)
    _, _, k_resample = jax.random.split(key, 3)
    u = (torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k_resample, 1), (p, 3)))) if inject else None)
    return n, u0, u


def _stacked_jax_draws(key, scans, draw):
    """Each scan's draws along JAX's key chain (the next key is the first
    of split(key, 3)), stacked along a leading frame axis."""
    per_scan = []
    for _ in range(scans):
        per_scan.append(draw(key))
        key = jax.random.split(key, 3)[0]
    return tree_map(lambda *xs: torch.stack(xs), *per_scan)


def _assert_scan_matches(st, infos, jst, jinfos, jstart, p):
    np.testing.assert_allclose(st.poses.numpy(), np.asarray(jst.poses),
                               atol=1e-4)
    np.testing.assert_allclose(st.log_weights.numpy(),
                               np.asarray(jst.log_weights), atol=1e-3)
    lo_j = np.asarray(jst.logodds)
    assert (np.abs(st.logodds.numpy() - lo_j) > K2_ATOL).mean() \
        <= K2_MAX_FRAC
    assert (lo_j != np.asarray(jstart.logodds)).mean() > 0.005
    assert int(st.step) == int(jst.step)
    np.testing.assert_allclose(infos.neff.numpy(), np.asarray(jinfos.neff),
                               rtol=1e-4)
    np.testing.assert_allclose(infos.weighted_pose.numpy(),
                               np.asarray(jinfos.weighted_pose), atol=1e-4)
    np.testing.assert_allclose(infos.best_log_weight.numpy(),
                               np.asarray(jinfos.best_log_weight), atol=1e-3)
    # on a first scan into a blank map every particle scores the same: the
    # argmax is float noise there (and unused)
    informative = np.asarray(jinfos.neff) < 0.95 * p
    np.testing.assert_array_equal(infos.best_index.numpy()[informative],
                                  np.asarray(jinfos.best_index)[informative])


@pytest.mark.parametrize("resample_fraction", [0.5, 1.0])
def test_rbpf_replay_matches_jax_replay(small_log, resample_fraction):
    """RBPF.replay with JAX's draws against JAX's RBPF.replay (lax.scan, the
    XLA path) over the first 3 scans."""
    frames, _ = small_log
    jcfg = _rbpf_config(resample_fraction)
    jeng = JRBPF(jcfg)
    jbatch = jax.tree.map(lambda x: x[:3], j_frames_to_device(
        frames, jcfg.max_beams, jcfg.sensor.max_range))
    jstart = jeng.init(jax.random.key(0))
    jst, jinfos = jax.jit(jeng.replay)(jstart, jbatch)
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    batch = _first(frames_to_device(frames, jcfg.max_beams,
                                    jcfg.sensor.max_range), 3)
    draws = _stacked_jax_draws(jstart.key, 3,
                               lambda k: _rbpf_jax_draws(k, 8))
    start = state_from_jax_arrays(
        *(np.asarray(x) for x in (jstart.poses, jstart.log_weights,
                                  jstart.logodds, jstart.step)))
    st, infos = eng.replay(start, batch, draws=draws)
    _assert_scan_matches(st, infos, jst, jinfos, jstart, 8)
    np.testing.assert_array_equal(infos.resampled.numpy(),
                                  np.asarray(jinfos.resampled))
    st_c, infos_c = eng.replay_jit()(start, batch, draws=draws)
    _assert_same(st, st_c)
    _assert_same(infos, infos_c)


@pytest.mark.parametrize("inject", [False, True])
def test_replay_surface_matches_jax_replay_surface(small_log, inject):
    """SharedMapSLAM.replay_surface with JAX's draws against JAX's
    replay_surface over the first 3 scans."""
    frames, _ = small_log
    jcfg = _surface_config(_INJECT if inject else None)
    p = jcfg.num_particles
    jeng = js.SharedMapSLAM(jcfg)
    jbatch = jax.tree.map(lambda x: x[:3], j_frames_to_device(
        frames, jcfg.max_beams, jcfg.sensor.max_range))
    jstart = jeng.init(jax.random.key(0))
    jst, jinfos = jax.jit(jeng.replay_surface)(jstart, jbatch)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    batch = _first(frames_to_device(frames, jcfg.max_beams,
                                    jcfg.sensor.max_range), 3)
    draws = _stacked_jax_draws(jstart.key, 3,
                               lambda k: _surface_jax_draws(k, p, inject))
    start = shared_state_from_jax_arrays(
        *(np.asarray(x) for x in (jstart.poses, jstart.log_weights,
                                  jstart.logodds, jstart.step,
                                  jstart.recov)))
    st, infos = eng.replay_surface(start, batch, draws=draws)
    _assert_scan_matches(st, infos, jst, jinfos, jstart, p)
    np.testing.assert_allclose(st.recov.numpy(), np.asarray(jst.recov),
                               atol=1e-4)
    # the gate compares Neff with a threshold: where the two sit within
    # float noise of each other either answer is right
    rf = jcfg.matcher.surface_resample_fraction
    clear = np.abs(np.asarray(jinfos.neff) - p * rf) > 1e-3 * p
    np.testing.assert_array_equal(infos.resampled.numpy()[clear],
                                  np.asarray(jinfos.resampled)[clear])
    st_c, infos_c = eng.replay_surface_jit()(start, batch, draws=draws)
    _assert_same(st, st_c)
    _assert_same(infos, infos_c)


# ------------------------------------------------------------- the pieces
def test_stack_steps_and_tree_map():
    a = {"x": torch.arange(3.0)}
    with pytest.raises(ValueError):
        stack_steps([])
    infos = [tsf_info(i) for i in range(4)]
    st = stack_steps(infos)
    assert st.neff.shape == (4,) and st.weighted_pose.shape == (4, 3)
    assert torch.equal(st.best_index, torch.arange(4, dtype=torch.int32))
    assert leaves((None, torch.ones(2), [torch.zeros(1)]))[1].shape == (1,)
    with pytest.raises(TypeError):
        tree_map(lambda x: x, a)


def tsf_info(i):
    from gridmap_slam_tpu_torch.types import StepInfo
    return StepInfo(neff=torch.tensor(float(i)),
                    weighted_pose=torch.full((3,), float(i)),
                    best_pose=torch.zeros(3),
                    best_index=torch.tensor(i, dtype=torch.int32),
                    best_log_weight=torch.tensor(0.0),
                    resampled=torch.tensor(i % 2 == 0))


@pytest.mark.parametrize("window", [False, True])
def test_k2_out_in_place_is_the_fresh_map(window):
    """K2's plain versions with out= the input map itself give the bits of
    the fresh map they return by default (the captured replays' in-place
    state)."""
    rng = np.random.default_rng(3)
    cfg = SlamConfig(max_beams=64,
                     map=MapConfig(width_m=4.0, height_m=3.0,
                                   origin=(-2.0, -1.5)),
                     sensor=SensorConfig(max_range=3.0))
    ang = np.linspace(-np.pi, np.pi, 64, endpoint=False)
    from gridmap_slam_tpu_torch.types import Scan
    scan = Scan.from_arrays(ang, rng.uniform(0.5, 2.5, 64),
                            rng.uniform(size=64) < 0.8, 64, 3.0)
    tables = k2.scan_bin_tables(scan, 256)
    lo = torch.from_numpy(rng.normal(size=(cfg.map.cells_y,
                                           cfg.map.cells_x))
                          .astype(np.float32))
    pose = torch.tensor([0.1, -0.2, 0.3])
    kw = dict(resolution=cfg.map.resolution, origin=cfg.map.origin,
              l_free=-0.4, l_occ=0.85)
    keep = torch.tensor(1.0)
    if window:
        win = torch.tensor([5, 7])
        fresh = k2.integrate_scan_window(lo, win, pose, keep, *tables,
                                         size=(20, 30), **kw)
        inplace = lo.clone()
        got = k2.integrate_scan_window(inplace, win, pose, keep, *tables,
                                       size=(20, 30), out=inplace, **kw)
    else:
        fresh = k2.integrate_scan_batch(lo[None], pose[None], keep,
                                        *tables, **kw)[0]
        inplace = lo.clone()[None]
        got = k2.integrate_scan_batch(inplace, pose[None], keep, *tables,
                                      out=inplace, **kw)[0]
    assert got.data_ptr() == inplace.data_ptr()
    assert torch.equal(got, fresh) and not torch.equal(fresh, lo)


def test_refine_moves_are_the_listed_ones():
    """refine_on_surface builds its six moves on the device; the climb
    gives the bits of the moves built from the Python list as before."""
    rng = np.random.default_rng(4)
    nt, h, w = 9, 30, 40
    vol = torch.from_numpy(rng.normal(size=(nt, h, w)).astype(np.float32))
    poses = torch.from_numpy(np.stack(
        [rng.uniform(-0.5, 0.5, 200), rng.uniform(-0.5, 0.5, 200),
         rng.uniform(-0.2, 0.2, 200)], -1).astype(np.float32))
    kw = dict(theta0=torch.tensor(-0.3), dtheta=0.075,
              crop_iy0=torch.tensor(0), crop_ix0=torch.tensor(0),
              resolution=0.05, origin=(-1.0, -0.75))
    s0 = tsf.sample_surface(vol, poses, **kw)
    got_p, got_s = tsf.refine_on_surface(vol, poses, s0, steps=3, **kw)
    moves = torch.tensor([[0.05, 0, 0], [-0.05, 0, 0], [0, 0.05, 0],
                          [0, -0.05, 0], [0, 0, 0.075], [0, 0, -0.075]],
                         dtype=torch.float32)
    p, s = poses, s0
    for _ in range(3):
        cand = p[..., None, :] + moves
        sc = tsf.sample_surface(vol, cand, **kw)
        k = torch.argmax(sc, -1, keepdim=True)
        s_best = torch.take_along_dim(sc, k, -1)[..., 0]
        p_best = torch.take_along_dim(cand, k[..., None], -2)[..., 0, :]
        better = s_best > s
        p = torch.where(better[..., None], p_best, p)
        s = torch.where(better, s_best, s)
    assert torch.equal(got_p, p) and torch.equal(got_s, s)
    assert (got_s > s0).any()


def test_captured_refuses_draws_of_another_shape(small_log):
    """Injected draws whose scan shape is not the step's raise
    ValueError."""
    case = Case("rbpf", small_log, None)
    normals, u0 = case.eng._draws(_gen())
    draws = (torch.stack([normals[:4]] * N), torch.stack([u0] * N))
    with pytest.raises(ValueError, match="the step draws"):
        case.jit()(case.init(), case.frames, draws=draws)


# a gate that fires on some scans of the replays and not on others
FRACTION = 0.95


@pytest.mark.parametrize("pred", [False, True])
def test_cond_forms_agree(pred):
    """captured.cond's branch (the CPU's form, and the body of the card's
    IF node) and its select form (the card's eager form) write the same
    bits into its outs: the body's where pred holds, else the identity."""
    from gridmap_slam_tpu_torch.models import captured
    from gridmap_slam_tpu_torch.ops.resample import systematic_indices
    lw = torch.randn(50, generator=_gen())
    rows = torch.randn(50, 3, generator=_gen())
    got = {}
    for select in (False, True):
        idx, out = torch.arange(50), rows.clone()

        def body():
            idx.copy_(systematic_indices(lw, torch.tensor(0.013)))
            torch.index_select(rows, 0, idx, out=out)

        captured.cond(torch.tensor(pred), body, [idx, out], select=select)
        got[select] = (idx, out)
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)
    assert torch.equal(got[False][1], rows) != pred


@pytest.mark.parametrize("name", CASES + ["surface_inject_refine"])
def test_cond_select_form_is_the_branch(small_log, multi_logs, monkeypatch,
                                        name):
    """Every engine's replay with its resample gates in captured.cond's
    select form (the card's eager form) against the branch (the CPU's,
    which runs the bodies of the card's IF nodes): the same bits, over
    scans whose gates fire and scans whose gates do not."""
    from gridmap_slam_tpu_torch.models import captured
    case = Case(name, small_log, multi_logs)
    key = ("matcher.surface_resample_fraction" if "surface" in name
           else "resample_fraction")
    case.eng.config = case.eng.config.with_overrides({key: FRACTION})
    s_b, i_b = case.replay(case.init(), case.frames, _gen())
    real = captured.cond
    monkeypatch.setattr(captured, "cond",
                        lambda *a, **k: real(*a, **k, select=True))
    s_s, i_s = case.replay(case.init(), case.frames, _gen())
    _assert_same(s_b, s_s)
    _assert_same(i_b, i_s)
    assert i_b.resampled.any() and not i_b.resampled.all()
