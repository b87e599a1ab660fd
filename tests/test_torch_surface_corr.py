"""K4 (ops/cuda/surface_corr.py) and the `surface_bf16` path on the CPU,
held to the JAX package's bf16 branch of ops/surface.py::scan_surface.

On the CPU K4's wrapper runs its plain version: the shifted field and the
endpoint images rounded to bf16 and back, a float32 conv2d, minus the
shift mass.  Inputs are made with numpy from a seed and fed to both
packages.  Tolerances: rtol 1e-5 / atol 1e-3 for the correlation (the
direct correlation's bound of tests/test_torch_surface.py: float32 sums in
other orders), also for the engine's whole volume; the step's
tolerances of tests/test_torch_shared.py (poses 1e-4, log-weights 1e-3,
K2's cells beyond 1e-5 on at most 0.5 % of the map); the cross-backend ATE
policy of docs/DIVERGENCES.md (within 0.06 m of the JAX run) for a log.
With the FFT correlation bf16 changes no bit, as in the JAX package.
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
from gridmap_slam_tpu.ops import surface as jsf
from gridmap_slam_tpu_torch import SharedMapSLAM, mega_config
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            shared_state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models import shared as ts
from gridmap_slam_tpu_torch.ops import surface as tsf
from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse
from tests.test_torch_shared import _jax_draws
from tests.test_torch_parallel import (JAX_LW_ATOL, K2_ATOL, K2_MAX_FRAC,
                                       build_cases, launch, log_frames,
                                       surface_config)

torch.set_num_threads(1)

RES, MAXR = 0.1, 4.0
LL_OUT = math.log(1.0 / MAXR)
CORR_RTOL, CORR_ATOL = 1e-5, 1e-3
P = 64


@pytest.fixture(scope="module")
def scan_log():
    return simulate_log(default_world(), square_path_controls(8),
                        params=SimParams(beams_per_rev=90), seed=7)


def _real_splat(frames, nt, kc, i=3):
    """The endpoint images of scan i of the log, splatted by the port at nt
    bins over +-0.3 rad, at the cell size that puts the range inside the
    kernel (a real scan's weights: bilinear taps of its hit beams)."""
    b = frames_to_device(frames, 96, MAXR)
    f = frame_at(b, i)
    scan = deskew_scan(f.scan, f.odom)
    px, py = scan_points(scan)
    wgt = (scan.valid & scan.hit).to(torch.float32)
    thetas = torch.linspace(-0.3, 0.3, nt)
    return tsf.splat_endpoint_kernels(px, py, wgt, thetas, kc,
                                      MAXR / (kc - 2))


# ------------------------------------------------------ the correlation
@pytest.mark.parametrize("nt,kc,hc,wc", [
    (1, 3, 10, 13), (5, 7, 24, 17), (7, 12, 31, 40), (5, 20, 40, 40),
    (7, 25, 17, 29), (8, 24, 32, 32)])
def test_bf16_correlation_matches_jax(scan_log, nt, kc, hc, wc):
    """scan_surface(bf16=True): nt of 1, 5, 7 and 8, K of 7 to 51 (no
    multiple of 16), crops square and not, the field across
    [ll_outside, 0], a real scan's splat."""
    frames, _ = scan_log
    rng = np.random.default_rng(nt * 100 + kc)
    llf = rng.uniform(LL_OUT, 0.0, (hc, wc)).astype(np.float32)
    llf[rng.uniform(size=(hc, wc)) < 0.1] = LL_OUT
    e = _real_splat(frames, nt, kc)
    assert float(e.sum()) > 10.0
    want = np.asarray(jsf.scan_surface(jnp.asarray(llf),
                                       jnp.asarray(e.numpy()), LL_OUT,
                                       bf16=True))
    got = tsf.scan_surface(torch.from_numpy(llf), e, LL_OUT, bf16=True)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (nt, hc, wc)
    np.testing.assert_allclose(got.numpy(), want, rtol=CORR_RTOL,
                               atol=CORR_ATOL)
    # bf16 quantisation is visible against the float32 correlation
    f32 = tsf.scan_surface(torch.from_numpy(llf), e, LL_OUT).numpy()
    assert np.abs(got.numpy() - f32).max() > CORR_ATOL


def test_plain_version_is_bf16_products_float32_sums():
    """The plain version equals a float64 correlation of the rounded
    operands (each product exact) to float32 summation noise, and
    subtracts shift * mass from it."""
    rng = np.random.default_rng(1)
    fpad = torch.from_numpy(rng.uniform(-2.0, 0.0, (21, 26))
                            .astype(np.float32))
    e = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 9, 9)).astype(np.float32))
    shift, mass = 0.75, e.sum((1, 2))
    got = k4.surface_corr_bf16(fpad, e, shift, mass)
    a = k4.round_bf16(fpad + shift).double()
    b = k4.round_bf16(e).double()
    want = torch.nn.functional.conv2d(a[None, None], b[:, None])[0] \
        - shift * mass.double()[:, None, None]
    assert got.shape == (3, 13, 18)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-4)
    assert k4.launches == 0          # a CPU tensor takes the plain version


def test_fft_ignores_bf16():
    """fft first, bf16 only on the direct branch: with fft=True, bf16
    changes no bit."""
    rng = np.random.default_rng(2)
    llf = torch.from_numpy(rng.uniform(LL_OUT, 0.0, (30, 22))
                           .astype(np.float32))
    e = torch.from_numpy(rng.uniform(0, 1, (4, 15, 15)).astype(np.float32))
    assert torch.equal(tsf.scan_surface(llf, e, LL_OUT, bf16=True, fft=True),
                       tsf.scan_surface(llf, e, LL_OUT, fft=True))


def test_surface_volume_auto_fft_keeps_float32_bits(scan_log):
    """surface_volume with surface_bf16 and surface_corr "auto" at the mega
    shapes (25 bins, K = 405, 120 x 120: auto picks the FFT) gives the
    float32 volume's bits; with "direct" the bf16 flag does change it."""
    frames, _ = scan_log
    cfg = mega_config().replace(num_particles=8)
    b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    f = frame_at(b, 2)
    scan = deskew_scan(f.scan, f.odom)
    rng = np.random.default_rng(3)
    lo = torch.from_numpy(np.where(rng.uniform(size=(120, 120)) < 0.05, 2.0,
                                   -0.5).astype(np.float32))
    center = torch.tensor([0.1, -0.2, 0.05])
    taps = SharedMapSLAM(cfg, device="cpu").taps
    bf = cfg.with_overrides({"matcher.surface_bf16": True})
    c_f32, _, _ = ts.surface_volume(cfg, taps, lo, scan, center)
    c_bf, _, _ = ts.surface_volume(bf, taps, lo, scan, center)
    assert torch.equal(c_bf, c_f32)

    small = {"matcher.surface_nt": 3, "sensor.max_range": 1.5,
             "matcher.surface_corr": "direct"}
    f = frame_at(frames_to_device(frames, cfg.max_beams, 1.5), 2)
    scan = deskew_scan(f.scan, f.odom)
    d_f32, _, _ = ts.surface_volume(cfg.with_overrides(small), taps, lo,
                                    scan, center)
    d_bf, _, _ = ts.surface_volume(bf.with_overrides(small), taps, lo, scan,
                                   center)
    assert not torch.equal(d_bf, d_f32)


# ------------------------------------------------------ the engine
def _bf16_config(**over):
    """6 x 6 m at 10 cm, a 4 m range (K = 85), 9 bins, the direct bf16
    correlation."""
    return JSlamConfig(num_particles=P, max_beams=96,
                       sensor=JSensorConfig(max_range=MAXR),
                       map=JMapConfig(width_m=6.0, height_m=6.0,
                                      resolution=RES, origin=(-3.0, -3.0)),
                       ).with_overrides({"matcher.surface_nt": 9,
                                         "matcher.surface_bf16": True,
                                         "matcher.surface_corr": "direct",
                                         **over})


def test_engine_volume_matches_jax(scan_log):
    """SharedMapSLAM's bf16 volume against JAX's surface_volume on a map
    with walls, at the correlation's tolerance (the volume is the bf16
    correlation: 85 x 85 taps a cell, float32 sums in other orders)."""
    frames, _ = scan_log
    jcfg = _bf16_config()
    jeng = js.SharedMapSLAM(jcfg)
    jb = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstate = jeng.init(jax.random.key(0))
    jstep = jax.jit(jeng.step_surface)
    for i in range(2):
        jstate, _ = jstep(jstate, j_frame_at(jb, i))
    from gridmap_slam_tpu.ops.geometry import deskew_scan as j_deskew
    jf = j_frame_at(jb, 2)
    center = np.array([0.2, -0.1, 0.05], np.float32)
    want, _, _ = js.surface_volume(jcfg, jeng.kernel, jstate.logodds,
                                   j_deskew(jf.scan, jf.odom),
                                   jnp.asarray(center))
    tcfg = config_from_jax(jcfg)
    f = frame_at(frames_to_device(frames, jcfg.max_beams, MAXR), 2)
    got, _, kc = ts.surface_volume(
        tcfg, SharedMapSLAM(tcfg, device="cpu").taps,
        torch.from_numpy(np.array(jstate.logodds)),
        deskew_scan(f.scan, f.odom), torch.from_numpy(center))
    assert kc == 42
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CORR_RTOL, atol=CORR_ATOL)


def test_step_surface_bf16_matches_jax(scan_log):
    """One bf16 surface step from the same state with JAX's draws injected,
    for 3 successive JAX states."""
    frames, _ = scan_log
    jcfg = _bf16_config()
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    jb = j_frames_to_device(frames, jcfg.max_beams, MAXR)
    b = frames_to_device(frames, jcfg.max_beams, MAXR)
    jstep = jax.jit(jeng.step_surface)
    jstate = jeng.init(jax.random.key(0))
    for i in range(3):
        state = shared_state_from_jax_arrays(
            *(np.asarray(x) for x in (jstate.poses, jstate.log_weights,
                                      jstate.logodds, jstate.step,
                                      jstate.recov)))
        jnext, jinfo = jstep(jstate, j_frame_at(jb, i))
        nxt, info = eng.step_surface(state, frame_at(b, i),
                                     draws=_jax_draws(jstate.key, P, False))
        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        assert (np.abs(nxt.logodds.numpy() - np.asarray(jnext.logodds))
                > K2_ATOL).mean() <= K2_MAX_FRAC
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        jstate = jnext


def test_bf16_log_ate_and_captured_replay(scan_log):
    """An 8-scan log at 256 particles through both engines: the port's ATE
    within 0.06 m of the JAX run's; replay_surface_jit (on the CPU its
    static-buffer loop) gives run_log's bits."""
    frames, gt = scan_log
    n = len(frames)
    jcfg = _bf16_config().replace(num_particles=256)
    jeng = js.SharedMapSLAM(jcfg)
    jb = j_frames_to_device(frames, jcfg.max_beams, MAXR)
    jstep = jax.jit(jeng.step_surface)
    jstate = jeng.init(jax.random.key(0))
    jtraj = []
    for i in range(n):
        jstate, jinfo = jstep(jstate, j_frame_at(jb, i))
        jtraj.append(np.asarray(jinfo.weighted_pose))

    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    b = frames_to_device(frames, jcfg.max_beams, MAXR)
    state, infos = eng.run_log(eng.init(), [frame_at(b, i) for i in range(n)],
                               torch.Generator().manual_seed(0))
    traj = torch.stack([i.weighted_pose for i in infos]).numpy()
    ate_j, ate_t = ate_rmse(np.stack(jtraj), gt[:n]), ate_rmse(traj, gt[:n])
    assert abs(ate_j - ate_t) <= 0.06, (ate_j, ate_t)
    assert max(ate_j, ate_t) < 0.15, (ate_j, ate_t)

    st, stacked = eng.replay_surface_jit()(eng.init(), b,
                                            torch.Generator().manual_seed(0))
    for name in ("poses", "log_weights", "logodds", "step", "recov"):
        assert torch.equal(getattr(st, name), getattr(state, name)), name
    assert torch.equal(stacked.weighted_pose, torch.from_numpy(traj))


# ------------------------------------------------------ surface_sharded
def test_surface_sharded_bf16_on_two_ranks_matches_jax(tmp_path):
    """surface_sharded with surface_bf16 on 2 gloo ranks (each rank
    correlates its own theta bins in bf16) against the JAX engine on 2
    devices with JAX's draws, at tests/test_torch_tiled.py's tolerances,
    and the ranks agree."""
    from tests.test_torch_tiled import _surface_sharded_close

    cfg = surface_config().with_overrides({"matcher.surface_bf16": True,
                                           "matcher.surface_corr": "direct"})
    cases, jres, _ = build_cases(
        [("ss_bf16", "surface_sharded", cfg)], 2,
        lambda c: log_frames(c, beams=90))
    outs = launch(cases, 2, tmp_path)
    steps = outs[0]["ss_bf16"]["steps"]
    assert len(steps) == len(jres["ss_bf16"]) > 1
    for got, want in zip(steps, jres["ss_bf16"]):
        _surface_sharded_close(got, want, JAX_LW_ATOL)
        assert (np.abs(got["logodds"] - want["logodds"]) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
    for a, b in zip(steps, outs[1]["ss_bf16"]["steps"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------ the launch plan
@pytest.mark.parametrize("shape", [(25, 405, 120, 120), (25, 405, 512, 512),
                                   (1, 7, 10, 13), (7, 51, 17, 29),
                                   (16, 64, 128, 128), (5, 85, 60, 60)])
def test_launch_plan_covers_the_volume(shape):
    """The plan's blocks cover every output row, column, bin and tap row
    once, its staging fits a block's and two blocks an SM's shared memory,
    the pitches hold what the kernel reads, and the grid is inside CUDA's
    limits; the mega shapes split the tap rows so that the grid fills the
    card."""
    nt, k, hc, wc = shape
    plan = k4.launch_plan(nt, k, hc, wc)
    assert plan is not None
    assert plan.chunk * plan.chunks >= k > plan.chunk * (plan.chunks - 1)
    assert plan.groups * plan.rows >= hc > (plan.groups - 1) * plan.rows
    assert plan.col_tiles * k4.TILE_X >= wc > (plan.col_tiles - 1) * k4.TILE_X
    assert plan.bin_tiles * k4.BINS >= nt > (plan.bin_tiles - 1) * k4.BINS
    assert plan.ksteps * 16 >= k
    # the A window's last load: word 16 (ksteps - 1) + 8 (WINDOW + 1) + 13
    assert plan.pitch_f > 16 * (plan.ksteps - 1) + 8 * (k4.WINDOW + 1) + 13
    assert plan.pitch_e >= 8 * plan.ksteps and plan.pitch_e % 8 == 4
    assert plan.smem_bytes == 4 * ((plan.rows + 1) * plan.pitch_f
                                   + 2 * k4.BINS * plan.pitch_e)
    assert plan.smem_bytes <= 48 * 1024
    assert plan.groups * plan.bin_tiles <= 65535
    blocks = plan.col_tiles * plan.groups * plan.bin_tiles * plan.chunks
    if shape == (25, 405, 120, 120):
        assert plan.chunks > 1 and blocks >= k4.H100["sm_count"]


def test_launch_plan_refuses_what_does_not_fit():
    """No plan for an empty volume or staging past a block's shared
    memory; a card of fewer SMs may split the tap rows differently, but
    the plan still covers them."""
    assert k4.launch_plan(0, 7, 10, 10) is None
    assert k4.launch_plan(5, 0, 10, 10) is None
    assert k4.launch_plan(5, 7, 0, 10) is None
    assert k4.launch_plan(25, 405, 120, 120, smem_block=20_000) is None
    big = k4.launch_plan(3, 1001, 8, 8)       # opts in past 48 KB
    assert big is not None and 48 * 1024 < big.smem_bytes < 100_000
    assert k4.launch_plan(3, 1001, 8, 8, smem_block=60_000) is None
    assert k4.launch_plan(3, 4001, 8, 8) is None
    small = k4.launch_plan(25, 405, 120, 120, sm_count=16)
    assert small.chunk * small.chunks >= 405


def test_wrapper_refuses_cpu_tensors_for_the_kernel():
    """The kernel's entry point takes card tensors only: no fallback."""
    fpad = torch.zeros((20, 20))
    e = torch.zeros((2, 5, 5))
    with pytest.raises(ValueError, match="must be on"):
        k4.surface_corr_bf16_cuda(fpad, e, 0.5, e.sum((1, 2)))
