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
K4's prologue has a plain version too (`prepare_bf16_plain`: the live
16-tap groups of each 8-bin tile and tap row, their order and their packed
tensor-core fragments), held bit for bit to a numpy definition here and to
the kernel's prologue on the card by chip_smoke.py; `launch_plan` is pure
Python and tested here at the shapes chip_smoke.py runs K4 at.
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


# ------------------------------------------------------ the preparation
def _np_bf16_bits(x):
    """float32 -> bf16 bits, round to nearest even, in numpy (finite x)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint64) & 0xFFFF


def _np_prep(fpad, e, shift, pitch_w):
    """The prologue's buffers from their definition: for each bin tile b
    and tap row dy, the k steps s whose 16 taps over the tile's 8 bins hold
    a nonzero rounded tap, ascending, with lane 4 g + t's words (taps
    16 s + 2 t, + 1) and (16 s + 2 t + 8, + 9) of bin 8 b + g; the field's
    pair words.  Returns (field, {(b, dy): [(s, words (32, 2))]})."""
    nt, k, _ = e.shape
    eb = _np_bf16_bits(e)
    fb = _np_bf16_bits(fpad + np.float32(shift))
    hp, wp = fpad.shape

    def tap(t, dy, kk):
        return int(eb[t, dy, kk]) if t < nt and kk < k else 0

    def fcol(r, j):
        return int(fb[r, j]) if j < wp else 0

    field = np.array([[fcol(r, j) | fcol(r, j + 1) << 16
                       for j in range(pitch_w)] for r in range(hp)],
                     np.uint64)
    lists = {}
    for b in range(-(-nt // 8)):
        for dy in range(k):
            row = []
            for s in range(-(-k // 16)):
                words = np.zeros((32, 2), np.uint64)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for h in range(2):
                        kk = 16 * s + 8 * h + 2 * t
                        words[lane, h] = (tap(8 * b + g, dy, kk)
                                          | tap(8 * b + g, dy, kk + 1) << 16)
                if ((words & 0x7FFF7FFF) != 0).any():
                    row.append((s, words))
            lists[b, dy] = row
    return field, lists


def _u32(t):
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


def _case_images(case, nt, k, rng, frames=None):
    e = np.zeros((nt, k, k), np.float32)
    if case == "sparse":
        e[rng.uniform(size=e.shape) < 0.004] = 0.5
    elif case == "dense":
        e = rng.uniform(0.01, 1.0, e.shape).astype(np.float32)
    elif case == "single":
        e[nt - 1, k // 3, k // 2] = 0.37
        e[0, 1, 1] = -0.0                   # a negative zero is no tap
    elif case == "last":
        e[nt - 1, k - 1, k - 1] = 1.0       # the last k step of the last row
    elif case == "tiny":
        e[0, 2, 3] = 1e-39                  # a subnormal tap stays live
    elif case == "splat":
        e = _real_splat(frames, nt, (k - 1) // 2).numpy()
    return e


@pytest.mark.parametrize("case,nt,k", [
    ("sparse", 5, 37), ("dense", 3, 21), ("zero", 9, 19), ("single", 25, 23),
    ("last", 25, 37), ("tiny", 2, 9), ("sparse", 25, 53), ("splat", 25, 51)])
def test_prepare_plain_matches_numpy(scan_log, case, nt, k):
    """prepare_bf16_plain (the prologue's plain version) against the
    numpy definition: per bin tile and tap row the live groups' count, their
    k steps in ascending order and their packed B fragments; the field's
    pair words.  Sparse, dense, all-zero, single-tap, subnormal and a real
    splat's images; 25 bins (a last tile of one bin); a tap only in the last
    k step of the last tap row (K = 37: that step holds 5 taps)."""
    rng = np.random.default_rng(k * 10 + nt)
    e = _case_images(case, nt, k, rng, scan_log[0])
    hc, wc = 6, 9
    fpad = rng.uniform(-2.0, 0.0, (hc + k - 1, wc + k - 1)).astype(np.float32)
    shift = 0.7
    plan = k4.launch_plan(nt, k, hc, wc)
    prep = k4.prepare_bf16_plain(torch.from_numpy(fpad), torch.from_numpy(e),
                                 shift, plan)
    tiles, ksteps = plan.bin_tiles, plan.ksteps
    assert prep.field.shape == (hc + k - 1, plan.pitch_w)
    assert prep.frags.shape == (tiles, k, ksteps, 32, 2)
    assert prep.ks.shape == (tiles, k, ksteps)
    assert prep.counts.shape == (tiles, k)
    assert all(x.dtype == torch.int32 for x in prep)
    field, lists = _np_prep(fpad, e, shift, plan.pitch_w)
    np.testing.assert_array_equal(_u32(prep.field), field)
    counts, ks, frags = prep.counts.numpy(), prep.ks.numpy(), _u32(prep.frags)
    for (b, dy), row in lists.items():
        n = len(row)
        assert counts[b, dy] == n, (b, dy)
        np.testing.assert_array_equal(ks[b, dy, :n], [s for s, _ in row])
        for i, (_, words) in enumerate(row):
            np.testing.assert_array_equal(frags[b, dy, i], words)
        assert not ks[b, dy, n:].any() and not frags[b, dy, n:].any()
    total = int(counts.sum())
    if case == "zero":
        assert total == 0
    elif case == "dense":
        assert total == tiles * k * ksteps
    elif case in ("single", "tiny"):
        assert total == 1
    elif case == "last":
        assert total == 1 and counts[tiles - 1, k - 1] == 1
        assert ks[tiles - 1, k - 1, 0] == ksteps - 1
    else:
        assert 0 < total < tiles * k * ksteps


@pytest.mark.parametrize("case,nt,k", [("sparse", 7, 45), ("splat", 25, 41),
                                       ("dense", 9, 17)])
def test_prepared_lists_hold_every_tap(scan_log, case, nt, k):
    """The live groups' fragments, unpacked into a dense image, are exactly
    the rounded endpoint images: every nonzero tap lies in a listed group,
    and a skipped group holds only zeros (its products add nothing)."""
    rng = np.random.default_rng(nt + k)
    e = torch.from_numpy(_case_images(case, nt, k, rng, scan_log[0]))
    fpad = torch.zeros((k + 4, k + 6))
    plan = k4.plan_for(fpad, e)
    prep = k4.prepare_bf16_plain(fpad, e, 0.0, plan)
    words = _u32(prep.frags)
    dense = np.zeros((8 * plan.bin_tiles, k, 16 * plan.ksteps), np.uint64)
    for b, dy in zip(*np.nonzero(prep.counts.numpy())):
        for i in range(int(prep.counts[b, dy])):
            s = int(prep.ks[b, dy, i])
            for lane in range(32):
                g, t = divmod(lane, 4)
                for h in range(2):
                    kk = 16 * s + 8 * h + 2 * t
                    w = words[b, dy, i, lane, h]
                    dense[8 * b + g, dy, kk] = w & 0xFFFF
                    dense[8 * b + g, dy, kk + 1] = w >> 16
    want = (k4.round_bf16(e).numpy().view(np.uint32) >> 16).astype(np.uint64)
    np.testing.assert_array_equal(dense[:nt, :, :k], want)
    assert not dense[nt:].any() and not dense[:, :, k:].any()
    assert k4.launches == 0


def test_prep_views_match_the_plain_layout():
    """The kernel's scratch, cut by the wrapper's views, has the plain
    preparation's buffers' shapes and uses every word once."""
    nt, k, hp, wp = 25, 41, 50, 61
    plan = k4.launch_plan(nt, k, hp - k + 1, wp - k + 1)
    scratch = torch.arange(plan.scratch_words, dtype=torch.int32)
    views = k4._prep_views(scratch, nt, k, hp, plan)
    plain = k4.prepare_bf16_plain(torch.zeros((hp, wp)),
                                  torch.zeros((nt, k, k)), 0.0, plan)
    assert [v.shape for v in views] == [p.shape for p in plain]
    assert sum(v.numel() for v in views) == plan.scratch_words
    seen = torch.cat([v.reshape(-1) for v in views]).sort().values
    assert torch.equal(seen, scratch)
    # the fragments come first (8-byte loads), the field after them
    assert views.frags.data_ptr() == scratch.data_ptr()


# ------------------------------------------------------ the launch plan
@pytest.mark.parametrize("shape", [(25, 405, 120, 120), (25, 405, 512, 512),
                                   (1, 7, 10, 13), (7, 51, 17, 29),
                                   (16, 64, 128, 128), (5, 85, 60, 60),
                                   (5, 51, 17, 29), (7, 25, 40, 31),
                                   (9, 101, 37, 45)])
def test_launch_plan_covers_the_volume(shape):
    """The plan's blocks cover every output row, column and bin, its runs
    every live group of a bin tile (at most one cluster of 8), its field
    pitch every word the A windows read, its shared memory the partial
    sums and the row offsets within a block's and two blocks an SM's
    limits, and the grid is inside CUDA's limits; the runs are the most
    that keep every cluster of the grid resident at once on an H100 (its
    cluster counts), so the mega shapes (mega_bf16) split each list in 4,
    the dense (16, 64, 128, 128) in 7, and the city crop, whose grid fills
    the card, not at all.  The shapes: mega_bf16's and city_bf16's steps,
    and chip_smoke.py's K4_SHAPES."""
    nt, k, hc, wc = shape
    plan = k4.launch_plan(nt, k, hc, wc)
    assert plan is not None
    assert plan.groups * k4.ROWS >= hc > (plan.groups - 1) * k4.ROWS
    assert plan.col_tiles * k4.TILE_X >= wc > (plan.col_tiles - 1) * k4.TILE_X
    assert plan.bin_tiles * k4.BINS >= nt > (plan.bin_tiles - 1) * k4.BINS
    assert plan.ksteps * 16 >= k > (plan.ksteps - 1) * 16
    assert 1 <= plan.runs <= k4.MAX_RUNS
    # the last A window's last word: column tile, k step, lane, window
    last = (k4.TILE_X * (plan.col_tiles - 1) + 16 * (plan.ksteps - 1) + 13
            + 8 * 16)
    assert plan.pitch_w > last and plan.pitch_w % 4 == 0
    # ... rounded up to 16 bytes
    assert plan.pitch_w >= (k4.TILE_X * (plan.col_tiles - 1)
                            + 16 * (plan.ksteps - 1) + k4.WINDOW_ROW)
    assert plan.pitch_w >= wc + k - 1 - 1          # every field word pair
    assert plan.smem_bytes == 4 * (k4.BINS * k4.RED_PITCH + k + 1)
    assert plan.smem_bytes <= 48 * 1024
    assert 2 * (plan.smem_bytes + 1024) <= k4.H100["smem_sm"]
    assert plan.groups * plan.bin_tiles <= 65535
    tiles = plan.col_tiles * plan.groups * plan.bin_tiles
    clusters = k4.H100_CLUSTERS
    assert tiles <= clusters[plan.runs - 1] or plan.runs == 1
    assert plan.runs == k4.MAX_RUNS or tiles > clusters[plan.runs]
    assert plan.scratch_words == k4.scratch_words(nt, k, hc + k - 1,
                                                  plan.pitch_w)
    if shape == (25, 405, 120, 120):
        assert plan.runs == 4 and tiles * plan.runs >= k4.H100["sm_count"]
    if shape == (16, 64, 128, 128):
        assert plan.runs == 7
    if shape == (25, 405, 512, 512):
        assert plan.runs == 1 and tiles >= 2 * k4.H100["sm_count"]


def test_launch_plan_refuses_what_does_not_fit():
    """No plan for an empty volume, a tap row of more than 256 k steps,
    shared memory past a block's limit or a grid past CUDA's; a card that
    holds fewer clusters splits the lists into fewer runs, one that holds
    more into up to 8."""
    assert k4.launch_plan(0, 7, 10, 10) is None
    assert k4.launch_plan(5, 0, 10, 10) is None
    assert k4.launch_plan(5, 7, 0, 10) is None
    assert k4.launch_plan(5, 7, 10, 0) is None
    assert k4.launch_plan(25, 405, 120, 120, smem_block=20_000) is None
    big = k4.launch_plan(3, 4096, 8, 8)       # opts in past 48 KB
    assert big is not None and 48 * 1024 < big.smem_bytes < 100_000
    assert k4.launch_plan(3, 4096, 8, 8, smem_block=48 * 1024) is None
    assert k4.launch_plan(3, 4097, 8, 8) is None
    assert k4.launch_plan(8, 3, 8 * 65535, 8) is not None
    assert k4.launch_plan(8, 3, 8 * 65536, 8) is None
    small = k4.launch_plan(25, 405, 120, 120,
                           clusters=(32, 16, 10, 8, 6, 5, 4, 4))
    assert small.runs == 1
    assert k4.launch_plan(25, 405, 120, 120,
                          clusters=(528, 264, 160, 124, 94, 60, 64, 60)
                          ).runs == 8
    assert k4.launch_plan(25, 405, 120, 120,
                          clusters=(528, 264, 160, 124, 94, 60, 59, 59)
                          ).runs == 6


def test_wrapper_refuses_cpu_tensors_for_the_kernel():
    """The kernel's entry points take card tensors only: no fallback."""
    fpad = torch.zeros((20, 20))
    e = torch.zeros((2, 5, 5))
    with pytest.raises(ValueError, match="must be on"):
        k4.surface_corr_bf16_cuda(fpad, e, 0.5, e.sum((1, 2)))
    with pytest.raises(ValueError, match="must be on"):
        k4.prepare_bf16_cuda(fpad, e, 0.5)
