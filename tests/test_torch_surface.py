"""The port's surface ops (ops/surface.py, models/shared.surface_volume),
held to the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both.  Tolerances:
exact for the integer and static helpers; 1e-6 for the endpoint splat (a
one-hot matmul whose only rounding is the order of at most four nonzero
terms a cell); rtol 1e-5 / atol 1e-3 for the direct correlation (both are
f32 convolutions over up to 51 x 51 taps, summed in different orders);
atol 5e-2 and mean 5e-3 for the FFT correlation (the JAX package's own FFT
bound, tests/test_surface.py:223-224); rtol 1e-6 / atol 1e-5 for the
trilinear samples (tests/test_surface.py:248-249); rtol 1e-5 / atol 1e-4
for the whole volume (tests/test_surface.py:352-353).  K3's plain version
is also held to JAX at the wide blur radii surface relocalization uses.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models import shared as js
from gridmap_slam_tpu.ops import matcher as jm
from gridmap_slam_tpu.ops import surface as jsf
from gridmap_slam_tpu.ops.geometry import deskew_scan as j_deskew_scan
from gridmap_slam_tpu.ops.grid import gaussian_kernel as j_gaussian_kernel
from gridmap_slam_tpu.ops.grid import likelihood_field as j_likelihood_field
from gridmap_slam_tpu.ops.pallas.likelihood import log_likelihood_field_pallas
from gridmap_slam_tpu_torch.convert import config_from_jax
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models import shared as ts
from gridmap_slam_tpu_torch.ops import surface as tsf
from gridmap_slam_tpu_torch.ops.cuda import likelihood
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

torch.set_num_threads(1)

RES, ORIGIN, MAXR = 0.1, (-3.0, -3.0), 5.0
LL_OUT = math.log(1.0 / MAXR)


def _t(a):
    return torch.from_numpy(np.array(a))


def _llf(seed=2, h=60, w=60):
    """A log-likelihood field of walls and free space (the map of
    tests/test_surface.py's fixture)."""
    rng = np.random.RandomState(seed)
    lo = np.zeros((h, w), np.float32)
    occ = rng.randint(3, h - 3, (60, 2))
    lo[occ[:, 0], occ[:, 1]] = 2.0
    fr = rng.randint(3, h - 3, (300, 2))
    lo[fr[:, 0], fr[:, 1]] -= 1.5
    field, unknown = j_likelihood_field(jnp.asarray(lo),
                                        j_gaussian_kernel(1.0, 3))
    return np.asarray(jm.log_likelihood_field(field, unknown, 0.9, MAXR))


def _endpoints(n=48, seed=0):
    rng = np.random.RandomState(seed)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dist = 0.8 + 0.9 * np.abs(np.sin(2 * ang)) + rng.uniform(0, 0.05, n)
    px, py = (dist * np.cos(ang)).astype(np.float32), \
        (dist * np.sin(ang)).astype(np.float32)
    wgt = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return px, py, wgt


def _splats(thetas, kc):
    px, py, wgt = _endpoints()
    want = np.asarray(jsf.splat_endpoint_kernels(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(wgt),
        jnp.asarray(thetas), kc, RES))
    got = tsf.splat_endpoint_kernels(_t(px), _t(py), _t(wgt), _t(thetas), kc,
                                     RES)
    return got, want


# ------------------------------------------------------ static helpers
def test_crop_center_theta_grid_fft_size_exact():
    rng = np.random.default_rng(0)
    centers = np.concatenate([rng.uniform(-4, 4, (40, 2)),
                              [[0.0, 0.0], [-10.0, 99.0], [-2.95, 2.95],
                               [0.05, -0.05]]]).astype(np.float32)
    for c in centers:
        for crop, full in (((20, 20), (60, 60)), ((48, 30), (60, 80)),
                           ((60, 60), (60, 60))):
            want = jsf.crop_center_cells(jnp.asarray(c), crop, full, RES,
                                         ORIGIN)
            got = tsf.crop_center_cells(_t(c), crop, full, RES, ORIGIN)
            assert [int(v) for v in got] == [int(v) for v in want], (c, crop)
    for nt in (1, 5, 16, 25):
        for span in (12.0, 24.0, 90.0, 179.99, 180.0):
            assert (tsf.theta_grid(nt, math.radians(span))
                    == jsf.theta_grid(nt, math.radians(span)))
    assert [tsf._fft_size(n) for n in range(2, 1201)] \
        == [jsf._fft_size(n) for n in range(2, 1201)]
    # the mega and city presets' correlation lengths
    assert (tsf._fft_size(524), tsf._fft_size(916)) == (540, 1024)


# ------------------------------------------------------ splat and volume
def test_splat_endpoint_kernels_matches():
    thetas = np.array([-0.3, 0.0, 0.45, 3.1], np.float32)
    got, want = _splats(thetas, 22)
    assert got.shape == want.shape == (4, 45, 45)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("fft", [False, True])
def test_scan_surface_matches(fft):
    llf = _llf()
    thetas = np.array([-0.2, 0.1, 0.3], np.float32)
    got_e, want_e = _splats(thetas, 25)
    want = np.asarray(jsf.scan_surface(jnp.asarray(llf), jnp.asarray(want_e),
                                       LL_OUT, fft=fft))
    got = tsf.scan_surface(_t(llf), got_e, LL_OUT, fft=fft).numpy()
    assert got.shape == want.shape == (3, 60, 60)
    if fft:
        np.testing.assert_allclose(got, want, atol=5e-2)
        assert np.abs(got - want).mean() < 5e-3
        direct = tsf.scan_surface(_t(llf), got_e, LL_OUT).numpy()
        np.testing.assert_allclose(got, direct, atol=5e-2)
        assert np.abs(got - direct).mean() < 5e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_scan_surface_bf16_refused():
    """surface_bf16 is refused nowhere: the engine takes it, and
    scan_surface's bf16 switch gives a float32 volume of the float32
    correlation's shape (its values are held to JAX in
    tests/test_torch_surface_corr.py)."""
    cfg = config_from_jax(JSlamConfig().with_overrides(
        {"matcher.surface_bf16": True}))
    assert ts.SharedMapSLAM(cfg, device="cpu").config.matcher.surface_bf16
    llf = _llf()
    e, _ = _splats(np.zeros(1, np.float32), 5)
    f32 = tsf.scan_surface(_t(llf), e, LL_OUT)
    bf16 = tsf.scan_surface(_t(llf), e, LL_OUT, bf16=True)
    assert f32.dtype == bf16.dtype == torch.float32
    assert f32.shape == bf16.shape


# ------------------------------------------------------ sampling
def _volume_and_poses(seed=3, nt=9, hc=24, wc=20, n=500):
    rng = np.random.RandomState(seed)
    vol = rng.randn(nt, hc, wc).astype(np.float32)
    poses = np.stack([rng.uniform(-2.0, 2.0, n),     # deliberately past crop
                      rng.uniform(-2.0, 2.0, n),
                      rng.uniform(-7.0, 7.0, n)], -1).astype(np.float32)
    return vol, poses


def _tap_kw(wrap, nt):
    return dict(theta0=-math.pi if wrap else -0.4,
                dtheta=(2 * math.pi / nt) if wrap else 0.1, crop_iy0=2,
                crop_ix0=3, resolution=0.05, origin=(-1.0, -1.0),
                wrap_theta=wrap)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wrap", [False, True])
def test_sample_surface_matches(wrap, packed):
    vol, poses = _volume_and_poses()
    kw = _tap_kw(wrap, vol.shape[0])
    jpk = jsf.pack_neighborhoods(jnp.asarray(vol), wrap) if packed else None
    tpk = tsf.pack_neighborhoods(_t(vol), wrap) if packed else None
    if packed:
        np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    want = np.asarray(jsf.sample_surface(jnp.asarray(vol),
                                         jnp.asarray(poses), packed=jpk,
                                         **kw))
    got = tsf.sample_surface(_t(vol), _t(poses), packed=tpk, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # and the two paths of the port agree with each other
    other = tsf.sample_surface(_t(vol), _t(poses),
                               packed=None if packed else
                               tsf.pack_neighborhoods(_t(vol), wrap),
                               **kw).numpy()
    np.testing.assert_allclose(got, other, rtol=1e-6, atol=1e-5)


def test_refine_on_surface_matches():
    """3 hill-climb steps on a random volume.  JAX runs the climb jitted,
    where XLA's fusion moves samples by up to ~1e-5, so where two moves tie
    that closely (a pose clamped past the bin span or the crop reads the
    same cells from both) either pick is right: the scores agree
    everywhere, the poses at >= 99 % of particles."""
    vol, _ = _volume_and_poses(seed=4)
    rng = np.random.RandomState(5)
    poses = np.stack([rng.uniform(-0.7, 0.0, 300), rng.uniform(-0.75, 0.15, 300),
                      rng.uniform(-0.25, 0.25, 300)], -1).astype(np.float32)
    kw = _tap_kw(False, vol.shape[0])
    jvol = jnp.asarray(vol)
    s0 = jsf.sample_surface(jvol, jnp.asarray(poses), **kw)
    jp, jsc = jsf.refine_on_surface(jvol, jnp.asarray(poses), s0, steps=3,
                                    **kw)
    tp, tsc = tsf.refine_on_surface(_t(vol), _t(poses), _t(s0), steps=3,
                                    **kw)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6,
                               atol=1e-5)
    same = np.abs(tp.numpy() - np.asarray(jp)).max(1) <= 1e-6
    assert same.mean() >= 0.99, same.mean()
    assert (tsc.numpy() >= np.asarray(s0)).all()
    assert (np.abs(tp.numpy() - poses).max(1) > 0).mean() > 0.5


# ------------------------------------------------------ surface_volume
_VOLUME_CASES = {
    # full map; the extended window does not fit, so the field is built
    # over the whole map
    "full": (dict(), (0.3, -0.2, 0.1)),
    # a 48-cell crop in the interior: crop-local field build
    "crop": ({"matcher.surface_crop_cells": 48}, (0.3, -0.2, 0.1)),
    # the same crop clamped at the world edge
    "edge": ({"matcher.surface_crop_cells": 48}, (-7.9, -4.9, 0.0)),
    # sigma 4 cells (radius 12), full circle of theta bins, FFT
    "wide": ({"matcher.surface_crop_cells": 48,
              "map.likelihood_sigma_cells": 4.0,
              "matcher.surface_theta_span_deg": 180.0,
              "matcher.surface_corr": "fft"}, (2.0, 1.0, -2.5)),
}


@pytest.fixture(scope="module")
def volume_map():
    """A 16 x 10 m map with two scans integrated, and a third scan."""
    cfg = JSlamConfig(
        num_particles=8, max_beams=96, sensor=JSensorConfig(max_range=4.0),
        map=JMapConfig(width_m=16.0, height_m=10.0, resolution=0.1,
                       origin=(-8.0, -5.0)),
    ).with_overrides({"matcher.surface_nt": 5})
    eng = js.SharedMapSLAM(cfg)
    frames, _ = simulate_log(default_world(), square_path_controls(3),
                             params=SimParams(beams_per_rev=90), seed=3)
    batch = j_frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    state = eng.init(jax.random.key(0))
    step = jax.jit(eng.step_surface)
    for i in range(2):
        state, _ = step(state, j_frame_at(batch, i))
    return cfg, np.asarray(state.logodds), frames


@pytest.mark.parametrize("case", sorted(_VOLUME_CASES))
def test_surface_volume_matches(volume_map, case):
    base, lo, frames = volume_map
    over, center = _VOLUME_CASES[case]
    cfg = base.with_overrides(over)
    jeng = js.SharedMapSLAM(cfg)
    jframe = j_frame_at(j_frames_to_device(frames, cfg.max_beams,
                                           cfg.sensor.max_range), 2)
    jscan = j_deskew_scan(jframe.scan, jframe.odom)
    jc = jnp.asarray(center, jnp.float32)
    want, jkw, jkc = js.surface_volume(cfg, jeng.kernel, jnp.asarray(lo),
                                       jscan, jc)

    tcfg = config_from_jax(cfg)
    teng = ts.SharedMapSLAM(tcfg, device="cpu")
    frame = frame_at(frames_to_device(frames, cfg.max_beams,
                                      cfg.sensor.max_range), 2)
    scan = deskew_scan(frame.scan, frame.odom)
    got, tkw, tkc = ts.surface_volume(tcfg, teng.taps, _t(lo), scan,
                                      _t(np.asarray(center, np.float32)))
    assert tkc == jkc
    assert int(tkw["crop_iy0"]) == int(jkw["crop_iy0"])
    assert int(tkw["crop_ix0"]) == int(jkw["crop_ix0"])
    for k in ("dtheta", "wrap_theta", "resolution", "origin"):
        assert tkw[k] == jkw[k], k
    np.testing.assert_allclose(float(tkw["theta0"]), float(jkw["theta0"]),
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    if case == "edge":
        assert (int(tkw["crop_iy0"]), int(tkw["crop_ix0"])) == (0, 0)
    np.testing.assert_allclose(
        tsf.pack_neighborhoods(got, tkw["wrap_theta"]).numpy(),
        np.asarray(jkw["packed"]), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------ K3 at wide radii
@pytest.mark.parametrize("sigma", [4.0, 10.0])
def test_k3_plain_matches_xla_wide_radius(sigma):
    """K3's plain version (the reference its kernel is held to on the card)
    against JAX at radius 12 and 30, and against the Pallas kernel in
    interpret mode (which needs H % 8 == 0, W % 128 == 0)."""
    radius = int(math.ceil(3 * sigma))
    rng = np.random.default_rng(radius)
    u = rng.uniform(size=(2, 64, 128))
    lo = np.where(u < 0.05, 2.2, np.where(u < 0.3, -0.9, 0.0)
                  ).astype(np.float32)
    lo[1, :, :40] = 0.0                   # an unexplored band
    k = gaussian_kernel(sigma, radius)
    np.testing.assert_array_equal(k, j_gaussian_kernel(sigma, radius))

    def xla_ll(x):
        f, un = j_likelihood_field(x, k)
        return jm.log_likelihood_field(f, un, 0.9, 10.0)

    got = likelihood.log_likelihood_field_batch(
        _t(lo), torch.as_tensor(k), z_hit=0.9, max_range=10.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.vmap(xla_ll)(
        jnp.asarray(lo))), atol=1e-5)
    pallas = log_likelihood_field_pallas(
        jnp.asarray(lo), kernel_tuple=tuple(float(x) for x in k), z_hit=0.9,
        max_range=10.0, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
