"""The PyTorch port's ops against the JAX package's, on the same inputs.

Inputs come from numpy with a fixed seed and go through both sides; JAX runs
on the CPU.  Tolerances are stated per test (float32 transcendentals differ
by a few ulp between XLA and PyTorch).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MotionConfig
from gridmap_slam_tpu.ops import geometry as jgeo
from gridmap_slam_tpu.ops import motion as jmotion
from gridmap_slam_tpu.ops import raycast as jray
from gridmap_slam_tpu.ops import resample as jres
from gridmap_slam_tpu.ops.grid import likelihood_field as j_likelihood_field
from gridmap_slam_tpu.types import Odom as JOdom
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu_torch.ops import geometry as tgeo
from gridmap_slam_tpu_torch.ops import motion as tmotion
from gridmap_slam_tpu_torch.ops import raycast as tray
from gridmap_slam_tpu_torch.ops import resample as tres
from gridmap_slam_tpu_torch.ops.grid import (gaussian_kernel, inv_log_odds,
                                             likelihood_field)
from gridmap_slam_tpu_torch.types import Odom, Scan

torch.set_num_threads(1)

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _scans(n=80, width=96, seed=0):
    """The same scan for both sides: n real beams padded to `width`."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False) + rng.uniform(
        -0.01, 0.01, n)
    dist = 0.6 + 0.8 * np.abs(np.sin(3 * ang)) + rng.uniform(0, 0.03, n)
    hit = rng.uniform(size=n) > 0.15
    return (JScan.from_arrays(ang, dist, hit, max_beams=width),
            Scan.from_arrays(ang, dist, hit, max_beams=width))


def test_wrap_angle_matches_including_pi():
    rng = np.random.default_rng(0)
    pi32 = np.float32(math.pi)
    edge = [pi32, -pi32, np.nextafter(pi32, np.float32(0)),
            np.nextafter(-pi32, np.float32(0)), 3 * pi32, -3 * pi32, 0.0]
    a = np.concatenate([rng.uniform(-20, 20, 500), edge]).astype(np.float32)
    want = np.asarray(jgeo.wrap_angle(jnp.asarray(a)))
    got = tgeo.wrap_angle(_t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # at the +-pi boundary both land on the same side
    np.testing.assert_array_equal(np.sign(got[-len(edge):]),
                                  np.sign(want[-len(edge):]))
    assert got[-5] > 3.14 and got[-4] < -3.14


def test_se2_ops_match():
    rng = np.random.default_rng(1)
    a = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    b = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    for jf, tf in ((jgeo.se2_compose, tgeo.se2_compose),
                   (jgeo.se2_relative, tgeo.se2_relative)):
        np.testing.assert_allclose(tf(_t(a), _t(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(a),
                                                 jnp.asarray(b))), atol=ATOL)
    np.testing.assert_allclose(tgeo.se2_inverse(_t(a)).numpy(),
                               np.asarray(jgeo.se2_inverse(jnp.asarray(a))),
                               atol=ATOL)


@pytest.mark.parametrize("d_theta", [0.0, 0.4, -0.7])
def test_deskew_scan_matches(d_theta):
    js, ts = _scans(n=70, width=96, seed=2)
    jo = JOdom(d_center=jnp.float32(0.12), d_theta=jnp.float32(d_theta))
    to = Odom(d_center=torch.tensor(0.12), d_theta=torch.tensor(d_theta))
    want = jgeo.deskew_scan(js, jo)
    got = tgeo.deskew_scan(ts, to)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               atol=ATOL)
    # angles compared on the circle (atan2 may land on either side of pi)
    dang = tgeo.wrap_angle(got.angle - _t(np.asarray(want.angle)))
    np.testing.assert_allclose(dang.numpy(), 0.0, atol=ATOL)
    sx, sy = tgeo.scan_points(got)
    jx, jy = jgeo.scan_points(want)
    np.testing.assert_allclose(sx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jy), atol=1e-5)


def test_motion_matches_with_same_normals():
    rng = np.random.default_rng(3)
    poses = rng.uniform(-2, 2, (32, 3)).astype(np.float32)
    normals = rng.standard_normal((32, 2)).astype(np.float32)
    cfg = MotionConfig()
    jo = JOdom(d_center=jnp.float32(0.07), d_theta=jnp.float32(-0.2))
    to = Odom(d_center=torch.tensor(0.07), d_theta=torch.tensor(-0.2))

    # the JAX sampler draws its own normals: rebuild its arithmetic with
    # ours (ops/motion.py:40-47) through its own noise_scales and wrap_angle
    sd_c, sd_t = jmotion.noise_scales(jo, cfg)
    d = jo.d_center + sd_c * jnp.asarray(normals[:, 0])
    th = jo.d_theta + sd_t * jnp.asarray(normals[:, 1])
    theta = jgeo.wrap_angle(jnp.asarray(poses[:, 2]) + th)
    want = np.stack([poses[:, 0] + np.asarray(jnp.cos(theta) * d),
                     poses[:, 1] + np.asarray(jnp.sin(theta) * d),
                     np.asarray(theta)], -1)
    got = tmotion.sample_motion(_t(poses), to, cfg, _t(normals)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

    tsd_c, tsd_t = tmotion.noise_scales(to, cfg)
    assert abs(float(tsd_c) - float(sd_c)) < 1e-9
    assert abs(float(tsd_t) - float(sd_t)) < 1e-9
    np.testing.assert_allclose(
        tmotion.apply_odometry(_t(poses), to).numpy(),
        np.asarray(jmotion.apply_odometry(jnp.asarray(poses), jo)), atol=ATOL)


def test_sample_motion_matches_jax_key_draws():
    """With the normals JAX itself draws from a key (split, then one normal
    per component, ops/motion.py:41-43), the port lands on JAX's pose."""
    cfg = MotionConfig()
    pose = np.asarray([0.3, -0.2, 2.9], np.float32)
    jo = JOdom(d_center=jnp.float32(0.1), d_theta=jnp.float32(0.3))
    to = Odom(d_center=torch.tensor(0.1), d_theta=torch.tensor(0.3))
    key = jax.random.key(5)
    kc, kt = jax.random.split(key)
    normals = np.asarray([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])
    want = np.asarray(jmotion.sample_motion(key, jnp.asarray(pose), jo, cfg))
    got = tmotion.sample_motion(_t(pose), to, cfg, _t(normals)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,width,n_bins", [(80, 96, 2048), (45, 64, 512),
                                            (1, 8, 256), (0, 8, 128)])
def test_build_beam_lut_exact(n, width, n_bins):
    if n:
        js, ts = _scans(n=n, width=width, seed=n)
    else:   # no valid beam at all
        js = JScan.from_arrays([], [], [], max_beams=width)
        ts = Scan.from_arrays([], [], [], max_beams=width)
    want = np.asarray(jray.build_beam_lut(js, n_bins))
    got = tray.build_beam_lut(ts, n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if n:   # padded beams are never selected
        assert got.max() < n


@pytest.mark.parametrize("cone_fill", [False, True])
def test_integrate_scan_single_matches(cone_fill):
    """Single-particle map update (direct table gather) vs the JAX one:
    atol 1e-5 on all but at most 0.5 % of cells (bearing-bin jitter between
    atan2 implementations, tests/test_pallas.py:124-126)."""
    from gridmap_slam_tpu.config import SlamConfig
    s = SlamConfig().sensor
    js, ts = _scans(seed=4)
    lo = np.random.default_rng(4).normal(size=(64, 80)).astype(np.float32)
    pose = np.asarray([0.1, -0.05, 0.3], np.float32)
    kw = dict(resolution=0.05, origin=(-2.0, -1.6), l_free=s.l_free,
              l_occ=s.l_occ, cone_fill=cone_fill)
    want = np.asarray(jray.integrate_scan(
        jnp.asarray(lo), jnp.asarray(pose), js, jray.build_beam_lut(js, 2048),
        **kw))
    got = tray.integrate_scan(_t(lo), _t(pose), ts,
                              tray.build_beam_lut(ts, 2048), **kw).numpy()
    assert (want != 0).mean() > 0.05
    assert (np.abs(got - want) > 1e-5).mean() <= 5e-3


def test_likelihood_field_matches():
    rng = np.random.default_rng(6)
    lo = np.zeros((48, 64), np.float32)
    lo[rng.integers(0, 48, 60), rng.integers(0, 64, 60)] = 2.2
    lo[rng.integers(0, 48, 300), rng.integers(0, 64, 300)] = -0.9
    k = gaussian_kernel(1.0, 3)
    jf, ju = j_likelihood_field(jnp.asarray(lo), k)
    tf, tu = likelihood_field(_t(lo), k)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(inv_log_odds(_t(lo)).numpy(),
                               1 - 1 / (1 + np.exp(lo)), atol=1e-6)


# systematic resampling: the tie cases of tests/test_resample.py plus exact
# u == cum ties (power-of-two uniform weights)
_CASES = [(np.asarray([0.15, 0.1, 0.3, 0.05, 0.25, 0.15]), r)
          for r in (0.0, 0.01, 0.123 / 6, 0.9999 / 6)]
_CASES += [(np.full(n, 1.0 / n), r) for n in (4, 8) for r in (0.0, 0.5 / n)]
_CASES += [(np.asarray([0.4, 0.3, 0.2, 0.05, 0.05]), 0.1)]


@pytest.mark.parametrize("w,r", _CASES)
def test_systematic_indices_exact(w, r):
    lw = np.log(w).astype(np.float32)
    n = len(w)
    # JAX draws r from the key; rebuild its walk with our r through its own
    # normalized_weights / cumsum / searchsorted (ops/resample.py:112-126)
    cum = jnp.cumsum(jres.normalized_weights(jnp.asarray(lw)))
    u = jnp.float32(r) + jnp.arange(n, dtype=jnp.float32) / n
    want = np.clip(np.asarray(jnp.searchsorted(cum, u)), 0, n - 1)
    got = tres.systematic_indices(_t(lw), torch.tensor(r, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_systematic_indices_matches_jax_key_draw():
    lw = np.log(np.asarray([0.4, 0.3, 0.2, 0.05, 0.05])).astype(np.float32)
    for seed in range(5):
        key = jax.random.key(seed)
        r = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / 5)
        want = np.asarray(jres.systematic_indices(key, jnp.asarray(lw)))
        got = tres.systematic_indices(_t(lw), torch.tensor(float(r)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 1000, 1025, 4096, 100003])
def test_blocked_cumsum_matches_cumsum(n):
    """The card's fixed-order scan (rows of ~sqrt(n), then the row totals)
    is the running sum: in float64 within 1e-12 of the total's magnitude,
    and in float32 of weights summing to 1 within 1e-6 of JAX's cumsum."""
    rng = np.random.default_rng(n)
    x = rng.uniform(size=n)
    got = tres.blocked_cumsum(torch.from_numpy(x))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x), rtol=0,
                               atol=1e-12 * n)
    w = (x / x.sum()).astype(np.float32)
    np.testing.assert_allclose(tres.blocked_cumsum(_t(w)).numpy(),
                               np.asarray(jnp.cumsum(jnp.asarray(w))),
                               rtol=0, atol=1e-6)
    # on the CPU the resampler keeps torch.cumsum itself
    assert torch.equal(tres.cumsum_fixed_order(_t(w)), torch.cumsum(_t(w), 0))


def test_neff_and_weighted_mean_pose_match():
    rng = np.random.default_rng(7)
    lw = rng.normal(-50, 3, 64).astype(np.float32)
    poses = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    assert abs(float(tres.neff(_t(lw)))
               - float(jres.neff(jnp.asarray(lw)))) < 1e-4
    np.testing.assert_allclose(
        tres.normalized_weights(_t(lw)).numpy(),
        np.asarray(jres.normalized_weights(jnp.asarray(lw))), atol=ATOL)
    np.testing.assert_allclose(
        tres.weighted_mean_pose(_t(poses), _t(lw)).numpy(),
        np.asarray(jres.weighted_mean_pose(jnp.asarray(poses),
                                           jnp.asarray(lw))), atol=ATOL)
