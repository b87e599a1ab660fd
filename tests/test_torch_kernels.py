"""The plain PyTorch versions of the port's three CUDA kernels, held to JAX.

On the CPU each kernel module runs its plain version; these tests feed it
and the JAX function it replaces the same numpy inputs (and, where stated,
the Pallas kernel in interpret mode).  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.  Tolerances are
the repo's own: tests/test_pallas.py for the LL field and the map update,
tests/test_pallas_matcher.py for the matcher.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.ops import matcher as jm
from gridmap_slam_tpu.ops.grid import likelihood_field as j_likelihood_field
from gridmap_slam_tpu.ops.pallas.likelihood import log_likelihood_field_pallas
from gridmap_slam_tpu.ops.pallas.matcher import (pad_llfield_batch,
                                                 stage_scores_pallas_batch)
from gridmap_slam_tpu.ops.raycast import build_beam_lut as j_build_beam_lut
from gridmap_slam_tpu.ops.raycast import integrate_scan as j_integrate_scan
from gridmap_slam_tpu.types import Odom as JOdom
from gridmap_slam_tpu.types import Scan as JScan
import gridmap_slam_tpu_torch
from gridmap_slam_tpu_torch import RBPF, SlamConfig
from gridmap_slam_tpu_torch.ops import matcher as tm
from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel
from gridmap_slam_tpu_torch.types import Odom, Scan

torch.set_num_threads(1)

RES, MAXR, ZHIT = 0.05, 10.0, 0.9
LL_OUT = math.log(1.0 / MAXR)
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
K1_TOL = dict(rtol=2e-5, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K3
def _maps(p, h, w, seed):
    rng = np.random.default_rng(seed)
    lo = np.zeros((p, h, w), np.float32)
    for i in range(p):
        lo[i, rng.integers(0, h, 40), rng.integers(0, w, 40)] = 2.2
        lo[i, rng.integers(0, h, 200), rng.integers(0, w, 200)] = -0.9
    lo[-1, 10:20, 30:50] = -3.0
    lo[-1, 15, 40] = 5.0
    return lo


def _k3_plain(lo):
    taps = torch.as_tensor(gaussian_kernel(1.0, 3))
    return likelihood.log_likelihood_field_batch(
        _t(lo), taps, z_hit=ZHIT, max_range=MAXR).numpy()


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 120, 120)])
def test_k3_plain_matches_xla(shape):
    lo = _maps(*shape, seed=shape[1])
    k = gaussian_kernel(1.0, 3)

    def xla_ll(x):
        f, u = j_likelihood_field(x, k)
        return jm.log_likelihood_field(f, u, ZHIT, MAXR)

    want = np.asarray(jax.vmap(xla_ll)(jnp.asarray(lo)))
    np.testing.assert_allclose(_k3_plain(lo), want, atol=1e-5)


def test_k3_plain_matches_pallas_interpret():
    lo = _maps(2, 64, 128, seed=0)
    k = gaussian_kernel(1.0, 3)
    want = np.asarray(log_likelihood_field_pallas(
        jnp.asarray(lo), kernel_tuple=tuple(float(x) for x in k), z_hit=ZHIT,
        max_range=MAXR, interpret=True))
    np.testing.assert_allclose(_k3_plain(lo), want, atol=1e-5)


def test_k3_blank_map_is_uniform():
    got = _k3_plain(np.zeros((1, 64, 128), np.float32))
    np.testing.assert_allclose(got, math.log(0.1), atol=1e-5)


# ------------------------------------------------------------------ K2
def _scans(n=80, width=96, seed=0):
    rng = np.random.RandomState(seed)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dist = 0.6 + 0.8 * np.abs(np.sin(3 * ang)) + rng.uniform(0, 0.03, n)
    hit = rng.uniform(size=n) > 0.15
    return (JScan.from_arrays(ang, dist, hit, max_beams=width),
            Scan.from_arrays(ang, dist, hit, max_beams=width))


def _k2(lo, poses, keep, ts, origin):
    s = SlamConfig().sensor
    tables = grid_update.scan_bin_tables(ts, 2048)
    return grid_update.integrate_scan_batch(
        _t(lo), _t(poses), keep, *tables, resolution=RES, origin=origin,
        l_free=s.l_free, l_occ=s.l_occ).numpy()


@pytest.mark.parametrize("h,w,origin", [(64, 128, (-3.2, -1.6)),
                                        (120, 120, (-3.0, -3.0))])
def test_k2_plain_matches_xla(h, w, origin):
    """atol 1e-5 on all but at most 0.5 % of cells, which may differ by
    more (bearing-bin jitter between atan2 implementations,
    tests/test_pallas.py:124-126)."""
    s = JSlamConfig().sensor
    js, ts = _scans()
    lut = j_build_beam_lut(js, 2048)
    poses = np.asarray([[0.1, -0.05, 0.3], [-0.2, 0.15, -1.2],
                        [0.0, 0.0, 0.0]], np.float32)
    lo = (np.random.RandomState(1).normal(size=(3, h, w)) * 0.5).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda x, p: x + j_integrate_scan(
        x, p, js, lut, resolution=RES, origin=origin, l_free=s.l_free,
        l_occ=s.l_occ))(jnp.asarray(lo), jnp.asarray(poses)))
    got = _k2(lo, poses, 1.0, ts, origin)
    assert (want != lo).mean() > 0.05        # the scan really updated cells
    assert (np.abs(got - want) > K2_ATOL).mean() <= K2_MAX_FRAC


@pytest.mark.parametrize("cone_fill", [False, True])
def test_k2_grouped_tables_match_xla(cone_fill):
    """Three scans, two particles each, one bin table a scan (the layout of
    the closure verifier's local maps and the multi-robot deltas), held to
    the JAX integrate_scan of each particle's own scan, with and without
    cone fill; same tolerance as above."""
    s = JSlamConfig().sensor
    scans = [_scans(n=70 + 5 * k, seed=k) for k in range(3)]
    poses = np.asarray([[0.1, -0.05, 0.3], [-0.2, 0.15, -1.2],
                        [0.0, 0.0, 0.0], [0.3, 0.1, 2.0],
                        [-0.1, -0.3, -2.5], [0.05, 0.2, 1.0]], np.float32)
    lo = (np.random.RandomState(3).normal(size=(6, 64, 72)) * 0.5).astype(
        np.float32)
    origin = (-1.6, -1.8)
    want = np.stack([np.asarray(lo[p] + j_integrate_scan(
        jnp.asarray(lo[p]), jnp.asarray(poses[p]), scans[p // 2][0],
        j_build_beam_lut(scans[p // 2][0], 2048), resolution=RES,
        origin=origin, l_free=s.l_free, l_occ=s.l_occ, cone_fill=cone_fill))
        for p in range(6)])
    stacked = Scan(*(torch.stack([getattr(ts, f) for _, ts in scans])
                     for f in ("angle", "dist", "hit", "valid")))
    tables = grid_update.scan_bin_tables(stacked, 2048)
    assert tables[0].shape == (3, 2048)
    for k, (_, ts) in enumerate(scans):     # a batch row is that scan's
        for a, b in zip(tables, grid_update.scan_bin_tables(ts, 2048)):
            assert torch.equal(a[k], b)
    got = grid_update.integrate_scan_batch(
        _t(lo), _t(poses), 1.0, *tables, resolution=RES, origin=origin,
        l_free=s.l_free, l_occ=s.l_occ, cone_fill=cone_fill).numpy()
    assert (want != lo).mean() > (0.2 if cone_fill else 0.05)
    assert (np.abs(got - want) > K2_ATOL).mean() <= K2_MAX_FRAC


def test_k2_keep_zero_is_identity():
    _, ts = _scans()
    lo = np.random.RandomState(2).normal(size=(2, 64, 128)).astype(np.float32)
    got = _k2(lo, np.zeros((2, 3), np.float32), torch.tensor(0.0), ts,
              (-1.0, -1.0))
    np.testing.assert_array_equal(got, lo)


# ------------------------------------------------------------------ K1
def _problem(p=2, h=40, w=40, b=24, seed=0):
    """tests/test_pallas_matcher.py's problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    llf = rng.normal(-1.5, 0.5, (p, h, w)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, b)
    dist = rng.uniform(0.2, 1.2, b)
    px = (dist * np.cos(ang)).astype(np.float32)
    py = (dist * np.sin(ang)).astype(np.float32)
    use = rng.uniform(size=b) > 0.2
    poses = np.stack([rng.uniform(-0.8, 0.8, p), rng.uniform(-0.8, 0.8, p),
                      rng.uniform(-np.pi, np.pi, p)], -1).astype(np.float32)
    poses[0] = [0.95, -0.95, 1.0]     # out-of-map taps on particle 0
    return llf, px, py, use, poses


def _k1_plain(llf, px, py, use, poses, dxs, dys, dts, nearest, origin):
    p = poses.shape[0]
    rep = lambda a: _t(np.broadcast_to(a, (p, len(a))).copy())
    return kmatch.stage_scores_batch(
        _t(llf), _t(px), _t(py), _t(use), _t(poses), rep(dxs), rep(dys),
        rep(dts), resolution=RES, origin=origin, max_range=MAXR,
        nearest=nearest).numpy()


@pytest.mark.parametrize("nearest", [False, True])
def test_k1_plain_matches_gather(nearest):
    llf, px, py, use, poses = _problem()
    origin = (-1.0, -1.0)
    offs = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    offs_t = np.linspace(-0.1, 0.1, 3).astype(np.float32)
    want = np.asarray(jax.vmap(lambda f, p: jm._stage_scores(
        f, jnp.asarray(px), jnp.asarray(py), jnp.asarray(use), p,
        jnp.asarray(offs), jnp.asarray(offs), jnp.asarray(offs_t),
        resolution=RES, origin=origin, z_hit=ZHIT, max_range=MAXR,
        nearest=nearest))(jnp.asarray(llf), jnp.asarray(poses)))
    got = _k1_plain(llf, px, py, use, poses, offs, offs, offs_t, nearest,
                    origin)
    np.testing.assert_allclose(got, want, **K1_TOL)
    # the single-particle scorer is the same plain function
    one = tm._stage_scores(_t(llf[1]), _t(px), _t(py), _t(use), _t(poses[1]),
                           _t(offs), _t(offs), _t(offs_t), resolution=RES,
                           origin=origin, z_hit=ZHIT, max_range=MAXR,
                           nearest=nearest).numpy()
    np.testing.assert_allclose(one, want[1], **K1_TOL)


def test_k1_plain_matches_pallas_interpret():
    llf, px, py, use, poses = _problem()
    origin = (-1.0, -1.0)
    offs = tuple(np.linspace(-0.1, 0.1, 5))
    offs_t = tuple(np.linspace(-0.1, 0.1, 3))
    fpad, hp, wp = pad_llfield_batch(jnp.asarray(llf), LL_OUT)
    want = np.asarray(stage_scores_pallas_batch(
        fpad, jnp.asarray(px), jnp.asarray(py), jnp.asarray(use),
        jnp.asarray(poses), jnp.zeros((2, 3)), offs_x=offs, offs_y=offs,
        offs_t=offs_t, resolution=RES, origin=origin, pad=2, hp=hp, wp=wp,
        nearest=False, interpret=True))
    f32 = lambda a: np.asarray(a, np.float32)
    got = _k1_plain(llf, px, py, use, poses, f32(offs), f32(offs),
                    f32(offs_t), False, origin)
    np.testing.assert_allclose(got, want, **K1_TOL)


@pytest.mark.parametrize("g_f,g_b", [(1, 1), (1, 3), (6, 6), (2, 3)])
def test_k1_grouped_plain_matches_gather(g_f, g_b):
    """Six particles on G_f fields and G_b scans, particle p reading field
    p // (6 // G_f) and scan p // (6 // G_b): held to JAX's per-particle
    _stage_scores on that field and scan (K1 tolerance)."""
    rng = np.random.default_rng(g_f * 10 + g_b)
    llf = rng.normal(-1.5, 0.5, (g_f, 36, 44)).astype(np.float32)
    b = 24
    ang = rng.uniform(-np.pi, np.pi, (g_b, b))
    dist = rng.uniform(0.2, 1.2, (g_b, b))
    px = (dist * np.cos(ang)).astype(np.float32)
    py = (dist * np.sin(ang)).astype(np.float32)
    use = rng.uniform(size=(g_b, b)) > 0.2
    poses = np.stack([rng.uniform(-0.6, 0.6, 6), rng.uniform(-0.6, 0.6, 6),
                      rng.uniform(-np.pi, np.pi, 6)], -1).astype(np.float32)
    poses[0] = [0.95, -0.95, 1.0]     # out-of-map taps on particle 0
    dxs = rng.uniform(-0.1, 0.1, (6, 5)).astype(np.float32)
    dys = rng.uniform(-0.1, 0.1, (6, 4)).astype(np.float32)
    dts = rng.uniform(-0.1, 0.1, (6, 3)).astype(np.float32)
    origin = (-1.0, -0.9)
    want = np.stack([np.asarray(jm._stage_scores(
        jnp.asarray(llf[p // (6 // g_f)]), jnp.asarray(px[p // (6 // g_b)]),
        jnp.asarray(py[p // (6 // g_b)]), jnp.asarray(use[p // (6 // g_b)]),
        jnp.asarray(poses[p]), jnp.asarray(dxs[p]), jnp.asarray(dys[p]),
        jnp.asarray(dts[p]), resolution=RES, origin=origin, z_hit=ZHIT,
        max_range=MAXR)) for p in range(6)])
    got = kmatch.stage_scores_batch(
        _t(llf), _t(px), _t(py), _t(use), _t(poses), _t(dxs), _t(dys),
        _t(dts), resolution=RES, origin=origin, max_range=MAXR).numpy()
    np.testing.assert_allclose(got, want, **K1_TOL)
    if g_b == 1:        # a (B,) scan is the one-group case, bit for bit
        flat = kmatch.stage_scores_batch(
            _t(llf), _t(px[0]), _t(py[0]), _t(use[0]), _t(poses), _t(dxs),
            _t(dys), _t(dts), resolution=RES, origin=origin,
            max_range=MAXR).numpy()
        np.testing.assert_array_equal(flat, got)


@pytest.mark.parametrize("shape,variant", [
    # P, G_f, H, W, B, nt, ny, nx
    ((500, 500, 60, 60, 48, 11, 9, 9), "shared"),      # parity coarse
    ((500, 500, 120, 120, 192, 5, 5, 5), "shared"),    # parity fine
    ((500_000, 1, 60, 60, 48, 11, 9, 9), "shared"),    # mega_blocked block
    ((500_000, 1, 120, 120, 192, 5, 5, 5), "shared"),
    ((20_000, 1, 40, 70, 24, 11, 9, 9), "shared"),     # multi, 140 x 80
    ((20_000, 1, 80, 140, 96, 5, 5, 5), "shared"),
    ((32, 32, 140, 140, 90, 13, 15, 15), "shared"),    # closures
    ((32, 32, 280, 280, 360, 5, 5, 5), "global"),
    ((200, 200, 280, 280, 360, 5, 5, 5), "global"),    # pose-graph filter
    ((500, 500, 120, 120, 192, 1, 1, 1), "global"),    # score_pose, RBPF
    ((4096, 1, 120, 120, 192, 1, 1, 1), "shared"),     # score_pose, shared
])
def test_k1_launch_plan_covers_every_candidate_once(shape, variant):
    """K1's launch plan at the shapes the paths give it: the variant, the
    shared memory within one H100 block's 232 448 bytes, and the kernel's
    walk (blocks over the tiles of each field group, threads over a tile's
    units, a unit a run of dx candidates of one pair and dy) covering every
    candidate exactly once."""
    p, g_f, h, w, b, nt, ny, nx = shape
    plan = kmatch.launch_plan(*shape)
    assert plan.variant == variant
    assert plan.smem_bytes <= kmatch.H100["smem_block"]
    if variant == "shared":
        assert plan.pitch >= w + 2 * kmatch.RING
        assert plan.smem_bytes >= (h + 2 * kmatch.RING) * plan.pitch * 4
    assert 32 <= plan.threads <= kmatch.MAX_THREADS
    assert plan.threads % 32 == 0
    assert 1 <= plan.run <= min(nx, kmatch.MAX_RUN)
    assert plan.groups == (g_f if variant == "shared" else 1)
    assert plan.groups * plan.pairs_per_group == p * nt
    assert 1 <= plan.splits <= plan.tiles_per_group
    # blocks: group b // splits, tiles [part T / splits, (part+1) T / splits)
    blocks = np.arange(plan.grid, dtype=np.int64)
    group, part = blocks // plan.splits, blocks % plan.splits
    t_len = plan.tiles_per_group
    t0 = part * t_len // plan.splits
    t1 = (part + 1) * t_len // plan.splits
    assert (t1 > t0).all()
    # tiles, in block order: pairs [g ppg + t k, min(.. + k, (g + 1) ppg))
    counts = t1 - t0
    tile_group = np.repeat(group, counts)
    tile = np.repeat(t0, counts) + np.arange(counts.sum()) - np.repeat(
        np.cumsum(counts) - counts, counts)
    k, ppg = plan.pairs_per_tile, plan.pairs_per_group
    q0 = tile_group * ppg + tile * k
    q1 = np.minimum(q0 + k, (tile_group + 1) * ppg)
    assert q0[0] == 0 and q1[-1] == p * nt
    np.testing.assert_array_equal(q0[1:], q1[:-1])     # no gap, no overlap
    assert ((q1 - q0 >= 1) & (q1 - q0 <= k)).all()
    # threads j, j + threads, ... over the n x ny x runs units of a tile;
    # unit u of pair s covers dy u // runs and the dx from (u % runs) run
    runs = -(-nx // plan.run)
    for n in {int(q1[0] - q0[0]), int(q1[-1] - q0[-1])}:
        j = np.concatenate([np.arange(t, n * ny * runs, plan.threads)
                            for t in range(plan.threads)])
        pair, unit = j // (ny * runs), j % (ny * runs)
        ix = (unit % runs)[:, None] * plan.run + np.arange(plan.run)
        cand = (pair * ny * nx + (unit // runs) * nx)[:, None] + ix
        seen = cand[ix < nx]
        np.testing.assert_array_equal(np.sort(seen), np.arange(n * ny * nx))


def test_k1_all_invalid_scan_scores_zero():
    llf, px, py, _, poses = _problem(b=16, seed=5)
    offs = np.linspace(-0.1, 0.1, 3).astype(np.float32)
    got = _k1_plain(llf, px, py, np.zeros(16, bool), poses, offs, offs, offs,
                    False, (-1.0, -1.0))
    np.testing.assert_array_equal(got, 0.0)


def test_score_pose_matches():
    """The matcher-disabled weight: measurement log-likelihood at the pose
    itself, through the K1 dispatch (plain on the CPU)."""
    llf, px, py, use, poses = _problem(p=3, b=20, seed=4)
    origin = (-1.0, -1.0)
    angle, dist = np.arctan2(py, px), np.hypot(px, py)
    jscan = JScan(angle=jnp.asarray(angle), dist=jnp.asarray(dist),
                  hit=jnp.asarray(use), valid=jnp.ones(20, bool))
    tscan = Scan(angle=_t(angle), dist=_t(dist), hit=_t(use),
                 valid=torch.ones(20, dtype=torch.bool))
    kw = dict(z_hit=ZHIT, resolution=RES, origin=origin, max_range=MAXR)
    want = np.asarray(jax.vmap(lambda f, p: jm.score_pose(
        f, jscan, p, **kw))(jnp.asarray(llf), jnp.asarray(poses)))
    got = tm.score_pose(_t(llf), tscan, _t(poses), **kw).numpy()
    np.testing.assert_allclose(got, want, **K1_TOL)


@pytest.mark.parametrize("halfres", [False, True])
def test_correlative_match_batch_matches_vmapped(halfres):
    llf, px, py, use, poses = _problem(p=3, b=20, seed=3)
    origin = (-1.0, -1.0)
    angle = np.arctan2(py, px)
    dist = np.sqrt(px ** 2 + py ** 2)
    valid = np.ones(20, bool)
    jscan = JScan(angle=jnp.asarray(angle), dist=jnp.asarray(dist),
                  hit=jnp.asarray(use), valid=jnp.asarray(valid))
    tscan = Scan(angle=_t(angle), dist=_t(dist), hit=_t(use), valid=_t(valid))
    cfg = dataclasses.replace(
        JSlamConfig().matcher, impl="gather", coarse_nxy=5, coarse_nt=3,
        fine_nxy=3, fine_nt=3, extra_refine_stages=1, window_xy=0.1,
        window_theta_deg=6.0, coarse_beam_stride=2, coarse_halfres=halfres)
    mcfg = JSlamConfig().motion
    prior = poses + np.asarray([0.01, -0.02, 0.03], np.float32)
    kw = dict(matcher_cfg=cfg, motion_cfg=mcfg, resolution=RES, origin=origin,
              max_range=MAXR)
    best_j, score_j = jax.vmap(lambda f, p0, pc: jm.correlative_match(
        f, jscan, p0, JOdom(d_center=jnp.float32(0.05),
                            d_theta=jnp.float32(0.02)),
        prior_center=pc, **kw))(jnp.asarray(llf), jnp.asarray(poses),
                                jnp.asarray(prior))
    best_t, score_t = tm.correlative_match_batch(
        _t(llf), tscan, _t(poses), Odom(d_center=torch.tensor(0.05),
                                        d_theta=torch.tensor(0.02)),
        prior_center_b=_t(prior), **kw)
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), **K1_TOL)


def test_single_particle_match_and_score_match_jax():
    """correlative_match and score_pose on one pose and one (H, W) field,
    the thin wrappers of the batched search, against the JAX functions."""
    llf, px, py, use, poses = _problem(p=1, b=20, seed=6)
    origin = (-1.0, -1.0)
    angle, dist = np.arctan2(py, px), np.hypot(px, py)
    jscan = JScan(angle=jnp.asarray(angle), dist=jnp.asarray(dist),
                  hit=jnp.asarray(use), valid=jnp.ones(20, bool))
    tscan = Scan(angle=_t(angle), dist=_t(dist), hit=_t(use),
                 valid=torch.ones(20, dtype=torch.bool))
    cfg = dataclasses.replace(JSlamConfig().matcher, impl="gather")
    kw = dict(matcher_cfg=cfg, motion_cfg=JSlamConfig().motion,
              resolution=RES, origin=origin, max_range=MAXR)
    prior = poses[0] + np.asarray([0.02, 0.01, -0.02], np.float32)
    best_j, s_j = jm.correlative_match(
        jnp.asarray(llf[0]), jscan, jnp.asarray(poses[0]),
        JOdom(d_center=jnp.float32(0.1), d_theta=jnp.float32(-0.05)),
        prior_center=jnp.asarray(prior), **kw)
    best_t, s_t = tm.correlative_match(
        _t(llf[0]), tscan, _t(poses[0]),
        Odom(d_center=torch.tensor(0.1), d_theta=torch.tensor(-0.05)),
        prior_center=_t(prior), **kw)
    assert best_t.shape == (3,) and s_t.shape == ()
    np.testing.assert_allclose(best_t.numpy(), np.asarray(best_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(s_t), float(s_j), **K1_TOL)
    skw = dict(z_hit=ZHIT, resolution=RES, origin=origin, max_range=MAXR)
    one = tm.score_pose(_t(llf[0]), tscan, _t(poses[0]), **skw)
    assert one.shape == ()
    np.testing.assert_allclose(float(one), float(jm.score_pose(
        jnp.asarray(llf[0]), jscan, jnp.asarray(poses[0]), **skw)), **K1_TOL)


def test_stage_offsets_are_cached_on_the_device():
    """Two searches with one matcher config reuse the same offset tensors
    (no numpy-to-device copy inside a step); another config builds its
    own."""
    mc = SlamConfig().matcher
    tm._OFFSETS.clear()
    first = tm._stage_offsets(mc, torch.device("cpu"))
    llf, px, py, use, poses = _problem(p=2, b=20, seed=2)
    scan = Scan(angle=_t(np.arctan2(py, px)), dist=_t(np.hypot(px, py)),
                hit=_t(use), valid=torch.ones(20, dtype=torch.bool))
    for _ in range(2):
        tm.correlative_match_batch(
            _t(llf), scan, _t(poses), Odom(torch.tensor(0.1),
                                           torch.tensor(0.0)),
            matcher_cfg=mc, motion_cfg=SlamConfig().motion, resolution=RES,
            origin=(-1.0, -1.0), max_range=MAXR)
    again = tm._stage_offsets(mc, torch.device("cpu"))
    assert again is first and len(tm._OFFSETS) == 1
    assert all(a is b for a, b in zip(again[0], first[0]))
    wide = dataclasses.replace(mc, coarse_nxy=15)
    assert tm._stage_offsets(wide, torch.device("cpu")) is not first
    np.testing.assert_allclose(first[0][0].numpy(), np.linspace(
        -mc.window_xy, mc.window_xy, mc.coarse_nxy), rtol=1e-6)
    assert len(first[1]) == 1 + mc.extra_refine_stages


# ------------------------------------------------------- dispatch rules
@pytest.mark.parametrize("impl", ["matmul", "splat", "pallas"])
def test_tpu_only_matcher_impls_raise(impl):
    cfg = SlamConfig(num_particles=2, max_beams=8).with_overrides(
        {"matcher.impl": impl})
    with pytest.raises(ValueError, match="not ported"):
        RBPF(cfg, device="cpu")
    llf, px, py, use, poses = _problem()
    scan = Scan(angle=_t(np.arctan2(py, px)), dist=_t(np.hypot(px, py)),
                hit=_t(use), valid=_t(np.ones(len(px), bool)))
    with pytest.raises(ValueError, match="not ported"):
        tm.correlative_match_batch(
            _t(llf), scan, _t(poses), Odom(torch.tensor(0.0),
                                           torch.tensor(0.0)),
            matcher_cfg=cfg.matcher, motion_cfg=cfg.motion, resolution=RES,
            origin=(-1.0, -1.0), max_range=MAXR)


@pytest.mark.parametrize("engine", ["RBPF", "SharedMapSLAM",
                                    "MultiRobotSLAM", "PoseGraphSLAM"])
def test_engines_default_to_the_card(engine):
    """An engine built with no device asks for the card: where there is one
    it runs there; where there is none PyTorch itself refuses, with no
    fallback to the CPU."""
    cfg = SlamConfig(num_particles=4, max_beams=8)
    extra = {"MultiRobotSLAM": dict(num_robots=2)}.get(engine, {})
    make = getattr(gridmap_slam_tpu_torch, engine)
    if torch.cuda.is_available():
        assert make(cfg, **extra).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|NVIDIA"):
            make(cfg, **extra)


def test_ptxas_usage_reads_each_kernel():
    """The build report chip_smoke.py prints: registers, static shared
    memory and spills of each kernel from nvcc's `-Xptxas -v` output."""
    from gridmap_slam_tpu_torch.ops.cuda import _build
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aILb1ELb0ELi3EEv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILb1ELb0ELi3EEv
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 1024 bytes smem, 400 bytes cmem[0]
"""
    assert _build.ptxas_usage(log) == {
        "_Z1aILb1ELb0ELi3EEv": dict(registers=48, smem_bytes=0,
                                    stack_bytes=32, spill_stores=0,
                                    spill_loads=0),
        "_Z1bv": dict(registers=255, smem_bytes=1024, stack_bytes=0,
                      spill_stores=8, spill_loads=12)}


def test_cuda_entry_points_refuse_cpu_tensors():
    """Asking for a kernel with CPU tensors raises before anything is built;
    the dispatching wrappers take the plain path for them and launch
    nothing."""
    llf, px, py, use, poses = _problem()
    p = poses.shape[0]
    z = torch.zeros((p, 3))
    taps = torch.as_tensor(gaussian_kernel(1.0, 3))
    _, ts = _scans()
    tables = grid_update.scan_bin_tables(ts, 2048)
    counts = (likelihood.launches, grid_update.launches, kmatch.launches)
    with pytest.raises(ValueError, match="must be on"):
        likelihood.log_likelihood_field_batch_cuda(
            _t(llf), taps, z_hit=ZHIT, max_range=MAXR)
    with pytest.raises(ValueError, match="must be on"):
        grid_update.integrate_scan_batch_cuda(
            _t(llf), _t(poses), 1.0, *tables, resolution=RES,
            origin=(-1.0, -1.0), l_free=-0.8, l_occ=2.2)
    with pytest.raises(ValueError, match="must be on"):
        kmatch.stage_scores_batch_cuda(
            _t(llf), _t(px), _t(py), _t(use), _t(poses), z, z, z,
            resolution=RES, origin=(-1.0, -1.0), max_range=MAXR)
    likelihood.log_likelihood_field_batch(_t(llf), taps, z_hit=ZHIT,
                                          max_range=MAXR)
    kmatch.stage_scores_batch(_t(llf), _t(px), _t(py), _t(use), _t(poses),
                              z, z, z, resolution=RES, origin=(-1.0, -1.0),
                              max_range=MAXR)
    assert (likelihood.launches, grid_update.launches,
            kmatch.launches) == counts
