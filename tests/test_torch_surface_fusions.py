"""F4-F6's plain versions (ops/cuda/fusions.py) held to the JAX package,
and the index rule F4 uses on the card held to the packed path.

F4 samples the surface volume and climbs on it reading the (nt, hc, wc)
volume in place; its plain version is the packed branch of
ops/surface.sample_surface.  The rule that picks a tap's cell in place is
written out here in tensor ops and must read the very values
pack_neighborhoods and the packed gather read, so the sample keeps its bits.
The plain sample and hill-climb are held to JAX's sample_surface and
refine_on_surface (gridmap_slam_tpu/ops/surface.py:231-318), the plain scan
preparation (F6) to JAX's deskew_scan and scan_bin_tables, and the plain
splat factors (F5) through their batched matmul to JAX's
splat_endpoint_kernels.  Inputs come from numpy with a fixed seed.  The
kernels themselves are held bit for bit against these plain versions on
the card by chip_smoke.py.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.ops import geometry as jgeo
from gridmap_slam_tpu.ops import surface as jsf
from gridmap_slam_tpu.ops.pallas.grid_update import \
    scan_bin_tables as j_scan_bin_tables
from gridmap_slam_tpu.types import Odom as JOdom
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu_torch.ops import surface as tsf
from gridmap_slam_tpu_torch.ops.cuda import _build, fusions
from gridmap_slam_tpu_torch.ops.cuda.grid_update import scan_bin_tables
from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
from gridmap_slam_tpu_torch.types import Odom, Scan

torch.set_num_threads(1)

SAMPLE_RTOL, SAMPLE_ATOL = 1e-6, 1e-5   # tests/test_surface.py:248-249
SPLAT_ATOL = 1e-6                        # tests/test_torch_surface.py:115
DESKEW_ATOL = 1e-5                       # tests/test_torch_ops.py
RES, ORIGIN = 0.05, (-1.0, -1.0)
NT, HC, WC = 7, 60, 60                   # a 60 x 60 crop of the field


def _t(a):
    return torch.from_numpy(np.array(a))


def _kw(wrap, theta0=0.2, nt=NT):
    return dict(theta0=theta0,
                dtheta=2.0 * math.pi / nt if wrap else 0.09,
                crop_iy0=4, crop_ix0=3, resolution=RES, origin=ORIGIN,
                wrap_theta=wrap)


def _torch_kw(wrap, nt=NT):
    """_kw with theta0 and the crop corner as the engines pass them:
    0-dim float32 and int64 tensors."""
    kw = _kw(wrap, nt=nt)
    kw.update(theta0=torch.tensor(kw["theta0"], dtype=torch.float32),
              crop_iy0=torch.tensor(kw["crop_iy0"]),
              crop_ix0=torch.tensor(kw["crop_ix0"]))
    return kw


def _volume(seed=0, nt=NT):
    rng = np.random.default_rng(seed)
    return rng.normal(-20.0, 4.0, (nt, HC, WC)).astype(np.float32)


def _cell_x(ix):
    """The world x of a crop cell's centre (fx = ix exactly there)."""
    return ORIGIN[0] + (ix + 3 + 0.5) * RES


def _cell_y(iy):
    return ORIGIN[1] + (iy + 4 + 0.5) * RES


def _rim_poses(wrap, nt=NT, seed=1):
    """Poses on every rim of the crop and past it, inside it at random,
    and with headings whose bin floor is -1 and nt (past the span), at
    the span's ends and around the circle."""
    rng = np.random.default_rng(seed)
    kw = _kw(wrap, nt=nt)
    t0, dt = kw["theta0"], kw["dtheta"]
    xs = [_cell_x(v) for v in (-3.0, -1.0, -0.5, -0.01, 0.0, 0.3, WC - 1.5,
                               WC - 1.0, WC - 0.99, WC - 0.5, WC + 2.0)]
    ys = [_cell_y(v) for v in (-2.0, -1.0, -0.2, 0.0, 0.7, HC - 1.0,
                               HC - 0.6, HC, HC + 3.0)]
    ths = [t0 - 1.5 * dt, t0 - 0.5 * dt, t0 - 1e-4, t0, t0 + 0.5 * dt,
           t0 + (nt - 1) * dt, t0 + (nt - 0.5) * dt, t0 + nt * dt,
           t0 + (nt + 0.5) * dt, t0 + 3.0, t0 - 3.0, t0 + 2 * math.pi - 1e-3]
    grid = np.array([(x, y, th) for x in xs for y in ys for th in ths],
                    np.float32)
    inside = np.stack([rng.uniform(_cell_x(-2), _cell_x(WC + 1), 400),
                       rng.uniform(_cell_y(-2), _cell_y(HC + 1), 400),
                       rng.uniform(-math.pi, math.pi, 400)], -1)
    return np.concatenate([grid, inside.astype(np.float32)])


def _coords(poses, kw, nt):
    """sample_surface's base cells and fractions, in its tensor ops."""
    x, y, th = poses[..., 0], poses[..., 1], poses[..., 2]
    fx = (x - kw["origin"][0]) / kw["resolution"] - 0.5 - kw["crop_ix0"]
    fy = (y - kw["origin"][1]) / kw["resolution"] - 0.5 - kw["crop_iy0"]
    if kw["wrap_theta"]:
        dt = torch.remainder(th - kw["theta0"], 2.0 * math.pi)
    else:
        dt = torch.remainder(th - kw["theta0"] + math.pi,
                             2.0 * math.pi) - math.pi
    ft = dt / kw["dtheta"]
    base = [torch.floor(v) for v in (ft, fy, fx)]
    fracs = [v - b for v, b in zip((ft, fy, fx), base)]
    return [b.to(torch.int64) for b in base], fracs


def _in_place_taps(vol, poses, kw):
    """The 8 taps F4 reads at each pose, (..., 8) in the packed array's
    order (dt, dy, dx): the base cell clamped to [-1, n - 1] (theta to
    [0, nt - 1] on a wrapping grid) + 1, then each tap's cell
    (t_b + dt - 1) wrapped modulo nt or clamped, (y_b + dy - 1) and
    (x_b + dx - 1) clamped to the crop."""
    nt, hc, wc = vol.shape
    (t0, y0, x0), _ = _coords(poses, kw, nt)
    wrap = kw["wrap_theta"]
    t_b = torch.clamp(t0, 0 if wrap else -1, nt - 1) + 1
    y_b = torch.clamp(y0, -1, hc - 1) + 1
    x_b = torch.clamp(x0, -1, wc - 1) + 1
    taps = []
    for dt in (0, 1):
        t = t_b + dt - 1
        t = torch.where(t == nt, 0, t) if wrap else torch.clamp(t, 0, nt - 1)
        for dy in (0, 1):
            y = torch.clamp(y_b + dy - 1, 0, hc - 1)
            for dx in (0, 1):
                x = torch.clamp(x_b + dx - 1, 0, wc - 1)
                taps.append(vol.reshape(-1)[(t * hc + y) * wc + x])
    return torch.stack(taps, -1), (t0, t_b, y_b, x_b)


# ------------------------------------------------------------ F4: the taps
@pytest.mark.parametrize("wrap", [False, True])
def test_in_place_taps_read_the_packed_values(wrap):
    """The in-place rule reads, at every pose, the 8 values the packed
    gather reads: on every rim of the crop, off it, and at t0 = -1 and nt
    (the latter only off a wrapping grid: there ft < nt by construction)."""
    vol = _t(_volume())
    poses = _t(_rim_poses(wrap))
    kw = _kw(wrap)
    taps, (t0, t_b, y_b, x_b) = _in_place_taps(vol, poses, kw)
    packed = tsf.pack_neighborhoods(vol, wrap)
    want = packed[(t_b * (HC + 1) + y_b) * (WC + 1) + x_b]
    assert torch.equal(taps, want)
    # the cases were reached: on a wrapping grid the bin floor lies in
    # [0, nt) by construction, elsewhere at -1 and nt too
    if wrap:
        assert int(t0.min()) == 0 and int(t0.max()) == NT - 1
    else:
        assert int(t0.min()) <= -1 and int(t0.max()) >= NT
    assert int(y_b.min()) == 0 and int(y_b.max()) == HC
    assert int(x_b.min()) == 0 and int(x_b.max()) == WC


@pytest.mark.parametrize("wrap", [False, True])
def test_in_place_sample_equals_packed_sample_bit_for_bit(wrap):
    """The trilinear sample from the in-place taps, weighted and summed as
    the packed branch does, equals the packed branch (sample_surface on
    pack_neighborhoods) in every bit; so do F4's plain version and the
    dispatcher on the CPU, with float arguments and with the engines'
    tensor arguments."""
    vol = _t(_volume(seed=2))
    poses = _t(_rim_poses(wrap, seed=3))
    kw = _kw(wrap)
    taps, _ = _in_place_taps(vol, poses, kw)
    _, (tt, ty, tx) = _coords(poses, kw, NT)
    w8 = torch.stack([(1 - tt) * (1 - ty) * (1 - tx), (1 - tt) * (1 - ty) * tx,
                      (1 - tt) * ty * (1 - tx), (1 - tt) * ty * tx,
                      tt * (1 - ty) * (1 - tx), tt * (1 - ty) * tx,
                      tt * ty * (1 - tx), tt * ty * tx], -1)
    want = tsf.sample_surface(vol, poses,
                              packed=tsf.pack_neighborhoods(vol, wrap), **kw)
    assert torch.equal(torch.sum(taps * w8, -1), want)
    assert torch.equal(fusions.score_plain(vol, poses, **kw)[1], want)
    assert torch.equal(fusions.score_on_volume(vol, poses, **kw)[1], want)
    assert torch.equal(
        fusions.score_on_volume(vol, poses, **_torch_kw(wrap))[1], want)


# ----------------------------------------------- F4: the plain versions vs JAX
@pytest.mark.parametrize("wrap", [False, True])
def test_plain_sample_matches_jax(wrap):
    vol = _volume(seed=4)
    poses = _rim_poses(wrap, seed=5)
    kw = _kw(wrap)
    want = np.asarray(jsf.sample_surface(
        jnp.asarray(vol), jnp.asarray(poses),
        packed=jsf.pack_neighborhoods(jnp.asarray(vol), wrap), **kw))
    got = fusions.score_on_volume(_t(vol), _t(poses), **kw)[1].numpy()
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("wrap", [False, True])
def test_plain_climb_matches_jax(wrap, steps):
    """The sample and hill-climb's scores against JAX's sample_surface and
    refine_on_surface on the packed neighbourhoods at the sample's
    tolerance, the climb's loop run op by op
    (jitted, XLA fuses the climb's sample and moves it by up to ~4e-5 at
    these poses: tests/test_torch_surface.py); the poses where no two moves
    tie within it (clamped poses read the same cells from several moves,
    and either pick is right) at >= 99 % of the poses."""
    vol = _volume(seed=6)
    rng = np.random.default_rng(7)
    poses = np.stack([rng.uniform(_cell_x(-2), _cell_x(WC + 1), 300),
                      rng.uniform(_cell_y(-2), _cell_y(HC + 1), 300),
                      rng.uniform(-math.pi, math.pi, 300)],
                     -1).astype(np.float32)
    kw = _kw(wrap)
    jvol = jnp.asarray(vol)
    jpk = jsf.pack_neighborhoods(jvol, wrap)
    s0 = jsf.sample_surface(jvol, jnp.asarray(poses), packed=jpk, **kw)
    with jax.disable_jit():
        jp, jsc = jsf.refine_on_surface(jvol, jnp.asarray(poses), s0,
                                        steps=steps, packed=jpk, **kw)
    tp, tsc = fusions.score_on_volume(_t(vol), _t(poses), steps=steps, **kw)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                               rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    same = np.abs(tp.numpy() - np.asarray(jp)).max(1) <= 1e-6
    assert same.mean() >= 0.99, same.mean()
    if steps == 0:
        assert torch.equal(tp, _t(poses))
    else:
        assert (np.abs(tp.numpy() - poses).max(1) > 0).mean() > 0.3


def test_plain_climb_equals_refine_on_surface():
    """score_on_volume on the CPU is refine_on_surface on the packed
    neighbourhoods, bit for bit, steps 2, from the packed sample's
    scores."""
    vol = _t(_volume(seed=8))
    poses = _t(_rim_poses(False, seed=9))
    kw = _kw(False)
    packed = tsf.pack_neighborhoods(vol, False)
    s0 = tsf.sample_surface(vol, poses, packed=packed, **kw)
    got = fusions.score_on_volume(vol, poses, steps=2, **kw)
    want = tsf.refine_on_surface(vol, poses, s0, steps=2, packed=packed,
                                 **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------- F5: splat
@pytest.mark.parametrize("kc", [9, 22])
def test_plain_splat_factors_match_jax(kc):
    """The plain factors' batched matmul (ops/surface.endpoint_images)
    against JAX's splat_endpoint_kernels, beams past the kernel radius
    (clamped to the rim) among them; and it is splat_endpoint_kernels."""
    rng = np.random.default_rng(10)
    n = 64
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dist = rng.uniform(0.05, 1.4, n)
    px = (dist * np.cos(ang)).astype(np.float32)
    py = (dist * np.sin(ang)).astype(np.float32)
    wgt = (rng.uniform(size=n) > 0.2).astype(np.float32)
    thetas = np.array([-3.1, -0.3, 0.0, 0.45, 1.7, 3.1], np.float32)
    want = np.asarray(jsf.splat_endpoint_kernels(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(wgt),
        jnp.asarray(thetas), kc, RES))
    a_yw, a_x = fusions.endpoint_factors(_t(px), _t(py), _t(wgt), _t(thetas),
                                         kc, RES)
    assert a_yw.shape == a_x.shape == (6, n, 2 * kc + 1)
    got = tsf.endpoint_images(a_yw, a_x)
    np.testing.assert_allclose(got.numpy(), want, atol=SPLAT_ATOL)
    assert torch.equal(got, tsf.splat_endpoint_kernels(
        _t(px), _t(py), _t(wgt), _t(thetas), kc, RES))
    # two taps a row, weights summing to the beam's weight
    np.testing.assert_allclose(a_yw.sum(-1).numpy(),
                               np.broadcast_to(wgt, (6, n)), atol=1e-6)
    assert int((a_x != 0).sum(-1).max()) <= 2


# --------------------------------------------------------------- F6: scan
def _planted(width, n, seed):
    """A scan of n beams padded to `width` for both packages, with planted
    equal bearings (and ranges), beams at +-pi in float32, +0.0 and -0.0."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    dist = rng.uniform(0.3, 9.0, n).astype(np.float32)
    if n >= 16:
        for i, j in ((3, 7), (8, 7), (11, 2)):
            ang[i], dist[i] = ang[j], dist[j]
        ang[12:16] = [np.float32(math.pi), -np.float32(math.pi), 0.0, -0.0]
    hit = rng.uniform(size=n) > 0.2
    return (JScan.from_arrays(ang, dist, hit, max_beams=width),
            Scan.from_arrays(ang, dist, hit, max_beams=width))


def _as_torch(js):
    return Scan(angle=_t(js.angle), dist=_t(js.dist), hit=_t(js.hit),
                valid=_t(js.valid))


@pytest.mark.parametrize("n,width", [(90, 96), (180, 192), (0, 96),
                                     (1, 8)])
@pytest.mark.parametrize("d_theta", [0.0, 0.4])
def test_plain_scan_prep_matches_jax(n, width, d_theta):
    """prepare_scan on the CPU against JAX's deskew_scan (within the ops
    tests' tolerance) and scan_bin_tables of that deskewed scan (exact),
    with padding beams, an all-invalid scan and planted beams."""
    if n:
        js, ts = _planted(width, n, seed=n)
    else:
        js = JScan.from_arrays([], [], [], max_beams=width)
        ts = Scan.from_arrays([], [], [], max_beams=width)
    jo = JOdom(d_center=jnp.float32(0.12), d_theta=jnp.float32(d_theta))
    to = Odom(d_center=torch.tensor(0.12), d_theta=torch.tensor(d_theta))
    want = jgeo.deskew_scan(js, jo)
    prep = fusions.prepare_scan(ts, to, 2048)
    got, tables = prep.scan, prep.tables
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               atol=DESKEW_ATOL)
    dang = np.angle(np.exp(1j * (got.angle.numpy().astype(np.float64)
                                 - np.asarray(want.angle))))
    np.testing.assert_allclose(dang, 0.0, atol=DESKEW_ATOL)
    # the tables of each package's deskewed scan agree exactly
    j_tables = j_scan_bin_tables(want, 2048)
    t_of_j = fusions.bin_tables(_as_torch(want), 2048)
    for a, b in zip(t_of_j, j_tables):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the joint entry is the two plain functions
    d = deskew_scan(ts, to)
    assert torch.equal(got.angle, d.angle) and torch.equal(got.dist, d.dist)
    for a, b in zip(tables, scan_bin_tables(d, 2048)):
        assert torch.equal(a, b)
    assert got.hit is ts.hit and got.valid is ts.valid


def test_plain_tables_of_planted_scans_match_jax():
    """bin_tables (no deskew) on scans with planted equal bearings, +-pi
    and +-0.0 against JAX's scan_bin_tables, exactly."""
    for width, n in ((96, 90), (192, 180), (360, 300)):
        js, ts = _planted(width, n, seed=width)
        for a, b in zip(fusions.bin_tables(ts, 2048),
                        j_scan_bin_tables(js, 2048)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plain_scan_prep_of_a_batch_is_each_scan():
    """prepare_scan of a batch (G, B) with one odometry a scan is, row by
    row, the JAX deskew and tables of each scan (tables exact), an
    all-invalid scan among them; deskew alone is its first part."""
    pairs = [_planted(192, n, seed=n) for n in (180, 97, 0)]
    pairs[2] = (JScan.from_arrays([], [], [], max_beams=192),
                Scan.from_arrays([], [], [], max_beams=192))
    odom = [(0.12, 0.4), (-0.05, -0.7), (0.0, 0.0)]
    batch = Scan(*(torch.stack([getattr(t, f) for _, t in pairs])
                   for f in ("angle", "dist", "hit", "valid")))
    to = Odom(d_center=torch.tensor([c for c, _ in odom]),
              d_theta=torch.tensor([t for _, t in odom]))
    prep = fusions.prepare_scan(batch, to, 512)
    got, tables = prep.scan, prep.tables
    assert tables[0].shape == (3, 512)
    for k, (js, _) in enumerate(pairs):
        want = jgeo.deskew_scan(js, JOdom(d_center=jnp.float32(odom[k][0]),
                                          d_theta=jnp.float32(odom[k][1])))
        np.testing.assert_allclose(got.dist[k].numpy(), np.asarray(want.dist),
                                   atol=DESKEW_ATOL)
        row = Scan(*(getattr(got, f)[k] for f in ("angle", "dist", "hit",
                                                  "valid")))
        for a, b in zip(scan_bin_tables(row, 512), (t[k] for t in tables)):
            assert torch.equal(a, b)
        for a, b in zip(fusions.bin_tables(_as_torch(want), 512),
                        j_scan_bin_tables(want, 512)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    alone = fusions.deskew(batch, to)
    assert torch.equal(alone.angle, got.angle)
    assert torch.equal(alone.dist, got.dist)


# ---------------------------------------------------- dispatch and bindings
def _no_kernel(*a, **kw):
    raise AssertionError("a CPU tensor reached a kernel")


def test_cpu_tensors_go_to_the_plain_versions(monkeypatch):
    """Every F4-F6 entry point runs its plain version for CPU tensors (the
    kernels are swapped for a function that fails) and gives its bits."""
    for name in ("score_cuda", "splat_cuda", "scan_cuda"):
        monkeypatch.setattr(fusions, name, _no_kernel)
    vol, poses = _t(_volume(seed=11)), _t(_rim_poses(True, seed=12))
    kw = _kw(True)
    for steps in (0, 2):
        p, sc = fusions.score_on_volume(vol, poses, steps=steps, **kw)
        want = fusions.score_plain(vol, poses, steps=steps, **kw)
        assert torch.equal(p, want[0]) and torch.equal(sc, want[1])
    px, py = torch.rand(10), torch.rand(10)
    f = fusions.endpoint_factors(px, py, torch.ones(10), torch.zeros(3), 5,
                                 RES)
    assert all(torch.equal(a, b) for a, b in zip(
        f, fusions.splat_plain(px, py, torch.ones(10), torch.zeros(3), 5,
                               RES)))
    _, ts = _planted(96, 90, seed=13)
    to = Odom(d_center=torch.tensor(0.1), d_theta=torch.tensor(0.2))
    prep = fusions.prepare_scan(ts, to, 256)
    scan, tables = prep.scan, prep.tables
    plain = fusions.scan_plain(ts.angle, ts.dist, ts.hit, ts.valid,
                               to.d_center, to.d_theta, n_bins=256)
    assert all(torch.equal(a, b) for a, b in zip(
        (scan.angle, scan.dist, *tables), plain))
    assert all(torch.equal(a, b) for a, b in zip(
        fusions.bin_tables(ts, 256), scan_bin_tables(ts, 256)))
    assert torch.equal(fusions.deskew(ts, to).angle, plain[0])


def test_kernel_entry_points_refuse_cpu_tensors():
    vol, poses = _t(_volume()), torch.zeros(4, 3)
    for steps in (0, 1):
        with pytest.raises(ValueError):
            fusions.score_cuda(vol, poses, steps=steps, **_kw(False))
    with pytest.raises(ValueError):
        fusions.splat_cuda(torch.zeros(4), torch.zeros(4), torch.zeros(4),
                           torch.zeros(2), 3, RES)
    _, ts = _planted(96, 90, seed=14)
    with pytest.raises(ValueError):
        fusions.scan_cuda(ts.angle, ts.dist, ts.hit, ts.valid, None, None,
                          n_bins=64)


def test_climb_of_no_steps_launches_nothing(monkeypatch):
    """steps <= 0 runs the sample alone and returns the poses as given (the
    kernel's launch likewise writes no poses)."""
    monkeypatch.setattr(fusions, "refine_on_surface", _no_kernel)
    vol, poses = _t(_volume(seed=15)), _t(_rim_poses(False, seed=16))
    for steps in (0, -1):
        p, s = fusions.score_on_volume(vol, poses, steps=steps, **_kw(False))
        assert p is poses
        assert torch.equal(s, fusions.score_plain(vol, poses, **_kw(False))[1])


def test_signatures_name_f4_to_f6():
    """_build.SIGNATURES binds each new C entry of csrc/fusions.cu with one
    ctypes type a C parameter."""
    src = (Path(_build.CSRC) / "fusions.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    for name in ("gs_fusion_sample", "gs_fusion_splat", "gs_fusion_scan"):
        assert len(_build.SIGNATURES[name]) == len(
            entries[name].split(",")), name



# ------------------------------------- F6's step outputs, F4's temperature
KEEP_DEG = 30.0                          # SlamConfig.skip_update_dtheta_deg


def _j_points(js, stride):
    """The JAX step's expressions of a (deskewed) scan: scan_points
    (gridmap_slam_tpu/ops/geometry.py:94), the used beams and their float32
    (ops/matcher.py:213-214, models/shared.py:166), every stride-th beam
    (ops/matcher.py:285-286) and the used beams' count as surface_temper
    sums it (models/shared.py:183)."""
    px, py = jgeo.scan_points(js)
    use = js.valid & js.hit
    wgt = use.astype(jnp.float32)
    n_used = jnp.maximum(jnp.sum(wgt, -1), 1.0)
    return (px, py, use, wgt, px[..., ::stride], py[..., ::stride],
            use[..., ::stride], n_used)


@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("n,width", [(90, 96), (180, 192), (0, 96)])
def test_plain_scan_points_match_jax(n, width, stride):
    """ScanPrep's endpoints against JAX's scan_points (the ops tests'
    tolerance), the used beams, their float32, every stride-th of them and
    their count exactly, an all-invalid scan among them (count 1)."""
    if n:
        js, ts = _planted(width, n, seed=n + stride)
    else:
        js = JScan.from_arrays([], [], [], max_beams=width)
        ts = Scan.from_arrays([], [], [], max_beams=width)
    prep = fusions.prepare_scan(ts, stride=stride)
    jpx, jpy, juse, jwgt, jpx_c, jpy_c, juse_c, jn = _j_points(js, stride)
    for got, want in ((prep.px, jpx), (prep.py, jpy), (prep.px_c, jpx_c),
                      (prep.py_c, jpy_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=DESKEW_ATOL)
    for got, want in ((prep.use, juse), (prep.wgt, jwgt),
                      (prep.use_c, juse_c), (prep.n_used, jn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(prep.px_c, prep.px[::stride])
    assert prep.keep is None and prep.tables == (None, None, None)
    assert prep.scan is ts and prep.stride == stride


@pytest.mark.parametrize("freeze", [False, True])
def test_plain_scan_gate_matches_jax(freeze):
    """The map update's gate keep of a batch of odometry rows, the bound
    itself and the float32 on either side of it among them, exactly as the
    JAX step computes it (models/rbpf.py:150-153); 0 everywhere under
    freeze_map."""
    bound = np.float32(math.radians(KEEP_DEG))
    d_theta = np.array([0.0, 0.4, -0.6, bound, -bound,
                        np.nextafter(bound, np.float32(1.0)),
                        np.nextafter(bound, np.float32(0.0)), np.nan],
                       np.float32)
    g = d_theta.size
    pairs = [_planted(96, 90, seed=40 + k) for k in range(g)]
    batch = Scan(*(torch.stack([getattr(t, f) for _, t in pairs])
                   for f in ("angle", "dist", "hit", "valid")))
    to = Odom(d_center=torch.full((g,), 0.1), d_theta=_t(d_theta))
    prep = fusions.prepare_scan(batch, to, 64, stride=4,
                                keep_below=math.radians(KEEP_DEG),
                                freeze=freeze)
    want = (jnp.abs(jnp.asarray(d_theta))
            <= math.radians(KEEP_DEG)).astype(jnp.float32)
    if freeze:
        want = want * 0.0
    np.testing.assert_array_equal(prep.keep.numpy(), np.asarray(want))
    one = fusions.prepare_scan(pairs[3][1], Odom(torch.tensor(0.1),
                                                 torch.tensor(bound)),
                               keep_below=math.radians(KEEP_DEG))
    assert one.keep.shape == () and float(one.keep) == 1.0
    # each row's endpoints are its deskewed scan's (NaN where its heading
    # is), bit for bit
    for k in range(g):
        row = Scan(*(getattr(prep.scan, f)[k] for f in ("angle", "dist",
                                                        "hit", "valid")))
        alone = fusions.prepare_scan(row, stride=4)
        for a, b in zip(prep[2:10], alone[2:10]):
            np.testing.assert_array_equal(a[k].numpy(), b.numpy())


@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("steps", [0, 2])
def test_plain_tempered_scores_match_jax(temp, steps):
    """F4's plain version with the temperature against JAX's
    surface_temper of JAX's sample and climb (rtol 1e-6,
    tests/test_torch_shared.py), the used beams counted by F6's plain
    version; and it is the untempered scores tempered."""
    from types import SimpleNamespace

    from gridmap_slam_tpu.models import shared as jshared
    js, ts = _planted(192, 150, seed=31)
    vol = _volume(seed=32)
    poses = _rim_poses(False, seed=33)
    n_used = fusions.prepare_scan(ts).n_used
    kw = _torch_kw(False)
    _, got = fusions.score_plain(_t(vol), _t(poses), steps=steps, temp=temp,
                                 n_used=n_used, **kw)
    jkw = _kw(False)
    jpacked = jsf.pack_neighborhoods(jnp.asarray(vol), False)
    want = jsf.sample_surface(jnp.asarray(vol), jnp.asarray(poses),
                              packed=jpacked, **jkw)
    if steps:                  # op by op, as test_plain_climb_matches_jax
        with jax.disable_jit():
            _, want = jsf.refine_on_surface(
                jnp.asarray(vol), jnp.asarray(poses), want, steps=steps,
                packed=jpacked, **jkw)
    want = jshared.surface_temper(SimpleNamespace(surface_weight_temp=temp),
                                  js, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    _, raw = fusions.score_plain(_t(vol), _t(poses), steps=steps, **kw)
    assert torch.equal(got, fusions.temper(raw, temp, n_used))


# ------------------------------------------------------- F7's windows
# (crop, map, blur radius) of the volume windows held to JAX: a crop whose
# extended window fits, one that does not (the whole map), the whole map
WINDOWS = {"fits": ((20, 20), (60, 60), 3), "wider": ((48, 30), (60, 80), 8),
           "whole": ((60, 60), (60, 60), 2)}


def _spec(case, nt=25, span=12.0):
    """The volume WindowSpec of a WINDOWS case, as
    models/shared.volume_window_spec builds one from a config."""
    crop, (h, w), r = WINDOWS[case]
    dtheta, _, t_off = tsf.theta_grid(nt, math.radians(span))
    fits = crop[0] + 2 * r <= h and crop[1] + 2 * r <= w
    return fusions.WindowSpec(
        crop=crop, full=(h, w), resolution=RES, origin=ORIGIN, volume=True,
        radius=r, ext=(crop[0] + 2 * r, crop[1] + 2 * r) if fits else (h, w),
        nt=nt, t_off=t_off, dtheta=dtheta)


@pytest.mark.parametrize("span", [12.0, 180.0])
@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_plain_volume_window_matches_jax(case, span):
    """F7's plain volume window (the weighted mean propagated by the
    odometry, then its crop) against JAX: the center within the motion
    tests' tolerance of JAX's apply_odometry, and of that center the crop's
    corner (crop_center_cells), the extended window's corner and the crop's
    offset in it (models/shared.py:145-150) and the bins (theta_grid,
    models/shared.py:157-162), exactly."""
    from gridmap_slam_tpu.ops import motion as jmotion
    spec = _spec(case, span=span)
    (hc, wc), (h, w), r = spec.crop, spec.full, spec.radius
    rng = np.random.default_rng(7)
    for k in range(30):
        mean = np.array([rng.uniform(-1.5, 3.5), rng.uniform(-1.5, 3.5),
                         rng.uniform(-3.5, 3.5)], np.float32)
        dc, dt = (np.float32(v) for v in rng.uniform(-0.4, 0.4, 2))
        win = fusions.window_plain(_t(mean), Odom(_t(dc), _t(dt)), spec)
        jc = jmotion.apply_odometry(jnp.asarray(mean),
                                    JOdom(jnp.float32(dc), jnp.float32(dt)))
        np.testing.assert_allclose(win.center.numpy(), np.asarray(jc),
                                   atol=1e-6)
        c = jnp.asarray(win.center.numpy())
        iy0, ix0 = jsf.crop_center_cells(c[:2], (hc, wc), (h, w), RES,
                                         ORIGIN)
        assert (int(win.iy0), int(win.ix0)) == (int(iy0), int(ix0))
        if hc + 2 * r <= h and wc + 2 * r <= w:
            ey0 = jnp.clip(iy0 - r, 0, h - spec.ext[0])
            ex0 = jnp.clip(ix0 - r, 0, w - spec.ext[1])
            assert (int(win.ey0), int(win.ex0), int(win.oy), int(win.ox)) \
                == (int(ey0), int(ex0), int(iy0 - ey0), int(ix0 - ex0))
        dtheta, _, t_off = jsf.theta_grid(spec.nt, math.radians(span))
        theta0 = c[2] + t_off
        thetas = theta0 + dtheta * jnp.arange(spec.nt, dtype=jnp.float32)
        np.testing.assert_array_equal(win.theta0.numpy(), np.asarray(theta0))
        np.testing.assert_array_equal(win.thetas.numpy(), np.asarray(thetas))


def test_plain_weights_place_the_windows():
    """F7's plain version with a volume WindowSpec returns window_plain of
    its weighted mean; with the map update's, the crop around its
    integration pose (crop_center_cells, stacked), exactly as the engines
    placed them before."""
    rng = np.random.default_rng(9)
    lw = _t(rng.normal(-3, 1, 300).astype(np.float32))
    poses = _t(rng.uniform(-1, 2, (300, 3)).astype(np.float32))
    odom = Odom(torch.tensor(0.1), torch.tensor(-0.2))
    spec = _spec("fits")
    tail = fusions.weights_plain(lw, poses, window=spec, odom=odom)
    want = fusions.window_plain(tail.weighted, odom, spec)
    assert all(torch.equal(a, b) for a, b in zip(tail.volume, want))
    crop = spec._replace(volume=False, crop=(30, 30))
    tail = fusions.weights_plain(lw, poses, resample_fraction=0.5,
                                 window=crop)
    want = torch.stack(tsf.crop_center_cells(
        tail.integ_pose[:2], (30, 30), spec.full, RES, ORIGIN))
    assert torch.equal(tail.crop, want) and tail.volume is None
