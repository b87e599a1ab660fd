"""The arithmetic and the launch plans of the port's K2 and K3 kernels, on
the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  What can be pinned without one is pinned
here: K2's rotated form (ops/cuda/grid_update.integrate_scan_batch_rotated,
the kernel's formulas in plain tensors) against the plain version and the
JAX integrate_scan; K3's launch planner (every output cell covered exactly
once, shared memory within an H100 block); and K3's window OR against the
blurred-evidence mask of the plain version and of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.ops.grid import likelihood_field as j_likelihood_field
from gridmap_slam_tpu.ops.raycast import build_beam_lut as j_build_beam_lut
from gridmap_slam_tpu.ops.raycast import integrate_scan as j_integrate_scan
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel, likelihood_field
from gridmap_slam_tpu_torch.ops.raycast import cell_bearings
from gridmap_slam_tpu_torch.types import Scan

torch.set_num_threads(1)

RES = 0.05
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3     # tests/test_pallas.py:124-126
K2_ROTATED_MAX_FRAC = 1e-3            # what the rotated form must stay under


def _t(a):
    return torch.from_numpy(np.array(a))


def _scans(n=80, width=96, seed=0):
    rng = np.random.RandomState(seed)
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dist = 0.6 + 0.8 * np.abs(np.sin(3 * ang)) + rng.uniform(0, 0.03, n)
    hit = rng.uniform(size=n) > 0.15
    return (JScan.from_arrays(ang, dist, hit, max_beams=width),
            Scan.from_arrays(ang, dist, hit, max_beams=width))


def _cell_center(origin, ix, iy):
    """The float32 center of cell (iy, ix), as the plain version and the
    kernel compute it."""
    i = torch.tensor([ix, iy], dtype=torch.float32)
    return (torch.tensor(origin, dtype=torch.float32) + (i + 0.5) * RES).numpy()


def _frac(got, want):
    return float((np.abs(got - want) > K2_ATOL).mean())


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("keep", [1.0, 0.0])
@pytest.mark.parametrize("h,w,origin", [(64, 128, (-3.2, -1.6)),
                                        (120, 120, (-3.0, -3.0))])
def test_k2_rotated_matches_plain_and_xla(h, w, origin, keep):
    """One table for every particle; the last pose sits on a cell center
    (r = 0 there).  atol 1e-5 on all but 0.5 % of cells against the JAX
    integrate_scan (its own tolerance), and on all but 0.1 % against the
    plain version; the measured fractions are printed."""
    s = JSlamConfig().sensor
    js, ts = _scans()
    lut = j_build_beam_lut(js, 2048)
    cx, cy = _cell_center(origin, w // 2 + 3, h // 2 - 5)
    poses = np.asarray([[0.1, -0.05, 0.3], [-0.2, 0.15, -1.2],
                        [0.0, 0.0, 0.0], [cx, cy, 0.3]], np.float32)
    lo = (np.random.RandomState(1).normal(size=(4, h, w)) * 0.5).astype(
        np.float32)
    kw = dict(resolution=RES, origin=origin, l_free=s.l_free, l_occ=s.l_occ)
    tables = grid_update.scan_bin_tables(ts, 2048)
    got = grid_update.integrate_scan_batch_rotated(
        _t(lo), _t(poses), keep, *tables, **kw).numpy()
    plain = grid_update.integrate_scan_batch_plain(
        _t(lo), _t(poses), keep, *tables, **kw).numpy()
    want = np.asarray(jax.vmap(lambda x, p: x + keep * j_integrate_scan(
        x, p, js, lut, **kw))(jnp.asarray(lo), jnp.asarray(poses)))
    f_plain, f_xla = _frac(got, plain), _frac(got, want)
    print(f"K2 rotated ({h}, {w}) keep {keep}: {f_plain} of cells beyond "
          f"atol against the plain version, {f_xla} against XLA")
    assert f_plain <= K2_ROTATED_MAX_FRAC
    assert f_xla <= K2_MAX_FRAC
    if keep:
        assert (want != lo).mean() > 0.05    # the scan really updated cells
        # the cell under the last pose: range 0, the plain version's update
        r, _ = cell_bearings((h, w), _t(poses[3:]), resolution=RES,
                             origin=origin)
        at = (r[0] == 0.0).nonzero()
        assert at.shape[0] == 1
        iy, ix = (int(v) for v in at[0])
        assert plain[3, iy, ix] != lo[3, iy, ix]
        assert got[3, iy, ix] == plain[3, iy, ix]
    else:
        np.testing.assert_array_equal(got, lo)


@pytest.mark.parametrize("cone_fill", [False, True])
def test_k2_rotated_grouped_tables(cone_fill):
    """Three scans, two particles each, one bin table a scan, with and
    without cone fill: against the plain version and against the JAX
    integrate_scan of each particle's own scan."""
    s = JSlamConfig().sensor
    scans = [_scans(n=70 + 5 * k, seed=k) for k in range(3)]
    origin = (-1.6, -1.8)
    cx, cy = _cell_center(origin, 30, 40)
    poses = np.asarray([[0.1, -0.05, 0.3], [-0.2, 0.15, -1.2],
                        [0.0, 0.0, 0.0], [0.3, 0.1, 2.0],
                        [-0.1, -0.3, -2.5], [cx, cy, 1.0]], np.float32)
    lo = (np.random.RandomState(3).normal(size=(6, 64, 72)) * 0.5).astype(
        np.float32)
    kw = dict(resolution=RES, origin=origin, l_free=s.l_free, l_occ=s.l_occ,
              cone_fill=cone_fill)
    want = np.stack([np.asarray(lo[p] + j_integrate_scan(
        jnp.asarray(lo[p]), jnp.asarray(poses[p]), scans[p // 2][0],
        j_build_beam_lut(scans[p // 2][0], 2048), **kw)) for p in range(6)])
    stacked = Scan(*(torch.stack([getattr(ts, f) for _, ts in scans])
                     for f in ("angle", "dist", "hit", "valid")))
    tables = grid_update.scan_bin_tables(stacked, 2048)
    got = grid_update.integrate_scan_batch_rotated(
        _t(lo), _t(poses), 1.0, *tables, **kw).numpy()
    plain = grid_update.integrate_scan_batch_plain(
        _t(lo), _t(poses), 1.0, *tables, **kw).numpy()
    f_plain, f_xla = _frac(got, plain), _frac(got, want)
    print(f"K2 rotated grouped, cone_fill {cone_fill}: {f_plain} beyond "
          f"atol against the plain version, {f_xla} against XLA")
    assert (want != lo).mean() > (0.2 if cone_fill else 0.05)
    assert f_plain <= K2_ROTATED_MAX_FRAC
    assert f_xla <= K2_MAX_FRAC


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("radius,shape,variant", [
    (3, (500, 120, 120), "small"),        # parity, chip
    (3, (200, 280, 280), "small"),        # pose-graph filter
    (3, (1, 518, 518), "small"),          # city's crop plus radius
    (3, (32, 280, 280), "small"),         # closure candidates
    (3, (1, 80, 140), "small"),           # multi
    (1, (2, 33, 45), "small"),
    (4, (7, 300, 1000), "small"),
    (0, (3, 50, 70), "generic"),
    (12, (500, 120, 120), "generic"),     # surface relocalization
    (30, (500, 120, 120), "generic"),
    (60, (500, 120, 120), "generic"),
    (180, (500, 120, 120), "generic"),
    (236, (500, 120, 120), "generic"),
    (236, (1, 4000, 4000), "generic"),    # the staged window still fits
    (12, (1, 518, 518), "generic"),
    (5, (3, 37, 1030), "generic"),
])
def test_k3_launch_plan_covers_every_cell_once(radius, shape, variant):
    """K3's plan at the shapes the paths give it, with an H100's limits:
    the variant, the kernel's constraints, shared memory within one block's
    232 448 bytes, and every output cell written by exactly one block."""
    p, h, w = shape
    plan = likelihood.launch_plan(radius, p, h, w, **kmatch.H100)
    assert plan is not None and plan.variant == variant
    assert plan.radius == radius
    assert plan.smem_bytes <= kmatch.H100["smem_block"]
    assert plan.tile_w % 32 == 0 and plan.tile_h >= 1
    assert plan.bands == -(-h // plan.tile_h)
    assert plan.tiles == -(-w // plan.tile_w)
    if variant == "small":
        assert plan.threads == plan.tile_w <= likelihood.SMALL_THREADS
        assert plan.tile_h <= likelihood.SMALL_ROWS
        assert plan.smem_bytes == likelihood._small_smem(
            radius, plan.tile_h, plan.tile_w)
        assert plan.smem_bytes <= 48 * 1024       # no opt-in needed
    else:
        assert plan.threads in likelihood.GENERIC_THREADS
        assert plan.tile_w % likelihood.BX == 0
        assert plan.smem_bytes == likelihood._generic_smem(
            radius, h, w, plan.tile_h, plan.tile_w)
    count = likelihood.covered_cells(plan, h, w)
    assert count.shape == (h, w) and bool((count == 1).all())


def test_k3_launch_plan_picks_bands_that_fit_the_map():
    """A 120-cell row is one tile and its 120 rows four bands of 30 (no
    lost rows or columns); a radius past the map takes the whole map a
    block; a small card's limits give a smaller tile or no plan."""
    plan = likelihood.launch_plan(3, 500, 120, 120, **kmatch.H100)
    assert (plan.tile_h, plan.tile_w, plan.bands, plan.tiles) == (30, 128,
                                                                  4, 1)
    plan = likelihood.launch_plan(3, 200, 280, 280, **kmatch.H100)
    assert (plan.tile_w, plan.tiles) == (96, 3)
    plan = likelihood.launch_plan(180, 500, 120, 120, **kmatch.H100)
    assert (plan.tile_h, plan.bands, plan.tiles) == (120, 1, 1)
    small_card = dict(sm_count=20, smem_block=48 * 1024, smem_sm=64 * 1024)
    plan = likelihood.launch_plan(30, 500, 120, 120, **small_card)
    assert plan is not None and plan.smem_bytes <= 48 * 1024
    assert likelihood.launch_plan(236, 1, 4000, 4000, **small_card) is None


@pytest.mark.parametrize("radius", [237, 300, -1])
def test_k3_launch_plan_refuses_radius(radius):
    assert likelihood.launch_plan(radius, 500, 120, 120,
                                  **kmatch.H100) is None


def _maps(p, h, w, seed):
    """tests/test_torch_kernels.py's maps, with an unexplored band on
    every other map, one blank map and one with a single explored cell."""
    rng = np.random.default_rng(seed)
    lo = np.zeros((p, h, w), np.float32)
    for i in range(p):
        lo[i, rng.integers(0, h, 40), rng.integers(0, w, 40)] = 2.2
        lo[i, rng.integers(0, h, 200), rng.integers(0, w, 200)] = -0.9
    lo[::2, :, :w // 2] = 0.0
    lo[1] = 0.0
    lo[-1] = 0.0
    lo[-1, h // 3, w - 1] = -0.4
    return lo


@pytest.mark.parametrize("radius", [3, 12, 60, 180])
def test_k3_window_or_equals_blurred_evidence_mask(radius):
    """The kernels' window OR against the unknown mask of
    ops/grid.likelihood_field and of the JAX package, cell for cell, at
    the radii chip_smoke.py checks (sigma = radius / 3)."""
    taps = gaussian_kernel(radius / 3.0, radius)
    assert likelihood.window_or_is_exact(torch.as_tensor(taps))
    h, w = (40, 56) if radius <= 12 else (120, 120)
    lo = _maps(4, h, w, seed=radius)
    got = likelihood.unknown_by_window(_t(lo), radius).numpy()
    _, plain = likelihood_field(_t(lo), taps.tolist())
    _, xla = jax.vmap(lambda x: j_likelihood_field(x, taps))(jnp.asarray(lo))
    assert got.any() and not got.all()      # both kinds of cell occur
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, np.asarray(xla))


def test_k3_window_or_is_not_taken_for_underflowing_taps():
    """sigma 1 at radius 12: the outer taps' squares underflow, the blurred
    evidence of a far corner cell is 0 and the window OR would call it
    known; the kernels' tap test sends such taps to the exact sum."""
    taps = gaussian_kernel(1.0, 12)
    assert not likelihood.window_or_is_exact(torch.as_tensor(taps))
    assert not likelihood.window_or_is_exact(torch.tensor([0.5, 0.0, 0.5]))
    assert not likelihood.window_or_is_exact(torch.tensor([0.6, -0.1, 0.5]))
    lo = np.zeros((1, 40, 40), np.float32)
    lo[0, 5, 5] = 1.0
    _, plain = likelihood_field(_t(lo), taps.tolist())
    window = likelihood.unknown_by_window(_t(lo), 12)
    assert bool(plain[0, 17, 17]) and not bool(window[0, 17, 17])
