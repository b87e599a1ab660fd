"""K1's nearest-cell branch at rounding ties, against JAX.

A nearest tap rounds its fractional cell-center coordinate to a cell, so a
coordinate within an ulp of a half cell goes to either neighbour depending
on the float order that computed it; with cell-aligned offsets (the coarse
stage's) one such tap moves a whole block of candidates.  The port computes
the coordinate in one order, the one XLA compiles
gridmap_slam_tpu/ops/matcher.py::_stage_scores into when it is jitted
(ops/cuda/matcher.cell_coords; csrc/matcher.cu's nearest instantiations do
the same on the card):

    rx = fma(px, c, -(py s)),  ry = fma(px, s, py c)
    fx = fma(((rx + (pose.x + dx)) - origin.x), f32(1) / f32(res), -0.5)

and rounds half to even.  Run op by op (no jit), JAX divides by the
resolution and rotates with unfused products instead; every JAX engine is
jitted, so the compiled order is the reference.

- The tie grid puts endpoints a few ulps from cell edges at 120, 400 and
  4 000 cells from the origin, at heading 0 (cos 1 and sin 0 exactly, in
  JAX and in torch) and at headings where torch's and XLA's cos and sin
  give the same bits.  The plain version's scores equal JAX's with no score
  beyond K1's tolerance, and the orders the port used before (the CPU's
  true division, the card's multiply by an unfused reciprocal, the
  kernel's 1/res folded into endpoint and candidate) pick other cells on
  at least TEETH taps of it.
- On random inputs at random headings the plain version's cells equal
  JAX's on every tap but those whose heading's cos or sin differs by an ulp
  between torch and XLA.
- `fma32`, the exact float32 FMA the order needs on either device, against
  exact references where the products nearly cancel and where a float64
  sum would round twice.
"""

from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.ops import matcher as jm
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch

torch.set_num_threads(1)

RES, MAXR, ZHIT = 0.05, 10.0, 0.9
K1_TOL = dict(rtol=2e-5, atol=2e-4)        # tests/test_pallas_matcher.py
ORIGIN = (-1.3, -2.1)
P, B, N_OFF = 8, 128, 9
# taps of the tie grid (of P x N_OFF x B an axis, both axes counted) on
# which each of the earlier orders picks another cell, at least
TEETH = 100
f32 = np.float32


def _jax_scores(field, px, py, use, pose, dxs, dts, res=RES):
    """JAX's _stage_scores(..., nearest=True), jitted and vmapped over the
    particles (and their scan rows where px is (P, B))."""
    def one(f, px_, py_, p):
        return jm._stage_scores(f, px_, py_, jnp.asarray(use), p,
                                jnp.asarray(dxs), jnp.asarray(dxs),
                                jnp.asarray(dts), resolution=res,
                                origin=ORIGIN, z_hit=ZHIT, max_range=MAXR,
                                nearest=True)
    rows = 0 if px.ndim == 2 else None
    fn = jax.jit(jax.vmap(one, in_axes=(None, rows, rows, 0)))
    return np.asarray(fn(jnp.asarray(field[0]), jnp.asarray(px),
                         jnp.asarray(py), jnp.asarray(pose)))


def _headings(rng, n):
    """n headings at which torch's and XLA's cos and sin agree bit for
    bit."""
    theta = rng.uniform(-math.pi, math.pi, 8 * n).astype(f32)
    same = ((torch.cos(torch.from_numpy(theta)).numpy()
             == np.asarray(jax.jit(jnp.cos)(theta)))
            & (torch.sin(torch.from_numpy(theta)).numpy()
               == np.asarray(jax.jit(jnp.sin)(theta))))
    return theta[same][:n]


def _tie_grid(cells: int, rotated: bool, seed: int = 0):
    """A field of (cells + 24)^2 random cells, P poses on the cell grid and
    a scan whose endpoints, rotated by each pose's heading and moved by it,
    land a few ulps from cell edges `cells` cells from the origin, under
    N_OFF cell-aligned offsets.  At heading 0 one scan serves every pose;
    rotated, each pose has a heading of _headings and a scan row (P, B)."""
    rng = np.random.default_rng(seed)
    side = cells + 24
    field = rng.uniform(-8.0, -0.5, (1, side, side)).astype(f32)
    offs = ((np.arange(N_OFF) - N_OFF // 2) * RES).astype(f32)
    pose = np.zeros((P, 3), f32)
    pose[:, :2] = rng.integers(-3, 4, (P, 2)) * RES
    if rotated:
        pose[:, 2] = _headings(rng, P)
    rows = P if rotated else 1
    edge = (np.asarray(ORIGIN)[None, :, None]
            + rng.integers(cells - 6, cells + 6, (rows, 2, B)) * RES
            - pose[:rows, :2, None].astype(np.float64))     # world - pose
    th = pose[:rows, 2, None].astype(np.float64)
    c, s = np.cos(th), np.sin(th)
    pts = np.stack([c * edge[:, 0] + s * edge[:, 1],
                    -s * edge[:, 0] + c * edge[:, 1]], 1).astype(f32)
    steps = rng.integers(-3, 4, pts.shape)                  # a few ulps off
    toward = np.copysign(np.inf, steps).astype(f32)
    for k in range(1, 4):
        pts = np.where(np.abs(steps) >= k, np.nextafter(pts, toward), pts)
    px, py = pts[:, 0], pts[:, 1]
    if not rotated:
        px, py = px[0], py[0]
    use = rng.uniform(size=B) > 0.1
    return field, px, py, use, pose, offs, np.zeros(1, f32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _earlier_cells(px, py, pose, offs, origin_axis, axis):
    """Each earlier order's rounded coordinates on one axis (P, 1, N_OFF,
    B): written out in float32 steps, an FMA (the kernel's contracted
    products) as kmatch.fma32."""
    th = _t(pose[:, 2:3])                                    # (P, 1)
    c, s = torch.cos(th)[:, :, None], torch.sin(th)[:, :, None]
    pxr, pyr = (_t(a if a.ndim == 2 else a[None])[:, None] for a in (px, py))
    rot = pxr * c - pyr * s if axis == 0 else pxr * s + pyr * c
    h = (_t(pose[:, axis, None]) + _t(offs))[:, None, :, None]
    wx = rot[:, :, None, :] + h                              # (P, 1, n, B)
    o = torch.tensor(origin_axis, dtype=torch.float32)
    inv = torch.tensor(1.0) / torch.tensor(RES, dtype=torch.float32)
    division = (wx - o) / torch.tensor(RES, dtype=torch.float32) - 0.5
    reciprocal = (wx - o) * inv - 0.5
    fma_rot = (kmatch.fma32(pxr, c, -(pyr * s)) if axis == 0
               else kmatch.fma32(pxr, s, pyr * c))
    folded = (fma_rot * inv)[:, :, None, :] + kmatch.fma32(h - o, inv, -0.5)
    return {"CPU true division": torch.round(division),
            "card's unfused reciprocal": torch.round(reciprocal),
            "kernel's folded form": torch.round(folded)}


@pytest.mark.parametrize("rotated", [False, True], ids=["heading0",
                                                         "rotated"])
@pytest.mark.parametrize("cells", [120, 400, 4000])
def test_tie_grid_nearest_scores_match_jax_with_none_beyond(cells, rotated):
    field, px, py, use, pose, offs, dts = _tie_grid(cells, rotated)
    want = _jax_scores(field, px, py, use, pose, offs, dts)
    got = kmatch.stage_scores_batch_plain(
        _t(field), _t(px), _t(py), _t(np.broadcast_to(use, px.shape)),
        _t(pose), _t(np.broadcast_to(offs, (P, N_OFF))),
        _t(np.broadcast_to(offs, (P, N_OFF))), _t(np.broadcast_to(dts,
                                                                  (P, 1))),
        resolution=RES, origin=ORIGIN, max_range=MAXR, nearest=True).numpy()
    beyond = np.abs(got - want) > K1_TOL["atol"] + K1_TOL["rtol"] * np.abs(
        want)
    assert int(beyond.sum()) == 0
    # the grid has teeth: the earlier orders round other cells
    pxr, pyr = (_t(a if a.ndim == 2 else a[None]) for a in (px, py))
    fx, fy = kmatch.cell_coords(
        pxr[:, None] if rotated else pxr[0], pyr[:, None] if rotated
        else pyr[0], _t(pose), _t(np.broadcast_to(offs, (P, N_OFF))),
        _t(np.broadcast_to(offs, (P, N_OFF))), _t(np.broadcast_to(
            dts, (P, 1))), resolution=RES, origin=ORIGIN)
    cells_now = (torch.round(fx), torch.round(fy))
    # a few ulps of a world coordinate 4 000 cells out are ~1e-3 cell
    near = sum(int(((f - torch.floor(f) - 0.5).abs() < 4e-3).sum())
               for f in (fx, fy))
    assert near > 0.9 * (fx.numel() + fy.numel())
    flips = {}
    for axis in (0, 1):
        for name, cell in _earlier_cells(px, py, pose, offs, ORIGIN[axis],
                                         axis).items():
            flips[name] = flips.get(name, 0) + int(
                (cell != cells_now[axis]).sum())
    for name, n in flips.items():
        if name == "card's unfused reciprocal" and not rotated:
            # at heading 0 the rotation is exact and an unfused product
            # less a half rounds as the fused one but where the product
            # crosses a power of two: the card's order is tested rotated
            continue
        assert n >= TEETH, (name, flips)


def test_random_taps_take_jax_cells_but_where_cos_or_sin_differ():
    """Random endpoints, poses, headings and offsets, one beam a row (so a
    score is one tap), on a field whose cell holds its own index: JAX's
    cells read off its scores against the plain version's rounded
    coordinates, every tap."""
    rng = np.random.default_rng(1)
    n, nt, k, side = 1500, 5, 5, 400
    origin = (-10.0, -10.0)
    field = np.arange(side * side, dtype=f32).reshape(1, side, side)
    pose = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                     rng.uniform(-math.pi, math.pi, n)], 1).astype(f32)
    px, py = (rng.uniform(-3, 3, (n, 1)).astype(f32) for _ in range(2))
    dxs, dys = (rng.uniform(-0.2, 0.2, (n, k)).astype(f32) for _ in range(2))
    dts = rng.uniform(-0.1, 0.1, (n, nt)).astype(f32)
    use = np.ones(1, bool)

    def one(f, px_, py_, p, dx, dy, dt):
        return jm._stage_scores(f, px_, py_, jnp.asarray(use), p, dx, dy, dt,
                                resolution=RES, origin=origin, z_hit=ZHIT,
                                max_range=MAXR, nearest=True)
    want = np.asarray(jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 6))(
        jnp.asarray(field[0]), *(jnp.asarray(a) for a in (px, py, pose, dxs,
                                                          dys, dts))))
    assert want.min() >= 0                    # every tap on the map
    idx = want.astype(np.int64)               # (n, nt, ny, nx)
    jax_x, jax_y = idx[:, :, 0, :] % side, idx[:, :, :, 0] // side
    fx, fy = kmatch.cell_coords(_t(px)[:, None], _t(py)[:, None], _t(pose),
                                _t(dxs), _t(dys), _t(dts), resolution=RES,
                                origin=origin)
    ours_x = torch.round(fx)[..., 0].numpy()  # (n, nt, nx)
    ours_y = torch.round(fy)[..., 0].numpy()
    theta = (pose[:, 2:3] + dts).astype(f32)
    trig = ((torch.cos(_t(theta)).numpy() != np.asarray(jax.jit(jnp.cos)(
        theta))) | (torch.sin(_t(theta)).numpy() != np.asarray(
            jax.jit(jnp.sin)(theta))))        # (n, nt)
    differ = (ours_x != jax_x).any(-1) | (ours_y != jax_y).any(-1)
    n_trig, n_differ = int(trig.sum()), int(differ.sum())
    assert 0 < n_trig < 0.2 * trig.size, n_trig
    # every heading whose taps took another cell has a cos or sin an ulp
    # apart; on random inputs such a tap is rare, so most of those
    # headings still agree
    assert not (differ & ~trig).any(), (n_differ, n_trig)
    assert n_differ <= n_trig


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c of float32 values, exactly, rounded once to float32 (the
    tie to even), from fractions."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = f32(float(x))
    # float(x) rounds once to float64; step to the float32 neighbours
    lo = lo if Fraction(float(lo)) <= x else np.nextafter(lo, f32(-np.inf))
    hi = np.nextafter(lo, f32(np.inf))
    dlo, dhi = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma32_is_exact_where_products_nearly_cancel_and_sums_round_twice():
    rng = np.random.default_rng(2)
    a = rng.uniform(-4, 4, 4000).astype(f32)
    b = rng.uniform(-4, 4, 4000).astype(f32)
    # c the product rounded to float32, nudged: the exact result is the
    # product's rounding error plus the nudge, which float64 holds exactly
    c = (-(a * b)).astype(f32)
    c = np.where(rng.uniform(size=c.shape) < 0.5, c,
                 np.nextafter(c, f32(np.inf)))
    want = (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(f32)
    got = kmatch.fma32(_t(a), _t(b), _t(c)).numpy()
    assert np.array_equal(got, want)
    assert (want != 0).mean() > 0.9 and (np.abs(want) < 1e-5).all()
    # a product exactly on a float32 midpoint and a tiny c: a float64 sum
    # rounds to the midpoint, then to the even neighbour, the wrong one
    cases = [(1 + 2 ** -12, 1 + 2 ** -12, 2 ** -80),
             (1 + 2 ** -12, 1 + 2 ** -11 + 2 ** -12, -2 ** -80),
             (-(1 + 2 ** -12), 1 + 2 ** -12, -2 ** -80)]
    a, b, c = (np.array(v, f32) for v in zip(*cases))
    want = np.array([_fma_exact(*abc) for abc in zip(a, b, c)], f32)
    twice = (a.astype(np.float64) * b.astype(np.float64)
             + c.astype(np.float64)).astype(f32)
    assert (twice != want).all()
    assert np.array_equal(kmatch.fma32(_t(a), _t(b), _t(c)).numpy(), want)
    # random triples against the exact rounding, c a Python float too
    a, b, c = (rng.uniform(-3, 3, 300).astype(f32) for _ in range(3))
    want = np.array([_fma_exact(*abc) for abc in zip(a, b, c)], f32)
    assert np.array_equal(kmatch.fma32(_t(a), _t(b), _t(c)).numpy(), want)
    want = np.array([_fma_exact(x, y, f32(-0.5)) for x, y in zip(a, b)], f32)
    assert np.array_equal(kmatch.fma32(_t(a), _t(b), -0.5).numpy(), want)
