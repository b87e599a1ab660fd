"""K1's tile variant on tiles too large to stage, on the CPU: its launch
plan, and the box its kernel stages.

The kernel (csrc/matcher.cu, stage_scores_tile_kernel) runs only on the
card, where chip_smoke.py's `k1_tile` phase holds it against its plain
version and checks that both of its paths ran.  Here `_box_path` repeats
its box path in tensors: block k of `grid` takes a contiguous run of the
(particle, heading) pairs and stages the box from the smallest base cell
of its beams at each pair's smallest candidate offset to the largest at
its largest, and one cell on; the candidates' taps are read from the box.
Every tap the plain version reads must fall inside the box, the box path
must give the plain version's bits (the same cells, the same operations in
the same order), and summed over the tiles it must match the JAX
package's _stage_scores_tiled at the tolerance of
tests/test_torch_tiled.py.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gridmap_slam_tpu_torch.config import MatcherConfig, city_config
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
from tests.test_torch_tiled import (SCORE_ATOL, W, _jax_tiled_scores, _scan,
                                    _test_map)

torch.set_num_threads(1)

RES = 0.05
ORIGIN = (-1.2, -1.0)
MAX_RANGE = 10.0
MAP_H, MAP_W = 40, 48          # cells: 2.4 x 2.0 m
PARTICLES, BEAMS = 8, 24


def _box_path(field, px, py, use, pose0, dxs, dys, dts, *, resolution,
              origin, max_range, c0, w_loc, n_m, ext, nearest, grid):
    """The box path's arithmetic in tensors, on one field (see the module
    docstring).  Returns (scores (P, nt, ny, nx), the smallest tap offset
    in a box and the most any tap lies past a box's last column or row,
    and the blocks that staged a box)."""
    v_out = math.log(1.0 / max_range)
    if nearest:
        # staged endpoints in metres, candidates' pose plus offset, and the
        # sample's coordinate in JAX's compiled order (kmatch.cell_coords)
        rows = kmatch._scan_rows(px, py, use, pose0.shape[0])
        sx, sy = kmatch.rotated(rows[0], rows[1], pose0, dts)
        u = rows[2]
        cx, cy = pose0[:, 0, None] + dxs, pose0[:, 1, None] + dys
        inv_res = kmatch._inv_res(resolution)
        ox, oy = kmatch._f32(origin[0]), kmatch._f32(origin[1])

        def coord_x(s, c):
            return kmatch.cell_coord(s, c, ox, inv_res)

        def coord_y(s, c):
            return kmatch.cell_coord(s, c, oy, inv_res)
    else:
        sx, sy, cx, cy, u = kmatch._tile_coords(
            px, py, use, pose0, dxs, dys, dts, resolution=resolution,
            origin=origin, nearest=False)

        def coord_x(s, c):
            return s + c

        coord_y = coord_x
    p, nt, b = sx.shape
    used = (u if u.dim() == 5 else u.expand(p, 1, 1, 1, -1))[:, 0, 0, 0]
    # each beam's base cells at its pair's smallest and largest offsets
    lo_x = torch.round(coord_x(sx, cx.min(-1).values[:, None, None]))
    hi_x = torch.round(coord_x(sx, cx.max(-1).values[:, None, None]))
    lo_y = torch.round(coord_y(sy, cy.min(-1).values[:, None, None]))
    hi_y = torch.round(coord_y(sy, cy.max(-1).values[:, None, None]))
    fx = coord_x(sx[:, :, None, :], cx[:, None, :, None])        # (P,nt,nx,B)
    fy = coord_y(sy[:, :, None, :], cy[:, None, :, None])        # (P,nt,ny,B)
    x0f, y0f = torch.round(fx), torch.round(fy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    out = torch.zeros((p, nt, cy.shape[1], cx.shape[1]))
    reach = [0, -1 << 30, -1 << 30, 0]
    for k in range(grid):
        q = torch.arange(k * p * nt // grid, (k + 1) * p * nt // grid)
        pp, tt = q // nt, q % nt
        m = used[pp]                                             # (n, B)
        if not bool(m.any()):
            continue
        bx, by = int(lo_x[pp, tt][m].min()), int(lo_y[pp, tt][m].min())
        bw = int(hi_x[pp, tt][m].max()) - bx + 2
        bh = int(hi_y[pp, tt][m].max()) - by + 2
        box = kmatch._taps(field, (bx - (c0 - ext) + torch.arange(bw))[
            None, None], (by + torch.arange(bh))[None, :, None], v_out)[0]
        xx = (x0[pp, tt] - bx)[:, None]                          # (n,1,nx,B)
        yy = (y0[pp, tt] - by)[:, :, None]                       # (n,ny,1,B)
        on = m[:, None, None]
        # the used beams' taps (the kernel stages no other beam)
        ux, uy = xx.expand(-1, 1, -1, -1)[on.expand_as(xx)], \
            yy.expand(-1, -1, 1, -1)[on.expand_as(yy)]
        reach = [min(reach[0], int(ux.min()), int(uy.min())),
                 max(reach[1], int(ux.max()) + 1 - (bw - 1)),
                 max(reach[2], int(uy.max()) + 1 - (bh - 1)), reach[3] + 1]

        def tap(dx, dy):
            return box[(yy + dy).clamp(0, bh - 1), (xx + dx).clamp(0, bw - 1)]

        if nearest:
            ll = tap(0, 0)
        else:
            tx = (fx - x0f + 0.5)[pp, tt][:, None]
            ty = (fy - y0f + 0.5)[pp, tt][:, :, None]
            v00, v10, v01, v11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
            a = v00 + tx * (v10 - v00)
            ll = a + ty * (v01 + tx * (v11 - v01) - a)
        mine = kmatch._owned(x0[pp, tt], c0, w_loc, n_m)[:, None]
        out[pp, tt] = torch.where(on & mine, ll, 0.0).sum(-1)
    return out, reach


def _ext_tile(field, j, n):
    """Tile j of n of a (G, H, W) field with one column of each
    neighbour, log(1 / max_range) at the world's edges."""
    g, h, w = field.shape
    w_loc = w // n
    out = torch.full((g, h, w_loc + 2), math.log(1.0 / MAX_RANGE))
    out[..., 1:-1] = field[..., j * w_loc:(j + 1) * w_loc]
    if j > 0:
        out[..., 0] = field[..., j * w_loc - 1]
    if j < n - 1:
        out[..., -1] = field[..., (j + 1) * w_loc]
    return out


def _inputs(stage: str, n_m: int, seed: int = 0):
    """A seeded field, scan and particles near the tile borders of n_m
    tiles and the world's edges, and the stage's offsets as
    correlative_match_batch makes them: coarse (the whole window, every
    offset for every particle), fine (one coarse step around a coarse
    offset) or refine (half that)."""
    rng = np.random.default_rng(seed)
    field = torch.as_tensor(rng.normal(-2.0, 1.0, (1, MAP_H, MAP_W)),
                            dtype=torch.float32)
    w_loc = MAP_W // n_m
    borders = [ORIGIN[0] + RES * c for c in range(0, MAP_W + 1, w_loc)]
    xs = rng.choice(borders, PARTICLES) + rng.uniform(-0.15, 0.15, PARTICLES)
    ys = rng.choice([ORIGIN[1] + 0.05, ORIGIN[1] + MAP_H * RES - 0.05, 0.0],
                    PARTICLES) + rng.uniform(-0.1, 0.1, PARTICLES)
    pose0 = torch.as_tensor(np.stack(
        [xs, ys, rng.uniform(-math.pi, math.pi, PARTICLES)], 1),
        dtype=torch.float32)
    px = torch.as_tensor(rng.uniform(-0.7, 0.7, BEAMS), dtype=torch.float32)
    py = torch.as_tensor(rng.uniform(-0.7, 0.7, BEAMS), dtype=torch.float32)
    use = torch.as_tensor(rng.uniform(size=BEAMS) > 0.2)
    mc = MatcherConfig()
    wt = math.radians(mc.window_theta_deg)
    c_xy = np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy)

    def per(a):
        return torch.as_tensor(np.asarray(a, np.float32)).expand(
            PARTICLES, -1).contiguous()

    if stage == "coarse":
        return (field, px, py, use, pose0, per(c_xy), per(c_xy),
                per(np.linspace(-wt, wt, mc.coarse_nt)))
    k = 1.0 if stage == "fine" else 2.0 / (mc.fine_nxy - 1)
    step_xy = k * 2 * mc.window_xy / (mc.coarse_nxy - 1)
    step_t = k * 2 * wt / (mc.coarse_nt - 1)
    off_xy = torch.as_tensor(np.linspace(-step_xy, step_xy, mc.fine_nxy),
                             dtype=torch.float32)
    at = torch.as_tensor(rng.choice(c_xy, (PARTICLES, 2)),
                         dtype=torch.float32)
    return (field, px, py, use, pose0, at[:, :1] + off_xy,
            at[:, 1:] + off_xy,
            per(np.linspace(-step_t, step_t, mc.fine_nt)))


@pytest.mark.parametrize("stage,nearest", [
    ("coarse", False), ("coarse", True), ("fine", False), ("refine", False)])
@pytest.mark.parametrize("n_m,j", [(1, 0), (2, 1), (4, 2)])
def test_box_holds_every_tap_and_gives_the_plain_bits(n_m, j, stage,
                                                      nearest):
    """A block's box holds every tap the plain version reads for its pairs
    (one tile, an edge tile, an inner tile), and the box path gives the
    plain version's bits, for blocks of one to a few pairs."""
    field, px, py, use, pose0, dxs, dys, dts = _inputs(stage, n_m)
    w_loc = MAP_W // n_m
    kw = dict(resolution=RES, origin=ORIGIN, max_range=MAX_RANGE,
              c0=j * w_loc, w_loc=w_loc, n_m=n_m, ext=1, nearest=nearest)
    args = (_ext_tile(field, j, n_m), px, py, use, pose0, dxs, dys, dts)
    want = kmatch.stage_scores_tile_plain(*args, **kw)
    for grid in (1, 3, 7, pose0.shape[0] * dts.shape[1]):
        got, (lo, over_x, over_y, blocks) = _box_path(*args, grid=grid,
                                                      **kw)
        assert blocks == grid and lo >= 0 and over_x <= 0 and over_y <= 0
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_box_path_summed_matches_jax(n):
    """The box path on JAX's extended tiles, summed over the tiles,
    against JAX's _stage_scores_tiled psummed over (1, n)."""
    from gridmap_slam_tpu_torch.ops.geometry import scan_points
    from gridmap_slam_tpu_torch.types import Scan

    want, ll_ext_all = _jax_tiled_scores(_test_map(), n)
    angles, dists, nb = _scan()
    scan = Scan.from_arrays(angles, dists, np.ones(nb, bool), max_beams=64)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    pose0 = torch.tensor([[0.3, -0.2, 0.25]])
    dxs = torch.as_tensor(np.linspace(-0.2, 0.2, 9), dtype=torch.float32)[None]
    dts = torch.as_tensor(np.linspace(-0.26, 0.26, 11),
                          dtype=torch.float32)[None]
    w_loc, we = W // n, W // n + 2
    total = 0
    for j in range(n):
        ext = torch.from_numpy(ll_ext_all[:, j * we:(j + 1) * we].copy())
        total = total + _box_path(
            ext[None], px, py, use, pose0, dxs, dxs, dts, resolution=0.05,
            origin=(-3.2, -2.0), max_range=10.0, c0=j * w_loc, w_loc=w_loc,
            n_m=n, ext=1, nearest=False, grid=3)[0][0]
    np.testing.assert_allclose(total.numpy(), want, atol=SCORE_ATOL)


def test_tile_launch_plan_at_the_tiled_row():
    """The tiled row's three stages (city tile 4000 x 4002, 500 particles,
    coarse over every 4th of 192 beam slots) take the tile kernel for
    tiles too large to stage: every pair's units in one warp, a block an
    SM of STAGED_WARPS warps each a run of the pairs, and the box a block
    may stage holds 200 x 200 cells (the synthetic room's reach is some
    130 x 130)."""
    cfg = city_config()
    mc = cfg.matcher
    h, w = cfg.map.cells_y, cfg.map.cells_x + 2
    card = kmatch.H100
    for b, nt, n in ((48, mc.coarse_nt, mc.coarse_nxy),
                     (192, mc.fine_nt, mc.fine_nxy)):
        plan = kmatch.tile_launch_plan(500, 1, h, w, b, nt, n, n, **card)
        assert plan.variant == "staged"
        units = n * -(-n // plan.run)
        assert units <= kmatch.WARP and plan.unit_warps == 1
        assert all(n * -(-n // r) > kmatch.WARP for r in range(1, plan.run))
        assert plan.grid == kmatch.STAGED_BLOCKS * card["sm_count"]
        assert plan.warps == kmatch.STAGED_WARPS
        assert plan.grid * plan.warps >= 500 * (nt if b > 48 else 1)
        assert kmatch.STAGED_BLOCKS * (plan.smem_bytes
                                       + kmatch.BLOCK_RESERVED) \
            <= card["smem_sm"]
        assert plan.box_floats * 4 + plan.warps * (b | 1) * 8 \
            <= plan.smem_bytes
        assert plan.box_floats >= 200 * 200
        assert plan.threads == kmatch.WARP * plan.warps


@pytest.mark.parametrize("b,nt,n,w", [(48, 11, 9, 62), (192, 5, 5, 122),
                                      (48, 11, 9, 122)])
def test_tile_launch_plan_keeps_the_shared_plan_at_the_sharded_shapes(
        b, nt, n, w):
    """The sharded RBPF's tiles (250 particles a field, the parity map's
    120 rows: its half-resolution coarse stage, its fine and refine
    stages, and a full-resolution coarse stage) fit a block: the plan is
    launch_plan's shared-variant plan, field for field."""
    h = 60 if w == 62 else 120
    got = kmatch.tile_launch_plan(250, 250, h, w, b, nt, n, n, **kmatch.H100)
    want = kmatch.launch_plan(250, 250, h, w, b, nt, n, n, **kmatch.H100)
    assert got == want and got.variant == "shared"
    assert (got.pitch, got.pairs_per_tile, got.run, got.splits, got.threads,
            got.smem_bytes) == (want.pitch, want.pairs_per_tile, want.run,
                                want.splits, want.threads, want.smem_bytes)


def test_tile_launch_plan_splits_a_wide_grid_over_warps_and_a_long_scan():
    """Candidates of more than 32 units a pair take several warps, a call
    of few items no more blocks than items, and a scan of many beams
    fewer warps, whose endpoints take at most half the block's shared
    memory and leave the rest to the box."""
    plan = kmatch.tile_launch_plan(8, 1, 4000, 4002, 64, 3, 21, 21,
                                   **kmatch.H100)
    assert plan.run == kmatch.MAX_RUN
    assert plan.unit_warps == -(-21 * -(-21 // plan.run) // kmatch.WARP)
    assert plan.grid == 8 * 3 * plan.unit_warps < kmatch.H100["sm_count"]
    big = kmatch.tile_launch_plan(16, 1, 4000, 4002, 4096, 3, 5, 5,
                                  **kmatch.H100)
    assert 1 <= big.warps < kmatch.STAGED_WARPS
    assert big.warps * 4097 * 8 <= big.smem_bytes // 2
    assert big.box_floats * 4 + big.warps * 4097 * 8 <= big.smem_bytes
    assert big.box_floats * 4 >= big.smem_bytes // 2 - 16
