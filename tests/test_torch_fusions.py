"""F1-F3's plain versions (ops/cuda/fusions.py) held to the JAX package.

F3's plain pick against JAX's _prior_grid, _argmax3 and take
(gridmap_slam_tpu/ops/matcher.py:137-162, vmapped over the particles), F1's
joint motion entry against JAX's sample_motion arithmetic and
apply_odometry with the same normals, F2's plain pool against the JAX
matcher's pool (gridmap_slam_tpu/ops/matcher.py:246-252).  Inputs come from
numpy with a fixed seed.  The kernels themselves are held bit for bit
against these plain versions on the card by chip_smoke.py.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MotionConfig
from gridmap_slam_tpu.ops import geometry as jgeo
from gridmap_slam_tpu.ops import matcher as jm
from gridmap_slam_tpu.ops import motion as jmotion
from gridmap_slam_tpu.types import Odom as JOdom
from gridmap_slam_tpu_torch.ops import matcher as tm
from gridmap_slam_tpu_torch.ops import motion as tmotion
from gridmap_slam_tpu_torch.ops.cuda import _build, fusions
from gridmap_slam_tpu_torch.ops.geometry import wrap_angle
from gridmap_slam_tpu_torch.types import Odom

torch.set_num_threads(1)

MOTION_ATOL = 1e-6        # tests/test_torch_ops.py
PICK_RTOL = 1e-6
GAP = 1e-5                # top-two totals apart by more than this
LL_OUT = math.log(1.0 / 10.0)
CFG = MotionConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ F3: pick
def _pick_inputs(seed, p, nt, ny, nx, groups=1):
    """Scores of a stage, its candidates' offsets a particle (an exact 0
    in the middle of each, as the matcher's linspace offsets), search
    centers, prior centers and odometry rows."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(-30.0, 3.0, (p, nt, ny, nx)).astype(np.float32)

    def offs(n, span):
        base = np.linspace(-span, span, n).astype(np.float32)
        return (base + rng.uniform(-0.01, 0.01, (p, 1))).astype(np.float32)

    dxs, dys, dts = offs(nx, 0.2), offs(ny, 0.2), offs(nt, 0.3)
    pose0 = rng.uniform(-2, 2, (p, 3)).astype(np.float32)
    pose0[:, 2] = rng.uniform(-3.1, 3.1, p)
    center = (pose0 + rng.normal(0, 0.05, (p, 3))).astype(np.float32)
    center[0, 2] = pose0[0, 2] - 6.2     # a bias heading that wraps
    d_c = rng.uniform(-0.3, 0.3, groups).astype(np.float32)
    d_t = rng.uniform(-0.4, 0.4, groups).astype(np.float32)
    return scores, dxs, dys, dts, pose0, center, d_c, d_t


def _jax_pick(scores, dxs, dys, dts, pose0, center, d_c, d_t, scale,
              weight):
    """JAX's prior, first argmax and take for each particle: (fx, fy, ft,
    flat, the picked score, each total)."""
    p = scores.shape[0]
    rows = np.arange(p) // (p // d_c.shape[0])

    def one(s, dx, dy, dt, p0, pc, dc, dth, sc):
        sd_c, sd_t = jmotion.noise_scales(JOdom(dc, dth), CFG)
        bias = None if pc is None else (
            p0[0] - pc[0], p0[1] - pc[1], jgeo.wrap_angle(p0[2] - pc[2]))
        total = s + sc * jm._prior_grid(dx, dy, dt, sd_c, sd_t, weight, bias)
        fx, fy, ft, flat = jm._argmax3(total, dx, dy, dt)
        return fx, fy, ft, flat, s.reshape(-1)[flat], total

    args = [jnp.asarray(a) for a in (scores, dxs, dys, dts, pose0)]
    odo = [jnp.asarray(d_c[rows]), jnp.asarray(d_t[rows])]
    sc = jnp.asarray(np.broadcast_to(np.float32(scale), (p,)))
    if center is None:
        out = jax.vmap(lambda s, dx, dy, dt, p0, dc, dth, c: one(
            s, dx, dy, dt, p0, None, dc, dth, c))(*args, *odo, sc)
    else:
        out = jax.vmap(one)(*args, jnp.asarray(center), *odo, sc)
    return [np.asarray(o) for o in out]


def _odom(d, groups):
    return _t(d) if groups > 1 else _t(d[0])


def _torch_pick(inputs, center, groups, use=None, stride=1, final=False):
    scores, dxs, dys, dts, pose0, _, d_c, d_t = inputs
    nx, nt = dxs.shape[1], dts.shape[1]
    offs = (None, None) if final else (
        _t(np.linspace(-0.05, 0.05, nx).astype(np.float32)),
        _t(np.linspace(-0.02, 0.02, nt).astype(np.float32)))
    return fusions.pick(
        _t(scores), _t(dxs), _t(dys), _t(dts), _t(pose0),
        None if center is None else _t(center), _odom(d_c, groups),
        _odom(d_t, groups), use, *offs, motion=CFG, prior_weight=0.7,
        stride=stride)


def _flat_from_offsets(nxt, dxs, dys, dts, ny, nx):
    """The flat index a pick chose, from the next stage's offsets: each
    axis's middle offset is 0, so that column is the chosen offset itself."""
    r_dxs, r_dys, r_dts = (a.numpy() for a in nxt)
    ix = np.array([np.flatnonzero(dxs[i] == r_dxs[i, r_dxs.shape[1] // 2])
                   for i in range(len(dxs))])[:, 0]
    iy = np.array([np.flatnonzero(dys[i] == r_dys[i, r_dys.shape[1] // 2])
                   for i in range(len(dys))])[:, 0]
    it = np.array([np.flatnonzero(dts[i] == r_dts[i, r_dts.shape[1] // 2])
                   for i in range(len(dts))])[:, 0]
    return (it * ny + iy) * nx + ix


def _scan_use(seed, groups, b):
    rng = np.random.default_rng(seed)
    use = rng.uniform(size=(groups, b)) < 0.7
    use[-1, :] = False                 # no used beam: counts clamp to 1
    return use


# name -> (prior centered on the odometry pose, odometry rows, coarse)
PICK_CASES = {"coarse": (True, 1, True), "refine": (True, 1, False),
              "no_bias": (False, 1, False),
              "per_group_odometry": (True, 4, True)}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_plain_pick_matches_jax(case):
    biased, groups, coarse = PICK_CASES[case]
    p, nt, ny, nx = 16, 5, 7, 7
    inputs = _pick_inputs(11, p, nt, ny, nx, groups)
    scores, dxs, dys, dts, pose0, center, d_c, d_t = inputs
    center = center if biased else None
    use, stride, scale, unscale = None, 1, np.ones(p, np.float32), 1.0
    if coarse:
        stride = 3
        mask = _scan_use(5, groups, 40)
        rows = np.arange(p) // (p // groups)
        n_all = np.maximum(mask.sum(-1), 1).astype(np.float32)[rows]
        n_c = np.maximum(mask[:, ::stride].sum(-1), 1).astype(np.float32)[rows]
        scale, unscale = n_c / n_all, n_all / n_c
        use = _t(mask if groups > 1 else mask[0])
    jfx, jfy, jft, jflat, jmeas, jtotal = _jax_pick(
        scores, dxs, dys, dts, pose0, center, d_c, d_t, scale, 0.7)
    top2 = np.sort(jtotal.reshape(p, -1), -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.sum() >= p - 2

    nxt = _torch_pick(inputs, center, groups, use, stride)
    flat = _flat_from_offsets(nxt, dxs, dys, dts, ny, nx)
    np.testing.assert_array_equal(flat[clear], jflat[clear])

    best, meas = _torch_pick(inputs, center, groups, use, stride, final=True)
    want_best = pose0 + np.stack([jfx, jfy, jft], -1)
    np.testing.assert_allclose(best.numpy()[clear], want_best[clear],
                               rtol=PICK_RTOL, atol=1e-6)
    np.testing.assert_allclose(meas.numpy()[clear],
                               (unscale * jmeas)[clear], rtol=PICK_RTOL)


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_plain_pick_takes_the_first_of_tied_totals(case):
    """Scores planted so that two mirrored candidates' totals tie exactly
    (the prior is symmetric without a bias): both pick the first."""
    _, groups, coarse = PICK_CASES[case]
    p, nt, ny, nx = 8, 3, 5, 5
    inputs = list(_pick_inputs(12, p, nt, ny, nx, groups))
    lin = np.linspace(-0.2, 0.2, nx).astype(np.float32)
    inputs[1] = np.broadcast_to(lin, (p, nx)).copy()
    inputs[2] = np.broadcast_to(lin, (p, ny)).copy()
    scores = inputs[0]
    for i in range(p):
        it, iy, ix = i % nt, (i * 2) % ny, i % 2
        scores[i, it, iy, ix] = scores[i, it, iy, nx - 1 - ix] = 1e4
    use, stride, scale = None, 1, np.ones(p, np.float32)
    if coarse:
        mask = np.ones((groups, 12), bool)
        stride, scale = 2, np.full(p, 0.5, np.float32)
        use = _t(mask if groups > 1 else mask[0])
    jflat = _jax_pick(*inputs[:5], None, *inputs[6:], scale, 0.7)[3]
    want = [(i % nt * ny + (i * 2) % ny) * nx + i % 2 for i in range(p)]
    np.testing.assert_array_equal(jflat, want)
    nxt = _torch_pick(inputs, None, groups, use, stride)
    np.testing.assert_array_equal(
        _flat_from_offsets(nxt, *inputs[1:4], ny, nx), want)


def test_pick_keeps_the_matchers_bits():
    """The last stage's pick_plain gives the bits of the op sequence
    correlative_match_batch ran before it (the prior, the argmax, the take
    and the best pose)."""
    inputs = _pick_inputs(13, 8, 11, 9, 9)
    scores, dxs, dys, dts, pose0, center, d_c, d_t = (_t(a) for a in inputs)
    sd_c, sd_t = fusions.noise_scales(Odom(d_c[0], d_t[0]), CFG)
    bias = torch.stack([pose0[:, 0] - center[:, 0],
                        pose0[:, 1] - center[:, 1],
                        wrap_angle(pose0[:, 2] - center[:, 2])], 1)
    total = scores + fusions._prior_grid(dxs, dys, dts, sd_c, sd_t, 0.7, bias)
    fx, fy, ft, flat = fusions._argmax3(total, dxs, dys, dts)
    best, meas = fusions.pick(scores, dxs, dys, dts, pose0, center, d_c[0],
                              d_t[0], None, None, None, motion=CFG,
                              prior_weight=0.7)
    assert torch.equal(best, torch.stack([pose0[:, 0] + fx, pose0[:, 1] + fy,
                                          pose0[:, 2] + ft], 1))
    assert torch.equal(meas, fusions._take(scores.reshape(8, -1), flat))


# F3's launch plan (ops/cuda/fusions.pick_plan) at the matcher's stage
# shapes (coarse 11 x 9 x 9, fine and refine 5 x 5 x 5) and a closure
# window's, from one particle to the 2^31-candidate limit
PLAN_SHAPES = {"coarse": (11, 9, 9), "fine": (5, 5, 5),
               "closure": (13, 15, 15)}
PLAN_PARTICLES = [1, 2, 100, 250, 500, 2048, 20_000, 500_000, "limit"]
H100_SMS = 132
# blocks of PICK_THREADS an SM: one, F3's launch bound's least, and the
# most an SM's 2048 threads hold
RESIDENT = (1, 3, 8)


def _pick_lane_candidates(lane, lanes, nt, ny, nx):
    """The candidates a lane of fusion_pick_kernel visits: its (dy, dx)
    cells r0 + a lanes for a < cells, at its headings h, h + H, ..."""
    nyx = ny * nx
    big_h = max(1, min(nt, lanes // nyx))
    h = lane // nyx if big_h > 1 else 0
    r0 = lane - h * nyx
    cells = ((1 if lane < big_h * nyx else 0) if big_h > 1
             else max(0, (nyx - lane + lanes - 1) // lanes))
    return [it * nyx + r0 + a * lanes for it in range(h, nt, big_h)
            for a in range(cells)], cells


@pytest.mark.parametrize("p", PLAN_PARTICLES)
@pytest.mark.parametrize("stage", sorted(PLAN_SHAPES))
def test_pick_plan_covers_each_particle_once(stage, p):
    """The plan as csrc/fusions.cu fusion_pick_kernel works it: the slabs
    a team takes (first = block teams + team, stride = grid teams, the grid
    as many blocks as are resident and no more than the slabs need), the
    particles of a slab, a particle's lanes (shuffles and the team's warps
    combine no lane of another particle) and a lane's candidates."""
    nt, ny, nx = PLAN_SHAPES[stage]
    n, nyx = nt * ny * nx, ny * nx
    p = (2 ** 31 - 1) // n if p == "limit" else p
    plan = fusions.pick_plan(p, nt, ny, nx)
    lanes, per_slab = plan.lanes, plan.per_slab
    team = lanes * per_slab
    assert lanes & (lanes - 1) == 0 and team == max(lanes, 32)
    assert fusions.PICK_THREADS % team == 0
    teams = fusions.PICK_THREADS // team
    slabs = -(-p // per_slab)
    for resident in RESIDENT:
        grid = min(resident * H100_SMS, -(-slabs // teams))
        assert 1 <= grid <= 2 ** 31 - 1
        stride = grid * teams
        taken = np.zeros(slabs, np.int32)
        for b in range(grid):
            for t in range(teams):
                taken[b * teams + t::stride] += 1
        assert (taken == 1).all()
    # slab s holds particles s per_slab + g for g < min(per_slab, P - p0)
    p0 = np.arange(slabs, dtype=np.int64) * per_slab
    ends = np.minimum(p0 + per_slab, p)
    assert p0[0] == 0 and ends[-1] == p and (p0[1:] == ends[:-1]).all()
    # a team's thread tt = g lanes + l works particle g; the xor partners
    # of its shuffles (off < min(lanes, 32)) and, past a warp, the team's
    # warps (a particle a team) are its particle's lanes
    tt = np.arange(team)
    for off in (1 << k for k in range(min(lanes, 32).bit_length() - 1)):
        assert ((tt ^ off) // lanes == tt // lanes).all()
    assert lanes <= 32 or per_slab == 1
    # a particle's lanes visit each candidate once, a lane at most as many
    # cells as its instantiation holds
    most = 1 if lanes >= nyx else -(-nyx // lanes)
    assert most <= fusions.PICK_CELLS
    visits = np.zeros(n, np.int32)
    for lane in range(lanes):
        cands, cells = _pick_lane_candidates(lane, lanes, nt, ny, nx)
        assert cells <= most
        np.add.at(visits, cands, 1)
    assert (visits == 1).all()
    # a slab staged within PICK_SLAB_BYTES; a warp's slab within
    # PICK_WARP_BYTES (or one particle); a block's worth of threads an SM,
    # unless each candidate has a lane already
    assert plan.staged == (per_slab * n * 4 <= fusions.PICK_SLAB_BYTES)
    assert per_slab == 1 or per_slab * n * 4 <= fusions.PICK_WARP_BYTES
    cap = min(fusions.PICK_THREADS, 1 << (n - 1).bit_length())
    assert lanes == cap or p * lanes >= H100_SMS * fusions.PICK_THREADS


@pytest.mark.parametrize("p,stage,lanes", [
    (250, "coarse", 256), (250, "fine", 128), (500, "coarse", 128),
    (500, "fine", 128), (500_000, "coarse", 32), (500_000, "fine", 4)])
def test_pick_plan_at_the_cells(p, stage, lanes):
    """250-500 particles spread over every SM, 128-256 threads a particle;
    a 500 000 block in warps, a particle a warp (coarse) or eight (fine),
    each warp working its slabs in turn; every slab's scores staged."""
    plan = fusions.pick_plan(p, *PLAN_SHAPES[stage])
    assert (plan.lanes, plan.staged) == (lanes, True)


# stages of more (dy, dx) cells than PICK_CELLS lanes' registers hold
# (ny nx > 2048): ny nx -> (nt, ny, nx)
WIDE_STAGES = {2049: (1, 3, 683), 2601: (11, 51, 51), 10201: (3, 101, 101)}


def _pick_lane_groups(lane, lanes, nt, ny, nx):
    """A lane's candidates as fusion_pick_kernel's grouped instantiation
    visits them: its cells r0 + a lanes in groups of PICK_CELLS, a group's
    headings in turn and its cells in turn within a heading."""
    cands, cells = _pick_lane_candidates(lane, lanes, nt, ny, nx)
    nyx, per = ny * nx, fusions.PICK_CELLS
    r = sorted({c % nyx for c in cands})
    return [[it * nyx + q for it in range(nt) for q in r[g:g + per]]
            for g in range(0, cells, per)]


def _before(v, i, w, j):
    """csrc/fusions.cu before(): (v, i) first in the argmax's order."""
    if j < 0:
        return i >= 0
    vn, wn = math.isnan(v), math.isnan(w)
    return i >= 0 and ((vn and not wn) or (vn == wn and v > w)
                       or (vn == wn and not v != w and i < j)
                       or (vn and wn and i < j))


@pytest.mark.parametrize("cells", sorted(WIDE_STAGES))
def test_pick_plan_covers_each_cell_past_2048_once(cells):
    """Past 2048 (dy, dx) cells the plan is the largest team, and each lane
    walks its cells in groups of at most PICK_CELLS: every candidate of a
    particle is visited once, by one lane, each group in index order."""
    nt, ny, nx = WIDE_STAGES[cells]
    for p in (1, 250, 500, 20_000):
        plan = fusions.pick_plan(p, nt, ny, nx)
        assert plan.lanes == fusions.PICK_THREADS and plan.per_slab == 1
        visits = np.zeros(nt * cells, np.int32)
        for lane in range(plan.lanes):
            for group in _pick_lane_groups(lane, plan.lanes, nt, ny, nx):
                assert len(group) <= nt * fusions.PICK_CELLS
                assert group == sorted(group)
                np.add.at(visits, group, 1)
        assert (visits == 1).all()


@pytest.mark.parametrize("kind", ["ties", "nan", "neginf", "zeros"])
@pytest.mark.parametrize("cells", sorted(WIDE_STAGES))
def test_pick_lane_groups_take_the_first_argmax(cells, kind):
    """The grouped walk as the kernel does it: a group's first maximum by
    strict comparison (a NaN kept once taken), the groups' and the lanes'
    picks combined in before()'s order; on scores with ties at the groups'
    edges, NaN, -inf or +-0 it is the first argmax (NaN first)."""
    nt, ny, nx = WIDE_STAGES[cells]
    n, lanes = nt * cells, fusions.PICK_THREADS
    rng = np.random.default_rng(cells)
    v = rng.normal(-30, 3, n).astype(np.float32)
    edges = sorted({e for k in range(1, 5) for e in
                    (k * fusions.PICK_CELLS * lanes - 1,
                     k * fusions.PICK_CELLS * lanes, n - k) if 0 <= e < n})
    if kind == "ties":
        v[edges] = 1e4
    elif kind == "nan":
        v[edges[1::2]] = np.nan
    elif kind == "neginf":
        v[:] = -np.inf
    else:
        v = np.where(rng.uniform(size=n) < 0.5, np.float32(0.0),
                     np.float32(-0.0))
    bv, bi = -math.inf, -1
    for lane in range(lanes):
        lv, li = -math.inf, -1
        for group in _pick_lane_groups(lane, lanes, nt, ny, nx):
            gv, gi = -math.inf, -1
            for c in group:
                if not math.isnan(gv) and not v[c] <= gv:
                    gv, gi = float(v[c]), c
            if _before(gv, gi, lv, li):
                lv, li = gv, gi
        if li < 0 and _pick_lane_candidates(lane, lanes, nt, ny, nx)[1]:
            li = _pick_lane_groups(lane, lanes, nt, ny, nx)[0][0]
        if _before(lv, li, bv, bi):
            bv, bi = lv, li
    want = (int(np.flatnonzero(np.isnan(v))[0]) if np.isnan(v).any()
            else int(torch.argmax(torch.from_numpy(v))))
    assert bi == want


@pytest.mark.parametrize("shape", [(11, 51, 51), (3, 101, 101)])
def test_plain_pick_matches_jax_past_2048_cells(shape):
    """pick_plain at a coarse stage of 51 x 51 cells (11 headings) and a
    fine one of 101 x 101 (3), against JAX's at test_plain_pick_matches_jax's
    tolerance: the chosen candidate, the best pose and its score."""
    nt, ny, nx = shape
    p = 4
    inputs = _pick_inputs(23, p, nt, ny, nx)
    scores, dxs, dys, dts, pose0, center, d_c, d_t = inputs
    scale = np.ones(p, np.float32)
    jfx, jfy, jft, jflat, jmeas, jtotal = _jax_pick(
        scores, dxs, dys, dts, pose0, center, d_c, d_t, scale, 0.7)
    top2 = np.sort(jtotal.reshape(p, -1), -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.sum() >= p - 1
    nxt = _torch_pick(inputs, center, 1)
    flat = _flat_from_offsets(nxt, dxs, dys, dts, ny, nx)
    np.testing.assert_array_equal(flat[clear], jflat[clear])
    best, meas = _torch_pick(inputs, center, 1, final=True)
    np.testing.assert_allclose(
        best.numpy()[clear], (pose0 + np.stack([jfx, jfy, jft], -1))[clear],
        rtol=PICK_RTOL, atol=1e-6)
    np.testing.assert_allclose(meas.numpy()[clear], jmeas[clear],
                               rtol=PICK_RTOL)


def _split_points(nt, ny, nx):
    """The candidates at the edges of the plans' splits: the first and the
    last, and each lane's, warp's and block's edges at 250 particles and at
    a 500 000 block."""
    n = nt * ny * nx
    edges = {0, n - 1}
    for p in (250, 500_000):
        lanes = fusions.pick_plan(p, nt, ny, nx).lanes
        for w in {lanes, 32}:
            edges |= {w - 1, w, n - w, n - w - 1, 2 * w - 1}
    return sorted(e for e in edges if 0 <= e < n)


@pytest.mark.parametrize("kind", ["ties", "nan", "neginf", "zeros"])
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_plain_pick_matches_jax_at_the_plans_split_points(stage, kind):
    """Scores that tie, are NaN, -inf or +-0 at the candidates where the
    kernel's plan splits a particle (with a zero prior weight, so that the
    totals are the scores): pick_plain takes JAX's first argmax and its
    score."""
    nt, ny, nx = PLAN_SHAPES[stage]
    n, p = nt * ny * nx, 10
    edges = _split_points(nt, ny, nx)
    inputs = list(_pick_inputs(21, p, nt, ny, nx))
    flat = inputs[0].reshape(p, n)
    for i in range(p):
        pick_ = edges[i % len(edges):]
        if kind == "ties":
            flat[i, pick_] = 1e4
        elif kind == "nan":
            flat[i, pick_[::2]] = np.nan
        elif kind == "neginf":
            flat[i] = -np.inf
            if i % 2:
                flat[i, pick_[1::3]] = -1e30
        else:
            flat[i] = np.where(np.arange(n) % 3 == i % 3, -0.0, 0.0)
    jfx, jfy, jft, jflat, jmeas, _ = _jax_pick(
        *inputs[:6], *inputs[6:], np.ones(p, np.float32), 0.0)
    scores, dxs, dys, dts, pose0, center, d_c, d_t = (_t(a) for a in inputs)
    kw = dict(motion=CFG, prior_weight=0.0)
    use = _t(np.ones(40, bool)) if stage == "coarse" else None
    off = (_t(np.linspace(-0.05, 0.05, 5).astype(np.float32)),
           _t(np.linspace(-0.02, 0.02, 5).astype(np.float32)))
    nxt = fusions.pick_plain(scores, dxs, dys, dts, pose0, center, d_c[0],
                             d_t[0], use, *off, **kw)
    np.testing.assert_array_equal(
        _flat_from_offsets(nxt, *inputs[1:4], ny, nx), jflat)
    best, meas = fusions.pick_plain(scores, dxs, dys, dts, pose0, center,
                                    d_c[0], d_t[0], use, None, None, **kw)
    np.testing.assert_array_equal(meas.numpy(), jmeas)
    np.testing.assert_array_equal(
        best.numpy(), inputs[4] + np.stack([jfx, jfy, jft], -1))


# ---------------------------------------------------------------- F1: motion
@pytest.mark.parametrize("robots", [0, 3])
def test_joint_motion_matches_jax(robots):
    """sample_and_propagate against JAX's sampler arithmetic with the same
    normals (tests/test_torch_ops.py's) and JAX's apply_odometry: one pose
    batch, and (R, P, 3) poses with one odometry row a robot."""
    rng = np.random.default_rng(4)
    lead = (robots, 8) if robots else (24,)
    poses = rng.uniform(-2, 2, (*lead, 3)).astype(np.float32)
    poses[..., 2] = rng.uniform(-3.1, 3.1, lead)
    normals = rng.standard_normal((*lead, 2)).astype(np.float32)
    shape = (robots, 1) if robots else ()
    d_c = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    d_t = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    jo = JOdom(d_center=jnp.asarray(d_c), d_theta=jnp.asarray(d_t))
    sd_c, sd_t = jmotion.noise_scales(jo, CFG)
    d = jo.d_center + sd_c * jnp.asarray(normals[..., 0])
    th = jo.d_theta + sd_t * jnp.asarray(normals[..., 1])
    theta = jgeo.wrap_angle(jnp.asarray(poses[..., 2]) + th)
    want_s = np.stack([poses[..., 0] + np.asarray(jnp.cos(theta) * d),
                       poses[..., 1] + np.asarray(jnp.sin(theta) * d),
                       np.asarray(theta)], -1)
    want_det = np.asarray(jmotion.apply_odometry(jnp.asarray(poses), jo))
    to = Odom(d_center=_t(d_c), d_theta=_t(d_t))
    got_s, got_det = tmotion.sample_and_propagate(_t(poses), to, CFG,
                                                  _t(normals))
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=MOTION_ATOL)
    np.testing.assert_allclose(got_det.numpy(), want_det, atol=MOTION_ATOL)
    assert torch.equal(got_s, tmotion.sample_motion(_t(poses), to, CFG,
                                                    _t(normals)))
    assert torch.equal(got_det, tmotion.apply_odometry(_t(poses), to))


@pytest.mark.parametrize("shape,lead,ok", [
    ((), (5, 3), True), ((1,), (6,), True), ((2, 1), (2, 4), True),
    ((6,), (6,), True), ((4,), (2, 4), False), ((3, 1), (2, 4), False)])
def test_motion_odometry_rows(shape, lead, ok):
    """The kernel's odometry rows: a 0-dim field, or one that broadcasts a
    row to a contiguous run of particles; else ValueError."""
    d = torch.zeros(shape)
    if ok:
        rows = fusions._groups("motion_cuda", d, lead)
        assert rows.dim() == 1 and math.prod(lead) % rows.shape[0] == 0
    else:
        with pytest.raises(ValueError, match="one row a run"):
            fusions._groups("motion_cuda", d, lead)


# ------------------------------------------------------------------ F2: pool
@pytest.mark.parametrize("shape", [(3, 8, 10), (2, 7, 9), (1, 5, 6),
                                   (2, 6, 1)])
def test_plain_pool_matches_jax(shape):
    rng = np.random.default_rng(7)
    field = rng.uniform(-5.0, 0.0, shape).astype(np.float32)

    def jax_pool(llfield):            # gridmap_slam_tpu/ops/matcher.py:246-252
        h_, w_ = llfield.shape
        lle = jnp.pad(llfield, ((0, h_ & 1), (0, w_ & 1)),
                      constant_values=LL_OUT)
        return lle.reshape(lle.shape[0] // 2, 2, lle.shape[1] // 2,
                           2).mean((1, 3))

    want = np.stack([np.asarray(jax_pool(jnp.asarray(f))) for f in field])
    got = tm.half_resolution(_t(field), LL_OUT)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a column slice of a wider field, as parallel/tiled.py pools its tiles
    wide = np.pad(field, ((0, 0), (0, 0), (1, 1)), constant_values=9.0)
    assert torch.equal(fusions.pool(_t(wide)[..., 1:-1], LL_OUT), got)


# ------------------------------------------------------- dispatch and build
def test_fused_entry_points_take_cpu_tensors_to_their_plain_versions():
    inputs = _pick_inputs(14, 4, 3, 3, 3)
    scores, dxs, dys, dts, pose0, center, d_c, d_t = (_t(a) for a in inputs)
    normals = torch.zeros((4, 2))
    field = torch.zeros((2, 5, 5))
    counts = (fusions.motion_launches, fusions.pool_launches,
              fusions.pick_launches)
    for fn, args, kw in (
            (fusions.motion_cuda, (pose0, d_c[0], d_t[0], normals),
             dict(cfg=CFG, deterministic=True)),
            (fusions.pool_cuda, (field, LL_OUT), {}),
            (fusions.pick_cuda, (scores, dxs, dys, dts, pose0, center,
                                 d_c[0], d_t[0], None, None, None),
             dict(motion=CFG, prior_weight=1.0))):
        with pytest.raises(ValueError, match="must be"):
            fn(*args, **kw)
    s, det = fusions.motion(pose0, d_c[0], d_t[0], normals, cfg=CFG,
                            deterministic=True)
    want = fusions.motion_plain(pose0, d_c[0], d_t[0], normals, cfg=CFG,
                                deterministic=True)
    assert torch.equal(s, want[0]) and torch.equal(det, want[1])
    assert torch.equal(fusions.pool(field, LL_OUT),
                       fusions.pool_plain(field, LL_OUT))
    got = fusions.pick(scores, dxs, dys, dts, pose0, center, d_c[0], d_t[0],
                       None, None, None, motion=CFG, prior_weight=1.0)
    want = fusions.pick_plain(scores, dxs, dys, dts, pose0, center, d_c[0],
                              d_t[0], None, None, None, motion=CFG,
                              prior_weight=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fusions.motion_launches, fusions.pool_launches,
            fusions.pick_launches) == counts


def test_signatures_name_each_c_entry_of_fusions_cu():
    src = (Path(_build.CSRC) / "fusions.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {name for name, _ in entries} == {
        "gs_fusion_motion", "gs_fusion_pool", "gs_fusion_pick",
        "gs_fusion_sample", "gs_fusion_splat", "gs_fusion_scan",
        "gs_fusion_weights", "gs_fusion_walk", "gs_fusion_exp",
        "gs_fusion_weights_mesh", "gs_fusion_walk_mesh"}
    for name, params in entries:
        assert len(_build.SIGNATURES[name]) == len(params.split(",")), name
    assert Path(_build.CSRC) / "fusions.cu" in _build.sources()
