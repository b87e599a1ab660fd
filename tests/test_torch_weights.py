"""The weights' tail of the port, on the CPU: ops/resample's fixed summing
orders, and the plain versions of F7 (the weights' tail) and F8 (the
systematic walk), held to numpy and to the JAX package.

On the CPU the port's reductions are PyTorch's own, bit for bit the op
sequence that F7 and F8 replaced; on the card they take the fixed orders
that ops/resample spells out with elementwise operations.  Those orders are
the same functions on any device, so the `card_order` fixture (which
replaces ops/resample.card_order for the test) runs the card's orders here.
Tolerances: tests/test_torch_ops.py's (Neff within 1e-4, weights and the
weighted pose within 1e-6, ancestors exact on the tie cases), the sums'
those of its test_blocked_cumsum_matches_cumsum (float64 within 1e-12 of
the magnitude a term, float32 weights within 1e-6 of JAX's), and the steps'
those of tests/test_torch_rbpf.py and tests/test_torch_shared.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu import RBPF as JRBPF
from gridmap_slam_tpu import SlamConfig as JSlamConfig
from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SensorConfig as JSensorConfig
from gridmap_slam_tpu.io import frame_at as j_frame_at
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.models import shared as js
from gridmap_slam_tpu.ops import resample as jres
from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            shared_state_from_jax_arrays,
                                            state_from_jax_arrays)
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.ops import resample as tres
from gridmap_slam_tpu_torch.ops.cuda import fusions
from gridmap_slam_tpu_torch.ops.geometry import wrap_angle
from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(1)

ATOL = 1e-6
SIZES = [1, 2, 7, 100, 500, 1025, 10_000, 100_003]
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
# systematic resampling's tie cases (tests/test_torch_ops.py): the cases of
# tests/test_resample.py plus exact u == cum ties
TIES = [(np.asarray([0.15, 0.1, 0.3, 0.05, 0.25, 0.15]), r)
        for r in (0.0, 0.01, 0.123 / 6, 0.9999 / 6)]
TIES += [(np.full(n, 1.0 / n), r) for n in (4, 8) for r in (0.0, 0.5 / n)]
TIES += [(np.asarray([0.4, 0.3, 0.2, 0.05, 0.05]), 0.1)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def card_order(monkeypatch):
    """ops/resample's fixed orders (the card's) on the CPU."""
    monkeypatch.setattr(tres, "card_order", lambda x: True)


# ------------------------------------------------------- the fixed orders
@pytest.mark.parametrize("n", SIZES)
def test_sum_fixed_order_matches_numpy(n, card_order):
    rng = np.random.default_rng(n)
    x = rng.uniform(size=n)
    got = tres.sum_fixed_order(torch.from_numpy(x))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), x.sum(), rtol=0, atol=1e-12 * n)
    w = (x / x.sum()).astype(np.float32)
    np.testing.assert_allclose(float(tres.sum_fixed_order(_t(w))),
                               float(jnp.sum(jnp.asarray(w))), rtol=0,
                               atol=1e-6)
    # rows of a batch, along either axis, sum as each row alone
    rows = _t(np.stack([w, w[::-1]]))
    want = torch.stack([tres.sum_fixed_order(r) for r in rows])
    assert torch.equal(tres.sum_fixed_order(rows), want)
    assert torch.equal(tres.sum_fixed_order(rows.T.contiguous(), 0), want)
    assert torch.equal(tres.sums_fixed_order(*rows), want)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_cumsum_fixed_order_matches_numpy(n, card_order):
    """The card's scan (ops/resample.blocked_cumsum, which
    cumsum_fixed_order takes there) is the running sum: float64 within
    1e-12 of the total's magnitude, float32 weights summing to 1 within
    1e-6 of JAX's cumsum."""
    rng = np.random.default_rng(n + 1)
    x = rng.uniform(size=n)
    got = tres.cumsum_fixed_order(torch.from_numpy(x))
    assert got.shape == (n,)
    assert torch.equal(got, tres.blocked_cumsum(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.cumsum(x), rtol=0,
                               atol=1e-12 * n)
    w = (x / x.sum()).astype(np.float32)
    np.testing.assert_allclose(tres.cumsum_fixed_order(_t(w)).numpy(),
                               np.asarray(jnp.cumsum(jnp.asarray(w))),
                               rtol=0, atol=1e-6)


def _spelled_sum(x):
    """ops/resample's documented sum order in numpy float32, value by
    value: each segment of 8 left to right, a row's 128 segment sums and
    then the row totals (padded to a power of two) by halving."""
    n = len(x)
    rows = max(-(-n // 1024), 1)
    v = np.zeros(rows * 1024, np.float32)
    v[:n] = x
    totals = []
    for r in range(rows):
        seg = []
        for s in range(128):
            acc = v[r * 1024 + 8 * s]
            for j in range(1, 8):
                acc = np.float32(acc + v[r * 1024 + 8 * s + j])
            seg.append(acc)
        while len(seg) > 1:
            h = len(seg) // 2
            seg = [np.float32(seg[i] + seg[i + h]) for i in range(h)]
        totals.append(seg[0])
    q = 1 << (rows - 1).bit_length()
    totals += [np.float32(0.0)] * (q - rows)
    while len(totals) > 1:
        h = len(totals) // 2
        totals = [np.float32(totals[i] + totals[i + h]) for i in range(h)]
    return totals[0]


def _spelled_scan(x):
    """ops/resample's documented scan order in numpy float32: each
    segment left to right, a row's segment totals and then the row totals
    by Hillis-Steele scans, the carry before each added after."""
    def hillis_steele(t):
        t, k = list(t), 1
        while k < len(t):
            t = t[:k] + [np.float32(t[i] + t[i - k])
                         for i in range(k, len(t))]
            k *= 2
        return t

    n = len(x)
    rows = max(-(-n // 1024), 1)
    v = np.zeros(rows * 1024, np.float32)
    v[:n] = x
    part = np.zeros_like(v)
    for r in range(rows):
        local = []
        for s in range(128):
            c = [v[r * 1024 + 8 * s]]
            for j in range(1, 8):
                c.append(np.float32(c[-1] + v[r * 1024 + 8 * s + j]))
            local.append(c)
        carry = hillis_steele([c[-1] for c in local])
        for s in range(128):
            for j in range(8):
                part[r * 1024 + 8 * s + j] = (
                    local[s][j] if s == 0
                    else np.float32(local[s][j] + carry[s - 1]))
    carry = hillis_steele([part[r * 1024 + 1023] for r in range(rows)])
    out = part.copy()
    for r in range(1, rows):
        out[r * 1024:(r + 1) * 1024] = part[r * 1024:(r + 1) * 1024] \
            + carry[r - 1]
    return out[:n]


@pytest.mark.parametrize("n", [5, 1024, 2900])
def test_fixed_orders_are_the_documented_ones(n):
    """tree_sum and blocked_cumsum are, bit for bit, the orders the module
    documents and csrc/fusions.cu's F7 and F8 reproduce."""
    rng = np.random.default_rng(10 + n)
    x = (rng.uniform(size=n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(
        np.float32)
    assert np.float32(tres.tree_sum(_t(x))) == _spelled_sum(x)
    np.testing.assert_array_equal(tres.blocked_cumsum(_t(x)).numpy(),
                                  _spelled_scan(x))


def test_fixed_orders_refuse_more_than_a_million():
    x = torch.zeros(1024 * 1024 + 1)
    with pytest.raises(ValueError, match="at most"):
        tres.tree_sum(x)
    with pytest.raises(ValueError, match="at most"):
        tres.blocked_cumsum(x)
    assert float(tres.tree_sum(torch.ones(1024 * 1024))) == 1024 * 1024


# --------------------------------------------------- the CPU's bits as they were
def _pr22_normalized(lw):
    w = torch.exp(lw - torch.max(lw))
    return w / torch.sum(w)


@pytest.mark.parametrize("n", SIZES)
def test_cpu_route_keeps_torch_bits(n):
    """On the CPU normalized_weights, neff, weighted_mean_pose and
    systematic_indices are the op sequences they were (torch.max, torch.exp,
    torch.sum, torch.cumsum), bit for bit, and F7's and F8's plain versions
    give the same bits."""
    rng = np.random.default_rng(20 + n)
    lw = _t(rng.normal(-50, 3, n).astype(np.float32))
    poses = _t(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    u0 = torch.tensor(float(rng.uniform(0, 1.0 / n)), dtype=torch.float32)
    w = _pr22_normalized(lw)
    neff = 1.0 / torch.sum(w * w)
    mean = torch.stack([torch.sum(poses[:, 0] * w),
                        torch.sum(poses[:, 1] * w),
                        torch.sum(wrap_angle(poses[:, 2]) * w)])
    cum = torch.cumsum(w, 0)
    idx = torch.clamp(torch.searchsorted(
        cum, u0 + torch.arange(n, dtype=torch.float32) / n), 0, n - 1)
    assert torch.equal(tres.normalized_weights(lw), w)
    assert torch.equal(tres.neff(lw), neff)
    assert torch.equal(tres.weighted_mean_pose(poses, lw), mean)
    assert torch.equal(tres.systematic_indices(lw, u0), idx)
    tail = fusions.weights(lw, poses)
    assert torch.equal(tail.max, torch.max(lw))
    assert torch.equal(tail.total, torch.sum(torch.exp(lw - torch.max(lw))))
    assert torch.equal(tail.neff, neff) and torch.equal(tail.weighted, mean)
    assert torch.equal(tail.best_index, torch.argmax(lw))
    assert torch.equal(tail.best_pose, poses[torch.argmax(lw)])
    got, gp, gl = fusions.walk(lw, u0, poses, tail.max, tail.total)
    assert torch.equal(got, idx) and torch.equal(gp, poses[idx])
    assert torch.equal(gl, lw[idx])


# ------------------------------------------------------ F7 and F8 against JAX
@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("n", [1, 7, 64, 1025, 5000])
def test_weights_plain_matches_jax(n, order, monkeypatch):
    if order == "card":
        monkeypatch.setattr(tres, "card_order", lambda x: True)
    rng = np.random.default_rng(30 + n)
    lw = rng.normal(-50, 3, n).astype(np.float32)
    poses = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    tail = fusions.weights_plain(_t(lw), _t(poses))
    assert abs(float(tail.neff) - float(jres.neff(jnp.asarray(lw)))) < 1e-4
    np.testing.assert_allclose(
        tail.weighted.numpy(),
        np.asarray(jres.weighted_mean_pose(jnp.asarray(poses),
                                           jnp.asarray(lw))), atol=ATOL)
    best = int(jnp.argmax(jnp.asarray(lw)))
    assert int(tail.best_index) == best
    np.testing.assert_array_equal(tail.best_pose.numpy(), poses[best])
    np.testing.assert_allclose(
        (torch.exp(_t(lw) - tail.max) / tail.total).numpy(),
        np.asarray(jres.normalized_weights(jnp.asarray(lw))), atol=ATOL)
    np.testing.assert_allclose(
        tres.normalized_weights(_t(lw)).numpy(),
        np.asarray(jres.normalized_weights(jnp.asarray(lw))), atol=ATOL)


@pytest.mark.parametrize("w,r", TIES)
def test_walk_plain_exact_ancestors_on_ties(w, r, card_order):
    """F8's plain version in the card's orders picks JAX's ancestors on the
    tie cases, exact u == cum ties among them, and gathers at them."""
    lw = np.log(w).astype(np.float32)
    n = len(w)
    cum = jnp.cumsum(jres.normalized_weights(jnp.asarray(lw)))
    u = jnp.float32(r) + jnp.arange(n, dtype=jnp.float32) / n
    want = np.clip(np.asarray(jnp.searchsorted(cum, u)), 0, n - 1)
    poses = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    tail = fusions.weights_plain(_t(lw), _t(poses))
    idx, got_p, got_l = fusions.walk_plain(
        _t(lw), torch.tensor(r, dtype=torch.float32), _t(poses), tail.max,
        tail.total)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(got_p.numpy(), poses[want])
    np.testing.assert_array_equal(got_l.numpy(), lw[want])


def test_walk_plain_matches_jax_key_draws(card_order):
    lw = np.log(np.asarray([0.4, 0.3, 0.2, 0.05, 0.05])).astype(np.float32)
    poses = torch.zeros((5, 3))
    for seed in range(5):
        key = jax.random.key(seed)
        r = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / 5)
        want = np.asarray(jres.systematic_indices(key, jnp.asarray(lw)))
        tail = fusions.weights_plain(_t(lw), poses)
        got = fusions.walk_plain(_t(lw), torch.tensor(float(r)), poses,
                                 tail.max, tail.total,
                                 gather_weights=False)
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert got[2] is None


@pytest.mark.parametrize("order", ["cpu", "card"])
def test_three_robots_in_one_call_as_three_calls(order, monkeypatch):
    if order == "card":
        monkeypatch.setattr(tres, "card_order", lambda x: True)
    rng = np.random.default_rng(40)
    lw = _t(rng.normal(-20, 2, (3, 300)).astype(np.float32))
    lw[1, 17] = lw[1].max()          # a tie at the max: the first wins
    poses = _t(rng.uniform(-3, 3, (3, 300, 3)).astype(np.float32))
    one = fusions.weights_plain(lw, poses, resample_fraction=0.5)
    for i in range(3):
        alone = fusions.weights_plain(lw[i], poses[i], resample_fraction=0.5)
        for f in ("max", "total", "best_index", "best_pose", "neff",
                  "weighted", "gate"):
            assert torch.equal(getattr(one, f)[i], getattr(alone, f)), f
    assert one.integ_pose is None and one.recov is None


@pytest.mark.parametrize("robots", [1, 2])
@pytest.mark.parametrize("rows", [1, 2, 1023, 1024])
def test_weights_plan_covers_each_row_once(rows, robots):
    """F7's launches as csrc/fusions.cu works them, for a robot's weights
    filling `rows` rows, the last whole or ragged: a block (b, r) of ROW /
    SEG threads, thread t the segment b ROW + t SEG + j, j < SEG, so each
    weight is in one row; the rows' partials (argmax values, sums, four
    moments; argmax indices, then two tickets a robot) at their own
    places in weights_plan's scratch."""
    threads = tres.ROW // tres.SEG
    for p in {(rows - 1) * tres.ROW + 1, rows * tres.ROW}:
        plan = fusions.weights_plan(robots, p)
        nb = -(-p // tres.ROW)
        assert nb == rows and nb <= 2 ** 31 - 1 and robots <= 65535
        b, t, j = np.meshgrid(np.arange(nb), np.arange(threads),
                              np.arange(tres.SEG), indexing="ij")
        i = (b * tres.ROW + t * tres.SEG + j).ravel()
        assert (np.bincount(i[i < p], minlength=p) == 1).all()
        if nb == 1:
            continue
        rn = robots * nb
        r, b = np.meshgrid(np.arange(robots), np.arange(nb), indexing="ij")
        c = np.arange(4)[:, None, None]
        floats = np.concatenate([(r * nb + b).ravel(),
                                 (rn + r * nb + b).ravel(),
                                 (2 * rn + r * 4 * nb + c * nb + b).ravel()])
        ints = np.concatenate([(r * nb + b).ravel(),
                               rn + 2 * np.arange(robots),
                               rn + 2 * np.arange(robots) + 1])
        for used, size in ((floats, plan.scratch_floats),
                           (ints, plan.scratch_ints)):
            assert used.min() >= 0 and used.max() < size
            assert (np.bincount(used) <= 1).all()
    with pytest.raises(ValueError):
        fusions.weights_plan(robots, tres.ROW * tres.ROW + 1)


def test_epilogue_matches_jax(card_order):
    """F7's epilogue: the gate, the integration pose and the recovery EMAs
    with p_inject, against JAX's integration_pose and recovery_update."""
    rng = np.random.default_rng(50)
    jcfg = JSlamConfig(num_particles=200).with_overrides(
        {"matcher.surface_reinject_slow": 0.05,
         "matcher.surface_reinject_fast": 0.6})
    for step, recov, scale in ((0, [0.0, 0.0], 3.0), (4, [-1.0, -9.0], 0.05),
                               (7, [-52.0, -51.0], 3.0)):
        lw = rng.normal(-50, scale, 200).astype(np.float32)
        poses = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
        tail = fusions.weights_plain(
            _t(lw), _t(poses), resample_fraction=0.5,
            recov=torch.tensor(recov, dtype=torch.float32),
            step=torch.tensor(step, dtype=torch.int32), reinject=(0.05, 0.6))
        jst = js.SharedMapSLAM(jcfg).init(jax.random.key(0)).replace(
            step=jnp.asarray(step, jnp.int32),
            recov=jnp.asarray(recov, jnp.float32))
        jr, jp = js.recovery_update(jcfg, jst, jnp.max(jnp.asarray(lw)))
        np.testing.assert_allclose(tail.recov.numpy(), np.asarray(jr),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tail.p_inject), float(jp),
                                   rtol=1e-6, atol=1e-7)
        jn = jres.neff(jnp.asarray(lw))
        want = js.integration_pose(
            jn, 200, jres.weighted_mean_pose(jnp.asarray(poses),
                                             jnp.asarray(lw)),
            jnp.asarray(poses[int(jnp.argmax(jnp.asarray(lw)))]))
        np.testing.assert_allclose(tail.integ_pose.numpy(), np.asarray(want),
                                   atol=1e-6)
        assert bool(tail.gate) == bool((jn < 100) | (jp > 0.05))


# ------------------------------------------------ whole steps, card's orders
@pytest.fixture(scope="module")
def small_log():
    return simulate_log(default_world(), square_path_controls(8),
                        params=SimParams(beams_per_rev=90), seed=7)


def _rbpf_draws(key, p):
    """gridmap_slam_tpu RBPF.step's draws for state key `key`
    (tests/test_torch_rbpf.py)."""
    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jax.vmap(normals)(jax.random.split(k_motion, p))
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    return n, u0, k_resample


@pytest.mark.parametrize("resample_fraction", [0.5, 1.0])
def test_rbpf_step_in_card_order_matches_jax(small_log, resample_fraction,
                                             card_order):
    """tests/test_torch_rbpf.py's step parity with the card's orders: one
    step from the same JAX state and draws, 3 successive states."""
    frames, _ = small_log
    jcfg = JSlamConfig(num_particles=8, max_beams=96, particle_chunk=4,
                       resample_fraction=resample_fraction,
                       map=JMapConfig(width_m=3.0, height_m=3.0,
                                      origin=(-1.5, -1.5)))
    jeng = JRBPF(jcfg)
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step)
    jstate = jeng.init(jax.random.key(0))
    for i in range(3):
        state = state_from_jax_arrays(
            np.asarray(jstate.poses), np.asarray(jstate.log_weights),
            np.asarray(jstate.logodds), np.asarray(jstate.step))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        n, u0, _ = _rbpf_draws(jstate.key, 8)
        nxt, info = eng.step(state, frame_at(batch, i),
                             draws=(_t(n), torch.tensor(float(u0))))
        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        lo_j = np.asarray(jnext.logodds)
        assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        assert bool(info.resampled) == bool(jinfo.resampled)
        assert int(info.best_index) == int(jinfo.best_index)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        jstate = jnext


def _surface_config(case):
    """tests/test_torch_shared.py's small surface configuration: 6 x 6 m at
    10 cm, 9 theta bins; "resample" resamples every scan, "inject" sets the
    recovery injection."""
    over = {"matcher.surface_nt": 9}
    if case == "resample":
        over["matcher.surface_resample_fraction"] = 1.0
    if case == "inject":
        over.update({"matcher.surface_reinject_slow": 0.05,
                     "matcher.surface_reinject_fast": 0.6})
    return JSlamConfig(num_particles=64, max_beams=96,
                       sensor=JSensorConfig(max_range=4.0),
                       map=JMapConfig(width_m=6.0, height_m=6.0,
                                      resolution=0.1, origin=(-3.0, -3.0))
                       ).with_overrides(over)


@pytest.mark.parametrize("case", ["resample", "inject"])
def test_surface_step_in_card_order_matches_jax(small_log, case,
                                                card_order):
    """tests/test_torch_shared.py's surface step parity with the card's
    orders (the volume's center, the tail and its epilogue, the walk)."""
    frames, _ = small_log
    p = 64
    jcfg = _surface_config(case)
    jeng = js.SharedMapSLAM(jcfg)
    eng = SharedMapSLAM(config_from_jax(jcfg), device="cpu")
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    jstep = jax.jit(jeng.step_surface)
    jstate = jeng.init(jax.random.key(0))
    inject = case == "inject"
    for i in range(3):
        if inject and i > 0:             # a collapsed fast EMA
            jstate = jstate.replace(recov=jnp.asarray([0.0, -5.0]))
        state = shared_state_from_jax_arrays(
            *(np.asarray(x) for x in (jstate.poses, jstate.log_weights,
                                      jstate.logodds, jstate.step,
                                      jstate.recov)))
        jnext, jinfo = jstep(jstate, j_frame_at(jbatch, i))
        n, u0, k_resample = _rbpf_draws(jstate.key, p)
        u = (_t(jax.random.uniform(jax.random.fold_in(k_resample, 1),
                                   (p, 3))) if inject else None)
        nxt, info = eng.step_surface(
            state, frame_at(batch, i),
            draws=(_t(n), torch.tensor(float(u0)), u))
        np.testing.assert_allclose(nxt.poses.numpy(), np.asarray(jnext.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(nxt.log_weights.numpy(),
                                   np.asarray(jnext.log_weights), atol=1e-3)
        lo_j = np.asarray(jnext.logodds)
        assert (np.abs(nxt.logodds.numpy() - lo_j) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
        np.testing.assert_allclose(nxt.recov.numpy(), np.asarray(jnext.recov),
                                   atol=1e-4)
        np.testing.assert_allclose(float(info.neff), float(jinfo.neff),
                                   rtol=1e-4)
        np.testing.assert_allclose(info.weighted_pose.numpy(),
                                   np.asarray(jinfo.weighted_pose), atol=1e-4)
        if i > 0:
            assert bool(info.resampled) and bool(jinfo.resampled)
        jstate = jnext


def test_rbpf_log_in_card_order_within_policy(small_log):
    """Whole runs with the card's orders: the port's RBPF on the small log
    under tests/test_torch_rbpf.py's ATE bound (0.25 m) and within 0.06 m
    of the JAX replay (docs/DIVERGENCES.md)."""
    frames, gt = small_log
    jcfg = JSlamConfig(num_particles=12, max_beams=96)
    jeng = JRBPF(jcfg)
    jbatch = j_frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    _, jinfo = jax.jit(jeng.replay)(jeng.init(jax.random.key(0)), jbatch)
    ate_j = ate_rmse(np.asarray(jinfo.weighted_pose), gt)
    eng = RBPF(config_from_jax(jcfg), device="cpu")
    batch = frames_to_device(frames, jcfg.max_beams, jcfg.sensor.max_range)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tres, "card_order", lambda x: True)
        _, infos = eng.run_log(eng.init(), [frame_at(batch, i)
                                            for i in range(len(frames))],
                               torch.Generator().manual_seed(0))
    traj = torch.stack([i.weighted_pose for i in infos]).numpy()
    assert np.isfinite(traj).all()
    ate_t = ate_rmse(traj, gt)
    assert ate_t < 0.25 and abs(ate_t - ate_j) <= 0.06, (ate_t, ate_j)
