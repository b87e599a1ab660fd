"""The distributed engines' weights tail on the CPU: F7's and F8's mesh
forms (ops/cuda/fusions.weights_mesh, walk_mesh), their plain versions held
to F7's and F8's single-device ones, to the JAX engines' statistics and to
numpy emulations of the kernels' passes.

- A world of one: the mesh form's plain version, its collectives the
  identity, equals weights_plain (and F8's walk) bit for bit, in the CPU's
  orders and in the card's (`card_order`, ops/resample's fixed orders run
  here), with and without the epilogue, the recovery EMAs and both windows;
  and each distributed engine at mesh (1, 1) in the card's orders gives its
  single-device engine's bits.
- n = 2 and 4 ranks, emulated in this process (a thread a rank, the
  collectives combining the ranks' tensors in rank order): the plain mesh
  form agrees with the JAX engines' shard_fn statistics (gridmap_slam_tpu/
  parallel/shmap.py:136-157, the center :94-103), run as jnp on the
  slices, within tests/test_torch_weights.py's tolerances (Neff within
  1e-4, the weighted pose within 1e-6; indices and poses exact).
- Numpy emulations of csrc/fusions.cu's mesh passes (rows of 1024 weights,
  a thread a segment of 8 added left to right, a row's 128 segment sums by
  the halving tree, the last block's tree over the rows' partials padded to
  a power of two; the first argmax in the kernels' total order) and of
  F8's slot window (the fixed-order scan over all P, the search of the
  window's slots alone) equal the plain version bit for bit, at sizes that
  straddle 1024 and the ranks' edges, with ties, NaN, -inf and +-0.
"""

import concurrent.futures
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu import SlamConfig as JSlamConfig
from gridmap_slam_tpu.models import shared as js
from gridmap_slam_tpu.ops.geometry import wrap_angle as j_wrap_angle
from gridmap_slam_tpu.ops.motion import apply_odometry as j_apply_odometry
from gridmap_slam_tpu.types import Odom as JOdom
from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig, SlamConfig
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models.shared import matcher_block_size
from gridmap_slam_tpu_torch.ops import resample as tres
from gridmap_slam_tpu_torch.ops.cuda import fusions
from gridmap_slam_tpu_torch.ops.geometry import wrap_angle
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from gridmap_slam_tpu_torch.types import Odom

torch.set_num_threads(1)

ATOL = 1e-6                     # tests/test_torch_weights.py
NEFF_ATOL = 1e-4
ROW, SEG = tres.ROW, tres.SEG
THREADS = ROW // SEG
CROP = fusions.WindowSpec(crop=(40, 40), full=(120, 150), resolution=0.05,
                          origin=(-3.0, -3.5))
VOLUME = fusions.WindowSpec(crop=(48, 48), full=(120, 150), resolution=0.05,
                            origin=(-3.0, -3.5), volume=True, radius=6,
                            ext=(60, 60), nt=7, t_off=-0.3, dtheta=0.1)
ODOM = Odom(torch.tensor(0.12), torch.tensor(-0.2))
REINJECT = (0.05, 0.6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def card_order(monkeypatch):
    """ops/resample's fixed orders (the card's) on the CPU."""
    monkeypatch.setattr(tres, "card_order", lambda x: True)


def _order(monkeypatch, order):
    if order == "card":
        monkeypatch.setattr(tres, "card_order", lambda x: True)


def _bits(x):
    """A tensor's bits, comparable with ==: float32 as int32."""
    x = x.detach()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def identity() -> fusions.Collectives:
    """The collectives of a world of one."""
    return fusions.Collectives(pmax=lambda x: x.clone(),
                               psum=lambda x: x.clone(),
                               all_gather=lambda x: x[None].clone())


class Ranks:
    """n ranks emulated in this process, a thread each, whose collectives
    combine the ranks' tensors in rank order (psum ((x0 + x1) + x2) ...),
    and keep what each rank handed them (`seen[rank]`: (kind, tensor))."""

    def __init__(self, n: int):
        self.n = n
        self.slots = [None] * n
        self.seen = [[] for _ in range(n)]
        self.barrier = threading.Barrier(n)

    def comm(self, rank: int) -> fusions.Collectives:
        def collective(kind):
            def call(x):
                self.seen[rank].append((kind, x.clone()))
                self.slots[rank] = x.clone()
                self.barrier.wait()
                xs = list(self.slots)
                self.barrier.wait()
                if kind == "all_gather":
                    return torch.stack(xs)
                out = xs[0]
                for y in xs[1:]:
                    out = torch.maximum(out, y) if kind == "pmax" else out + y
                return out
            return call
        return fusions.Collectives(*(collective(k) for k in
                                     ("pmax", "psum", "all_gather")))

    def run(self, fn):
        """[fn(rank, comm) for each rank], run together."""
        with concurrent.futures.ThreadPoolExecutor(self.n) as pool:
            futures = [pool.submit(fn, r, self.comm(r))
                       for r in range(self.n)]
            return [f.result(timeout=120) for f in futures]


def _inputs(seed, n, scale=3.0):
    rng = np.random.default_rng(seed)
    lw = rng.normal(-50, scale, n).astype(np.float32)
    poses = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    return lw, poses


def _plant(lw, kind, rng):
    """Ties, NaN, -inf and +-0 planted in log-weights."""
    lw = lw.copy()
    n = len(lw)
    if kind == "ties":
        at = rng.choice(n, size=min(n, 5), replace=False)
        lw[at] = lw.max() + 1.0
        lw[-1] = lw.max()
    elif kind == "nan":
        lw[rng.integers(n)] = np.nan
        if n > 3:
            lw[n // 2] = np.nan
    elif kind == "neginf":
        lw[rng.choice(n, size=max(n // 3, 1), replace=False)] = -np.inf
    elif kind == "zeros":
        lw[:] = np.where(rng.uniform(size=n) < 0.5, np.float32(0.0),
                         np.float32(-0.0))
    return lw


TAIL_CASES = {
    "stats": {},
    "epilogue": dict(resample_fraction=0.5),
    "recovery": dict(resample_fraction=0.5, reinject=REINJECT),
    "crop": dict(resample_fraction=0.5, window=CROP),
    "recovery_crop": dict(resample_fraction=0.5, reinject=REINJECT,
                          window=CROP),
}


def _tail_kw(case, step=3):
    kw = dict(TAIL_CASES[case])
    if "reinject" in kw:
        kw.update(recov=torch.tensor([-52.0, -51.0]),
                  step=torch.tensor(step, dtype=torch.int32))
    return kw


# ------------------------------------------------------------ a world of one
@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("case", sorted(TAIL_CASES))
@pytest.mark.parametrize("n", [1, 500, 1025, 5000])
def test_world_of_one_is_weights_plain(n, case, order, monkeypatch):
    """The mesh form's plain version on one rank (identity collectives)
    equals weights_plain in every output and every bit."""
    _order(monkeypatch, order)
    lw, poses = _inputs(100 + n, n)
    kw = _tail_kw(case, step=0 if n == 500 else 3)
    want = fusions.weights_plain(_t(lw), _t(poses), **kw)
    got = fusions.weights_mesh_plain(_t(lw), _t(poses), identity(), **kw)
    for f in fusions.Tail._fields:
        assert _same(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("n", [1, 700, 3000])
def test_world_of_one_center_is_weights_plain(n, order, monkeypatch):
    """The center call on one rank: weights_plain's weighted mean pose,
    max, total and the volume's Window, bit for bit."""
    _order(monkeypatch, order)
    lw, poses = _inputs(200 + n, n)
    want = fusions.weights_plain(_t(lw), _t(poses), window=VOLUME,
                                 odom=ODOM)
    got = fusions.weights_mesh_plain(_t(lw), _t(poses), identity(),
                                     center=True, window=VOLUME, odom=ODOM)
    for f in ("max", "total", "weighted"):
        assert _same(getattr(got, f), getattr(want, f)), f
    assert got.best_index is None and got.neff is None
    for f in fusions.Window._fields:
        assert _same(getattr(got.volume, f), getattr(want.volume, f)), f


@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("n", [5, 1024, 2500])
def test_world_of_one_walk_is_walk_plain(n, order, monkeypatch):
    """F8's mesh form over one rank's rows, every slot or a window of
    them, is walk_plain's walk (and its slice), with and without the
    log-weights."""
    _order(monkeypatch, order)
    lw, poses = _inputs(300 + n, n, scale=0.5)
    u0 = torch.tensor(0.37 / n, dtype=torch.float32)
    rows = torch.cat([_t(lw)[:, None], _t(poses)], 1)
    tail = fusions.weights_plain(_t(lw), _t(poses))
    want = fusions.walk_plain(_t(lw), u0, _t(poses), tail.max, tail.total)
    for base, count in ((0, n), (n // 3, n - n // 3), (n - 1, 1)):
        got = fusions.walk_mesh_plain(rows, u0, base=base, count=count)
        assert _same(got, tuple(t[base:base + count] for t in want))
        idx, gp, gl = fusions.walk_mesh_plain(rows, u0, base=base,
                                              count=count,
                                              gather_weights=False)
        assert gl is None and _same((idx, gp), (want[0][base:base + count],
                                                want[1][base:base + count]))


def test_mesh_form_refuses_what_it_does_not_place():
    lw, poses = _inputs(1, 50)
    for kw in (dict(center=True, resample_fraction=0.5),
               dict(center=True, window=CROP),
               dict(window=VOLUME, resample_fraction=0.5),
               dict(window=CROP),
               dict(recov=torch.zeros(2), step=torch.tensor(0))):
        with pytest.raises(ValueError):
            fusions.weights_mesh(_t(lw), _t(poses), identity(), **kw)


def test_mesh_entry_points_take_cpu_tensors_to_their_plain_versions():
    """The dispatchers run the plain versions on CPU tensors, launch
    nothing, and the kernels' entry points refuse CPU tensors."""
    lw, poses = _inputs(2, 300)
    rows = torch.cat([_t(lw)[:, None], _t(poses)], 1)
    u0 = torch.tensor(0.001)
    counts = (fusions.weights_mesh_launches, fusions.walk_mesh_launches)
    got = fusions.weights_mesh(_t(lw), _t(poses), identity(),
                               resample_fraction=0.5)
    want = fusions.weights_mesh_plain(_t(lw), _t(poses), identity(),
                                      resample_fraction=0.5)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert _same(fusions.walk_mesh(rows, u0, base=100, count=100),
                 fusions.walk_mesh_plain(rows, u0, base=100, count=100))
    assert (fusions.weights_mesh_launches,
            fusions.walk_mesh_launches) == counts
    with pytest.raises(ValueError, match="must be"):
        fusions.weights_mesh_cuda(_t(lw), _t(poses), identity())
    with pytest.raises(ValueError, match="must be"):
        fusions.walk_mesh_cuda(rows, u0, base=0, count=300)


class _OnCard:
    """Stands for a tensor on the card in the dispatchers' device test."""

    is_cuda = True


@pytest.mark.parametrize("walk", ["walk", "walk_mesh"])
def test_walks_take_a_draw_on_the_cpu_and_refuse_it_on_the_card(walk):
    """`draw` is the plain versions' (systematic_indices where None): the
    dispatchers pass it on for CPU tensors and refuse it for tensors on
    the card, whose kernels draw the ancestors themselves."""
    lw, poses = _inputs(3, 200)
    lw, poses = _t(lw), _t(poses)
    rows = torch.cat([lw[:, None], poses], 1)
    u0 = torch.tensor(0.002)
    calls = []

    def draw(*a):
        calls.append(1)
        return tres.systematic_indices(*a)

    if walk == "walk":
        m, total = lw.max(), torch.exp(lw - lw.max()).sum()
        run = lambda **kw: fusions.walk(lw, u0, poses, m, total, **kw)
        bad = lambda: fusions.walk(_OnCard(), u0, poses, m, total, draw=draw)
    else:
        run = lambda **kw: fusions.walk_mesh(rows, u0, base=50, count=100,
                                             **kw)
        bad = lambda: fusions.walk_mesh(_OnCard(), u0, base=0, count=1,
                                        draw=draw)
    assert _same(run(), run(draw=draw)) and calls == [1]
    with pytest.raises(ValueError, match="draw"):
        bad()
    assert calls == [1]


def test_signatures_bind_the_mesh_entries_of_fusions_cu():
    """_build.SIGNATURES binds the mesh forms' C entries with one type a
    parameter, and F7's and F8's single-device entries take no mesh
    parameter."""
    import re
    from pathlib import Path
    from gridmap_slam_tpu_torch.ops.cuda import _build

    src = (Path(_build.CSRC) / "fusions.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    for name in ("gs_fusion_weights_mesh", "gs_fusion_walk_mesh"):
        assert len(_build.SIGNATURES[name]) == len(
            entries[name].split(",")), name
    for name in ("gs_fusion_weights", "gs_fusion_walk"):
        assert "mesh" not in entries[name] and "base" not in entries[name]


# --------------------------------------------------------- engines at (1, 1)
def _mesh_config(p=16) -> SlamConfig:
    return SlamConfig(num_particles=p, max_beams=64,
                      map=MapConfig(width_m=4.0, height_m=4.0,
                                    resolution=0.05, origin=(-2.0, -2.0)))


def _surface_config(p=16, crop=48) -> SlamConfig:
    return SlamConfig(
        num_particles=p, max_beams=96, sensor=SensorConfig(max_range=4.0),
        map=MapConfig(width_m=12.8, height_m=8.0, resolution=0.1,
                      origin=(-6.4, -4.0))).with_overrides(
        {"matcher.surface_nt": 7, "matcher.surface_crop_cells": crop})


# gates at 0.99 of P, so that most scans resample
_GATE = {"resample_fraction": 0.99, "matcher.surface_resample_fraction": 0.99}
ENGINES = {
    "shmap": _mesh_config().with_overrides(_GATE),
    "shmap_surface": _surface_config().with_overrides(_GATE),
    "shmap_surface_inject": _surface_config().with_overrides(
        {**_GATE, "matcher.surface_reinject_slow": 0.05,
         "matcher.surface_reinject_fast": 0.6}),
    "surface_sharded": _surface_config().with_overrides(_GATE),
    "sharded": _mesh_config(8).with_overrides(_GATE),
    "sharded_accumulate": _mesh_config(8).with_overrides(_GATE).replace(
        accumulate_weights=True),
}


@pytest.fixture(scope="module")
def world():
    pmesh.init_world("cpu")
    return pmesh.make_mesh(device="cpu")


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engines_at_mesh_1x1_in_card_order_give_single_device_bits(
        world, kind, card_order):
    """Each distributed engine at mesh (1, 1), its tail on F7's and F8's
    mesh forms, gives its single-device engine's bits in the card's
    orders, resampling scans among them."""
    from gridmap_slam_tpu_torch.parallel.sharded import make_sharded_step
    from gridmap_slam_tpu_torch.parallel.shmap import make_shmap_step
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        make_surface_sharded_step)

    cfg = ENGINES[kind]
    frames, _ = simulate_log(default_world(), square_path_controls(4),
                             params=SimParams(
                                 beams_per_rev=60 if cfg.max_beams == 64
                                 else 90), seed=2)
    batch = frames_to_device(frames[:4], cfg.max_beams, cfg.sensor.max_range)
    seq = [frame_at(batch, i) for i in range(4)]
    if kind.startswith("sharded"):
        eng = RBPF(cfg, device="cpu")
        step, ref = make_sharded_step(eng, world), eng.step
    else:
        eng = SharedMapSLAM(cfg, device="cpu")
        if kind == "shmap":
            step = make_shmap_step(eng, world)
            block = matcher_block_size(cfg)

            def ref(s, f, g):
                return eng.step_blocked(s, f, block, g)
        else:
            step = (make_surface_sharded_step(eng, world)
                    if kind == "surface_sharded"
                    else make_shmap_step(eng, world, surface=True))
            ref = eng.step_surface
    a = b = eng.init()
    fired = 0
    for i, f in enumerate(seq):
        a, ia = ref(a, f, torch.Generator().manual_seed(i))
        b, ib = step(b, f, torch.Generator().manual_seed(i))
        fired += int(ia.resampled)
        if kind.startswith("sharded"):
            # K1's tile plain version takes the kernel's coordinate order,
            # the untiled one the JAX package's (tests/test_torch_parallel.
            # py's world of one): within its tolerances here, the bits on
            # the card (chip_smoke.py's parallel phase)
            for k in ("poses", "logodds"):
                np.testing.assert_allclose(getattr(b, k).numpy(),
                                           getattr(a, k).numpy(), atol=1e-4)
            np.testing.assert_allclose(ib.weighted_pose.numpy(),
                                       ia.weighted_pose.numpy(), atol=1e-4)
            np.testing.assert_allclose(float(ib.neff), float(ia.neff),
                                       rtol=1e-5, atol=1e-5)
            assert bool(ib.resampled) == bool(ia.resampled)
            continue
        for k in ("poses", "log_weights", "logodds", "step"):
            assert _same(getattr(a, k), getattr(b, k)), (i, k)
        for k in ("neff", "weighted_pose", "best_pose", "best_index",
                  "best_log_weight", "resampled"):
            assert _same(getattr(ia, k), getattr(ib, k)), (i, k)
    assert fired > 0


# -------------------------------------------------------- n ranks, and JAX
def _slices(n_ranks, x):
    p = x.shape[0] // n_ranks
    return [x[r * p:(r + 1) * p] for r in range(n_ranks)]


def _jax_stats(lw, poses, n_ranks, cfg, recov, step, rf):
    """The JAX engines' shard_fn statistics (parallel/shmap.py:136-157) on
    n_ranks slices, the collectives combined in rank order, as jnp."""
    lws = [jnp.asarray(x) for x in _slices(n_ranks, lw)]
    ps = [jnp.asarray(x) for x in _slices(n_ranks, poses)]
    p_loc = lws[0].shape[0]
    m = jnp.max(jnp.stack([jnp.max(x) for x in lws]))
    es = [jnp.exp(x - m) for x in lws]
    z = es[0].sum()
    for e in es[1:]:
        z = z + e.sum()
    ws = [e / z for e in es]
    s2 = sum(jnp.sum(w * w) for w in ws)
    n_eff = 1.0 / s2
    weighted = sum(jnp.stack([jnp.sum(q[:, 0] * w), jnp.sum(q[:, 1] * w),
                              jnp.sum(j_wrap_angle(q[:, 2]) * w)])
                   for q, w in zip(ps, ws))
    li = [int(jnp.argmax(x)) for x in lws]
    cand = jnp.stack([jnp.concatenate([x[i][None], q[i]])
                      for x, q, i in zip(lws, ps, li)])
    g = int(jnp.argmax(cand[:, 0]))
    best_index = g * p_loc + li[g]
    best_pose = cand[g, 1:]
    p = n_ranks * p_loc
    integ = js.integration_pose(n_eff, p, weighted, best_pose)
    jst = js.SharedMapSLAM(cfg).init(jax_key()).replace(
        step=jnp.asarray(step, jnp.int32),
        recov=jnp.asarray(recov, jnp.float32))
    jr, jp = js.recovery_update(cfg, jst, m)
    gate = (n_eff < p * rf) | (jp > 0.05)
    return dict(max=m, total=z, neff=n_eff, weighted=weighted,
                best_index=best_index, best_pose=best_pose, integ=integ,
                recov=jr, p_inject=jp, gate=gate)


def jax_key():
    import jax
    return jax.random.key(0)


def _check_against_jax(got, want):
    assert abs(float(got.neff) - float(want["neff"])) < NEFF_ATOL
    np.testing.assert_allclose(got.weighted.numpy(),
                               np.asarray(want["weighted"]), atol=ATOL)
    np.testing.assert_allclose(float(got.max), float(want["max"]), rtol=0,
                               atol=0)
    np.testing.assert_allclose(float(got.total), float(want["total"]),
                               rtol=1e-5)
    assert int(got.best_index) == want["best_index"]
    np.testing.assert_array_equal(got.best_pose.numpy(),
                                  np.asarray(want["best_pose"]))
    np.testing.assert_allclose(got.integ_pose.numpy(),
                               np.asarray(want["integ"]), atol=ATOL)
    np.testing.assert_allclose(got.recov.numpy(), np.asarray(want["recov"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got.p_inject), float(want["p_inject"]),
                               rtol=1e-6, atol=1e-7)
    assert bool(got.gate) == bool(want["gate"])


@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("p", [16, 2048, 4100])
def test_n_ranks_match_jax_shard_statistics(p, n_ranks, order, monkeypatch):
    """The plain mesh form on n emulated ranks: every rank holds the JAX
    engines' global statistics of the whole cloud, the same on each."""
    _order(monkeypatch, order)
    lw, poses = _inputs(400 + p + n_ranks, p)
    lw[p // n_ranks + 3] = lw.max() + 0.5        # the best on rank 1
    jcfg = JSlamConfig(num_particles=p).with_overrides(
        {"matcher.surface_reinject_slow": REINJECT[0],
         "matcher.surface_reinject_fast": REINJECT[1]})
    recov, step = [-51.0, -49.5], 4
    kw = dict(resample_fraction=0.5, recov=torch.tensor(recov),
              step=torch.tensor(step, dtype=torch.int32), reinject=REINJECT,
              window=CROP)

    def rank(r, comm):
        return fusions.weights_mesh_plain(
            _slices(n_ranks, _t(lw))[r], _slices(n_ranks, _t(poses))[r],
            comm, **kw)

    outs = Ranks(n_ranks).run(rank)
    want = _jax_stats(lw, poses, n_ranks, jcfg, recov, step, 0.5)
    for got in outs:
        _check_against_jax(got, want)
        assert int(got.best_index) == p // n_ranks + 3
        for f in fusions.Tail._fields:
            assert _same(getattr(got, f), getattr(outs[0], f)), f


@pytest.mark.parametrize("order", ["cpu", "card"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_n_ranks_center_matches_jax(n_ranks, order, monkeypatch):
    """The center call on n emulated ranks against the JAX engines' volume
    center (parallel/shmap.py:94-103): the weighted mean of the previous
    cloud over every rank, propagated by the odometry."""
    _order(monkeypatch, order)
    p = 3000
    lw, poses = _inputs(500 + n_ranks, p)

    def rank(r, comm):
        return fusions.weights_mesh_plain(
            _slices(n_ranks, _t(lw))[r], _slices(n_ranks, _t(poses))[r],
            comm, center=True, window=VOLUME, odom=ODOM)

    outs = Ranks(n_ranks).run(rank)
    lws = [jnp.asarray(x) for x in _slices(n_ranks, lw)]
    ps = [jnp.asarray(x) for x in _slices(n_ranks, poses)]
    m0 = jnp.max(jnp.stack([jnp.max(x) for x in lws]))
    es = [jnp.exp(x - m0) for x in lws]
    z0 = sum(e.sum() for e in es)
    mean = sum(jnp.stack([jnp.sum(q[:, 0] * (e / z0)),
                          jnp.sum(q[:, 1] * (e / z0)),
                          jnp.sum(j_wrap_angle(q[:, 2]) * (e / z0))])
               for q, e in zip(ps, es))
    center = j_apply_odometry(mean, JOdom(jnp.float32(0.12),
                                          jnp.float32(-0.2)))
    for got in outs:
        np.testing.assert_allclose(got.weighted.numpy(), np.asarray(mean),
                                   atol=ATOL)
        np.testing.assert_allclose(got.volume.center.numpy(),
                                   np.asarray(center), atol=ATOL)
        for f in fusions.Window._fields:
            assert _same(getattr(got.volume, f), getattr(outs[0].volume, f))


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_n_ranks_walk_is_the_global_walk(n_ranks, card_order):
    """F8's mesh form on each rank's slots of the gathered rows: the
    ranks' slots together are the global systematic walk's."""
    p = 2052
    lw, poses = _inputs(600 + n_ranks, p, scale=0.5)
    rows = torch.cat([_t(lw)[:, None], _t(poses)], 1)
    u0 = torch.tensor(0.3 / p, dtype=torch.float32)
    want = fusions.walk_plain(_t(lw), u0, _t(poses), None, None)
    p_loc = p // n_ranks
    got = [fusions.walk_mesh_plain(rows, u0, base=r * p_loc, count=p_loc)
           for r in range(n_ranks)]
    for k in range(3):
        assert _same(torch.cat([g[k] for g in got]), want[k])


# ----------------------------------------- numpy emulations of the kernels
def _before(v, i, w, j) -> bool:
    """csrc/fusions.cu before(): (v, i) ahead of (w, j) in the argmax's
    order, a NaN first, then the larger value, then the smaller index; j <
    0 is no candidate."""
    if j < 0:
        return i >= 0
    if i < 0:
        return False
    vn, wn = np.isnan(v), np.isnan(w)
    if vn and wn:
        return i < j
    if vn != wn:
        return bool(vn)
    return bool(v > w) or (v == w and i < j)


def _emu_argmax(x):
    """Pass A: each thread's segment in index order, the block's and the
    rows' combines (any pairing: before() is a total order)."""
    n = len(x)
    rows = []
    for b in range(max(-(-n // ROW), 1)):
        best = (np.float32(0.0), -1)
        for t in range(THREADS):
            for j in range(SEG):
                k = b * ROW + t * SEG + j
                if k < n and _before(x[k], k, *best):
                    best = (x[k], k)
        rows.append(best)
    best = (np.float32(0.0), -1)
    for r in rows[::-1]:                    # the rows in any order
        if _before(*r, *best):
            best = r
    return best


def _halve(v):
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [np.float32(v[i] + v[i + h]) for i in range(h)]
    return v[0]


def _emu_sum(terms):
    """Pass B's and C's order: segments of 8 left to right, a row's 128
    segment sums halved, the rows' partials padded to a power of two and
    halved by the last block."""
    n = len(terms)
    nb = max(-(-n // ROW), 1)
    v = np.zeros(nb * ROW, np.float32)
    v[:n] = terms
    part = []
    for b in range(nb):
        segs = []
        for t in range(THREADS):
            acc = v[b * ROW + t * SEG]
            for j in range(1, SEG):
                acc = np.float32(acc + v[b * ROW + t * SEG + j])
            segs.append(acc)
        part.append(_halve(segs))
    q = 1 << (nb - 1).bit_length()
    return _halve(part + [np.float32(0.0)] * (q - nb))


def _emu_passes(lw, poses, m, total):
    """Passes A (the candidate), B (the rank's total at the ranks' max m)
    and C (the four moments at the ranks' total) of one rank."""
    v, i = _emu_argmax(lw)
    cand = np.asarray([v, *poses[i], np.float32(i)], np.float32)
    e = torch.exp(_t(lw) - torch.tensor(m)).numpy()
    tot = _emu_sum(e)
    if total is None:
        return cand, tot, None
    w = (e / np.float32(total)).astype(np.float32)
    th = wrap_angle(_t(poses[:, 2])).numpy()
    moments = [_emu_sum((w * w).astype(np.float32))] + [
        _emu_sum((q * w).astype(np.float32))
        for q in (poses[:, 0], poses[:, 1], th)]
    return cand, tot, np.asarray(moments, np.float32)


EDGE_SIZES = (1, 8, 1023, 1024, 1025, 2047, 2048, 3000)
EDGE_KINDS = ("plain", "ties", "nan", "neginf", "zeros")


@pytest.mark.parametrize("kind", EDGE_KINDS)
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
@pytest.mark.parametrize("p_loc", EDGE_SIZES)
def test_emulated_passes_equal_the_plain_version(p_loc, n_ranks, kind,
                                                 card_order):
    """What each rank hands its collectives in the plain mesh form (the
    candidate, its max, its total and its moments) equals the emulation of
    passes A, B and C bit for bit, at the ranks' reduced max and total."""
    rng = np.random.default_rng(p_loc * 10 + n_ranks)
    p = p_loc * n_ranks
    lw, poses = _inputs(700 + p, p)
    lw = _plant(lw, kind, rng) if kind != "plain" else lw
    ranks = Ranks(n_ranks)

    def rank(r, comm):
        return fusions.weights_mesh_plain(
            _slices(n_ranks, _t(lw))[r], _slices(n_ranks, _t(poses))[r],
            comm, resample_fraction=0.5)

    outs = ranks.run(rank)
    m, total = outs[0].max, outs[0].total
    for r in range(n_ranks):
        seen = dict(ranks.seen[r][k] for k in range(4))
        kinds = [k for k, _ in ranks.seen[r]]
        assert kinds == ["pmax", "psum", "psum", "all_gather"]
        cand, tot, moments = _emu_passes(
            _slices(n_ranks, lw)[r], _slices(n_ranks, poses)[r],
            m.numpy(), total.numpy())
        got_tot, got_moments = ranks.seen[r][1][1], ranks.seen[r][2][1]
        assert _same(seen["pmax"], _t(cand[0]))
        assert _same(seen["all_gather"], _t(cand))
        assert _same(got_tot, _t(tot))
        assert _same(got_moments, _t(moments))


def _emu_scan(w):
    """F8's scan of the normalized weights in the fixed order: segments
    left to right, a row's segment totals by a Hillis-Steele scan and their
    carry, then the rows' totals by the same scan and their carry."""
    def hillis_steele(t):
        t, k = list(t), 1
        while k < len(t):
            t = t[:k] + [np.float32(t[i] + t[i - k])
                         for i in range(k, len(t))]
            k *= 2
        return t

    n = len(w)
    nb = max(-(-n // ROW), 1)
    v = np.zeros(nb * ROW, np.float32)
    v[:n] = w
    rows = []
    for b in range(nb):
        segs = []
        for t in range(THREADS):
            c = [v[b * ROW + t * SEG]]
            for j in range(1, SEG):
                c.append(np.float32(c[-1] + v[b * ROW + t * SEG + j]))
            segs.append(c)
        carry = hillis_steele([s[-1] for s in segs])
        row = segs[0] + [np.float32(x + carry[t - 1]) for t in
                         range(1, THREADS) for x in segs[t]]
        rows.append(row)
    carry = hillis_steele([r[-1] for r in rows])
    out = rows[0] + [np.float32(x + carry[b - 1]) for b in range(1, nb)
                     for x in rows[b]]
    return np.asarray(out[:n], np.float32)


@pytest.mark.parametrize("kind", ["plain", "ties", "zeros"])
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
@pytest.mark.parametrize("p", [8, 1024, 1028, 2056])
def test_emulated_slot_window_equals_the_plain_walk(p, n_ranks, kind,
                                                    card_order):
    """F8's mesh form emulated: F7's passes A and B over every gathered
    row, the fixed-order scan of all P, then each rank's slots alone by
    the left binary search of u = u0 + j / P (j the global slot), clamped;
    equal to walk_mesh_plain bit for bit."""
    rng = np.random.default_rng(p + n_ranks)
    lw, poses = _inputs(800 + p, p, scale=0.5)
    if kind == "ties":                  # equal weights: u == cum ties
        lw[:] = np.float32(-3.0)
    elif kind == "zeros":
        lw = _plant(lw, "zeros", rng)
    rows = torch.cat([_t(lw)[:, None], _t(poses)], 1)
    u0 = np.float32(rng.uniform(0, 1.0 / p)) if kind != "ties" \
        else np.float32(0.0)
    v, _ = _emu_argmax(lw)
    e = torch.exp(_t(lw) - torch.tensor(v)).numpy()
    w = (e / _emu_sum(e)).astype(np.float32)
    cum = _emu_scan(w)
    p_loc = p // n_ranks
    for r in range(n_ranks):
        j = np.arange(r * p_loc, (r + 1) * p_loc)
        u = (np.float32(u0) + (j.astype(np.float32) / np.float32(p))
             .astype(np.float32)).astype(np.float32)
        want = np.clip(np.searchsorted(cum, u, side="left"), 0, p - 1)
        idx, gp, gl = fusions.walk_mesh_plain(
            rows, torch.tensor(u0), base=r * p_loc, count=p_loc)
        np.testing.assert_array_equal(idx.numpy(), want)
        assert _same(gp, _t(poses[want]))
        assert _same(gl, _t(lw[want]))
