"""The port's pose graph (models/posegraph.py), held to the JAX package's on
the CPU: residuals, Gauss-Newton, the closure proposals and the batched
two-way closure verifier.

Tolerances: residuals and Jacobians 1e-5 (the same float32 formulas);
Gauss-Newton nodes 1e-4 and chi2 rtol 1e-4 (the port assembles H = J^T W J
as a dense product where the JAX package scatter-adds, so the sums round
differently); closure poses 1e-4 and per-beam scores 1e-4 (the matcher's K1
tolerance divided by the beam count).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridmap_slam_tpu.config import MapConfig as JMapConfig
from gridmap_slam_tpu.config import SlamConfig as JSlamConfig
from gridmap_slam_tpu.models import posegraph as JPG
from gridmap_slam_tpu.ops.grid import gaussian_kernel
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu_torch.convert import (config_from_jax,
                                            posegraph_from_jax_arrays)
from gridmap_slam_tpu_torch.models import posegraph as PG
from gridmap_slam_tpu_torch.types import Scan

torch.set_num_threads(1)


def _graph(k=30, n_closures=6, seed=0):
    """A noisy loop of k keyframes: odometry edges from a drifted chain and
    closures between the loop's ends, as numpy arrays of both sides."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    truth = np.stack([2 * np.cos(t), 2 * np.sin(t), t + np.pi / 2], 1)
    noisy = truth + rng.normal(0, [0.05, 0.05, 0.03], truth.shape)
    ei, ej, ez, ew = JPG.odometry_edges(truth, 200.0, 400.0)
    ez = ez + rng.normal(0, 0.01, ez.shape).astype(np.float32)
    ci = np.arange(n_closures, dtype=np.int32)
    cj = (k - n_closures + ci).astype(np.int32)
    cz = np.stack([JPG._relative_np(truth[a], truth[b])
                   for a, b in zip(ci, cj)]).astype(np.float32)
    cw = np.tile(np.asarray([400.0, 400.0, 800.0], np.float32),
                 (n_closures, 1))
    return (noisy.astype(np.float32), np.concatenate([ei, ci]),
            np.concatenate([ej, cj]), np.concatenate([ez, cz]),
            np.concatenate([ew, cw]))


def test_odometry_edges_and_residuals_match():
    nodes, ei, ej, ez, ew = _graph()
    for a, b in zip(PG.odometry_edges(nodes.astype(np.float64)),
                    JPG.odometry_edges(nodes.astype(np.float64))):
        np.testing.assert_array_equal(a, b)
    want = JPG.residuals_and_jacobians(jnp.asarray(nodes), jnp.asarray(ei),
                                       jnp.asarray(ej), jnp.asarray(ez))
    got = PG.residuals_and_jacobians(
        torch.from_numpy(nodes), torch.from_numpy(ei).long(),
        torch.from_numpy(ej).long(), torch.from_numpy(ez))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("self_edge", [False, True])
def test_optimize_matches(self_edge):
    """10 Gauss-Newton iterations on both sides: chi2 falls the same way
    and the nodes agree.  A zero-weight self-edge (the padding the JAX
    distributed BA uses) changes nothing."""
    arrays = list(_graph())
    if self_edge:
        arrays[1] = np.append(arrays[1], np.int32(3))
        arrays[2] = np.append(arrays[2], np.int32(3))
        arrays[3] = np.vstack([arrays[3], np.zeros((1, 3), np.float32)])
        arrays[4] = np.vstack([arrays[4], np.zeros((1, 3), np.float32)])
    jg = JPG.PoseGraph(*(jnp.asarray(a) for a in arrays))
    jopt, jchi = jax.jit(lambda g: JPG.optimize(g, iterations=10))(jg)
    opt, chi = PG.optimize(posegraph_from_jax_arrays(*arrays), iterations=10)
    assert opt.edge_i.dtype == torch.int64
    np.testing.assert_allclose(chi.numpy(), np.asarray(jchi), rtol=1e-4)
    assert float(chi[-1]) < 0.1 * float(chi[0])
    np.testing.assert_allclose(opt.nodes.numpy(), np.asarray(jopt.nodes),
                               atol=1e-4)


def test_gauss_newton_is_deterministic_and_nan_when_singular():
    """The dense assembly gives the same bits on a rerun; a system that is
    not positive definite gives NaN poses (the JAX solve's answer), not an
    exception."""
    g = posegraph_from_jax_arrays(*_graph(seed=1))
    a, ca = PG.gauss_newton_step(g)
    b, cb = PG.gauss_newton_step(g)
    assert torch.equal(a.nodes, b.nodes) and torch.equal(ca, cb)
    bad = dataclasses.replace(g, edge_w=-g.edge_w)
    nan, _ = PG.gauss_newton_step(bad, anchor_w=-1e6)
    assert torch.isnan(nan.nodes).all()


def test_propose_closures_match():
    rng = np.random.default_rng(4)
    poses = np.cumsum(rng.normal(0, 0.3, (60, 3)), 0)
    for kw in (dict(min_gap=5, max_dist=1.5, max_candidates=500),
               dict(min_gap=8, max_dist=2.0, max_candidates=16)):
        want = JPG.propose_closures(poses, **kw).pairs
        got = PG.propose_closures(poses, **kw).pairs
        assert len(got) > 5
        np.testing.assert_array_equal(got, want)


def _closure_scans(c, seed=0):
    """c pairs of scans of one room seen from two nearby poses, and the
    odometry guesses between them."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, 80, endpoint=False)
    room = lambda a: np.minimum(1.6 / np.maximum(np.abs(np.cos(a)), 1e-3),
                                1.2 / np.maximum(np.abs(np.sin(a)), 1e-3))
    out = {k: [] for k in ("ji", "jj", "ti", "tj")}
    guesses = []
    for k in range(c):
        d = rng.uniform(-0.15, 0.15, 3)
        d[2] *= 0.5
        for tag, shift in (("i", np.zeros(3)), ("j", d)):
            a = ang + shift[2]
            dist = np.clip(room(a) - shift[0] * np.cos(a)
                           - shift[1] * np.sin(a), 0.2, 3.9)
            hit = dist < 3.8
            out["j" + tag].append(JScan.from_arrays(ang, dist, hit, 96, 4.0))
            out["t" + tag].append(Scan.from_arrays(ang, dist, hit, 96, 4.0))
        guesses.append(d + rng.normal(0, [0.05, 0.05, 0.03]))
    stack_j = lambda xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)
    stack_t = lambda xs: Scan(*(torch.stack([getattr(s, f.name) for s in xs])
                                for f in dataclasses.fields(Scan)))
    return (stack_j(out["ji"]), stack_j(out["jj"]), stack_t(out["ti"]),
            stack_t(out["tj"]), np.asarray(guesses, np.float32))


def test_verify_closure_bidirectional_matches():
    """Six candidates in one batch (K2 with cone fill, K3 and K1 at batch 6,
    each direction) against the JAX verifier vmapped over the same
    candidates, with the frontend's closure matcher on a 100 x 80-cell
    map."""
    jcfg = JSlamConfig(map=JMapConfig(width_m=5.0, height_m=4.0,
                                      resolution=0.05, origin=(-2.5, -2.0)))
    mc = dataclasses.replace(jcfg.matcher, window_xy=0.3,
                             window_theta_deg=15.0, coarse_nxy=11,
                             coarse_nt=9, extra_refine_stages=2,
                             prior_weight=0.0, impl="gather")
    ji, jj, ti, tj, guesses = _closure_scans(6)
    k = gaussian_kernel(jcfg.map.likelihood_sigma, jcfg.map.likelihood_radius)
    kw = dict(map_cfg=jcfg.map, matcher_cfg=mc, motion_cfg=jcfg.motion,
              sensor_cfg=jcfg.sensor, beam_lut_bins=jcfg.beam_lut_bins)
    want = jax.jit(jax.vmap(lambda a, b, g: JPG.verify_closure_bidirectional(
        a, b, g, kernel=k, **kw)))(ji, jj, jnp.asarray(guesses))
    tcfg = config_from_jax(jcfg)
    got = PG.verify_closure_bidirectional(
        ti, tj, torch.from_numpy(guesses), taps=torch.from_numpy(k),
        **dict(kw, map_cfg=tcfg.map, matcher_cfg=dataclasses.replace(
            tcfg.matcher, **{f: getattr(mc, f) for f in (
                "window_xy", "window_theta_deg", "coarse_nxy", "coarse_nt",
                "extra_refine_stages", "prior_weight", "impl")}),
               motion_cfg=tcfg.motion, sensor_cfg=tcfg.sensor))
    rel, score, consist = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), rel, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), score, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), consist, atol=1e-4)
    assert (score > -1.25).sum() >= 3          # real closures among them


def test_f32_matmul_sets_and_restores_the_tf32_flag():
    """Gauss-Newton's products run under ops.precision.f32_matmul: TF32
    off inside the block, the caller's flag back after it, also after an
    exception."""
    from gridmap_slam_tpu_torch.ops.precision import f32_matmul
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    try:
        flags.allow_tf32 = True
        with f32_matmul():
            assert flags.allow_tf32 is False
        assert flags.allow_tf32 is True
        with pytest.raises(RuntimeError):
            with f32_matmul():
                raise RuntimeError("inside")
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = prev
