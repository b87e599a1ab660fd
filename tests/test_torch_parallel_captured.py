"""The distributed engines' compiled steps (jit=True) on the CPU, at a world
of one (gloo, in this process): each engine's compiled step, its compiled
replay and the compiled distributed optimizer against their eager forms.

On the CPU a compiled step is the static-buffer body that the card
captures as one CUDA graph (models/captured.Captured calls the body where
the card replays the graph), so these tests hold that body: the eager
step's bits in every state and info field, scan by scan, over a log with
resampling and quiet scans, and the static buffer's life (the state a
compiled step returns is the capture's buffer, overwritten by the next
call).  The compiled forms at 2 and 4 ranks, where the resample decision
moves to the card, are held in tests/test_torch_parallel.py,
tests/test_torch_tiled.py and tests/test_torch_ba.py, which launch their
ranks once a rank count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.models.captured import stack_steps
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_parallel import (log_frames, matcher_config,
                                       surface_config)

torch.set_num_threads(1)

SCANS = 6
STATE = ("poses", "log_weights", "logodds", "step")
INFO = ("neff", "weighted_pose", "best_pose", "best_index",
        "best_log_weight", "resampled")


@pytest.fixture(scope="module")
def world():
    pmesh.init_world("cpu")
    return pmesh.make_mesh(device="cpu")


def _config(kind):
    """A small config of each engine whose 6 scans hold resampling and
    quiet scans."""
    if kind in ("shmap_surface", "surface_sharded"):
        return surface_config().with_overrides(
            {"matcher.surface_resample_fraction": 0.3})
    return matcher_config(8 if kind == "sharded" else 16).replace(
        resample_fraction=0.85 if kind == "sharded" else 0.975)


def _make(kind, eng, mesh, jit):
    from gridmap_slam_tpu_torch.parallel.sharded import make_sharded_step
    from gridmap_slam_tpu_torch.parallel.shmap import make_shmap_step
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        make_surface_sharded_step)
    from gridmap_slam_tpu_torch.parallel.tiled import make_tiled_step

    if kind in ("shmap", "shmap_surface"):
        return make_shmap_step(eng, mesh, kind == "shmap_surface", jit)
    return {"tiled": make_tiled_step, "sharded": make_sharded_step,
            "surface_sharded": make_surface_sharded_step}[kind](
        eng, mesh, jit)


def _setup(kind):
    cfg = _config(kind)
    eng = (RBPF if kind == "sharded" else SharedMapSLAM)(cfg, device="cpu")
    raw = log_frames(cfg, revs=SCANS,
                     beams=60 if cfg.max_beams == 64 else 90)
    batch = frames_to_device(raw, cfg.max_beams, cfg.sensor.max_range)
    return eng, batch, [frame_at(batch, i) for i in range(SCANS)]


def _assert_equal(a, b, fields):
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k


KINDS = ["shmap", "shmap_surface", "tiled", "surface_sharded", "sharded"]


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_step_gives_the_eager_bits(world, kind):
    eng, _, frames = _setup(kind)
    eager = _make(kind, eng, world, jit=False)
    compiled = _make(kind, eng, world, jit=True)
    a = b = eng.init()
    gen_a, gen_b = torch.Generator().manual_seed(4), \
        torch.Generator().manual_seed(4)
    resampled = []
    for f in frames:
        a, ia = eager(a, f, gen_a)
        b, ib = compiled(b, f, gen_b)
        assert b is compiled.captured.state      # the static buffer
        _assert_equal(a, b, STATE)
        _assert_equal(ia, ib, INFO)
        resampled.append(bool(ia.resampled))
    assert any(resampled) and not all(resampled), resampled
    assert compiled.captured.captures == 0          # no graph on the CPU
    # the next call overwrites the returned state; a clone keeps it
    kept = dataclasses.replace(b, **{k: getattr(b, k).clone()
                                     for k in STATE})
    c, _ = compiled(b, frames[0], torch.Generator().manual_seed(9))
    assert c is b and not torch.equal(c.poses, kept.poses)
    _assert_equal(kept, a, STATE)


@pytest.mark.parametrize("kind", KINDS)
def test_compiled_replay_gives_the_eager_replay_bits(world, kind):
    eng, batch, _ = _setup(kind)
    step = _make(kind, eng, world, jit=False)
    st_e, inf_e = step.replay(eng.init(), batch,
                              torch.Generator().manual_seed(1))
    replay = step.replay_jit()
    st_c, inf_c = replay(eng.init(), batch, torch.Generator().manual_seed(1))
    _assert_equal(st_e, st_c, STATE)
    _assert_equal(inf_e, inf_c, INFO)
    assert inf_c.weighted_pose.shape == (SCANS, 3)
    assert st_c is not replay.captured.state          # a copy of it
    # the eager replay is the eager step scan by scan
    st, infos = eng.init(), []
    gen = torch.Generator().manual_seed(1)
    for i in range(SCANS):
        st, info = step(st, frame_at(batch, i), gen)
        infos.append(info)
    _assert_equal(st, st_e, STATE)
    _assert_equal(stack_steps(infos), inf_e, INFO)


def test_sharded_body_writes_into_the_state_at_mesh_one(world):
    """At mesh (1, 1) the compiled sharded body with out=state (what the
    graph runs on its static buffer) keeps the state's map storage, gives
    the eager sharded step's bits and RBPF.step's results on the same
    draws, scan by scan, over resampling and quiet scans: its chunks' maps
    are written into one tensor and moved once, at the gate's indices.
    Against RBPF.step within tests/test_torch_parallel.py's single-device
    tolerances, as its world-of-one test holds the sharded step: K1's tile
    plain version takes another float order than the untiled one (on the
    card the two kernels give the same bits, chip_smoke.py)."""
    from tests.test_torch_parallel import _host, check_against

    eng, _, frames = _setup("sharded")
    step = _make("sharded", eng, world, jit=True)
    eager = _make("sharded", eng, world, jit=False)
    ref, st, ea = eng.init(), eng.init(), eng.init()
    storage = st.logodds.data_ptr()
    gen = torch.Generator().manual_seed(4)
    resampled = []
    for f in frames:
        draws = eng._draws(gen)
        ref, ir = eng.step(ref, f, draws=draws)
        ea, ie = eager(ea, f, draws=draws)
        out, io = step._compiled(st, f, draws, st)
        assert out is st and st.logodds.data_ptr() == storage
        _assert_equal(ea, st, STATE)
        _assert_equal(ie, io, INFO)
        check_against(_host(st, io), _host(ref, ir), jax_ref=False)
        resampled.append(bool(io.resampled))
    assert any(resampled) and not all(resampled), resampled


def _graph(k=40):
    from gridmap_slam_tpu_torch.models.posegraph import PoseGraph

    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.stack([np.cos(t), np.sin(t), t + np.pi / 2], 1)
    est = gt + rng.normal(0, 0.03, gt.shape)
    ei = np.arange(k)
    ej = (ei + 1) % k
    dx, dy = gt[ej, 0] - gt[ei, 0], gt[ej, 1] - gt[ei, 1]
    c, s = np.cos(gt[ei, 2]), np.sin(gt[ei, 2])
    ez = np.stack([c * dx + s * dy, -s * dx + c * dy,
                   np.angle(np.exp(1j * (gt[ej, 2] - gt[ei, 2])))], 1)
    ew = np.tile([[100.0, 100.0, 400.0]], (k, 1))

    def t_(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype))
    return PoseGraph(nodes=t_(est, np.float32), edge_i=t_(ei, np.int64),
                     edge_j=t_(ej, np.int64), edge_z=t_(ez, np.float32),
                     edge_w=t_(ew, np.float32))


def test_compiled_distributed_optimizer_gives_the_eager_bits(world):
    from gridmap_slam_tpu_torch.parallel.ba import make_distributed_optimizer

    graph = _graph()
    eager = make_distributed_optimizer(world, iterations=5)
    compiled = make_distributed_optimizer(world, iterations=5, jit=True)
    g_e, chi2_e = eager(graph)
    for _ in range(2):                              # one static-buffer set
        g_c, chi2_c = compiled(graph)
        assert torch.equal(g_c.nodes, g_e.nodes)
        assert torch.equal(chi2_c, chi2_e)
    assert chi2_e[-1] < 0.5 * chi2_e[0]
    # a graph of another size takes new buffers (a new graph on the card)
    small = _graph(20)
    g_s, _ = compiled(small)
    assert torch.equal(g_s.nodes, eager(small)[0].nodes)
