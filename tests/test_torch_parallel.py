"""The port's distributed engines (gridmap_slam_tpu_torch/parallel/) on the
CPU: the mesh and its collectives, shmap (matcher and surface), the
sharded RBPF, dcn and the multi-rank dry run.

The multi-rank checks run each case on n = 2 and 4 gloo ranks
(parallel/launch.run_ranks: a file rendezvous in a temporary directory,
one thread a rank, every rank killed at the time limit), all cases of a
file in one launch a rank count; each rank writes its gathered results
and the tests compare them:

- with the JAX engine on an n-device mesh of the 8 virtual CPU devices,
  JAX's draws rebuilt and injected (the per-shard fold_in layout of
  parallel/shmap.py:83-85 and :199, laid out globally);
- with the port's single-device engine on the same global draws;
- across the ranks (every replicated output equal).

Tolerances are the JAX package's own: weights rtol 1e-5 / atol 1e-5
(tests/test_shmap.py:130), poses and maps atol 1e-4 (tests/test_sharding.py:
53-58).  Against JAX, the log-weights and the maps take the port's
single-device tolerances of tests/test_torch_shared.py (log-weights atol
1e-3; K2's map cells beyond 1e-5 on at most 0.5 % of the map): a
kernel's sum order and K2's bin-edge rounding differ from XLA's by that
much on one device already.  On a world of one (mesh (1, 1), in this
process) each engine gives the single-device engine's bits, but for the
tiled ones, whose tile scorer's plain version takes another float order
than the untiled one (their kernels agree to the bit on the card).

The rank side of a launch is `_rank_cases` (this module is imported by
every rank; it imports no JAX at the top).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig, SlamConfig
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
from gridmap_slam_tpu_torch.io.synthetic import (SimParams, default_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.models.shared import matcher_block_size
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from gridmap_slam_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W_RTOL = W_ATOL = 1e-5          # tests/test_shmap.py:130
POSE_ATOL = MAP_ATOL = 1e-4     # tests/test_sharding.py:53-58
JAX_LW_ATOL = 1e-3              # tests/test_torch_shared.py
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3
STEPS = 2
RANKS = (2, 4)
INJECT = {"matcher.surface_reinject_slow": 0.05,
          "matcher.surface_reinject_fast": 0.6}


# --------------------------------------------------------------- the configs
def matcher_config(p=16) -> SlamConfig:
    """80 x 80 cells at 5 cm: 2 or 4 column tiles of even width."""
    return SlamConfig(num_particles=p, max_beams=64,
                      map=MapConfig(width_m=4.0, height_m=4.0,
                                    resolution=0.05, origin=(-2.0, -2.0)))


def surface_config(p=16, crop=48) -> SlamConfig:
    """128 x 80 cells at 10 cm with a 4 m range
    (tests/test_surface_sharded.py's), a 48-cell crop that straddles the
    tiles, and 7 theta bins (padded bins on 2 and 4 tiles)."""
    return SlamConfig(
        num_particles=p, max_beams=96, sensor=SensorConfig(max_range=4.0),
        map=MapConfig(width_m=12.8, height_m=8.0, resolution=0.1,
                      origin=(-6.4, -4.0))).with_overrides(
        {"matcher.surface_nt": 7, "matcher.surface_crop_cells": crop})


def log_frames(cfg, seed=2, revs=3, beams=60):
    frames, _ = simulate_log(default_world(), square_path_controls(revs),
                             params=SimParams(beams_per_rev=beams),
                             seed=seed)
    return frames


def mesh_shape(kind: str, n: int):
    """(n_p, n_m) of each engine's n-rank runs."""
    if kind in ("shmap", "shmap_surface", "ba"):
        return n, 1
    if kind == "sharded":
        return (2, n // 2) if n > 2 else (n, 1)
    return (n // 2, 2) if n > 2 else (1, n)


# ------------------------------------------------------------- the rank side
def _engine(case):
    cls = RBPF if case["kind"] == "sharded" else SharedMapSLAM
    return cls(case["cfg"], device="cpu")


def _step_fn(case, eng, mesh, jit=False):
    from gridmap_slam_tpu_torch.parallel.sharded import make_sharded_step
    from gridmap_slam_tpu_torch.parallel.shmap import make_shmap_step
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        make_surface_sharded_step)
    from gridmap_slam_tpu_torch.parallel.tiled import make_tiled_step

    kind = case["kind"]
    if kind in ("shmap", "shmap_surface"):
        return make_shmap_step(eng, mesh, surface=kind == "shmap_surface",
                               jit=jit)
    return {"tiled": make_tiled_step, "sharded": make_sharded_step,
            "surface_sharded": make_surface_sharded_step}[kind](eng, mesh,
                                                                jit=jit)


def _host(state, info):
    """Copies of the fields on the host (a compiled step's state is its
    static buffer, which the next step overwrites)."""
    out = {k: getattr(state, k).cpu().numpy().copy()
           for k in ("poses", "log_weights", "logodds")}
    out.update({k: getattr(info, k).cpu().numpy().copy()
                for k in ("neff", "weighted_pose", "best_pose",
                          "best_index", "best_log_weight", "resampled")})
    return out


@contextlib.contextmanager
def host_reads():
    """Count the truth tests of a tensor inside the block (bool(t), `if
    t:`), each a read of the card on a CUDA tensor: yields a dict of two
    lists, "host" (every such test but those below) and "gate" (the truth
    tests of a captured.cond predicate, the Python branch that stands on
    the CPU for the card's IF node), whose lengths are the counts."""
    from gridmap_slam_tpu_torch.models import captured

    real, real_cond = torch.Tensor.__bool__, captured.cond
    seen = {"host": [], "gate": []}
    preds = []

    def counted(t):
        kind = "gate" if any(t is q for q in preds) else "host"
        seen[kind].append(tuple(t.shape))
        return real(t)

    def cond(pred, body, outs, select=None):
        preds.append(pred)
        return real_cond(pred, body, outs, select)

    torch.Tensor.__bool__ = counted
    captured.cond = cond
    try:
        yield seen
    finally:
        torch.Tensor.__bool__ = real
        captured.cond = real_cond


@contextlib.contextmanager
def resample_draws():
    """Count the calls of systematic_indices by the distributed engines'
    resample (parallel/shmap.finish_step) inside the block: yields a list
    whose length is the count."""
    from gridmap_slam_tpu_torch.parallel import shmap

    real = shmap.systematic_indices
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    shmap.systematic_indices = counted
    try:
        yield calls
    finally:
        shmap.systematic_indices = real


def run_engine_case(case, n):
    """The case's steps on this rank (the compiled step where case["jit"]);
    returns each step's gathered global state and info (numpy), the
    collectives of the last step ("records") and of each step
    ("step_records"), each step's calls of systematic_indices, and the
    truth tests of a tensor that the steps made outside ("host_reads") and
    inside ("gate_reads") captured.cond's branch (host_reads)."""
    tiled = case["kind"] in ("tiled", "surface_sharded", "sharded")
    mesh = pmesh.make_mesh(n, map_shards=case["mesh"][1], device="cpu")
    eng = _engine(case)
    step = _step_fn(case, eng, mesh, jit=case.get("jit", False))
    state = pmesh.shard_state(case["state"], mesh, tiled=tiled)
    out, reads, gates, step_records, draws_made = [], 0, 0, [], []
    for i, frame in enumerate(case["frames"]):
        draws = case["draws"][i] if case.get("draws") else None
        gen = None if draws else torch.Generator().manual_seed(i)
        with pmesh.recording() as rec, host_reads() as seen, \
                resample_draws() as calls:
            state, info = step(state, frame, gen, draws)
        reads += len(seen["host"])
        gates += len(seen["gate"])
        step_records.append(list(rec))
        draws_made.append(len(calls))
        out.append(_host(pmesh.gather_state(state, mesh, tiled), info))
    return {"steps": out, "records": rec, "step_records": step_records,
            "systematic_calls": draws_made, "host_reads": reads,
            "gate_reads": gates}


def _rank_cases(payload: str, rank: int, n: int) -> None:
    """Rank side: run every case of the payload pickle and write this
    rank's results next to it (out<rank>.pkl)."""
    import importlib
    with open(payload, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for case in cases:
        if n % (case["mesh"][0] * case["mesh"][1]):
            continue
        mod, fn = case.get("runner", f"{__name__}:run_engine_case").split(":")
        out[case["name"]] = getattr(importlib.import_module(mod), fn)(case, n)
    with open(os.path.join(os.path.dirname(payload), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


def launch(cases, n, tmp) -> list:
    """Run `cases` on n gloo ranks; returns each rank's results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    run_ranks(n, "tests.test_torch_parallel:_rank_cases",
              str(tmp / "cases.pkl"), timeout=500)
    outs = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ----------------------------------------------- the JAX side and references
def jax_shmap_draws(key, p, n_p, inject):
    """The draws of the JAX shard_map engines (shmap, tiled,
    surface_sharded) for state key `key` on n_p particle shards, laid out
    globally: split into (next, motion, resample) keys; shard s's motion
    keys split from fold_in(motion, s) (shmap.py:83-85), each split for
    the distance and heading normals (motion.py:41-43); u0 from the
    resample key (resample.py:117); shard s's injection uniforms from
    fold_in(resample, 1000 + s) (shmap.py:199, shared.py:222)."""
    import jax
    import jax.numpy as jnp

    _, k_motion, k_resample = jax.random.split(key, 3)
    p_loc = p // n_p

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    nrm = np.concatenate([np.array(jax.vmap(normals)(jax.random.split(
        jax.random.fold_in(k_motion, s), p_loc))) for s in range(n_p)])
    u0 = float(jax.random.uniform(k_resample, (), minval=0.0,
                                  maxval=1.0 / p))
    inj = (torch.from_numpy(np.concatenate([np.array(jax.random.uniform(
        jax.random.fold_in(k_resample, 1000 + s), (p_loc, 3)))
        for s in range(n_p)])) if inject else None)
    return torch.from_numpy(nrm), torch.tensor(u0), inj


def jax_rbpf_draws(key, p):
    """RBPF.step's draws (tests/test_torch_rbpf.py's _jax_draws)."""
    import jax
    import jax.numpy as jnp

    _, k_motion, k_resample = jax.random.split(key, 3)

    def normals(k):
        kc, kt = jax.random.split(k)
        return jnp.stack([jax.random.normal(kc, (), jnp.float32),
                          jax.random.normal(kt, (), jnp.float32)])

    n = jax.vmap(normals)(jax.random.split(k_motion, p))
    u0 = jax.random.uniform(k_resample, (), minval=0.0, maxval=1.0 / p)
    return torch.from_numpy(np.array(n)), torch.tensor(float(u0))


def jax_case(kind, cfg, frames, n, seed=0, collapsed=False):
    """Run the JAX engine of `kind` on an n-device mesh for len(frames)
    steps from init(key(seed)) (with collapsed=True at step 1 with the
    recovery EMAs set apart, so that the first step injects 30 % of the
    slots); returns (the initial global state as a port state, the
    injected draws of each step, each step's results)."""
    import jax
    from gridmap_slam_tpu import RBPF as JRBPF
    from gridmap_slam_tpu.io import frame_at as j_frame_at
    from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
    from gridmap_slam_tpu.models.shared import SharedMapSLAM as JShared
    from gridmap_slam_tpu.parallel.mesh import make_mesh as j_make_mesh
    from gridmap_slam_tpu_torch.models.shared import SharedMapState
    from gridmap_slam_tpu_torch.types import SlamState

    jcfg = _jax_config(cfg)
    n_p, n_m = mesh_shape(kind, n)
    mesh = j_make_mesh(n, map_shards=n_m)
    jb = j_frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    key = jax.random.key(seed)
    if kind == "sharded":
        from gridmap_slam_tpu.parallel.sharded import (init_sharded,
                                                       make_sharded_step)
        eng = JRBPF(jcfg)
        st = init_sharded(eng, key, mesh)
        step = make_sharded_step(eng, mesh)
    else:
        eng = JShared(jcfg)
        if kind in ("shmap", "shmap_surface"):
            from gridmap_slam_tpu.parallel.shmap import (init_shmap,
                                                         make_shmap_step)
            st = init_shmap(eng, key, mesh)
            step = make_shmap_step(eng, mesh,
                                   surface=kind == "shmap_surface")
        elif kind == "tiled":
            from gridmap_slam_tpu.parallel.tiled import (init_tiled,
                                                         make_tiled_step)
            st = init_tiled(eng, key, mesh)
            step = make_tiled_step(eng, mesh)
        else:
            from gridmap_slam_tpu.parallel.surface_sharded import (
                init_surface_sharded, make_surface_sharded_step)
            st = init_surface_sharded(eng, key, mesh)
            step = make_surface_sharded_step(eng, mesh)
    if collapsed:
        st = st.replace(step=st.step + 1,
                        recov=jax.numpy.asarray([0.0, -5.0], np.float32))
    arrays = {k: np.array(getattr(st, k))
              for k in ("poses", "log_weights", "logodds", "step")}
    if kind == "sharded":
        state0 = SlamState(*(torch.from_numpy(arrays[k]) for k in
                             ("poses", "log_weights", "logodds", "step")))
    else:
        state0 = SharedMapState(
            *(torch.from_numpy(arrays[k]) for k in
              ("poses", "log_weights", "logodds", "step")),
            recov=torch.as_tensor(np.array(st.recov)))
    inject = (cfg.matcher.surface_reinject_slow > 0
              and cfg.matcher.surface_reinject_fast > 0)
    draws, results = [], []
    for i in range(len(frames)):
        draws.append(jax_rbpf_draws(st.key, cfg.num_particles)
                     if kind == "sharded" else
                     jax_shmap_draws(st.key, cfg.num_particles, n_p, inject))
        st, info = step(st, j_frame_at(jb, i))
        res = {k: np.asarray(getattr(st, k))
               for k in ("poses", "log_weights", "logodds")}
        res.update({k: np.asarray(getattr(info, k))
                    for k in ("neff", "weighted_pose", "best_pose",
                              "resampled")})
        results.append(res)
    return state0, draws, results


def _jax_config(cfg):
    from gridmap_slam_tpu.config import (MapConfig as JMap,
                                         MatcherConfig as JMatcher,
                                         MotionConfig as JMotion,
                                         RobotConfig as JRobot,
                                         SensorConfig as JSensor,
                                         SlamConfig as JSlam)
    d = dataclasses.asdict(cfg)
    for name, cls in (("robot", JRobot), ("sensor", JSensor),
                      ("motion", JMotion), ("map", JMap),
                      ("matcher", JMatcher)):
        d[name] = cls(**d[name])
    return JSlam(**d)


def single_device(kind, cfg, state0, frames, draws):
    """The port's single-device engine on the same global draws: each
    step's results (numpy)."""
    if kind == "sharded":
        eng = RBPF(cfg, device="cpu")
        step = eng.step
    else:
        eng = SharedMapSLAM(cfg, device="cpu")
        step = {"shmap": eng.step, "shmap_surface": eng.step_surface,
                "surface_sharded": eng.step_surface}.get(kind)
        if kind == "tiled":
            # _match_tiled's schedule: the coarse stage at full resolution
            eng = SharedMapSLAM(cfg.replace(matcher=dataclasses.replace(
                cfg.matcher, coarse_halfres=False, coarse_nearest=False)),
                device="cpu")
            step = eng.step
    st, out = state0, []
    for frame, d in zip(frames, draws):
        st, info = step(st, frame, draws=d)
        out.append(_host(st, info))
    return out


def build_cases(kinds, n, tmp_frames):
    """For each (name, kind, cfg) the JAX run on n devices, the port's
    single-device run, and the case the ranks run; returns
    (cases, jax results, single-device results)."""
    cases, jres, sres = [], {}, {}
    for name, kind, cfg in kinds:
        frames = tmp_frames(cfg)
        raw = frames[:STEPS]
        state0, draws, jres[name] = jax_case(
            kind, cfg, raw, n, collapsed="inject" in name)
        batch = frames_to_device(raw, cfg.max_beams, cfg.sensor.max_range)
        pframes = [frame_at(batch, i) for i in range(len(raw))]
        sres[name] = single_device(kind, cfg, state0, pframes, draws)
        cases.append(dict(name=name, kind=kind, cfg=cfg, frames=pframes,
                          draws=draws, state=state0,
                          mesh=mesh_shape(kind, n)))
    return cases, jres, sres


def with_compiled(cases, jres, sres):
    """Each case again as `<name>_jit`, run by the compiled step on the
    same draws, with the same references."""
    for case in list(cases):
        name = case["name"] + "_jit"
        cases.append(dict(case, name=name, jit=True))
        jres[name], sres[name] = jres[case["name"]], sres[case["name"]]
    return cases, jres, sres


def compiled_is_eager(outs, name):
    """On every rank the compiled step `<name>_jit` gave the eager step's
    bits, and made no truth test of a tensor but its gate's, one a scan
    (the Python branch of captured.cond, an IF node on the card: no host
    read of the resample gate), where the eager one read the gate on the
    host once a scan on a 'p' axis of more than one rank."""
    for out in outs:
        eager, comp = out[name], out[name + "_jit"]
        for a, b in zip(eager["steps"], comp["steps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert comp["host_reads"] == 0
        assert comp["gate_reads"] == len(comp["steps"])


def resample_collectives_follow_the_gate(outs, name, kind, n):
    """On every rank and every step of `name`, the collectives over 'p' are
    comm_table's rows of a scan that resamples where the step resampled
    and of one that does not elsewhere, call for call and byte for byte,
    and systematic_indices ran once on a resampling step and never on
    another."""
    from gridmap_slam_tpu_torch.parallel import comm_model

    n_p, n_m = mesh_shape(kind, n)
    cfg = dict((k[0], k[2]) for k in KINDS + QUIET)[name.replace("_jit",
                                                                  "")]
    rows = [r for r in comm_model.comm_table(cfg, n_p, n_m, kind)
            if r.axis == "p"]
    for out in outs:
        res = out[name]
        for step, records, calls in zip(res["steps"], res["step_records"],
                                        res["systematic_calls"]):
            fired = bool(step["resampled"])
            want = Counter()
            for r in rows:
                if r.when == "every scan" or fired:
                    want[r.collective, r.bytes_per_scan] += 1
            got = Counter((c, b) for c, axis, b in records if axis == "p")
            assert got == want, (name, fired)
            assert calls == int(fired), (name, fired)


def check_against(got, want, *, jax_ref: bool):
    """One step's gathered results against a reference step."""
    np.testing.assert_allclose(got["poses"], want["poses"], atol=POSE_ATOL)
    np.testing.assert_allclose(got["weighted_pose"], want["weighted_pose"],
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got["neff"], want["neff"], rtol=W_RTOL,
                               atol=W_ATOL)
    assert bool(got["resampled"]) == bool(want["resampled"])
    if jax_ref:
        np.testing.assert_allclose(got["log_weights"], want["log_weights"],
                                   atol=JAX_LW_ATOL)
        assert (np.abs(got["logodds"] - want["logodds"]) > K2_ATOL).mean() \
            <= K2_MAX_FRAC
    else:
        np.testing.assert_allclose(got["log_weights"], want["log_weights"],
                                   rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_allclose(got["logodds"], want["logodds"],
                                   atol=MAP_ATOL)


def ranks_agree(outs, name):
    """Every rank's gathered state and replicated info are the same."""
    for other in outs[1:]:
        for a, b in zip(outs[0][name]["steps"], other[name]["steps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------- multi-rank fixtures
KINDS = [("shmap", "shmap", matcher_config()),
         ("shmap_surface", "shmap_surface", surface_config(crop=0)),
         ("shmap_inject", "shmap_surface",
          surface_config(crop=0).with_overrides(INJECT)),
         ("sharded", "sharded", matcher_config(8))]
# the gate never fires: held to the eager step alone, on seeded draws
QUIET = [("shmap_quiet", "shmap", matcher_config().replace(
              resample_fraction=0.0)),
         ("shmap_surface_quiet", "shmap_surface", surface_config(
             crop=0).with_overrides({"matcher.surface_resample_fraction":
                                     0.0})),
         ("sharded_quiet", "sharded",
          matcher_config(8).replace(resample_fraction=0.0))]


def quiet_cases(n, frames_for):
    """The QUIET cases, eager and compiled, with no reference runs."""
    cases = []
    for name, kind, cfg in QUIET:
        batch = frames_to_device(frames_for(cfg)[:STEPS], cfg.max_beams,
                                 cfg.sensor.max_range)
        state = _engine(dict(kind=kind, cfg=cfg)).init()
        for jit in (False, True):
            cases.append(dict(name=name + ("_jit" if jit else ""), kind=kind,
                              cfg=cfg, jit=jit, state=state,
                              frames=[frame_at(batch, i)
                                      for i in range(STEPS)],
                              mesh=mesh_shape(kind, n)))
    return cases


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """n -> (rank results, JAX results, single-device results), all cases
    in one launch a rank count (the QUIET cases' results beside, with no
    references)."""
    cache = {}

    def frames_for(cfg):
        return log_frames(cfg, beams=60 if cfg.max_beams == 64 else 90)

    def get(n):
        if n not in cache:
            cases, jres, sres = with_compiled(*build_cases(KINDS, n,
                                                           frames_for))
            outs = launch(cases + quiet_cases(n, frames_for), n,
                          tmp_path_factory.mktemp(f"ranks{n}"))
            cache[n] = (outs, jres, sres)
        return cache[n]
    return get


NAMES = [k[0] for k in KINDS] + [k[0] + "_jit" for k in KINDS]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax_on_n_devices(multi_rank, name, n):
    outs, jres, _ = multi_rank(n)
    for got, want in zip(outs[0][name]["steps"], jres[name]):
        check_against(got, want, jax_ref=True)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_single_device(multi_rank, name, n):
    outs, _, sres = multi_rank(n)
    for got, want in zip(outs[0][name]["steps"], sres[name]):
        check_against(got, want, jax_ref=False)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree(multi_rank, name, n):
    ranks_agree(multi_rank(n)[0], name)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", [k[0] for k in KINDS + QUIET])
def test_compiled_step_gives_eager_bits_on_n_ranks(multi_rank, name, n):
    """The compiled body (the resample under captured.cond, an IF node on
    the card) against the eager one (the gate read on the host), with the
    gate firing on some scans and, in the QUIET cases, on none."""
    outs = multi_rank(n)[0]
    compiled_is_eager(outs, name)
    assert all(out[name]["host_reads"] == STEPS for out in outs)
    if name.endswith("_quiet"):
        assert not any(step["resampled"] for out in outs
                       for step in out[name + "_jit"]["steps"])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", [k[0] + jit for k in KINDS + QUIET
                                  for jit in ("", "_jit")])
def test_resample_collectives_only_where_the_gate_fires(multi_rank, name,
                                                        n):
    """Eager and compiled, every scan's collectives over 'p' are the
    comm model's rows of its gate: a scan that does not resample calls no
    resample all_gather, pmax or psum and no systematic_indices."""
    kind = dict((k[0], k[1]) for k in KINDS + QUIET)[name.replace("_jit",
                                                                   "")]
    resample_collectives_follow_the_gate(multi_rank(n)[0], name, kind, n)


@pytest.mark.parametrize("n", RANKS)
def test_injection_resamples_on_every_rank(multi_rank, n):
    """With the recovery EMAs set apart the first step injects uniform
    poses into the global slots [0, 0.3 P) and so resamples, on every rank
    as in both references."""
    outs, jres, sres = multi_rank(n)
    assert bool(jres["shmap_inject"][0]["resampled"])
    for out in outs:
        assert bool(out["shmap_inject"]["steps"][0]["resampled"])
    np.testing.assert_allclose(outs[0]["shmap_inject"]["steps"][0]["poses"],
                               sres["shmap_inject"][0]["poses"],
                               atol=POSE_ATOL)


# --------------------------------------------------- a world of one, in here
@pytest.fixture(scope="module")
def world():
    pmesh.init_world("cpu")
    return pmesh.make_mesh(device="cpu")


def _one_rank_engines():
    mc, sc = matcher_config(), surface_config()
    return {"shmap": (mc, "shmap"), "shmap_surface": (sc, "shmap_surface"),
            "tiled": (mc, "tiled"), "surface_sharded": (sc, "surface_sharded"),
            "sharded": (matcher_config(8), "sharded")}


@pytest.mark.parametrize("kind", sorted(_one_rank_engines()))
def test_world_of_one_gives_single_device_bits(world, kind):
    cfg, _ = _one_rank_engines()[kind]
    if kind == "tiled":
        cfg = cfg.replace(matcher=dataclasses.replace(
            cfg.matcher, coarse_halfres=False, coarse_nearest=False))
    raw = log_frames(cfg, beams=60 if cfg.max_beams == 64 else 90)[:3]
    batch = frames_to_device(raw, cfg.max_beams, cfg.sensor.max_range)
    frames = [frame_at(batch, i) for i in range(3)]
    case = dict(kind=kind, cfg=cfg)
    eng = _engine(case)
    step = _step_fn(case, eng, world)
    block = matcher_block_size(cfg)
    ref = {"shmap": lambda s, f, g: eng.step_blocked(s, f, block, g),
           "shmap_surface": lambda s, f, g: eng.step_surface(s, f, g),
           "surface_sharded": lambda s, f, g: eng.step_surface(s, f, g)}.get(
        kind, eng.step)
    a = b = eng.init()
    for i, f in enumerate(frames):
        a, ia = ref(a, f, torch.Generator().manual_seed(i))
        b, ib = step(b, f, torch.Generator().manual_seed(i))
        if kind in ("tiled", "sharded"):
            # K1's tile plain version takes the kernel's coordinate order,
            # the untiled one the JAX package's: on the card the two
            # kernels give the same bits (chip_smoke.py), here the two
            # plain versions agree within the tolerances
            check_against(_host(b, ib), _host(a, ia), jax_ref=False)
            continue
        for k in ("poses", "log_weights", "logodds", "step"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        for k in ("neff", "weighted_pose", "best_pose", "best_index",
                  "best_log_weight", "resampled"):
            assert torch.equal(getattr(ia, k), getattr(ib, k)), k


@pytest.mark.parametrize("kind", ["shmap", "shmap_surface", "tiled",
                                  "surface_sharded"])
def test_injection_with_accumulated_weights_is_refused(world, kind):
    """The engines take a SharedMapSLAM, which refuses the configuration."""
    cfg = surface_config().with_overrides(INJECT).replace(
        accumulate_weights=True)
    with pytest.raises(ValueError, match="accumulate_weights"):
        _step_fn(dict(kind=kind), SharedMapSLAM(cfg, device="cpu"), world)


@pytest.mark.parametrize("kind", sorted(_one_rank_engines()))
def test_freeze_map_keeps_the_map(world, kind):
    cfg, _ = _one_rank_engines()[kind]
    cfg = cfg.replace(freeze_map=True)
    raw = log_frames(cfg, beams=60 if cfg.max_beams == 64 else 90)[:1]
    batch = frames_to_device(raw, cfg.max_beams, cfg.sensor.max_range)
    eng = _engine(dict(kind=kind, cfg=cfg))
    state = eng.init()
    state.logodds[..., 20:40, 30:60] = 2.0
    before = state.logodds.clone()
    state, _ = _step_fn(dict(kind=kind), eng, world)(
        state, frame_at(batch, 0), torch.Generator().manual_seed(0))
    assert torch.equal(state.logodds, before)


def test_shard_and_gather_round_trip(world):
    cfg = matcher_config(8)
    eng = RBPF(cfg, device="cpu")
    st = eng.init()
    st.logodds = torch.randn_like(st.logodds)
    for tiled in (False, True):
        local = pmesh.shard_state(st, world, tiled=tiled)
        back = pmesh.gather_state(local, world, tiled=tiled)
        for k in ("poses", "log_weights", "logodds"):
            assert torch.equal(getattr(back, k), getattr(st, k))


def test_shard_arrays_slices_the_global_state():
    from gridmap_slam_tpu_torch.convert import shard_arrays

    poses = np.arange(24, dtype=np.float32).reshape(8, 3)
    lw = np.arange(8, dtype=np.float32)
    lo = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    p, w, m = shard_arrays(poses, lw, lo, n_p=2, i_p=1, n_m=3, i_m=2,
                           tiled=True)
    np.testing.assert_array_equal(p, poses[4:])
    np.testing.assert_array_equal(w, lw[4:])
    np.testing.assert_array_equal(m, lo[4:, :, 4:6])
    _, _, shared = shard_arrays(poses, lw, lo[0], n_p=4, i_p=0, n_m=2,
                                i_m=0, tiled=True)
    np.testing.assert_array_equal(shared, lo[0][:, :3])
    with pytest.raises(ValueError):
        shard_arrays(poses, lw, lo, n_p=3, i_p=0)


def test_make_mesh_refuses_a_mesh_the_world_cannot_hold(world):
    with pytest.raises(ValueError, match="world of 2 ranks"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.make_mesh(1, map_shards=2, device="cpu")


def test_inject_uniform_slot_offset_matches_jax():
    """inject_uniform(..., slot_offset) against the JAX function with a
    non-zero offset: the same uniforms, the same slots replaced."""
    import jax
    from gridmap_slam_tpu.models import shared as js
    from gridmap_slam_tpu_torch.models import shared as ts

    cfg = surface_config(p=64)
    jcfg = _jax_config(cfg)
    key = jax.random.key(3)
    poses = np.random.default_rng(0).uniform(-1, 1, (16, 3)).astype(
        np.float32)
    for offset, p_inject in ((16, 0.3), (0, 0.1), (48, 0.3)):
        jp, jt = js.inject_uniform(jcfg, key, jax.numpy.asarray(poses),
                                   np.float32(p_inject), slot_offset=offset)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (16, 3))))
        tp, tt = ts.inject_uniform(cfg, u, torch.from_numpy(poses),
                                   torch.tensor(p_inject),
                                   slot_offset=offset)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


# -------------------------------------------------------------- dcn, dry run
_DCN_RANK = r"""
import json, sys, torch
torch.set_num_threads(1)
import torch.distributed as dist
from gridmap_slam_tpu_torch.parallel import dcn
from gridmap_slam_tpu_torch.parallel.tiled import init_tiled, make_tiled_step
from tests.test_torch_parallel import log_frames, matcher_config
from gridmap_slam_tpu_torch import SharedMapSLAM
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
rank = int(sys.argv[1])
dcn.initialize(sys.argv[2], num_processes=2, process_id=rank)
dcn.initialize(sys.argv[2], num_processes=2, process_id=rank)  # no-op
mesh = dcn.make_multihost_mesh(map_shards=2)
cfg = matcher_config()
eng = SharedMapSLAM(cfg, device="cpu")
b = frames_to_device(log_frames(cfg)[:2], cfg.max_beams, cfg.sensor.max_range)
st = init_tiled(eng, mesh)
step = make_tiled_step(eng, mesh)
for i in range(2):
    st, info = step(st, frame_at(b, i), torch.Generator().manual_seed(i))
# leave the world together: a rank closes its gloo connections only when
# the other has finished every collective (told through a file store, not
# through those connections), so none reads a closed socket
done = dist.FileStore(sys.argv[3], 2)
done.set(f"rank{rank}", "done")
done.wait(["rank0", "rank1"])
dist.destroy_process_group()
print("DCN_OK", json.dumps({"neff": float(info.neff),
      "pose": info.weighted_pose.tolist(), "mesh": list(mesh.shape)}),
      flush=True)
"""
DCN_TIMEOUT = 300


def test_two_process_dcn_tiled_step(tmp_path):
    """dcn.initialize over a file rendezvous joins two processes, the
    multi-host mesh puts both on 'm', and the tiled step's replicated
    outputs agree (tests/test_dcn.py's counterpart).  Each rank writes to a
    file of its own and both are watched together, as parallel/launch.py
    does: a rank that fails is reported at once with its output, and
    neither can block on a full pipe while the test waits on the other."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), LOCAL_WORLD_SIZE="2")
    init = f"file://{tmp_path}/rendezvous"
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _DCN_RANK, str(r), init,
                               str(tmp_path / "left")],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=str(ROOT))
             for r in range(2)]

    def output(r):
        logs[r].seek(0)
        return logs[r].read()

    deadline = time.monotonic() + DCN_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            assert not bad, (f"rank {bad[0]} failed "
                             f"({procs[bad[0]].returncode}):\n"
                             f"{output(bad[0])[-3000:]}")
            assert time.monotonic() < deadline, (
                f"the ranks passed {DCN_TIMEOUT} s:\n{output(0)[-1500:]}\n"
                f"{output(1)[-1500:]}")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            assert p.returncode == 0, output(r)[-3000:]
        outs = [next(ln for ln in output(r).splitlines()
                     if ln.startswith("DCN_OK")) for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    got = [json.loads(ln.split(" ", 1)[1]) for ln in outs]
    assert got[0] == got[1] and got[0]["mesh"] == [1, 2]
    assert np.isfinite(got[0]["neff"])


def test_dryrun_multichip_four_ranks(capfd):
    from gridmap_slam_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip(4)")]
    assert len(lines) == 6
    for what in ("sharded RBPF", "shmap collectives", "surface shmap",
                 "map-sharded surface", "tiled halo-exchange",
                 "distributed BA"):
        assert any(what in ln for ln in lines), what


def test_dryrun_refuses_more_ranks_than_cards():
    from gridmap_slam_tpu_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="cards"):
        dryrun_multichip(max(torch.cuda.device_count(), 0) + 1,
                         device="cuda")
