"""The port's distributed bundle adjustment and its communication model on
the CPU, and the port's freedom from JAX.

- BA on n = 2 and 4 gloo ranks against the JAX package's
  make_distributed_optimizer on an n-device mesh and against the port's
  single-device Gauss-Newton (chi2 rtol 1e-3, nodes atol 1e-3,
  tests/test_ba.py:43-45);
- parallel/comm_model.comm_table's rows against the collectives the
  engines called (parallel/mesh.recording) in a gloo run, eager and
  compiled, on scans that resample and scans that do not (the compiled
  step calls the resample's rows only on the former, as the eager one);
- the functions the port's comm_model keeps unchanged (CollectiveRow,
  project_two_host) pinned to the JAX module's, definition by definition;
- no module of the port, and not chip_smoke.py, imports jax, flax, orbax
  or gridmap_slam_tpu.
"""

from __future__ import annotations

import ast
import dataclasses
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from gridmap_slam_tpu_torch.parallel import comm_model as tcomm
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_parallel import (RANKS, launch, log_frames,
                                       matcher_config, surface_config)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHI2_RTOL, NODES_ATOL = 1e-3, 1e-3
ITERATIONS = 8


def _loop_graph():
    """tests/test_ba.py's loop: a drifted square with one closure."""
    from gridmap_slam_tpu.models import posegraph as PG
    from tests.test_posegraph import _noisy_square

    gt, est = _noisy_square()
    k = len(gt)
    ei, ej, ez, ew = PG.odometry_edges(est)
    ci = np.concatenate([ei, [k - 1]]).astype(np.int32)
    cj = np.concatenate([ej, [0]]).astype(np.int32)
    cz = np.concatenate([ez, [PG._relative_np(gt[-1], gt[0])]]).astype(
        np.float32)
    cw = np.concatenate([ew, [[500.0, 500.0, 1000.0]]]).astype(np.float32)
    return est.astype(np.float32), ci, cj, cz, cw


def run_ba_case(case, n):
    """Rank side: the distributed optimizer on this rank's edges."""
    from gridmap_slam_tpu_torch.parallel.ba import (make_distributed_optimizer,
                                                    pad_edges, shard_graph)

    mesh = pmesh.make_mesh(n, device="cpu")
    nodes, *edges = case["graph"]
    graph = shard_graph((nodes,) + pad_edges(*edges, n), mesh, device="cpu")
    out = {}
    for jit in (False, True):
        g, chi2 = make_distributed_optimizer(mesh, iterations=ITERATIONS,
                                             jit=jit)(graph)
        out["jit" if jit else "eager"] = {"nodes": g.nodes.numpy(),
                                          "chi2": chi2.numpy()}
    return dict(out["eager"], jit=out["jit"])


COMM_KINDS = [("shmap", matcher_config()),
              ("shmap_surface", surface_config(crop=0)),
              ("tiled", matcher_config()),
              ("surface_sharded", surface_config()),
              ("sharded", matcher_config(8))]


def run_comm_case(case, n):
    """Rank side: one step of the engine, eager and compiled, once with the
    resample gate shut and once forced open; the collectives each called
    and each one's results."""
    from tests.test_torch_parallel import run_engine_case

    out = {}
    for label, fraction in (("quiet", 0.0), ("resampling", 2.0)):
        mc = case["cfg"].matcher
        cfg = case["cfg"].replace(
            resample_fraction=fraction,
            matcher=dataclasses.replace(mc,
                                        surface_resample_fraction=fraction))
        for jit in (False, True):
            res = run_engine_case(dict(case, cfg=cfg, jit=jit), n)
            out[label + ("_jit" if jit else "")] = {
                "records": res["records"], "steps": res["steps"],
                "resampled": bool(res["steps"][-1]["resampled"])}
    return out


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    cache = {}

    def get(n):
        if n not in cache:
            cases = [dict(name="ba", kind="ba", mesh=(n, 1),
                          graph=_loop_graph(),
                          runner="tests.test_torch_ba:run_ba_case")]
            if n == 4:
                for kind, cfg in COMM_KINDS:
                    raw = log_frames(cfg, beams=60 if cfg.max_beams == 64
                                     else 90)[:1]
                    b = frames_to_device(raw, cfg.max_beams,
                                         cfg.sensor.max_range)
                    cls = RBPF if kind == "sharded" else SharedMapSLAM
                    m_axis = kind in ("tiled", "surface_sharded")
                    cases.append(dict(
                        name=f"comm_{kind}", kind=kind, cfg=cfg,
                        mesh=(1, 4) if m_axis else (2, 2)
                        if kind == "sharded" else (4, 1),
                        frames=[frame_at(b, 0)],
                        state=cls(cfg, device="cpu").init(),
                        runner="tests.test_torch_ba:run_comm_case"))
            cache[n] = launch(cases, n, tmp_path_factory.mktemp(f"ba{n}"))
        return cache[n]
    return get


# ------------------------------------------------------------------------ BA
@pytest.mark.parametrize("n", RANKS)
def test_distributed_ba_matches_jax(multi_rank, n):
    import jax
    from jax.sharding import Mesh
    from gridmap_slam_tpu.parallel.ba import (make_distributed_optimizer,
                                              pad_edges, shard_graph)

    nodes, *edges = _loop_graph()
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("p", "m"))
    g, chi2 = make_distributed_optimizer(mesh, iterations=ITERATIONS)(
        shard_graph((nodes,) + pad_edges(*edges, n), mesh))
    got = multi_rank(n)[0]["ba"]
    np.testing.assert_allclose(got["chi2"], np.asarray(chi2), rtol=CHI2_RTOL)
    np.testing.assert_allclose(got["nodes"], np.asarray(g.nodes),
                               atol=NODES_ATOL)


@pytest.mark.parametrize("n", RANKS)
def test_distributed_ba_matches_single_device(multi_rank, n):
    from gridmap_slam_tpu_torch.convert import posegraph_from_jax_arrays
    from gridmap_slam_tpu_torch.models.posegraph import optimize

    g, chi2 = optimize(posegraph_from_jax_arrays(*_loop_graph()),
                       iterations=ITERATIONS)
    outs = multi_rank(n)
    got = outs[0]["ba"]
    np.testing.assert_allclose(got["chi2"], chi2.numpy(), rtol=CHI2_RTOL)
    np.testing.assert_allclose(got["nodes"], g.nodes.numpy(),
                               atol=NODES_ATOL)
    assert got["chi2"][-1] < 0.5 * got["chi2"][0]
    for other in outs[1:]:
        np.testing.assert_array_equal(other["ba"]["nodes"], got["nodes"])


@pytest.mark.parametrize("n", RANKS)
def test_compiled_distributed_ba_gives_eager_bits(multi_rank, n):
    """jit=True (every iteration with its psum one graph on the card; the
    static-buffer body here) gives the eager optimizer's bits on every
    rank, and so JAX's within test_distributed_ba_matches_jax's
    tolerances."""
    import jax
    from jax.sharding import Mesh
    from gridmap_slam_tpu.parallel.ba import (make_distributed_optimizer,
                                              pad_edges, shard_graph)

    for out in multi_rank(n):
        got = out["ba"]
        np.testing.assert_array_equal(got["jit"]["nodes"], got["nodes"])
        np.testing.assert_array_equal(got["jit"]["chi2"], got["chi2"])
    nodes, *edges = _loop_graph()
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("p", "m"))
    g, chi2 = make_distributed_optimizer(mesh, iterations=ITERATIONS)(
        shard_graph((nodes,) + pad_edges(*edges, n), mesh))
    got = multi_rank(n)[0]["ba"]["jit"]
    np.testing.assert_allclose(got["chi2"], np.asarray(chi2), rtol=CHI2_RTOL)
    np.testing.assert_allclose(got["nodes"], np.asarray(g.nodes),
                               atol=NODES_ATOL)


def test_pad_edges_keeps_the_graph():
    from gridmap_slam_tpu.parallel.ba import pad_edges as j_pad
    from gridmap_slam_tpu_torch.parallel.ba import pad_edges

    edges = _loop_graph()[1:]
    for mult in (1, 3, 8):
        for a, b in zip(pad_edges(*edges, mult), j_pad(*edges, mult)):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- the comm model
def _expected(rows, resampled: bool, m_edge: bool):
    """(collective, axis) -> (bytes, calls) of the model's rows for a scan,
    for a rank with one neighbour along 'm' (m_edge) or two."""
    out = Counter()
    calls = Counter()
    for r in rows:
        if r.when != "every scan" and not resampled:
            continue
        nbytes = r.bytes_per_scan
        n_calls = 1
        if r.collective == "ppermute":
            n_calls = 1 if m_edge else 2
            nbytes = nbytes // 2 * n_calls
        out[r.collective, r.axis] += nbytes
        calls[r.collective, r.axis] += n_calls
    return out, calls


@pytest.mark.parametrize("label", ["quiet", "resampling"])
@pytest.mark.parametrize("kind", [k for k, _ in COMM_KINDS])
def test_comm_model_rows_equal_the_recorded_collectives(multi_rank, kind,
                                                        label):
    outs = multi_rank(4)
    cfg = dict(COMM_KINDS)[kind]
    n_p, n_m = ((1, 4) if kind in ("tiled", "surface_sharded")
                else (2, 2) if kind == "sharded" else (4, 1))
    rows = tcomm.comm_table(cfg, n_p, n_m, kind)
    for rank, out in enumerate(outs):
        res = out[f"comm_{kind}"][label]
        assert res["resampled"] == (label == "resampling")
        got, got_calls = Counter(), Counter()
        for coll, axis, nbytes in res["records"]:
            got[coll, axis] += nbytes
            got_calls[coll, axis] += 1
        j = rank % n_m
        want, want_calls = _expected(rows, res["resampled"],
                                     m_edge=j in (0, n_m - 1))
        assert dict(got) == dict(want), (rank, label)
        assert dict(got_calls) == dict(want_calls), (rank, label)


@pytest.mark.parametrize("label", ["quiet", "resampling"])
@pytest.mark.parametrize("kind", [k for k, _ in COMM_KINDS])
def test_comm_model_captured_rows_equal_the_compiled_collectives(
        multi_rank, kind, label):
    """comm_table's rows against the collectives the compiled body called:
    the resample's rows ("resampling scans only", as in the JAX comm
    model) on the resampling scan, none of them on the quiet one; and the
    compiled step's results equal the eager step's."""
    outs = multi_rank(4)
    cfg = dict(COMM_KINDS)[kind]
    n_p, n_m = ((1, 4) if kind in ("tiled", "surface_sharded")
                else (2, 2) if kind == "sharded" else (4, 1))
    rows = tcomm.comm_table(cfg, n_p, n_m, kind)
    gated = [r for r in rows if r.when != "every scan"]
    assert all(r.when == tcomm.RESAMPLE for r in gated)
    assert bool(gated) == (n_p > 1)
    for rank, out in enumerate(outs):
        res = out[f"comm_{kind}"][label + "_jit"]
        assert res["resampled"] == (label == "resampling")
        got, got_calls = Counter(), Counter()
        for coll, axis, nbytes in res["records"]:
            got[coll, axis] += nbytes
            got_calls[coll, axis] += 1
        want, want_calls = _expected(rows, res["resampled"],
                                     m_edge=rank % n_m in (0, n_m - 1))
        assert dict(got) == dict(want), (rank, label)
        assert dict(got_calls) == dict(want_calls), (rank, label)
        every, _ = _expected(rows, False, m_edge=rank % n_m in
                             (0, n_m - 1))
        extra = Counter(got)
        extra.subtract(every)
        want_extra = Counter()
        if res["resampled"]:
            for r in gated:
                want_extra[r.collective, r.axis] += r.bytes_per_scan
        assert +extra == want_extra, (rank, label)
        for a, b in zip(out[f"comm_{kind}"][label]["steps"], res["steps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_comm_model_payload_scaling():
    cfg = matcher_config(1024)
    rows = tcomm.comm_table(cfg, 4, 2, "tiled")
    resamp = [r for r in rows if r.what.startswith("systematic")]
    assert len(resamp) == 1 and resamp[0].bytes_per_scan == 16 * 1024
    psum4 = sum(r.bytes_per_scan for r in rows
                if r.axis == "m" and r.collective == "psum")
    psum8 = sum(r.bytes_per_scan for r in tcomm.comm_table(cfg, 8, 2, "tiled")
                if r.axis == "m" and r.collective == "psum")
    assert psum4 == 2 * psum8
    assert not [r for r in tcomm.comm_table(cfg, 1, 2, "tiled")
                if r.when != "every scan"]
    with pytest.raises(ValueError):
        tcomm.comm_table(cfg, 4, 2, "gspmd")


def test_two_host_projection_at_city_scale():
    from gridmap_slam_tpu_torch.config import MapConfig, SlamConfig

    cfg = SlamConfig(num_particles=1_000_000,
                     map=MapConfig(width_m=200.0, height_m=200.0,
                                   resolution=0.05, origin=(-100.0, -100.0))
                     ).with_overrides({"matcher.surface_crop_cells": 512})
    proj = tcomm.project_two_host(cfg, 2, 4, "surface_sharded", step_ms=50.0,
                                  resample_rate=1.0)
    assert proj["meets_80pct_criterion"]
    assert proj["dcn_bytes_resampling_scan"] >= 16 * 1_000_000


def _definitions(path, names):
    tree = ast.parse(path.read_text())
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in names}


def test_comm_model_keeps_the_jax_module_functions():
    """CollectiveRow and project_two_host are the JAX module's, unchanged
    (the port's comm_table is re-derived)."""
    keep = ("CollectiveRow", "project_two_host")
    want = _definitions(ROOT / "gridmap_slam_tpu/parallel/comm_model.py",
                        keep)
    got = _definitions(ROOT / "gridmap_slam_tpu_torch/parallel/comm_model.py",
                       keep)
    assert sorted(got) == sorted(keep)
    for name in keep:
        assert got[name] == want[name], name


# ---------------------------------------------------------- no JAX in here
def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["gridmap_slam_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(where):
    paths = ([ROOT / where] if where.endswith(".py")
             else sorted((ROOT / where).rglob("*.py")))
    bad = [(str(p.relative_to(ROOT)), m) for p in paths for m in _imports(p)
           if m.split(".")[0] in ("jax", "flax", "orbax", "gridmap_slam_tpu")]
    assert not bad, bad
