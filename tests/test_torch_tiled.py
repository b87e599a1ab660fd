"""The port's map-tiled engines on the CPU: the tiled likelihood field, K1's
tile variant (its plain version), the tiled engine, the map-sharded
surface engine, K2's window variant and the CLI's mesh engines.

Multi-rank cases run on n = 2 and 4 gloo ranks through
tests/test_torch_parallel.py's launcher and are held, as there, to the
JAX engine on an n-device mesh with JAX's draws injected, to the port's
single-device engine on the same global draws, and across the ranks.
The tiled engine's single-device reference is SharedMapSLAM.step with the
coarse stage of `_match_tiled` (full resolution, bilinear).  The
map-sharded surface engine is held to the tolerances of
tests/test_surface_sharded.py:66-73 (poses 2e-3, maps 1e-3, Neff rtol
1e-3).  The tiled field is held to JAX's _ll_field_tiled at atol 1e-5 and
the summed K1 tiles to _stage_scores_tiled at atol 1e-4
(tests/test_tiled.py:144).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
from gridmap_slam_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_parallel import (JAX_LW_ATOL, K2_ATOL, K2_MAX_FRAC,
                                       RANKS, build_cases,
                                       check_against, compiled_is_eager,
                                       launch, log_frames, matcher_config,
                                       ranks_agree, surface_config,
                                       with_compiled)

torch.set_num_threads(1)

SS_POSE_ATOL, SS_MAP_ATOL, SS_NEFF_RTOL = 2e-3, 1e-3, 1e-3
LL_ATOL = 1e-5
SCORE_ATOL = 1e-4
H, W = 80, 128


def _test_map():
    """tests/test_tiled.py's map: walls and free cells in a 80 x 128 grid."""
    rng = np.random.RandomState(0)
    lo = np.zeros((H, W), np.float32)
    occ = rng.randint(5, 75, (60, 2))
    lo[occ[:, 0], occ[:, 1] + 20] = 2.0
    free = rng.randint(5, 75, (300, 2))
    lo[free[:, 0], free[:, 1] + 20] -= 1.0
    return lo


def _scan():
    n = 60
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    dists = 0.8 + 0.7 * np.abs(np.sin(2 * angles))
    return angles, dists, n


# ---------------------------------------------- K1's tile variant, plainly
def _jax_tiled_scores(lo, n):
    """JAX's _stage_scores_tiled psummed over a (1, n) mesh, on JAX's
    tiled field with an ll_outside halo at the world's edges."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from gridmap_slam_tpu.ops.geometry import scan_points
    from gridmap_slam_tpu.ops.grid import gaussian_kernel
    from gridmap_slam_tpu.parallel.tiled import (_halo_exchange_cols,
                                                 _ll_field_tiled,
                                                 _stage_scores_tiled)
    from gridmap_slam_tpu.types import Scan

    angles, dists, nb = _scan()
    scan = Scan.from_arrays(angles, dists, np.ones(nb, bool), max_beams=64)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    pose0 = jax.numpy.asarray([0.3, -0.2, 0.25], jax.numpy.float32)
    dxs = jax.numpy.asarray(np.linspace(-0.2, 0.2, 9), jax.numpy.float32)
    dts = jax.numpy.asarray(np.linspace(-0.26, 0.26, 11), jax.numpy.float32)
    kernel = gaussian_kernel(1.0, 3)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("p", "m"))
    w_loc = W // n
    ll_out = math.log(1.0 / 10.0)

    def tilefn(tile):
        j = jax.lax.axis_index("m")
        llt = _ll_field_tiled(tile, kernel, 0.9, 10.0, "m")
        ll_ext = _halo_exchange_cols(llt, 1, "m", fill=ll_out)
        part = _stage_scores_tiled(
            ll_ext, px, py, use, pose0, dxs, dxs, dts, resolution=0.05,
            origin=(-3.2, -2.0), max_range=10.0, w_total=W, h=H, tile_j=j,
            w_loc=w_loc, ext=1)
        return jax.lax.psum(part, "m"), ll_ext

    scores, ext = jax.jit(jax.shard_map(
        tilefn, mesh=mesh, in_specs=P(None, "m"),
        out_specs=(P(), P(None, "m")), check_vma=False))(jax.numpy.asarray(lo))
    return np.asarray(scores), np.asarray(ext)


def _port_tile_scores(ll_ext_all, n, nearest=False):
    """The port's plain tile variant on JAX's extended tiles, summed."""
    angles, dists, nb = _scan()
    from gridmap_slam_tpu_torch.ops.geometry import scan_points
    from gridmap_slam_tpu_torch.types import Scan

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
        total = total + kmatch.stage_scores_tile_plain(
            ext[None], px, py, use, pose0, dxs, dxs, dts, resolution=0.05,
            origin=(-3.2, -2.0), max_range=10.0, c0=j * w_loc, w_loc=w_loc,
            n_m=n, ext=1, nearest=nearest)[0]
    return total.numpy(), (px, py, use, pose0, dxs, dts)


@pytest.mark.parametrize("n", RANKS)
def test_k1_tile_plain_summed_matches_jax(n):
    want, ext = _jax_tiled_scores(_test_map(), n)
    got, _ = _port_tile_scores(ext, n)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_k1_tile_plain_summed_matches_untiled(n, nearest):
    """On the port's own field: the tiles' partial scores summed equal the
    untiled plain K1 (on the card the tile kernel on one tile gives the
    untiled kernel's bits: chip_smoke.py)."""
    _, ext = _jax_tiled_scores(_test_map(), 1)
    field = torch.from_numpy(ext[:, 1:-1].copy())[None]
    got, (px, py, use, pose0, dxs, dts) = _port_tile_scores(
        np.concatenate([_ext_tile(ext[:, 1:-1], j, n) for j in range(n)], 1),
        n, nearest=nearest)
    want = kmatch.stage_scores_batch_plain(
        field, px, py, use, pose0, dxs, dxs, dts, resolution=0.05,
        origin=(-3.2, -2.0), max_range=10.0, nearest=nearest)[0].numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL)


def _ext_tile(field, j, n):
    """Tile j of n of a (H, W) field with one column of each neighbour,
    log(1 / 10) at the world's edges."""
    w_loc = field.shape[1] // n
    out = np.full((field.shape[0], w_loc + 2), math.log(0.1), np.float32)
    out[:, 1:-1] = field[:, j * w_loc:(j + 1) * w_loc]
    if j > 0:
        out[:, 0] = field[:, j * w_loc - 1]
    if j < n - 1:
        out[:, -1] = field[:, (j + 1) * w_loc]
    return out


def test_k1_tile_refuses_a_tile_that_does_not_fit():
    """The wrapper refuses a tile its field cannot hold, and CPU tensors
    (the kernel runs on the card only)."""
    field = torch.zeros((1, 8, 12))
    args = (torch.zeros(4), torch.zeros(4), torch.ones(4, dtype=torch.bool),
            torch.zeros((1, 3)), torch.zeros((1, 1)), torch.zeros((1, 1)),
            torch.zeros((1, 1)))
    kw = dict(resolution=0.05, origin=(0.0, 0.0), max_range=10.0)
    for c0, w_loc, n_m in ((3, 10, 2), (10, 10, 1), (0, 9, 2)):
        with pytest.raises(ValueError, match="does not fit"):
            kmatch.stage_scores_tile_cuda(field, *args, c0=c0, w_loc=w_loc,
                                          n_m=n_m, **kw)
    with pytest.raises(ValueError, match="must be on"):
        kmatch.stage_scores_tile_cuda(field, *args, c0=10, w_loc=10, n_m=2,
                                      **kw)


# ------------------------------------------------------- multi-rank: fields
def run_ll_case(case, n):
    """Rank side: the tiled LL field of the case's map, gathered."""
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel
    from gridmap_slam_tpu_torch.parallel.tiled import tiled_ll_field

    mesh = pmesh.make_mesh(n, map_shards=n, device="cpu")
    lo = torch.from_numpy(case["lo"])
    w_loc = lo.shape[1] // n
    j = pmesh.axis_index(mesh, "m")
    taps = torch.as_tensor(gaussian_kernel(1.0, 3))
    tf = tiled_ll_field(lo[None, :, j * w_loc:(j + 1) * w_loc].contiguous(),
                        taps, mesh, z_hit=0.9, max_range=10.0, w_loc=w_loc,
                        c0=j * w_loc)
    tiles = pmesh.all_gather(tf.ext[0], mesh, "m")
    return {"ll": torch.cat([t[:, 1:-1] for t in tiles.unbind(0)],
                            1).numpy(),
            "ext": torch.cat(list(tiles.unbind(0)), 1).numpy()}


KINDS = [("tiled", "tiled", matcher_config()),
         ("surface_sharded", "surface_sharded", surface_config())]


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    cache = {}

    def frames_for(cfg):
        return log_frames(cfg, beams=60 if cfg.max_beams == 64 else 90)

    def get(n):
        if n not in cache:
            cases, jres, sres = with_compiled(*build_cases(KINDS, n,
                                                           frames_for))
            cases.append(dict(name="ll_field", kind="ll_field", mesh=(1, n),
                              lo=_test_map(),
                              runner="tests.test_torch_tiled:run_ll_case"))
            outs = launch(cases, n, tmp_path_factory.mktemp(f"tiled{n}"))
            cache[n] = (outs, jres, sres)
        return cache[n]
    return get


@pytest.mark.parametrize("n", RANKS)
def test_tiled_ll_field_matches_jax(multi_rank, n):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from gridmap_slam_tpu.ops.grid import gaussian_kernel
    from gridmap_slam_tpu.parallel.tiled import _ll_field_tiled

    outs = multi_rank(n)[0]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("p", "m"))
    want = jax.jit(jax.shard_map(
        lambda t: _ll_field_tiled(t, gaussian_kernel(1.0, 3), 0.9, 10.0,
                                  "m"),
        mesh=mesh, in_specs=P(None, "m"), out_specs=P(None, "m"),
        check_vma=False))(jax.numpy.asarray(_test_map()))
    np.testing.assert_allclose(outs[0]["ll_field"]["ll"], np.asarray(want),
                               atol=LL_ATOL)
    # the halo: the neighbours' columns, log(1 / max_range) at the edges
    ext = outs[0]["ll_field"]["ext"]
    assert np.all(ext[:, 0] == np.float32(math.log(0.1)))
    assert np.all(ext[:, -1] == np.float32(math.log(0.1)))
    for r in outs[1:]:
        np.testing.assert_array_equal(r["ll_field"]["ext"], ext)


@pytest.mark.parametrize("n", RANKS)
def test_tiled_engine_matches_jax(multi_rank, n):
    outs, jres, _ = multi_rank(n)
    for got, want in zip(outs[0]["tiled"]["steps"], jres["tiled"]):
        check_against(got, want, jax_ref=True)


@pytest.mark.parametrize("n", RANKS)
def test_tiled_engine_matches_single_device(multi_rank, n):
    outs, _, sres = multi_rank(n)
    for got, want in zip(outs[0]["tiled"]["steps"], sres["tiled"]):
        check_against(got, want, jax_ref=False)


def _surface_sharded_close(got, want, lw_atol):
    np.testing.assert_allclose(got["poses"], want["poses"],
                               atol=SS_POSE_ATOL)
    np.testing.assert_allclose(got["weighted_pose"], want["weighted_pose"],
                               atol=SS_POSE_ATOL)
    np.testing.assert_allclose(got["neff"], want["neff"], rtol=SS_NEFF_RTOL)
    np.testing.assert_allclose(got["log_weights"], want["log_weights"],
                               atol=lw_atol)


@pytest.mark.parametrize("n", RANKS)
def test_surface_sharded_matches_jax(multi_rank, n):
    outs, jres, _ = multi_rank(n)
    for got, want in zip(outs[0]["surface_sharded"]["steps"],
                         jres["surface_sharded"]):
        _surface_sharded_close(got, want, JAX_LW_ATOL)
        assert (np.abs(got["logodds"] - want["logodds"]) > K2_ATOL).mean() \
            <= K2_MAX_FRAC


@pytest.mark.parametrize("n", RANKS)
def test_surface_sharded_matches_single_device(multi_rank, n):
    outs, _, sres = multi_rank(n)
    for got, want in zip(outs[0]["surface_sharded"]["steps"],
                         sres["surface_sharded"]):
        _surface_sharded_close(got, want, SS_MAP_ATOL)
        np.testing.assert_allclose(got["logodds"], want["logodds"],
                                   atol=SS_MAP_ATOL)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", ["tiled", "surface_sharded"])
def test_tiled_ranks_agree(multi_rank, name, n):
    ranks_agree(multi_rank(n)[0], name)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", ["tiled", "surface_sharded"])
def test_compiled_tiled_engines_give_eager_bits(multi_rank, name, n):
    """The compiled step (jit=True) on every rank: the eager step's bits,
    no host read of the resample gate (at 4 ranks the mesh (2, 2), whose
    'p' axis the eager step gates on the host), and every rank alike."""
    outs = multi_rank(n)[0]
    compiled_is_eager(outs, name)
    ranks_agree(outs, name + "_jit")


@pytest.mark.parametrize("n", RANKS)
def test_compiled_tiled_engine_matches_jax(multi_rank, n):
    outs, jres, _ = multi_rank(n)
    for got, want in zip(outs[0]["tiled_jit"]["steps"], jres["tiled"]):
        check_against(got, want, jax_ref=True)


@pytest.mark.parametrize("n", RANKS)
def test_compiled_surface_sharded_matches_jax(multi_rank, n):
    outs, jres, _ = multi_rank(n)
    for got, want in zip(outs[0]["surface_sharded_jit"]["steps"],
                         jres["surface_sharded"]):
        _surface_sharded_close(got, want, JAX_LW_ATOL)
        assert (np.abs(got["logodds"] - want["logodds"]) > K2_ATOL).mean() \
            <= K2_MAX_FRAC


# ---------------------------------------------------- K2's window variant
@pytest.mark.parametrize("where", [(3, 7, 0), (50, 100, 0), (0, 0, 0),
                                   (10, 20, 64)])
def test_k2_window_plain_matches_slicing(where):
    """The window variant's plain version against integrating a slice cut
    with host integers at the crop's float32 origin, the path it replaced:
    the same bits."""
    from gridmap_slam_tpu_torch.ops.cuda.grid_update import (
        integrate_scan_batch, integrate_scan_window, scan_bin_tables)
    from gridmap_slam_tpu_torch.types import Scan

    iy0, ix0, col0 = where
    h, w, res, origin, crop = 90, 140, 0.05, (-3.3, -2.2), 40
    lo = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (h, w)).astype(np.float32))
    angles = np.linspace(-np.pi, np.pi, 64, endpoint=False)
    dists = 0.3 + np.random.default_rng(2).uniform(0, 1, 64)
    tables = scan_bin_tables(Scan.from_arrays(angles, dists,
                                              np.ones(64, bool), 64), 720)
    pose = torch.tensor([origin[0] + (col0 + ix0 + 20) * res + 0.013,
                         origin[1] + (iy0 + 20) * res - 0.02, 0.4])
    kw = dict(resolution=res, l_free=-0.4, l_occ=0.9, tol_cells=2.0)
    f32 = np.float32
    c_origin = (float(f32(origin[0]) + f32(col0 + ix0) * f32(res)),
                float(f32(origin[1]) + f32(iy0) * f32(res)))
    win = (slice(iy0, iy0 + crop), slice(ix0, ix0 + crop))
    want = lo.clone()
    want[win] = integrate_scan_batch(lo[win].contiguous()[None], pose[None],
                                     torch.tensor(1.0), *tables,
                                     origin=c_origin, **kw)[0]
    got = integrate_scan_window(lo, torch.tensor([iy0, ix0]), pose,
                                torch.tensor(1.0), *tables,
                                size=(crop, crop), col0=col0, origin=origin,
                                **kw)
    assert torch.equal(got, want)
    assert int((got != lo).sum()) > 100


# ------------------------------------------------------------ the CLI
SMALL = ["--particles", "8", "--max-beams", "64", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_log(tmp_path_factory):
    from gridmap_slam_tpu_torch.app.cli import main
    d = tmp_path_factory.mktemp("cli")
    main(["synth", "--revs", "3", "--beams", "60", *SMALL, "--out", str(d),
          "--save-log", str(d / "log.rec")])
    return d / "log.rec"


@pytest.mark.parametrize("engine", ["shmap", "shmap-surface", "tiled",
                                    "surface-sharded"])
def test_cli_mesh_engine_on_a_world_of_one(tmp_path, cli_log, engine,
                                           capsys):
    import json
    from gridmap_slam_tpu_torch.app.cli import main

    state, traj, metrics = main(
        ["replay", "--log", str(cli_log), *SMALL, "--out", str(tmp_path),
         "--engine", engine, "--set", "matcher.surface_nt=7"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == metrics
    assert metrics["frames"] == len(traj) and np.isfinite(traj).all()
    assert (tmp_path / "replay_map.png").exists()
    assert state.logodds.shape == (120, 120)


@pytest.mark.parametrize("argv,reason", [
    (["--engine", "tiled", "--devices", "2"], "needs a world of 2 ranks"),
    (["--engine", "surface-sharded", "--map-shards", "2"],
     "does not divide the world of 1"),
    (["--engine", "shmap", "--map-shards", "2"], "replicates the map"),
])
def test_cli_mesh_engine_refusals(tmp_path, cli_log, argv, reason):
    from gridmap_slam_tpu_torch.app.cli import main

    with pytest.raises(SystemExit, match=reason):
        main(["replay", "--log", str(cli_log), *SMALL, "--out",
              str(tmp_path), *argv])
