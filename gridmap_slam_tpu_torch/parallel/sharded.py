"""The RBPF over ranks: particles and their maps over 'p', map columns over
'm', every exchange an explicit collective.

Counterpart of gridmap_slam_tpu/parallel/sharded.py, where GSPMD infers
the collectives of RBPF.step from the state's shardings.  Here each is
written out.  Rank (i, j) holds the P / n_p particles of shard i with
column tile j of each of their maps, (P_loc, H, W / n_m).  Per scan:

- LL fields: K3 on the local maps' tiles extended by the blur radius from
  each neighbour (parallel/tiled.tiled_ll_field, batched over the local
  particles), then the one-column LL halo;
- scores: K1's tile variant at G_f = P_loc (one field a particle), summed
  over 'm', in RBPF.step's own candidate schedule (its half-resolution
  coarse stage pools each tile: parallel/tiled.tile_pool);
- map update: K2 on each local map's tile at the tile's origin;
- weights, Neff and the strongest particle over 'p' (parallel/shmap.
  finish_step);
- chunks: the JAX step's lax.map, as XLA writes it on the donated state:
  K2 writes each chunk's new tiles into its rows of one (P_loc, H, W_loc)
  tensor, with no concatenation of maps after (RBPF.step's form);
- resample: the gate is finish_step's captured.cond.  On one 'p' rank the
  ancestors' indices are drawn under it and the maps move once a scan,
  gathered at them (the identity where it does not fire), as in
  RBPF.step.  On more ranks the maps move across 'p': K2 writes into the
  state's own tiles where the step has an `out`, and the gate's body
  all_gathers the (P_loc, H, W_loc) tiles over 'p' and takes the
  ancestors' rows into them, so a rank holds n_p x its local maps for
  that moment and only on scans that resample (PERF.md).  Sending only
  the ancestors that cross ranks is later work (ROADMAP.md).

On a mesh (1, 1) the step is RBPF.step, bit for bit.
"""

from __future__ import annotations

import torch

from ..models.rbpf import RBPF, scan_prep
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.matcher import correlative_match_batch
from ..ops.motion import sample_and_propagate
from ..types import Frame
from .mesh import axis_index, axis_size, shard_state
from .shmap import MeshStep, finish_step, local_particles
from .tiled import (tile_geometry, tile_origin, tile_pool, tile_stage,
                    tiled_ll_field)


def make_sharded_step(engine: RBPF, mesh, jit: bool = False):
    """The sharded RBPF step (module docstring).  Returns a
    parallel/shmap.MeshStep (eager, or with jit=True compiled) on this
    rank's shard (init_sharded); its draws are RBPF._draws' (normals
    (P, 2), u0), global: each rank takes its slice."""
    cfg = engine.config
    p_loc = local_particles(engine, mesh)
    w_loc, c0 = tile_geometry(cfg, mesh)
    s = cfg.sensor
    res = float(cfg.map.resolution)
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    t_origin = tile_origin(cfg, c0)
    chunk = cfg.particle_chunk
    chunk = chunk if 0 < chunk < p_loc and p_loc % chunk == 0 else p_loc
    i_p, n_p = axis_index(mesh, "p"), axis_size(mesh, "p")
    match_kw = dict(stage=tile_stage(mesh), pool=tile_pool(mesh))

    def body(state, frame: Frame, draws, out, host_gate):
        normals, u0 = draws
        normals = normals[i_p * p_loc:(i_p + 1) * p_loc]
        prep = scan_prep(cfg, frame)
        odom = frame.odom

        # the maps' tensor is made once the first chunk is matched, as in
        # RBPF.step; on more than one 'p' rank it is the state's own where
        # the step writes into `out` (each chunk's tiles are read before
        # K2 writes them, and the gate's gather reads a copy); F3 writes
        # each chunk's best poses and scores into its rows
        dev = state.poses.device
        poses_all = torch.empty((p_loc, 3), dtype=torch.float32, device=dev)
        scores = torch.empty((p_loc,), dtype=torch.float32, device=dev)
        maps = None
        for a in range(0, p_loc, chunk):
            poses = state.poses[a:a + chunk]
            tiles = state.logodds[a:a + chunk]
            pose_s, pose_det = sample_and_propagate(
                poses, odom, cfg.motion, normals[a:a + chunk])
            tf = tiled_ll_field(tiles, engine.taps, mesh,
                                z_hit=cfg.matcher.z_hit,
                                max_range=s.max_range, w_loc=w_loc, c0=c0)
            best, _ = correlative_match_batch(
                tf, prep, pose_s, odom, matcher_cfg=cfg.matcher,
                motion_cfg=cfg.motion, resolution=res, origin=origin,
                max_range=s.max_range, prior_center_b=pose_det,
                out=(poses_all[a:a + chunk], scores[a:a + chunk]),
                **match_kw)
            if maps is None:
                maps = (out.logodds if out is not None and n_p > 1
                        else torch.empty_like(state.logodds))
            integrate_scan_batch(
                tiles, best, prep.keep, *prep.tables, resolution=res,
                origin=t_origin, l_free=s.l_free, l_occ=s.l_occ,
                tol_cells=s.hit_tolerance_cells, out=maps[a:a + chunk])
        return finish_step(engine, mesh, state, poses_all, scores,
                           lambda pose, into, win: None, u0, None,
                           cfg.resample_fraction, maps=maps, out=out,
                           host_gate=host_gate)

    return MeshStep(body, engine._draws, engine.device, jit)


def init_sharded(engine: RBPF, mesh, pose=(0.0, 0.0, 0.0)):
    """This rank's shard of engine.init(pose): its particles and their maps'
    column tiles (built whole and sliced: a caller of city-scale maps
    builds its shard itself)."""
    return shard_state(engine.init(pose), mesh, tiled=True,
                       device=engine.device)
