"""The shared-map engine on a map split into column tiles over ranks.

Counterpart of gridmap_slam_tpu/parallel/tiled.py, the city-scale design
(BASELINE configs 3 and 5): a grid too large to replicate is split into
column tiles, one a rank along mesh axis 'm', and the particles over 'p'
(replicated across 'm', as every particle's scan spans the whole map).
Rank (i, j) holds particle shard i and map tile j.  Per scan:

- LL field: K3 on the tile extended by `radius` columns of raw log-odds
  from each neighbour (two ppermutes along 'm'; an edge tile extends only
  towards its neighbour, so K3's own zero boundary stands for the world's
  edge, as the JAX blur's zero halo does), then the centre w_loc columns;
- LL halo: one column of the field from each neighbour, log(1 / max_range)
  at the world's edges (gridmap_slam_tpu/parallel/tiled.py:333-340);
- scores: K1's tile variant (each beam counted on the tile that owns its
  base column) summed over 'm' by a psum, in the candidate schedule of
  `_match_tiled` (tiled.py:227-293): the coarse stage at full resolution,
  bilinear, over every `coarse_beam_stride`-th beam, whatever the config's
  coarse_halfres and coarse_nearest say; the prior and the argmax of
  ops/matcher;
- weights, the strongest particle and the resample over 'p' as
  parallel/shmap.py;
- map update: K2 on the tile at the tile's origin
  origin + (j * w_loc * res, 0), float32 as the JAX engine computes it.

`TileField`, `tile_stage` and `tile_pool` let ops/matcher.
correlative_match_batch score a field split over 'm'; the sharded RBPF
(parallel/sharded.py) uses them with the RBPF's own schedule.

Requires map width % n_m == 0 and a blur radius no wider than a tile
(mesh.halo_cols refuses a wider halo).
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from ..models.shared import SharedMapSLAM, match_particles
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.cuda.matcher import stage_scores_tile
from ..ops.matcher import half_resolution
from ..types import Frame
from .mesh import axis_index, axis_size, halo_cols, psum, shard_state
from .shmap import MeshStep, finish_step, local_draws, local_particles


@dataclasses.dataclass
class TileField:
    """A log-likelihood field split over 'm': `ext` (G, H, w_loc + 2) is
    this rank's column tile [c0, c0 + w_loc) with one column of each
    neighbour (log(1 / max_range) at the world's edges)."""

    ext: torch.Tensor
    c0: int
    w_loc: int
    n_m: int


def tile_geometry(cfg, mesh):
    """(w_loc, c0) of this rank's tile; raises unless n_m divides W."""
    w, n_m = cfg.map.cells_x, axis_size(mesh, "m")
    if w % n_m:
        raise ValueError(f"a map {w} cells wide does not split into {n_m} "
                         f"column tiles")
    w_loc = w // n_m
    return w_loc, axis_index(mesh, "m") * w_loc


def tiled_ll_field(lo_tiles, taps, mesh, *, z_hit: float, max_range: float,
                   w_loc: int, c0: int) -> TileField:
    """K3 on (G, H, w_loc) log-odds tiles extended by the blur radius from
    each neighbour (raw log-odds: K3's evidence window sees the
    neighbour's cells; nothing at the world's edges), cut back to the
    tile, then the one-column LL halo."""
    r = (taps.shape[0] - 1) // 2
    j = axis_index(mesh, "m")
    ext = halo_cols(lo_tiles, r, mesh, fill=None) if r else lo_tiles
    llf = log_likelihood_field_batch(ext.contiguous(), taps, z_hit=z_hit,
                                     max_range=max_range)
    left = r if j > 0 else 0
    llf = llf[..., left:left + w_loc]
    return TileField(halo_cols(llf, 1, mesh,
                               fill=math.log(1.0 / max_range)).contiguous(),
                     c0, w_loc, axis_size(mesh, "m"))


def tile_stage(mesh):
    """A `stage` for correlative_match_batch: K1's tile variant on a
    TileField, summed over 'm'."""
    def stage(tf: TileField, px, py, use, pose0, dxs, dys, dts, *,
              resolution, origin, max_range, nearest):
        part = stage_scores_tile(tf.ext, px, py, use, pose0, dxs, dys, dts,
                                 resolution=resolution, origin=origin,
                                 max_range=max_range, c0=tf.c0,
                                 w_loc=tf.w_loc, n_m=tf.n_m, ext=1,
                                 nearest=nearest)
        return psum(part, mesh, "m")
    return stage


def tile_pool(mesh):
    """A `pool` for correlative_match_batch: the 2 x 2 mean-pooled field
    of a TileField (ops/matcher.half_resolution of each tile, then its own
    one-column halo).  Needs even tiles when n_m > 1."""
    def pool(tf: TileField, ll_outside: float) -> TileField:
        if tf.n_m > 1 and tf.w_loc % 2:
            raise ValueError(f"the half-resolution coarse stage needs even "
                             f"tiles, got {tf.w_loc} columns")
        pooled = half_resolution(tf.ext[..., 1:-1], ll_outside)
        return TileField(halo_cols(pooled, 1, mesh,
                                   fill=ll_outside).contiguous(),
                         tf.c0 // 2, -(-tf.w_loc // 2), tf.n_m)
    return pool


def tile_origin(cfg, c0: int):
    """The tile's world origin, origin[0] + c0 * res in float32 as the JAX
    engine's traced arithmetic (tiled.py:383)."""
    f32 = np.float32
    return (float(f32(cfg.map.origin[0]) + f32(c0) * f32(cfg.map.resolution)),
            float(f32(cfg.map.origin[1])))


def make_tiled_step(engine: SharedMapSLAM, mesh, jit: bool = False):
    """The step of the tiled engine (module docstring): particles over 'p',
    map columns over 'm'.  Returns a parallel/shmap.MeshStep (eager, or
    with jit=True compiled) on this rank's shard (init_tiled)."""
    cfg = engine.config
    local_particles(engine, mesh)
    w_loc, c0 = tile_geometry(cfg, mesh)
    s = cfg.sensor
    res = float(cfg.map.resolution)
    t_origin = tile_origin(cfg, c0)
    mc = dataclasses.replace(cfg.matcher, coarse_halfres=False,
                             coarse_nearest=False)
    tiled_cfg = cfg.replace(matcher=mc)
    chunk = cfg.particle_chunk

    def body(state, frame: Frame, draws, out, host_gate):
        normals, u0, inj = local_draws(engine, mesh, draws)
        prep = engine._scan_inputs(frame)
        tf = tiled_ll_field(state.logodds[None], engine.taps, mesh,
                            z_hit=mc.z_hit, max_range=s.max_range,
                            w_loc=w_loc, c0=c0)
        k = state.poses.shape[0]
        ch = chunk if 0 < chunk < k and k % chunk == 0 else k
        poses, scores = match_particles(tiled_cfg, tf, state.poses, normals,
                                        prep, frame.odom, ch,
                                        stage=tile_stage(mesh))

        def integrate(pose, into, win):
            return integrate_scan_batch(
                state.logodds[None], pose[None], prep.keep, *prep.tables,
                resolution=res, origin=t_origin, l_free=s.l_free,
                l_occ=s.l_occ, tol_cells=s.hit_tolerance_cells,
                out=None if into is None else into[None])[0]

        return finish_step(engine, mesh, state, poses, scores, integrate,
                           u0, inj, cfg.resample_fraction, out=out,
                           host_gate=host_gate)

    return MeshStep(body, engine._draw, engine.device, jit)


def init_tiled(engine: SharedMapSLAM, mesh, pose=(0.0, 0.0, 0.0)):
    """This rank's shard of engine.init(pose): its particles and its map
    tile."""
    return shard_state(engine.init(pose), mesh, tiled=True,
                       device=engine.device)
