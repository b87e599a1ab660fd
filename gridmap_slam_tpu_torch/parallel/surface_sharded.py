"""Surface mode on a map split into column tiles over ranks.

Counterpart of gridmap_slam_tpu/parallel/surface_sharded.py: the
1M-particle surface mode composed with map tiling, on a ('p', 'm') mesh.
The map is split into column tiles over 'm' (the layout of
parallel/tiled.py) and the particles over 'p'.  Per scan:

- volume centre: the previous cloud's global weighted mean, propagated by
  the odometry, and the volume's window around it: F7's mesh form's center
  call (a pmax and two psums over 'p'), the window placed on the card;
- crop: the raw log-odds crop, extended by the blur radius, assembled from
  the owning tiles by a masked column gather and one psum over 'm'
  (surface_sharded.py:151-166); the crop's place is a tensor on the card;
- LL field: K3 on the assembled crop, redundantly on every rank;
- correlation: split over 'm' by theta bin (nt padded up to a multiple of
  n_m; a padded bin repeats the last bin's theta and is dropped after the
  gather), then one all_gather over 'm' (:183); with matcher.surface_bf16
  the direct correlation of a rank's bins runs in bf16 (K4), as :181-182;
- taps, weights and resampling over 'p' as parallel/shmap.py;
- map update: K2's window variant on each tile's crop of 2 kc + 8 cells
  (or the whole tile) around the integration pose, placed on the card, at
  the crop's world origin origin + (j w_loc + ix0, iy0) res in float32.

No host read a scan on a 'p' axis of one rank.  Requires W % n_m == 0.
"""

from __future__ import annotations

import math

import torch

from ..models.shared import SharedMapSLAM, _window
from ..ops.cuda.grid_update import integrate_scan_window
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.cuda import fusions
from ..ops.motion import sample_motion
from ..ops.surface import endpoint_images, scan_surface, theta_grid
from ..types import Frame
from .mesh import all_gather, axis_index, axis_size, psum, shard_state
from .shmap import (MeshStep, finish_step, local_draws, local_particles,
                    mesh_window)
from .tiled import tile_geometry


def make_surface_sharded_step(engine: SharedMapSLAM, mesh,
                              jit: bool = False):
    """The map-sharded surface step (module docstring).  Returns a
    parallel/shmap.MeshStep (eager, or with jit=True compiled) on this
    rank's shard (init_surface_sharded)."""
    cfg = engine.config
    mc = cfg.matcher
    local_particles(engine, mesh)
    n_m = axis_size(mesh, "m")
    j = axis_index(mesh, "m")
    h, w_total = cfg.map.cells_y, cfg.map.cells_x
    w_loc, c0 = tile_geometry(cfg, mesh)
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)
    s = cfg.sensor
    if mc.surface_crop_cells > 0:         # 0 = the whole map
        hc, wc = min(mc.surface_crop_cells, h), min(mc.surface_crop_cells,
                                                    w_total)
    else:
        hc, wc = h, w_total
    nt = mc.surface_nt
    dtheta, wrap_theta, t_off = theta_grid(
        nt, math.radians(mc.surface_theta_span_deg))
    kc = int(math.ceil(s.max_range / res)) + 2
    use_fft = (mc.surface_corr == "fft"
               or (mc.surface_corr == "auto"
                   and nt * (2 * kc + 1) ** 2 * hc * wc > 2e10))
    ll_outside = math.log(1.0 / s.max_range)
    nt_loc = -(-nt // n_m)
    ic, icw = min(2 * kc + 8, h), min(2 * kc + 8, w_loc)
    r = cfg.map.likelihood_radius
    hce, wce = min(hc + 2 * r, h), min(wc + 2 * r, w_total)

    # the volume's window: the crop, the crop plus the blur radius (each
    # side clamped to the map apart) and the theta bins
    spec = fusions.WindowSpec(crop=(hc, wc), full=(h, w_total),
                              resolution=res, origin=origin, volume=True,
                              radius=r, ext=(hce, wce), nt=nt, t_off=t_off,
                              dtheta=dtheta)
    # this rank's theta bins (a padded bin repeats the last bin's theta)
    bins = torch.clamp(j * nt_loc + torch.arange(nt_loc), max=nt - 1).to(
        engine.device)

    def body(state, frame: Frame, draws, out, host_gate):
        normals, u0, inj = local_draws(engine, mesh, draws)
        prep = engine._scan_inputs(frame)
        odom = frame.odom
        dev = state.logodds.device
        # the window around the mesh's weighted mean propagated by the
        # odometry (F7's mesh form's center call)
        win = mesh_window(state, odom, mesh, spec)

        # the raw crop plus blur radius, from the tiles that own its columns
        rows = win.ey0 + torch.arange(hce, device=dev)
        cols = win.ex0 + torch.arange(wce, device=dev) - c0
        owned = (cols >= 0) & (cols < w_loc)
        piece = (state.logodds[rows[:, None],
                               cols.clamp(0, w_loc - 1)[None, :]]
                 * owned[None, :].to(state.logodds.dtype))
        lo_ext = psum(piece, mesh, "m")
        llf_ext = log_likelihood_field_batch(
            lo_ext[None], engine.taps, z_hit=mc.z_hit,
            max_range=s.max_range)[0]
        llf_crop = _window(llf_ext, win.oy, win.ox, hc, wc)

        # this rank's theta bins, then the whole volume
        e_stack = endpoint_images(*fusions.endpoint_factors(
            prep.px, prep.py, prep.wgt, win.thetas[bins], kc, res))
        c_local = scan_surface(llf_crop, e_stack, ll_outside,
                               bf16=mc.surface_bf16, fft=use_fft)
        c_vol = all_gather(c_local, mesh, "m", tiled=True)[:nt]
        kw = dict(theta0=win.theta0, dtheta=dtheta, crop_iy0=win.iy0,
                  crop_ix0=win.ix0, resolution=res, origin=origin,
                  wrap_theta=wrap_theta, temp=mc.surface_weight_temp,
                  n_used=prep.n_used)

        # the sample, the climb and the weights' temperature (F4)
        pose_s = sample_motion(state.poses, odom, cfg.motion, normals)
        poses, scores = fusions.score_on_volume(
            c_vol, pose_s, steps=mc.surface_refine_steps, **kw)

        def integrate(pose, into, _):
            # the tile-local crop around the integration pose (F7's crop is
            # the whole map's)
            cx = (pose[0] - origin[0]) / res
            cy = (pose[1] - origin[1]) / res
            win = torch.stack([
                torch.clamp(torch.round(cy).to(torch.int64) - ic // 2, 0,
                            h - ic),
                torch.clamp(torch.round(cx).to(torch.int64) - c0 - icw // 2,
                            0, w_loc - icw)])
            return integrate_scan_window(
                state.logodds, win, pose, prep.keep, *prep.tables,
                size=(ic, icw),
                col0=c0, resolution=res, origin=origin, l_free=s.l_free,
                l_occ=s.l_occ, tol_cells=s.hit_tolerance_cells, out=into)

        return finish_step(engine, mesh, state, poses, scores, integrate,
                           u0, inj, mc.surface_resample_fraction, out=out,
                           host_gate=host_gate)

    return MeshStep(body, engine._draw, engine.device, jit)


def init_surface_sharded(engine: SharedMapSLAM, mesh, pose=(0.0, 0.0, 0.0)):
    """This rank's shard of engine.init(pose), in the tiled engine's layout
    (particles over 'p', map columns over 'm')."""
    return shard_state(engine.init(pose), mesh, tiled=True,
                       device=engine.device)
