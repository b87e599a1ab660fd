"""Shared-map particle filter, in PyTorch.

Counterpart of gridmap_slam_tpu/models/shared.py: one log-odds map for the
whole cloud, and particles that carry only (pose, log-weight).  Two
measurement models:

- `step` / `step_blocked`: every particle runs the full three-stage
  correlative matcher (ops/matcher.py, kernel K1) against the one shared
  field, built once a scan (kernel K3 at batch 1), in blocks of
  `particle_chunk` (or `block`) particles; the scan is then integrated into
  the whole map (kernel K2 at batch 1) and the filter resamples when
  Neff < resample_fraction * P.  `matcher_block_size` sizes the block from
  the matcher's workspace on the card (the `mega_blocked` preset: 1M
  particles in blocks of 500 000).
- `step_surface`: the engine's 1M-particle surface mode (BASELINE config
  3), a per-scan correlation volume (ops/surface.py) sampled at every
  particle's pose.

Both end in the same tail (`_finish`): weights, Neff, the integration pose,
the map update, the resample as a select on the card and the AMCL recovery
injection.

Per surface scan: the volume is centered on the odometry-propagated cloud mean; the
log-likelihood field is built over the volume's crop plus the blur radius
(kernel K3 at batch 1); every particle samples the motion model and reads
its score from the volume; weights, Neff and the integration pose follow;
the scan is integrated once into the shared map (kernel K2 at batch 1, on
a crop of 2*kc + 8 cells around the pose when the map is larger); the
filter resamples when Neff < surface_resample_fraction * P, as a select on
the card, and the AMCL recovery injection replaces a fraction of the
resampled slots with uniform poses.

Host reads a scan: none in `step`.  In surface mode none when the
integration crop covers the map (the `mega` preset); one, the crop's
(iy0, ix0), when it does not (`city`): K2 takes the crop's origin as a
scalar argument.  The volume crop is sliced by index arithmetic on the
card and needs no host read.

Not ported here: surface_bf16, which raises ValueError.  Faults of the JAX
package not copied: it feeds the recovery EMAs the max log-weight after
weight accumulation (models/shared.py:434), so this engine refuses
injection together with accumulate_weights=True; and its step_blocked
(models/shared.py:577-654) skips the recovery EMAs, never injects and
ignores freeze_map, where this engine's step_blocked is `step` with
particle_chunk = block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cuda.grid_update import integrate_scan_batch, scan_bin_tables
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.geometry import deskew_scan, scan_points
from ..ops.grid import gaussian_kernel
from ..ops.matcher import correlative_match_batch, score_pose
from ..ops.motion import apply_odometry, sample_motion
from ..ops.resample import neff, systematic_indices, weighted_mean_pose
from ..ops.surface import (crop_center_cells, pack_neighborhoods,
                           refine_on_surface, sample_surface, scan_surface,
                           splat_endpoint_kernels, theta_grid)
from ..types import Frame, Scan, StepInfo


def matcher_workspace_bytes(cfg: SlamConfig) -> int:
    """Bytes a particle of correlative_match_batch holds on the card at its
    peak: the K1 output of a stage, its prior grid and its total, each
    nt * nxy^2 float32 values, for the larger of the coarse stage and a
    refinement stage (the coarse buffers are freed before the refinement
    stages start).  Default matcher: 3 * 11 * 81 * 4 = 10 692 bytes."""
    mc = cfg.matcher
    cells = max(mc.coarse_nt * mc.coarse_nxy ** 2,
                mc.fine_nt * mc.fine_nxy ** 2)
    return 3 * cells * 4


def matcher_block_size(cfg: SlamConfig, budget_bytes: float = 10e9,
                       granule: int = 256) -> int:
    """Largest particle block whose matcher workspace fits `budget_bytes`
    of device memory (the JAX package's rule, with the workspace of the
    torch matcher, `matcher_workspace_bytes`, in place of the TPU matmul's):
    the budget-derived size, at most num_particles, lowered to the largest
    divisor of num_particles (step_blocked needs block | num_particles).
    The default matcher at 1M particles gives 500 000.  `granule` is kept
    for the JAX signature and unused, as there."""
    del granule
    block = max(1, int(budget_bytes / matcher_workspace_bytes(cfg)))
    block = min(block, cfg.num_particles)
    while cfg.num_particles % block:
        block -= 1
    return block


@dataclasses.dataclass
class SharedMapState:
    """poses: (P, 3); log_weights: (P,); logodds: (H, W), the one shared
    map; step: int32 scan counter; recov: (2,) [l_slow, l_fast], the
    slow/fast EMAs of the max log-weight for the recovery injection
    (unchanged while injection is off)."""

    poses: torch.Tensor
    log_weights: torch.Tensor
    logodds: torch.Tensor
    step: torch.Tensor
    recov: torch.Tensor


def _window(x, y0, x0, hh: int, ww: int):
    """x[y0:y0+hh, x0:x0+ww] for start indices held in tensors on x's
    device (gathered, so the host reads nothing)."""
    if (hh, ww) == tuple(x.shape):
        return x
    rows = y0 + torch.arange(hh, device=x.device)
    cols = x0 + torch.arange(ww, device=x.device)
    return x[rows[:, None], cols[None, :]]


def surface_volume(cfg: SlamConfig, taps, logodds, scan: Scan, center):
    """One scan's likelihood volume around `center` (the odometry-propagated
    cloud mean) and the keyword arguments of sample_surface /
    refine_on_surface.

    The likelihood field (K3, batch 1) is built only over the crop plus the
    blur radius, which reproduces the full-map build exactly on the crop;
    when that extended window does not fit the map, over the whole map.
    Returns (c_vol, tap_kw, kc)."""
    mc = cfg.matcher
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    res = float(cfg.map.resolution)
    h, w = cfg.map.cells_y, cfg.map.cells_x
    if mc.surface_crop_cells > 0:
        hc = min(mc.surface_crop_cells, h)
        wc = min(mc.surface_crop_cells, w)
    else:
        hc, wc = h, w
    iy0, ix0 = crop_center_cells(center[:2], (hc, wc), (h, w), res, origin)

    r = cfg.map.likelihood_radius
    hce, wce = hc + 2 * r, wc + 2 * r
    llf_kw = dict(z_hit=mc.z_hit, max_range=cfg.sensor.max_range)
    if hce <= h and wce <= w:
        ey0 = torch.clamp(iy0 - r, 0, h - hce)
        ex0 = torch.clamp(ix0 - r, 0, w - wce)
        lo_ext = _window(logodds, ey0, ex0, hce, wce)
        llf_ext = log_likelihood_field_batch(lo_ext[None], taps, **llf_kw)[0]
        llf_crop = _window(llf_ext, iy0 - ey0, ix0 - ex0, hc, wc)
    else:
        llf = log_likelihood_field_batch(logodds[None], taps, **llf_kw)[0]
        llf_crop = _window(llf, iy0, ix0, hc, wc)

    nt = mc.surface_nt
    dtheta, wrap_theta, t_off = theta_grid(
        nt, math.radians(mc.surface_theta_span_deg))
    theta0 = center[2] + t_off
    thetas = theta0 + dtheta * torch.arange(nt, dtype=torch.float32,
                                            device=logodds.device)
    px, py = scan_points(scan)
    wgt = (scan.valid & scan.hit).to(llf_crop.dtype)
    # The kernel radius covers every hit endpoint (<= max_range), so the
    # splat's rim clamp never engages.
    kc = int(math.ceil(cfg.sensor.max_range / res)) + 2
    e_stack = splat_endpoint_kernels(px, py, wgt, thetas, kc, res)
    use_fft = (mc.surface_corr == "fft"
               or (mc.surface_corr == "auto"
                   and nt * (2 * kc + 1) ** 2 * hc * wc > 2e10))
    c_vol = scan_surface(llf_crop, e_stack,
                         math.log(1.0 / cfg.sensor.max_range), fft=use_fft)
    tap_kw = dict(theta0=theta0, dtheta=dtheta, crop_iy0=iy0, crop_ix0=ix0,
                  resolution=res, origin=origin, wrap_theta=wrap_theta,
                  packed=pack_neighborhoods(c_vol, wrap_theta))
    return c_vol, tap_kw, kc


def surface_temper(mc, scan: Scan, scores):
    """Surface-mode weight temperature (MatcherConfig.surface_weight_temp:
    0 = auto 1/sqrt(n_valid_hit_beams), 1 = raw product)."""
    if mc.surface_weight_temp == 1.0:
        return scores
    if mc.surface_weight_temp > 0.0:
        return scores * mc.surface_weight_temp
    n_b = torch.clamp((scan.valid & scan.hit).to(scores.dtype).sum(), min=1.0)
    return scores * torch.rsqrt(n_b)


def recovery_update(cfg: SlamConfig, state: SharedMapState, l_ref):
    """AMCL fast/slow EMA update from `l_ref`, the max log-weight of the
    scan.  Returns (recov', p_inject), p_inject None when injection is
    off."""
    mc = cfg.matcher
    a_slow, a_fast = mc.surface_reinject_slow, mc.surface_reinject_fast
    if not (a_slow > 0.0 and a_fast > 0.0):
        return state.recov, None
    r = state.recov
    ema = torch.stack([r[0] + a_slow * (l_ref - r[0]),
                       r[1] + a_fast * (l_ref - r[1])])
    recov = torch.where(state.step == 0, l_ref.expand(2), ema)
    p_inject = torch.clamp(1.0 - torch.exp(recov[1] - recov[0]), 0.0, 0.3)
    return recov, p_inject


def _uniform_poses(m, u):
    """(k, 3) poses uniform over the map extent x [-pi, pi) from (k, 3)
    uniform draws in [0, 1)."""
    return torch.stack([m.origin[0] + u[:, 0] * m.width_m,
                        m.origin[1] + u[:, 1] * m.height_m,
                        (u[:, 2] * 2.0 - 1.0) * math.pi], 1)


def inject_uniform(cfg: SlamConfig, u, poses, p_inject):
    """Replace resample slots [0, p_inject * P) with uniform poses over the
    map extent x the full circle.  u: (P, 3) uniform draws in [0, 1);
    poses: (P, 3).  Returns (poses', mask)."""
    uni = _uniform_poses(cfg.map, u)
    slot = torch.arange(poses.shape[0], device=poses.device)
    take = slot < p_inject * cfg.num_particles
    return torch.where(take[:, None], uni, poses), take


def integration_pose(n_eff, num_particles: int, weighted, best_pose):
    """Pose the shared map is updated at: the argmax-weight particle, except
    when the weights are near-uniform (Neff >= 0.95 P, e.g. the first scan
    into an empty map), where the weighted mean is used."""
    return torch.where(n_eff >= 0.95 * num_particles, weighted, best_pose)


class SharedMapSLAM:
    """Shared-map particle filter for a fixed `SlamConfig` on one device
    (the card unless `device="cpu"` is asked for).
    On a CUDA device K1, K2 and K3 are the hand-written kernels; on the CPU
    their plain versions."""

    def __init__(self, config: SlamConfig, device="cuda"):
        mc = config.matcher
        if config.dtype != "float32":
            raise ValueError(f"the kernels take float32, got {config.dtype}")
        if mc.surface_bf16:
            raise ValueError("matcher.surface_bf16 is not ported: a bf16 "
                             "conv2d on CUDA does not give the "
                             "f32-accumulated volume it needs")
        self.injects = (mc.surface_reinject_slow > 0.0
                        and mc.surface_reinject_fast > 0.0)
        if self.injects and config.accumulate_weights:
            raise ValueError(
                "recovery injection with accumulate_weights=True is refused: "
                "the JAX engine feeds the recovery EMAs the max log-weight "
                "after accumulation (gridmap_slam_tpu/models/shared.py:434), "
                "a fault this port does not copy")
        self.config = config
        self.device = torch.device(device)
        m = config.map
        self.taps = torch.as_tensor(
            gaussian_kernel(m.likelihood_sigma, m.likelihood_radius),
            device=self.device)

    # ------------------------------------------------------------------ state
    def init(self, pose=(0.0, 0.0, 0.0)) -> SharedMapState:
        """All particles at `pose`, blank map, on the engine's device."""
        cfg = self.config
        p = cfg.num_particles
        dev = self.device
        return SharedMapState(
            poses=torch.tensor(pose, dtype=torch.float32,
                               device=dev).expand(p, 3).clone(),
            log_weights=torch.full((p,), -math.log(p), dtype=torch.float32,
                                   device=dev),
            logodds=torch.zeros((cfg.map.cells_y, cfg.map.cells_x),
                                dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            recov=torch.zeros((2,), dtype=torch.float32, device=dev))

    def init_from_map(self, logodds, pose=(0.0, 0.0, 0.0)) -> SharedMapState:
        """Start from a previously built (H, W) shared map (localization,
        checkpoint resume)."""
        state = self.init(pose)
        lo = torch.as_tensor(logodds, dtype=torch.float32, device=self.device)
        if lo.shape != state.logodds.shape:
            raise ValueError(f"map shape {tuple(lo.shape)} != configured "
                             f"{tuple(state.logodds.shape)}")
        state.logodds = lo.clone()
        return state

    def init_uniform(self, logodds, generator: Optional[torch.Generator] = None,
                     draws=None) -> SharedMapState:
        """Kidnapped-robot start: particles uniform over the map extent x
        [-pi, pi) on a known map.  `draws`: (P, 3) uniforms in [0, 1) that
        replace the draws from `generator`."""
        u = draws
        if u is None:
            u = torch.rand((self.config.num_particles, 3),
                           generator=generator, device=self.device)
        state = self.init_from_map(logodds)
        state.poses = _uniform_poses(self.config.map, u)
        return state

    # ------------------------------------------------------------------- step
    def _draws(self, generator, draws):
        """(normals (P, 2), u0, injection uniforms (P, 3) or None): `draws`
        as given, or drawn from `generator` on the engine's device."""
        if draws is not None:
            return draws
        p = self.config.num_particles
        dev = self.device
        normals = torch.randn((p, 2), generator=generator, device=dev)
        u0 = torch.rand((), generator=generator, device=dev) * (1.0 / p)
        inj = (torch.rand((p, 3), generator=generator, device=dev)
               if self.injects else None)
        return normals, u0, inj

    def _scan_inputs(self, frame: Frame):
        """The deskewed scan, its bin tables and the map-update multiplier
        (0 past the large-rotation skip, slam/SLAM.java:82, and always 0
        with freeze_map)."""
        cfg = self.config
        scan = deskew_scan(frame.scan, frame.odom)
        tables = scan_bin_tables(scan, cfg.beam_lut_bins)
        keep = (torch.abs(frame.odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)).to(torch.float32)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0
        return scan, tables, keep

    def step(self, state: SharedMapState, frame: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None) -> Tuple[SharedMapState, StepInfo]:
        """One scan with the per-particle matcher against the shared map, in
        blocks of `particle_chunk` particles (all at once when 0).  `draws`
        as in step_surface."""
        return self._matcher_step(state, frame, self.config.particle_chunk,
                                  generator, draws)

    def step_blocked(self, state: SharedMapState, frame: Frame, block: int,
                     generator: Optional[torch.Generator] = None,
                     draws=None) -> Tuple[SharedMapState, StepInfo]:
        """`step` with particle_chunk = block (block must divide P; size it
        with matcher_block_size): the same result bit for bit, recovery
        EMAs, injection and freeze_map included."""
        return self._matcher_step(state, frame, block, generator, draws)

    def _matcher_step(self, state, frame, chunk, generator, draws):
        cfg = self.config
        p = cfg.num_particles
        chunk = chunk if 0 < chunk < p else p
        if p % chunk:
            raise ValueError(f"num_particles {p} must be divisible by the "
                             f"block {chunk}")
        normals, u0, inj = self._draws(generator, draws)
        scan, tables, keep = self._scan_inputs(frame)
        odom = frame.odom
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        kw = dict(resolution=float(cfg.map.resolution), origin=origin,
                  max_range=cfg.sensor.max_range)
        # the LL field, built once for the shared map (K3 at batch 1)
        llf = log_likelihood_field_batch(
            state.logodds[None], self.taps, z_hit=cfg.matcher.z_hit,
            max_range=cfg.sensor.max_range)
        poses, scores = [], []
        for s in range(0, p, chunk):
            pose = state.poses[s:s + chunk]
            pose_s = sample_motion(pose, odom, cfg.motion,
                                   normals[s:s + chunk])
            if cfg.matcher.enabled:
                best, score = correlative_match_batch(
                    llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                    motion_cfg=cfg.motion,
                    prior_center_b=apply_odometry(pose, odom), **kw)
            else:
                best, score = pose_s, score_pose(
                    llf, scan, pose_s, z_hit=cfg.matcher.z_hit, **kw)
            poses.append(best)
            scores.append(score)
        poses = torch.cat(poses) if len(poses) > 1 else poses[0]
        scores = torch.cat(scores) if len(scores) > 1 else scores[0]
        return self._finish(state, poses, scores, tables, keep, u0, inj,
                            crop=0, resample_fraction=cfg.resample_fraction)

    def step_surface(self, state: SharedMapState, frame: Frame,
                     generator: Optional[torch.Generator] = None,
                     draws=None) -> Tuple[SharedMapState, StepInfo]:
        """One scan in surface mode.  `draws` = (normals (P, 2), u0,
        injection uniforms (P, 3) or None) replaces the draws from
        `generator`: standard normals for each particle's distance and
        heading noise, the systematic-resampling offset u0 in [0, 1/P), and
        the uniforms of the recovery injection (used only when it is on).
        A generator must be on the engine's device."""
        cfg = self.config
        mc = cfg.matcher
        normals, u0, inj = self._draws(generator, draws)
        scan, tables, keep = self._scan_inputs(frame)
        odom = frame.odom

        # Volume center: the previous cloud's weighted mean propagated by
        # this frame's odometry, so the theta span follows a turn.
        center = apply_odometry(
            weighted_mean_pose(state.poses, state.log_weights), odom)
        c_vol, kw, kc = surface_volume(cfg, self.taps, state.logodds, scan,
                                       center)
        pose_s = sample_motion(state.poses, odom, cfg.motion, normals)
        scores = sample_surface(c_vol, pose_s, **kw)
        poses, scores = refine_on_surface(
            c_vol, pose_s, scores, steps=mc.surface_refine_steps, **kw)
        scores = surface_temper(mc, scan, scores)
        # Integration only touches cells within max_range of the pose.
        return self._finish(state, poses, scores, tables, keep, u0, inj,
                            crop=2 * kc + 8,
                            resample_fraction=mc.surface_resample_fraction)

    def _finish(self, state, poses, scores, tables, keep, u0, inj, *,
                crop: int, resample_fraction: float):
        """The tail of every step: weights, Neff, the map update at the
        integration pose (into a crop x crop window when that is smaller
        than the map), the resample gate, the recovery EMAs and the
        injection."""
        cfg = self.config
        p = cfg.num_particles
        log_weights = scores.to(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        n_eff = neff(log_weights)
        best_index = torch.argmax(log_weights)
        # indexing with a 1-element tensor, not the 0-dim one, keeps the
        # index on the card (a 0-dim index is read back to the host)
        best_pose = poses[best_index[None]][0]
        weighted = weighted_mean_pose(poses, log_weights)
        integ_pose = integration_pose(n_eff, p, weighted, best_pose)
        logodds = self._integrate(state.logodds, integ_pose, tables, keep,
                                  crop)

        do_resample = n_eff < (p * resample_fraction)
        recov, p_inject = recovery_update(cfg, state, log_weights.max())
        if p_inject is not None:
            # a kidnap makes every particle uniformly bad, so Neff rises and
            # the gate alone would never fire: injection forces a resample
            do_resample = do_resample | (p_inject > 0.05)

        # Resample as a select on the card: identity indices when the gate
        # does not fire.
        idx = torch.where(do_resample, systematic_indices(log_weights, u0),
                          torch.arange(p, device=self.device))
        new_poses = poses[idx]
        if cfg.accumulate_weights:
            new_lw = torch.where(do_resample, torch.zeros_like(log_weights),
                                 log_weights)
        else:
            new_lw = log_weights[idx]
        if p_inject is not None:
            inj_poses, took = inject_uniform(cfg, inj, new_poses, p_inject)
            inj_lw = torch.where(took, new_lw.mean(), new_lw)
            new_poses = torch.where(do_resample, inj_poses, new_poses)
            new_lw = torch.where(do_resample, inj_lw, new_lw)

        new_state = SharedMapState(poses=new_poses, log_weights=new_lw,
                                   logodds=logodds, step=state.step + 1,
                                   recov=recov)
        info = StepInfo(neff=n_eff, weighted_pose=weighted,
                        best_pose=best_pose, best_index=best_index,
                        best_log_weight=new_lw.max(), resampled=do_resample)
        return new_state, info

    def _integrate(self, logodds, pose, tables, keep, crop: int):
        """The shared map with the scan integrated at `pose` (K2 at batch
        1): into a crop x crop window around the pose when that is smaller
        than the map, else into the whole map."""
        cfg = self.config
        s = cfg.sensor
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)
        kw = dict(resolution=res, l_free=s.l_free, l_occ=s.l_occ,
                  tol_cells=s.hit_tolerance_cells)
        h, w = logodds.shape
        if not 0 < crop < min(h, w):
            return integrate_scan_batch(logodds[None], pose[None], keep,
                                        *tables, origin=origin, **kw)[0]
        iy0, ix0 = crop_center_cells(pose[:2], (crop, crop), (h, w), res,
                                     origin)
        iy0, ix0 = torch.stack([iy0, ix0]).tolist()   # the scan's host read
        # the crop's origin in float32, as the JAX engine computes it
        f32 = np.float32
        c_origin = (float(f32(origin[0]) + f32(ix0) * f32(res)),
                    float(f32(origin[1]) + f32(iy0) * f32(res)))
        win = (slice(iy0, iy0 + crop), slice(ix0, ix0 + crop))
        upd = integrate_scan_batch(logodds[win].contiguous()[None], pose[None],
                                   keep, *tables, origin=c_origin, **kw)[0]
        out = logodds.clone()
        out[win] = upd
        return out

    # -------------------------------------------------------------- utilities
    def run_log(self, state: SharedMapState, frames: Iterable[Frame],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SharedMapState, List[StepInfo]]:
        """Replay a sequence of frames through step_surface; returns
        (state, infos)."""
        infos = []
        for f in frames:
            state, info = self.step_surface(state, f, generator)
            infos.append(info)
        return state, infos

    def replay(self, state: SharedMapState, frames: Iterable[Frame],
               generator: Optional[torch.Generator] = None,
               block: int = 0) -> Tuple[SharedMapState, List[StepInfo]]:
        """Replay a sequence of frames through `step` (block 0) or
        `step_blocked(block)`; returns (state, infos)."""
        infos = []
        for f in frames:
            if block:
                state, info = self.step_blocked(state, f, block, generator)
            else:
                state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos

    def best_map(self, state: SharedMapState):
        """The shared log-odds map (interface parity with RBPF.best_map)."""
        return state.logodds
