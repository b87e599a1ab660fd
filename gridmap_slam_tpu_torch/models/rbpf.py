"""Rao-Blackwellized particle-filter SLAM in PyTorch.

Counterpart of gridmap_slam_tpu/models/rbpf.py (reference slam/SLAM.java,
app/GridMapApp.java:133-212).  Per scan, every particle samples the motion
model, builds its log-likelihood field (kernel K3), refines its pose by
correlative scan matching (kernel K1, three stages), weights itself by
p(z|x,m), and integrates the scan into its own map (kernel K2; skipped for
|dTheta| > 30 deg).  Then Neff is computed and the filter resamples
systematically when Neff < P/2.

On a CUDA device every kernel is the hand-written one; on the CPU each runs
its plain PyTorch version.  The resample gate is a device-side select
(identity indices when it does not fire), so a step never waits on the
host: a warm step on the card makes no synchronizing call (chip_smoke.py
runs one under torch.cuda.set_sync_debug_mode("error")).  Randomness comes
from the `torch.Generator` passed to `step`, or from draws the caller
injects.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Tuple

import torch

from ..config import SlamConfig
from ..ops.cuda.grid_update import integrate_scan_batch, scan_bin_tables
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.geometry import deskew_scan
from ..ops.grid import gaussian_kernel, inv_log_odds
from ..ops.matcher import IMPLS, correlative_match_batch, score_pose
from ..ops.motion import apply_odometry, sample_motion
from ..ops.resample import neff, systematic_indices, weighted_mean_pose
from ..types import Frame, Odom, Scan, SlamState, StepInfo


class RBPF:
    """Particle-filter SLAM engine for a fixed `SlamConfig` on one device:
    the card unless `device="cpu"` is asked for.

    The config's `use_pallas` field has no meaning here: on a CUDA device
    the kernels always run.
    """

    def __init__(self, config: SlamConfig, device="cuda"):
        if config.matcher.impl not in IMPLS:
            raise ValueError(f"matcher.impl={config.matcher.impl!r} is not "
                             f"ported (TPU-only backend); use one of {IMPLS}")
        if config.dtype != "float32":
            raise ValueError(f"the kernels take float32, got {config.dtype}")
        p, chunk = config.num_particles, config.particle_chunk
        if chunk and p > chunk and p % chunk:
            raise ValueError(f"num_particles {p} must be divisible by "
                             f"particle_chunk {chunk}")
        self.config = config
        self.device = torch.device(device)
        m = config.map
        self.taps = torch.as_tensor(
            gaussian_kernel(m.likelihood_sigma, m.likelihood_radius),
            device=self.device)

    # ------------------------------------------------------------------ state
    def init(self, pose=(0.0, 0.0, 0.0)) -> SlamState:
        """All particles at `pose` with blank maps, on the engine's device
        (slam/SLAM.java:65-77)."""
        cfg = self.config
        p = cfg.num_particles
        h, w = cfg.map.cells_y, cfg.map.cells_x
        dev = self.device
        return SlamState(
            poses=torch.tensor(pose, dtype=torch.float32,
                               device=dev).expand(p, 3).clone(),
            log_weights=torch.full((p,), -math.log(p), dtype=torch.float32,
                                   device=dev),
            logodds=torch.zeros((p, h, w), dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev))

    def init_from_map(self, logodds, pose=(0.0, 0.0, 0.0)) -> SlamState:
        """Start with every particle sharing a previously-built (H, W) map."""
        state = self.init(pose)
        lo = torch.as_tensor(logodds, dtype=torch.float32, device=self.device)
        if lo.shape != state.logodds.shape[1:]:
            raise ValueError(f"map shape {tuple(lo.shape)} != configured "
                             f"{tuple(state.logodds.shape[1:])}")
        state.logodds = lo.expand_as(state.logodds).clone()
        return state

    # ------------------------------------------------------------------- step
    def _update_chunk(self, poses, logodds, normals, scan: Scan, odom: Odom,
                      tables, keep):
        """Motion sample, field build, match and map update for a block of
        particles.  Returns (poses, measurement scores, logodds)."""
        cfg = self.config
        mcfg = cfg.map
        origin = (float(mcfg.origin[0]), float(mcfg.origin[1]))
        res = float(mcfg.resolution)
        pose_s = sample_motion(poses, odom, cfg.motion, normals)
        pose_det = apply_odometry(poses, odom)
        llf = log_likelihood_field_batch(logodds, self.taps,
                                         z_hit=cfg.matcher.z_hit,
                                         max_range=cfg.sensor.max_range)
        if cfg.matcher.enabled:
            best, score = correlative_match_batch(
                llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                motion_cfg=cfg.motion, resolution=res, origin=origin,
                max_range=cfg.sensor.max_range, prior_center_b=pose_det)
        else:
            best, score = pose_s, score_pose(
                llf, scan, pose_s, z_hit=cfg.matcher.z_hit, resolution=res,
                origin=origin, max_range=cfg.sensor.max_range)
        new_lo = integrate_scan_batch(
            logodds, best, keep, *tables, resolution=res, origin=origin,
            l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        return best, score, new_lo

    def step(self, state: SlamState, frame: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None) -> Tuple[SlamState, StepInfo]:
        """One scan.  `draws` = (normals (P, 2), u0) replaces the draws from
        `generator`: standard normals for each particle's distance and
        heading noise, and the systematic-resampling offset u0 in
        [0, 1/P).  A generator must be on the engine's device."""
        cfg = self.config
        p = cfg.num_particles
        dev = self.device
        if draws is None:
            normals = torch.randn((p, 2), generator=generator, device=dev)
            u0 = torch.rand((), generator=generator, device=dev) * (1.0 / p)
        else:
            normals, u0 = draws

        scan = deskew_scan(frame.scan, frame.odom)
        odom = frame.odom
        tables = scan_bin_tables(scan, cfg.beam_lut_bins)
        # Large-rotation skip for map integration (slam/SLAM.java:82).
        keep = (torch.abs(odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)).to(torch.float32)
        if cfg.freeze_map:          # localization-only: map never changes
            keep = keep * 0.0

        chunk = cfg.particle_chunk if 0 < cfg.particle_chunk < p else p
        parts = [self._update_chunk(state.poses[s:s + chunk],
                                    state.logodds[s:s + chunk],
                                    normals[s:s + chunk], scan, odom, tables,
                                    keep)
                 for s in range(0, p, chunk)]
        poses, scores, logodds = (torch.cat(x) for x in zip(*parts))

        # Per-scan importance weights: the reference overwrites weights with
        # p(z|x,m) each update (slam/SLAM.java:99); with accumulate_weights
        # the filter multiplies them in (sequential importance sampling).
        log_weights = scores.to(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        n_eff = neff(log_weights)
        best_index = torch.argmax(log_weights)
        # indexing with a 1-element tensor, not the 0-dim one, keeps the
        # index on the card (a 0-dim index is read back to the host)
        best_pose = poses[best_index[None]][0]
        weighted = weighted_mean_pose(poses, log_weights)

        # Auto-resample when Neff < P/2 (app/GridMapApp.java:185-186), as a
        # select on the card: identity indices when the gate does not fire.
        do_resample = n_eff < (p * cfg.resample_fraction)
        idx = torch.where(do_resample, systematic_indices(log_weights, u0),
                          torch.arange(p, device=dev))
        poses = poses[idx]
        logodds = logodds[idx]
        if cfg.accumulate_weights:
            log_weights = torch.where(do_resample,
                                      torch.zeros_like(log_weights),
                                      log_weights)
        else:
            log_weights = log_weights[idx]

        new_state = SlamState(poses=poses, log_weights=log_weights,
                              logodds=logodds, step=state.step + 1)
        info = StepInfo(neff=n_eff, weighted_pose=weighted,
                        best_pose=best_pose, best_index=best_index,
                        best_log_weight=log_weights.max(),
                        resampled=do_resample)
        return new_state, info

    # -------------------------------------------------------------- utilities
    def run_log(self, state: SlamState, frames: Iterable[Frame],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SlamState, List[StepInfo]]:
        """Replay a sequence of frames; returns (state, infos)."""
        infos = []
        for f in frames:
            state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos

    def best_map(self, state: SlamState):
        """Log-odds map of the strongest particle."""
        return state.logodds[torch.argmax(state.log_weights)]

    def combined_occupancy(self, state: SlamState):
        """Cell-wise fused occupancy across particles:
        1 - prod_i(1 - p_i) (app/GridMapApp.java:439-458)."""
        return 1.0 - torch.prod(1.0 - inv_log_odds(state.logodds), dim=0)
