"""Multi-robot SLAM: R robots mapping one shared world, in PyTorch.

Counterpart of gridmap_slam_tpu/models/multi.py (BASELINE config 5).  Each
robot runs its own particle belief (pose + weight per particle) against the
same shared occupancy grid; per tick every robot consumes one frame of its
own log, and the map fuses all robots' observations (log-odds updates are
additive, so the R per-robot deltas sum).

Per tick: the shared log-likelihood field is built once (kernel K3 at batch
1); the R * P particles sample their robots' motion and are matched in one
call of the correlative matcher (kernel K1 with one shared field and one
scan a robot, G_f = 1 and G_b = R); each robot's delta is the scan
integrated into a zero map at its strongest particle's pose (kernel K2 at
batch R, one bin table a robot), summed onto the map in robot order; each
robot resamples on its own.

The JAX step ignores `freeze_map` and `matcher.enabled` (it always matches
and always integrates); this engine raises ValueError for either instead of
copying that.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..ops.cuda.grid_update import integrate_scan_batch, scan_bin_tables
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.geometry import deskew_scan
from ..ops.grid import gaussian_kernel
from ..ops.matcher import correlative_match_batch
from ..ops.motion import apply_odometry, sample_motion
from ..ops.resample import neff, systematic_indices, weighted_mean_pose
from ..types import Frame, Odom


@dataclasses.dataclass
class MultiRobotState:
    """poses: (R, P, 3); log_weights: (R, P); logodds: (H, W) shared;
    step: int32 tick counter."""

    poses: torch.Tensor
    log_weights: torch.Tensor
    logodds: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass
class MultiStepInfo:
    neff: torch.Tensor            # (R,)
    weighted_pose: torch.Tensor   # (R, 3), after the resample
    best_pose: torch.Tensor       # (R, 3), the pose each delta was taken at
    resampled: torch.Tensor       # (R,) bool


def stack_frames(frames: Sequence[Frame]) -> Frame:
    """One Frame with a leading robot axis from R frames (one per robot)."""
    def stack(get):
        return torch.stack([get(f) for f in frames])
    return Frame(scan=type(frames[0].scan)(
        *(stack(lambda f, n=fld.name: getattr(f.scan, n))
          for fld in dataclasses.fields(frames[0].scan))),
        odom=Odom(stack(lambda f: f.odom.d_center),
                  stack(lambda f: f.odom.d_theta)),
        t=stack(lambda f: f.t))


class MultiRobotSLAM:
    """R-robot shared-map SLAM for a fixed `SlamConfig` on one device (the
    card unless `device="cpu"` is asked for).  On a CUDA device K1, K2 and
    K3 are the hand-written kernels; on the CPU their plain versions."""

    def __init__(self, config: SlamConfig, num_robots: int, device="cuda"):
        if config.freeze_map:
            raise ValueError(
                "freeze_map=True is refused: the JAX multi-robot step "
                "ignores it and integrates every robot's scan "
                "(gridmap_slam_tpu/models/multi.py:112-121), a fault this "
                "port does not copy")
        if not config.matcher.enabled:
            raise ValueError(
                "matcher.enabled=False is refused: the JAX multi-robot step "
                "ignores it and always runs the correlative matcher "
                "(gridmap_slam_tpu/models/multi.py:99-105), a fault this "
                "port does not copy")
        if config.dtype != "float32":
            raise ValueError(f"the kernels take float32, got {config.dtype}")
        self.config = config
        self.num_robots = num_robots
        self.device = torch.device(device)
        m = config.map
        self.taps = torch.as_tensor(
            gaussian_kernel(m.likelihood_sigma, m.likelihood_radius),
            device=self.device)

    def init(self, poses=None) -> MultiRobotState:
        """poses: (R, 3) start pose per robot (default all zeros)."""
        cfg = self.config
        r, p = self.num_robots, cfg.num_particles
        dev = self.device
        start = (torch.zeros((r, 1, 3), dtype=torch.float32, device=dev)
                 if poses is None else
                 torch.as_tensor(poses, dtype=torch.float32,
                                 device=dev).reshape(r, 1, 3))
        return MultiRobotState(
            poses=start.expand(r, p, 3).clone(),
            log_weights=torch.full((r, p), -math.log(p), dtype=torch.float32,
                                   device=dev),
            logodds=torch.zeros((cfg.map.cells_y, cfg.map.cells_x),
                                dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev))

    def step(self, state: MultiRobotState, frames: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None) -> Tuple[MultiRobotState, MultiStepInfo]:
        """One tick.  frames: a Frame with a leading robot axis R
        (`stack_frames`).  `draws` = (normals (R, P, 2), u0 (R,)) replaces
        the draws from `generator`: each particle's distance and heading
        normals, and each robot's systematic-resampling offset in
        [0, 1/P)."""
        cfg = self.config
        r, p = self.num_robots, cfg.num_particles
        dev = self.device
        if draws is None:
            normals = torch.randn((r, p, 2), generator=generator, device=dev)
            u0 = torch.rand((r,), generator=generator, device=dev) * (1.0 / p)
        else:
            normals, u0 = draws
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)

        # Shared LL field for everyone this tick.
        llf = log_likelihood_field_batch(
            state.logodds[None], self.taps, z_hit=cfg.matcher.z_hit,
            max_range=cfg.sensor.max_range)
        odom = frames.odom
        scan = deskew_scan(frames.scan, odom)                    # (R, B)
        per_robot = Odom(odom.d_center[:, None], odom.d_theta[:, None])
        pose_s = sample_motion(state.poses, per_robot, cfg.motion, normals)
        prior = apply_odometry(state.poses, per_robot)
        best, scores = correlative_match_batch(
            llf, scan, pose_s.reshape(r * p, 3), odom,
            matcher_cfg=cfg.matcher, motion_cfg=cfg.motion, resolution=res,
            origin=origin, max_range=cfg.sensor.max_range,
            prior_center_b=prior.reshape(r * p, 3))
        poses = best.reshape(r, p, 3)
        lw = scores.reshape(r, p)
        if cfg.accumulate_weights:
            lw = lw + state.log_weights
        best_index = torch.argmax(lw, 1)
        best_poses = torch.gather(
            poses, 1, best_index[:, None, None].expand(r, 1, 3))[:, 0]
        neffs = torch.stack([neff(lw[i]) for i in range(r)])

        # per-robot map deltas at the strongest poses: K2 into zero maps,
        # one bin table a robot, then the large-rotation skip a robot
        keep = (torch.abs(odom.d_theta)
                <= math.radians(cfg.skip_update_dtheta_deg)).to(torch.float32)
        deltas = integrate_scan_batch(
            torch.zeros((r,) + tuple(state.logodds.shape),
                        dtype=torch.float32, device=dev),
            best_poses, torch.ones((), device=dev),
            *scan_bin_tables(scan, cfg.beam_lut_bins), resolution=res,
            origin=origin, l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        deltas = keep[:, None, None] * deltas
        total = deltas[0]
        for i in range(1, r):                 # the JAX sum's order
            total = total + deltas[i]
        logodds = state.logodds + total

        # per-robot resampling, as a select on the card
        do_rs = neffs < (p * cfg.resample_fraction)
        new_poses, new_lw = [], []
        for i in range(r):
            idx = torch.where(do_rs[i], systematic_indices(lw[i], u0[i]),
                              torch.arange(p, device=dev))
            new_poses.append(poses[i][idx])
            if cfg.accumulate_weights:
                new_lw.append(torch.where(do_rs[i], torch.zeros_like(lw[i]),
                                          lw[i]))
            else:
                new_lw.append(lw[i][idx])
        poses, lw = torch.stack(new_poses), torch.stack(new_lw)
        weighted = torch.stack([weighted_mean_pose(poses[i], lw[i])
                                for i in range(r)])
        new_state = MultiRobotState(poses=poses, log_weights=lw,
                                    logodds=logodds, step=state.step + 1)
        info = MultiStepInfo(neff=neffs, weighted_pose=weighted,
                             best_pose=best_poses, resampled=do_rs)
        return new_state, info

    def replay(self, state: MultiRobotState, frames: Iterable[Frame],
               generator: Optional[torch.Generator] = None
               ) -> Tuple[MultiRobotState, List[MultiStepInfo]]:
        """Replay a sequence of ticks, each a Frame with a leading robot
        axis; returns (state, infos)."""
        infos = []
        for f in frames:
            state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos
