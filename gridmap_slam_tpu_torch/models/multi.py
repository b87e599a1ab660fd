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
robot resamples on its own, under its own gate (models/captured.cond: an
IF node a robot in the captured replay; the JAX step's lax.cond sits under
jax.vmap, which XLA compiles to a select of both branches).

`replay` also takes the ticks stacked, (T, R, ...), as the JAX package's
`lax.scan` does (stacked infos); `replay_jit` is its captured form, all the
ticks one CUDA graph replayed once a call (models/captured.py).

The JAX step ignores `freeze_map` and `matcher.enabled` (it always matches
and always integrates); this engine raises ValueError for either instead of
copying that.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from ..config import SlamConfig
from ..ops.cuda import fusions
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.grid import gaussian_kernel
from ..ops.matcher import correlative_match_batch
from ..ops.motion import sample_and_propagate
from ..types import Frame, Odom
from . import captured
from .rbpf import scan_prep


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

    def _draws(self, generator: Optional[torch.Generator], out=None):
        """One tick's draws from `generator`: (normals (R, P, 2), u0 (R,)),
        into the tensors of `out` where it is given (the captured replay's
        static draws)."""
        r, p = self.num_robots, self.config.num_particles
        dev = self.device
        o = (None, None) if out is None else out
        normals = torch.randn((r, p, 2), generator=generator, device=dev,
                              out=o[0])
        u0 = torch.rand((r,), generator=generator, device=dev, out=o[1])
        return normals, torch.mul(u0, 1.0 / p, out=o[1])

    def step(self, state: MultiRobotState, frames: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None, out: Optional[MultiRobotState] = None
             ) -> Tuple[MultiRobotState, MultiStepInfo]:
        """One tick.  frames: a Frame with a leading robot axis R
        (`stack_frames`).  `draws` = (normals (R, P, 2), u0 (R,)) replaces
        the draws from `generator`: each particle's distance and heading
        normals, and each robot's systematic-resampling offset in
        [0, 1/P).  `out`: a state whose tensors receive the new state,
        which is then `out` (it may be `state` itself; the captured replay
        passes its static buffers)."""
        cfg = self.config
        r, p = self.num_robots, cfg.num_particles
        dev = self.device
        normals, u0 = self._draws(generator) if draws is None else draws
        o = out if out is not None else MultiRobotState(None, None, None,
                                                        None)
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)

        # Shared LL field for everyone this tick.
        llf = log_likelihood_field_batch(
            state.logodds[None], self.taps, z_hit=cfg.matcher.z_hit,
            max_range=cfg.sensor.max_range)
        odom = frames.odom
        # every robot's scan once a tick (F6 on the card, (R, B)): deskewed,
        # its bin tables, endpoints, used and coarse beams, and each
        # robot's map-update gate (its large-rotation skip)
        prep = scan_prep(cfg, frames)
        per_robot = Odom(odom.d_center[:, None], odom.d_theta[:, None])
        pose_s, prior = sample_and_propagate(state.poses, per_robot,
                                             cfg.motion, normals)
        best, scores = correlative_match_batch(
            llf, prep, pose_s.reshape(r * p, 3), odom,
            matcher_cfg=cfg.matcher, motion_cfg=cfg.motion, resolution=res,
            origin=origin, max_range=cfg.sensor.max_range,
            prior_center_b=prior.reshape(r * p, 3))
        poses = best.reshape(r, p, 3)
        lw = scores.reshape(r, p)
        if cfg.accumulate_weights:
            lw = lw + state.log_weights
        # every robot's weights' tail in one call (F7 on the card): Neff,
        # the strongest particle and its pose, and the gate
        tail = fusions.weights(lw, poses,
                               resample_fraction=cfg.resample_fraction)
        best_poses = tail.best_pose

        # per-robot map deltas at the strongest poses: K2 into zero maps,
        # one bin table a robot, then the large-rotation skip a robot
        keep = prep.keep
        deltas = integrate_scan_batch(
            torch.zeros((r,) + tuple(state.logodds.shape),
                        dtype=torch.float32, device=dev),
            best_poses, torch.ones((), device=dev),
            *prep.tables, resolution=res,
            origin=origin, l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
            tol_cells=cfg.sensor.hit_tolerance_cells)
        deltas = keep[:, None, None] * deltas
        total = deltas[0]
        for i in range(1, r):                 # the JAX sum's order
            total = total + deltas[i]
        logodds = torch.add(state.logodds, total, out=o.logodds)

        # per-robot resampling, each robot's gate the JAX step's lax.cond
        # as captured.cond: the identity lands in `out` (or fresh tensors)
        # and a robot's systematic walk (F8 on the card) overwrites its rows
        # where its gate fires
        do_rs = tail.gate
        new_poses = (poses.clone() if out is None
                     else captured.copy_into(out.poses, poses))
        new_lw = (lw.clone() if out is None
                  else captured.copy_into(out.log_weights, lw))
        for i in range(r):
            def resample(i=i):
                fusions.walk(lw[i], u0[i], poses[i], tail.max[i],
                             tail.total[i],
                             gather_weights=not cfg.accumulate_weights,
                             out=(None, new_poses[i], new_lw[i]))
                if cfg.accumulate_weights:
                    new_lw[i].zero_()

            captured.cond(do_rs[i], resample, [new_poses[i], new_lw[i]])
        poses, lw = new_poses, new_lw
        # the weighted mean pose after the resample, every robot in one call
        weighted = fusions.weights(lw, poses).weighted
        new_step = torch.add(state.step, 1, out=o.step)
        new_state = out if out is not None else MultiRobotState(
            poses=poses, log_weights=lw, logodds=logodds, step=new_step)
        info = MultiStepInfo(neff=tail.neff, weighted_pose=weighted,
                             best_pose=best_poses, resampled=do_rs)
        return new_state, info

    def replay(self, state: MultiRobotState, frames,
               generator: Optional[torch.Generator] = None, draws=None):
        """Replay ticks.  `frames` an iterable of Frames with a leading robot
        axis: returns (state, list of infos).  A Frame with leading axes
        (T, R) (`stack_frames` of the ticks): returns (state, MultiStepInfo
        with a leading tick axis), as gridmap_slam_tpu's `lax.scan` does
        (models/multi.py:151-155), and `draws` may replace the generator's
        draws with stacked ones, ((T, R, P, 2) normals, (T, R) u0); one of
        another length raises ValueError."""
        if isinstance(frames, Frame):
            return captured.scan(self._scan_step, self._draws, state, frames,
                                 generator, draws)
        if draws is not None:
            raise ValueError("injected draws need a stacked Frame batch")
        infos = []
        for f in frames:
            state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos

    def replay_jit(self):
        """`replay` of stacked ticks replayed as captured CUDA graphs of
        at most captured.CHUNK_SCANS ticks of `step`, launched in turn,
        their draws inside (on a CPU engine, the same static-buffer loop
        calling the step): the counterpart of `jax.jit(eng.replay)`, with
        the same arguments, results and bits, and the generator left
        where `replay` leaves it.  A graph is captured at the first call
        that needs its length; keep the function to reuse them."""
        return captured.replay_fn(captured.Captured(
            self._scan_step, self._draws, self.device))

    def _scan_step(self, state, frames, draws, out):
        return self.step(state, frames, draws=draws, out=out)
