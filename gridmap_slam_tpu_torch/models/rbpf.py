"""Rao-Blackwellized particle-filter SLAM in PyTorch.

Counterpart of gridmap_slam_tpu/models/rbpf.py (reference slam/SLAM.java,
app/GridMapApp.java:133-212).  Per scan, every particle samples the motion
model, builds its log-likelihood field (kernel K3), refines its pose by
correlative scan matching (kernel K1, three stages), weights itself by
p(z|x,m), and integrates the scan into its own map (kernel K2; skipped for
|dTheta| > 30 deg).  Then Neff is computed and the filter resamples
systematically when Neff < P/2.

On a CUDA device every kernel is the hand-written one; on the CPU each runs
its plain PyTorch version.  The chunks' maps are written into one
(P, H, W) tensor (the JAX step's lax.map), and the resample gate is the
JAX step's lax.cond as models/captured.cond: the ancestors' indices are
drawn only where it fires (a CUDA-graph IF node in the captured replays,
a select eagerly on the card, a Python branch on the CPU), and the maps
then move once, gathered at those indices (the identity where it does
not fire).  A step never waits on the host: a warm step on the card
makes no synchronizing call (chip_smoke.py runs one under
torch.cuda.set_sync_debug_mode("error")).  Randomness comes
from the `torch.Generator` passed to `step`, or from draws the caller
injects.

`replay` runs a stacked Frame batch as `jax.lax.scan` does (stacked infos);
`replay_jit` is its captured form, the whole log one CUDA graph replayed
once a call, and `step_jit` the step's, one graph a scan
(models/captured.py).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Tuple

import torch

from ..config import SlamConfig
from ..ops.cuda import fusions
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.grid import gaussian_kernel, inv_log_odds
from ..ops.matcher import IMPLS, correlative_match_batch, score_pose
from ..ops.motion import sample_and_propagate
from ..types import Frame, Odom, SlamState, StepInfo
from . import captured


def scan_prep(cfg: SlamConfig, frame: Frame):
    """A step's ScanPrep of its frame (F6 on the card): the scan deskewed
    by the frame's odometry, its bin tables, endpoints, used beams and
    every coarse_beam_stride-th of them, and the map update's gate keep =
    |d_theta| <= skip_update_dtheta_deg (0 with freeze_map)."""
    return fusions.prepare_scan(
        frame.scan, frame.odom, cfg.beam_lut_bins,
        stride=max(int(cfg.matcher.coarse_beam_stride), 1),
        keep_below=math.radians(cfg.skip_update_dtheta_deg),
        freeze=cfg.freeze_map)


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
    def _match_chunk(self, poses, logodds, normals, scan, odom: Odom,
                     out=None):
        """Motion sample, field build and match for a block of particles,
        `scan` the step's ScanPrep.  Returns (poses, measurement scores),
        written into `out` = (poses, scores) where given (the chunk's rows
        of the step's)."""
        cfg = self.config
        mcfg = cfg.map
        origin = (float(mcfg.origin[0]), float(mcfg.origin[1]))
        res = float(mcfg.resolution)
        pose_s, pose_det = sample_and_propagate(poses, odom, cfg.motion,
                                                normals)
        llf = log_likelihood_field_batch(logodds, self.taps,
                                         z_hit=cfg.matcher.z_hit,
                                         max_range=cfg.sensor.max_range)
        if cfg.matcher.enabled:
            return correlative_match_batch(
                llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                motion_cfg=cfg.motion, resolution=res, origin=origin,
                max_range=cfg.sensor.max_range, prior_center_b=pose_det,
                out=out)
        score = score_pose(llf, scan, pose_s, z_hit=cfg.matcher.z_hit,
                           resolution=res, origin=origin,
                           max_range=cfg.sensor.max_range)
        if out is None:
            return pose_s, score
        return out[0].copy_(pose_s), out[1].copy_(score)

    def _draws(self, generator: Optional[torch.Generator], out=None):
        """One scan's draws from `generator`: (normals (P, 2), u0), into the
        tensors of `out` where it is given (the captured replays' static
        draws)."""
        p = self.config.num_particles
        dev = self.device
        o = (None, None) if out is None else out
        normals = torch.randn((p, 2), generator=generator, device=dev,
                              out=o[0])
        u0 = torch.rand((), generator=generator, device=dev, out=o[1])
        return normals, torch.mul(u0, 1.0 / p, out=o[1])

    def step(self, state: SlamState, frame: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None, out: Optional[SlamState] = None
             ) -> Tuple[SlamState, StepInfo]:
        """One scan.  `draws` = (normals (P, 2), u0) replaces the draws from
        `generator`: standard normals for each particle's distance and
        heading noise, and the systematic-resampling offset u0 in
        [0, 1/P).  A generator must be on the engine's device.  `out`: a
        state whose tensors receive the new state, which is then `out`
        (it may be `state` itself; the captured replays pass their static
        buffers)."""
        cfg = self.config
        p = cfg.num_particles
        dev = self.device
        normals, u0 = self._draws(generator) if draws is None else draws

        # The scan once a scan (F6 on the card): deskewed, its bin tables,
        # endpoints, used and coarse beams, and the map update's gate, 0
        # past the large-rotation skip (slam/SLAM.java:82) and always with
        # freeze_map (localization only: the map never changes).
        prep = scan_prep(cfg, frame)
        odom = frame.odom

        # lax.map over the chunks, as XLA compiles it on the donated state:
        # K2 writes each chunk's new maps into its rows of one (P, H, W)
        # tensor, with no concatenation of maps after, and F3 each chunk's
        # best poses and scores into its rows of the step's.  The maps'
        # tensor is made once the first chunk is matched, so the matcher's
        # first field and workspace are gone by then.
        chunk = cfg.particle_chunk if 0 < cfg.particle_chunk < p else p
        mc = cfg.map
        k2 = dict(resolution=float(mc.resolution),
                  origin=(float(mc.origin[0]), float(mc.origin[1])),
                  l_free=cfg.sensor.l_free, l_occ=cfg.sensor.l_occ,
                  tol_cells=cfg.sensor.hit_tolerance_cells)
        poses = torch.empty((p, 3), dtype=torch.float32, device=dev)
        scores = torch.empty((p,), dtype=torch.float32, device=dev)
        maps = None
        for s in range(0, p, chunk):
            lo = state.logodds[s:s + chunk]
            best, _ = self._match_chunk(
                state.poses[s:s + chunk], lo, normals[s:s + chunk], prep,
                odom, out=(poses[s:s + chunk], scores[s:s + chunk]))
            if maps is None:
                maps = torch.empty_like(state.logodds)
            integrate_scan_batch(lo, best, prep.keep, *prep.tables,
                                 out=maps[s:s + chunk], **k2)

        # Per-scan importance weights: the reference overwrites weights with
        # p(z|x,m) each update (slam/SLAM.java:99); with accumulate_weights
        # the filter multiplies them in (sequential importance sampling).
        log_weights = scores.to(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        # The weights' tail (F7 on the card): Neff, the first argmax and its
        # pose, the weighted mean pose and the gate Neff < P/2
        # (app/GridMapApp.java:185-186).
        tail = fusions.weights(log_weights, poses,
                               resample_fraction=cfg.resample_fraction)
        do_resample = tail.gate

        # The resample, the JAX step's lax.cond as captured.cond: the
        # identity's indices, poses and weights land in `out` (or new
        # tensors), and the systematic walk (F8 on the card) overwrites the
        # indices, the poses and the weights (or, accumulating, resets the
        # weights) only where the gate fires; then the maps move once,
        # gathered at those indices.
        o = out if out is not None else SlamState(None, None, None, None)
        acc = cfg.accumulate_weights
        idx = torch.arange(p, device=dev)
        new_poses = (poses.clone() if out is None
                     else captured.copy_into(out.poses, poses))
        new_lw = (log_weights.clone() if out is None
                  else captured.copy_into(out.log_weights, log_weights))

        def resample():
            fusions.walk(log_weights, u0, poses, tail.max, tail.total,
                         gather_weights=not acc,
                         out=(idx, new_poses, None if acc else new_lw))
            if acc:
                new_lw.zero_()

        captured.cond(do_resample, resample, [idx, new_poses, new_lw])
        new_step = torch.add(state.step, 1, out=o.step)
        logodds = torch.index_select(maps, 0, idx, out=o.logodds)

        new_state = out if out is not None else SlamState(
            poses=new_poses, log_weights=new_lw, logodds=logodds,
            step=new_step)
        info = StepInfo(neff=tail.neff, weighted_pose=tail.weighted,
                        best_pose=tail.best_pose,
                        best_index=tail.best_index.to(torch.int32),
                        best_log_weight=new_lw.max(),
                        resampled=do_resample)
        return new_state, info

    # -------------------------------------------------------------- replays
    def _scan_step(self, state, frame, draws, out):
        return self.step(state, frame, draws=draws, out=out)

    def run_log(self, state: SlamState, frames: Iterable[Frame],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SlamState, List[StepInfo]]:
        """Replay a sequence of frames; returns (state, infos)."""
        infos = []
        for f in frames:
            state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos

    def replay(self, state: SlamState, frames: Frame,
               generator: Optional[torch.Generator] = None,
               draws=None) -> Tuple[SlamState, StepInfo]:
        """Replay a stacked Frame batch (`io.frames_to_device`) scan by
        scan, as gridmap_slam_tpu's `lax.scan` does: returns (final state,
        StepInfo with a leading frame axis).  `draws` replaces the
        generator's draws with stacked ones, ((T, P, 2) normals, (T,) u0);
        a leading axis of another length raises ValueError.  With one
        generator seed the bits of `run_log`."""
        return captured.scan(self._scan_step, self._draws, state, frames,
                             generator, draws)

    def replay_jit(self):
        """`replay` with the whole log replayed as captured CUDA graphs of
        at most captured.CHUNK_SCANS scans, launched in turn, their draws
        inside (on a CPU engine, the same static-buffer loop calling the
        step): the same arguments and results, the same bits, and the
        generator left where `replay` leaves it.  A graph is captured at
        the first call that needs its length; keep the function to reuse
        them."""
        return captured.replay_fn(captured.Captured(
            self._scan_step, self._draws, self.device))

    def step_jit(self):
        """`step` as a captured graph: (state, frame, generator=None,
        draws=None) -> (state, info).  The state it returns lives in the
        capture's buffers and is consumed by the next call, which
        overwrites it (the counterpart of donating the state to a jitted
        step): pass it back, and clone it to keep it."""
        return captured.step_fn(captured.Captured(
            self._scan_step, self._draws, self.device))

    def best_map(self, state: SlamState):
        """Log-odds map of the strongest particle."""
        return state.logodds[torch.argmax(state.log_weights)]

    def combined_occupancy(self, state: SlamState):
        """Cell-wise fused occupancy across particles:
        1 - prod_i(1 - p_i) (app/GridMapApp.java:439-458)."""
        return 1.0 - torch.prod(1.0 - inv_log_odds(state.logodds), dim=0)
