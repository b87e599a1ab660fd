"""Pose-graph SLAM frontend: keyframes, loop closure, global correction.

Counterpart of gridmap_slam_tpu/models/frontend.py (BASELINE config 4): an
online frontend that

  1. promotes scans to keyframes on travel/turn thresholds,
  2. chains keyframes with odometry edges,
  3. proposes spatially-near / temporally-far closure candidates
     (models/posegraph.propose_closures),
  4. verifies each candidate by correlatively matching the two keyframe
     scans, the whole padded batch at once both ways
     (models/posegraph.verify_closure_bidirectional: K2 with cone fill, K3
     and K1 at batch C),
  5. optimizes the graph by damped Gauss-Newton (models/posegraph.optimize),
  6. rebuilds the global occupancy grid from the optimized poses, chaining
     K2 at batch 1 over the keyframes: acc <- acc + delta_k, the JAX
     package's sum in its order.

Candidate generation and thresholding stay on the host in numpy, as in the
JAX package (they are tiny and data-dependent).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cuda.grid_update import integrate_scan_batch, scan_bin_tables
from ..ops.geometry import se2_relative, wrap_angle
from ..ops.grid import gaussian_kernel
from ..types import Scan
from . import posegraph as PG


@dataclasses.dataclass
class FrontendConfig:
    keyframe_dist: float = 0.3         # m of travel between keyframes
    keyframe_angle_deg: float = 20.0   # or heading change
    closure_min_gap: int = 8           # keyframe index separation
    closure_max_dist: float = 1.2      # m candidate radius
    # Acceptance thresholds for bidirectional closure verification
    # (posegraph.verify_closure_bidirectional).  min_score is the worse of
    # the two directions' PER-BEAM mean measurement log-likelihood at the
    # matched pose: a true closure lands most beams on blurred walls
    # (per-beam ~ -1.0); a visually-wrong match leaks endpoints into known
    # free space (~ -4.6 each), dragging the mean below ~ -1.3.  The
    # forward/reverse composed-transform error catches perceptual aliasing
    # (symmetric rooms score well both ways but disagree on the pose).
    closure_min_score: float = -1.25
    closure_max_consistency: float = 0.25   # m
    max_candidates: int = 32
    # Closure verification search window: much wider than the per-scan
    # matcher (odometry drift across a loop can be large), and with NO
    # motion prior (there is no odometry constraint between loop ends —
    # a prior would pin the match to the drifted guess).
    closure_window_xy: float = 1.0
    closure_window_theta_deg: float = 30.0
    closure_coarse_nxy: int = 15
    closure_coarse_nt: int = 13
    closure_refine_stages: int = 3
    odom_w_xy: float = 200.0
    odom_w_t: float = 400.0
    closure_w_xy: float = 400.0
    closure_w_t: float = 800.0
    gn_iterations: int = 10


def _stack_scans(scans) -> Scan:
    return Scan(*(torch.stack([getattr(s, f.name) for s in scans])
                  for f in dataclasses.fields(Scan)))


class PoseGraphSLAM:
    """Keyframe pose-graph layered over any pose source (SLAM filter or raw
    odometry), on one device.  Feed (pose, deskewed scan) per processed
    scan via `add`."""

    def __init__(self, slam_config: SlamConfig,
                 cfg: FrontendConfig = FrontendConfig(), device="cpu"):
        self.scfg = slam_config
        self.cfg = cfg
        self.device = torch.device(device)
        m = slam_config.map
        self.taps = torch.as_tensor(
            gaussian_kernel(m.likelihood_sigma, m.likelihood_radius),
            device=self.device)
        self.kf_poses: List[np.ndarray] = []
        self.kf_scans: List[Scan] = []
        self.closures: List[Tuple[int, int, np.ndarray, float]] = []

    # ----------------------------------------------------------- keyframes
    def add(self, pose, scan: Scan) -> bool:
        """Consider (pose, scan) for keyframe promotion; returns True if
        promoted.  The scan is kept on the engine's device."""
        if torch.is_tensor(pose):
            pose = pose.detach().cpu().numpy()
        pose = np.asarray(pose, np.float64)
        if self.kf_poses:
            last = self.kf_poses[-1]
            d = np.hypot(*(pose[:2] - last[:2]))
            # in float32, as the JAX frontend computes it
            dth = abs(float(wrap_angle(torch.tensor(pose[2] - last[2],
                                                    dtype=torch.float32))))
            if (d < self.cfg.keyframe_dist
                    and dth < math.radians(self.cfg.keyframe_angle_deg)):
                return False
        self.kf_poses.append(pose)
        self.kf_scans.append(Scan(*(getattr(scan, f.name).to(self.device)
                                    for f in dataclasses.fields(Scan))))
        return True

    @property
    def num_keyframes(self) -> int:
        return len(self.kf_poses)

    # -------------------------------------------------------- loop closure
    def _verify(self, pairs):
        """(rels (C, 3), scores (C,), consistency (C,)) of keyframe pairs,
        as numpy arrays, with the closure matcher: the wide window of
        FrontendConfig and no motion prior."""
        scfg, c = self.scfg, self.cfg
        mc = dataclasses.replace(
            scfg.matcher, window_xy=c.closure_window_xy,
            window_theta_deg=c.closure_window_theta_deg,
            coarse_nxy=c.closure_coarse_nxy, coarse_nt=c.closure_coarse_nt,
            extra_refine_stages=c.closure_refine_stages, prior_weight=0.0,
            impl="gather")
        guesses = torch.stack([
            se2_relative(torch.tensor(self.kf_poses[i], dtype=torch.float32),
                         torch.tensor(self.kf_poses[j], dtype=torch.float32))
            for i, j in pairs]).to(self.device)
        out = PG.verify_closure_bidirectional(
            _stack_scans([self.kf_scans[i] for i, _ in pairs]),
            _stack_scans([self.kf_scans[j] for _, j in pairs]), guesses,
            map_cfg=scfg.map, matcher_cfg=mc,
            motion_cfg=scfg.motion, sensor_cfg=scfg.sensor, taps=self.taps,
            beam_lut_bins=scfg.beam_lut_bins)
        return tuple(t.cpu().numpy() for t in out)

    def detect_closures(self) -> int:
        """Propose + verify closure candidates; returns how many were
        accepted and recorded (deduplicated by pair)."""
        props = PG.propose_closures(
            np.asarray(self.kf_poses), min_gap=self.cfg.closure_min_gap,
            max_dist=self.cfg.closure_max_dist,
            max_candidates=self.cfg.max_candidates)
        seen = {(i, j) for i, j, _, _ in self.closures}
        pairs = [(i, j) for i, j in props.pairs if (i, j) not in seen]
        if not pairs:
            return 0
        # a fixed batch width, as the JAX frontend pads it
        width = self.cfg.max_candidates
        padded = pairs + [pairs[0]] * (width - len(pairs))
        rels, scores, consist = self._verify(padded)
        n = 0
        for k, (i, j) in enumerate(pairs):
            if (scores[k] >= self.cfg.closure_min_score
                    and consist[k] <= self.cfg.closure_max_consistency):
                self.closures.append((i, j, rels[k].astype(np.float64),
                                      float(scores[k])))
                n += 1
        return n

    # --------------------------------------------------------- optimization
    def graph(self, chain_breaks: Tuple[int, ...] = ()) -> PG.PoseGraph:
        """The odometry chain (without the edges i -> i+1 of chain_breaks)
        plus the accepted closures, on the engine's device."""
        poses = np.asarray(self.kf_poses, np.float32)
        ei, ej, ez, ew = PG.odometry_edges(poses, self.cfg.odom_w_xy,
                                           self.cfg.odom_w_t)
        if chain_breaks:
            keep = ~np.isin(np.asarray(ei), np.asarray(chain_breaks,
                                                       np.int32))
            ei, ej, ez, ew = ei[keep], ej[keep], ez[keep], ew[keep]
        if self.closures:
            ci = np.asarray([c[0] for c in self.closures], np.int32)
            cj = np.asarray([c[1] for c in self.closures], np.int32)
            cz = np.asarray([c[2] for c in self.closures], np.float32)
            cw = np.tile(np.asarray([self.cfg.closure_w_xy,
                                     self.cfg.closure_w_xy,
                                     self.cfg.closure_w_t], np.float32),
                         (len(self.closures), 1))
            ei = np.concatenate([ei, ci])
            ej = np.concatenate([ej, cj])
            ez = np.concatenate([ez, cz])
            ew = np.concatenate([ew, cw])
        dev = self.device
        return PG.PoseGraph(
            nodes=torch.as_tensor(poses, device=dev),
            edge_i=torch.as_tensor(ei, dtype=torch.int64, device=dev),
            edge_j=torch.as_tensor(ej, dtype=torch.int64, device=dev),
            edge_z=torch.as_tensor(ez, device=dev),
            edge_w=torch.as_tensor(ew, device=dev))

    def optimize(self, chain_breaks: Tuple[int, ...] = ()
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Build the graph (odometry chain + accepted closures), run GN, and
        return (optimized_poses (K,3), chi2 history).

        chain_breaks: keyframe indices i whose odometry edge i -> i+1 must
        be DROPPED — the multi-robot case (BASELINE config 5): keyframes of
        several robots concatenated into one graph have no odometry
        constraint across the robot seams; alignment there comes from
        cross-robot loop closures instead."""
        graph, chi2 = PG.optimize(self.graph(chain_breaks),
                                  iterations=self.cfg.gn_iterations)
        opt = graph.nodes.cpu().numpy().astype(np.float64)
        self.kf_poses = [p for p in opt]
        return opt, chi2.cpu().numpy()

    # ----------------------------------------------------------- map rebuild
    def rebuild_map(self, poses: Optional[np.ndarray] = None) -> torch.Tensor:
        """Re-integrate every keyframe scan at its (optimized) pose into a
        fresh (H, W) grid, one K2 call a keyframe: acc <- acc + delta_k."""
        scfg = self.scfg
        if poses is None:
            poses = np.asarray(self.kf_poses)
        poses = torch.as_tensor(np.asarray(poses, np.float32),
                                device=self.device)
        s = scfg.sensor
        kw = dict(resolution=float(scfg.map.resolution),
                  origin=(float(scfg.map.origin[0]),
                          float(scfg.map.origin[1])),
                  l_free=s.l_free, l_occ=s.l_occ,
                  tol_cells=s.hit_tolerance_cells)
        acc = torch.zeros((1, scfg.map.cells_y, scfg.map.cells_x),
                          dtype=torch.float32, device=self.device)
        one = torch.ones((), device=self.device)
        for k, scan in enumerate(self.kf_scans):
            acc = integrate_scan_batch(
                acc, poses[k:k + 1], one,
                *scan_bin_tables(scan, scfg.beam_lut_bins), **kw)
        return acc[0]
