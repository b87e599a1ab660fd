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

The JAX frontend jit-compiles verify, optimize and rebuild; here each is a
CUDA graph on the card (models/captured.Graphed), captured at its first
call: the verifier over static (max_candidates, B) buffers
(ClosureVerifier), Gauss-Newton at a graph's size (posegraph.
CapturedOptimize) and the keyframes' K2 updates in graphs of
captured.CHUNK_SCANS keyframes, each under an IF node (MapRebuild).  Each
call copies its inputs into the static buffers, replays and returns fresh
tensors with the eager path's bits; the eager forms stay
(`verify_eager`, `posegraph.optimize`, `rebuild_map_eager`).  On the CPU the
same static-buffer code runs, with the body called where the card replays.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cuda.fusions import bin_tables
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.geometry import se2_relative, wrap_angle
from ..ops.grid import gaussian_kernel
from ..types import Scan
from . import posegraph as PG
from .captured import CHUNK_SCANS, Graphed, cond, copy_from_host


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


def _stack_into(buf: Scan, scans) -> None:
    """The scans stacked along a leading axis into buf's leading rows."""
    for f in dataclasses.fields(Scan):
        dst = getattr(buf, f.name)
        torch.stack([getattr(s, f.name) for s in scans],
                    out=dst[:len(scans)])


def _scan_key(scan: Scan) -> tuple:
    return tuple((tuple(getattr(scan, f.name).shape),
                  getattr(scan, f.name).dtype)
                 for f in dataclasses.fields(Scan))


def _empty_scans(scan: Scan, n: int) -> Scan:
    """A Scan of n rows shaped and typed as `scan`, on its device."""
    return Scan(*(getattr(scan, f.name).new_empty(
        (n,) + tuple(getattr(scan, f.name).shape))
        for f in dataclasses.fields(Scan)))


def _zero_scans(scan: Scan, n: int) -> Scan:
    """A Scan of n zero rows (no valid beam) shaped and typed as `scan`, on
    its device."""
    return Scan(*(getattr(scan, f.name).new_zeros(
        (n,) + tuple(getattr(scan, f.name).shape))
        for f in dataclasses.fields(Scan)))


class ClosureVerifier(Graphed):
    """The closure verifier over static buffers at the padded width, the
    counterpart of `jax.jit(jax.vmap(verify))`
    (gridmap_slam_tpu/models/frontend.py:132): the candidates' scans each
    way and their guesses in, `verify(scan_i, scan_j, guesses)`'s rels,
    min scores and consistency out.  Captured at the first call (again for
    a batch of other shapes); each call copies its inputs in and
    replays."""

    def __init__(self, verify, device):
        super().__init__(self._body, device)
        self._verify = verify
        self._key = None
        self.scan_i = self.scan_j = self.guesses = None
        self._out = None

    def _body(self):
        self._out = self._verify(self.scan_i, self.scan_j, self.guesses)

    def __call__(self, scans_i, scans_j, guesses):
        """scans_i, scans_j: C scans (B,) each; guesses: (C, 3) float32 on
        the host.  Returns (rels (C, 3), min_score (C,), consistency
        (C,)) on the device."""
        key = (len(scans_i), _scan_key(scans_i[0]))
        fresh = key != self._key
        if fresh:
            self._key = key
            self.scan_i = _empty_scans(scans_i[0], len(scans_i))
            self.scan_j = _empty_scans(scans_j[0], len(scans_j))
            self.guesses = torch.empty((len(scans_i), 3),
                                       dtype=torch.float32,
                                       device=self.device)
        _stack_into(self.scan_i, scans_i)
        _stack_into(self.scan_j, scans_j)
        copy_from_host(self.guesses, guesses)
        if fresh:
            self.capture()
        self.run()
        return tuple(t.clone() for t in self._out)


class MapRebuild(Graphed):
    """The rebuild's lax.scan over keyframes
    (gridmap_slam_tpu/models/frontend.py:234-243) as one graph of
    CHUNK_SCANS keyframe steps, launched ceil(n / CHUNK_SCANS) times for n
    keyframes.  A keyframe step reads keyframe k of a scan bank and its
    pose at a counter on the device, builds its bin tables, adds its K2
    delta into a static accumulator (acc <- acc + delta_k, the eager
    loop's order, so the eager loop's bits) and adds one to the counter,
    all under captured.cond(counter < n) with n on the device: on the card
    an IF node each, so the launches read nothing on the host and the last
    one's steps past n do nothing.  The bank holds one spare zero row for
    the select form of the warm-up, which runs a step at counter = n and
    then keeps the old accumulator.  Recaptured only when a longer
    keyframe list exceeds the bank's capacity (models/captured.Captured's
    rule); `launches` counts the last call's graph launches."""

    def __init__(self, slam_config: SlamConfig, device):
        super().__init__(self._body, device, reset=self._reset)
        self.scfg = slam_config
        self._key = None
        self.capacity = self.launches = 0
        self.bank = self.poses = self.acc = None
        self.counter = self.count = None
        self._one = torch.ones((), device=self.device)

    def _reset(self):
        self.acc.zero_()
        self.counter.zero_()

    def _keyframe(self):
        scfg, s, k = self.scfg, self.scfg.sensor, self.counter
        scan = Scan(*(getattr(self.bank, f.name).index_select(0, k)[0]
                      for f in dataclasses.fields(Scan)))
        integrate_scan_batch(
            self.acc, self.poses.index_select(0, k), self._one,
            *bin_tables(scan, scfg.beam_lut_bins),
            resolution=float(scfg.map.resolution),
            origin=(float(scfg.map.origin[0]), float(scfg.map.origin[1])),
            l_free=s.l_free, l_occ=s.l_occ, tol_cells=s.hit_tolerance_cells,
            out=self.acc)
        k.add_(1)

    def _body(self):
        for _ in range(CHUNK_SCANS):
            cond(torch.lt(self.counter, self.count)[0], self._keyframe,
                 [self.acc, self.counter])

    def __call__(self, scans, poses: np.ndarray) -> torch.Tensor:
        """scans: K scans (B,); poses: (K, 3).  Returns the (H, W) map."""
        n = len(scans)
        key = _scan_key(scans[0])
        fresh = key != self._key or n > self.capacity
        if fresh:
            self._key, self.capacity, self.graph = key, n, None
            self.bank = _zero_scans(scans[0], n + 1)
            self.poses = torch.zeros((n + 1, 3), dtype=torch.float32,
                                     device=self.device)
            self.acc = torch.empty((1, self.scfg.map.cells_y,
                                    self.scfg.map.cells_x),
                                   dtype=torch.float32, device=self.device)
            self.counter = torch.empty((1,), dtype=torch.int64,
                                       device=self.device)
            self.count = torch.empty((1,), dtype=torch.int64,
                                     device=self.device)
        _stack_into(self.bank, scans)
        copy_from_host(self.poses[:n], torch.as_tensor(
            np.asarray(poses, np.float32)))
        copy_from_host(self.count, torch.tensor([n]))
        if fresh:
            self.capture()
        self._reset()
        self.launches = -(-n // CHUNK_SCANS)
        for _ in range(self.launches):
            self.run()
        return self.acc[0].clone()


class PoseGraphSLAM:
    """Keyframe pose-graph layered over any pose source (SLAM filter or raw
    odometry), on one device (the card unless `device="cpu"` is asked
    for).  Feed (pose, deskewed scan) per processed scan via `add`."""

    def __init__(self, slam_config: SlamConfig,
                 cfg: FrontendConfig = FrontendConfig(), device="cuda"):
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
        # the compiled pieces, each captured at its first call
        self.verifier = ClosureVerifier(self._verify_fn(), self.device)
        self.solver = PG.CapturedOptimize(self.device)
        self.rebuilder = MapRebuild(slam_config, self.device)

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
    def _verify_fn(self):
        """verify_closure_bidirectional with the closure matcher: the wide
        window of FrontendConfig and no motion prior."""
        scfg, c = self.scfg, self.cfg
        mc = dataclasses.replace(
            scfg.matcher, window_xy=c.closure_window_xy,
            window_theta_deg=c.closure_window_theta_deg,
            coarse_nxy=c.closure_coarse_nxy, coarse_nt=c.closure_coarse_nt,
            extra_refine_stages=c.closure_refine_stages, prior_weight=0.0,
            impl="gather")
        return functools.partial(
            PG.verify_closure_bidirectional, map_cfg=scfg.map,
            matcher_cfg=mc, motion_cfg=scfg.motion, sensor_cfg=scfg.sensor,
            taps=self.taps, beam_lut_bins=scfg.beam_lut_bins)

    def _closure_inputs(self, pairs):
        """The pairs' scans each way, and their guesses (C, 3) in float32
        on the host, one pair at a time as the JAX frontend computes them
        (a vectorised se2_relative can round otherwise)."""
        guesses = torch.stack([
            se2_relative(torch.tensor(self.kf_poses[i], dtype=torch.float32),
                         torch.tensor(self.kf_poses[j], dtype=torch.float32))
            for i, j in pairs])
        return ([self.kf_scans[i] for i, _ in pairs],
                [self.kf_scans[j] for _, j in pairs], guesses)

    def verify_eager(self, pairs):
        """The eager verifier: (rels (C, 3), min_score (C,), consistency
        (C,)) of keyframe pairs, on the device."""
        scans_i, scans_j, guesses = self._closure_inputs(pairs)
        return self._verify_fn()(_stack_scans(scans_i),
                                 _stack_scans(scans_j),
                                 guesses.to(self.device))

    def verify(self, pairs):
        """verify_eager's results from the captured verifier
        (ClosureVerifier)."""
        return self.verifier(*self._closure_inputs(pairs))

    def candidate_pairs(self):
        """(the proposed pairs not yet recorded, the batch padded to
        max_candidates with the first pair as the JAX frontend pads it);
        ([], []) when there is none."""
        props = PG.propose_closures(
            np.asarray(self.kf_poses), min_gap=self.cfg.closure_min_gap,
            max_dist=self.cfg.closure_max_dist,
            max_candidates=self.cfg.max_candidates)
        seen = {(i, j) for i, j, _, _ in self.closures}
        pairs = [(i, j) for i, j in props.pairs if (i, j) not in seen]
        if not pairs:
            return [], []
        return pairs, pairs + [pairs[0]] * (self.cfg.max_candidates
                                            - len(pairs))

    def detect_closures(self) -> int:
        """Propose + verify closure candidates; returns how many were
        accepted and recorded (deduplicated by pair)."""
        pairs, padded = self.candidate_pairs()
        if not pairs:
            return 0
        # one read back, as the JAX frontend's np.asarray
        rels, scores, consist = (t.cpu().numpy() for t in self.verify(padded))
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
        graph, chi2 = self.solver(self.graph(chain_breaks),
                                  iterations=self.cfg.gn_iterations)
        opt = graph.nodes.cpu().numpy().astype(np.float64)
        self.kf_poses = [p for p in opt]
        return opt, chi2.cpu().numpy()

    # ----------------------------------------------------------- map rebuild
    def rebuild_map(self, poses: Optional[np.ndarray] = None) -> torch.Tensor:
        """Re-integrate every keyframe scan at its (optimized) pose into a
        fresh (H, W) grid on the captured rebuild (MapRebuild): one K2
        update a keyframe, acc <- acc + delta_k."""
        if poses is None:
            poses = np.asarray(self.kf_poses)
        return self.rebuilder(self.kf_scans, poses)

    def rebuild_map_eager(self, poses: Optional[np.ndarray] = None
                          ) -> torch.Tensor:
        """rebuild_map's map by the eager loop, one K2 call a keyframe."""
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
                *bin_tables(scan, scfg.beam_lut_bins), **kw)
        return acc[0]
