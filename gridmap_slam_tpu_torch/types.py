"""Core state types as plain dataclasses of tensors.

Counterpart of gridmap_slam_tpu/types.py: poses are (..., 3) tensors, a scan
is a fixed-width structure-of-arrays with a validity mask, and the filter
state is one dataclass of tensors.  `SlamState` carries no PRNG key: the
randomness of a step comes from the `torch.Generator` passed to
`RBPF.step`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Scan:
    """One full LiDAR revolution, fixed width B (reference Observation).

    angle:  (B,) beam angle in the robot frame, radians.
    dist:   (B,) measured distance in meters (max_range when no hit).
    hit:    (B,) bool, True if the beam returned an echo.
    valid:  (B,) bool, False for padding entries.
    """

    angle: torch.Tensor
    dist: torch.Tensor
    hit: torch.Tensor
    valid: torch.Tensor

    @property
    def num_beams(self) -> int:
        return self.angle.shape[-1]

    @staticmethod
    def from_arrays(angle, dist, hit, max_beams: int,
                    max_range: float = 10.0, device="cpu") -> "Scan":
        """Pad/truncate variable-length beam arrays to fixed width."""
        angle = np.asarray(angle, np.float32)
        dist = np.asarray(dist, np.float32)
        hit = np.asarray(hit, bool)
        n = min(angle.shape[0], max_beams)
        pa = np.zeros((max_beams,), np.float32)
        pd = np.full((max_beams,), max_range, np.float32)
        ph = np.zeros((max_beams,), bool)
        pv = np.zeros((max_beams,), bool)
        pa[:n], pd[:n], ph[:n], pv[:n] = angle[:n], dist[:n], hit[:n], True
        return Scan(*(torch.from_numpy(a).to(device)
                      for a in (pa, pd, ph, pv)))


@dataclasses.dataclass
class Odom:
    """Relative odometry for one scan interval (reference Odometry).

    d_center: scalar forward motion of the wheel-base center, meters.
    d_theta:  scalar heading change, radians.
    """

    d_center: torch.Tensor
    d_theta: torch.Tensor

    @staticmethod
    def from_counts(left: int, right: int, robot, device="cpu") -> "Odom":
        """Encoder counts -> (d_center, d_theta) (slam/Odometry.java:41-55)."""
        d_left = left / robot.motor_steps_per_rev * np.pi * robot.wheel_diameter
        d_right = right / robot.motor_steps_per_rev * np.pi * robot.wheel_diameter
        return Odom(
            d_center=torch.tensor((d_left + d_right) / 2.0,
                                  dtype=torch.float32, device=device),
            d_theta=torch.tensor((d_right - d_left) / robot.wheel_distance,
                                 dtype=torch.float32, device=device),
        )


@dataclasses.dataclass
class Frame:
    """One SLAM input: a scan plus the odometry accumulated since the previous
    scan (reference TimeFrame).  `t` is the recording timestamp in seconds."""

    scan: Scan
    odom: Odom
    t: torch.Tensor


@dataclasses.dataclass
class SlamState:
    """Full Rao-Blackwellized particle-filter state.

    poses:       (P, 3) particle poses (x, y, theta).
    log_weights: (P,) unnormalized log importance weights.
    logodds:     (P, H, W) per-particle occupancy grids, log-odds.
    step:        scan counter (int32 scalar tensor).
    """

    poses: torch.Tensor
    log_weights: torch.Tensor
    logodds: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass
class StepInfo:
    """Per-scan diagnostics (reference prints / ImGui readouts)."""

    neff: torch.Tensor            # effective sample size (slam/SLAM.java:180)
    weighted_pose: torch.Tensor   # (3,) weighted mean pose (slam/SLAM.java:165)
    best_pose: torch.Tensor       # (3,) strongest particle's pose
    best_index: torch.Tensor      # index of the strongest particle
    best_log_weight: torch.Tensor
    resampled: torch.Tensor       # bool, whether this step resampled
