"""Synthetic world + log generator.

The reference's datasets are recordings of a real robot (a TFMini 1-D LiDAR
spun on a stepper turret, robot/esp32/sensor.cpp) saved by DataRecorder.  For
benchmarking and tests we synthesize equivalent logs: a 2-D world of wall
segments, a differential-drive robot driving a scripted path, and a spinning
single-beam LiDAR whose revolution takes finite time — so the generated scans
exhibit the same motion distortion the reference's de-skew corrects
(app/GridMapApp.java:144-175), and odometry is derived from encoder counts
with the reference's quantization (slam/Odometry.java:41-55).

Output is a list of `RecordedFrame` (writable into the reference on-disk
format via io.recording.write_recording) plus the ground-truth trajectory for
ATE evaluation.

A copy of gridmap_slam_tpu/io/synthetic.py; tests/test_torch_config_io.py
holds the two generators and worlds equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from .recording import RecordedFrame


def raycast_segments(origin: np.ndarray, angles: np.ndarray,
                     segments: np.ndarray, max_range: float) -> np.ndarray:
    """Cast rays from `origin` (2,) at world `angles` (B,) against wall
    `segments` (S, 4); returns distances (B,), max_range where nothing hit."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)       # (B, 2)
    a = segments[:, :2]                                       # (S, 2)
    ab = segments[:, 2:] - a                                  # (S, 2)
    ao = a - origin[None, :]                                  # (S, 2)
    # Solve o + t d = a + u ab, i.e. t d - u ab = ao, by Cramer's rule.
    denom = (ab[None, :, 0] * d[:, None, 1]
             - ab[None, :, 1] * d[:, None, 0])                # (B, S)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[None, :, 1] * ab[None, :, 0]
             - ao[None, :, 0] * ab[None, :, 1]) / denom
        u = (d[:, None, 0] * ao[None, :, 1]
             - d[:, None, 1] * ao[None, :, 0]) / denom
    valid = (np.abs(denom) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = np.where(valid, t, np.inf)
    dist = t.min(axis=1)
    return np.minimum(dist, max_range)


def box(x0, y0, x1, y1) -> List[Tuple[float, float, float, float]]:
    return [(x0, y0, x1, y0), (x1, y0, x1, y1),
            (x1, y1, x0, y1), (x0, y1, x0, y0)]


def default_world() -> np.ndarray:
    """A 5x5 m room with two obstacles, fitting the reference 6x6 m map."""
    segs = []
    segs += box(-2.5, -2.5, 2.5, 2.5)
    segs += box(0.8, 0.6, 1.6, 1.2)
    segs += box(-1.8, -1.5, -1.2, -0.8)
    segs += [(-0.5, 2.5, -0.5, 1.2)]          # a wall stub / doorway
    return np.asarray(segs, np.float64)


def multi_room_world(rooms_x: int = 3, rooms_y: int = 3,
                     room: float = 6.0, door: float = 1.0) -> np.ndarray:
    """Grid of connected rooms (BASELINE config 3's "multi-room synthetic
    world"), centered at the origin."""
    segs = []
    w, h = rooms_x * room, rooms_y * room
    x0, y0 = -w / 2, -h / 2
    segs += box(x0, y0, x0 + w, y0 + h)
    for i in range(1, rooms_x):
        x = x0 + i * room
        for j in range(rooms_y):
            lo, hi = y0 + j * room, y0 + (j + 1) * room
            mid = (lo + hi) / 2
            segs += [(x, lo, x, mid - door / 2), (x, mid + door / 2, x, hi)]
    for j in range(1, rooms_y):
        y = y0 + j * room
        for i in range(rooms_x):
            lo, hi = x0 + i * room, x0 + (i + 1) * room
            mid = (lo + hi) / 2
            segs += [(lo, y, mid - door / 2, y), (mid + door / 2, y, hi, y)]
    return np.asarray(segs, np.float64)


@dataclasses.dataclass
class SimParams:
    """Robot/sensor simulation parameters (defaults follow the reference
    hardware: 180 beams/rev at 2 deg, TFMini 100 Hz -> ~1.8 s per revolution,
    encoder 960 counts/wheel-rev, sensor mounted at -pi/2 offset)."""

    beams_per_rev: int = 180
    rev_time: float = 1.8
    max_range: float = 10.0
    sensor_angle_offset: float = -math.pi / 2.0
    wheel_distance: float = 0.22
    wheel_diameter: float = 0.063
    motor_steps_per_rev: int = 960
    range_noise_sd: float = 0.01          # m, LiDAR noise
    encoder_noise_sd: float = 1.0         # counts per revolution interval
    hit_dropout: float = 0.0              # probability a hit is dropped


def simulate_log(world: np.ndarray, controls: Sequence[Tuple[float, float]],
                 params: SimParams = SimParams(), seed: int = 0,
                 start_pose=(0.0, 0.0, 0.0)):
    """Drive the robot with per-revolution (v, omega) controls.

    Returns (frames, gt_poses): frames in the reference recording format
    (odometry from noisy, quantized encoder counts; scans skewed by intra-
    revolution motion) and the ground-truth pose at the END of each revolution
    (the frame the de-skew corrects to, matching where SLAM estimates live).
    """
    rng = np.random.RandomState(seed)
    p = params
    pose = np.asarray(start_pose, np.float64).copy()
    frames: List[RecordedFrame] = []
    gt = []
    t_now = 0.0
    sub = p.beams_per_rev                       # integration substeps
    for (v, om) in controls:
        dt = p.rev_time / sub
        angles = np.empty(sub)
        dists = np.empty(sub)
        # left/right wheel distance accumulated over the revolution
        d_left_true = 0.0
        d_right_true = 0.0
        for i in range(sub):
            # advance pose by one substep (beam i measured at substep end,
            # matching d_i = -(N-i)/N measuring backwards from interval end)
            pose[2] += om * dt
            pose[0] += v * dt * math.cos(pose[2])
            pose[1] += v * dt * math.sin(pose[2])
            d_left_true += (v - om * p.wheel_distance / 2) * dt
            d_right_true += (v + om * p.wheel_distance / 2) * dt
            beam_angle = p.sensor_angle_offset + i * (2 * math.pi / sub)
            world_angle = pose[2] + beam_angle
            dist = raycast_segments(pose[:2], np.array([world_angle]),
                                    world, p.max_range)[0]
            angles[i] = beam_angle
            dists[i] = dist
        t_now += p.rev_time

        hit = dists < p.max_range - 1e-9
        noisy = dists + rng.normal(0.0, p.range_noise_sd, sub) * hit
        if p.hit_dropout > 0:
            drop = rng.uniform(size=sub) < p.hit_dropout
            hit = hit & ~drop
        noisy = np.where(hit, np.clip(noisy, 0.01, p.max_range), p.max_range)

        # Encoder counts: quantized wheel distances + count noise
        # (slam/Odometry.java:41-55 inverted).
        scale = p.motor_steps_per_rev / (math.pi * p.wheel_diameter)
        lc = int(round(d_left_true * scale + rng.normal(0, p.encoder_noise_sd)))
        rc = int(round(d_right_true * scale + rng.normal(0, p.encoder_noise_sd)))
        d_left = lc / scale
        d_right = rc / scale
        frames.append(RecordedFrame(
            t=t_now, d_center=(d_left + d_right) / 2,
            d_theta=(d_right - d_left) / p.wheel_distance,
            angle=angles.copy(), dist=noisy, hit=hit.copy()))
        gt.append(pose.copy())
    return frames, np.asarray(gt)


def square_path_controls(n_revs: int = 40, v: float = 0.15,
                         side_revs: int = 8) -> List[Tuple[float, float]]:
    """Drive a rough square: straights with 90-degree turns spread over two
    revolutions (keeping |dTheta| < 30 deg per rev triggers map updates)."""
    controls = []
    turn_om = (math.pi / 2) / (2 * 1.8)     # 90 deg over 2 revs of 1.8 s
    i = 0
    while len(controls) < n_revs:
        phase = i % (side_revs + 2)
        if phase < side_revs:
            controls.append((v, 0.0))
        else:
            controls.append((v * 0.3, turn_om))
        i += 1
    return controls[:n_revs]
