"""Differential-drive odometry motion model.

Counterpart of gridmap_slam_tpu/ops/motion.py (reference
slam/Odometry.java:60-96): one Gaussian sample for the traveled distance and
one for the heading change, the heading noise applied BEFORE the translation.
The standard normals are drawn by the caller, so a test can feed both
implementations the same draws.  `motion_log_prior` is the Gaussian
log-density of a candidate's deviation from the sampled pose (the intended
spec of the reference's `probabiliyOf`, slam/Odometry.java:99-103).
"""

from __future__ import annotations

import math

import torch

from ..types import Odom
from .geometry import wrap_angle


def noise_scales(odom: Odom, cfg):
    """(sd_center, sd_theta) per slam/Odometry.java:60-69."""
    sd_c = (cfg.base_center + torch.abs(odom.d_center) * cfg.rel_center) / 2.0
    sd_t = math.radians(cfg.base_theta_deg) + torch.abs(odom.d_theta) * cfg.rel_theta
    return sd_c, sd_t


def sample_motion(pose, odom: Odom, cfg, normals):
    """Sample new poses from the motion model (slam/Odometry.java:77-96).

    pose: (..., 3); normals: (..., 2) standard normal draws, column 0 for the
    traveled distance and column 1 for the heading.  Returns (..., 3).
    """
    sd_c, sd_t = noise_scales(odom, cfg)
    d = odom.d_center + sd_c * normals[..., 0]
    th = odom.d_theta + sd_t * normals[..., 1]
    theta = wrap_angle(pose[..., 2] + th)
    x = pose[..., 0] + torch.cos(theta) * d
    y = pose[..., 1] + torch.sin(theta) * d
    return torch.stack([x, y, theta], -1)


def apply_odometry(pose, odom: Odom):
    """Deterministic odometry propagation x0 (+) u (slam/Odometry.java:77-96
    with zero noise): rotate, then translate along the new heading."""
    theta = wrap_angle(pose[..., 2] + odom.d_theta)
    x = pose[..., 0] + torch.cos(theta) * odom.d_center
    y = pose[..., 1] + torch.sin(theta) * odom.d_center
    return torch.stack([x, y, theta], -1)


def motion_log_prior(candidate, sampled, odom: Odom, cfg):
    """Log prior of a candidate pose given the motion-sampled pose.

    Penalizes the candidate's deviation from the sampled pose with the same
    noise scales the sampler used (the role the reference's BOBYQA objective
    intended for `u.probabiliyOf`, slam/GridMap.java:356)."""
    sd_c, sd_t = noise_scales(odom, cfg)
    dx = candidate[..., 0] - sampled[..., 0]
    dy = candidate[..., 1] - sampled[..., 1]
    dt = wrap_angle(candidate[..., 2] - sampled[..., 2])
    return (-(dx * dx + dy * dy) / (2.0 * sd_c * sd_c)
            - (dt * dt) / (2.0 * sd_t * sd_t))
