"""Differential-drive odometry motion model.

Counterpart of gridmap_slam_tpu/ops/motion.py (reference
slam/Odometry.java:60-96): one Gaussian sample for the traveled distance and
one for the heading change, the heading noise applied BEFORE the translation.
The standard normals are drawn by the caller, so a test can feed both
implementations the same draws.  `motion_log_prior` is the Gaussian
log-density of a candidate's deviation from the sampled pose (the intended
spec of the reference's `probabiliyOf`, slam/Odometry.java:99-103).

On the card the sampler and the propagation are one kernel, F1
(ops/cuda/fusions.py, csrc/fusions.cu), with the bits of their tensor ops
there; `sample_and_propagate` gives both poses from one launch.  On the CPU
they are those tensor ops (fusions.sample_motion_plain and
apply_odometry_plain).
"""

from __future__ import annotations

from ..types import Odom
from .cuda import fusions
from .cuda.fusions import noise_scales
from .geometry import wrap_angle

__all__ = ["noise_scales", "sample_motion", "apply_odometry",
           "sample_and_propagate", "motion_log_prior"]


def sample_motion(pose, odom: Odom, cfg, normals):
    """Sample new poses from the motion model (slam/Odometry.java:77-96).

    pose: (..., 3); normals: (..., 2) standard normal draws, column 0 for the
    traveled distance and column 1 for the heading.  Returns (..., 3).
    """
    return fusions.motion(pose, odom.d_center, odom.d_theta, normals,
                          cfg=cfg)[0]


def apply_odometry(pose, odom: Odom):
    """Deterministic odometry propagation x0 (+) u (slam/Odometry.java:77-96
    with zero noise): rotate, then translate along the new heading."""
    return fusions.motion(pose, odom.d_center, odom.d_theta, None,
                          deterministic=True)[1]


def sample_and_propagate(pose, odom: Odom, cfg, normals):
    """(sample_motion(pose, odom, cfg, normals), apply_odometry(pose, odom))
    from one launch on the card: the matcher's search centers and the
    poses its motion prior is centered at."""
    return fusions.motion(pose, odom.d_center, odom.d_theta, normals,
                          cfg=cfg, deterministic=True)


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
