"""Particle weights and low-variance (systematic) resampling.

Counterpart of gridmap_slam_tpu/ops/resample.py (reference
slam/SLAM.java:120-153, slam/ParticleFilter.java:59-82): draw r ~ U[0, 1/N),
take U_m = r + (m-1)/N and select the first particle whose cumulative weight
exceeds U_m.  The walk is cumsum + searchsorted (side left) at every P; the
JAX package's sort-based rank paths work around slow TPU searchsorted and
are not ported.  The draw r is passed in.
"""

from __future__ import annotations

import torch

from .geometry import wrap_angle


def normalized_weights(log_weights):
    """exp-normalize log weights to a probability vector."""
    w = torch.exp(log_weights - torch.max(log_weights))
    return w / torch.sum(w)


def neff(log_weights):
    """Effective sample size 1 / sum(w^2) (slam/SLAM.java:180-190)."""
    w = normalized_weights(log_weights)
    return 1.0 / torch.sum(w * w)


def systematic_indices(log_weights, u0):
    """Systematic resampling ancestor indices (slam/SLAM.java:133-153).
    u0: the start offset, a draw from U[0, 1/N) (scalar tensor or float)."""
    n = log_weights.shape[0]
    cum = torch.cumsum(normalized_weights(log_weights), 0)
    u = u0 + torch.arange(n, dtype=cum.dtype, device=cum.device) / n
    idx = torch.searchsorted(cum, u)
    return torch.clamp(idx, 0, n - 1)


def weighted_mean_pose(poses, log_weights):
    """Weighted mean pose; theta averaged after wrapping to (-pi, pi]
    (slam/SLAM.java:165-178 — the reference averages constrained angles
    linearly, which is reproduced)."""
    w = normalized_weights(log_weights)
    return torch.stack([torch.sum(poses[:, 0] * w),
                        torch.sum(poses[:, 1] * w),
                        torch.sum(wrap_angle(poses[:, 2]) * w)])
