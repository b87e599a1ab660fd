"""Particle weights and low-variance (systematic) resampling.

Counterpart of gridmap_slam_tpu/ops/resample.py (reference
slam/SLAM.java:120-153, slam/ParticleFilter.java:59-82): draw r ~ U[0, 1/N),
take U_m = r + (m-1)/N and select the first particle whose cumulative weight
exceeds U_m.  The walk is cumsum + searchsorted (side left) at every P; the
JAX package's sort-based rank paths work around slow TPU searchsorted and
are not ported.  The draw r is passed in.  On the card the cumulative sum
is taken in a fixed order (`cumsum_fixed_order`), so a run is bit-identical
from one call to the next.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .geometry import wrap_angle


def normalized_weights(log_weights):
    """exp-normalize log weights to a probability vector."""
    w = torch.exp(log_weights - torch.max(log_weights))
    return w / torch.sum(w)


def neff(log_weights):
    """Effective sample size 1 / sum(w^2) (slam/SLAM.java:180-190)."""
    w = normalized_weights(log_weights)
    return 1.0 / torch.sum(w * w)


def _row_scan(m):
    """Inclusive scan along dim 1 of a (rows, cols) tensor.  A spare zero
    row keeps the tensor from being one row: PyTorch scans the rows of a
    2-D CUDA tensor in a fixed order, but a tensor with a single row goes
    to CUB's decoupled look-back scan, whose order varies between calls."""
    return F.pad(m, (0, 0, 0, 1)).cumsum(1)[:-1]


def blocked_cumsum(x):
    """Inclusive cumulative sum of a 1-D tensor, scanned as about sqrt(n)
    rows of about sqrt(n) and the row totals the same way: every scan is a
    row scan, in a fixed order on the card."""
    n = x.shape[0]
    cols = math.isqrt(max(n - 1, 0)) + 1
    rows = -(-n // cols)
    part = _row_scan(F.pad(x, (0, rows * cols - n)).view(rows, cols))
    carry = _row_scan(part[None, :, -1])[0]      # inclusive, over row totals
    out = torch.cat([part[:1], part[1:] + carry[:-1, None]])
    return out.reshape(-1)[:n]


def cumsum_fixed_order(x):
    """torch.cumsum(x, 0) of a 1-D tensor, bit-identical from call to call.
    On the CPU this is torch.cumsum.  On the card torch.cumsum of a 1-D
    tensor runs CUB's look-back scan, which may add a 1M-weight vector in
    another order each call (1 ulp apart, enough to move a systematic-
    resampling ancestor by hundreds of slots); there it is blocked_cumsum."""
    return blocked_cumsum(x) if x.is_cuda else torch.cumsum(x, 0)


def systematic_indices(log_weights, u0):
    """Systematic resampling ancestor indices (slam/SLAM.java:133-153).
    u0: the start offset, a draw from U[0, 1/N) (scalar tensor or float)."""
    n = log_weights.shape[0]
    cum = cumsum_fixed_order(normalized_weights(log_weights))
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
