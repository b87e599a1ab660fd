"""Occupancy-grid numerics: log-odds transforms and the likelihood field.

Counterpart of gridmap_slam_tpu/ops/grid.py.  Reference behavior:
app/Util.java:31-58 (logOdds/invLogOdds), slam/GridMap.java:233-250
(threshold + separable Gaussian blur), app/Util.java:378-474 (separable blur
with zero boundary, kernel generator).  These are the plain versions the
likelihood-field kernel (ops/cuda/likelihood.py) is held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def inv_log_odds(l):
    """logodds -> probability: 1 - 1/(1+e^l) (app/Util.java:42-48)."""
    return 1.0 - 1.0 / (1.0 + torch.exp(l))


def gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    """Normalized 1-D Gaussian kernel with `radius` taps on either side
    (app/Util.java:428-456)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma)) / (np.sqrt(2 * np.pi) * sigma)
    g /= g.sum()
    return g.astype(np.float32)


def blur_separable(img, kernel):
    """Separable blur with zero boundary handling (app/Util.java:378-426):
    out-of-bounds taps contribute 0.  img: (..., H, W); kernel: a sequence
    of 2k+1 floats.  Shifted multiply-adds in tap order, as the JAX package
    sums them."""
    k = (len(kernel) - 1) // 2
    h, w = img.shape[-2:]
    px = F.pad(img, (k, k))
    acc = torch.zeros_like(img)
    for i, kv in enumerate(kernel):
        acc = acc + float(kv) * px[..., i:i + w]
    py = F.pad(acc, (0, 0, k, k))
    out = torch.zeros_like(img)
    for i, kv in enumerate(kernel):
        out = out + float(kv) * py[..., i:i + h, :]
    return out


def threshold_occupancy(logodds):
    """Round probabilities to {0, 0.5, 1} by log-odds sign
    (slam/GridMap.java:238-245)."""
    one = torch.ones_like(logodds)
    return torch.where(logodds > 0.0, one,
                       torch.where(logodds < 0.0, 0.0 * one, 0.5 * one))


def likelihood_field(logodds, kernel):
    """Build the Gaussian-blurred likelihood field from a log-odds map
    (slam/GridMap.java:233-250).  Returns (field, unknown_mask) where
    `unknown_mask` marks cells whose entire blur neighborhood is unexplored
    (the blurred "explored" indicator is zero)."""
    p = threshold_occupancy(logodds)
    field = blur_separable(p, kernel)
    explored = torch.abs(p - 0.5) > 0.25   # cells with any evidence
    evidence = blur_separable(explored.to(logodds.dtype), kernel)
    return field, evidence <= 0.0


def beam_log_likelihood(field_vals, unknown, z_hit: float, max_range: float):
    """Per-beam log p(z_b | x, m) from likelihood-field lookups
    (slam/GridMap.java:261-294): uniform 1/max_range for unexplored cells,
    else z_hit*field + (1-z_hit)/max_range."""
    uniform = 1.0 / max_range
    known_p = z_hit * field_vals + (1.0 - z_hit) * uniform
    p = torch.where(unknown, uniform, known_p)
    return torch.log(torch.clamp(p, min=1e-30))
