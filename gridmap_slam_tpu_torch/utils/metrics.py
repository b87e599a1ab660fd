"""Trajectory metrics (numpy).

A copy of `ate_rmse` and `align_se2` from gridmap_slam_tpu/utils/metrics.py;
tests/test_torch_config_io.py holds the copies equal.
"""

from __future__ import annotations

import numpy as np


def ate_rmse(estimate: np.ndarray, ground_truth: np.ndarray,
             align: bool = False) -> float:
    """Absolute trajectory error (RMSE over xy positions).

    estimate/ground_truth: (T, >=2) arrays of positions (extra columns such as
    theta are ignored).  With align=True, an SE(2) Umeyama alignment (rotation
    + translation, no scale) is applied first — use for gauge-free comparison
    of two SLAM runs; raw (align=False) matches "trajectory in the odometry
    start frame" comparisons against the reference.
    """
    e = np.asarray(estimate, np.float64)[:, :2]
    g = np.asarray(ground_truth, np.float64)[:, :2]
    if e.shape != g.shape:
        raise ValueError(f"shape mismatch {e.shape} vs {g.shape}")
    if align:
        e = align_se2(e, g)
    d = e - g
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def align_se2(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares rigid 2-D alignment of src onto dst (Umeyama, no scale)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(2)
    if np.linalg.det(u @ vt) < 0:
        s[1, 1] = -1.0
    r = u @ s @ vt
    return (src - mu_s) @ r.T + mu_d
