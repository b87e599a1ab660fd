"""SE(2) geometry, angle utilities, and scan de-skew.

Counterpart of gridmap_slam_tpu/ops/geometry.py.  Reference behavior:
math/MathUtil.java (angle wrap), app/GridMapApp.java:133-175
(motion-distortion de-skew of one revolution).
"""

from __future__ import annotations

import torch

from ..types import Odom, Scan


def wrap_angle(a):
    """Constrain angle(s) to (-pi, pi] (math/MathUtil.java:65-72).

    The atan2(sin, cos) form, as in the JAX package, so +pi maps to +pi.
    """
    return torch.atan2(torch.sin(a), torch.cos(a))


def se2_compose(a, b):
    """Pose composition a ⊕ b for (..., 3) poses."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + b[..., 0] * c - b[..., 1] * s
    y = a[..., 1] + b[..., 0] * s + b[..., 1] * c
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], -1)


def se2_inverse(a):
    """Pose inverse for (..., 3) poses."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(a[..., 0] * c + a[..., 1] * s)
    y = a[..., 0] * s - a[..., 1] * c
    return torch.stack([x, y, -a[..., 2]], -1)


def se2_relative(a, b):
    """Relative pose of b expressed in a's frame: a^-1 ⊕ b."""
    return se2_compose(se2_inverse(a), b)


def deskew_scan(scan: Scan, odom: Odom) -> Scan:
    """Motion-distortion correction of one revolution
    (app/GridMapApp.java:144-175).

    Beam i (of N valid beams, in acquisition order) is transformed back to the
    end-of-revolution frame with time factor d_i = -(N - i)/N:
        x' = dist * cos(angle + dTheta*d_i) + dCenter*d_i
        y' = dist * sin(angle + dTheta*d_i)
    then re-expressed in polar form.  Padding beams keep d_i computed over
    the count of valid beams, matching the reference's variable N.  A batch
    of scans (G, B) takes odometry of shape (G,), one revolution each.
    """
    n = torch.clamp(scan.valid.sum(-1, keepdim=True, dtype=torch.int32),
                    min=1).float()
    i = torch.arange(scan.num_beams, dtype=torch.float32,
                     device=scan.angle.device)
    d_i = -(n - i) / n
    dth = odom.d_theta[..., None] * d_i
    dx = odom.d_center[..., None] * d_i
    xa = scan.dist * torch.cos(scan.angle + dth) + dx
    ya = scan.dist * torch.sin(scan.angle + dth)
    return Scan(angle=torch.atan2(ya, xa), dist=torch.sqrt(xa * xa + ya * ya),
                hit=scan.hit, valid=scan.valid)


def scan_points(scan: Scan):
    """Beam endpoints in the robot frame: (..., B), (..., B)."""
    return scan.dist * torch.cos(scan.angle), scan.dist * torch.sin(scan.angle)
