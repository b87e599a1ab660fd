"""Dense beam-endpoint occupancy-grid update.

Counterpart of gridmap_slam_tpu/ops/raycast.py (reference
slam/GridMap.java:173-228 with slam/RayIterator.java): every grid cell
computes its own update from the scan.  It finds its bearing and range from
the pose, looks up the beam nearest that bearing in a per-scan table, tests
whether it lies in that beam's ~1-cell-wide ray footprint, and applies the
inverse sensor model by range.  Only the JAX package's direct table-gather
branch is ported; its one-hot GEMM branch works around slow TPU gathers.
"""

from __future__ import annotations

import math

import torch

from ..types import Scan
from .geometry import wrap_angle

_TWO_PI = 6.283185307179586


def build_beam_lut(scan: Scan, n_bins: int):
    """Bearing -> beam-index lookup table, shared across particles.

    Bins cover (-pi, pi]; each bin stores the index of the valid beam with the
    nearest angle (circular distance).  Invalid (padding) beams are never
    selected.  Returns lut: (n_bins,) int32, or (G, n_bins) for a batch of
    G scans (G, B).
    """
    inf = torch.full_like(scan.angle, math.inf)
    ang = torch.where(scan.valid, wrap_angle(scan.angle), inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_ang = torch.gather(ang, -1, order)
    n_valid = torch.clamp(scan.valid.sum(-1, keepdim=True, dtype=torch.int64),
                          min=1)

    centers = -math.pi + (torch.arange(n_bins, dtype=torch.float32,
                                       device=ang.device) + 0.5) * (
        _TWO_PI / n_bins)
    centers = centers.expand(*ang.shape[:-1], n_bins).contiguous()
    pos = torch.searchsorted(sorted_ang, centers)            # side left
    left = (pos - 1) % n_valid                               # Python-style mod
    right = pos % n_valid
    d_left = torch.abs(wrap_angle(centers - torch.gather(sorted_ang, -1,
                                                         left)))
    d_right = torch.abs(wrap_angle(centers - torch.gather(sorted_ang, -1,
                                                          right)))
    pick = torch.where(d_left <= d_right, left, right)
    return torch.gather(order, -1, pick).to(torch.int32)


def bearing_bins(phi, n_bins: int):
    """Bin index in [0, n_bins) of bearings phi (any shape)."""
    b = torch.floor((wrap_angle(phi) + math.pi) * (n_bins / _TWO_PI))
    return torch.clamp(b.to(torch.int64), 0, n_bins - 1)


def cell_bearings(shape, poses, *, resolution: float, origin):
    """Range r and robot-frame bearing phi of every cell center seen from
    each pose.  poses: (..., 3); returns two (..., H, W) tensors."""
    h, w = shape
    dev = poses.device
    ix = torch.arange(w, dtype=torch.float32, device=dev)
    iy = torch.arange(h, dtype=torch.float32, device=dev)
    cx = origin[0] + (ix[None, :] + 0.5) * resolution
    cy = origin[1] + (iy[:, None] + 0.5) * resolution
    dx = cx - poses[..., 0, None, None]
    dy = cy - poses[..., 1, None, None]
    r = torch.sqrt(dx * dx + dy * dy)
    phi = torch.atan2(dy, dx) - poses[..., 2, None, None]
    return r, phi


def footprint_delta(r, phi, theta, alpha, m, hit, valid, *, resolution: float,
                    l_free: float, l_occ: float, tol_cells: float,
                    cone_fill: bool = False):
    """Inverse-sensor-model log-odds delta of cells at range r and bearing
    phi whose nearest beam has angle alpha, distance m and flags hit/valid;
    theta is the pose heading (broadcast against the cells)."""
    dphi = wrap_angle(phi - alpha)
    # Ray footprint: a unit cell is crossed by a line at angle `wba` iff the
    # perpendicular distance from its center is <= (|cos|+|sin|)/2 cells.
    # The 1.001 guard keeps cells whose centers sit exactly on the boundary
    # from flickering in/out on float rounding.
    wba = theta + alpha
    halfw = 0.5005 * (torch.abs(torch.cos(wba))
                      + torch.abs(torch.sin(wba))) * resolution
    perp = r * torch.sin(dphi)
    if cone_fill:
        on_ray = (torch.cos(dphi) > 0.0) & valid
    else:
        on_ray = (torch.abs(perp) <= halfw) & (torch.cos(dphi) > 0.0) & valid

    tol_m = 0.5 * tol_cells * resolution    # hitTolerance/2 in meters
    zero = torch.zeros_like(r)
    free_hit = r < (m - tol_m)
    occ_band = (r >= (m - tol_m)) & (r <= (m + tol_m))
    delta_hit = torch.where(free_hit, l_free,
                            torch.where(occ_band, l_occ, zero))
    delta_miss = torch.where(r < m, l_free, zero)
    return torch.where(on_ray, torch.where(hit, delta_hit, delta_miss), zero)


def integrate_scan(logodds, pose, scan: Scan, lut, *, resolution: float,
                   origin, l_free: float, l_occ: float,
                   tol_cells: float = 2.0, cone_fill: bool = False):
    """Dense per-cell log-odds update for one particle.

    logodds: (H, W); pose: (3,); returns the log-odds *delta* (H, W) so the
    caller can mask the large-rotation skip (slam/SLAM.java:82) with a simple
    multiply.  cone_fill=True carves each beam's whole angular wedge instead
    of its ray footprint (single-scan local maps).
    """
    r, phi = cell_bearings(logodds.shape, pose, resolution=resolution,
                           origin=origin)
    beam = lut.to(torch.int64)[bearing_bins(phi, lut.shape[0])]
    delta = footprint_delta(
        r, phi, pose[2], scan.angle[beam], scan.dist[beam], scan.hit[beam],
        scan.valid[beam], resolution=resolution, l_free=l_free, l_occ=l_occ,
        tol_cells=tol_cells, cone_fill=cone_fill)
    return delta.to(logodds.dtype)
