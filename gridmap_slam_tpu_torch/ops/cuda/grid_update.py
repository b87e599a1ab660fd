"""K2: batched dense map update, csrc/grid_update.cu.

Replaces gridmap_slam_tpu/ops/pallas/grid_update.py::integrate_scan_pallas.
`integrate_scan_batch` runs the kernel for a tensor on the card and the
plain version for a tensor on the CPU.  Both read the per-scan bearing-bin
tables of `scan_bin_tables`, shared by every particle.
"""

from __future__ import annotations

import math

import torch

from ...types import Scan
from ..raycast import (bearing_bins, build_beam_lut, cell_bearings,
                       footprint_delta)
from . import _build, check_tensor, stream_handle

launches = 0   # kernel launches since the count was last set to 0


def scan_bin_tables(scan: Scan, n_bins: int):
    """Dense per-bearing-bin beam data, shared across particles.

    Returns (dist, alpha, code) each (n_bins,) float32:
      dist  — measured distance (m) of the nearest beam for this bearing
      alpha — that beam's angle in the robot frame
      code  — 0: invalid/padding, 1: hit, 2: miss
    """
    lut = build_beam_lut(scan, n_bins).to(torch.int64)
    code = torch.where(scan.hit[lut], 1.0, 2.0)
    code = torch.where(scan.valid[lut], code, 0.0)
    return (scan.dist[lut].contiguous(), scan.angle[lut].contiguous(),
            code.to(torch.float32))


def integrate_scan_batch_plain(logodds, poses, keep, bin_dist, bin_alpha,
                               bin_code, *, resolution: float, origin,
                               l_free: float, l_occ: float,
                               tol_cells: float = 2.0):
    """Plain version: ops/raycast's per-cell update read from the bin
    tables.  logodds: (P, H, W); poses: (P, 3); keep: scalar multiplier of
    the update.  Returns the updated (P, H, W)."""
    r, phi = cell_bearings(logodds.shape[-2:], poses, resolution=resolution,
                           origin=origin)
    b = bearing_bins(phi, bin_dist.shape[0])
    code = bin_code[b]
    delta = footprint_delta(
        r, phi, poses[:, 2, None, None], bin_alpha[b], bin_dist[b],
        code < 1.5, code > 0.5, resolution=resolution, l_free=l_free,
        l_occ=l_occ, tol_cells=tol_cells)
    return logodds + keep * delta


def integrate_scan_batch_cuda(logodds, poses, keep, bin_dist, bin_alpha,
                              bin_code, *, resolution: float, origin,
                              l_free: float, l_occ: float,
                              tol_cells: float = 2.0):
    """The kernel.  logodds: (P, H, W) float32 on the card; poses: (P, 3);
    keep: a float or a scalar tensor on the card; bin_*: (n_bins,)."""
    global launches
    fn = "integrate_scan_batch_cuda"
    if logodds.dim() != 3:
        raise ValueError(f"{fn}: logodds must be (P, H, W), got "
                         f"{tuple(logodds.shape)}")
    dev = logodds.device
    p, h, w = logodds.shape
    n_bins = bin_dist.shape[0] if bin_dist.dim() == 1 else -1
    check_tensor(fn, "logodds", logodds, (p, h, w), dev)
    check_tensor(fn, "poses", poses, (p, 3), dev)
    for name, t in (("bin_dist", bin_dist), ("bin_alpha", bin_alpha),
                    ("bin_code", bin_code)):
        check_tensor(fn, name, t, (n_bins,), dev)
    if not isinstance(keep, torch.Tensor):
        keep = torch.tensor(float(keep), dtype=torch.float32, device=dev)
    check_tensor(fn, "keep", keep, (), dev)
    out = torch.empty_like(logodds)
    lib = _build.library()
    code = lib.gs_grid_update(
        logodds.data_ptr(), out.data_ptr(), poses.data_ptr(), keep.data_ptr(),
        bin_dist.data_ptr(), bin_alpha.data_ptr(), bin_code.data_ptr(),
        n_bins, p, h, w, resolution, origin[0], origin[1], l_free, l_occ,
        0.5 * tol_cells * resolution, n_bins / math.tau, stream_handle(dev))
    launches += 1
    _build.check("gs_grid_update", code)
    return out


def integrate_scan_batch(logodds, poses, keep, bin_dist, bin_alpha, bin_code,
                         *, resolution: float, origin, l_free: float,
                         l_occ: float, tol_cells: float = 2.0):
    """Updated (P, H, W) log-odds: logodds + keep * (inverse sensor model of
    the scan seen from each pose)."""
    fn = (integrate_scan_batch_cuda if logodds.is_cuda
          else integrate_scan_batch_plain)
    return fn(logodds, poses, keep, bin_dist, bin_alpha, bin_code,
              resolution=resolution, origin=origin, l_free=l_free,
              l_occ=l_occ, tol_cells=tol_cells)
