"""K2: batched dense map update, csrc/grid_update.cu.

Replaces gridmap_slam_tpu/ops/pallas/grid_update.py::integrate_scan_pallas.
`integrate_scan_batch` runs the kernel for a tensor on the card and the
plain version for a tensor on the CPU.  Both read the bearing-bin tables of
`scan_bin_tables`: (n_bins,) tables shared by every particle, or (G, n_bins)
tables of G scans, particle p reading table p // (P // G) (the robots of a
multi-robot step, the closure candidates' local maps).  With cone_fill the
update covers each beam's whole angular wedge instead of its ray footprint
(single-scan local maps, ops/raycast.integrate_scan).

`integrate_scan_window` is K2's window variant: one map, updated only in a
window whose top-left cell is a tensor on the card (the shared-map
engines' integration crop), so that placing it reads nothing back to the
host.

Every entry point takes `out=`: the tensor that receives the updated map
(by default a new one).  It may be `logodds` itself, for the captured
replays' in-place state: each cell is read and then written by the same
thread, and the window variant then rewrites only its window.
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
    """Dense per-bearing-bin beam data of a scan (B,), or of each scan of a
    batch (G, B).

    Returns (dist, alpha, code) each (n_bins,) or (G, n_bins) float32:
      dist  — measured distance (m) of the nearest beam for this bearing
      alpha — that beam's angle in the robot frame
      code  — 0: invalid/padding, 1: hit, 2: miss
    """
    lut = build_beam_lut(scan, n_bins).to(torch.int64)

    def take(a):
        return torch.gather(a, -1, lut)

    code = torch.where(take(scan.hit), 1.0, 2.0)
    code = torch.where(take(scan.valid), code, 0.0)
    return (take(scan.dist).contiguous(), take(scan.angle).contiguous(),
            code.to(torch.float32))


def _bin_reader(bin_dist, bins):
    """A function reading a table at each particle's bins (P, H, W): the
    one table, or table p // (P // G) of (G, n_bins) tables."""
    if bin_dist.dim() == 1:
        return lambda table: table[bins]
    g, n_bins = bin_dist.shape
    group = torch.arange(bins.shape[0], device=bins.device) // (
        bins.shape[0] // g)
    flat = group[:, None, None] * n_bins + bins
    return lambda table: table.reshape(-1)[flat]


def integrate_scan_batch_plain(logodds, poses, keep, bin_dist, bin_alpha,
                               bin_code, *, resolution: float, origin,
                               l_free: float, l_occ: float,
                               tol_cells: float = 2.0,
                               cone_fill: bool = False, out=None):
    """Plain version: ops/raycast's per-cell update read from the bin
    tables.  logodds: (P, H, W); poses: (P, 3); keep: scalar multiplier of
    the update; bin_*: (n_bins,) or (G, n_bins).  Returns the updated
    (P, H, W), in `out` where one is given."""
    r, phi = cell_bearings(logodds.shape[-2:], poses, resolution=resolution,
                           origin=origin)
    read = _bin_reader(bin_dist, bearing_bins(phi, bin_dist.shape[-1]))
    code = read(bin_code)
    delta = footprint_delta(
        r, phi, poses[:, 2, None, None], read(bin_alpha), read(bin_dist),
        code < 1.5, code > 0.5, resolution=resolution, l_free=l_free,
        l_occ=l_occ, tol_cells=tol_cells, cone_fill=cone_fill)
    return torch.add(logodds, keep * delta, out=out)


def integrate_scan_batch_rotated(logodds, poses, keep, bin_dist, bin_alpha,
                                 bin_code, *, resolution: float, origin,
                                 l_free: float, l_occ: float,
                                 tol_cells: float = 2.0,
                                 cone_fill: bool = False):
    """The kernel's arithmetic in plain tensors (csrc/grid_update.cu); it
    documents the kernel and is held to the plain version by the tests, and
    no path calls it.  Only the bin needs an angle: the cell's offset is
    turned into the robot frame with the heading's cos and sin, one atan2
    of it is the bearing already in (-pi, pi], and r cos(dphi), r sin(dphi)
    are that offset's components along and across the bin's beam.  The
    range stays sqrt(dx^2 + dy^2) of the unrotated offset.  A cell whose
    center is the pose (r = 0) takes the plain version's bearing -theta
    and perpendicular distance 0."""
    h, w = logodds.shape[-2:]
    dev = poses.device
    ix = torch.arange(w, dtype=torch.float32, device=dev)
    iy = torch.arange(h, dtype=torch.float32, device=dev)
    dx = origin[0] + (ix[None, :] + 0.5) * resolution - poses[:, 0, None, None]
    dy = origin[1] + (iy[:, None] + 0.5) * resolution - poses[:, 1, None, None]
    r = torch.sqrt(dx * dx + dy * dy)
    c = torch.cos(poses[:, 2, None, None])
    s = torch.sin(poses[:, 2, None, None])
    at_pose = r == 0.0
    xr = torch.where(at_pose, c, dx * c + dy * s)
    yr = torch.where(at_pose, -s, dy * c - dx * s)
    n_bins = bin_dist.shape[-1]
    bins = torch.floor((torch.atan2(yr, xr) + math.pi) * (n_bins / math.tau))
    read = _bin_reader(bin_dist, bins.to(torch.int64).clamp(0, n_bins - 1))
    code, m, alpha = read(bin_code), read(bin_dist), read(bin_alpha)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    along = xr * ca + yr * sa                               # r cos(dphi)
    perp = torch.where(at_pose, 0.0, yr * ca - xr * sa)     # r sin(dphi)
    halfw = 0.5005 * (torch.abs(c * ca - s * sa)
                      + torch.abs(s * ca + c * sa)) * resolution
    on_ray = (along > 0.0) & (code > 0.5)
    if not cone_fill:
        on_ray = on_ray & (torch.abs(perp) <= halfw)
    tol_m = 0.5 * tol_cells * resolution
    zero = torch.zeros_like(r)
    delta_hit = torch.where(r < m - tol_m, l_free,
                            torch.where(r <= m + tol_m, l_occ, zero))
    delta_miss = torch.where(r < m, l_free, zero)
    delta = torch.where(on_ray, torch.where(code < 1.5, delta_hit,
                                            delta_miss), zero)
    return logodds + keep * delta


def integrate_scan_batch_cuda(logodds, poses, keep, bin_dist, bin_alpha,
                              bin_code, *, resolution: float, origin,
                              l_free: float, l_occ: float,
                              tol_cells: float = 2.0,
                              cone_fill: bool = False, out=None):
    """The kernel.  logodds: (P, H, W) float32 on the card; poses: (P, 3);
    keep: a float or a scalar tensor on the card; bin_*: (n_bins,) or
    (G, n_bins) with G dividing P; out: None or a (P, H, W) float32 tensor
    on the card (logodds itself allowed)."""
    global launches
    fn = "integrate_scan_batch_cuda"
    if logodds.dim() != 3 or bin_dist.dim() not in (1, 2):
        raise ValueError(f"{fn}: logodds must be (P, H, W) and the tables "
                         f"(n_bins,) or (G, n_bins), got "
                         f"{tuple(logodds.shape)}, {tuple(bin_dist.shape)}")
    dev = logodds.device
    p, h, w = logodds.shape
    g, n_bins = (1,) * (2 - bin_dist.dim()) + tuple(bin_dist.shape)
    check_tensor(fn, "logodds", logodds, (p, h, w), dev)
    check_tensor(fn, "poses", poses, (p, 3), dev)
    for name, t in (("bin_dist", bin_dist), ("bin_alpha", bin_alpha),
                    ("bin_code", bin_code)):
        check_tensor(fn, name, t, bin_dist.shape, dev)
    if g == 0 or g > 65535 or p % g:
        raise ValueError(f"{fn}: {g} tables must divide the {p} particles "
                         f"and number at most 65535")
    if not isinstance(keep, torch.Tensor):
        keep = torch.tensor(float(keep), dtype=torch.float32, device=dev)
    check_tensor(fn, "keep", keep, (), dev)
    if out is None:
        out = torch.empty_like(logodds)
    check_tensor(fn, "out", out, (p, h, w), dev)
    lib = _build.library()
    code = lib.gs_grid_update(
        logodds.data_ptr(), out.data_ptr(), poses.data_ptr(), keep.data_ptr(),
        bin_dist.data_ptr(), bin_alpha.data_ptr(), bin_code.data_ptr(),
        n_bins, g, p, h, w, resolution, origin[0], origin[1], l_free, l_occ,
        0.5 * tol_cells * resolution, n_bins / math.tau, int(cone_fill),
        stream_handle(dev))
    launches += 1
    _build.check("gs_grid_update", code)
    return out


def integrate_scan_batch(logodds, poses, keep, bin_dist, bin_alpha, bin_code,
                         *, resolution: float, origin, l_free: float,
                         l_occ: float, tol_cells: float = 2.0,
                         cone_fill: bool = False, out=None):
    """Updated (P, H, W) log-odds: logodds + keep * (inverse sensor model of
    the scan seen from each pose, read from its group's tables), in `out`
    where one is given."""
    fn = (integrate_scan_batch_cuda if logodds.is_cuda
          else integrate_scan_batch_plain)
    kw = {} if out is None else {"out": out}
    return fn(logodds, poses, keep, bin_dist, bin_alpha, bin_code,
              resolution=resolution, origin=origin, l_free=l_free,
              l_occ=l_occ, tol_cells=tol_cells, cone_fill=cone_fill, **kw)


def _window_origin(win, col0: int, resolution: float, origin):
    """The window's origin, origin + (col0 + ix0, iy0) * resolution, each
    product and sum rounded once in float32 (the JAX engines' arithmetic),
    as two 0-dim float32 tensors on win's device."""
    f32 = torch.float32
    res = torch.tensor(resolution, dtype=f32, device=win.device)
    ox = torch.tensor(origin[0], dtype=f32, device=win.device)
    oy = torch.tensor(origin[1], dtype=f32, device=win.device)
    return ox + (win[1] + col0).to(f32) * res, oy + win[0].to(f32) * res


def integrate_scan_window_plain(logodds, win, pose, keep, bin_dist,
                                bin_alpha, bin_code, *, size, col0: int = 0,
                                resolution: float, origin, l_free: float,
                                l_occ: float, tol_cells: float = 2.0,
                                cone_fill: bool = False, out=None):
    """Plain version of the window variant: logodds (H, W) with the scan
    integrated from `pose` (3,) into the size = (Hw, Ww) window whose
    top-left cell is win = (iy0, ix0), an int64 tensor; the window's origin
    is `_window_origin` (col0: the map's first column in the map whose
    origin is `origin`).  The window is gathered and scattered by index, so
    nothing is read back to the host.  Returns a new (H, W) map, or `out`
    (which may be logodds) updated."""
    hw, ww = size
    rows = (win[0] + torch.arange(hw, device=win.device))[:, None]
    cols = (win[1] + torch.arange(ww, device=win.device))[None, :]
    w_origin = _window_origin(win, col0, resolution, origin)
    upd = integrate_scan_batch_plain(
        logodds[rows, cols][None], pose[None], keep, bin_dist, bin_alpha,
        bin_code, resolution=resolution, origin=w_origin, l_free=l_free,
        l_occ=l_occ, tol_cells=tol_cells, cone_fill=cone_fill)[0]
    out = logodds.clone() if out is None else _copy_map(out, logodds)
    out[rows, cols] = upd
    return out


def _copy_map(out, logodds):
    """out holding logodds' cells (nothing to copy where out is logodds)."""
    if out.data_ptr() != logodds.data_ptr():
        out.copy_(logodds)
    return out


def integrate_scan_window_cuda(logodds, win, pose, keep, bin_dist, bin_alpha,
                               bin_code, *, size, col0: int = 0,
                               resolution: float, origin, l_free: float,
                               l_occ: float, tol_cells: float = 2.0,
                               cone_fill: bool = False, out=None):
    """The window variant of the kernel.  logodds: (H, W) float32 on the
    card; win: (2,) int64 on the card, inside the map for the window size;
    pose: (3,); keep: a float or a scalar tensor on the card; bin_*:
    (n_bins,).  Returns a new (H, W) map, or `out` (an (H, W) float32
    tensor on the card, logodds itself allowed) updated."""
    global launches
    fn = "integrate_scan_window_cuda"
    if logodds.dim() != 2 or bin_dist.dim() != 1:
        raise ValueError(f"{fn}: logodds must be (H, W) and the tables "
                         f"(n_bins,), got {tuple(logodds.shape)}, "
                         f"{tuple(bin_dist.shape)}")
    dev = logodds.device
    h, w = logodds.shape
    hw, ww = size
    if not (0 < hw <= h and 0 < ww <= w):
        raise ValueError(f"{fn}: window {size} does not fit a "
                         f"{tuple(logodds.shape)} map")
    check_tensor(fn, "logodds", logodds, (h, w), dev)
    check_tensor(fn, "win", win, (2,), dev, dtype=torch.int64)
    check_tensor(fn, "pose", pose, (3,), dev)
    for name, t in (("bin_dist", bin_dist), ("bin_alpha", bin_alpha),
                    ("bin_code", bin_code)):
        check_tensor(fn, name, t, bin_dist.shape, dev)
    if not isinstance(keep, torch.Tensor):
        keep = torch.tensor(float(keep), dtype=torch.float32, device=dev)
    check_tensor(fn, "keep", keep, (), dev)
    n_bins = bin_dist.shape[0]
    if out is None:
        out = logodds.clone()
    else:
        check_tensor(fn, "out", out, (h, w), dev)
        _copy_map(out, logodds)
    lib = _build.library()
    code = lib.gs_grid_update_window(
        logodds.data_ptr(), out.data_ptr(), pose.data_ptr(), keep.data_ptr(),
        bin_dist.data_ptr(), bin_alpha.data_ptr(), bin_code.data_ptr(),
        win.data_ptr(), n_bins, h, w, hw, ww, col0, resolution, origin[0],
        origin[1], l_free, l_occ, 0.5 * tol_cells * resolution,
        n_bins / math.tau, int(cone_fill), stream_handle(dev))
    launches += 1
    _build.check("gs_grid_update_window", code)
    return out


def integrate_scan_window(logodds, win, pose, keep, bin_dist, bin_alpha,
                          bin_code, *, size, col0: int = 0,
                          resolution: float, origin, l_free: float,
                          l_occ: float, tol_cells: float = 2.0,
                          cone_fill: bool = False, out=None):
    """The (H, W) map with the scan integrated from `pose` into its
    size = (Hw, Ww) window at the cell win = (iy0, ix0), a tensor on the
    map's device (see integrate_scan_window_plain), in `out` where one is
    given."""
    fn = (integrate_scan_window_cuda if logodds.is_cuda
          else integrate_scan_window_plain)
    kw = {} if out is None else {"out": out}
    return fn(logodds, win, pose, keep, bin_dist, bin_alpha, bin_code,
              size=size, col0=col0, resolution=resolution, origin=origin,
              l_free=l_free, l_occ=l_occ, tol_cells=tol_cells,
              cone_fill=cone_fill, **kw)
