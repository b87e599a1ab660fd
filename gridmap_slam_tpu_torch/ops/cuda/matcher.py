"""K1: batched correlative-match stage scores, csrc/matcher.cu.

Replaces gridmap_slam_tpu/ops/pallas/matcher.py::stage_scores_pallas_batch.
`stage_scores_batch` runs the kernel for a tensor on the card and the plain
version for a tensor on the CPU.  Candidates are given per particle as
offset vectors (dxs, dys, dts) around each search center pose0, so the
coarse stage and the refinement stages (centered on the running argmax)
share one entry point.

Fields and scans are grouped.  The field is (G_f, H, W) and the scan
(px, py, use) is (G_b, B) or (B,) for G_b = 1; particle p reads field
p // (P // G_f) and scan row p // (P // G_b).  G_f = P is the RBPF (a map a
particle), G_f = 1 the shared-map filters, G_b = R the robots of a
multi-robot step and G_f = G_b = C a batch of closure candidates.  Neither
is ever expanded to one copy a particle.
"""

from __future__ import annotations

import math

import torch

from . import _build, check_tensor, stream_handle

launches = 0   # kernel launches since the count was last set to 0

_MAX_BEAMS = 4096          # three (B,) arrays in 48 KB of shared memory
_MAX_CANDIDATES_XY = 1024  # one thread per (dy, dx) candidate


def _taps(vfield, xi, yi, v_outside):
    """vfield[p // (P // G), yi, xi] for (P, ...) integer coordinates and a
    (G, H, W) vfield, G dividing P; v_outside where the cell lies outside
    the map."""
    g, h, w = vfield.shape
    xi, yi = torch.broadcast_tensors(xi, yi)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    # particles come in G contiguous runs, one a field: row g of the
    # reshaped index holds exactly the particles of field g
    vals = torch.gather(vfield.reshape(g, h * w), 1,
                        idx.reshape(g, -1)).reshape(idx.shape)
    return torch.where(inb, vals, v_outside)


def _bilinear(vfield, fx, fy, v_outside):
    """Bilinearly sample vfield (G, H, W) at fractional cell-center coords
    (fx, fy), each (P, ...); out-of-map corners contribute `v_outside`."""
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v00 = _taps(vfield, x0i, y0i, v_outside)
    v10 = _taps(vfield, x0i + 1, y0i, v_outside)
    v01 = _taps(vfield, x0i, y0i + 1, v_outside)
    v11 = _taps(vfield, x0i + 1, y0i + 1, v_outside)
    return ((1 - tx) * (1 - ty) * v00 + tx * (1 - ty) * v10
            + (1 - tx) * ty * v01 + tx * ty * v11)


def _nearest(vfield, fx, fy, v_outside):
    """Nearest-cell sample (round half to even) of vfield (G, H, W) at
    fractional cell-center coords (fx, fy), each (P, ...)."""
    return _taps(vfield, torch.round(fx).to(torch.int64),
                 torch.round(fy).to(torch.int64), v_outside)


def per_particle(values, p: int):
    """A per-group tensor (G, ...) as (P, ...) for P particles in G
    contiguous runs (particle p reads row p // (P // G)); a 0-dim tensor as
    it is."""
    if values.dim() == 0:
        return values
    return values.repeat_interleave(p // values.shape[0], 0)


def stage_scores_batch_plain(field, px, py, use, pose0, dxs, dys, dts, *,
                             resolution: float, origin, max_range: float,
                             nearest: bool = False):
    """Plain version: ops/matcher._stage_scores for every particle at once,
    on the grouped fields and scans.  Returns (P, nt, ny, nx)."""
    ll_outside = math.log(1.0 / max_range)
    p = pose0.shape[0]
    if px.dim() == 2:              # one scan a group: (P, 1, B) rows
        px, py, use = (per_particle(a, p)[:, None] for a in (px, py, use))
        use = use[:, :, None, None, :]
    theta = pose0[:, 2, None] + dts                           # (P, nt)
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    rx = px * c - py * s                                      # (P, nt, B)
    ry = px * s + py * c
    wx = rx[:, :, None, :] + (pose0[:, 0, None] + dxs)[:, None, :, None]
    wy = ry[:, :, None, :] + (pose0[:, 1, None] + dys)[:, None, :, None]
    fx = (wx - origin[0]) / resolution - 0.5                  # (P, nt, nx, B)
    fy = (wy - origin[1]) / resolution - 0.5                  # (P, nt, ny, B)
    sample = _nearest if nearest else _bilinear
    ll = sample(field, fx[:, :, None, :, :], fy[:, :, :, None, :],
                ll_outside)                                   # (P,nt,ny,nx,B)
    return torch.where(use, ll, 0.0).sum(-1)


def stage_scores_batch_cuda(field, px, py, use, pose0, dxs, dys, dts, *,
                            resolution: float, origin, max_range: float,
                            nearest: bool = False):
    """The kernel.  field: (G_f, H, W) float32 on the card; px, py: (G_b, B)
    or (B,); use: bool of px's shape; pose0: (P, 3); dxs: (P, nx);
    dys: (P, ny); dts: (P, nt); G_f and G_b divide P.  Returns
    (P, nt, ny, nx)."""
    global launches
    fn = "stage_scores_batch_cuda"
    if field.dim() != 3 or px.dim() not in (1, 2) or pose0.dim() != 2 \
            or dxs.dim() != 2 or dys.dim() != 2 or dts.dim() != 2:
        raise ValueError(f"{fn}: need field (G_f, H, W), px (G_b, B) or "
                         f"(B,), pose0 (P, 3) and (P, n) offsets")
    dev = field.device
    g_f, h, w = field.shape
    p = pose0.shape[0]
    g_b, b = (1,) * (2 - px.dim()) + tuple(px.shape)
    nx, ny, nt = dxs.shape[1], dys.shape[1], dts.shape[1]
    check_tensor(fn, "field", field, (g_f, h, w), dev)
    check_tensor(fn, "px", px, px.shape, dev)
    check_tensor(fn, "py", py, px.shape, dev)
    check_tensor(fn, "use", use, px.shape, dev, dtype=torch.bool)
    check_tensor(fn, "pose0", pose0, (p, 3), dev)
    if g_f == 0 or g_b == 0 or p % g_f or p % g_b:
        raise ValueError(f"{fn}: {g_f} fields and {g_b} scans must each "
                         f"divide the {p} particles")
    check_tensor(fn, "dxs", dxs, (p, nx), dev)
    check_tensor(fn, "dys", dys, (p, ny), dev)
    check_tensor(fn, "dts", dts, (p, nt), dev)
    if b > _MAX_BEAMS or ny * nx > _MAX_CANDIDATES_XY or nt > 65535 \
            or p * max(nt, ny, nx) >= 2 ** 31:
        raise ValueError(f"{fn}: at most {_MAX_BEAMS} beams, "
                         f"{_MAX_CANDIDATES_XY} (dy, dx) candidates, 65535 "
                         f"headings and 2^31 offsets a call; got {b}, "
                         f"{ny * nx}, {nt}, {p * max(nt, ny, nx)}")
    out = torch.empty((p, nt, ny, nx), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = lib.gs_stage_scores(
        field.data_ptr(), px.data_ptr(), py.data_ptr(), use.data_ptr(),
        pose0.data_ptr(), dxs.data_ptr(), dys.data_ptr(), dts.data_ptr(),
        out.data_ptr(), p, g_f, g_b, h, w, b, nt, ny, nx, resolution, origin[0],
        origin[1], math.log(1.0 / max_range), int(nearest),
        stream_handle(dev))
    launches += 1
    _build.check("gs_stage_scores", code)
    return out


def stage_scores_batch(field, px, py, use, pose0, dxs, dys, dts, *,
                       resolution: float, origin, max_range: float,
                       nearest: bool = False):
    """(P, nt, ny, nx) measurement log-likelihoods log p(z | x, m) of the
    candidates (pose0 + (dxs[ix], dys[iy], dts[it])) of every particle, on
    its group's field (G_f, H, W) and scan (G_b, B) (see the module
    docstring)."""
    fn = stage_scores_batch_cuda if field.is_cuda else stage_scores_batch_plain
    return fn(field, px, py, use, pose0, dxs, dys, dts, resolution=resolution,
              origin=origin, max_range=max_range, nearest=nearest)
