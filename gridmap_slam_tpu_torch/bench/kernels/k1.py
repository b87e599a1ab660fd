"""K1, the matcher's stage scores (ops/cuda/matcher.stage_scores_batch,
csrc/matcher.cu's untiled stage_scores_kernel), and its bound."""

from __future__ import annotations

import re

import torch

from ...ops.cuda import matcher as kmatch
from .. import bounds
from ..bounds import bound, nbytes
from . import Entry, Kernel

# Float operations (an FMA counted as two) a K1 sample: bilinear: 2
# coordinate adds, 2 floors, 2 fraction subtractions, 3 lerps (a
# subtraction and an FMA each), the add into the sum; nearest: 2 adds, 2
# roundings, the add.
K1_FLOPS = {False: 16, True: 5}
# K1's field cells are counted tap by tap up to this many taps a call (in
# blocks of at most K1_BLOCK_TAPS); past it the whole field counts as read.
# Only calls on one shared field pass it (1M particles in blocks of
# 500 000, multi's 20 000), where the field is under a thousandth of the
# call's bytes.
K1_TAP_BUDGET = 2 ** 28
K1_BLOCK_TAPS = 2 ** 24
# Against the plain version: tests/test_pallas_matcher.py's rtol and atol,
# with no score beyond on nearest cells either: the kernel and the plain
# version round one float order's coordinates (ops/cuda/matcher.
# cell_coords; chip_smoke.py's K1_NEAREST_MAX_FRAC).
K1_RTOL, K1_ATOL, K1_NEAREST_MAX_SHARE = 2e-5, 2e-4, 0.0


def k1_samples(args, kw) -> float:
    """The float operations of K1's samples: every candidate of particle p
    samples each used beam of its scan row once."""
    field, px, py, use, pose0, dxs, dys, dts = args
    p = pose0.shape[0]
    cands = dts.shape[1] * dys.shape[1] * dxs.shape[1]
    rows = use.reshape(-1, use.shape[-1])
    samples = float(rows.sum()) * (p // rows.shape[0]) * cands
    return samples * K1_FLOPS[bool(kw.get("nearest"))]


def k1_cells(args, kw):
    """The distinct cells of K1's (G_f, H, W) field that a call's taps
    read: the plain version's tap indices (stage_scores_batch_plain's
    coordinates; four taps a sample, or one nearest), counted once each; a
    tap off the map and a beam not used read none.  None when the call has
    more than K1_TAP_BUDGET taps."""
    field, px, py, use, pose0, dxs, dys, dts = args
    g, h, w = field.shape
    p = pose0.shape[0]
    nearest = bool(kw.get("nearest"))
    taps = ((0, 0),) if nearest else ((0, 0), (1, 0), (0, 1), (1, 1))
    per = dts.shape[1] * dys.shape[1] * dxs.shape[1] * px.shape[-1]
    if p * per * len(taps) > K1_TAP_BUDGET:
        return None
    if px.dim() == 2:              # one scan a group: a row a particle
        px, py, use = (kmatch.per_particle(x, p) for x in (px, py, use))
    else:
        px, py, use = px[None], py[None], use[None]
    origin, res = kw["origin"], kw["resolution"]
    seen = torch.zeros(g * h * w, dtype=torch.bool, device=field.device)
    block = max(1, K1_BLOCK_TAPS // (per * len(taps)))
    for a in range(0, p, block):
        n = min(block, p - a)
        rows = slice(a, a + n) if px.shape[0] > 1 else slice(0, 1)
        theta = pose0[a:a + n, 2, None] + dts[a:a + n]          # (n, nt)
        c = torch.cos(theta)[:, :, None]
        s = torch.sin(theta)[:, :, None]
        rx = px[rows, None] * c - py[rows, None] * s            # (n, nt, B)
        ry = px[rows, None] * s + py[rows, None] * c
        wx = rx[:, :, None, :] + (pose0[a:a + n, 0, None]
                                  + dxs[a:a + n])[:, None, :, None]
        wy = ry[:, :, None, :] + (pose0[a:a + n, 1, None]
                                  + dys[a:a + n])[:, None, :, None]
        fx = (wx - origin[0]) / res - 0.5                       # (n,nt,nx,B)
        fy = (wy - origin[1]) / res - 0.5                       # (n,nt,ny,B)
        cell = torch.round if nearest else torch.floor
        x0 = cell(fx).to(torch.int64)[:, :, None]               # (n,nt,1,nx,B)
        y0 = cell(fy).to(torch.int64)[:, :, :, None]            # (n,nt,ny,1,B)
        u = use[rows][:, None, None, None, :]
        grp = (torch.arange(a, a + n, device=field.device) // (p // g)
               )[:, None, None, None, None]
        for dx, dy in taps:
            x, y = x0 + dx, y0 + dy
            on = u & (x >= 0) & (x < w) & (y >= 0) & (y < h)
            idx = (grp * h + y.clamp(0, h - 1)) * w + x.clamp(0, w - 1)
            seen[torch.broadcast_to(idx, on.shape)[on]] = True
    return int(seen.sum())


def k1_bound(args, kw):
    """K1's bound on these arguments: the samples this scan's used beams
    need (k1_samples), and the bytes of the field's cells its taps read
    (k1_cells; the whole field past K1_TAP_BUDGET taps), of the other
    inputs and of the (P, nt, ny, nx) output."""
    field, pose0, dxs, dys, dts = args[0], *args[4:]
    cands = dts.shape[1] * dys.shape[1] * dxs.shape[1]
    cells = k1_cells(args, kw)
    field_bytes = field.numel() * 4 if cells is None else cells * 4
    return bound(k1_samples(args, kw),
                 field_bytes + nbytes(args[1:]) + pose0.shape[0] * cands * 4)


def k1_agreement(out, ref, kw):
    """(share of the scores beyond rtol / atol of the plain version's, the
    most that may be)."""
    beyond = (out - ref).abs() > K1_ATOL + K1_RTOL * ref.abs()
    return (float(beyond.float().mean()),
            K1_NEAREST_MAX_SHARE if kw.get("nearest") else 0.0)


def k1_parts(args):
    """The particles of a K1 call held against the plain version
    (bounds.compared_parts: the first and last SLICE_PARTICLES of a call of
    more than FULL_PARTICLES, such as a 500 000-particle block; each
    particle's scores depend on its own rows only), as Entry.parts; None
    for the whole call."""
    parts = bounds.compared_parts(args[4].shape[0])
    if len(parts) == 1:
        return None
    return [(a, n, bounds.particle_slice("K1", args, a, n))
            for a, n in parts]


KERNEL = Kernel(
    "K1",
    # the untiled instantiations (kTiled false), mangled or demangled
    re.compile(r"stage_scores_kernelILb[01]ELb[01]ELi\d+ELb0E"
               r"|stage_scores_kernel<\w+, \w+, \d+, false>"),
    (Entry("matcher", "stage_scores_batch", k1_bound, k1_parts),),
    k1_agreement)
