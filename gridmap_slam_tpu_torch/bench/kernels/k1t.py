"""K1's tile variant, K1t (ops/cuda/matcher.stage_scores_tile: the kTiled
instantiations of stage_scores_kernel and stage_scores_tile_kernel), and
its bound."""

from __future__ import annotations

import re

import torch

from ...ops.cuda import matcher as kmatch
from ..bounds import bound, nbytes, particle_slice
from . import Entry, Kernel
from .k1 import k1_agreement, k1_samples


def k1t_cells(args, kw, block=64) -> int:
    """The distinct cells of K1t's field that a call's taps read: the plain
    version's tap indices (its coordinates, ownership and bounds), counted
    once each; a tap off the field (v_outside) and a beam the tile does
    not own read none.  Particles go in blocks of `block` (a mark a cell)."""
    field, px, py, use, pose0, dxs, dys, dts = args
    g, h, w = field.shape
    p = pose0.shape[0]
    nearest = bool(kw.get("nearest"))
    shift = kw["c0"] - kw["ext"]
    seen = torch.zeros(g * h * w, dtype=torch.bool, device=field.device)
    per_g = p // g
    for a in range(0, p, block):
        n = min(block, p - a)
        sub = particle_slice("K1t", args, a, n)
        sx, sy, cx, cy, u = kmatch._tile_coords(
            *sub[1:], resolution=kw["resolution"], origin=kw["origin"],
            nearest=nearest)
        fx = sx[:, :, None, :] + cx[:, None, :, None]         # (n, nt, nx, B)
        fy = sy[:, :, None, :] + cy[:, None, :, None]         # (n, nt, ny, B)
        x0 = torch.round(fx).to(torch.int64)
        y0 = torch.round(fy).to(torch.int64)
        mine = kmatch._owned(x0, kw["c0"], kw["w_loc"], kw["n_m"])
        xl = (x0 - shift)[:, :, None]                         # (n,nt,1,nx,B)
        y0 = y0[:, :, :, None]                                # (n,nt,ny,1,B)
        keep = (u if u.dim() == 5 else u.expand(n, 1, 1, 1, -1)) \
            & mine[:, :, None]
        grp = (torch.arange(a, a + n, device=field.device) // per_g
               )[:, None, None, None, None]
        for dx, dy in ((0, 0),) if nearest else (
                (0, 0), (1, 0), (0, 1), (1, 1)):
            x, y = xl + dx, y0 + dy
            on = keep & (x >= 0) & (x < w) & (y >= 0) & (y < h)
            idx = (grp * h + y.clamp(0, h - 1)) * w + x.clamp(0, w - 1)
            seen[torch.broadcast_to(idx, on.shape)[on]] = True
    return int(seen.sum())


def k1t_bound(args, kw):
    """K1t's bound: the operations as k1_bound counts them (the used beams'
    samples), and the bytes of the field's cells its taps read
    (k1t_cells), of the other inputs and of the output.  A tile too large
    to stage is never read whole: counting it whole would put the bound
    above what any design needs."""
    pose0, dxs, dys, dts = args[4:]
    cands = dts.shape[1] * dys.shape[1] * dxs.shape[1]
    return bound(k1_samples(args, kw),
                 k1t_cells(args, kw) * 4 + nbytes(args[1:])
                 + pose0.shape[0] * cands * 4)


KERNEL = Kernel(
    "K1t",
    re.compile(r"stage_scores_kernelILb[01]ELb[01]ELi\d+ELb1E"
               r"|stage_scores_kernel<\w+, \w+, \d+, true>"
               r"|stage_scores_tile_kernel"),
    (Entry("matcher", "stage_scores_tile", k1t_bound),), k1_agreement)
