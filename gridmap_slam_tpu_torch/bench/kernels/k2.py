"""K2, the map update (ops/cuda/grid_update: integrate_scan_batch and its
window variant integrate_scan_window, csrc/grid_update.cu), and its
bounds."""

from __future__ import annotations

import re

from ..bounds import bound, nbytes
from . import Entry, Kernel

# A K2 cell: range (5) and bearing (about 15, an atan2) from the pose, the
# bin (3) and the footprint and return tests (about 7).
K2_FLOPS_CELL = 30
# Against the plain version (tests/test_pallas.py:124-126): atol, and the
# share of cells a ray's edge may put on the other side of it
K2_ATOL, K2_MAX_SHARE = 1e-5, 5e-3


def k2_bound(args, kw):
    """K2's bound: K2_FLOPS_CELL a cell; the map read and written once,
    the poses and tables read once."""
    lo = args[0]
    return bound(K2_FLOPS_CELL * lo.numel(), nbytes(args) + nbytes([lo]))


def k2w_bound(args, kw):
    """K2's window variant's bound: K2_FLOPS_CELL a window cell; the
    window's cells read and written once, the pose, its window's place and
    the tables read once.  The kernel touches the window alone: where the
    call returns a new map (no `out`, or `out` another tensor) the copy of
    the map is PyTorch's, before the kernel, and not counted."""
    hw, ww = kw["size"]
    cells = hw * ww
    return bound(K2_FLOPS_CELL * cells,
                 2 * cells * args[0].element_size() + nbytes(args[1:]))


def k2_agreement(out, ref, kw):
    """(share of the cells beyond atol of the plain version's, the most
    that may be).  The window variant's share is of its window's cells
    (chip_smoke.py's rule): it updates no other cell, and a share of the
    whole map would hide a wrong window under the map's untouched rest."""
    beyond = int(((out - ref).abs() > K2_ATOL).sum())
    cells = kw["size"][0] * kw["size"][1] if "size" in kw else out.numel()
    return beyond / cells, K2_MAX_SHARE


KERNEL = Kernel(
    "K2", re.compile("grid_update_kernel"),
    (Entry("grid_update", "integrate_scan_batch", k2_bound),
     Entry("grid_update", "integrate_scan_window", k2w_bound)), k2_agreement)
