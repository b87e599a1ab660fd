"""K3, the likelihood field (ops/cuda/likelihood.log_likelihood_field_batch,
csrc/likelihood.cu's ll_field_small and ll_field_generic), and its
bound."""

from __future__ import annotations

import re

from ..bounds import bound, nbytes
from . import Entry, Kernel

K3_ATOL = 1e-5      # against the plain version, tests/test_pallas.py:91


def _taps_inside(n: int, r: int) -> int:
    """The taps of a (2r + 1)-tap blur along an axis of n cells that fall
    inside it, summed over its cells (a tap outside adds zero)."""
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def k3_bound(args, kw=None):
    """K3's bound: one blurred plane (the evidence mask is a window OR on
    bits, counted as nothing), two passes of an FMA for each tap that falls
    inside the map (4 (2r + 1) operations a cell away from the edges), and
    4 for the threshold and the log epilogue (a log counted as one); the
    map read and the field written once."""
    lo, taps = args
    p, h, w = lo.shape
    r = (taps.numel() - 1) // 2
    fmas = p * (h * _taps_inside(w, r) + w * _taps_inside(h, r))
    return bound(2 * fmas + 4 * lo.numel(), nbytes(args) + nbytes([lo]))


def k3_agreement(out, ref, kw):
    """(share of the cells beyond atol of the plain version's, 0)."""
    return float(((out - ref).abs() > K3_ATOL).float().mean()), 0.0


KERNEL = Kernel(
    "K3", re.compile("ll_field_"),
    (Entry("likelihood", "log_likelihood_field_batch", k3_bound),),
    k3_agreement)
