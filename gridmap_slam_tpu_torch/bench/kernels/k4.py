"""K4, the bf16 surface correlation (ops/cuda/surface_corr.surface_corr_bf16,
csrc/surface_corr.cu's surface_corr_prep and surface_corr_kernel), and its
bound."""

from __future__ import annotations

import re

from ..bounds import BF16_TC_FLOPS, bound, nbytes
from . import Entry, Kernel

# against the plain version: the direct correlation's float32 bound
# (tests/test_torch_surface_corr.py)
K4_RTOL, K4_ATOL = 1e-5, 1e-3


def k4_bound(args, kw=None):
    """K4's bound on these arguments: a multiply and an add for each
    product of a nonzero (bf16-rounded) tap with a crop cell, 2 nnz Hc Wc
    summed over the bins (a zero tap's products add nothing), over the
    dense bf16 tensor-core peak; the field, the endpoint images and the
    masses read once and the volume written once."""
    from ...ops.cuda.surface_corr import round_bf16
    fpad, e_stack, _, mass = args
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hc, wc = fpad.shape[0] - k + 1, fpad.shape[1] - k + 1
    nnz = int((round_bf16(e_stack) != 0).sum())
    return bound(2.0 * nnz * hc * wc,
                 nbytes([fpad, e_stack, mass]) + nt * hc * wc * 4,
                 BF16_TC_FLOPS)


def k4_agreement(out, ref, kw):
    """(share of the volume beyond rtol / atol of the plain version's,
    0)."""
    beyond = (out - ref).abs() > K4_ATOL + K4_RTOL * ref.abs()
    return float(beyond.float().mean()), 0.0


KERNEL = Kernel(
    "K4", re.compile("surface_corr_"),
    (Entry("surface_corr", "surface_corr_bf16", k4_bound),), k4_agreement)
