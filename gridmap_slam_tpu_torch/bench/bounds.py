"""The least time an H100 could take for one kernel call's work: the
helpers each kernel's bound function (kernels/) counts with.

A call's bound is the larger of its float operations over the card's peak
rate for their type and its bytes (each input read once, each output
written once) over its HBM rate, counted from the call's own arguments;
where the work depends on the data, what these inputs need.  A bound
function takes a kernel entry point's (args, kw), as the `*_cuda` wrappers
of ops/cuda receive them, and returns (bound ms, "operations" or "bytes").

The counts live with the benchmark, not in the kernels' code: the
benchmark's shares of bound (layers.py) and chip_smoke.py's kernel rows
use the same functions.
"""

from __future__ import annotations

import torch

# The H100 SXM's published peaks (NVIDIA's data sheet, 700 W): FP32
# outside the tensor cores and HBM3.
FP32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# K4 runs on the tensor cores: its operations go against the dense bf16
# peak (NVIDIA's data sheet), not the FP32 units'.
BF16_TC_FLOPS = 989e12


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    """(bound ms, "operations" or "bytes") of work on the H100, its
    operations at `peak` operations a second."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def group_rows(t, p, a, n):
    """The rows of a per-group tensor t (G, ...) that particles [a, a + n)
    of p read, as a tensor those n particles read the same way."""
    g = t.shape[0]
    per = p // g
    if g == 1:
        return t
    if per == 1:
        return t[a:a + n]
    if a // per == (a + n - 1) // per:
        return t[a // per:a // per + 1]
    if a % per == 0 and n % per == 0:
        return t[a // per:(a + n) // per]
    raise ValueError(f"particles [{a}, {a + n}) cut a group of {per}")


# A kernel call of more particles than FULL_PARTICLES is held against its
# plain version on its first and its last SLICE_PARTICLES particles (the
# plain version at a 500 000-particle block cannot be materialised); the
# benchmark's agreement (kernels/k1.py) and chip_smoke.py take these.
FULL_PARTICLES, SLICE_PARTICLES = 4096, 2048


def compared_parts(p: int):
    """The (first particle, particles) ranges of a call of p particles
    held against the plain version: the whole call up to FULL_PARTICLES,
    else its first and its last SLICE_PARTICLES."""
    if p <= FULL_PARTICLES:
        return [(0, p)]
    return [(0, SLICE_PARTICLES), (p - SLICE_PARTICLES, SLICE_PARTICLES)]


def particle_slice(kernel, args, a, n):
    """A kernel call's arguments for its particles [a, a + n) alone (each
    particle's output depends on its own rows only)."""
    if kernel in ("K1", "K1t"):
        field, px, py, use, pose0, dxs, dys, dts = args
        p = pose0.shape[0]
        scan = [x if x.dim() == 1 else group_rows(x, p, a, n)
                for x in (px, py, use)]
        return (group_rows(field, p, a, n), *scan,
                *(x[a:a + n] for x in (pose0, dxs, dys, dts)))
    if kernel == "K2":
        lo, poses, keep, *tables = args
        p = lo.shape[0]
        return (lo[a:a + n], poses[a:a + n], keep,
                *(t if t.dim() == 1 else group_rows(t, p, a, n)
                  for t in tables))
    lo, taps = args
    return (lo[a:a + n], taps)


