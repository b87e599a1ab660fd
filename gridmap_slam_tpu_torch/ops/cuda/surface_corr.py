"""K4: the surface correlation in bf16 on the tensor cores, csrc/surface_corr.cu.

Replaces the bf16 branch of gridmap_slam_tpu/ops/surface.py::scan_surface
(:170-179), an XLA convolution of bf16 inputs into a float32 volume (not a
Pallas kernel: no PyTorch call computes it, since a bf16 `conv2d` on CUDA
returns a bf16 volume).  `surface_corr_bf16` runs the kernel for a tensor on
the card and the plain version for a tensor on the CPU:

    out[t, y, x] = sum_{dy,dx} bf16(fpad[y+dy, x+dx] + shift)
                                  * bf16(E[t, dy, dx])  -  shift * mass[t]

with round-to-nearest-even casts and float32 sums (a product of two bf16
numbers is exact in float32).  `launch_plan` chooses, from the shapes and
the card alone, the rows of a block and the chunks the tap rows are split
into (a second kernel then sums the chunks in a fixed order).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..precision import f32_conv
from . import _build, check_tensor, stream_handle
from .matcher import H100, SMEM_SM_MARGIN, device_limits

launches = 0   # kernel launches since the count was last set to 0

TILE_X = 128               # output columns a warp (8 M tiles of 16)
BINS = 8                   # theta bins a block (one N tile)
WINDOW = 17                # pair words of the A window in registers
ROWS = 8                   # warps (output rows) a block
REGISTERS = 128            # at most, a thread (__launch_bounds__(256, 2))
# The time estimate, in cycles of an SM: a warp's m16n8k16 MMA on the
# SM's tensor cores, the warps an SM needs resident to keep them busy (two
# blocks, so that one computes while the other waits on its staging
# loads), a staged word (two loads, two roundings, a store), the launch of
# the chunk-summing kernel and the bytes an SM moves a cycle.
MMA_CYCLES, FULL_WARPS, STAGE_CYCLES = 2.0, 16, 0.5
SUM_LAUNCH_CYCLES, BYTES_PER_CYCLE = 5000.0, 1900.0


class K4Plan(NamedTuple):
    """How K4 runs at one call's shapes (csrc/surface_corr.cu): block
    (column tile, group * bin_tiles + bin tile, chunk) works output rows
    [group * rows, (group + 1) * rows), columns [tile * 128, (tile + 1) *
    128), bins [bin tile * 8, + 8), over tap rows [chunk * rows_a_chunk,
    + rows_a_chunk), clipped to the volume."""
    rows: int              # warps a block, one output row each
    chunk: int             # tap rows a chunk
    chunks: int
    ksteps: int            # k steps of 16 taps a tap row
    pitch_f: int           # words a staged field row
    pitch_e: int           # words a staged tap row of one bin
    col_tiles: int
    groups: int
    bin_tiles: int
    smem_bytes: int        # dynamic shared memory a block


@functools.lru_cache(maxsize=None)
def launch_plan(nt: int, k: int, hc: int, wc: int, *,
                sm_count: int = H100["sm_count"],
                smem_block: int = H100["smem_block"],
                smem_sm: int = H100["smem_sm"]) -> Optional[K4Plan]:
    """The launch of K4 for nt bins of K x K taps over an Hc x Wc volume, on
    a card with `sm_count` SMs and the given shared memory a block (opt-in)
    and an SM; None where a shape is empty or no block fits.

    Blocks of ROWS warps; of the chunk counts of the K tap rows, the one
    of the least estimated time: the blocks an SM runs, times a block's
    MMAs (ROWS x chunk x ksteps x 8) and its staging, slowed where the
    warps an SM holds are fewer than FULL_WARPS; plus, with more than one
    chunk, the partial volumes written and summed."""
    if min(nt, k, hc, wc) < 1:
        return None
    ksteps = -(-k // 16)
    pitch_f = 16 * ksteps + 8 * WINDOW + 16
    pitch_e = 8 * ksteps + 4          # 4, 12, 20 or 28 modulo 32
    col_tiles = -(-wc // TILE_X)
    bin_tiles = -(-nt // BINS)
    groups = -(-hc // ROWS)
    smem = 4 * ((ROWS + 1) * pitch_f + 2 * BINS * pitch_e)
    threads = 32 * ROWS
    per_sm = min(2048 // threads, 65536 // (threads * REGISTERS),
                 (smem_sm - SMEM_SM_MARGIN) // (smem + 1024))
    if smem > smem_block or per_sm == 0 or groups * bin_tiles > 65535:
        return None
    step = (ROWS * 8 * ksteps * MMA_CYCLES
            + (BINS * 8 * ksteps + pitch_f) * STAGE_CYCLES / 32)
    best = None
    for chunks in sorted({-(-k // c) for c in range(1, k + 1)}):
        chunk = -(-k // chunks)
        on_sm = -(-col_tiles * groups * bin_tiles * chunks // sm_count)
        warps = min(per_sm, on_sm) * ROWS          # warps an SM holds
        cycles = on_sm * (chunk + ROWS) * step * max(1.0, FULL_WARPS / warps)
        if chunks > 1:
            cycles += SUM_LAUNCH_CYCLES + (
                (chunks + 1) * nt * hc * wc * 4 / BYTES_PER_CYCLE / sm_count)
        if best is None or (cycles, chunks) < best[0]:
            best = ((cycles, chunks), K4Plan(
                ROWS, chunk, chunks, ksteps, pitch_f, pitch_e, col_tiles,
                groups, bin_tiles, smem))
    return best[1]


def round_bf16(x):
    """float32 x rounded to bf16 (to nearest, ties to even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def surface_corr_bf16_plain(fpad, e_stack, shift: float, mass):
    """Plain version: the shifted field and the endpoint images rounded to
    bf16 and back, correlated by a float32 conv2d (exactly bf16 products
    with float32 sums), minus shift * mass.  fpad: (Hc + K - 1, Wc + K - 1);
    e_stack: (nt, K, K); mass: (nt,).  Returns (nt, Hc, Wc)."""
    a = round_bf16(fpad + shift)
    b = round_bf16(e_stack)
    with f32_conv():
        out = F.conv2d(a[None, None], b[:, None])[0]
    return out - shift * mass[:, None, None]


def plan_for(fpad, e_stack) -> Optional[K4Plan]:
    """The plan the kernel runs these tensors on the card with."""
    nt, k, _ = e_stack.shape
    return launch_plan(nt, k, fpad.shape[0] - k + 1, fpad.shape[1] - k + 1,
                       **device_limits(fpad.device.index))


def surface_corr_bf16_cuda(fpad, e_stack, shift: float, mass):
    """The kernel.  fpad: (Hp, Wp), e_stack: (nt, K, K) with K at most Hp
    and Wp, mass: (nt,), float32 on one card.  Returns (nt, Hp - K
    + 1, Wp - K + 1)."""
    global launches
    fn = "surface_corr_bf16_cuda"
    if fpad.dim() != 2 or e_stack.dim() != 3:
        raise ValueError(f"{fn}: need fpad (Hp, Wp) and e_stack (nt, K, K), "
                         f"got {tuple(fpad.shape)} and "
                         f"{tuple(e_stack.shape)}")
    dev = fpad.device
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hp, wp = fpad.shape
    check_tensor(fn, "fpad", fpad, (hp, wp), dev)
    check_tensor(fn, "e_stack", e_stack, (nt, k, k), dev)
    check_tensor(fn, "mass", mass, (nt,), dev)
    plan = plan_for(fpad, e_stack)
    if plan is None or min(hp, wp) < k:
        raise ValueError(f"{fn}: no launch plan for {nt} bins of {k} x {k} "
                         f"taps over a {hp} x {wp} field on {dev}")
    hc, wc = hp - k + 1, wp - k + 1
    out = torch.empty((nt, hc, wc), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.chunks, nt, hc, wc), dtype=torch.float32,
                        device=dev) if plan.chunks > 1 else None)
    code = _build.library().gs_surface_corr(
        fpad.data_ptr(), e_stack.data_ptr(), mass.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), hp, wp, k, nt,
        float(shift), plan.rows, plan.chunk, plan.chunks, plan.ksteps,
        plan.pitch_f, plan.pitch_e, plan.smem_bytes, stream_handle(dev))
    launches += 1
    _build.check("gs_surface_corr", code)
    return out


def surface_corr_bf16(fpad, e_stack, shift: float, mass):
    """(Hp, Wp) padded field, (nt, K, K) endpoint images and their (nt,)
    float32 masses -> (nt, Hp - K + 1, Wp - K + 1) bf16-product volume."""
    fn = (surface_corr_bf16_cuda if fpad.is_cuda
          else surface_corr_bf16_plain)
    return fn(fpad, e_stack, shift, mass)
