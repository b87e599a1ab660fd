"""K4: the surface correlation in bf16 on the tensor cores, csrc/surface_corr.cu.

Replaces the bf16 branch of gridmap_slam_tpu/ops/surface.py::scan_surface
(:170-179), an XLA convolution of bf16 inputs into a float32 volume (not a
Pallas kernel: no PyTorch call computes it, since a bf16 `conv2d` on CUDA
returns a bf16 volume).  `surface_corr_bf16` runs the kernel for a tensor on
the card and the plain version for a tensor on the CPU:

    out[t, y, x] = sum_{dy,dx} bf16(fpad[y+dy, x+dx] + shift)
                                  * bf16(E[t, dy, dx])  -  shift * mass[t]

with round-to-nearest-even casts and float32 sums (a product of two bf16
numbers is exact in float32).

The kernel does only the work of the endpoint images' nonzero taps: a
prologue lists, for each tile of 8 bins and each tap row, the "groups" (16
consecutive taps of the row, all 8 bins) that hold a nonzero rounded tap and
packs their tensor-core B fragments (`prepare_bf16_cuda` runs it alone; its
plain version `prepare_bf16_plain` builds the same buffers with tensor ops);
the main kernel walks those lists.  `launch_plan` chooses, from the shapes
and the card alone, how many runs each bin tile's list is split into (the
blocks of one thread-block cluster).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..precision import f32_conv
from . import _build, check_tensor, stream_handle
from .matcher import H100, SMEM_SM_MARGIN, device_limits

launches = 0   # kernel launches since the count was last set to 0

TILE_X = 128               # output columns a warp (8 M tiles of 16)
BINS = 8                   # theta bins a bin tile (one N tile)
KSTEP = 16                 # taps a k step (one MMA's depth)
ROWS = 8                   # warps (output rows) a block
MAX_RUNS = 8               # blocks a cluster, the portable limit
MAX_KSTEPS = 256           # k steps a tap row the prologue takes (K <= 4096)
RED_PITCH = ROWS * TILE_X + 4   # floats a bin of a block's partial sums
WINDOW_ROW = TILE_X + 16   # field words an A window spans, to 16 bytes
REGISTERS = 128            # at most, a thread (__launch_bounds__(256, 2))
KERNELS = 2                # launches a call: the prologue, the correlation
# Clusters of r = 1 .. 8 main-kernel blocks an H100 80GB HBM3 holds at once
# at 33-35 KB of shared memory a block (cudaOccupancyMaxActiveClusters):
# the plan's default where it is made for no card, as in the CPU tests.
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)


class K4Plan(NamedTuple):
    """How K4 runs at one call's shapes (csrc/surface_corr.cu).  The main
    kernel's block (column tile, row group * bin_tiles + bin tile, run)
    works output rows [row group * 8, + 8), columns [tile * 128, + 128) and
    bins [bin tile * 8, + 8) over run `run` of `runs` of the bin tile's
    live groups, clipped to the volume; the runs of one output tile are one
    cluster."""
    runs: int              # blocks a cluster
    ksteps: int            # k steps of 16 taps a tap row
    pitch_w: int           # 32-bit words a row of the prepared field
    col_tiles: int
    groups: int            # row groups of 8 output rows
    bin_tiles: int
    smem_bytes: int        # dynamic shared memory of a main-kernel block
    scratch_words: int     # the prologue's buffers, 32-bit words


class K4Prep(NamedTuple):
    """The prologue's buffers (int32 views of the kernel's scratch, or the
    plain version's tensors).  For bin tile b and tap row dy, the live
    groups are k steps ks[b, dy, :counts[b, dy]] in ascending order, and
    frags[b, dy, i] is the B fragment of the i-th: lane 4 g + t holds the
    bf16 pair words (E[8 b + g, dy, 16 s + 2 t], the next tap) and
    (E[8 b + g, dy, 16 s + 2 t + 8], the next tap), zero past nt and K.
    Entries past a row's count are unspecified.  field[r, j] is the pair
    word (bf16 F[r, j], bf16 F[r, j + 1]) of the shifted field F = fpad +
    shift, zero past its width."""
    field: torch.Tensor    # (Hp, pitch_w)
    frags: torch.Tensor    # (bin_tiles, K, ksteps, 32, 2)
    ks: torch.Tensor       # (bin_tiles, K, ksteps)
    counts: torch.Tensor   # (bin_tiles, K)


def _pitch_w(col_tiles: int, ksteps: int) -> int:
    """Words a prepared field row: up to the end of the last column tile's
    last A window, 128 (col_tiles - 1) + 16 (ksteps - 1) + WINDOW_ROW (a
    multiple of 4: rows start on 16 bytes)."""
    return TILE_X * (col_tiles - 1) + KSTEP * (ksteps - 1) + WINDOW_ROW


def scratch_words(nt: int, k: int, hp: int, pitch_w: int) -> int:
    """32-bit words of the prologue's buffers: fragments, field, k steps,
    counts (the kernel's layout)."""
    tiles, ksteps = -(-nt // BINS), -(-k // KSTEP)
    groups = tiles * k * ksteps
    return groups * 64 + hp * pitch_w + groups + tiles * k


def _smem_bytes(k: int) -> int:
    """A main-kernel block's dynamic shared memory: the partial sums (the
    group list lives in their words until the last group) and the K + 1
    row offsets."""
    return 4 * (BINS * RED_PITCH + k + 1)


@functools.lru_cache(maxsize=None)
def launch_plan(nt: int, k: int, hc: int, wc: int, *,
                smem_block: int = H100["smem_block"],
                smem_sm: int = H100["smem_sm"],
                clusters: tuple = H100_CLUSTERS) -> Optional[K4Plan]:
    """The launch of K4 for nt bins of K x K taps over an Hc x Wc volume, on
    a card with the given shared memory a block (opt-in) and an SM, and
    `clusters[r - 1]` clusters of r blocks resident at once;
    None where a shape is empty, K is past 4096 or no block fits.

    The live groups are data, so the plan cannot weigh them: it splits each
    bin tile's list into as many runs (up to 8, one cluster of that many
    blocks an output tile) as keep every cluster of the grid resident at
    once; a grid that fills the card already takes one run.  (Clusters
    pack less well than blocks: an H100 holds 30 clusters of 8 where its
    block slots would take 33, and a second wave doubles the time.)"""
    if min(nt, k, hc, wc) < 1:
        return None
    ksteps = -(-k // KSTEP)
    if ksteps > MAX_KSTEPS:
        return None
    col_tiles = -(-wc // TILE_X)
    bin_tiles = -(-nt // BINS)
    groups = -(-hc // ROWS)
    smem = _smem_bytes(k)
    threads = 32 * ROWS
    per_sm = min(2048 // threads, 65536 // (threads * REGISTERS),
                 (smem_sm - SMEM_SM_MARGIN) // (smem + 1024))
    if smem > smem_block or per_sm == 0 or groups * bin_tiles > 65535:
        return None
    tiles = col_tiles * groups * bin_tiles
    runs = next((r for r in range(MAX_RUNS, 0, -1)
                 if tiles <= clusters[r - 1]), 1)
    pitch_w = _pitch_w(col_tiles, ksteps)
    return K4Plan(runs, ksteps, pitch_w, col_tiles, groups, bin_tiles, smem,
                  scratch_words(nt, k, hc + k - 1, pitch_w))


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


def _bf16_bits(x):
    """The bf16 bits of float32 x rounded to nearest even, as int64 0..65535."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _pair_words(lo, hi):
    """int32 words lo | hi << 16 of bf16 bit patterns (int64 tensors)."""
    w = lo | (hi << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def prepare_bf16_plain(fpad, e_stack, shift: float,
                       plan: K4Plan) -> K4Prep:
    """Plain version of K4's prologue (K4Prep's buffers, entries past a
    row's count zero)."""
    nt, k, _ = e_stack.shape
    hp, wp = fpad.shape
    tiles, ksteps = plan.bin_tiles, plan.ksteps
    f = F.pad(_bf16_bits(fpad + shift), (0, plan.pitch_w + 1 - wp))
    field = _pair_words(f[:, :-1], f[:, 1:])
    e = F.pad(_bf16_bits(e_stack),
              (0, KSTEP * ksteps - k, 0, 0, 0, BINS * tiles - nt))
    # (tile, g, dy, s, h, t, pair) -> (tile, dy, s, g, t, h): lane 4 g + t,
    # word h (taps 16 s + 8 h + 2 t and the next)
    e = e.reshape(tiles, BINS, k, ksteps, 2, 4, 2)
    words = _pair_words(e[..., 0], e[..., 1]).permute(0, 2, 3, 1, 5, 4)
    words = words.reshape(tiles, k, ksteps, 32, 2)
    live = ((words & 0x7FFF7FFF) != 0).flatten(-2).any(-1)
    counts = live.sum(-1, dtype=torch.int32)
    order = torch.argsort((~live).to(torch.int8), dim=-1, stable=True)
    kept = torch.arange(ksteps, device=fpad.device) < counts[..., None]
    ks = torch.where(kept, order, 0).to(torch.int32)
    frags = torch.gather(words, 2, order[..., None, None].expand_as(words))
    frags = torch.where(kept[..., None, None], frags, 0)
    return K4Prep(field, frags, ks, counts)


@functools.lru_cache(maxsize=None)
def cluster_limits(index: int, smem_bytes: int) -> tuple:
    """launch_plan's `clusters` for CUDA device `index` at `smem_bytes` a
    block, read from the card itself."""
    out = (ctypes.c_int * MAX_RUNS)()
    with torch.cuda.device(index):
        _build.check("gs_surface_corr_clusters",
                     _build.library().gs_surface_corr_clusters(smem_bytes,
                                                               out))
    return tuple(out)


def plan_for(fpad, e_stack) -> Optional[K4Plan]:
    """The plan the kernel runs these tensors with: on the card, for its
    limits; on the CPU, for the H100's."""
    nt, k, _ = e_stack.shape
    limits = {}
    if fpad.is_cuda:
        card = device_limits(fpad.device.index)
        limits = dict(smem_block=card["smem_block"], smem_sm=card["smem_sm"])
        if _smem_bytes(k) <= card["smem_block"]:
            limits["clusters"] = cluster_limits(fpad.device.index,
                                                _smem_bytes(k))
    return launch_plan(nt, k, fpad.shape[0] - k + 1, fpad.shape[1] - k + 1,
                       **limits)


def _checked_plan(fn, fpad, e_stack, mass=None):
    if fpad.dim() != 2 or e_stack.dim() != 3:
        raise ValueError(f"{fn}: need fpad (Hp, Wp) and e_stack (nt, K, K), "
                         f"got {tuple(fpad.shape)} and "
                         f"{tuple(e_stack.shape)}")
    dev = fpad.device
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hp, wp = fpad.shape
    check_tensor(fn, "fpad", fpad, (hp, wp), dev)
    check_tensor(fn, "e_stack", e_stack, (nt, k, k), dev)
    if mass is not None:
        check_tensor(fn, "mass", mass, (nt,), dev)
    plan = plan_for(fpad, e_stack) if min(hp, wp) >= k else None
    if plan is None:
        raise ValueError(f"{fn}: no launch plan for {nt} bins of {k} x {k} "
                         f"taps over a {hp} x {wp} field on {dev}")
    return plan


def _prep_views(scratch, nt, k, hp, plan: K4Plan) -> K4Prep:
    tiles, ksteps = plan.bin_tiles, plan.ksteps
    n_groups = tiles * k * ksteps
    frags, field, ks, counts = torch.split(
        scratch, [n_groups * 64, hp * plan.pitch_w, n_groups, tiles * k])
    return K4Prep(field.view(hp, plan.pitch_w),
                  frags.view(tiles, k, ksteps, 32, 2),
                  ks.view(tiles, k, ksteps), counts.view(tiles, k))


def prepare_bf16_cuda(fpad, e_stack, shift: float) -> K4Prep:
    """K4's prologue alone on the card (one launch): its buffers."""
    global launches
    fn = "prepare_bf16_cuda"
    plan = _checked_plan(fn, fpad, e_stack)
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hp, wp = fpad.shape
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32,
                          device=fpad.device)
    launched = (ctypes.c_int * 1)()
    code = _build.library().gs_surface_corr_prep(
        fpad.data_ptr(), e_stack.data_ptr(), scratch.data_ptr(), hp, wp, k,
        nt, float(shift), plan.ksteps, plan.pitch_w, plan.scratch_words,
        stream_handle(fpad.device), launched)
    _build.check("gs_surface_corr_prep", code)
    launches += launched[0]
    return _prep_views(scratch, nt, k, hp, plan)


def surface_corr_bf16_cuda(fpad, e_stack, shift: float, mass):
    """The kernel: the prologue and the correlation (two launches).  fpad:
    (Hp, Wp), e_stack: (nt, K, K) with K at most Hp and Wp, mass: (nt,),
    float32 on one card.  Returns (nt, Hp - K + 1, Wp - K + 1)."""
    global launches
    fn = "surface_corr_bf16_cuda"
    plan = _checked_plan(fn, fpad, e_stack, mass)
    dev = fpad.device
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hp, wp = fpad.shape
    out = torch.empty((nt, hp - k + 1, wp - k + 1), dtype=torch.float32,
                      device=dev)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 1)()
    code = _build.library().gs_surface_corr(
        fpad.data_ptr(), e_stack.data_ptr(), mass.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), hp, wp, k, nt, float(shift), plan.runs,
        plan.ksteps, plan.pitch_w, plan.smem_bytes, plan.scratch_words,
        stream_handle(dev), launched)
    _build.check("gs_surface_corr", code)
    launches += launched[0]
    return out


def surface_corr_bf16(fpad, e_stack, shift: float, mass):
    """(Hp, Wp) padded field, (nt, K, K) endpoint images and their (nt,)
    float32 masses -> (nt, Hp - K + 1, Wp - K + 1) bf16-product volume."""
    fn = (surface_corr_bf16_cuda if fpad.is_cuda
          else surface_corr_bf16_plain)
    return fn(fpad, e_stack, shift, mass)
