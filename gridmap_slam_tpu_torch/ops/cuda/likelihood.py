"""K3: batched log-likelihood field build, csrc/likelihood.cu.

Replaces gridmap_slam_tpu/ops/pallas/likelihood.py::
log_likelihood_field_pallas.  `log_likelihood_field_batch` runs the kernel
for a tensor on the card and the plain version for a tensor on the CPU.

`launch_plan` chooses, from the radius and the shapes alone, how the kernel
runs: the "small" variant (radius 1 to 4 compiled in, one thread a column
walking down a band of rows with the vertical pass in registers) or the
"generic" one (any radius up to MAX_RADIUS, both passes through shared
memory, each thread several outputs), and the band of rows and tile of
columns a block works.  `unknown_by_window` is the kernels' evidence test in
plain tensors: a window OR in place of the second blur.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..grid import likelihood_field
from ..matcher import log_likelihood_field
from . import _build, check_tensor, stream_handle
from .matcher import H100, SMEM_SM_MARGIN, device_limits

launches = 0   # kernel launches since the count was last set to 0

MAX_RADIUS = 236           # the largest blur radius K3 takes
MAX_SMALL_RADIUS = 4       # radii compiled into the small variant
SMALL_THREADS = 256        # most columns (threads) a small-variant block
SMALL_ROWS = 32            # most rows a small-variant band
SMALL_APRON = 4            # staged columns either side of its tile
GENERIC_THREADS = (256, 512)
BX, BY = 8, 8              # outputs a thread: horizontal, vertical pass
# The generic variant's time estimate, in cycles of an SM: instructions a
# staged cell (with its widened evidence), a tap of one output in the
# horizontal and in the vertical pass and an output's epilogue; the warp
# instructions an SM starts a cycle, the cycles between two instructions
# of one warp, the cycles a round of staging loads takes to arrive, and
# the cycles of a block's launch, prologue and barriers.
STAGE_COST, H_TAP_COST, V_TAP_COST, EPILOGUE_COST = 2.0, 2.1, 1.5, 20.0
SM_IPC, WARP_GAP, LOAD_LATENCY, LOADS_IN_FLIGHT = 4, 3, 700, 4
BLOCK_CYCLES = 2000
MIN_ROWS = 8               # fewest rows of a generic band (measured: one map
                           # at radius 12 runs no faster in thinner bands)


class K3Plan(NamedTuple):
    """How K3 runs at one call's shapes (csrc/likelihood.cu): block
    (p, band, tile) works output rows [band * tile_h, (band + 1) * tile_h)
    and columns [tile * tile_w, (tile + 1) * tile_w) of map p, clipped to
    the map."""
    variant: str           # "small" or "generic"
    radius: int
    tile_h: int
    tile_w: int            # a multiple of 32
    bands: int
    tiles: int
    threads: int
    smem_bytes: int        # dynamic shared memory a block


def _small_smem(r: int, tile_h: int, tile_w: int) -> int:
    """A small-variant block's shared memory: the staged floats with their
    apron, the evidence words (one spare either side) and the row-widened
    evidence words."""
    return (tile_h + 2 * r) * (tile_w + 2 * SMALL_APRON
                               + 2 * (tile_w // 32) + 2) * 4


def _generic_smem(r: int, h: int, w: int, tile_h: int, tile_w: int) -> int:
    """A generic-variant block's shared memory: the padded taps and half
    taps, a flag word, and for each staged row the horizontal-pass floats,
    the evidence and prefix words, the 2-bit codes and the widened
    evidence."""
    rows, cols = min(h, tile_h + 2 * r), min(w, tile_w + 2 * r)
    rw = -(-cols // 32) + 1
    taps = -(-(2 * r + 1 + 2 * (BX - 1)) // 4) * 4
    return 4 * (2 * taps + 4 + rows * (tile_w + 2 * rw + 2 * (rw - 1)
                                       + tile_w // 32))


def _blocks_per_sm(threads: int, smem: int, smem_sm: int) -> int:
    return min(2048 // threads, 32, (smem_sm - SMEM_SM_MARGIN)
               // (smem + 1024))


@functools.lru_cache(maxsize=None)
def launch_plan(radius: int, p: int, h: int, w: int, *,
                sm_count: int = H100["sm_count"],
                smem_block: int = H100["smem_block"],
                smem_sm: int = H100["smem_sm"]) -> Optional[K3Plan]:
    """The launch of K3 at blur radius `radius` on P maps of H x W cells,
    on a card with `sm_count` SMs and the given shared memory a block
    (opt-in) and an SM; None where the radius is past MAX_RADIUS or no
    tile fits a block.

    Small variant (radius 1 to MAX_SMALL_RADIUS): the column tile, a
    multiple of 32 up to SMALL_THREADS, is the one that stages the fewest
    columns over the whole row (tiles x (tile_w + 2 SMALL_APRON); the
    wider on a tie), so a 120-cell row is one tile of 128 and a 280-cell
    row three of 96; the rows are cut into equal bands of at most
    SMALL_ROWS rows (120 rows are 4 bands of 30), halved down to 8 while
    the grid has fewer than two blocks an SM.

    Generic variant: of the column tiles (multiples of 32) and the equal
    bands of at least MIN_ROWS rows whose staged rows fit a block, the
    pair of the least estimated time.  A block's three phases (staging,
    the horizontal pass over its staged rows, the vertical pass with the
    epilogue) each take the larger of two times: their warp instructions,
    times the blocks an SM holds at once, over SM_IPC; and the
    instructions of one warp, as many warps as the phase has work for,
    WARP_GAP cycles apart (what bounds a grid too small to fill the card,
    such as one map).  To that come the rounds of staging loads,
    LOAD_LATENCY each, and BLOCK_CYCLES, and the sum is multiplied by the
    blocks an SM runs over those it holds.  A radius past the map stages
    the whole map whatever the band, so one block takes a whole map."""
    if radius < 0 or radius > MAX_RADIUS or min(p, h, w) <= 0:
        return None
    if 1 <= radius <= MAX_SMALL_RADIUS:
        tile_w = min(range(32, SMALL_THREADS + 1, 32),
                     key=lambda t: (-(-w // t) * (t + 2 * SMALL_APRON), -t))
        tiles = -(-w // tile_w)
        rows = SMALL_ROWS
        while rows > 8 and p * tiles * -(-h // rows) < 2 * sm_count:
            rows //= 2
        bands = -(-h // rows)
        tile_h = -(-h // bands)
        return K3Plan("small", radius, tile_h, tile_w, bands, tiles, tile_w,
                      _small_smem(radius, tile_h, tile_w))

    n_taps = 2 * radius + 1
    best = None
    for tile_w in range(32, min(-(-w // 32) * 32, 512) + 1, 32):
        tiles = -(-w // tile_w)
        cols = min(w, tile_w + 2 * radius)
        out_w = min(tile_w, w)
        for bands in sorted({-(-h // t) for t in range(min(h, MIN_ROWS),
                                                       h + 1)}):
            tile_h = -(-h // bands)
            smem = _generic_smem(radius, h, w, tile_h, tile_w)
            if smem > smem_block:
                continue
            rows = min(h, tile_h + 2 * radius)
            # (thread instructions, threads it has work for) of each phase
            phases = (
                (STAGE_COST * rows * cols, rows * cols),
                (H_TAP_COST * rows * out_w * (min(n_taps, cols) + BX),
                 rows * out_w // BX),
                (V_TAP_COST * tile_h * out_w * (min(n_taps, rows) + BY)
                 + EPILOGUE_COST * tile_h * out_w, tile_h * out_w // BY))
            rounds = p * bands * tiles / sm_count    # blocks an SM runs
            for threads in GENERIC_THREADS:
                per_sm = _blocks_per_sm(threads, smem, smem_sm)
                if per_sm == 0:
                    continue
                held = max(1.0, min(per_sm, rounds))  # blocks an SM holds
                loads = -(-rows * -(-cols // 32)
                          // (threads // 32 * LOADS_IN_FLIGHT))
                cycles = BLOCK_CYCLES + LOAD_LATENCY * loads + sum(
                    max(work / 32 * held / SM_IPC,
                        work / max(32, min(threads, items)) * WARP_GAP)
                    for work, items in phases)
                cost = max(1.0, rounds / held) * cycles
                key = (cost, threads, -tile_w, -tile_h)
                if best is None or key < best[0]:
                    best = (key, K3Plan("generic", radius, tile_h, tile_w,
                                        bands, tiles, threads, smem))
    return None if best is None else best[1]


def covered_cells(plan: K3Plan, h: int, w: int):
    """How often the plan's blocks write each cell of an H x W map, as the
    kernels walk them: (H, W) int64 (all ones for a sound plan)."""
    count = torch.zeros((h, w), dtype=torch.int64)
    for band in range(plan.bands):
        for tile in range(plan.tiles):
            y0, x0 = band * plan.tile_h, tile * plan.tile_w
            count[y0:min(y0 + plan.tile_h, h),
                  x0:min(x0 + plan.tile_w, w)] += 1
    return count


def unknown_by_window(logodds, radius: int):
    """The kernels' unknown mask: a cell is unknown when no cell of its
    (2r + 1)^2 window, clipped to the map, has evidence (a log-odds other
    than 0).  Equal to ops/grid.likelihood_field's `evidence <= 0` for
    positive taps whose smallest, squared, does not underflow; the kernels
    test their taps for that and sum the window otherwise.  (..., H, W)
    bool."""
    ev = ((logodds > 0.0) | (logodds < 0.0)).to(torch.float32)
    lead = ev.shape[:-2]
    ev = ev.reshape(-1, 1, *ev.shape[-2:])
    k = 2 * radius + 1
    any_ev = F.max_pool2d(F.pad(ev, (radius,) * 4), k, stride=1)
    return (any_ev <= 0.0).reshape(*lead, *ev.shape[-2:])


def window_or_is_exact(taps) -> bool:
    """The kernels' own test of their taps (made on the card, so no launch
    waits for it): every tap positive and the smallest, squared, still a
    positive float32."""
    t_min = taps.to(torch.float32).min()
    return bool(t_min > 0.0) and bool(t_min * t_min > 0.0)


def log_likelihood_field_batch_plain(logodds, taps, *, z_hit: float,
                                     max_range: float):
    """Plain version: ops/grid.likelihood_field followed by
    ops/matcher.log_likelihood_field.  logodds: (..., H, W); taps: the 1-D
    blur kernel as a tensor."""
    field, unknown = likelihood_field(logodds, taps.tolist())
    return log_likelihood_field(field, unknown, z_hit, max_range)


def plan_for(logodds, taps) -> Optional[K3Plan]:
    """The plan the kernel runs a (P, H, W) tensor on the card with."""
    p, h, w = logodds.shape
    return launch_plan((taps.shape[0] - 1) // 2, p, h, w,
                       **device_limits(logodds.device.index))


def log_likelihood_field_batch_cuda(logodds, taps, *, z_hit: float,
                                    max_range: float):
    """The kernel.  logodds: (P, H, W) float32 on the card; taps: (2r+1,)
    float32 on the same card, any radius r up to MAX_RADIUS.  Returns
    (P, H, W)."""
    global launches
    fn = "log_likelihood_field_batch_cuda"
    if logodds.dim() != 3:
        raise ValueError(f"{fn}: logodds must be (P, H, W), got "
                         f"{tuple(logodds.shape)}")
    dev = logodds.device
    check_tensor(fn, "logodds", logodds, logodds.shape, dev)
    n_taps = taps.shape[0] if taps.dim() == 1 else -1
    check_tensor(fn, "taps", taps, (n_taps,), dev)
    radius = (n_taps - 1) // 2
    if n_taps % 2 != 1:
        raise ValueError(f"{fn}: need an odd tap count, got {n_taps}")
    p, h, w = logodds.shape
    out = torch.empty_like(logodds)
    if out.numel() == 0:
        return out
    plan = plan_for(logodds, taps)
    if plan is None:
        raise ValueError(f"{fn}: no launch plan for a blur radius of "
                         f"{radius} cells (at most {MAX_RADIUS}) on "
                         f"{tuple(logodds.shape)} maps on {dev}")
    uniform = 1.0 / max_range
    c_rand = (1.0 - z_hit) * uniform
    v_eq = (uniform - c_rand) / z_hit
    lib = _build.library()
    code = lib.gs_ll_field(logodds.data_ptr(), out.data_ptr(), taps.data_ptr(),
                           radius, p, h, w, z_hit, c_rand, v_eq,
                           int(plan.variant == "small"), plan.tile_h,
                           plan.tile_w, plan.threads, plan.smem_bytes,
                           stream_handle(dev))
    launches += 1
    _build.check("gs_ll_field", code)
    return out


def log_likelihood_field_batch(logodds, taps, *, z_hit: float,
                               max_range: float):
    """(P, H, W) log-odds -> (P, H, W) log-likelihood field."""
    fn = (log_likelihood_field_batch_cuda if logodds.is_cuda
          else log_likelihood_field_batch_plain)
    return fn(logodds, taps, z_hit=z_hit, max_range=max_range)
