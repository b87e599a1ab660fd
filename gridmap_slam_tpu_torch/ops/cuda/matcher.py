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

`launch_plan` chooses, from the shapes alone, how the kernel runs: the
"shared" variant (the field and a 2-cell ring of the out-of-map value in
shared memory) or the "global" one (the field read from device memory, for
fields too large for one block or too little work to pay for staging), the
(particle, heading) pairs a tile, the threads a block and the blocks that
share one field's tiles.

`stage_scores_tile` is K1's tile variant: the partial scores of one column
tile of a map split over ranks (parallel/tiled.py, parallel/sharded.py),
whose sum over the tiles is `stage_scores_batch` on the whole map.  Its
plain version, `stage_scores_tile_plain`, is the JAX package's XLA
function gridmap_slam_tpu/parallel/tiled.py::_stage_scores_tiled in
PyTorch.  Its launches are counted in `tile_launches`.  `tile_launch_plan`
chooses its kernel from the shapes alone: launch_plan's shared variant
where the extended tile fits a block, else stage_scores_tile_kernel (a
block an SM over a run of the (particle, heading) pairs, a warp a pair),
which stages the box the block's taps reach where it fits and else reads
the taps from the field.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build, check_tensor, stream_handle

launches = 0   # kernel launches since the count was last set to 0
tile_launches = 0   # launches of the tile variant, likewise

_MAX_BEAMS = 4096          # one pair's staged endpoints in 32 KB
RING = 2                   # cells of out-of-map value around a staged field
MAX_THREADS = 256          # threads a block (the kernel's launch bound)
STAGE_BYTES = 48 * 1024    # most shared memory a tile's endpoints may take
MAX_RUN = 5                # dx candidates a thread, at most
REGISTERS = 64             # registers a thread (the kernel's cap, runs 1-3)
SATURATING_WARPS = 8       # warps an SM past which the rate stops rising
# Shared memory an SM is assumed to give its blocks, short of its total:
# two blocks of 115 KB on an H100 (228 KB) measured as slow as one.
SMEM_SM_MARGIN = 8 * 1024
# Instructions a beam: a unit's endpoint load and y axis, and each of its
# candidates' x axis, four taps, three lerps and add; instructions a staged
# field cell.
UNIT_COST, SAMPLE_COST, STAGE_COST = 8, 21, 4
H100 = dict(sm_count=132, smem_block=232_448, smem_sm=233_472)
# The tile variant's kernel for tiles too large to stage: warps a block,
# blocks an SM (the kernel's launch bound), and lanes a warp
STAGED_WARPS = 24
STAGED_BLOCKS = 1
WARP = 32
# Shared memory the card keeps back a block (1 KB), and the kernel's own
# static array, short of what a block's plan may take
BLOCK_RESERVED = 1024 + 64


class K1Plan(NamedTuple):
    """How K1 runs at one call's shapes (csrc/matcher.cu).  Field group g
    (of `groups`) holds `pairs_per_group` (particle, heading) pairs, cut
    into tiles of `pairs_per_tile`; block b works group b // splits, the
    (b % splits)-th of `splits` contiguous runs of its tiles; a block's
    threads stride over a tile's units, pairs x dy x runs of `run` dx
    candidates (a row's last run may be shorter)."""
    variant: str           # "shared" or "global"
    pitch: int             # floats a staged field row (0: global)
    pairs_per_tile: int
    run: int
    splits: int
    groups: int            # G_f (shared) or 1 (global)
    pairs_per_group: int
    threads: int
    smem_bytes: int        # dynamic shared memory a block

    @property
    def grid(self) -> int:
        return self.groups * self.splits

    @property
    def tiles_per_group(self) -> int:
        return -(-self.pairs_per_group // self.pairs_per_tile)


def _smem_bytes(field_bytes: int, k: int, b: int) -> int:
    """A block's shared memory: the staged field, then k pairs' endpoints
    (float2 slots, an odd count a pair) and their used-beam counts."""
    return field_bytes + k * (b | 1) * 8 + k * 4


def _field_bytes(h: int, pitch: int) -> int:
    return -(-(h + 2 * RING) * pitch * 4 // 16) * 16


@functools.lru_cache(maxsize=None)
def launch_plan(p: int, g_f: int, h: int, w: int, b: int, nt: int, ny: int,
                nx: int, *, sm_count: int = H100["sm_count"],
                smem_block: int = H100["smem_block"],
                smem_sm: int = H100["smem_sm"]) -> K1Plan:
    """The launch of K1 for P particles on G_f fields of H x W cells, B
    beam slots and nt x ny x nx candidates a particle, on a card with
    `sm_count` SMs and the given shared memory a block (opt-in) and an SM.

    The shared variant runs when the ringed field and one pair's endpoints
    fit a block and either the field is shared by every particle (G_f = 1)
    or a group's samples outnumber its cells.  The pairs a tile are those
    of the least estimated time: the warps of units a tile needs over the
    busy warps that run at once (whole blocks an SM from threads,
    registers and shared memory, short of SMEM_SM_MARGIN; capped at
    SATURATING_WARPS an SM), a unit of `run` candidates
    costing UNIT_COST + run * SAMPLE_COST; of the plans within 1 % of the
    best, the one of most threads a block (fewer copies of the field),
    then of the smallest tile and run.  Staging the field costs
    STAGE_COST a cell in every block that holds it.  A group's tiles are
    split over enough blocks to fill the card: at G_f = 1 a persistent
    grid, at G_f = P one block a particle."""
    ring_w = w + 2 * RING
    variant, pitch, field_bytes = "global", 0, 0
    # a block that stages the field must also fit an SM's budget
    room_block = min(smem_block, smem_sm - SMEM_SM_MARGIN - 1024)
    if g_f == 1 or (p // g_f) * nt * ny * nx * b >= h * w:
        for pitch in (ring_w + (8 - ring_w % 16) % 16, ring_w):
            field_bytes = _field_bytes(h, pitch)
            if _smem_bytes(field_bytes, 1, b) <= room_block:
                variant = "shared"
                break
    if variant == "global":
        pitch, field_bytes = 0, 0
    groups = g_f if variant == "shared" else 1
    ppg = p // groups * nt
    room = min(STAGE_BYTES, room_block - field_bytes)
    k_cap = max(1, min(ppg, room // ((b | 1) * 8 + 4)))

    staged = (h + 2 * RING) * ring_w if variant == "shared" else 0

    def estimate(k, run):
        units = ny * -(-nx // run)
        # a block that stages a field of its own stages it with all threads
        threads = (MAX_THREADS if variant == "shared" and groups > 1 else
                   min(MAX_THREADS, -(-k * units // 32) * 32))
        full, rem = divmod(ppg, k)
        tiles = full + (rem > 0)
        warp_rounds = groups * (full * -(-k * units // 32)
                                + -(-rem * units // 32))
        smem = _smem_bytes(field_bytes, k, b)
        per_sm = min(2048 // threads, 32,
                     (smem_sm - SMEM_SM_MARGIN) // (smem + 1024),
                     65536 // (threads * REGISTERS))
        splits = min(tiles, max(1, -(-sm_count * per_sm // groups)))
        busy = min(threads, -(-k * units // 32) * 32) // 32   # warps a tile
        warps = min(groups * tiles, sm_count * per_sm) * busy
        work = (warp_rounds * (UNIT_COST + run * SAMPLE_COST) * b
                + groups * splits * staged / 32 * STAGE_COST)
        cost = work / min(warps, sm_count * SATURATING_WARPS)
        return cost, threads, smem, splits

    costs = {(k, run): estimate(k, run) for k in range(1, k_cap + 1)
             for run in range(1, min(nx, MAX_RUN) + 1)}
    best = min(cost for cost, *_ in costs.values())
    k, run = min((key for key, (cost, *_) in costs.items()
                  if cost <= 1.01 * best),
                 key=lambda key: (-costs[key][1], key))
    _, threads, smem, splits = costs[k, run]
    return K1Plan(variant, pitch, k, run, splits, groups, ppg, threads,
                  smem)


class TilePlan(NamedTuple):
    """How the tile variant runs on a tile too large to stage (csrc/
    matcher.cu, stage_scores_tile_kernel): a work item is a (particle,
    heading) pair's units, `unit_warps` items a pair of more than 32
    units; a lane works a unit of `run` dx candidates of one dy.  Each of
    `grid` blocks takes a contiguous run of the items, a warp every
    `warps`, and stages the box their taps reach where it fits the
    box_floats its warps' endpoints leave, else reads the taps from the
    field."""
    variant: str           # "staged"
    run: int
    unit_warps: int
    warps: int
    grid: int
    threads: int
    smem_bytes: int        # dynamic shared memory a block
    box_floats: int        # the largest box a block stages (pitch x rows)


@functools.lru_cache(maxsize=None)
def tile_launch_plan(p: int, g_f: int, h: int, w: int, b: int, nt: int,
                     ny: int, nx: int, *,
                     sm_count: int = H100["sm_count"],
                     smem_block: int = H100["smem_block"],
                     smem_sm: int = H100["smem_sm"]):
    """The launch of K1's tile variant on (G_f, H, W) extended tiles:
    launch_plan's plan where that is the shared variant (the tile and its
    ring staged in a block), else a TilePlan.  A lane takes the fewest dx
    candidates (`run`) that keep a pair's units within one warp.
    STAGED_BLOCKS blocks an SM share its shared memory (less what the card
    keeps back); a block has STAGED_WARPS warps, fewer where their staged
    endpoints (B | 1 float2 slots a warp) would take more than half of
    it, and what the endpoints leave holds the box.  The grid is
    STAGED_BLOCKS blocks an SM (no more than the items), each a run of
    the pairs."""
    plan = launch_plan(p, g_f, h, w, b, nt, ny, nx, sm_count=sm_count,
                       smem_block=smem_block, smem_sm=smem_sm)
    if plan.variant == "shared":
        return plan
    run = next((r for r in range(1, MAX_RUN + 1)
                if ny * -(-nx // r) <= WARP), MAX_RUN)
    unit_warps = -(-(ny * -(-nx // run)) // WARP)
    smem = min(smem_block - 64,
               smem_sm // STAGED_BLOCKS - BLOCK_RESERVED) // 16 * 16
    ep_floats = (b | 1) * 2                # a warp's staged endpoints
    warps = max(1, min(STAGED_WARPS, smem // 2 // (ep_floats * 4)))
    grid = max(1, min(p * nt * unit_warps, STAGED_BLOCKS * sm_count))
    box = (smem // 4 - warps * ep_floats) // 4 * 4
    return TilePlan("staged", run, unit_warps, warps, grid, WARP * warps,
                    smem, box)


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> dict:
    """launch_plan's card arguments for CUDA device `index`, read from the
    card itself."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(index):
        _build.check("gs_device_limits", _build.library().gs_device_limits(
            *(ctypes.byref(v) for v in vals)))
    return dict(zip(("sm_count", "smem_block", "smem_sm"),
                    (v.value for v in vals)))


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


def fma32(a, b, c):
    """fma(a, b, c) for float32 tensors (or Python floats), rounded once to
    float32, on the CPU and the card alike.  The product of two float32 is
    exact in float64; the sum with c is not always (a small c far below the
    product, or the reverse), so a two-sum takes its error and the sum is
    rounded to odd: where it was inexact and its last bit is even it moves
    one float64 ulp toward the error.  A float64 rounded to odd and then to
    float32 is the exact value rounded to float32 (53 bits >= 24 + 2), so no
    double rounding is left."""
    f64 = torch.float64
    a, b, c = (v.to(f64) if torch.is_tensor(v) else v for v in (a, b, c))
    prod = a * b
    s = prod + c
    z = s - prod
    err = (prod - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf),
                                            err))
    return torch.where((err != 0) & even & err.isfinite(), odd,
                       s).to(torch.float32)


def _f32(value: float):
    """A Python float as a 0-dim float32 tensor on the CPU (rounded to
    nearest, as JAX makes a weakly typed constant), which a tensor on any
    device takes as a scalar."""
    return torch.tensor(value, dtype=torch.float32)


def _inv_res(resolution: float):
    """float32(1) / float32(resolution), the reciprocal JAX's compiled
    division multiplies by (and csrc/matcher.cu's inv_res)."""
    return _f32(1.0) / _f32(resolution)


def _scan_rows(px, py, use, p: int):
    """A grouped scan (G_b, B) as (P, 1, B) rows and `use` as
    (P, 1, 1, 1, B); a scan (B,) as it is."""
    if px.dim() == 2:
        px, py, use = (per_particle(a, p)[:, None] for a in (px, py, use))
        use = use[:, :, None, None, :]
    return px, py, use


def rotated(px, py, pose0, dts):
    """The beam endpoints (P, 1, B) or (B,) rotated by each candidate
    heading pose0.theta + dts: (rx, ry), each (P, nt, B), in the JAX
    package's compiled order, fma(px, c, -(py s)) and fma(px, s, py c),
    with torch's cos and sin (csrc/matcher.cu's sincosf gives their bits on
    the card)."""
    theta = pose0[:, 2, None] + dts                           # (P, nt)
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    return fma32(px, c, -(py * s)), fma32(px, s, py * c)


def cell_coord(r, h, o, inv_res):
    """The fractional cell-center coordinate of the world coordinate r + h
    (r a rotated endpoint, h the candidate's pose plus offset) on the axis
    of origin o: fma((r + h) - o, inv_res, -0.5), each add rounded to
    float32."""
    return fma32((r + h) - o, inv_res, -0.5)


def cell_coords(px, py, pose0, dxs, dys, dts, *, resolution: float, origin):
    """fx (P, nt, nx, B) and fy (P, nt, ny, B), the taps' fractional
    cell-center coordinates, in the order XLA compiles
    gridmap_slam_tpu/ops/matcher.py::_stage_scores into on the CPU (jitted;
    op by op JAX divides by the resolution, and rotates with unfused
    products): `rotated`, then `cell_coord`.  The kernel's nearest branch
    computes the same floats, so both round to the same cells."""
    inv_res = _inv_res(resolution)
    rx, ry = rotated(px, py, pose0, dts)                      # (P, nt, B)
    hx = (pose0[:, 0, None] + dxs)[:, None, :, None]          # (P, 1, nx, 1)
    hy = (pose0[:, 1, None] + dys)[:, None, :, None]
    return (cell_coord(rx[:, :, None, :], hx, _f32(origin[0]), inv_res),
            cell_coord(ry[:, :, None, :], hy, _f32(origin[1]), inv_res))


def stage_scores_batch_plain(field, px, py, use, pose0, dxs, dys, dts, *,
                             resolution: float, origin, max_range: float,
                             nearest: bool = False):
    """Plain version: ops/matcher._stage_scores for every particle at once,
    on the grouped fields and scans, its coordinates in JAX's compiled
    order (cell_coords).  Returns (P, nt, ny, nx)."""
    ll_outside = math.log(1.0 / max_range)
    px, py, use = _scan_rows(px, py, use, pose0.shape[0])
    fx, fy = cell_coords(px, py, pose0, dxs, dys, dts, resolution=resolution,
                         origin=origin)            # (P, nt, nx | ny, B)
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
    if b > _MAX_BEAMS or p * max(nt, ny, nx) >= 2 ** 31:
        raise ValueError(f"{fn}: at most {_MAX_BEAMS} beams and 2^31 "
                         f"offsets a call; got {b}, {p * max(nt, ny, nx)}")
    out = torch.empty((p, nt, ny, nx), dtype=torch.float32, device=dev)
    plan = launch_plan(p, g_f, h, w, b, nt, ny, nx,
                       **device_limits(dev.index))
    lib = _build.library()
    code = lib.gs_stage_scores(
        field.data_ptr(), px.data_ptr(), py.data_ptr(), use.data_ptr(),
        pose0.data_ptr(), dxs.data_ptr(), dys.data_ptr(), dts.data_ptr(),
        out.data_ptr(), p, g_f, g_b, h, w, b, nt, ny, nx, resolution, origin[0],
        origin[1], math.log(1.0 / max_range), int(nearest),
        int(plan.variant == "shared"), plan.pitch, plan.pairs_per_tile,
        plan.run, plan.splits, plan.threads, plan.smem_bytes,
        stream_handle(dev))
    launches += 1
    _build.check("gs_stage_scores", code)
    return out


def kernel_rotation(theta):
    """(sin, cos) of float32 headings on the card as the stage kernels take
    them (csrc/matcher.cu `rotation`, through gs_k1_rotation), for a check
    of their bits against torch.sin and torch.cos (`rotated`).  Counts no
    launch of K1."""
    check_tensor("kernel_rotation", "theta", theta, theta.shape,
                 theta.device)
    sn, cs = torch.empty_like(theta), torch.empty_like(theta)
    _build.check("gs_k1_rotation", _build.library().gs_k1_rotation(
        theta.data_ptr(), sn.data_ptr(), cs.data_ptr(), theta.numel(),
        stream_handle(theta.device)))
    return sn, cs


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


def _owned(x0, c0: int, w_loc: int, n_m: int):
    """Whether the tile [c0, c0 + w_loc) of n_m owns base column x0: the
    tile of x0, clipped to [0, n_m - 1] (beams off the world's west side
    belong to the first tile, off its east side to the last)."""
    j = c0 // w_loc
    return torch.clamp(torch.div(x0, w_loc, rounding_mode="floor"), 0,
                       n_m - 1) == j


def _tile_coords(px, py, use, pose0, dxs, dys, dts, *, resolution: float,
                 origin, nearest: bool):
    """The tile variant's bilinear cell coordinates in the kernel's order
    (1/res times the rotated endpoint, plus 1/res times the candidate's
    offset from the origin less a cell): the endpoints sx, sy (P, nt, B),
    the candidates' cx (P, nx) and cy (P, ny), and `use` as
    (P, 1, 1, 1, B) or (B,).  With `nearest` the candidates' parts are a
    half cell higher: sx + cx then rounds to the nearest branch's cells
    (cell_coords) but at rounding ties, close enough to count the cells a
    call reads."""
    px, py, use = _scan_rows(px, py, use, pose0.shape[0])
    inv_res = _inv_res(resolution).to(pose0.device)
    c_off = 0.5 if nearest else 1.0
    theta = pose0[:, 2, None] + dts                           # (P, nt)
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    sx = (px * c - py * s) * inv_res                          # (P, nt, B)
    sy = (px * s + py * c) * inv_res
    cx = (pose0[:, 0, None] + dxs - origin[0]) * inv_res - c_off   # (P, nx)
    cy = (pose0[:, 1, None] + dys - origin[1]) * inv_res - c_off   # (P, ny)
    return sx, sy, cx, cy, use


def stage_scores_tile_plain(field, px, py, use, pose0, dxs, dys, dts, *,
                            resolution: float, origin, max_range: float,
                            c0: int, w_loc: int, n_m: int, ext: int = 1,
                            nearest: bool = False):
    """Plain version of the tile variant: the JAX package's
    _stage_scores_tiled (gridmap_slam_tpu/parallel/tiled.py:104-158) for
    every particle at once, on grouped fields and scans as
    stage_scores_batch_plain.  field: (G_f, H, w_loc + 2 ext), the tile
    [c0, c0 + w_loc) extended by ext columns each side, whose world-edge
    columns hold log(1 / max_range).  A beam's base column is taken in
    global cells from the unshifted origin; only the beams whose base
    column the tile owns (`_owned`) add to the sum, with their taps read at
    that column less c0 - ext.

    The bilinear cell coordinates follow the kernel's arithmetic
    (_tile_coords), rounded to the nearest cell, where the JAX function
    divides the world coordinate less the origin by res: 4000 cells from
    the origin (the city map) a float32 coordinate is good to 2.4e-4 of a
    cell, and the two orders then part by more than K1's tolerance.  The
    interpolation is the kernel's two lerps.  The nearest branch's
    coordinates are stage_scores_batch_plain's (cell_coords), which the
    kernel's nearest branch computes too.  Returns (P, nt, ny, nx)."""
    ll_outside = math.log(1.0 / max_range)
    if nearest:
        px, py, use = _scan_rows(px, py, use, pose0.shape[0])
        fx, fy = cell_coords(px, py, pose0, dxs, dys, dts,
                             resolution=resolution, origin=origin)
    else:
        sx, sy, cx, cy, use = _tile_coords(px, py, use, pose0, dxs, dys, dts,
                                           resolution=resolution,
                                           origin=origin, nearest=False)
        fx = sx[:, :, None, :] + cx[:, None, :, None]         # (P, nt, nx, B)
        fy = sy[:, :, None, :] + cy[:, None, :, None]         # (P, nt, ny, B)
    # rounded to the nearest cell: the nearest cell's index, or (bilinear,
    # a half cell lower) the base cell's
    x0f, y0f = torch.round(fx), torch.round(fy)
    x0 = x0f.to(torch.int64)
    xl = (x0 - (c0 - ext))[:, :, None]
    y0 = y0f.to(torch.int64)[:, :, :, None]
    if nearest:
        ll = _taps(field, xl, y0, ll_outside)
    else:
        tx = (fx - x0f + 0.5)[:, :, None]
        ty = (fy - y0f + 0.5)[:, :, :, None]
        v00 = _taps(field, xl, y0, ll_outside)
        v10 = _taps(field, xl + 1, y0, ll_outside)
        v01 = _taps(field, xl, y0 + 1, ll_outside)
        v11 = _taps(field, xl + 1, y0 + 1, ll_outside)
        a = v00 + tx * (v10 - v00)
        ll = a + ty * (v01 + tx * (v11 - v01) - a)            # (P,nt,ny,nx,B)
    mine = _owned(x0, c0, w_loc, n_m)[:, :, None]
    return torch.where(use & mine, ll, 0.0).sum(-1)


def _check_tile(fn, field, c0, w_loc, n_m, ext):
    if w_loc <= 0 or n_m <= 0 or ext < 1 or c0 < 0 or c0 % w_loc \
            or c0 // w_loc >= n_m or field.shape[-1] != w_loc + 2 * ext:
        raise ValueError(f"{fn}: tile c0={c0}, w_loc={w_loc}, n_m={n_m}, "
                         f"ext={ext} does not fit a field of width "
                         f"{field.shape[-1]}")


def stage_scores_tile_cuda(field, px, py, use, pose0, dxs, dys, dts, *,
                           resolution: float, origin, max_range: float,
                           c0: int, w_loc: int, n_m: int, ext: int = 1,
                           nearest: bool = False, paths=None):
    """The tile variant of the kernel; arguments as stage_scores_batch_cuda
    with the field (G_f, H, w_loc + 2 ext) and the tile c0, w_loc, n_m,
    ext.  The launch plan is tile_launch_plan's at the extended tile's
    shape.  `paths`, where given, is two int32 counts on the field's
    device to which the staged kernel adds each block that had used beams:
    [blocks that staged their box, blocks that read the field]."""
    global tile_launches
    fn = "stage_scores_tile_cuda"
    if field.dim() != 3 or px.dim() not in (1, 2) or pose0.dim() != 2 \
            or dxs.dim() != 2 or dys.dim() != 2 or dts.dim() != 2:
        raise ValueError(f"{fn}: need field (G_f, H, W), px (G_b, B) or "
                         f"(B,), pose0 (P, 3) and (P, n) offsets")
    _check_tile(fn, field, c0, w_loc, n_m, ext)
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
    if paths is not None:
        check_tensor(fn, "paths", paths, (2,), dev, dtype=torch.int32)
    if b > _MAX_BEAMS or p * max(nt, ny, nx) >= 2 ** 31:
        raise ValueError(f"{fn}: at most {_MAX_BEAMS} beams and 2^31 "
                         f"offsets a call; got {b}, {p * max(nt, ny, nx)}")
    plan = tile_launch_plan(p, g_f, h, w, b, nt, ny, nx,
                            **device_limits(dev.index))
    out = torch.empty((p, nt, ny, nx), dtype=torch.float32, device=dev)
    lib = _build.library()
    args = (field.data_ptr(), px.data_ptr(), py.data_ptr(), use.data_ptr(),
            pose0.data_ptr(), dxs.data_ptr(), dys.data_ptr(),
            dts.data_ptr(), out.data_ptr(), p, g_f, g_b, h, w, b, nt, ny, nx,
            resolution, origin[0], origin[1], math.log(1.0 / max_range),
            int(nearest), c0, w_loc, n_m, ext)
    if plan.variant == "staged":
        name = "gs_stage_scores_tile_staged"
        code = lib.gs_stage_scores_tile_staged(
            *args, plan.run, plan.warps, plan.grid, plan.smem_bytes,
            0 if paths is None else paths.data_ptr(), stream_handle(dev))
    else:
        name = "gs_stage_scores_tile"
        code = lib.gs_stage_scores_tile(
            *args, plan.pitch, plan.pairs_per_tile, plan.run, plan.splits,
            plan.threads, plan.smem_bytes, stream_handle(dev))
    tile_launches += 1
    _build.check(name, code)
    return out


def stage_scores_tile(field, px, py, use, pose0, dxs, dys, dts, *,
                      resolution: float, origin, max_range: float, c0: int,
                      w_loc: int, n_m: int, ext: int = 1,
                      nearest: bool = False):
    """(P, nt, ny, nx) partial measurement log-likelihoods of one column
    tile (see stage_scores_tile_plain); summed over the n_m tiles they are
    stage_scores_batch on the whole map."""
    fn = (stage_scores_tile_cuda if field.is_cuda
          else stage_scores_tile_plain)
    return fn(field, px, py, use, pose0, dxs, dys, dts, resolution=resolution,
              origin=origin, max_range=max_range, c0=c0, w_loc=w_loc,
              n_m=n_m, ext=ext, nearest=nearest)
