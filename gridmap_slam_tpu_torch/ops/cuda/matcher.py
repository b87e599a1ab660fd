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
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build, check_tensor, stream_handle

launches = 0   # kernel launches since the count was last set to 0

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
    if g_f == 1 or (p // g_f) * nt * ny * nx * b >= h * w:
        for pitch in (ring_w + (8 - ring_w % 16) % 16, ring_w):
            field_bytes = _field_bytes(h, pitch)
            if _smem_bytes(field_bytes, 1, b) <= smem_block:
                variant = "shared"
                break
    if variant == "global":
        pitch, field_bytes = 0, 0
    groups = g_f if variant == "shared" else 1
    ppg = p // groups * nt
    room = min(STAGE_BYTES, smem_block - field_bytes)
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


def stage_scores_batch_plain(field, px, py, use, pose0, dxs, dys, dts, *,
                             resolution: float, origin, max_range: float,
                             nearest: bool = False):
    """Plain version: ops/matcher._stage_scores for every particle at once,
    on the grouped fields and scans.  Returns (P, nt, ny, nx)."""
    ll_outside = math.log(1.0 / max_range)
    p = pose0.shape[0]
    if px.dim() == 2:              # one scan a group: (P, 1, B) rows
        px, py, use = (per_particle(a, p)[:, None] for a in (px, py, use))
        use = use[:, :, None, None, :]
    theta = pose0[:, 2, None] + dts                           # (P, nt)
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    rx = px * c - py * s                                      # (P, nt, B)
    ry = px * s + py * c
    wx = rx[:, :, None, :] + (pose0[:, 0, None] + dxs)[:, None, :, None]
    wy = ry[:, :, None, :] + (pose0[:, 1, None] + dys)[:, None, :, None]
    fx = (wx - origin[0]) / resolution - 0.5                  # (P, nt, nx, B)
    fy = (wy - origin[1]) / resolution - 0.5                  # (P, nt, ny, B)
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
