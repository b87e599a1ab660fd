"""F1-F8: eight of XLA's fusions as kernels, csrc/fusions.cu.

The JAX package leaves the motion model, the matcher's coarse pool and each
matcher stage's prior, argmax and pick, the surface step's sample and
splat, and every step's scan preparation to XLA, which fuses each into one
loop or reduce fusion (gridmap_slam_tpu/models/rbpf.py:180-182;
gridmap_slam_tpu/ops/matcher.py:246-252 and :302-321;
gridmap_slam_tpu/ops/surface.py:60-99 and :231-318;
gridmap_slam_tpu/ops/geometry.py:67, ops/raycast.py, ops/pallas/
grid_update.py:58).  Here they are one kernel each, with the bits of the
port's op sequence on the card:

- F1 `motion`: sample_motion and apply_odometry of ops/motion.py, either or
  both in one launch (the RBPF and the shared-map matcher take both);
- F2 `pool`: ops/matcher.half_resolution, the pad to even and the 2 x 2
  mean;
- F3 `pick`: after K1 has scored a stage, the motion prior (`_prior_grid`,
  scaled by the used-beam fraction at the coarse stage), the first argmax
  of scores + prior and the pick: the next stage's offsets, or the best
  pose and its measurement score after the last stage, written into the
  rows of the step's tensors it is given.  The stage's prior and total
  tensors do not exist on the card; a stage of any number of (dy, dx)
  cells (past 2048, a lane walks its cells in groups);
- F4 `score_on_volume`: ops/surface.sample_surface with packed
  neighbourhoods, then refine_on_surface's hill-climb (all its steps), in
  one launch reading the volume in place, the score tempered as it is
  written (`temper`, models/shared.surface_temper): the packed array
  (ops/surface.pack_neighborhoods, 8x the volume) does not exist on the
  card;
- F5 `endpoint_factors`: ops/surface.splat_factors, the endpoint images' two (nt, B,
  K) factors (their batched matmul stays torch.bmm, ops/surface.
  endpoint_images, as JAX leaves it to a dot);
- F6 `prepare_scan`, `bin_tables`, `deskew`: ops/geometry.deskew_scan and
  ops/cuda/grid_update.scan_bin_tables (with ops/raycast.build_beam_lut),
  together or either, for one scan or a batch (G, B); `prepare_scan`
  returns a step's ScanPrep: with them the endpoints
  (ops/geometry.scan_points), the used beams and their float32, every
  coarse_beam_stride-th of them, their count and the map update's gate
  `keep`, all once a scan;
- F7 `weights`: the weights' tail of every step (gridmap_slam_tpu/models/
  rbpf.py:254-278, models/shared.py:386-461 and :197-240, models/
  multi.py:110-142): the max, the first argmax and its pose, Neff and the
  weighted mean pose of log-weights (R, P), and for the shared map the
  scalar epilogue (the resample gate, the integration pose, the recovery
  EMAs and p_inject), in one launch a call where P <= 1024 and three
  above (`weights_plan`), the sums in ops/resample's fixed order; for one
  robot it also places a WindowSpec's window: the surface volume's crop,
  extended window and theta bins around the odometry-propagated mean
  (`volume_window`), or the map update's crop around the integration
  pose;
- F8 `walk`: the systematic resample inside the gate's body
  (ops/resample.systematic_indices with the gathers of the poses and
  log-weights at the ancestors), in two launches, from F7's max and total;
- F7's and F8's mesh forms, the distributed engines' tail (gridmap_slam_
  tpu/parallel/shmap.py:94-103, :136-157, :178-205): `weights_mesh`, F7's
  sums as passes over one rank's rows with the collectives over the ranks
  (`Collectives`, callables the caller passes) between them and an
  epilogue on the reduced values, and `walk_mesh`, F8 on every rank's
  gathered rows for this rank's slots.

Each dispatching function (`motion`, `pool`, `pick`, `score_on_volume`,
`endpoint_factors`, F6's three, `weights`, `walk`, `weights_mesh`,
`walk_mesh`) runs the kernel for a
tensor on the card and the plain version (`*_plain`, the op sequence the
kernel replaces, which keeps the CPU's bits) for a tensor on the CPU; the
`*_cuda` entry points raise ValueError on other tensors.  Each kernel counts
its launches in `motion_launches`, `pool_launches`, `pick_launches`,
`sample_launches` (F4), `splat_launches`, `scan_launches`,
`weights_launches` (F7: one or three kernels a call), `walk_launches`
(F8: two), `weights_mesh_launches` and `walk_mesh_launches` (four each).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...types import Odom, Scan
from ..geometry import deskew_scan, scan_points, wrap_angle
from ..resample import (ROW, exp_weights, integration_pose,
                        max_fixed_order, mean_pose_of, neff_of,
                        recovery_ema, sum_fixed_order, sums_fixed_order,
                        systematic_indices)
from ..surface import (crop_center_cells, pack_neighborhoods,
                       refine_on_surface, sample_surface, splat_factors)
from . import _build, check_tensor, stream_handle
from .grid_update import scan_bin_tables
from .matcher import H100, per_particle

motion_launches = 0   # F1 launches since the count was last set to 0
pool_launches = 0     # F2, likewise
pick_launches = 0     # F3, likewise
sample_launches = 0   # F4, likewise
splat_launches = 0    # F5, likewise
scan_launches = 0     # F6, likewise
weights_launches = 0  # F7's kernels launched (one a call of P <= 1024
#                       weights a robot, else three), likewise
walk_launches = 0     # F8's (two a call), likewise
weights_mesh_launches = 0  # F7's mesh form's (four a call), likewise
walk_mesh_launches = 0     # F8's mesh form's (four a call), likewise


def noise_scales(odom: Odom, cfg):
    """(sd_center, sd_theta) per slam/Odometry.java:60-69."""
    sd_c = (cfg.base_center + torch.abs(odom.d_center) * cfg.rel_center) / 2.0
    sd_t = math.radians(cfg.base_theta_deg) + torch.abs(odom.d_theta) * cfg.rel_theta
    return sd_c, sd_t


def _motion_args(cfg):
    return (float(cfg.base_center), float(cfg.rel_center),
            math.radians(cfg.base_theta_deg), float(cfg.rel_theta))


def _groups(fn: str, d, lead) -> torch.Tensor:
    """An odometry field as (G,) rows of particles in G contiguous runs:
    a 0-dim tensor, or one whose shape less its trailing ones leads `lead`
    (the particles' leading shape) and so broadcasts a row to a run."""
    shape = tuple(d.shape)
    while shape != tuple(lead[:len(shape)]) and shape and shape[-1] == 1:
        shape = shape[:-1]
    if shape != tuple(lead[:len(shape)]):
        raise ValueError(f"{fn}: odometry of shape {tuple(d.shape)} does not "
                         f"give one row a run of particles {tuple(lead)}")
    return d.reshape(-1).contiguous()


def _f32(x) -> float:
    """A Python number rounded to float32, as PyTorch passes a scalar to a
    float32 kernel."""
    return float(np.float32(x))


def _inv(x) -> float:
    """PyTorch's reciprocal of a Python float divisor on the card: 1 / x in
    float32 (a tensor / float is a product by it there)."""
    return float(np.float32(1.0) / np.float32(x))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------- F1: motion
def sample_motion_plain(pose, odom: Odom, cfg, normals):
    """slam/Odometry.java:77-96 in tensor ops (ops/motion.sample_motion)."""
    sd_c, sd_t = noise_scales(odom, cfg)
    d = odom.d_center + sd_c * normals[..., 0]
    th = odom.d_theta + sd_t * normals[..., 1]
    theta = wrap_angle(pose[..., 2] + th)
    x = pose[..., 0] + torch.cos(theta) * d
    y = pose[..., 1] + torch.sin(theta) * d
    return torch.stack([x, y, theta], -1)


def apply_odometry_plain(pose, odom: Odom):
    """x0 (+) u in tensor ops (ops/motion.apply_odometry)."""
    theta = wrap_angle(pose[..., 2] + odom.d_theta)
    x = pose[..., 0] + torch.cos(theta) * odom.d_center
    y = pose[..., 1] + torch.sin(theta) * odom.d_center
    return torch.stack([x, y, theta], -1)


def motion_plain(pose, d_center, d_theta, normals, *, cfg=None,
                 deterministic: bool = False):
    """Plain version of F1: (sample_motion, apply_odometry) of `pose`
    (..., 3), the first where `normals` (..., 2) are given and the second
    where `deterministic`, else None."""
    odom = Odom(d_center, d_theta)
    return (None if normals is None else
            sample_motion_plain(pose, odom, cfg, normals),
            apply_odometry_plain(pose, odom) if deterministic else None)


def motion_cuda(pose, d_center, d_theta, normals, *, cfg=None,
                deterministic: bool = False):
    """The kernel: motion_plain's outputs in one launch.  pose (..., 3)
    float32 on the card; normals (..., 2) or None; d_center, d_theta
    0-dim or one row a run of particles (multi-robot: (R, 1) for poses
    (R, P, 3))."""
    global motion_launches
    fn = "motion_cuda"
    dev = pose.device
    if pose.dim() == 0 or pose.shape[-1] != 3:
        raise ValueError(f"{fn}: need poses (..., 3), got {tuple(pose.shape)}")
    lead = tuple(pose.shape[:-1])
    n = math.prod(lead)
    flat = pose.reshape(n, 3).contiguous()
    check_tensor(fn, "pose", flat, (n, 3), dev)
    dc, dt = (_groups(fn, d, lead) for d in (d_center, d_theta))
    g = dc.shape[0]
    check_tensor(fn, "d_center", dc, (g,), dev)
    check_tensor(fn, "d_theta", dt, (g,), dev)
    if n % g:
        raise ValueError(f"{fn}: {g} odometry rows do not divide {n} poses")
    out_s = out_det = nrm = None
    if normals is not None:
        nrm = normals.reshape(n, 2).contiguous()
        check_tensor(fn, "normals", nrm, (n, 2), dev)
        out_s = torch.empty_like(flat)
    if deterministic:
        out_det = torch.empty_like(flat)
    consts = _motion_args(cfg) if normals is not None else (0.0,) * 4
    code = _build.library().gs_fusion_motion(
        flat.data_ptr(), _ptr(nrm), dc.data_ptr(), dt.data_ptr(),
        _ptr(out_s), _ptr(out_det), n, g, *consts,
        stream_handle(dev))
    motion_launches += 1
    _build.check("gs_fusion_motion", code)
    return tuple(None if o is None else o.reshape(pose.shape)
                 for o in (out_s, out_det))


def motion(pose, d_center, d_theta, normals, *, cfg=None,
           deterministic: bool = False):
    """(sample_motion(pose, odom, cfg, normals) or None,
    apply_odometry(pose, odom) or None) for odom = (d_center, d_theta):
    F1 on the card, its plain version on the CPU."""
    fn = motion_cuda if pose.is_cuda else motion_plain
    return fn(pose, d_center, d_theta, normals, cfg=cfg,
              deterministic=deterministic)


# ------------------------------------------------------------------ F2: pool
def pool_plain(field, ll_outside: float):
    """Plain version of F2: the 2x2-mean-pooled (G, H/2, W/2) fields of
    (G, H, W) fields, odd edges padded with the out-of-map value."""
    h, w = field.shape[-2:]
    lle = F.pad(field, (0, w & 1, 0, h & 1), value=ll_outside)
    return lle.reshape(lle.shape[0], lle.shape[1] // 2, 2, lle.shape[2] // 2,
                       2).mean((2, 4))


def pool_cuda(field, ll_outside: float):
    """The kernel: pool_plain's result in one pass, a thread an output
    cell.  field: (G, H, W) float32 on the card whose cells are contiguous
    in a row (a column slice of a wider field is read in place)."""
    global pool_launches
    fn = "pool_cuda"
    if field.dim() != 3:
        raise ValueError(f"{fn}: need fields (G, H, W), got "
                         f"{tuple(field.shape)}")
    g, h, w = field.shape
    dev = field.device
    if field.stride(-1) != 1:
        field = field.contiguous()
    if field.device.type != "cuda" or field.dtype != torch.float32:
        raise ValueError(f"{fn}: field must be float32 on the card, got "
                         f"{field.dtype} on {field.device}")
    out = torch.empty((g, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                      device=dev)
    code = _build.library().gs_fusion_pool(
        field.data_ptr(), out.data_ptr(), g, h, w, field.stride(0),
        field.stride(1), float(ll_outside), stream_handle(dev))
    pool_launches += 1
    _build.check("gs_fusion_pool", code)
    return out


def pool(field, ll_outside: float):
    """The (G, H/2, W/2) 2x2-mean-pooled fields of (G, H, W) fields: F2 on
    the card, its plain version on the CPU."""
    fn = pool_cuda if field.is_cuda else pool_plain
    return fn(field, ll_outside)


# ------------------------------------------------------------------ F3: pick
def _scale(x, trailing: int):
    """A 0-dim or (P,) tensor shaped to broadcast against (P, ...) tensors
    with `trailing` dimensions after P."""
    return x if x.dim() == 0 else x.reshape(-1, *(1,) * trailing)


def _prior_grid(dxs, dys, dts, sd_c, sd_t, weight=1.0, bias=None):
    """Motion log-prior over the offset grid, (..., nt, ny, nx) from
    (..., nx), (..., ny), (..., nt) offsets; the noise scales sd_c, sd_t are
    scalars or one a particle (P,).

    `bias` (..., 3) shifts the prior's center: candidates live at
    pose0 + offset, and the prior penalizes deviation from the deterministic
    odometry pose x0 (+) u, so the deviation is bias + offset with
    bias = pose0 - (x0 (+) u).  Without a bias the prior is centered at
    pose0 itself."""
    if bias is None:
        bx = by = bt = 0.0
    else:
        bx, by, bt = bias[..., 0, None], bias[..., 1, None], bias[..., 2, None]
    if torch.is_tensor(sd_c) and sd_c.dim() == 1:
        sd_c, sd_t = _scale(sd_c, 3), _scale(sd_t, 1)
    d2 = ((dys + by) ** 2)[..., :, None] + ((dxs + bx) ** 2)[..., None, :]
    pt = -((dts + bt) ** 2) / (2.0 * sd_t * sd_t)
    return weight * (pt[..., :, None, None]
                     - d2[..., None, :, :] / (2.0 * sd_c * sd_c))


def _take(values, index):
    """values[..., index] for one index per leading position."""
    return torch.gather(values, -1, index[..., None])[..., 0]


def _argmax3(scores, dxs, dys, dts):
    """First argmax of (..., nt, ny, nx) scores: the offsets there and the
    flat index."""
    nt, ny, nx = scores.shape[-3:]
    flat = torch.argmax(scores.reshape(*scores.shape[:-3], nt * ny * nx), -1)
    it = flat // (ny * nx)
    iy = (flat % (ny * nx)) // nx
    ix = flat % nx
    return _take(dxs, ix), _take(dys, iy), _take(dts, it), flat


def _used(use, stride: int = 1):
    """The used beams of a scan mask (..., B), every stride-th, as a float
    no less than 1: a scan's n_all (stride 1) or n_c."""
    return torch.clamp(use[..., ::stride].to(torch.float32).sum(-1), min=1.0)


# F3's launch (csrc/fusions.cu kPickThreads, kPickCells): threads a block;
# the (dy, dx) cells a lane holds in registers at once (a lane with more
# walks them in groups of PICK_CELLS)
PICK_THREADS = 256
PICK_CELLS = 8
# a warp's slab of scores, at most, where a particle's lanes need not
# spread it over the card (a coarse stage's 891 candidates, 3.5 KB: a warp
# a particle; a fine stage's 125: 4 lanes, eight particles a warp)
PICK_WARP_BYTES = 4 * 1024
# a slab's scores a team copies into shared memory, at most (else read in
# place)
PICK_SLAB_BYTES = 16 * 1024


class PickPlan(NamedTuple):
    """How F3 runs a stage (csrc/fusions.cu fusion_pick_kernel): `lanes`
    threads a particle; teams of max(lanes, 32) threads, PICK_THREADS //
    team a block, each taking slabs of `per_slab` = team // lanes
    particles in turn; `staged`: a slab's scores copied into shared memory
    (else read in place).  The kernel's entry lays out the shared memory
    and launches as many blocks as are resident at once."""

    lanes: int
    per_slab: int
    staged: bool


def pick_plan(p: int, nt: int, ny: int, nx: int) -> PickPlan:
    """F3's launch for P particles of nt x ny x nx candidates.  The lanes
    a particle are a power of two, at most PICK_THREADS and the
    candidates' power of two: the fewest that leave a lane at most
    PICK_CELLS (dy, dx) cells and a warp's slab within PICK_WARP_BYTES (or
    one particle), and no fewer than give each of the H100's SMs a block's
    worth of threads (at 250 to 500 particles 128 or 256 threads a
    particle).  Past PICK_CELLS * PICK_THREADS = 2048 cells a lane holds
    more than PICK_CELLS and walks them in groups of PICK_CELLS.  Teams of
    max(lanes, 32) threads take slabs of team // lanes particles in turn,
    each with its own shared memory and barrier (a warp's where lanes <=
    32), copying its next slab while it works the current one, so that no
    barrier waits for another team.  A slab whose scores pass
    PICK_SLAB_BYTES is read in place."""
    n, nyx = nt * ny * nx, ny * nx
    if p <= 0 or n <= 0:
        raise ValueError(f"pick_plan: need particles and candidates, got "
                         f"{p} x {nt} x {ny} x {nx}")
    cap = min(PICK_THREADS, 1 << (n - 1).bit_length())
    lanes = 1
    per_warp = max(1, PICK_WARP_BYTES // (4 * n))
    while lanes < cap and (-(-nyx // lanes) > PICK_CELLS
                           or 32 // min(lanes, 32) > per_warp
                           or p * lanes < H100["sm_count"] * PICK_THREADS):
        lanes *= 2
    per_slab = max(lanes, 32) // lanes
    return PickPlan(lanes, per_slab, per_slab * n * 4 <= PICK_SLAB_BYTES)


def pick_plain(scores, dxs, dys, dts, pose0, center, d_center, d_theta, use,
               off_xy, off_t, *, motion, prior_weight: float,
               stride: int = 1, out=None):
    """Plain version of F3: a stage's pick from its (P, nt, ny, nx) scores
    at the candidates pose0 + (dxs[ix], dys[iy], dts[it]).  The motion
    prior (noise scales of the odometry rows d_center, d_theta; centered at
    `center` (P, 3), or at pose0 where None) times prior_weight, at the
    coarse stage (`use`, the scan's mask (G_b, B) or (B,), given) scaled by
    n_c / n_all, the used beams every `stride`-th over all; the first
    argmax of scores + prior.  Returns the next stage's offsets (fx + off_xy,
    fy + off_xy, ft + off_t) where off_xy is given, else (best poses
    (P, 3), the scores there (P,), times n_all / n_c at the coarse
    stage), written into the tensors of `out` = (best, meas) where it is
    given (a step's rows)."""
    pn = pose0.shape[0]
    sd_c, sd_t = (per_particle(sd, pn)
                  for sd in noise_scales(Odom(d_center, d_theta), motion))
    bias = None
    if center is not None:
        bias = torch.stack([pose0[:, 0] - center[:, 0],
                            pose0[:, 1] - center[:, 1],
                            wrap_angle(pose0[:, 2] - center[:, 2])], 1)
    prior = _prior_grid(dxs, dys, dts, sd_c, sd_t, prior_weight, bias)
    if use is None:
        total = scores + prior
    else:
        n_all = per_particle(_used(use), pn)
        n_c = per_particle(_used(use, stride), pn)
        total = scores + _scale(n_c / n_all, 3) * prior
    fx, fy, ft, flat = _argmax3(total, dxs, dys, dts)
    if off_xy is not None:
        return fx[:, None] + off_xy, fy[:, None] + off_xy, ft[:, None] + off_t
    meas = _take(scores.reshape(pn, -1), flat)
    if use is not None:
        meas = (n_all / n_c) * meas
    best = torch.stack([pose0[:, 0] + fx, pose0[:, 1] + fy,
                        pose0[:, 2] + ft], 1)
    if out is None:
        return best, meas
    return out[0].copy_(best), out[1].copy_(meas)


def pick_cuda(scores, dxs, dys, dts, pose0, center, d_center, d_theta, use,
              off_xy, off_t, *, motion, prior_weight: float,
              stride: int = 1, out=None):
    """The kernel: pick_plain's outputs in one pass over the scores, as
    pick_plan lays it out (slabs of particles, their scores staged in
    shared memory, `lanes` threads a particle).  scores (P, nt, ny, nx),
    dxs (P, nx), dys (P, ny), dts (P, nt), pose0 and center (P, 3),
    float32 on the card; d_center, d_theta 0-dim or (G_o,); use (G_b, B)
    or (B,) bool; off_xy, off_t the next stage's offset vectors; `out`
    (best (P, 3), meas (P,)) after the last stage, the rows the kernel
    writes (none of them an input).  G_o and G_b divide P."""
    global pick_launches
    fn = "pick_cuda"
    if scores.dim() != 4:
        raise ValueError(f"{fn}: need scores (P, nt, ny, nx), got "
                         f"{tuple(scores.shape)}")
    dev = scores.device
    p, nt, ny, nx = scores.shape
    check_tensor(fn, "scores", scores, (p, nt, ny, nx), dev)
    check_tensor(fn, "dxs", dxs, (p, nx), dev)
    check_tensor(fn, "dys", dys, (p, ny), dev)
    check_tensor(fn, "dts", dts, (p, nt), dev)
    check_tensor(fn, "pose0", pose0, (p, 3), dev)
    if center is not None:
        check_tensor(fn, "center", center, (p, 3), dev)
    dc, dt = (d.reshape(-1).contiguous() for d in (d_center, d_theta))
    g_o = dc.shape[0]
    check_tensor(fn, "d_center", dc, (g_o,), dev)
    check_tensor(fn, "d_theta", dt, (g_o,), dev)
    g_b = b = 0
    if use is not None:
        use = use.reshape(-1, use.shape[-1])
        g_b, b = use.shape
        check_tensor(fn, "use", use, (g_b, b), dev, dtype=torch.bool)
    if g_o == 0 or p % g_o or (use is not None and (g_b == 0 or p % g_b)):
        raise ValueError(f"{fn}: {g_o} odometry rows and {g_b} scans must "
                         f"each divide the {p} particles")
    if p * nt * ny * nx >= 2 ** 31 or stride < 1:
        raise ValueError(f"{fn}: at most 2^31 candidates a call and a "
                         f"stride of 1 or more")
    n_xy = n_t = 0
    if off_xy is not None:
        n_xy, n_t = off_xy.shape[0], off_t.shape[0]
        check_tensor(fn, "off_xy", off_xy, (n_xy,), dev)
        check_tensor(fn, "off_t", off_t, (n_t,), dev)
        outs = (torch.empty((p, n_xy), dtype=torch.float32, device=dev),
                torch.empty((p, n_xy), dtype=torch.float32, device=dev),
                torch.empty((p, n_t), dtype=torch.float32, device=dev))
        best = meas = None
    else:
        outs = None
        best, meas = out if out is not None else (
            torch.empty((p, 3), dtype=torch.float32, device=dev),
            torch.empty((p,), dtype=torch.float32, device=dev))
        check_tensor(fn, "best", best, (p, 3), dev)
        check_tensor(fn, "meas", meas, (p,), dev)

    nxt = outs if outs is not None else (None, None, None)
    plan = pick_plan(p, nt, ny, nx)
    code = _build.library().gs_fusion_pick(
        scores.data_ptr(), dxs.data_ptr(), dys.data_ptr(), dts.data_ptr(),
        pose0.data_ptr(), _ptr(center), dc.data_ptr(), dt.data_ptr(),
        _ptr(use), _ptr(off_xy), _ptr(off_t), *(_ptr(t) for t in nxt),
        _ptr(best), _ptr(meas), p, nt, ny, nx, g_o, max(g_b, 1), b, stride,
        n_xy, n_t, plan.lanes, plan.per_slab, int(plan.staged),
        float(prior_weight), *_motion_args(motion),
        stream_handle(dev))
    pick_launches += 1
    _build.check("gs_fusion_pick", code)
    return outs if outs is not None else (best, meas)


def pick(scores, dxs, dys, dts, pose0, center, d_center, d_theta, use,
         off_xy, off_t, *, motion, prior_weight: float, stride: int = 1,
         out=None):
    """A matcher stage's pick (see pick_plain): F3 on the card, its plain
    version on the CPU."""
    fn = pick_cuda if scores.is_cuda else pick_plain
    return fn(scores, dxs, dys, dts, pose0, center, d_center, d_theta, use,
              off_xy, off_t, motion=motion, prior_weight=prior_weight,
              stride=stride, out=out)


# --------------------------------------------------------- F4: sample, climb
def temper(scores, temp: float = 1.0, n_used=None):
    """The surface weights' temperature (models/shared.surface_temper):
    scores as they are where temp is 1, times temp where it is above 0,
    else times rsqrt(n_used), n_used the scan's used beams clamped to at
    least 1 (F6's)."""
    if temp == 1.0:
        return scores
    if temp > 0.0:
        return scores * temp
    return scores * torch.rsqrt(n_used)


def score_plain(c_vol, poses, *, steps: int = 0, theta0, dtheta, crop_iy0,
                crop_ix0, resolution: float, origin, wrap_theta: bool = False,
                temp: float = 1.0, n_used=None):
    """Plain version of F4: the measurement log-likelihood of poses (..., 3),
    ops/surface.sample_surface on the packed neighbourhoods
    (pack_neighborhoods, built here), then `steps` steps of its greedy
    hill-climb (ops/surface.refine_on_surface) on the same pack, the scores
    tempered (`temper` by temp and n_used): (poses, scores), the poses
    those given where steps <= 0."""
    packed = pack_neighborhoods(c_vol, wrap_theta)
    kw = dict(theta0=theta0, dtheta=dtheta, crop_iy0=crop_iy0,
              crop_ix0=crop_ix0, resolution=resolution, origin=origin,
              wrap_theta=wrap_theta, packed=packed)
    scores = sample_surface(c_vol, poses, **kw)
    if steps > 0:
        poses, scores = refine_on_surface(c_vol, poses, scores, steps=steps,
                                          **kw)
    return poses, temper(scores, temp, n_used)


def _one(fn, name, v, dtype, dev):
    """A 0-dim or one-element `dtype` tensor on the card, as one element."""
    if not (torch.is_tensor(v) and v.device == dev and v.dtype == dtype
            and v.numel() == 1):
        raise ValueError(f"{fn}: {name} must be one {dtype} on {dev}, got "
                         f"{v!r}")
    return v.reshape(1)


def score_cuda(c_vol, poses, *, steps: int = 0, theta0, dtheta, crop_iy0,
               crop_ix0, resolution: float, origin, wrap_theta: bool = False,
               temp: float = 1.0, n_used=None):
    """The kernel: score_plain's (poses, scores) in one launch, a thread a
    pose, its pose and score in registers for all the climb's steps, the
    score tempered as it is written; the volume (nt, hc, wc) float32 on
    the card read in place (a view whose cells are contiguous in a row, as
    the FFT's crop); theta0 and n_used float32 and crop_iy0, crop_ix0
    int64 tensors of one element on the card (n_used only where temp <=
    0)."""
    global sample_launches
    fn = "score_cuda"
    if c_vol.dim() != 3 or poses.dim() == 0 or poses.shape[-1] != 3:
        raise ValueError(f"{fn}: need a volume (nt, hc, wc) and poses "
                         f"(..., 3), got {tuple(c_vol.shape)} and "
                         f"{tuple(poses.shape)}")
    dev = c_vol.device
    nt, hc, wc = c_vol.shape
    if c_vol.stride(-1) != 1:
        c_vol = c_vol.contiguous()
    if c_vol.device.type != "cuda" or c_vol.dtype != torch.float32:
        raise ValueError(f"{fn}: c_vol must be float32 on the card, got "
                         f"{c_vol.dtype} on {c_vol.device}")
    steps = max(int(steps), 0)
    lead = tuple(poses.shape[:-1])
    n = math.prod(lead)
    flat = poses.reshape(n, 3).contiguous()
    check_tensor(fn, "poses", flat, (n, 3), dev)
    t0 = _one(fn, "theta0", theta0, torch.float32, dev)
    iy0 = _one(fn, "crop_iy0", crop_iy0, torch.int64, dev)
    ix0 = _one(fn, "crop_ix0", crop_ix0, torch.int64, dev)
    mode = 0 if temp == 1.0 else (1 if temp > 0.0 else 2)
    used = _one(fn, "n_used", n_used, torch.float32, dev) if mode == 2 \
        else None
    poses_out = torch.empty_like(flat) if steps else None
    scores = torch.empty((n,), dtype=torch.float32, device=dev)
    code = _build.library().gs_fusion_sample(
        c_vol.data_ptr(), flat.data_ptr(), t0.data_ptr(), iy0.data_ptr(),
        ix0.data_ptr(), _ptr(used), _ptr(poses_out), scores.data_ptr(), n,
        nt, hc, wc, c_vol.stride(0), c_vol.stride(1), int(bool(wrap_theta)),
        steps, _f32(origin[0]), _f32(origin[1]), _inv(resolution),
        _inv(dtheta), _f32(resolution), _f32(dtheta), mode,
        _f32(temp) if mode == 1 else 0.0, stream_handle(dev))
    sample_launches += 1
    _build.check("gs_fusion_sample", code)
    if not steps:
        return poses, scores.reshape(lead)
    return poses_out.reshape(poses.shape), scores.reshape(lead)


def score_on_volume(c_vol, poses, *, steps: int = 0, **kw):
    """(poses, scores): the trilinear sample of the volume at poses (...,
    3), then `steps` steps of the greedy hill-climb on it, the scores
    tempered (`kw`: ops/surface.sample_surface's keyword arguments, and
    `temper`'s temp and n_used): F4 on the card, one launch reading the
    volume in place, its plain version on the CPU."""
    fn = score_cuda if c_vol.is_cuda else score_plain
    return fn(c_vol, poses, steps=steps, **kw)


# ----------------------------------------------------------------- F5: splat
def splat_plain(px, py, wgt, thetas, k_cells: int, resolution: float):
    """Plain version of F5: ops/surface.splat_factors, (A_y diag(w), A_x),
    each (nt, B, K)."""
    return splat_factors(px, py, wgt, thetas, k_cells, resolution)


def splat_cuda(px, py, wgt, thetas, k_cells: int, resolution: float):
    """The kernel: splat_plain's two (nt, B, 2 k_cells + 1) factors in one
    launch, a warp a (bin, beam) row.  px, py, wgt (B,) and thetas (nt,)
    float32 on the card."""
    global splat_launches
    fn = "splat_cuda"
    dev = px.device
    b, nt = px.shape[0], thetas.shape[0]
    for name, t, shape in (("px", px, (b,)), ("py", py, (b,)),
                           ("wgt", wgt, (b,)), ("thetas", thetas, (nt,))):
        check_tensor(fn, name, t, shape, dev)
    k = 2 * k_cells + 1
    a_yw = torch.empty((nt, b, k), dtype=torch.float32, device=dev)
    a_x = torch.empty_like(a_yw)
    code = _build.library().gs_fusion_splat(
        px.data_ptr(), py.data_ptr(), wgt.data_ptr(), thetas.data_ptr(),
        a_yw.data_ptr(), a_x.data_ptr(), nt, b, k_cells, _inv(resolution),
        stream_handle(dev))
    splat_launches += 1
    _build.check("gs_fusion_splat", code)
    return a_yw, a_x


def endpoint_factors(px, py, wgt, thetas, k_cells: int, resolution: float):
    """The endpoint images' factors (ops/surface.splat_factors): F5 on the
    card, its plain version on the CPU; ops/surface.endpoint_images makes
    the images of them."""
    fn = splat_cuda if px.is_cuda else splat_plain
    return fn(px, py, wgt, thetas, k_cells, resolution)


# ------------------------------------------------------------------ F6: scan
class ScanPrep(NamedTuple):
    """What a step needs of its scan, computed once a scan (F6's one launch
    on the card), for a scan (B,) or a batch (G, B): `scan` the deskewed
    scan (the given one without odometry); `tables` the bin tables (dist,
    alpha, code) (..., n_bins), or three None; the endpoints px, py
    (ops/geometry.scan_points) and the used beams `use` = valid & hit with
    `wgt` its float32, each (..., B); every `stride`-th beam of them,
    px_c, py_c, use_c (the matcher's coarse stage; px, py and use
    themselves at stride 1); n_used (...), the used beams clamped to at
    least 1; keep, the map update's gate |d_theta| <= keep_below as a
    float32 (0 with freeze), of the odometry's shape, or None without
    odometry."""

    scan: Scan
    tables: tuple
    px: torch.Tensor
    py: torch.Tensor
    use: torch.Tensor
    wgt: torch.Tensor
    px_c: torch.Tensor
    py_c: torch.Tensor
    use_c: torch.Tensor
    n_used: torch.Tensor
    keep: Optional[torch.Tensor]
    stride: int


def scan_plain(angle, dist, hit, valid, d_center, d_theta, *,
               n_bins: int = 0, points: bool = False, stride: int = 1,
               keep_below=None, freeze: bool = False):
    """Plain version of F6: (angle, dist) of ops/geometry.deskew_scan where
    the odometry (d_center, d_theta) is given (else None, None), the
    (dist, alpha, code) tables of ops/cuda/grid_update.scan_bin_tables of
    that scan where n_bins > 0 (else three None), then where `points`
    ScanPrep's px, py, use, wgt, their every stride-th beam (three None at
    stride 1) and n_used (else seven None), and the gate keep where
    keep_below is given (else None)."""
    scan = Scan(angle=angle, dist=dist, hit=hit, valid=valid)
    out = (None, None)
    if d_center is not None:
        scan = deskew_scan(scan, Odom(d_center, d_theta))
        out = (scan.angle, scan.dist)
    tables = (scan_bin_tables(scan, n_bins) if n_bins > 0
              else (None, None, None))
    pts = (None,) * 8
    if points:
        px, py = scan_points(scan)
        use = valid & hit
        wgt = use.to(torch.float32)
        strided = ((None,) * 3 if stride == 1 else
                   tuple(t[..., ::stride].contiguous() for t in (px, py, use)))
        pts = (px, py, use, wgt, *strided,
               torch.clamp(wgt.sum(-1), min=1.0))
    keep = None
    if keep_below is not None:
        keep = (torch.abs(d_theta) <= keep_below).to(torch.float32)
        if freeze:
            keep = keep * 0.0
    return (*out, *tables, *pts, keep)


def scan_cuda(angle, dist, hit, valid, d_center, d_theta, *,
              n_bins: int = 0, points: bool = False, stride: int = 1,
              keep_below=None, freeze: bool = False):
    """The kernel: scan_plain's outputs in one launch, a block a scan.
    angle, dist (B,) or (G, B) float32 and hit, valid bool on the card;
    d_center, d_theta 0-dim or (G,), or None for no deskew (and no
    keep); keep only with the points."""
    global scan_launches
    fn = "scan_cuda"
    dev = angle.device
    shape = tuple(angle.shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"{fn}: need a scan (B,) or (G, B), got {shape}")
    g, b = (1, shape[0]) if len(shape) == 1 else shape
    flat = {}
    for name, t, dtype in (("angle", angle, torch.float32),
                           ("dist", dist, torch.float32),
                           ("hit", hit, torch.bool),
                           ("valid", valid, torch.bool)):
        flat[name] = t.reshape(g, b).contiguous()
        check_tensor(fn, name, flat[name], (g, b), dev, dtype=dtype)
    if stride < 1 or (keep_below is not None
                      and (d_center is None or not points)):
        raise ValueError(f"{fn}: need a stride of 1 or more, and the "
                         f"odometry and the points for the gate keep")

    def empty(*size, dtype=torch.float32):
        return torch.empty(size, dtype=dtype, device=dev)

    odo = (None, None)
    outs = (None, None)
    if d_center is not None:
        odo = tuple(d.reshape(-1).contiguous() for d in (d_center, d_theta))
        for name, d in zip(("d_center", "d_theta"), odo):
            check_tensor(fn, name, d, (g,), dev)
        outs = (empty(g, b), empty(g, b))
    tables = (None, None, None)
    if n_bins > 0:
        tables = tuple(empty(g, n_bins) for _ in range(3))
    pts = (None,) * 8
    b_c = -(-b // stride)
    if points:
        strided = ((None,) * 3 if stride == 1 else
                   (empty(g, b_c), empty(g, b_c),
                    empty(g, b_c, dtype=torch.bool)))
        pts = (empty(g, b), empty(g, b), empty(g, b, dtype=torch.bool),
               empty(g, b), *strided, empty(g))
    keep = empty(g) if keep_below is not None else None
    code = _build.library().gs_fusion_scan(
        flat["angle"].data_ptr(), flat["dist"].data_ptr(),
        flat["hit"].data_ptr(), flat["valid"].data_ptr(),
        *(_ptr(t) for t in (*odo, *outs, *tables)),
        *(_ptr(t) for t in (*pts, keep)), g, b, max(n_bins, 0),
        _f32(2.0 * math.pi / n_bins) if n_bins > 0 else 0.0, stride,
        _f32(keep_below) if keep_below is not None else 0.0, int(freeze),
        stream_handle(dev))
    scan_launches += 1
    _build.check("gs_fusion_scan", code)
    lead = shape[:-1]
    strided = pts[4:7]
    return (*(None if t is None else t.reshape(shape) for t in outs),
            *(None if t is None else t.reshape(*lead, n_bins)
              for t in tables),
            *(None if t is None else t.reshape(shape) for t in pts[:4]),
            *(None if t is None else t.reshape(*lead, b_c) for t in strided),
            None if pts[7] is None else pts[7].reshape(lead),
            None if keep is None else keep.reshape(d_theta.shape))


def _scan_fn(angle):
    return scan_cuda if angle.is_cuda else scan_plain


def prepare_scan(scan: Scan, odom: Optional[Odom] = None, n_bins: int = 0,
                 *, stride: int = 1, keep_below=None,
                 freeze: bool = False) -> ScanPrep:
    """A step's ScanPrep of a scan (B,) or a batch (G, B) (with odometry
    of shape (G,)): deskew_scan(scan, odom) where odom is given, the bin
    tables of that scan where n_bins > 0, its endpoints, used beams, every
    stride-th of them and their count, and where keep_below is given the
    map update's gate: F6 on the card in one launch, its plain version on
    the CPU."""
    dc, dt = (None, None) if odom is None else (odom.d_center, odom.d_theta)
    a, d, *rest = _scan_fn(scan.angle)(
        scan.angle, scan.dist, scan.hit, scan.valid, dc, dt, n_bins=n_bins,
        points=True, stride=stride, keep_below=keep_below, freeze=freeze)
    tables, (px, py, use, wgt, px_c, py_c, use_c, n_used), keep = (
        tuple(rest[:3]), rest[3:11], rest[11])
    if stride == 1:
        px_c, py_c, use_c = px, py, use
    deskewed = scan if a is None else Scan(angle=a, dist=d, hit=scan.hit,
                                           valid=scan.valid)
    return ScanPrep(deskewed, tables, px, py, use, wgt, px_c, py_c, use_c,
                    n_used, keep, stride)


def bin_tables(scan: Scan, n_bins: int):
    """ops/cuda/grid_update.scan_bin_tables(scan, n_bins): F6 on the card,
    its plain version on the CPU."""
    return _scan_fn(scan.angle)(scan.angle, scan.dist, scan.hit, scan.valid,
                                None, None, n_bins=n_bins)[2:5]


def deskew(scan: Scan, odom: Odom) -> Scan:
    """ops/geometry.deskew_scan(scan, odom): F6 on the card, its plain
    version on the CPU."""
    a, d = _scan_fn(scan.angle)(scan.angle, scan.dist, scan.hit, scan.valid,
                                odom.d_center, odom.d_theta)[:2]
    return Scan(angle=a, dist=d, hit=scan.hit, valid=scan.valid)


# --------------------------------------------------------------- F7: weights
# the recovery injection's constants (models/shared.py): p_inject's ceiling
# and the p_inject above which it forces the resample
P_INJECT_MAX, P_INJECT_FORCE = 0.3, 0.05


class WindowSpec(NamedTuple):
    """A window F7 places on the map for one robot: a crop of `crop` (hc,
    wc) cells of the `full` (h, w) map (its `resolution`, `origin`),
    centered as ops/surface.crop_center_cells centers it.  `volume`: the
    surface volume's, around the weighted mean pose propagated by the
    odometry, with the extended window (`ext`, the crop plus the blur
    `radius`, clamped to the map) and the `nt` theta bins center + t_off +
    t dtheta (ops/surface.theta_grid); else the map update's, around the
    integration pose (the epilogue's)."""

    crop: Tuple[int, int]
    full: Tuple[int, int]
    resolution: float
    origin: Tuple[float, float]
    volume: bool = False
    radius: int = 0
    ext: Tuple[int, int] = (0, 0)
    nt: int = 0
    t_off: float = 0.0
    dtheta: float = 0.0


class Window(NamedTuple):
    """The surface volume's window (WindowSpec with `volume`): the crop's
    corner (iy0, ix0), the extended window's (ey0, ex0) and the crop's
    offset in it (oy, ox), each a 0-dim int64; the center (3,), the first
    bin's heading theta0 (0-dim) and the bins' `thetas` (nt,)."""

    iy0: torch.Tensor
    ix0: torch.Tensor
    ey0: torch.Tensor
    ex0: torch.Tensor
    oy: torch.Tensor
    ox: torch.Tensor
    center: torch.Tensor
    theta0: torch.Tensor
    thetas: torch.Tensor


def volume_window(center, spec: WindowSpec) -> Window:
    """The surface volume's window around `center` (3,) in tensor ops (the
    plain version of F7's, and the mesh engines' window)."""
    h, w = spec.full
    iy0, ix0 = crop_center_cells(center[:2], spec.crop, spec.full,
                                 spec.resolution, spec.origin)
    ey0 = torch.clamp(iy0 - spec.radius, 0, h - spec.ext[0])
    ex0 = torch.clamp(ix0 - spec.radius, 0, w - spec.ext[1])
    theta0 = center[2] + spec.t_off
    thetas = theta0 + spec.dtheta * torch.arange(
        spec.nt, dtype=torch.float32, device=center.device)
    return Window(iy0, ix0, ey0, ex0, iy0 - ey0, ix0 - ex0, center, theta0,
                  thetas)


def window_plain(weighted, odom: Odom, spec: WindowSpec) -> Window:
    """Plain version of F7's volume window: apply_odometry of the weighted
    mean pose (3,), then volume_window."""
    return volume_window(apply_odometry_plain(weighted, odom), spec)


class Tail(NamedTuple):
    """F7's outputs, each with the log-weights' leading shape (() or (R,)):
    the max, the total sum(exp(lw - max)), the first argmax (int64) and its
    pose (..., 3), Neff and the weighted mean pose (..., 3); with the
    epilogue the resample gate (bool), and for one robot the integration
    pose (3,) and, with the recovery EMAs, their new (2,) and p_inject; for
    one robot with a WindowSpec, the surface volume's Window (`volume`) or
    the map update's crop corner (2,) int64 (`crop`)."""

    max: torch.Tensor
    total: torch.Tensor
    best_index: torch.Tensor
    best_pose: torch.Tensor
    neff: torch.Tensor
    weighted: torch.Tensor
    gate: Optional[torch.Tensor] = None
    integ_pose: Optional[torch.Tensor] = None
    recov: Optional[torch.Tensor] = None
    p_inject: Optional[torch.Tensor] = None
    volume: Optional[Window] = None
    crop: Optional[torch.Tensor] = None


def _weights_row(lw, poses):
    """One robot's F7 outputs in ops/resample's op sequence."""
    m, e, s = exp_weights(lw)
    w = e / s
    best = torch.argmax(lw)
    return (m, s, best, poses[best[None]][0], neff_of(w),
            mean_pose_of(poses, w))


def weights_plain(log_weights, poses, *, resample_fraction=None, recov=None,
                  step=None, reinject=(0.0, 0.0), window=None, odom=None):
    """Plain version of F7 on log-weights (P,) or (R, P) and poses (..., P,
    3), a robot at a time: ops/resample's exp_weights, neff and
    weighted_mean_pose, torch.argmax and the pose there.  Where
    resample_fraction is given, the epilogue: the gate Neff < P
    resample_fraction, for one robot the integration pose
    (ops/resample.integration_pose) and, where the recovery EMAs `recov`
    (2,) are given with the scan counter `step`, recovery_ema of the max
    with reinject = (a_slow, a_fast), the gate forced where p_inject >
    0.05.  With a WindowSpec `window` (one robot): the volume's Window
    (window_plain, odom the odometry) or the map update's crop corner
    (crop_center_cells of the integration pose, stacked).  Returns a
    Tail."""
    if log_weights.dim() == 1:
        out = Tail(*_weights_row(log_weights, poses))
    else:
        out = Tail(*(torch.stack(c) for c in zip(
            *(_weights_row(lw, q) for lw, q in zip(log_weights, poses)))))
    if window is not None and window.volume:
        out = out._replace(volume=window_plain(out.weighted, odom, window))
    if resample_fraction is None:
        return out
    p = log_weights.shape[-1]
    gate = out.neff < (p * resample_fraction)
    integ = rec = p_inject = None
    if log_weights.dim() == 1:
        integ = integration_pose(out.neff, p, out.weighted, out.best_pose)
    if recov is not None:
        rec, p_inject = recovery_ema(recov, step, out.max, *reinject)
        gate = gate | (p_inject > P_INJECT_FORCE)
    crop = None
    if window is not None and not window.volume:
        crop = torch.stack(crop_center_cells(
            integ[:2], window.crop, window.full, window.resolution,
            window.origin))
    return out._replace(gate=gate, integ_pose=integ, recov=rec,
                        p_inject=p_inject, crop=crop)


class WeightsPlan(NamedTuple):
    """F7's launches for a call (csrc/fusions.cu gs_fusion_weights: one
    where a robot's weights are one row of ROW, else three) and the scratch
    they share: floats (each row's argmax value, sum and four moments) and
    int32s (each row's argmax index, two tickets a robot)."""

    launches: int
    scratch_floats: int
    scratch_ints: int


def weights_plan(r: int, p: int) -> WeightsPlan:
    """F7's launches for R robots of P weights each (1 <= P <= ROW^2)."""
    if not (0 < p <= ROW * ROW and 0 < r <= 65535):
        raise ValueError(f"weights_plan: 1 to {ROW * ROW} weights and 1 to "
                         f"65535 robots, got {r} x {p}")
    nb = -(-p // ROW)
    return WeightsPlan(1 if nb == 1 else 3, 6 * r * nb, r * nb + 2 * r)


class _WindowArgs:
    """A WindowSpec as gs_fusion_weights takes it: the mode (0 none, 1 the
    volume's, 2 the map update's), its ints and floats, and the odometry
    and the tensors F7 writes the window into (`args`), then the Window
    or the crop corner (`volume()`, `crop()`)."""

    def __init__(self, fn: str, window, odom, dev):
        self.mode = 0 if window is None else (1 if window.volume else 2)
        ints = (ctypes.c_int * 8)()
        floats = (ctypes.c_float * 5)()
        dc = dt = self.center = self.thetas = self.cells = None
        if self.mode:
            ints[:] = [*window.crop, *window.full, window.radius,
                       *window.ext, window.nt]
            floats[:] = [_f32(window.origin[0]), _f32(window.origin[1]),
                         _inv(window.resolution), _f32(window.t_off),
                         _f32(window.dtheta)]
            self.cells = torch.empty(6 if self.mode == 1 else 2,
                                     dtype=torch.int64, device=dev)
        if self.mode == 1:
            dc, dt = (_one(fn, name, v, torch.float32, dev) for name, v in
                      (("d_center", odom.d_center),
                       ("d_theta", odom.d_theta)))
            self.center = torch.empty(3, device=dev)
            self.thetas = torch.empty(1 + window.nt, device=dev)
        self.args = (self.mode, ints, floats,
                     *(_ptr(t) for t in (dc, dt, self.center, self.thetas,
                                         self.cells)))

    def volume(self) -> Optional[Window]:
        if self.mode != 1:
            return None
        return Window(*self.cells, self.center, self.thetas[0],
                      self.thetas[1:])

    def crop(self) -> Optional[torch.Tensor]:
        return self.cells if self.mode == 2 else None


def weights_cuda(log_weights, poses, *, resample_fraction=None, recov=None,
                 step=None, reinject=(0.0, 0.0), window=None, odom=None):
    """The kernel: weights_plain's Tail, the sums in ops/resample's fixed
    order (csrc/fusions.cu: a thread a segment of 8 weights, a block a row
    of 1024), as weights_plan lays it out: one launch where P <= 1024, else
    three, the rows' partials of each pass summed once, by its last
    block.  log_weights (P,) or (R, P) and poses (..., P, 3) float32 on the
    card, P at most 1024 * 1024; recov (2,) float32 and step int32 on the
    card with one robot only; the window with one robot only (the volume's
    with odom's d_center and d_theta one float32 each on the card, the
    map update's with the epilogue), placed by the thread that writes the
    outputs."""
    global weights_launches
    fn = "weights_cuda"
    dev = log_weights.device
    if log_weights.dim() not in (1, 2):
        raise ValueError(f"{fn}: need log-weights (P,) or (R, P), got "
                         f"{tuple(log_weights.shape)}")
    lead = tuple(log_weights.shape[:-1])
    r, p = math.prod(lead), log_weights.shape[-1]
    lw = log_weights.reshape(r, p).contiguous()
    ps = poses.reshape(r, p, 3).contiguous()
    check_tensor(fn, "log_weights", lw, (r, p), dev)
    check_tensor(fn, "poses", ps, (r, p, 3), dev)
    if not 0 < p <= ROW * ROW:
        raise ValueError(f"{fn}: 1 to {ROW * ROW} weights a robot, got {p}")
    finish = resample_fraction is not None
    if recov is not None:
        if lead or not finish:
            raise ValueError(f"{fn}: the recovery EMAs need one robot and "
                             f"the epilogue (resample_fraction)")
        check_tensor(fn, "recov", recov, (2,), dev)
        step = _one(fn, "step", step, torch.int32, dev)
    mode = 0 if window is None else (1 if window.volume else 2)
    if mode and (lead or (mode == 2 and not finish)):
        raise ValueError(f"{fn}: a window needs one robot, the map "
                         f"update's the epilogue (resample_fraction)")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Tail(max=empty(r), total=empty(r),
               best_index=empty(r, dtype=torch.int64), best_pose=empty(r, 3),
               neff=empty(r), weighted=empty(r, 3),
               gate=empty(r, dtype=torch.bool) if finish else None,
               integ_pose=empty(3) if finish and not lead else None,
               recov=empty(2) if recov is not None else None,
               p_inject=empty(1) if recov is not None else None)
    plan = weights_plan(r, p)
    scratch_f = empty(plan.scratch_floats)
    scratch_i = empty(plan.scratch_ints, dtype=torch.int32)
    thr = ((_f32(0.95 * p), _f32(p * resample_fraction)) if finish
           else (0.0, 0.0))
    win = _WindowArgs(fn, window, odom, dev)
    launched = (ctypes.c_int * 1)()
    code = _build.library().gs_fusion_weights(
        lw.data_ptr(), ps.data_ptr(), _ptr(recov), _ptr(step),
        *(_ptr(t) for t in (out.max, out.total, out.best_index,
                            out.best_pose, out.neff, out.weighted, out.gate,
                            out.integ_pose, out.recov, out.p_inject)),
        scratch_f.data_ptr(), scratch_i.data_ptr(), r, p, *thr,
        _f32(reinject[0]), _f32(reinject[1]), _f32(P_INJECT_FORCE),
        _f32(P_INJECT_MAX), *win.args, stream_handle(dev), launched)
    weights_launches += launched[0]
    _build.check("gs_fusion_weights", code)
    return out._replace(**{
        k: v.reshape(lead + tuple(v.shape[1:])) for k, v in zip(
            Tail._fields[:7], out[:7]) if v is not None},
        p_inject=None if out.p_inject is None else out.p_inject[0],
        volume=win.volume(), crop=win.crop())


def weights(log_weights, poses, **kw):
    """The weights' tail (see weights_plain): F7 on the card, its plain
    version on the CPU."""
    fn = weights_cuda if log_weights.is_cuda else weights_plain
    return fn(log_weights, poses, **kw)


def weight_exp_cuda(x, rsqrt: bool = False):
    """F7's exp (csrc/fusions.cu weight_exp), or with `rsqrt` F4's rsqrtf,
    of float32 x on the card, for the probes that hold them to torch.exp
    and torch.rsqrt; no path calls it."""
    x = x.contiguous()
    check_tensor("weight_exp_cuda", "x", x, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    _build.check("gs_fusion_exp", _build.library().gs_fusion_exp(
        x.data_ptr(), out.data_ptr(), x.numel(), int(rsqrt),
        stream_handle(x.device)))
    return out


# ------------------------------------------------- F7's mesh form, the ranks
class Collectives(NamedTuple):
    """The collectives F7's mesh form calls between its passes, over the
    ranks of one mesh axis, each a callable of one tensor that returns a
    new tensor (parallel/shmap builds them from parallel/mesh's): `pmax`
    and `psum` the elementwise maximum and sum over the ranks, `all_gather`
    every rank's tensor stacked (n, ...) in rank order.  This module calls
    no collective of its own."""

    pmax: Callable
    psum: Callable
    all_gather: Callable


def _check_mesh(fn, center, resample_fraction, recov, window):
    if center and (resample_fraction is not None or recov is not None
                   or (window is not None and not window.volume)):
        raise ValueError(f"{fn}: the center call places the volume's "
                         f"window alone")
    if not center and window is not None and (
            window.volume or resample_fraction is None):
        raise ValueError(f"{fn}: the tail places the map update's window, "
                         f"with the epilogue (resample_fraction)")
    if recov is not None and resample_fraction is None:
        raise ValueError(f"{fn}: the recovery EMAs need the epilogue "
                         f"(resample_fraction)")


def weights_mesh_plain(log_weights, poses, comm: Collectives, *,
                       center=False, resample_fraction=None, recov=None,
                       step=None, reinject=(0.0, 0.0), window=None,
                       odom=None):
    """Plain version of F7's mesh form: the weights' tail of every rank's
    particles, this rank holding log_weights (p,) and poses (p, 3) of them
    and the ranks joined by `comm` (Collectives), in ops/resample's op
    sequence with the collectives between: the max's pmax, then exp(lw -
    max) and the total's psum, then w = exp / total and the psum of Neff's
    sum of squares and the weighted pose's three sums, and the all_gather
    of each rank's (max log-weight, its pose, its index) (the JAX engines'
    shard_fn, gridmap_slam_tpu/parallel/shmap.py:136-157).  Returns a Tail
    (weights_plain's fields): best_index the global index of the strongest
    particle, the first argmax over the ranks' rows (rank g's local index
    i: g p + i), and with resample_fraction the epilogue over the global P
    = n p, and a map update's WindowSpec's crop.

    center=True: the surface volume's center call (:94-103): the psum of
    the weighted pose's three sums alone, no candidate; Tail's max, total
    and weighted mean pose, and with a volume WindowSpec `window` its
    Window around the mean propagated by `odom` (window_plain)."""
    _check_mesh("weights_mesh_plain", center, resample_fraction, recov,
                window)
    lw = log_weights
    m = comm.pmax(max_fixed_order(lw))
    e = torch.exp(lw - m)
    total = comm.psum(sum_fixed_order(e))
    w = e / total
    if center:
        mean = comm.psum(sums_fixed_order(poses[:, 0] * w, poses[:, 1] * w,
                                          wrap_angle(poses[:, 2]) * w))
        return Tail(m, total, None, None, None, mean,
                    volume=None if window is None
                    else window_plain(mean, odom, window))
    sums = comm.psum(sums_fixed_order(w * w, poses[:, 0] * w,
                                      poses[:, 1] * w,
                                      wrap_angle(poses[:, 2]) * w))
    n_eff, weighted = 1.0 / sums[0], sums[1:]
    li = torch.argmax(lw)
    every = comm.all_gather(torch.cat([lw[li[None]], poses[li[None]][0],
                                       li[None].to(lw.dtype)]))
    g = torch.argmax(every[:, 0])
    row = every[g[None]][0]
    p_loc = lw.shape[0]
    out = Tail(m, total, g * p_loc + row[4].to(torch.int64), row[1:4],
               n_eff, weighted)
    if resample_fraction is None:
        return out
    p = every.shape[0] * p_loc
    gate = n_eff < (p * resample_fraction)
    integ = integration_pose(n_eff, p, weighted, out.best_pose)
    rec = p_inject = None
    if recov is not None:
        rec, p_inject = recovery_ema(recov, step, m, *reinject)
        gate = gate | (p_inject > P_INJECT_FORCE)
    crop = None
    if window is not None:
        crop = torch.stack(crop_center_cells(
            integ[:2], window.crop, window.full, window.resolution,
            window.origin))
    return out._replace(gate=gate, integ_pose=integ, recov=rec,
                        p_inject=p_inject, crop=crop)


def weights_mesh_cuda(log_weights, poses, comm: Collectives, *,
                      center=False, resample_fraction=None, recov=None,
                      step=None, reinject=(0.0, 0.0), window=None,
                      odom=None):
    """The kernel: weights_mesh_plain's Tail, the collectives called
    between F7's mesh passes (csrc/fusions.cu: A the first argmax and the
    candidate, B the sum of exp at the ranks' max, C the four moments at
    the ranks' total, each summing its rows once by its last block; then
    the epilogue of one thread on the reduced values and the gathered
    candidates, which places the window), four launches a call (three for
    a center call without a window).  log_weights (p,), poses (p, 3)
    float32 on the card, p at most 1024 * 1024; recov, step and the window
    as in weights_cuda."""
    fn = "weights_mesh_cuda"
    dev = log_weights.device
    p = log_weights.shape[0] if log_weights.dim() == 1 else -1
    check_tensor(fn, "log_weights", log_weights, (p,), dev)
    check_tensor(fn, "poses", poses, (p, 3), dev)
    if not 0 < p <= ROW * ROW:
        raise ValueError(f"{fn}: 1 to {ROW * ROW} weights, got {p}")
    _check_mesh(fn, center, resample_fraction, recov, window)
    finish = resample_fraction is not None
    if recov is not None:
        check_tensor(fn, "recov", recov, (2,), dev)
        step = _one(fn, "step", step, torch.int32, dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    nb = -(-p // ROW)
    scratch_f = empty(6 * nb + 10)
    scratch_i = empty(nb + 3, dtype=torch.int32)
    cand, part = scratch_f[6 * nb:6 * nb + 5], scratch_f[6 * nb + 5:]
    lib = _build.library()

    def launch(mesh_pass, out=None, m=None, total=None, sums=None,
               cands=None, outs=(None,) * 7, thr=(0.0, 0.0), win=None):
        global weights_mesh_launches
        epilogue = mesh_pass == 4
        launched = (ctypes.c_int * 1)()
        code = lib.gs_fusion_weights_mesh(
            mesh_pass, log_weights.data_ptr(), poses.data_ptr(), _ptr(m),
            _ptr(total), _ptr(sums), _ptr(cands),
            0 if cands is None else cands.shape[0], _ptr(out),
            scratch_f.data_ptr(), scratch_i.data_ptr(), p,
            _ptr(recov) if epilogue else None,
            _ptr(step) if epilogue and recov is not None else None,
            *(_ptr(t) for t in outs), *thr, _f32(reinject[0]),
            _f32(reinject[1]), _f32(P_INJECT_FORCE), _f32(P_INJECT_MAX),
            *(win.args if win is not None else (0, None, None) + (None,) * 5),
            stream_handle(dev), launched)
        weights_mesh_launches += launched[0]
        _build.check("gs_fusion_weights_mesh", code)

    launch(1, out=cand)
    m = comm.pmax(cand[0])
    launch(2, out=part[:1], m=m)
    total = comm.psum(part[0])
    launch(3, out=part[1:], m=m, total=total)
    if center:
        mean = comm.psum(part[2:])
        win = _WindowArgs(fn, window, odom, dev)
        if window is not None:
            launch(4, m=m, sums=mean, win=win)
        return Tail(m, total, None, None, None, mean, volume=win.volume())
    sums = comm.psum(part[1:])
    every = comm.all_gather(cand)
    n_all = every.shape[0] * p
    thr = ((_f32(0.95 * n_all), _f32(n_all * resample_fraction)) if finish
           else (0.0, 0.0))
    out = Tail(max=m, total=total, best_index=empty(1, dtype=torch.int64),
               best_pose=empty(3), neff=empty(1), weighted=sums[1:],
               gate=empty(1, dtype=torch.bool) if finish else None,
               integ_pose=empty(3) if finish else None,
               recov=empty(2) if recov is not None else None,
               p_inject=empty(1) if recov is not None else None)
    win = _WindowArgs(fn, window, odom, dev)
    launch(4, m=m, sums=sums, cands=every,
           outs=(out.best_index, out.best_pose, out.neff, out.gate,
                 out.integ_pose, out.recov, out.p_inject),
           thr=thr, win=win)
    return out._replace(
        best_index=out.best_index[0], neff=out.neff[0],
        gate=None if out.gate is None else out.gate[0],
        p_inject=None if out.p_inject is None else out.p_inject[0],
        crop=win.crop())


def weights_mesh(log_weights, poses, comm: Collectives, **kw):
    """F7's mesh form (see weights_mesh_plain): the kernels on the card,
    the plain version on the CPU."""
    fn = weights_mesh_cuda if log_weights.is_cuda else weights_mesh_plain
    return fn(log_weights, poses, comm, **kw)


# ------------------------------------------------------------------ F8: walk
def walk_plain(log_weights, u0, poses, m, total, *, gather_weights=True,
               out=None, draw=systematic_indices):
    """Plain version of F8 on one robot's log-weights (P,), the start u0
    and poses (P, 3): the ancestors `draw(log_weights, u0)`
    (ops/resample.systematic_indices), then the poses (and where
    gather_weights the log-weights) at those ancestors, each written into
    its tensor of `out` = (indices, poses, log-weights) where given.  m,
    total: F7's max and total of these weights, which the kernel takes in
    place of recomputing them; this version recomputes them (the same
    bits).  Returns (indices int64, poses, log-weights or None)."""
    del m, total
    o = (None, None, None) if out is None else out
    idx = draw(log_weights, u0)
    if o[0] is not None:
        idx = o[0].copy_(idx)
    got = torch.index_select(poses, 0, idx, out=o[1])
    lw = (torch.index_select(log_weights, 0, idx, out=o[2])
          if gather_weights else None)
    return idx, got, lw


def walk_cuda(log_weights, u0, poses, m, total, *, gather_weights=True,
              out=None):
    """The kernel: walk_plain's outputs in two launches (the normalized
    weights' fixed-order scan, a block a row; then a thread a slot: its u,
    the binary search, the clamp and the gathers).  log_weights (P,), poses
    (P, 3) float32 on the card; u0, m, total one float32 each on the card
    (m and total F7's); `out` as in walk_plain, none of it an input."""
    global walk_launches
    fn = "walk_cuda"
    dev = log_weights.device
    p = log_weights.shape[0] if log_weights.dim() == 1 else -1
    check_tensor(fn, "log_weights", log_weights, (p,), dev)
    check_tensor(fn, "poses", poses, (p, 3), dev)
    if not 0 < p <= ROW * ROW:
        raise ValueError(f"{fn}: 1 to {ROW * ROW} weights, got {p}")
    u0, m, total = (_one(fn, name, v, torch.float32, dev) for name, v in
                    (("u0", u0), ("m", m), ("total", total)))
    o = (None, None, None) if out is None else out
    idx = o[0] if o[0] is not None else torch.empty(
        (p,), dtype=torch.int64, device=dev)
    got = o[1] if o[1] is not None else torch.empty_like(poses)
    lw = None
    if gather_weights:
        lw = o[2] if o[2] is not None else torch.empty_like(log_weights)
    check_tensor(fn, "indices", idx, (p,), dev, dtype=torch.int64)
    check_tensor(fn, "poses out", got, (p, 3), dev)
    if lw is not None:
        check_tensor(fn, "log-weights out", lw, (p,), dev)
    ins = {t.data_ptr() for t in (log_weights, poses, u0, m, total)}
    if any(t is not None and t.data_ptr() in ins for t in (idx, got, lw)):
        raise ValueError(f"{fn}: an output may not be an input")
    scratch = torch.empty((-(-p // ROW) * ROW,), dtype=torch.float32,
                          device=dev)
    launched = (ctypes.c_int * 1)()
    code = _build.library().gs_fusion_walk(
        log_weights.data_ptr(), poses.data_ptr(), u0.data_ptr(),
        m.data_ptr(), total.data_ptr(), idx.data_ptr(), got.data_ptr(),
        _ptr(lw), scratch.data_ptr(), p, _inv(p), stream_handle(dev),
        launched)
    walk_launches += launched[0]
    _build.check("gs_fusion_walk", code)
    return idx, got, lw


def _plain_draw(fn, draw, on_card):
    """The plain version's `draw` (systematic_indices where None); a draw
    given with tensors on the card is refused, since the kernel draws its
    own ancestors."""
    if on_card and draw is not None:
        raise ValueError(f"{fn}: draw= is the plain version's; the kernel "
                         f"draws the ancestors itself")
    return systematic_indices if draw is None else draw


def walk(log_weights, u0, poses, m, total, *, gather_weights=True,
         out=None, draw=None):
    """The systematic resample of one robot (see walk_plain), m and total
    its weights' Tail's: F8 on the card, its plain version (its ancestors
    by `draw`, systematic_indices where None) on the CPU; a `draw` with
    tensors on the card raises."""
    draw = _plain_draw("walk", draw, log_weights.is_cuda)
    if log_weights.is_cuda:
        return walk_cuda(log_weights, u0, poses, m, total,
                         gather_weights=gather_weights, out=out)
    return walk_plain(log_weights, u0, poses, m, total,
                      gather_weights=gather_weights, out=out, draw=draw)


def walk_mesh_plain(rows, u0, *, base: int, count: int, gather_weights=True,
                    out=None, draw=systematic_indices):
    """Plain version of F8's mesh form on the gathered rows (P, 4) of every
    rank's (log-weight, pose): the ancestors `draw(lw_all, u0)`
    (ops/resample.systematic_indices) of all P log-weights with the start
    u0, the slots [base, base + count) of it
    (this rank's), and the poses (and where gather_weights the
    log-weights) of the rows at those ancestors, each written into its
    tensor of `out` = (indices, poses, log-weights) where given (the JAX
    engines' resample body, gridmap_slam_tpu/parallel/shmap.py:178-207).
    Returns (indices (count,) int64, poses (count, 3), log-weights (count,)
    or None)."""
    o = (None, None, None) if out is None else out
    lw_all, poses_all = rows[:, 0], rows[:, 1:]
    idx = draw(lw_all, u0)[base:base + count]
    if o[0] is not None:
        idx = o[0].copy_(idx)
    got = torch.index_select(poses_all, 0, idx, out=o[1])
    lw = (torch.index_select(lw_all, 0, idx, out=o[2])
          if gather_weights else None)
    return idx, got, lw


def walk_mesh_cuda(rows, u0, *, base: int, count: int, gather_weights=True,
                   out=None):
    """The kernel: walk_mesh_plain's outputs in four launches (F7's mesh
    passes A and B over all P log-weights of the rows: the fixed order's
    max and total; F8's scan over all P; its search of the slots [base,
    base + count) alone, with the gathers).  rows (P, 4) float32 on the
    card, P at most 1024 * 1024; u0 one float32 on the card; `out` as in
    walk_mesh_plain, none of it an input."""
    global walk_mesh_launches
    fn = "walk_mesh_cuda"
    dev = rows.device
    p = rows.shape[0] if rows.dim() == 2 else -1
    check_tensor(fn, "rows", rows, (p, 4), dev)
    if not 0 < p <= ROW * ROW:
        raise ValueError(f"{fn}: 1 to {ROW * ROW} rows, got {p}")
    if not (0 <= base and 0 < count and base + count <= p):
        raise ValueError(f"{fn}: slots [{base}, {base + count}) are not "
                         f"within the {p} rows")
    u0 = _one(fn, "u0", u0, torch.float32, dev)
    o = (None, None, None) if out is None else out
    idx = o[0] if o[0] is not None else torch.empty(
        (count,), dtype=torch.int64, device=dev)
    got = o[1] if o[1] is not None else torch.empty((count, 3), device=dev)
    lw = None
    if gather_weights:
        lw = o[2] if o[2] is not None else torch.empty((count,), device=dev)
    check_tensor(fn, "indices", idx, (count,), dev, dtype=torch.int64)
    check_tensor(fn, "poses out", got, (count, 3), dev)
    if lw is not None:
        check_tensor(fn, "log-weights out", lw, (count,), dev)
    ins = {t.data_ptr() for t in (rows, u0)}
    if any(t is not None and t.data_ptr() in ins for t in (idx, got, lw)):
        raise ValueError(f"{fn}: an output may not be an input")
    nb = -(-p // ROW)
    scratch = torch.empty((nb * ROW + 2 * nb + 2,), dtype=torch.float32,
                          device=dev)
    scratch_i = torch.empty((nb + 3,), dtype=torch.int32, device=dev)
    launched = (ctypes.c_int * 1)()
    code = _build.library().gs_fusion_walk_mesh(
        rows.data_ptr(), u0.data_ptr(), idx.data_ptr(), got.data_ptr(),
        _ptr(lw), scratch.data_ptr(), scratch_i.data_ptr(), p, base, count,
        _inv(p), stream_handle(dev), launched)
    walk_mesh_launches += launched[0]
    _build.check("gs_fusion_walk_mesh", code)
    return idx, got, lw


def walk_mesh(rows, u0, *, base: int, count: int, gather_weights=True,
              out=None, draw=None):
    """F8's mesh form, this rank's slots of the systematic resample of the
    gathered rows (see walk_mesh_plain): the kernels on the card, the plain
    version (its ancestors by `draw`, systematic_indices where None) on the
    CPU; a `draw` with rows on the card raises."""
    draw = _plain_draw("walk_mesh", draw, rows.is_cuda)
    if rows.is_cuda:
        return walk_mesh_cuda(rows, u0, base=base, count=count,
                              gather_weights=gather_weights, out=out)
    return walk_mesh_plain(rows, u0, base=base, count=count,
                           gather_weights=gather_weights, out=out, draw=draw)
