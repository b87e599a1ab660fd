"""Correlative scan matcher.

Counterpart of the gather path of gridmap_slam_tpu/ops/matcher.py
(reference slam/GridMap.java:319-369): a multi-stage dense correlative
search, a coarse grid over the whole window and then halving refinement
grids around the running argmax, scored with bilinear lookups of a
precomputed log-likelihood field.  Out-of-map and unknown cells score the
uniform likelihood 1/max_range (see the JAX module's docstring for the two
documented divergences from the reference).

`correlative_match_batch` searches for all particles at once, with the
schedule of the JAX package's `correlative_match`, on grouped fields and
scans (one map a particle, one shared map, one a closure candidate; one
scan, or one a robot); its stages are scored by
`ops.cuda.matcher.stage_scores_batch` (kernel K1 on the card).
Each stage's prior, argmax and pick (`_prior_grid`, `_argmax3`, `_take`)
and the coarse stage's pool are `ops.cuda.fusions.pick` and `pool`
(kernels F3 and F2 on the card, these tensor ops on the CPU).
The scan comes as the step's `ops.cuda.fusions.ScanPrep` (F6's endpoints,
used beams and coarse beams, once a scan), or as a Scan that is prepared
here (F6 on the card).  The coarse stage's offsets, expanded to a chunk's
particles, are cached beside the offsets; the last stage writes the best
poses and scores into the rows a step passes (`out`).
`correlative_match` and `score_pose` on a single pose are batches of one.  Only
`impl` "auto" and "gather" exist here: the JAX package's "matmul", "splat"
and "pallas" backends are TPU workarounds and raise ValueError.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..types import Odom, Scan
from .cuda import fusions
from .cuda.fusions import ScanPrep, _argmax3, _prior_grid
from .cuda.matcher import (_bilinear, _nearest, stage_scores_batch,
                           stage_scores_batch_plain)

__all__ = ["effective_field", "log_likelihood_field", "score_pose",
           "correlative_match", "correlative_match_batch", "half_resolution",
           "_bilinear", "_nearest", "_stage_scores", "_prior_grid",
           "_argmax3"]

IMPLS = ("auto", "gather")


def effective_field(field, unknown, z_hit: float, max_range: float):
    """Fold the unknown-cell uniform case into the field values so scoring is
    a single fused formula."""
    uniform = 1.0 / max_range
    v_eq = (uniform - (1.0 - z_hit) * uniform) / z_hit
    return torch.where(unknown, v_eq, field)


def log_likelihood_field(field, unknown, z_hit: float, max_range: float):
    """Per-cell log measurement likelihood, precomputed once per particle:
    LL = log(z_hit * v' + (1-z_hit)/max_range) with v' the effective field."""
    uniform = 1.0 / max_range
    v = effective_field(field, unknown, z_hit, max_range)
    return torch.log(z_hit * v + (1.0 - z_hit) * uniform)


def _stage_scores(llfield, px, py, use, pose0, dxs, dys, dts, *,
                  resolution, origin, z_hit, max_range, nearest=False):
    """Score all (dt, dy, dx) pose offsets around one pose0 (3,) on one
    (H, W) field: the plain stage scorer for a single particle.  Returns
    (nt, ny, nx).  z_hit is unused, as in the JAX package (the field already
    holds log-likelihoods)."""
    del z_hit
    return stage_scores_batch_plain(
        llfield[None], px, py, use, pose0[None], dxs[None], dys[None],
        dts[None], resolution=resolution, origin=origin, max_range=max_range,
        nearest=nearest)[0]


def _offsets_key(mc, device):
    return (float(mc.window_xy), float(mc.window_theta_deg),
            int(mc.coarse_nxy), int(mc.coarse_nt), int(mc.fine_nxy),
            int(mc.fine_nt), int(mc.extra_refine_stages), str(device))


def _stage_offsets(mc, device):
    """The matcher's candidate offsets on `device`, built once per (matcher
    config, device) and cached: the coarse (dxs, dts) and, for each
    refinement stage, its (off_xy, off_t) around the running argmax.
    Copying numpy-built offsets to the card inside a step would stop the
    host once a stage."""
    key = _offsets_key(mc, device)
    hit = _OFFSETS.get(key)
    if hit is not None:
        return hit

    def dev(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    wt = math.radians(mc.window_theta_deg)
    coarse = (dev(np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy)),
              dev(np.linspace(-wt, wt, mc.coarse_nt)))
    step_xy = 2.0 * mc.window_xy / max(mc.coarse_nxy - 1, 1)
    step_t = 2.0 * wt / max(mc.coarse_nt - 1, 1)
    refine = []
    for _ in range(1 + mc.extra_refine_stages):
        refine.append((dev(np.linspace(-step_xy, step_xy, mc.fine_nxy)),
                       dev(np.linspace(-step_t, step_t, mc.fine_nt))))
        step_xy = 2.0 * step_xy / max(mc.fine_nxy - 1, 1)
        step_t = 2.0 * step_t / max(mc.fine_nt - 1, 1)
    _OFFSETS[key] = (coarse, tuple(refine))
    return _OFFSETS[key]


def _coarse_offsets(mc, device, pn: int):
    """The coarse stage's (dxs, dts) expanded to pn particles, (pn, nx) and
    (pn, nt), cached beside _stage_offsets by (matcher config, device, pn):
    built at a step's first call (a captured replay's warm-up), read by
    every later one."""
    key = (*_offsets_key(mc, device), pn)
    hit = _EXPANDED.get(key)
    if hit is None:
        (c_off_xy, c_off_t), _ = _stage_offsets(mc, device)
        hit = _EXPANDED[key] = (c_off_xy.expand(pn, -1).contiguous(),
                                c_off_t.expand(pn, -1).contiguous())
    return hit


_OFFSETS: dict = {}
_EXPANDED: dict = {}


def _prepared(scan, stride: int) -> ScanPrep:
    """The scan as a ScanPrep of coarse stride `stride`: the step's, or one
    made of a Scan (F6 on the card, its plain version on the CPU)."""
    if not isinstance(scan, ScanPrep):
        return fusions.prepare_scan(scan, stride=stride)
    if scan.stride != stride:
        raise ValueError(f"the scan was prepared at coarse stride "
                         f"{scan.stride}, the matcher takes {stride}")
    return scan


def half_resolution(llfield_b, ll_outside: float):
    """The 2x2-mean-pooled (G, H/2, W/2) fields of (G, H, W) fields, odd
    edges padded with the out-of-map value: one pooled field a field (F2
    on the card)."""
    return fusions.pool(llfield_b, ll_outside)


def score_pose(llfield, scan, pose, *, z_hit, resolution, origin,
               max_range):
    """Measurement log-likelihood of poses with no search.  A single pose
    (3,) on one (H, W) field gives a scalar (the JAX package's score_pose);
    poses (P, 3) on grouped fields (G_f, H, W) and a scan (B,) or (G_b, B)
    (a Scan or the step's ScanPrep) give (P,).  z_hit is unused, as in the
    JAX package."""
    del z_hit
    if pose.dim() == 1:
        return score_pose(llfield[None], scan, pose[None], z_hit=None,
                          resolution=resolution, origin=origin,
                          max_range=max_range)[0]
    prep = scan if isinstance(scan, ScanPrep) else _prepared(scan, 1)
    zero = torch.zeros((pose.shape[0], 1), dtype=torch.float32,
                       device=pose.device)
    return stage_scores_batch(llfield, prep.px, prep.py, prep.use, pose,
                              zero, zero, zero, resolution=resolution,
                              origin=origin, max_range=max_range).reshape(-1)


def correlative_match(llfield, scan: Scan, pose0, odom: Odom, *,
                      matcher_cfg, motion_cfg, resolution, origin, max_range,
                      prior_center=None):
    """The search for one particle: llfield (H, W), pose0 (3,), prior_center
    (3,) or None.  Returns (best_pose (3,), meas_logscore), as the JAX
    package's correlative_match (a batch of one of
    correlative_match_batch)."""
    best, score = correlative_match_batch(
        llfield[None], scan, pose0[None], odom, matcher_cfg=matcher_cfg,
        motion_cfg=motion_cfg, resolution=resolution, origin=origin,
        max_range=max_range,
        prior_center_b=None if prior_center is None else prior_center[None])
    return best[0], score[0]


def correlative_match_batch(llfield_b, scan, pose0_b, odom: Odom, *,
                            matcher_cfg, motion_cfg, resolution, origin,
                            max_range, prior_center_b=None, stage=None,
                            pool=None, out=None):
    """For every particle, the pose maximizing
    log p(z|x,m) + prior_weight * log p(x|x0,u) near pose0.

    llfield_b: (G_f, H, W) log-likelihood fields, particle p matching on
    field p // (P // G_f): one a particle (the RBPF), one for all (the
    shared-map filters) or one a group (closure candidates).  scan: (B,)
    arrays, or (G_b, B) with odom of shape (G_b,), one scan and one odometry
    a group of P // G_b particles (the robots of a multi-robot step): the
    step's ScanPrep at the matcher's coarse stride, or a Scan.
    pose0_b: (P, 3) search centers (the motion-sampled poses);
    prior_center_b: (P, 3) poses the motion prior is centered at (the
    deterministic odometry poses), or None to center it at pose0.  Same
    candidate schedule as the JAX package's correlative_match: a coarse
    stage (optionally on a 2x2-mean-pooled half-resolution field, pooled
    once a field) over every `coarse_beam_stride`-th beam with its prior
    scaled by the used-beam fraction, then 1 + extra_refine_stages halving
    bilinear stages over all beams.  The offsets come from a cache on the
    device, so a call reads nothing back to the host.

    `stage` and `pool` replace stage_scores_batch and half_resolution for
    a field split over ranks (parallel/tiled.py: llfield_b is then a tile
    of the field, `stage` sums the tiles' partial scores and `pool` pools
    the tiles); the schedule, the prior and the argmax are unchanged.

    Returns (best_poses (P, 3), meas_logscores (P,)), the measurement-only
    log-likelihood at the best pose (the reference's particle weight),
    written into `out` = (poses (P, 3), scores (P,)) where it is given (a
    step's rows).
    """
    stage = stage_scores_batch if stage is None else stage
    pool = half_resolution if pool is None else pool
    mc = matcher_cfg
    impl = getattr(mc, "impl", "gather")
    if impl not in IMPLS:
        raise ValueError(f"matcher.impl={impl!r} is not ported (TPU-only "
                         f"backend); use one of {IMPLS}")
    pn, rows = pose0_b.shape[0], out
    ll_outside = math.log(1.0 / max_range)
    stride = max(int(mc.coarse_beam_stride), 1)
    prep = _prepared(scan, stride)
    px, py, use = prep.px, prep.py, prep.use
    px_c, py_c, use_c = prep.px_c, prep.py_c, prep.use_c
    kw = dict(origin=origin, max_range=max_range)
    _, refine = _stage_offsets(mc, pose0_b.device)
    c_dxs, c_dts = _coarse_offsets(mc, pose0_b.device, pn)

    if getattr(mc, "coarse_halfres", False):
        # Basin-finding on the 2x2-mean-pooled field, bilinear at twice the
        # cell size.
        meas = stage(pool(llfield_b, ll_outside), px_c, py_c, use_c, pose0_b,
                     c_dxs, c_dxs, c_dts, resolution=2.0 * resolution,
                     nearest=False, **kw)
    else:
        meas = stage(llfield_b, px_c, py_c, use_c, pose0_b, c_dxs, c_dxs,
                     c_dts, resolution=resolution,
                     nearest=bool(mc.coarse_nearest), **kw)

    # Each stage's pick (F3 on the card): the motion prior, centered at
    # prior_center_b, the first argmax of scores + prior, then the next
    # stage's offsets around it (the refinement stages halve the span), or
    # the best poses and their scores after the last.  The coarse prior is
    # scaled by the coarse beam fraction: a prior in per-used-beam units
    # must not change with the beam subset.
    def picked(scores, dxs, dys, dts, i, coarse=False):
        last = i >= len(refine)
        nxt = (None, None) if last else refine[i]
        return fusions.pick(scores, dxs, dys, dts, pose0_b, prior_center_b,
                            odom.d_center, odom.d_theta,
                            use if coarse else None, *nxt, motion=motion_cfg,
                            prior_weight=mc.prior_weight, stride=stride,
                            out=rows if last else None)

    out = picked(meas, c_dxs, c_dxs, c_dts, 0, coarse=True)
    # the coarse stage's scores go before the finer stages allocate theirs:
    # a stage's scores are the search's one tensor of its size
    # (models/shared.matcher_workspace_bytes counts the larger stage's)
    del meas
    for i in range(len(refine)):
        meas = stage(llfield_b, px, py, use, pose0_b, *out,
                     resolution=resolution, nearest=False, **kw)
        out = picked(meas, *out, i + 1)
        del meas
    return out
