"""Shared-map particle filter, in PyTorch.

Counterpart of gridmap_slam_tpu/models/shared.py: one log-odds map for the
whole cloud, and particles that carry only (pose, log-weight).  Two
measurement models:

- `step` / `step_blocked`: every particle runs the full three-stage
  correlative matcher (ops/matcher.py, kernel K1) against the one shared
  field, built once a scan (kernel K3 at batch 1), in blocks of
  `particle_chunk` (or `block`) particles; the scan is then integrated into
  the whole map (kernel K2 at batch 1) and the filter resamples when
  Neff < resample_fraction * P.  `matcher_block_size` sizes the block from
  the matcher's workspace on the card (the `mega_blocked` preset: 1M
  particles in blocks of 500 000).
- `step_surface`: the engine's 1M-particle surface mode (BASELINE config
  3), a per-scan correlation volume (ops/surface.py) sampled at every
  particle's pose.

Both end in the same tail (`_finish`): weights, Neff, the integration pose,
the map update, and the resample with the AMCL recovery injection under
the JAX step's lax.cond (models/captured.cond: a CUDA-graph IF node in
the captured replays, so that a scan whose gate does not fire skips the
P-row tail; a select eagerly on the card; a Python branch on the CPU).

Per surface scan: the volume is centered on the odometry-propagated cloud mean; the
log-likelihood field is built over the volume's crop plus the blur radius
(kernel K3 at batch 1); every particle samples the motion model and reads
its score from the volume; weights, Neff and the integration pose follow;
the scan is integrated once into the shared map (kernel K2 at batch 1, on
a crop of 2*kc + 8 cells around the pose when the map is larger); the
filter resamples when Neff < surface_resample_fraction * P, and the AMCL
recovery injection replaces a fraction of the resampled slots with
uniform poses.

`replay` / `replay_surface` run a stacked Frame batch as `jax.lax.scan`
does (stacked infos); `replay_jit` / `replay_surface_jit` are their
captured forms, the whole log one CUDA graph replayed once a call
(models/captured.py), and `step_jit` captures one step.

Host reads a scan: none.  Where the integration crop is smaller than the
map (`city`), K2's window variant reads the crop's top-left cell from the
card; the volume crop is sliced by index arithmetic on the card.

With matcher.surface_bf16 the direct correlation takes bf16 products with
float32 sums (kernel K4 on the card); the FFT correlation ignores it, as
in the JAX package.

Faults of the JAX package not copied: it feeds the recovery EMAs the max
log-weight after weight accumulation (models/shared.py:434), so this engine
refuses injection together with accumulate_weights=True; and its
step_blocked (models/shared.py:577-654) skips the recovery EMAs, never
injects and ignores freeze_map, where this engine's step_blocked is `step`
with particle_chunk = block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

import torch

from ..config import SlamConfig
from ..ops.cuda.fusions import (ScanPrep, WindowSpec, endpoint_factors,
                                 prepare_scan, score_on_volume, temper,
                                 volume_window, walk, weights)
from ..ops.cuda.grid_update import integrate_scan_batch, integrate_scan_window
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.grid import gaussian_kernel
from ..ops.matcher import correlative_match_batch, score_pose
from ..ops.motion import sample_and_propagate, sample_motion
# integration_pose is the JAX module's (models/shared.py) and is kept
# under its name here; it lives in ops/resample beside F7's plain version
from ..ops.resample import integration_pose, recovery_ema  # noqa: F401
from ..ops.surface import (crop_center_cells, endpoint_images, scan_surface,
                           theta_grid)
from ..types import Frame, Scan, StepInfo
from . import captured
from .rbpf import scan_prep


def matcher_workspace_bytes(cfg: SlamConfig) -> int:
    """Bytes a particle of correlative_match_batch is allowed on the card:
    three times the K1 output of a stage, nt * nxy^2 float32 values, for the
    larger of the coarse stage and a refinement stage (the coarse scores are
    freed before the refinement stages start).  The scores are the only
    tensor of that size the search makes on the card (F3 picks from them
    in one pass; the prior grid and the total it once added are gone), so
    the other two
    are a margin, kept so that the blocks it sizes, and their bits, stay as
    they were.  Default matcher: 3 * 11 * 81 * 4 = 10 692 bytes."""
    mc = cfg.matcher
    cells = max(mc.coarse_nt * mc.coarse_nxy ** 2,
                mc.fine_nt * mc.fine_nxy ** 2)
    return 3 * cells * 4


def matcher_block_size(cfg: SlamConfig, budget_bytes: float = 10e9,
                       granule: int = 256) -> int:
    """Largest particle block whose matcher workspace fits `budget_bytes`
    of device memory (the JAX package's rule, with the workspace of the
    torch matcher, `matcher_workspace_bytes`, in place of the TPU matmul's):
    the budget-derived size, at most num_particles, lowered to the largest
    divisor of num_particles (step_blocked needs block | num_particles).
    The default matcher at 1M particles gives 500 000.  `granule` is kept
    for the JAX signature and unused, as there."""
    del granule
    block = max(1, int(budget_bytes / matcher_workspace_bytes(cfg)))
    block = min(block, cfg.num_particles)
    while cfg.num_particles % block:
        block -= 1
    return block


@dataclasses.dataclass
class SharedMapState:
    """poses: (P, 3); log_weights: (P,); logodds: (H, W), the one shared
    map; step: int32 scan counter; recov: (2,) [l_slow, l_fast], the
    slow/fast EMAs of the max log-weight for the recovery injection
    (unchanged while injection is off)."""

    poses: torch.Tensor
    log_weights: torch.Tensor
    logodds: torch.Tensor
    step: torch.Tensor
    recov: torch.Tensor


def _window(x, y0, x0, hh: int, ww: int):
    """x[y0:y0+hh, x0:x0+ww] for start indices held in tensors on x's
    device (gathered, so the host reads nothing)."""
    if (hh, ww) == tuple(x.shape):
        return x
    rows = y0 + torch.arange(hh, device=x.device)
    cols = x0 + torch.arange(ww, device=x.device)
    return x[rows[:, None], cols[None, :]]


def volume_window_spec(cfg: SlamConfig) -> WindowSpec:
    """The surface volume's window (F7's center call places it): the crop
    around the odometry-propagated cloud mean, the window of the crop plus
    the blur radius the field is built over (the whole map where that does
    not fit in it), and the theta bins of ops/surface.theta_grid."""
    mc = cfg.matcher
    h, w = cfg.map.cells_y, cfg.map.cells_x
    crop = mc.surface_crop_cells          # 0: the whole map
    hc, wc = (min(crop, h), min(crop, w)) if crop > 0 else (h, w)
    r = cfg.map.likelihood_radius
    ext = (hc + 2 * r, wc + 2 * r)
    if ext[0] > h or ext[1] > w:
        ext = (h, w)
    dtheta, _, t_off = theta_grid(mc.surface_nt,
                                  math.radians(mc.surface_theta_span_deg))
    return WindowSpec(crop=(hc, wc), full=(h, w),
                      resolution=float(cfg.map.resolution),
                      origin=(float(cfg.map.origin[0]),
                              float(cfg.map.origin[1])),
                      volume=True, radius=r, ext=ext, nt=mc.surface_nt,
                      t_off=t_off, dtheta=dtheta)


def surface_volume(cfg: SlamConfig, taps, logodds, scan, center=None,
                   window=None):
    """One scan's likelihood volume around `center` (the odometry-propagated
    cloud mean) and the keyword arguments of score_on_volume (F4), the
    temperature's among them.  `scan`: the step's ScanPrep (or a Scan,
    prepared here); `window`: the volume's ops/cuda/fusions.Window, which
    F7's center call places (else placed here around `center` in tensor
    ops).

    The likelihood field (K3, batch 1) is built only over the crop plus the
    blur radius, which reproduces the full-map build exactly on the crop;
    when that extended window does not fit the map, over the whole map.
    Returns (c_vol, tap_kw, kc)."""
    mc = cfg.matcher
    spec = volume_window_spec(cfg)
    prep = scan if isinstance(scan, ScanPrep) else prepare_scan(scan)
    win = window if window is not None else volume_window(center, spec)
    res = spec.resolution
    (h, w), (hc, wc), (hce, wce) = spec.full, spec.crop, spec.ext
    llf_kw = dict(z_hit=mc.z_hit, max_range=cfg.sensor.max_range)
    if hc + 2 * spec.radius <= h and wc + 2 * spec.radius <= w:
        lo_ext = _window(logodds, win.ey0, win.ex0, hce, wce)
        llf_ext = log_likelihood_field_batch(lo_ext[None], taps, **llf_kw)[0]
        llf_crop = _window(llf_ext, win.oy, win.ox, hc, wc)
    else:
        llf = log_likelihood_field_batch(logodds[None], taps, **llf_kw)[0]
        llf_crop = _window(llf, win.iy0, win.ix0, hc, wc)

    nt = mc.surface_nt
    dtheta, wrap_theta, _ = theta_grid(
        nt, math.radians(mc.surface_theta_span_deg))
    # The kernel radius covers every hit endpoint (<= max_range), so the
    # splat's rim clamp never engages.
    kc = int(math.ceil(cfg.sensor.max_range / res)) + 2
    e_stack = endpoint_images(*endpoint_factors(prep.px, prep.py, prep.wgt,
                                                win.thetas, kc, res))
    use_fft = (mc.surface_corr == "fft"
               or (mc.surface_corr == "auto"
                   and nt * (2 * kc + 1) ** 2 * hc * wc > 2e10))
    c_vol = scan_surface(llf_crop, e_stack,
                         math.log(1.0 / cfg.sensor.max_range),
                         bf16=mc.surface_bf16, fft=use_fft)
    tap_kw = dict(theta0=win.theta0, dtheta=dtheta, crop_iy0=win.iy0,
                  crop_ix0=win.ix0, resolution=res, origin=spec.origin,
                  wrap_theta=wrap_theta, temp=mc.surface_weight_temp,
                  n_used=prep.n_used)
    return c_vol, tap_kw, kc


def surface_temper(mc, scan: Scan, scores):
    """Surface-mode weight temperature (MatcherConfig.surface_weight_temp:
    0 = auto 1/sqrt(n_valid_hit_beams), 1 = raw product), in tensor ops:
    ops/cuda/fusions.temper with the scan's used beams.  The steps temper
    inside F4 (score_on_volume's temp and n_used)."""
    n_b = torch.clamp((scan.valid & scan.hit).to(scores.dtype).sum(),
                      min=1.0)
    return temper(scores, mc.surface_weight_temp, n_b)


def reinject_rates(cfg: SlamConfig):
    """(a_slow, a_fast) of the AMCL recovery EMAs, or None when injection
    is off."""
    mc = cfg.matcher
    a_slow, a_fast = mc.surface_reinject_slow, mc.surface_reinject_fast
    return (a_slow, a_fast) if a_slow > 0.0 and a_fast > 0.0 else None


def recovery_update(cfg: SlamConfig, state: SharedMapState, l_ref):
    """AMCL fast/slow EMA update from `l_ref`, the max log-weight of the
    scan (ops/resample.recovery_ema).  Returns (recov', p_inject), p_inject
    None when injection is off."""
    rates = reinject_rates(cfg)
    if rates is None:
        return state.recov, None
    return recovery_ema(state.recov, state.step, l_ref, *rates)


def _uniform_poses(m, u):
    """(k, 3) poses uniform over the map extent x [-pi, pi) from (k, 3)
    uniform draws in [0, 1)."""
    return torch.stack([m.origin[0] + u[:, 0] * m.width_m,
                        m.origin[1] + u[:, 1] * m.height_m,
                        (u[:, 2] * 2.0 - 1.0) * math.pi], 1)


def inject_uniform(cfg: SlamConfig, u, poses, p_inject, slot_offset=0):
    """Replace the global resample slots [0, p_inject * P) with uniform
    poses over the map extent x the full circle.  poses: (k, 3), the slots
    [slot_offset, slot_offset + k) of the resampled population (a rank's
    slice in the distributed engines); u: (k, 3) uniform draws in [0, 1).
    Returns (poses', mask)."""
    uni = _uniform_poses(cfg.map, u)
    slot = slot_offset + torch.arange(poses.shape[0], device=poses.device)
    take = slot < p_inject * cfg.num_particles
    return torch.where(take[:, None], uni, poses), take


def match_particles(cfg: SlamConfig, llf, poses, normals, scan, odom,
                    chunk: int, **match_kw):
    """Motion-sample `poses` (k, 3) with `normals` (k, 2) and run the
    matcher (K1) against the field(s) llf, in blocks of `chunk` particles,
    each block's best poses and scores written into its rows of the
    results (F3's last stage writes them).  `scan`: the step's ScanPrep.
    `match_kw` goes to correlative_match_batch (the distributed engines
    pass their tile scorer).  Returns (poses, measurement scores)."""
    origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
    kw = dict(resolution=float(cfg.map.resolution), origin=origin,
              max_range=cfg.sensor.max_range)
    k = poses.shape[0]
    out_poses = torch.empty((k, 3), dtype=torch.float32, device=poses.device)
    scores = torch.empty((k,), dtype=torch.float32, device=poses.device)
    for s in range(0, k, chunk):
        pose = poses[s:s + chunk]
        rows = (out_poses[s:s + chunk], scores[s:s + chunk])
        if cfg.matcher.enabled:
            pose_s, pose_det = sample_and_propagate(
                pose, odom, cfg.motion, normals[s:s + chunk])
            correlative_match_batch(
                llf, scan, pose_s, odom, matcher_cfg=cfg.matcher,
                motion_cfg=cfg.motion, prior_center_b=pose_det, **kw,
                out=rows, **match_kw)
        else:
            pose_s = sample_motion(pose, odom, cfg.motion,
                                   normals[s:s + chunk])
            rows[0].copy_(pose_s)
            rows[1].copy_(score_pose(llf, scan, pose_s,
                                     z_hit=cfg.matcher.z_hit, **kw))
    return out_poses, scores


class SharedMapSLAM:
    """Shared-map particle filter for a fixed `SlamConfig` on one device
    (the card unless `device="cpu"` is asked for).
    On a CUDA device K1, K2 and K3 are the hand-written kernels; on the CPU
    their plain versions."""

    def __init__(self, config: SlamConfig, device="cuda"):
        mc = config.matcher
        if config.dtype != "float32":
            raise ValueError(f"the kernels take float32, got {config.dtype}")
        self.injects = (mc.surface_reinject_slow > 0.0
                        and mc.surface_reinject_fast > 0.0)
        if self.injects and config.accumulate_weights:
            raise ValueError(
                "recovery injection with accumulate_weights=True is refused: "
                "the JAX engine feeds the recovery EMAs the max log-weight "
                "after accumulation (gridmap_slam_tpu/models/shared.py:434), "
                "a fault this port does not copy")
        self.config = config
        self.device = torch.device(device)
        m = config.map
        self.taps = torch.as_tensor(
            gaussian_kernel(m.likelihood_sigma, m.likelihood_radius),
            device=self.device)

    # ------------------------------------------------------------------ state
    def init(self, pose=(0.0, 0.0, 0.0)) -> SharedMapState:
        """All particles at `pose`, blank map, on the engine's device."""
        cfg = self.config
        p = cfg.num_particles
        dev = self.device
        return SharedMapState(
            poses=torch.tensor(pose, dtype=torch.float32,
                               device=dev).expand(p, 3).clone(),
            log_weights=torch.full((p,), -math.log(p), dtype=torch.float32,
                                   device=dev),
            logodds=torch.zeros((cfg.map.cells_y, cfg.map.cells_x),
                                dtype=torch.float32, device=dev),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            recov=torch.zeros((2,), dtype=torch.float32, device=dev))

    def init_from_map(self, logodds, pose=(0.0, 0.0, 0.0)) -> SharedMapState:
        """Start from a previously built (H, W) shared map (localization,
        checkpoint resume)."""
        state = self.init(pose)
        lo = torch.as_tensor(logodds, dtype=torch.float32, device=self.device)
        if lo.shape != state.logodds.shape:
            raise ValueError(f"map shape {tuple(lo.shape)} != configured "
                             f"{tuple(state.logodds.shape)}")
        state.logodds = lo.clone()
        return state

    def init_uniform(self, logodds, generator: Optional[torch.Generator] = None,
                     draws=None) -> SharedMapState:
        """Kidnapped-robot start: particles uniform over the map extent x
        [-pi, pi) on a known map.  `draws`: (P, 3) uniforms in [0, 1) that
        replace the draws from `generator`."""
        u = draws
        if u is None:
            u = torch.rand((self.config.num_particles, 3),
                           generator=generator, device=self.device)
        state = self.init_from_map(logodds)
        state.poses = _uniform_poses(self.config.map, u)
        return state

    # ------------------------------------------------------------------- step
    def _draws(self, generator, draws, out=None):
        """(normals (P, 2), u0, injection uniforms (P, 3) or None): `draws`
        as given, or drawn from `generator` on the engine's device, into
        the tensors of `out` where it is given (the captured replays'
        static draws)."""
        if draws is not None:
            return draws
        p = self.config.num_particles
        dev = self.device
        o = (None, None, None) if out is None else out
        normals = torch.randn((p, 2), generator=generator, device=dev,
                              out=o[0])
        u0 = torch.rand((), generator=generator, device=dev, out=o[1])
        u0 = torch.mul(u0, 1.0 / p, out=o[1])
        inj = (torch.rand((p, 3), generator=generator, device=dev, out=o[2])
               if self.injects else None)
        return normals, u0, inj

    def _scan_inputs(self, frame: Frame) -> ScanPrep:
        """The step's ScanPrep (F6 on the card): the deskewed scan, its bin
        tables, endpoints, used beams and their count, and the map-update
        multiplier keep (0 past the large-rotation skip, slam/SLAM.java:82,
        and always 0 with freeze_map)."""
        return scan_prep(self.config, frame)

    def step(self, state: SharedMapState, frame: Frame,
             generator: Optional[torch.Generator] = None,
             draws=None, out: Optional[SharedMapState] = None
             ) -> Tuple[SharedMapState, StepInfo]:
        """One scan with the per-particle matcher against the shared map, in
        blocks of `particle_chunk` particles (all at once when 0).  `draws`
        and `out` as in step_surface."""
        return self._matcher_step(state, frame, self.config.particle_chunk,
                                  generator, draws, out)

    def step_blocked(self, state: SharedMapState, frame: Frame, block: int,
                     generator: Optional[torch.Generator] = None,
                     draws=None, out: Optional[SharedMapState] = None
                     ) -> Tuple[SharedMapState, StepInfo]:
        """`step` with particle_chunk = block (block must divide P; size it
        with matcher_block_size): the same result bit for bit, recovery
        EMAs, injection and freeze_map included."""
        return self._matcher_step(state, frame, block, generator, draws, out)

    def _matcher_step(self, state, frame, chunk, generator, draws, out):
        cfg = self.config
        p = cfg.num_particles
        chunk = chunk if 0 < chunk < p else p
        if p % chunk:
            raise ValueError(f"num_particles {p} must be divisible by the "
                             f"block {chunk}")
        normals, u0, inj = self._draws(generator, draws)
        prep = self._scan_inputs(frame)
        # the LL field, built once for the shared map (K3 at batch 1)
        llf = log_likelihood_field_batch(
            state.logodds[None], self.taps, z_hit=cfg.matcher.z_hit,
            max_range=cfg.sensor.max_range)
        poses, scores = match_particles(cfg, llf, state.poses, normals,
                                        prep, frame.odom, chunk)
        return self._finish(state, poses, scores, prep.tables, prep.keep,
                            u0, inj, crop=0,
                            resample_fraction=cfg.resample_fraction, out=out)

    def step_surface(self, state: SharedMapState, frame: Frame,
                     generator: Optional[torch.Generator] = None,
                     draws=None, out: Optional[SharedMapState] = None
                     ) -> Tuple[SharedMapState, StepInfo]:
        """One scan in surface mode.  `draws` = (normals (P, 2), u0,
        injection uniforms (P, 3) or None) replaces the draws from
        `generator`: standard normals for each particle's distance and
        heading noise, the systematic-resampling offset u0 in [0, 1/P), and
        the uniforms of the recovery injection (used only when it is on).
        A generator must be on the engine's device.  `out`: a state whose
        tensors receive the new state, which is then `out` (it may be
        `state` itself; the captured replays pass their static buffers)."""
        cfg = self.config
        mc = cfg.matcher
        normals, u0, inj = self._draws(generator, draws)
        prep = self._scan_inputs(frame)
        odom = frame.odom

        # Volume center: the previous cloud's weighted mean propagated by
        # this frame's odometry, so the theta span follows a turn; F7's
        # center call places the volume's crop, the field's window and the
        # theta bins around it.
        win = weights(state.log_weights, state.poses,
                      window=volume_window_spec(cfg), odom=odom).volume
        c_vol, kw, kc = surface_volume(cfg, self.taps, state.logodds, prep,
                                       window=win)
        pose_s = sample_motion(state.poses, odom, cfg.motion, normals)
        # the sample, the climb and the weights' temperature (F4)
        poses, scores = score_on_volume(
            c_vol, pose_s, steps=mc.surface_refine_steps, **kw)
        # Integration only touches cells within max_range of the pose.
        return self._finish(state, poses, scores, prep.tables, prep.keep,
                            u0, inj, crop=2 * kc + 8,
                            resample_fraction=mc.surface_resample_fraction,
                            out=out)

    def _finish(self, state, poses, scores, tables, keep, u0, inj, *,
                crop: int, resample_fraction: float, out=None):
        """The tail of every step: weights, Neff, the map update at the
        integration pose (into a crop x crop window when that is smaller
        than the map), the resample gate, the recovery EMAs and the
        injection.  Each field's last operation writes into `out` where
        one is given, after the field's last read of `state`."""
        cfg = self.config
        o = out if out is not None else SharedMapState(None, None, None,
                                                       None, None)
        log_weights = scores.to(state.log_weights.dtype)
        if cfg.accumulate_weights:
            log_weights = log_weights + state.log_weights
        # The weights' tail (F7 on the card): Neff, the first argmax and its
        # pose, the weighted mean pose, the integration pose, the resample
        # gate and the recovery EMAs of the max log-weight with p_inject (a
        # kidnap makes every particle uniformly bad, so Neff rises and the
        # gate alone would never fire: injection forces a resample).
        rates = reinject_rates(cfg)
        tail = weights(log_weights, poses,
                       resample_fraction=resample_fraction,
                       recov=None if rates is None else state.recov,
                       step=state.step, reinject=rates or (0.0, 0.0),
                       window=self._crop_spec(crop))
        logodds = self._integrate(state.logodds, tail.integ_pose, tables,
                                  keep, crop, out=o.logodds, win=tail.crop)
        do_resample, p_inject = tail.gate, tail.p_inject
        recov = state.recov if tail.recov is None else tail.recov
        if out is not None:
            recov = captured.copy_into(out.recov, recov)
        new_step = torch.add(state.step, 1, out=o.step)

        # The JAX step's lax.cond as captured.cond: the identity's poses and
        # weights land in `out` (or fresh tensors), and the resample (the
        # systematic walk, F8 on the card, with its gathers, and the
        # injection) overwrites them only where the gate fires.
        new_poses = (poses.clone() if out is None
                     else captured.copy_into(out.poses, poses))
        new_lw = (log_weights.clone() if out is None
                  else captured.copy_into(out.log_weights, log_weights))

        def resample():
            walk(log_weights, u0, poses, tail.max, tail.total,
                 gather_weights=not cfg.accumulate_weights,
                 out=(None, new_poses, new_lw))
            if cfg.accumulate_weights:
                new_lw.zero_()
            if p_inject is not None:
                inj_poses, took = inject_uniform(cfg, inj, new_poses,
                                                 p_inject)
                new_poses.copy_(inj_poses)
                new_lw.copy_(torch.where(took, new_lw.mean(), new_lw))

        captured.cond(do_resample, resample, [new_poses, new_lw])

        new_state = out if out is not None else SharedMapState(
            poses=new_poses, log_weights=new_lw, logodds=logodds,
            step=new_step, recov=recov)
        info = StepInfo(neff=tail.neff, weighted_pose=tail.weighted,
                        best_pose=tail.best_pose,
                        best_index=tail.best_index.to(torch.int32),
                        best_log_weight=new_lw.max(), resampled=do_resample)
        return new_state, info

    def _crop_spec(self, crop: int):
        """The map update's crop x crop window around the integration pose
        (F7's tail call places it), or None where the crop is not smaller
        than the map."""
        m = self.config.map
        h, w = m.cells_y, m.cells_x
        if not 0 < crop < min(h, w):
            return None
        return WindowSpec(crop=(crop, crop), full=(h, w),
                          resolution=float(m.resolution),
                          origin=(float(m.origin[0]), float(m.origin[1])))

    def _integrate(self, logodds, pose, tables, keep, crop: int, out=None,
                   win=None):
        """The shared map with the scan integrated at `pose` (K2 at batch
        1): into a crop x crop window around the pose when that is smaller
        than the map (K2's window variant, placed on the card: `win`, its
        corner (2,) int64 where F7 placed it, else placed here), else into
        the whole map.  `out`: the (H, W) map that receives it (it may be
        `logodds` itself)."""
        cfg = self.config
        s = cfg.sensor
        origin = (float(cfg.map.origin[0]), float(cfg.map.origin[1]))
        res = float(cfg.map.resolution)
        kw = dict(resolution=res, l_free=s.l_free, l_occ=s.l_occ,
                  tol_cells=s.hit_tolerance_cells)
        h, w = logodds.shape
        if not 0 < crop < min(h, w):
            return integrate_scan_batch(
                logodds[None], pose[None], keep, *tables, origin=origin,
                out=None if out is None else out[None], **kw)[0]
        if win is None:
            win = torch.stack(crop_center_cells(pose[:2], (crop, crop),
                                                (h, w), res, origin))
        return integrate_scan_window(logodds, win, pose, keep, *tables,
                                     size=(crop, crop), origin=origin,
                                     out=out, **kw)

    # -------------------------------------------------------------- utilities
    def run_log(self, state: SharedMapState, frames: Iterable[Frame],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SharedMapState, List[StepInfo]]:
        """Replay a sequence of frames through step_surface; returns
        (state, infos)."""
        infos = []
        for f in frames:
            state, info = self.step_surface(state, f, generator)
            infos.append(info)
        return state, infos

    def replay(self, state: SharedMapState, frames,
               generator: Optional[torch.Generator] = None,
               block: int = 0, draws=None):
        """Replay frames through `step` (block 0) or `step_blocked(block)`.
        `frames` an iterable of Frames: returns (state, list of infos).  A
        stacked Frame batch (`io.frames_to_device`): returns (state,
        StepInfo with a leading frame axis), as gridmap_slam_tpu's
        `lax.scan` does, and `draws` may replace the generator's draws with
        stacked ones (as in step_surface, with a leading frame axis; one of
        another length raises ValueError)."""
        if isinstance(frames, Frame):
            return captured.scan(self._matcher_scan_step(block),
                                 self._draw, state, frames, generator, draws)
        if draws is not None:
            raise ValueError("injected draws need a stacked Frame batch")
        infos = []
        for f in frames:
            if block:
                state, info = self.step_blocked(state, f, block, generator)
            else:
                state, info = self.step(state, f, generator)
            infos.append(info)
        return state, infos

    def replay_surface(self, state: SharedMapState, frames: Frame,
                       generator: Optional[torch.Generator] = None,
                       draws=None) -> Tuple[SharedMapState, StepInfo]:
        """Replay a stacked Frame batch through step_surface, as
        gridmap_slam_tpu's `lax.scan` does: returns (final state, StepInfo
        with a leading frame axis); `draws` as in `replay`.  With one
        generator seed the bits of `run_log`."""
        return captured.scan(self._surface_scan_step, self._draw, state,
                             frames, generator, draws)

    def replay_jit(self, block: int = 0):
        """`replay` of a stacked batch with the whole log replayed as
        captured CUDA graphs of at most captured.CHUNK_SCANS scans of
        `step` (or `step_blocked(block)`), launched in turn, their draws
        inside; on a CPU engine the same static-buffer loop calling the
        step.  The same arguments, results and bits, and the generator
        left where `replay` leaves it.  A graph is captured at the first
        call that needs its length; keep the function to reuse them."""
        return captured.replay_fn(captured.Captured(
            self._matcher_scan_step(block), self._draw, self.device))

    def replay_surface_jit(self):
        """`replay_surface` as captured CUDA graphs of step_surface (see
        replay_jit)."""
        return captured.replay_fn(captured.Captured(
            self._surface_scan_step, self._draw, self.device))

    def step_jit(self):
        """`step` as a captured graph, as `RBPF.step_jit`: (state, frame,
        generator=None, draws=None) -> (state, info), the state the
        capture's buffer, consumed and overwritten by the next call.  It
        captures `step` as this instance routes it (the CLI's surface
        engine sets `step` to `step_surface`)."""
        return captured.step_fn(captured.Captured(
            self._routed_scan_step, self._draw, self.device))

    def _routed_scan_step(self, state, frame, draws, out):
        return self.step(state, frame, draws=draws, out=out)

    def _draw(self, generator, out=None):
        return self._draws(generator, None, out)

    def _matcher_scan_step(self, block: int):
        chunk = block or self.config.particle_chunk

        def step(state, frame, draws, out):
            return self._matcher_step(state, frame, chunk, None, draws, out)
        return step

    def _surface_scan_step(self, state, frame, draws, out):
        return self.step_surface(state, frame, draws=draws, out=out)

    def best_map(self, state: SharedMapState):
        """The shared log-odds map (interface parity with RBPF.best_map)."""
        return state.logodds
