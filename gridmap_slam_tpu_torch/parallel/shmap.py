"""The shared-map engine over ranks, every exchange an explicit collective.

Counterpart of gridmap_slam_tpu/parallel/shmap.py (shard_map + psum /
all_gather): particles (poses, log-weights) are split over mesh axis 'p',
the shared map is replicated.  A rank's step:

- motion sampling and matching of its particles, no communication: K3
  once on the replicated map, then K1 at G_f = 1 over the local particles
  in blocks (`SharedMapSLAM.match`, the blocks of step_blocked); or, with
  surface=True, the likelihood volume built redundantly on every rank
  around the previous cloud's global weighted mean propagated by the
  odometry (models/shared.surface_volume), its window placed by F7's mesh
  form's center call (a pmax and two psums over 'p'), and tapped by the
  local particles;
- weight statistics: F7's mesh form (ops/cuda/fusions.weights_mesh), its
  passes over the local rows with one pmax and two psums over 'p' between
  them (the normalizer; then Neff's sum and the weighted pose in one
  vector);
- strongest particle: an all_gather of each rank's (score, pose, index),
  which F7's epilogue reads with the integration pose, the gate, the
  recovery EMAs and the map update's crop;
- map update: K2 at batch 1, redundantly on every rank from the agreed
  integration pose (into the crop around it in surface mode, K2's window
  variant placed on the card);
- resampling: the JAX step's lax.cond as models/captured.cond.  Its body
  is what JAX puts inside the cond: on more than one rank the all_gather
  of every rank's (log-weight, pose) rows (and, for the sharded RBPF, map
  tiles), F8's mesh form (the walk of the gathered log-weights from the
  shared draw u0, this rank's slots of it and the gathers), and the
  injection with its psum; on one rank F8 from F7's max and total.  The
  compiled step (jit=True) runs it as a CUDA-graph IF node a scan on the
  card, so a replay calls no resample collective on a scan whose gate
  does not fire, with no host read; the
  eager step on the card is the select on one rank (no host read, no
  collective in the body) and on more ranks reads the gate on the host
  once a scan; on the CPU the gate is a Python branch
  (parallel/comm_model.py counts the rows as the JAX comm model does);
- the AMCL recovery injection replaces the global slots
  [0, p_inject * P) (inject_uniform's slot_offset).

Draws: every rank draws the global (P, ...) tensors of
SharedMapSLAM._draws from a generator seeded the same on every rank and
takes its slice, so an n-rank run has the single-device engine's draws; a
`draws=` argument takes injected ones (the JAX layout, in the tests).  On
a mesh (1, 1) the step gives the single-device engine's bits
(`step_blocked`, `step_surface`).

Every engine of parallel/ returns a `MeshStep`: eager, or compiled
(jit=True, the counterpart of the JAX engines' jax.jit: the step over
static buffers, one CUDA graph on the card with the NCCL collectives in
it), with `replay` / `replay_jit` over a stacked Frame batch.

The engines take a SharedMapSLAM, which refuses recovery injection together
with accumulate_weights=True (the JAX engines feed the recovery EMAs the
max log-weight after accumulation, gridmap_slam_tpu/parallel/shmap.py:139),
so no distributed engine runs that configuration either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from ..models import captured
from ..models.shared import (SharedMapSLAM, SharedMapState, inject_uniform,
                             match_particles, matcher_block_size,
                             reinject_rates, surface_volume,
                             volume_window_spec)
from ..ops.cuda import fusions
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.motion import sample_motion
from ..ops.resample import systematic_indices
from ..types import Frame, StepInfo
from .mesh import (all_gather, axis_index, axis_size, pmax, psum,
                   shard_state)


def local_particles(engine, mesh) -> int:
    """P / n_p, the particles a rank holds; raises unless n_p divides P."""
    p, n_p = engine.config.num_particles, axis_size(mesh, "p")
    if p % n_p:
        raise ValueError(f"{p} particles do not split over {n_p} ranks")
    return p // n_p


def local_draws(engine, mesh, draws):
    """This rank's slice of one scan's global draws (SharedMapSLAM._draws:
    normals (P, 2), u0, injection uniforms (P, 3) or None)."""
    normals, u0, inj = draws
    p_loc = local_particles(engine, mesh)
    sl = slice(axis_index(mesh, "p") * p_loc,
               (axis_index(mesh, "p") + 1) * p_loc)
    return normals[sl], u0, None if inj is None else inj[sl]


class MeshStep:
    """A distributed engine's step, eager or compiled, over its scan body
    body(state, frame, draws, out, host_gate) -> (state, info), where
    `draws` are one scan's global draws (each rank takes its slice) and
    `out`, when given, a state that receives the new state (it may be
    `state` itself: the body writes each field of `out` after its last
    read of that field).  `host_gate`: on a 'p' axis of more than one rank
    the resample gate is read on the host (finish_step), else it is
    captured.cond.

    Calling it: step(state, frame, generator=None, draws=None) -> (state,
    info) on this rank's shard.  Eager (jit=False): the body on the draws
    of `draw(generator)`, host_gate=True.  Compiled (jit=True): the
    counterpart of the JAX engines' jax.jit, the body over static buffers
    (models/captured.Captured) with the gate as captured.cond, one CUDA
    graph on the card with the NCCL collectives inside it and the
    resample's in an IF node, captured at the first call, and the same
    static-buffer body on the CPU; the state it returns is the capture's
    buffer, which the next call consumes and overwrites
    (captured.step_fn).

    `replay` runs a stacked Frame batch eagerly (captured.scan, stacked
    infos), `replay_jit()` gives its captured form; the counterparts of the
    JAX step composed under lax.scan."""

    def __init__(self, body, draw, device, jit: bool = False):
        self._eager = functools.partial(body, host_gate=True)
        self._compiled = functools.partial(body, host_gate=False)
        self._draw = draw
        self.device = torch.device(device)
        self.captured = None
        if jit:
            self.captured = captured.Captured(self._compiled, draw,
                                              self.device)
            self._step = captured.step_fn(self.captured)

    def __call__(self, state, frame, generator=None, draws=None):
        if self.captured is not None:
            return self._step(state, frame, generator, draws)
        return self._eager(state, frame,
                           self._draw(generator) if draws is None else draws,
                           None)

    def replay(self, state, frames, generator=None, draws=None):
        """The eager replay of a stacked Frame batch: (final state, infos
        stacked along a leading frame axis); `draws` stacked global draws
        in place of the generator's."""
        return captured.scan(self._eager, self._draw, state, frames,
                             generator, draws)

    def replay_jit(self):
        """`replay` with the whole log replayed as captured graphs of at
        most captured.CHUNK_SCANS scans of the compiled body, launched in
        turn, their draws and collectives inside: the same arguments,
        results and bits.  Keep the function to reuse its graphs."""
        return captured.replay_fn(captured.Captured(
            self._compiled, self._draw, self.device))


def collectives(mesh) -> fusions.Collectives:
    """The collectives over 'p' that F7's mesh form calls between its
    passes (ops/cuda/fusions.Collectives)."""
    return fusions.Collectives(
        pmax=functools.partial(pmax, mesh=mesh, axis="p"),
        psum=functools.partial(psum, mesh=mesh, axis="p"),
        all_gather=functools.partial(all_gather, mesh=mesh, axis="p"))


def mesh_window(state, odom, mesh, spec):
    """The surface volume's Window (ops/cuda/fusions.WindowSpec `spec`, a
    volume's) around the previous cloud's weighted mean over every rank's
    particles, propagated by the odometry: F7's mesh form's center call
    (its pmax and two psums over 'p'), which places the window on the
    card.  Each rank's sums take ops/resample's fixed order, so that a 'p'
    axis of one rank gives the single-device engines' window bits."""
    return fusions.weights_mesh(state.log_weights, state.poses,
                                collectives(mesh), center=True, window=spec,
                                odom=odom).volume


def _global_mean(x, mesh, n_total: int):
    """The mean of x over every rank of 'p' (x.mean() on one rank)."""
    if axis_size(mesh, "p") == 1:
        return x.mean()
    return psum(x.sum(), mesh, "p") / n_total


def finish_step(engine, mesh, state, poses, scores, integrate: Callable,
                u0, inj, resample_fraction: float, maps=None, out=None,
                host_gate: bool = False, crop=None):
    """The tail every distributed engine shares, on this rank's particles:
    F7's mesh form (the weights, the global statistics over 'p', the
    strongest particle, the integration pose, the resample gate and the
    recovery EMAs, and the map update's window `crop`, a WindowSpec or
    None), the map update `integrate(integration_pose, into, win)` (into:
    the map that receives it, or None; win: F7's crop corner or None), the
    injection (shared-map states), and the resample, which carries `maps`
    (the sharded RBPF's local maps) with the poses when given.  Each field
    of `out`, where given, is written after its last read of `state`.

    The resample is the JAX step's lax.cond: captured.cond (an IF node
    under capture, a select eagerly on the card, a Python branch on the
    CPU) over a body that, on a 'p' axis of more than one rank, gathers
    every rank's (log-weight, pose) rows (and maps) first and walks them
    (F8's mesh form: this rank's slots of the walk over all of them), so
    that no resample collective runs where the gate does not fire.  With
    host_gate=True (the eager step) a 'p' axis of more than one rank reads
    the gate on the host once a scan instead.  On one rank the walk is F8
    from F7's max and total: the sharded RBPF takes RBPF.step's form (the
    ancestors' indices, poses and weights under the gate, then its maps
    gathered once at the indices) and the shared-map engines
    SharedMapSLAM._finish's (the identity's rows, overwritten where the
    gate fires); on more ranks the sharded RBPF's `maps` may be
    `out.logodds` itself, which the body overwrites from the gathered
    tiles.  On the CPU the walks' plain versions draw the ancestors by this
    module's systematic_indices.  Returns (new_state, info)."""
    cfg = engine.config
    p = cfg.num_particles
    p_loc = poses.shape[0]
    i_p, n_p = axis_index(mesh, "p"), axis_size(mesh, "p")
    dev = poses.device

    def into(name):
        return None if out is None else getattr(out, name)

    lw = scores.to(state.log_weights.dtype)
    if cfg.accumulate_weights:
        lw = lw + state.log_weights

    # the weights' tail over every rank (F7's mesh form on the card): the
    # pmax, psums and all_gather between its passes, then its epilogue
    shared = isinstance(state, SharedMapState)
    rates = reinject_rates(cfg) if shared else None
    tail = fusions.weights_mesh(
        lw, poses, collectives(mesh), resample_fraction=resample_fraction,
        recov=None if rates is None else state.recov, step=state.step,
        reinject=rates or (0.0, 0.0), window=crop)
    logodds = integrate(tail.integ_pose, into("logodds"), tail.crop)
    # a kidnap makes every particle uniformly bad, so Neff rises and the
    # gate alone would never fire: injection forces a resample (the
    # epilogue's gate)
    do_resample, p_inject = tail.gate, tail.p_inject
    recov = None
    if shared:
        recov = state.recov if tail.recov is None else tail.recov
        if out is not None:
            recov = captured.copy_into(out.recov, recov)
    new_step = torch.add(state.step, 1, out=into("step"))

    def gate(body, outs):
        if n_p > 1 and host_gate:                   # one host read
            if bool(do_resample):
                body()
        else:
            captured.cond(do_resample, body, outs)

    base = i_p * p_loc
    acc = cfg.accumulate_weights
    # the walks' plain versions draw by this module's systematic_indices
    # (the kernels draw their own)
    draw = None if dev.type == "cuda" else systematic_indices
    # the identity's rows land in `out` (or new tensors), and the resample
    # overwrites them where the gate fires
    new_poses = (poses.clone() if out is None
                 else captured.copy_into(out.poses, poses))
    new_lw = (lw.clone() if out is None
              else captured.copy_into(out.log_weights, lw))
    if maps is not None and n_p == 1:
        # RBPF.step's form: the ancestors' indices, poses and weights (or,
        # accumulating, the weights' reset) under the gate, the identity
        # where it does not fire; then the maps move once, gathered at
        # those indices
        idx = torch.arange(p_loc, device=dev)

        def resample():
            fusions.walk(lw, u0, poses, tail.max, tail.total,
                         gather_weights=not acc,
                         out=(idx, new_poses, None if acc else new_lw),
                         draw=draw)
            if acc:
                new_lw.zero_()

        gate(resample, [idx, new_poses, new_lw])
        new_maps = torch.index_select(maps, 0, idx, out=into("logodds"))
        best_lw = new_lw.max()
    else:
        # SharedMapSLAM._finish's form
        new_maps = (maps if maps is None or out is None
                    else captured.copy_into(out.logodds, maps))
        best_lw = tail.max.clone() if n_p > 1 else None
        idx = (None if maps is None
               else torch.empty(p_loc, dtype=torch.int64, device=dev))

        def resample():
            walked = (None if acc else new_lw)
            if n_p == 1:
                fusions.walk(lw, u0, poses, tail.max, tail.total,
                             gather_weights=not acc,
                             out=(None, new_poses, walked),
                             draw=draw)
            else:
                rows = all_gather(torch.cat([lw[:, None], poses], 1), mesh,
                                  "p", tiled=True)
                maps_all = (None if maps is None
                            else all_gather(maps, mesh, "p", tiled=True))
                fusions.walk_mesh(rows, u0, base=base, count=p_loc,
                                  gather_weights=not acc,
                                  out=(idx, new_poses, walked),
                                  draw=draw)
                if maps is not None:
                    torch.index_select(maps_all, 0, idx, out=new_maps)
            if acc:
                new_lw.zero_()
            if p_inject is not None:
                inj_poses, took = inject_uniform(cfg, inj, new_poses,
                                                 p_inject, slot_offset=base)
                new_poses.copy_(inj_poses)
                new_lw.copy_(torch.where(took, _global_mean(new_lw, mesh, p),
                                         new_lw))
            if n_p > 1:
                best_lw.copy_(pmax(new_lw.max(), mesh, "p"))

        gate(resample, [x for x in (new_poses, new_lw, new_maps, best_lw)
                        if x is not None])
        if n_p == 1:
            best_lw = new_lw.max()

    fields = dict(poses=new_poses, log_weights=new_lw,
                  logodds=logodds if new_maps is None else new_maps,
                  step=new_step)
    if recov is not None:
        fields["recov"] = recov
    new_state = out if out is not None else dataclasses.replace(state,
                                                                **fields)
    info = StepInfo(neff=tail.neff, weighted_pose=tail.weighted,
                    best_pose=tail.best_pose,
                    best_index=tail.best_index.to(torch.int32),
                    best_log_weight=best_lw, resampled=do_resample)
    return new_state, info


def make_shmap_step(engine: SharedMapSLAM, mesh, surface: bool = False,
                    jit: bool = False) -> MeshStep:
    """The step of the shared-map engine over `mesh`'s 'p' axis (the 'm'
    axis must be 1: the map is replicated), a MeshStep (eager, or with
    jit=True compiled) on this rank's shard (init_shmap).  surface=True
    runs step_surface's measurement model; else the matcher in blocks of
    matcher_block_size particles, lowered to a divisor of the local
    count."""
    if axis_size(mesh, "m") != 1:
        raise ValueError("shmap replicates the map: the mesh's 'm' axis "
                         "must be 1 (use tiled or surface_sharded)")
    cfg = engine.config
    p_loc = local_particles(engine, mesh)
    chunk = min(matcher_block_size(cfg), p_loc)
    while p_loc % chunk:
        chunk -= 1

    spec = volume_window_spec(cfg) if surface else None

    def body(state: SharedMapState, frame: Frame, draws, out, host_gate):
        mc = cfg.matcher
        normals, u0, inj = local_draws(engine, mesh, draws)
        prep = engine._scan_inputs(frame)
        odom = frame.odom
        if surface:
            # the volume's window around the mesh's weighted mean (F7's
            # mesh form's center call); the temperature inside F4
            c_vol, kw, kc = surface_volume(
                cfg, engine.taps, state.logodds, prep,
                window=mesh_window(state, odom, mesh, spec))
            pose_s = sample_motion(state.poses, odom, cfg.motion, normals)
            poses, scores = fusions.score_on_volume(
                c_vol, pose_s, steps=mc.surface_refine_steps, **kw)
            crop, fraction = 2 * kc + 8, mc.surface_resample_fraction
        else:
            llf = log_likelihood_field_batch(
                state.logodds[None], engine.taps, z_hit=mc.z_hit,
                max_range=cfg.sensor.max_range)
            poses, scores = match_particles(cfg, llf, state.poses, normals,
                                            prep, odom, chunk)
            crop, fraction = 0, cfg.resample_fraction

        def integrate(pose, into, win):
            return engine._integrate(state.logodds, pose, prep.tables,
                                     prep.keep, crop, out=into, win=win)

        return finish_step(engine, mesh, state, poses, scores, integrate,
                           u0, inj, fraction, out=out, host_gate=host_gate,
                           crop=engine._crop_spec(crop))

    return MeshStep(body, engine._draw, engine.device, jit)


def init_shmap(engine: SharedMapSLAM, mesh, pose=(0.0, 0.0, 0.0)):
    """This rank's shard of engine.init(pose)."""
    return shard_state(engine.init(pose), mesh, tiled=False,
                       device=engine.device)


__all__ = ["make_shmap_step", "init_shmap", "finish_step", "MeshStep",
           "collectives", "mesh_window", "local_draws", "local_particles"]
