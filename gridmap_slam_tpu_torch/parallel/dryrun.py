"""The multi-rank dry run: one step of every distributed engine on n ranks.

The port's counterpart of the JAX package's __graft_entry__.dryrun_multichip:
the same six stages on tiny shapes, each printing one line — the sharded
RBPF, shmap, shmap-surface, surface-sharded, tiled and the distributed BA.
The ranks are gloo processes on the CPU (device="cpu") or NCCL processes
with one card a rank (device="cuda"); more ranks than cards raises, there
is no fallback.

    from gridmap_slam_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)                  # 4 gloo ranks on the CPU
    dryrun_multichip(4, device="cuda")   # 4 NCCL ranks on 4 cards
"""

from __future__ import annotations

import math

import numpy as np

from .launch import run_ranks


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     timeout: float = 600.0) -> None:
    """Run the six stages on n_devices ranks and print rank 0's lines."""
    backend = "nccl" if device == "cuda" else "gloo"
    outs = run_ranks(n_devices, "gridmap_slam_tpu_torch.parallel.dryrun:"
                     "_stages", backend=backend, device=device,
                     timeout=timeout)
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith("dryrun_multichip(")]
    if len(lines) != 6:
        raise RuntimeError(f"dryrun_multichip({n_devices}) ran "
                           f"{len(lines)} of 6 stages:\n{outs[0][-4000:]}")
    for ln in lines:
        print(ln, flush=True)


def _tiny_frame(cfg, device):
    import torch
    from ..types import Frame, Odom, Scan

    b = cfg.max_beams
    angles = np.linspace(-np.pi, np.pi, b, endpoint=False).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return Frame(scan=Scan(angle=t(angles), dist=t(np.full(b, 2.0,
                                                            np.float32)),
                           hit=t(np.ones(b, bool)), valid=t(np.ones(b, bool))),
                 odom=Odom(d_center=t(np.float32(0.1)),
                           d_theta=t(np.float32(0.02))),
                 t=t(np.float32(0.0)))


def _relative(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    dt = math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))
    return [c * dx + s * dy, -s * dx + c * dy, dt]


def _stages(payload: str, rank: int, n: int) -> None:
    """One rank of the dry run (launch.run_ranks calls it with the world
    up)."""
    import torch
    import torch.distributed as dist

    from ..config import MapConfig, SlamConfig
    from ..models.posegraph import odometry_edges
    from ..models.rbpf import RBPF
    from ..models.shared import SharedMapSLAM
    from .ba import make_distributed_optimizer, pad_edges, shard_graph
    from .mesh import make_mesh
    from .sharded import init_sharded, make_sharded_step
    from .shmap import init_shmap, make_shmap_step
    from .surface_sharded import (init_surface_sharded,
                                  make_surface_sharded_step)
    from .tiled import init_tiled, make_tiled_step

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    say = print if rank == 0 else (lambda *a, **k: None)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    shards = 2 if n % 2 == 0 else 1
    cfg = SlamConfig(num_particles=4 * n, max_beams=64,
                     map=MapConfig(width_m=3.2, height_m=3.2,
                                   resolution=0.05, origin=(-1.6, -1.6)))
    frame = _tiny_frame(cfg, device)

    def check(info, state, what):
        neff = float(info.neff)
        if not (np.isfinite(neff)
                and bool(torch.isfinite(state.poses).all())):
            raise AssertionError(f"{what}: non-finite Neff or poses")
        return neff

    mesh = make_mesh(n, map_shards=shards, device=device)
    eng = RBPF(cfg, device=device)
    st, info = make_sharded_step(eng, mesh)(init_sharded(eng, mesh), frame,
                                            gen(0))
    say(f"dryrun_multichip({n}): sharded RBPF ok, mesh={tuple(mesh.shape)}, "
        f"neff={check(info, st, 'sharded'):.2f}", flush=True)

    mesh1 = make_mesh(n, map_shards=1, device=device)
    eng2 = SharedMapSLAM(cfg, device=device)
    st, info = make_shmap_step(eng2, mesh1)(init_shmap(eng2, mesh1), frame,
                                            gen(1))
    say(f"dryrun_multichip({n}): shmap collectives ok, "
        f"neff={check(info, st, 'shmap'):.2f}", flush=True)

    eng2s = SharedMapSLAM(cfg.with_overrides({"matcher.surface_nt": 7}),
                          device=device)
    st, info = make_shmap_step(eng2s, mesh1, surface=True)(
        init_shmap(eng2s, mesh1), frame, gen(3))
    say(f"dryrun_multichip({n}): surface shmap ok, "
        f"neff={check(info, st, 'shmap surface'):.2f}", flush=True)

    mesh_t = make_mesh(n, map_shards=max(n // 2, 1), device=device)
    eng2c = SharedMapSLAM(cfg.with_overrides(
        {"matcher.surface_nt": 7, "matcher.surface_crop_cells": 48}),
        device=device)
    st, info = make_surface_sharded_step(eng2c, mesh_t)(
        init_surface_sharded(eng2c, mesh_t), frame, gen(4))
    say(f"dryrun_multichip({n}): map-sharded surface ok, "
        f"mesh={tuple(mesh_t.shape)}, "
        f"neff={check(info, st, 'surface sharded'):.2f}", flush=True)

    eng3 = SharedMapSLAM(cfg, device=device)
    st, info = make_tiled_step(eng3, mesh_t)(init_tiled(eng3, mesh_t),
                                             frame, gen(2))
    say(f"dryrun_multichip({n}): tiled halo-exchange ok, "
        f"mesh={tuple(mesh_t.shape)}, "
        f"neff={check(info, st, 'tiled'):.2f}", flush=True)

    k = 2 * n
    theta = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.stack([np.cos(theta), np.sin(theta), theta + np.pi / 2],
                  1).astype(np.float32)
    ei, ej, ez, ew = odometry_edges(gt)
    ei = np.concatenate([ei, [k - 1]]).astype(np.int32)
    ej = np.concatenate([ej, [0]]).astype(np.int32)
    ez = np.concatenate([ez, [_relative(gt[k - 1], gt[0])]]).astype(
        np.float32)
    ew = np.concatenate([ew, [[400.0, 400.0, 800.0]]]).astype(np.float32)
    drift = np.linspace(0, 0.3, k)[:, None] * np.asarray([1.0, -0.5, 0.2])
    graph = shard_graph((gt + drift,) + pad_edges(ei, ej, ez, ew, n), mesh1,
                        device=device)
    _, chi2 = make_distributed_optimizer(mesh1, iterations=5)(graph)
    chi2 = chi2.cpu().numpy()
    if not (np.isfinite(chi2).all() and chi2[-1] <= chi2[0]):
        raise AssertionError(f"distributed BA: chi2 {chi2}")
    say(f"dryrun_multichip({n}): distributed BA ok, "
        f"chi2 {chi2[0]:.3f} -> {chi2[-1]:.3f}", flush=True)
