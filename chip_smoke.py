#!/usr/bin/env python3
"""Drive the PyTorch port (gridmap_slam_tpu_torch) on one NVIDIA GPU.

Phases, each printed on its own line:

1. device — the card's name and power limit (nvidia-smi) and CUDA version;
2. build  — compile gridmap_slam_tpu_torch/csrc/*.cu with nvcc;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the parity preset (500 particles, 120 x 120 maps,
   2048 bearing bins, the three matcher stages), with its tolerance and
   its time beside the plain version's (CUDA events, after warm-up);
4. agree  — one filter step on the card against the same step in plain
   PyTorch on the CPU, from the same state and draws, on a small input;
5. main   — the parity preset (bench.py --preset parity: 500 particles,
   particle_chunk 250, 180 beams in 192 slots, a 12-scan synthetic
   square-path log, seed 0) through RBPF(cfg, device="cuda").run_log,
   with every kernel's launch count, the ATE and the scans/s of a warm run.

Then one JSON line of kernels, and last {"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no "ok" line.
There is no CPU path: without a CUDA device it exits non-zero.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

K1_RTOL, K1_ATOL = 2e-5, 2e-4     # tests/test_pallas_matcher.py
K1_NEAREST_MAX_FRAC = 1e-3         # nearest-cell rounding ties, see below
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3  # tests/test_pallas.py:124-126
K3_ATOL = 1e-5                     # tests/test_pallas.py:91
ATE_MAX_M = 0.10
N_SCANS = 12
SEED = 0


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        capability=list(torch.cuda.get_device_capability(0)))
    return name


def build_phase() -> None:
    """Compile csrc/*.cu afresh; nvcc's -Xptxas -v report (registers,
    shared memory, spills per kernel) goes to stdout."""
    from gridmap_slam_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    say("build", seconds=time.perf_counter() - t0,
        sources=[str(p.relative_to(_build.CSRC.parents[1]))
                 for p in _build.sources()],
        library=path.name)


def parity_config():
    from gridmap_slam_tpu_torch import SlamConfig
    from gridmap_slam_tpu_torch.config import MapConfig
    return SlamConfig(num_particles=500, max_beams=192, particle_chunk=250,
                      map=MapConfig(width_m=6.0, height_m=6.0,
                                    resolution=0.05, origin=(-3.0, -3.0)))


def parity_log():
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     default_world,
                                                     simulate_log,
                                                     square_path_controls)
    return simulate_log(default_world(), square_path_controls(N_SCANS),
                        params=SimParams(beams_per_rev=180), seed=SEED)


def kernel_phase(cfg, frames):
    """Each kernel against its plain version at the parity shapes."""
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    p, h, w = cfg.num_particles, cfg.map.cells_y, cfg.map.cells_x
    origin, res = cfg.map.origin, cfg.map.resolution
    maxr, zhit = cfg.sensor.max_range, cfg.matcher.z_hit
    # maps with free space, walls and unexplored cells in random places
    u = rng.uniform(size=(p, h, w))
    lo = np.where(u < 0.3, -rng.uniform(0.1, 4.0, (p, h, w)),
                  np.where(u < 0.4, rng.uniform(0.1, 4.0, (p, h, w)), 0.0))
    logodds = torch.as_tensor(lo.astype(np.float32), device=dev)
    poses = torch.as_tensor(np.stack(
        [rng.uniform(-1.5, 1.5, p), rng.uniform(-1.5, 1.5, p),
         rng.uniform(-math.pi, math.pi, p)], 1).astype(np.float32),
        device=dev)
    batch = frames_to_device(frames, cfg.max_beams, maxr, device=dev)
    f0 = frame_at(batch, 0)
    scan = deskew_scan(f0.scan, f0.odom)
    rows = []

    # ---- K3: log-likelihood field
    taps = torch.as_tensor(gaussian_kernel(cfg.map.likelihood_sigma,
                                           cfg.map.likelihood_radius),
                           device=dev)
    kw3 = dict(z_hit=zhit, max_range=maxr)
    got = likelihood.log_likelihood_field_batch_cuda(logodds, taps, **kw3)
    want = likelihood.log_likelihood_field_batch_plain(logodds, taps, **kw3)
    err3 = float((got - want).abs().max())
    ms = cuda_ms(lambda: likelihood.log_likelihood_field_batch_cuda(
        logodds, taps, **kw3), 50)
    plain_ms = cuda_ms(lambda: likelihood.log_likelihood_field_batch_plain(
        logodds, taps, **kw3), 20)
    say("kernel", name="K3 log_likelihood_field", shape=[p, h, w],
        max_abs_err=err3, atol=K3_ATOL, ms=ms, plain_ms=plain_ms)
    if not err3 <= K3_ATOL:
        raise AssertionError(f"K3 max abs error {err3} > {K3_ATOL}")
    rows.append(dict(name="log_likelihood_field", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/likelihood.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/likelihood.py:62",
                     max_abs_err=err3, ms=ms, plain_ms=plain_ms))
    llf = got

    # ---- K2: map update
    tables = grid_update.scan_bin_tables(scan, cfg.beam_lut_bins)
    keep = torch.ones((), device=dev)
    kw2 = dict(resolution=res, origin=origin, l_free=cfg.sensor.l_free,
               l_occ=cfg.sensor.l_occ,
               tol_cells=cfg.sensor.hit_tolerance_cells)
    got = grid_update.integrate_scan_batch_cuda(logodds, poses, keep,
                                                *tables, **kw2)
    want = grid_update.integrate_scan_batch_plain(logodds, poses, keep,
                                                  *tables, **kw2)
    diff = (got - want).abs()
    frac2 = float((diff > K2_ATOL).float().mean())
    err2 = float(diff.max())
    changed = float((want != logodds).float().mean())
    ms = cuda_ms(lambda: grid_update.integrate_scan_batch_cuda(
        logodds, poses, keep, *tables, **kw2), 50)
    plain_ms = cuda_ms(lambda: grid_update.integrate_scan_batch_plain(
        logodds, poses, keep, *tables, **kw2), 20)
    say("kernel", name="K2 integrate_scan", shape=[p, h, w],
        bins=cfg.beam_lut_bins, cells_updated_frac=changed,
        frac_beyond_atol=frac2, atol=K2_ATOL, max_frac=K2_MAX_FRAC,
        max_abs_err=err2, ms=ms, plain_ms=plain_ms)
    if not (frac2 <= K2_MAX_FRAC and changed > 0.01):
        raise AssertionError(f"K2: {frac2} of cells beyond {K2_ATOL} "
                             f"(limit {K2_MAX_FRAC}); {changed} updated")
    rows.append(dict(name="integrate_scan", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/grid_update.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/grid_update.py:170",
                     max_abs_err=err2, ms=ms, plain_ms=plain_ms))

    # ---- K1: the three matcher stages of the parity schedule
    mc = cfg.matcher
    px, py = scan_points(scan)
    use = scan.valid & scan.hit
    stride = mc.coarse_beam_stride
    hll = llf.reshape(p, h // 2, 2, w // 2, 2).mean((2, 4))

    def offs(a, n):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=dev).expand(n, -1).contiguous()

    wt = math.radians(mc.window_theta_deg)
    c_xy = offs(np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy), p)
    c_t = offs(np.linspace(-wt, wt, mc.coarse_nt), p)
    step_xy = 2 * mc.window_xy / (mc.coarse_nxy - 1)
    step_t = 2 * wt / (mc.coarse_nt - 1)
    centers = torch.as_tensor(rng.uniform(-1, 1, (p, 3)).astype(np.float32),
                              device=dev) * torch.tensor(
        [mc.window_xy, mc.window_xy, wt], device=dev)
    stages = [("coarse", hll, px[::stride].contiguous(),
               py[::stride].contiguous(), use[::stride].contiguous(),
               c_xy, c_xy, c_t, 2 * res)]
    for name, k in (("fine", 1.0), ("refine", 0.5)):
        oxy = offs(np.linspace(-k * step_xy, k * step_xy, mc.fine_nxy), p)
        ot = offs(np.linspace(-k * step_t, k * step_t, mc.fine_nt), p)
        stages.append((name, llf, px, py, use, centers[:, :1] + oxy,
                       centers[:, 1:2] + oxy, centers[:, 2:] + ot, res))
    # The nearest-cell branch (coarse_halfres=False) is off the parity path;
    # it is checked but neither timed nor counted in the row.  A tap whose
    # coordinate sits within an ulp of a rounding boundary may pick the
    # neighbouring cell (the plain version on the card divides by the
    # resolution as a multiply by its reciprocal), and with cell-aligned
    # offsets one such tap moves a whole 9 x 9 block of candidates, so that
    # branch may miss the tolerance on at most K1_NEAREST_MAX_FRAC of them.
    stages.append(("coarse nearest", llf) + stages[0][2:-1] + (res,))
    err1, ms1, plain1 = 0.0, 0.0, 0.0
    for name, field, sx, sy, su, dxs, dys, dts, r in stages:
        args = (field, sx, sy, su, poses, dxs, dys, dts)
        nearest = name.endswith("nearest")
        kw1 = dict(resolution=r, origin=origin, max_range=maxr,
                   nearest=nearest)
        got = kmatch.stage_scores_batch_cuda(*args, **kw1)
        want = kmatch.stage_scores_batch_plain(*args, **kw1)
        diff = (got - want).abs()
        err = float(diff.max())
        frac = float((diff > K1_ATOL + K1_RTOL * want.abs()).float().mean())
        ms = cuda_ms(lambda: kmatch.stage_scores_batch_cuda(*args, **kw1), 50)
        plain_ms = cuda_ms(
            lambda: kmatch.stage_scores_batch_plain(*args, **kw1), 10)
        limit = K1_NEAREST_MAX_FRAC if nearest else 0.0
        say("kernel", name=f"K1 stage_scores {name}",
            field=list(field.shape), beams=int(sx.shape[0]),
            candidates=[dts.shape[1], dys.shape[1], dxs.shape[1]],
            max_abs_err=err, rtol=K1_RTOL, atol=K1_ATOL,
            frac_beyond_tol=frac, max_frac=limit, ms=ms, plain_ms=plain_ms)
        if not frac <= limit:
            raise AssertionError(f"K1 {name}: {frac} of candidates beyond "
                                 f"rtol {K1_RTOL} / atol {K1_ATOL} (limit "
                                 f"{limit}; max abs {err})")
        if not nearest:            # the row covers the three parity stages
            err1, ms1, plain1 = max(err1, err), ms1 + ms, plain1 + plain_ms
    rows.append(dict(name="stage_scores", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/matcher.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/matcher.py:287",
                     max_abs_err=err1, ms=ms1, plain_ms=plain1))
    return rows


def agree_phase(frames):
    """One step on the card (kernels) against the same step on the CPU
    (plain versions), from the same state and the same draws."""
    from gridmap_slam_tpu_torch import RBPF, SlamState
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    cfg = parity_config().replace(num_particles=32, particle_chunk=16)
    engines = {d: RBPF(cfg, device=d) for d in ("cuda", "cpu")}
    batches = {d: frames_to_device(frames, cfg.max_beams,
                                   cfg.sensor.max_range, device=d)
               for d in engines}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state, _ = engines["cuda"].run_log(
        engines["cuda"].init(),
        [frame_at(batches["cuda"], i) for i in range(3)], gen)
    rng = np.random.default_rng(SEED)
    normals = rng.standard_normal((cfg.num_particles, 2)).astype(np.float32)
    u0 = np.float32(rng.uniform(0, 1 / cfg.num_particles))
    out = {}
    for d, eng in engines.items():
        st = SlamState(poses=state.poses.to(d),
                       log_weights=state.log_weights.to(d),
                       logodds=state.logodds.to(d), step=state.step.to(d))
        draws = (torch.as_tensor(normals, device=d),
                 torch.as_tensor(u0, device=d))
        out[d] = eng.step(st, frame_at(batches[d], 3), draws=draws)
    (sc, ic), (sp, ip) = out["cuda"], out["cpu"]
    dpose = (sc.poses.cpu() - sp.poses).abs().amax(1)
    pose_frac = float((dpose <= 1e-4).float().mean())
    map_frac = float(((sc.logodds.cpu() - sp.logodds).abs()
                      > K2_ATOL).float().mean())
    say("agree", particles=cfg.num_particles, poses_within_1e4=pose_frac,
        map_cells_beyond_atol=map_frac, neff_cuda=float(ic.neff),
        neff_cpu=float(ip.neff))
    if not (pose_frac >= 0.9 and map_frac <= 0.05):
        raise AssertionError("card and CPU steps disagree")


def main_phase(cfg, frames, gt):
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    kernels = {"stage_scores": kmatch, "integrate_scan": grid_update,
               "log_likelihood_field": likelihood}
    eng = RBPF(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    seq = [frame_at(batch, i) for i in range(len(frames))]

    for mod in kernels.values():
        mod.launches = 0
    state, infos = eng.run_log(
        eng.init(), seq, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in kernels.items()}

    traj = torch.stack([i.weighted_pose for i in infos]).cpu().numpy()
    finite = bool(torch.isfinite(state.poses).all()
                  and torch.isfinite(state.logodds).all()
                  and np.isfinite(traj).all())
    ate = ate_rmse(traj, gt)
    best = eng.best_map(state)
    occ, free = int((best > 0).sum()), int((best < 0).sum())

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    eng.run_log(eng.init(), seq,
                torch.Generator(device="cuda").manual_seed(SEED))
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    say("main", preset="parity", particles=cfg.num_particles,
        map=[cfg.map.cells_y, cfg.map.cells_x], scans=len(seq),
        launches=launches, ate_m=ate, final_neff=float(infos[-1].neff),
        resamples=int(sum(bool(i.resampled) for i in infos)),
        best_map_occupied=occ, best_map_free=free, finite=finite,
        warm_seconds=sec, scans_per_sec=len(seq) / sec)
    if not finite:
        raise AssertionError("non-finite poses or maps")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if not ate < ATE_MAX_M:
        raise AssertionError(f"parity ATE {ate} >= {ATE_MAX_M}")
    if not (occ > 50 and free > 1000):
        raise AssertionError(f"best map too empty: {occ} occupied, "
                             f"{free} free")
    return launches


def main() -> int:
    name = device_phase()
    build_phase()
    cfg = parity_config()
    frames, gt = parity_log()
    rows = kernel_phase(cfg, frames)
    agree_phase(frames)
    launches = main_phase(cfg, frames, gt)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
        for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
