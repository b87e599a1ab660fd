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
   with every kernel's launch count, the ATE and the scans/s of a warm run;
6. k3 radii — K3 against its plain version at blur radius 3, 12 and 30
   (sigma 1, 4 and 10 cells), 60 (above the 48 KB shared-memory opt-in)
   and 180 (the tile shrunk to 16), 500 maps of 120 x 120;
7. surface ops — at the mega shapes (25 theta bins, a 405 x 405 endpoint
   kernel, a 120 x 120 field): the FFT correlation on the card against the
   same call on the CPU; the direct (conv2d) correlation with PyTorch's
   default TF32 flag on, against the CPU and the FFT; the 8-tap and the
   packed trilinear sample at 1M poses; times of the volume build, both
   sample paths and the FFT at the exact, 5-smooth and power-of-two
   lengths of the mega and city volumes;
8. surface agree — one surface-mode step on the card against the same step
   on the CPU, from the same state and draws, at 4096 particles;
9. mega   — SharedMapSLAM(mega_config(), device="cuda").run_log: 1M
   particles on the 120 x 120 map over the 12-scan log, then over the 40
   scans of maps/room_loop_40.rec; a second run with the same seed must
   give bit-identical poses and map;
10. city  — the same with city_config(): 1M particles on the 4000 x 4000
   map, the volume over a 512-cell crop;
11. city kernels — K3 and K2 against their plain versions on the arguments
   one city step passes them: K3 on the (1, 518, 518) crop plus blur
   radius, K2 on the 412 x 412 integration crop with its shifted origin.

Each path (parity, mega, city) is run with every launch count set to 0
just before it and read just after.  Then one JSON line of kernels, with
their launches per path, and last {"ok": true, "device": {...}}.
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
ROOM_LOOP_ATE_MAX_M = 0.25         # ROADMAP item 11: 40 scans at 1M
N_SCANS = 12
SEED = 0
FFT_ATOL, FFT_MEAN = 5e-2, 5e-3    # tests/test_surface.py:223-224
DIRECT_RTOL, DIRECT_ATOL = 1e-5, 1e-3
TAPS_RTOL, TAPS_ATOL = 1e-6, 1e-5  # tests/test_surface.py:248-249
SPLAT_RTOL = 1e-5                  # of the largest endpoint-image cell
K3_RADII_SIGMAS = (1.0, 4.0, 10.0, 20.0, 60.0)
AGREE_PARTICLES = 4096


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
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    kernels = _kernel_modules()
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


def _kernel_modules():
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    return {"stage_scores": kmatch, "integrate_scan": grid_update,
            "log_likelihood_field": likelihood}


def _test_maps(p, h, w, rng):
    """Log-odds maps with free space, walls and unexplored cells in random
    places, and an unexplored band on every other map."""
    u = rng.uniform(size=(p, h, w))
    lo = np.where(u < 0.3, -rng.uniform(0.1, 4.0, (p, h, w)),
                  np.where(u < 0.4, rng.uniform(0.1, 4.0, (p, h, w)), 0.0))
    lo[::2, :, :w // 2] = 0.0
    return torch.as_tensor(lo.astype(np.float32), device="cuda")


def k3_radii_phase(cfg):
    """K3 against its plain version at the blur radii of surface-mode
    relocalization (config.py: sigma 0.2-0.5 m is 4-10 cells at 5 cm), and
    at radius 60 and 180, where the kernel opts in to more than 48 KB of
    shared memory and then shrinks its tile."""
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

    p, h, w = cfg.num_particles, cfg.map.cells_y, cfg.map.cells_x
    logodds = _test_maps(p, h, w, np.random.default_rng(SEED + 1))
    kw = dict(z_hit=cfg.matcher.z_hit, max_range=cfg.sensor.max_range)
    for sigma in K3_RADII_SIGMAS:
        radius = int(math.ceil(3 * sigma))
        taps = torch.as_tensor(gaussian_kernel(sigma, radius), device="cuda")
        got = likelihood.log_likelihood_field_batch_cuda(logodds, taps, **kw)
        want = likelihood.log_likelihood_field_batch_plain(logodds, taps,
                                                           **kw)
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: likelihood.log_likelihood_field_batch_cuda(
            logodds, taps, **kw), 20)
        plain_ms = cuda_ms(lambda: likelihood.log_likelihood_field_batch_plain(
            logodds, taps, **kw), 5)
        say("k3_radius", sigma_cells=sigma, radius=radius,
            tile=likelihood.tile(radius), shape=[p, h, w],
            max_abs_err=err, atol=K3_ATOL, ms=ms,
            plain_ms=plain_ms)
        if not err <= K3_ATOL:
            raise AssertionError(f"K3 at radius {radius}: max abs error "
                                 f"{err} > {K3_ATOL}")


def surface_setup(frames):
    """A 4096-particle engine on the mega preset, run 3 scans on the card
    so the shared map holds walls and free space; with the frames on both
    devices."""
    from gridmap_slam_tpu_torch import SharedMapSLAM, mega_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    cfg = mega_config().replace(num_particles=AGREE_PARTICLES)
    eng = SharedMapSLAM(cfg, device="cuda")
    batches = {d: frames_to_device(frames, cfg.max_beams,
                                   cfg.sensor.max_range, device=d)
               for d in ("cuda", "cpu")}
    state, _ = eng.run_log(
        eng.init(), [frame_at(batches["cuda"], i) for i in range(3)],
        torch.Generator(device="cuda").manual_seed(SEED))
    return eng, batches, state


def _smooth5(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= n."""
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def _close(got, want, rtol, atol):
    diff = (got - want).abs()
    return (float(diff.max()), float(diff.mean()),
            bool((diff <= atol + rtol * want.abs()).all()))


def surface_ops_phase(eng, batches, state):
    """The surface ops at the mega shapes, on the card."""
    import torch.nn.functional as F

    from gridmap_slam_tpu_torch.io import frame_at
    from gridmap_slam_tpu_torch.models.shared import surface_volume
    from gridmap_slam_tpu_torch.ops import surface as sf
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu_torch.ops.motion import apply_odometry
    from gridmap_slam_tpu_torch.ops.resample import weighted_mean_pose

    cfg = eng.config
    mc = cfg.matcher
    res, maxr = cfg.map.resolution, cfg.sensor.max_range
    ll_out = math.log(1.0 / maxr)
    f = frame_at(batches["cuda"], 3)
    scan = deskew_scan(f.scan, f.odom)
    center = apply_odometry(weighted_mean_pose(state.poses,
                                               state.log_weights), f.odom)
    volume_ms = cuda_ms(lambda: surface_volume(cfg, eng.taps, state.logodds,
                                               scan, center), 10)
    c_vol, kw, kc = surface_volume(cfg, eng.taps, state.logodds, scan, center)

    # the pieces of the volume, to hold each mode against the CPU
    llf = likelihood.log_likelihood_field_batch(
        state.logodds[None], eng.taps, z_hit=mc.z_hit, max_range=maxr)[0]
    px, py = scan_points(scan)
    wgt = (scan.valid & scan.hit).to(torch.float32)
    thetas = kw["theta0"] + kw["dtheta"] * torch.arange(
        mc.surface_nt, dtype=torch.float32, device="cuda")
    e = sf.splat_endpoint_kernels(px, py, wgt, thetas, kc, res)
    fft_gpu = sf.scan_surface(llf, e, ll_out, fft=True)
    fft_cpu = sf.scan_surface(llf.cpu(), e.cpu(), ll_out, fft=True)
    fft_err, fft_mean, _ = _close(fft_gpu.cpu(), fft_cpu, 0.0, FFT_ATOL)
    vol_err = float((c_vol - fft_gpu).abs().max())

    # the direct correlation at a small shape, under PyTorch's default TF32
    # flags: scan_surface and the splat must pin float32 themselves.  Only
    # the beams inside the small kernel are weighted (a beam past it would
    # clamp to the rim with bilinear weights far outside [0, 1]).
    small_kc, small = 40, 64
    llf_s = llf[:small, :small].contiguous()
    wgt_s = wgt * (scan.dist < (small_kc - 2) * res).to(torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        e_s = sf.splat_endpoint_kernels(px, py, wgt_s, thetas, small_kc, res)
        direct_gpu = sf.scan_surface(llf_s, e_s, ll_out)
        fpad = F.pad(llf_s, (small_kc,) * 4, value=ll_out)
        tf32_gpu = F.conv2d(fpad[None, None], e_s[:, None])[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    e_s_cpu = sf.splat_endpoint_kernels(px.cpu(), py.cpu(), wgt_s.cpu(),
                                        thetas.cpu(), small_kc, res)
    splat_max = float(e_s_cpu.abs().max())
    splat_err = float((e_s.cpu() - e_s_cpu).abs().max())
    direct_cpu = sf.scan_surface(llf_s.cpu(), e_s_cpu, ll_out)
    fft_s = sf.scan_surface(llf_s, e_s, ll_out, fft=True)
    d_err, _, d_ok = _close(direct_gpu.cpu(), direct_cpu, DIRECT_RTOL,
                            DIRECT_ATOL)
    df_err, df_mean, _ = _close(direct_gpu, fft_s, 0.0, FFT_ATOL)
    tf32_err = float((tf32_gpu.cpu() - direct_cpu).abs().max())

    # the two trilinear sample paths at 1M poses around the cloud, some
    # past the volume's span
    rng = np.random.default_rng(SEED + 2)
    n = 1_000_000
    noise = rng.uniform(-1, 1, (n, 3)) * np.array([1.0, 1.0, 0.6])
    poses = center + torch.as_tensor(noise.astype(np.float32), device="cuda")
    taps_kw = {k: v for k, v in kw.items() if k != "packed"}
    s_taps = sf.sample_surface(c_vol, poses, **taps_kw)
    s_pack = sf.sample_surface(c_vol, poses, **kw)
    t_err, _, t_ok = _close(s_pack, s_taps, TAPS_RTOL, TAPS_ATOL)
    taps_ms = cuda_ms(lambda: sf.sample_surface(c_vol, poses, **taps_kw), 10)
    pack_ms = cuda_ms(lambda: sf.sample_surface(c_vol, poses, **kw), 10)
    pack_build_ms = cuda_ms(lambda: sf.pack_neighborhoods(
        c_vol, kw["wrap_theta"]), 10)

    # the FFT at the exact, 5-smooth and power-of-two lengths of the mega
    # (120-cell field) and city (512-cell crop) volumes
    crop = torch.as_tensor(rng.uniform(-3.0, -1.0, (512, 512)).astype(
        np.float32), device="cuda")
    def fft_corr(fpad, n):
        """scan_surface's FFT correlation at transform length n."""
        f_hat = torch.fft.rfft2(fpad, s=(n, n))
        e_hat = torch.fft.rfft2(e, s=(n, n))
        return torch.fft.irfft2(f_hat[None] * torch.conj(e_hat), s=(n, n))

    fft_ms = {}
    for field in (llf, crop):
        fpad = F.pad(field, (kc,) * 4, value=ll_out)
        exact = fpad.shape[0]
        for length in (exact, _smooth5(exact), 1 << (exact - 1).bit_length()):
            fft_ms[str(length)] = cuda_ms(lambda: fft_corr(fpad, length), 5)
    say("surface_ops", nt=mc.surface_nt, kernel=2 * kc + 1,
        field=list(llf.shape), fft_len=sf._fft_size(llf.shape[0] + 2 * kc),
        fft_vs_cpu_max_abs=fft_err, fft_vs_cpu_mean_abs=fft_mean,
        volume_vs_fft_max_abs=vol_err, small_direct_kernel=2 * small_kc + 1,
        small_field=small, splat_max_abs=splat_max,
        splat_tf32_on_vs_cpu_max_abs=splat_err,
        direct_tf32_on_vs_cpu_max_abs=d_err,
        direct_vs_fft_max_abs=df_err, direct_vs_fft_mean_abs=df_mean,
        raw_conv2d_tf32_vs_cpu_max_abs=tf32_err,
        sample_poses=n, packed_vs_taps_max_abs=t_err,
        volume_build_ms=volume_ms, sample_taps_ms=taps_ms,
        sample_packed_ms=pack_ms, pack_build_ms=pack_build_ms,
        fft_ms_by_length=fft_ms)
    if not (fft_err <= FFT_ATOL and fft_mean < FFT_MEAN):
        raise AssertionError(f"FFT volume card vs CPU: max {fft_err}, "
                             f"mean {fft_mean}")
    if not vol_err <= 1e-4:
        raise AssertionError(f"surface_volume differs from its pieces by "
                             f"{vol_err}")
    # float32 sums in another order stay within a few ulps of the largest
    # splat cell; TF32 (10-bit mantissa) would miss by ~1e-3 of it
    if not (d_ok and splat_err <= SPLAT_RTOL * splat_max):
        raise AssertionError(f"direct correlation not float32 with TF32 "
                             f"flags on: {d_err} (splat {splat_err})")
    if not (df_err <= FFT_ATOL and df_mean < FFT_MEAN):
        raise AssertionError(f"direct vs FFT on the card: max {df_err}, "
                             f"mean {df_mean}")
    if not t_ok:
        raise AssertionError(f"packed vs 8-tap sample: max {t_err}")


def surface_agree_phase(eng, batches, state):
    """One surface step on the card against the same step on the CPU, from
    the same state and draws."""
    from gridmap_slam_tpu_torch import SharedMapSLAM, SharedMapState
    from gridmap_slam_tpu_torch.io import frame_at

    cfg = eng.config
    p = cfg.num_particles
    engines = {"cuda": eng, "cpu": SharedMapSLAM(cfg, device="cpu")}
    rng = np.random.default_rng(SEED)
    normals = rng.standard_normal((p, 2)).astype(np.float32)
    u0 = np.float32(rng.uniform(0, 1 / p))
    out = {}
    for d, e in engines.items():
        st = SharedMapState(poses=state.poses.to(d),
                            log_weights=state.log_weights.to(d),
                            logodds=state.logodds.to(d), step=state.step.to(d),
                            recov=state.recov.to(d))
        draws = (torch.as_tensor(normals, device=d),
                 torch.as_tensor(u0, device=d), None)
        out[d] = e.step_surface(st, frame_at(batches[d], 3), draws=draws)
    (sc, ic), (sp, ip) = out["cuda"], out["cpu"]
    dpose = (sc.poses.cpu() - sp.poses).abs().amax(1)
    pose_frac = float((dpose <= 1e-4).float().mean())
    map_frac = float(((sc.logodds.cpu() - sp.logodds).abs()
                      > K2_ATOL).float().mean())
    say("surface_agree", particles=p, poses_within_1e4=pose_frac,
        map_cells_beyond_atol=map_frac, neff_cuda=float(ic.neff),
        neff_cpu=float(ip.neff), resampled=[bool(ic.resampled),
                                            bool(ip.resampled)])
    if not (pose_frac >= 0.9 and map_frac <= 0.05):
        raise AssertionError("card and CPU surface steps disagree")


def surface_path(preset, cfg, frames, gt, ate_max):
    """Drive SharedMapSLAM(cfg, device="cuda").run_log over `frames` with
    every launch count set to 0 just before, then again with the same seed;
    returns (the counts, the engine, the first run's state, the frames)."""
    from gridmap_slam_tpu_torch import SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    kernels = _kernel_modules()
    eng = SharedMapSLAM(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    seq = [frame_at(batch, i) for i in range(len(frames))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    state, infos = eng.run_log(
        eng.init(), seq, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    traj = torch.stack([i.weighted_pose for i in infos]).cpu().numpy()
    finite = bool(torch.isfinite(state.poses).all()
                  and torch.isfinite(state.log_weights).all()
                  and torch.isfinite(state.logodds).all()
                  and np.isfinite(traj).all())
    ate = ate_rmse(traj, gt[:len(frames)])
    occ = int((state.logodds > 0).sum())
    free = int((state.logodds < 0).sum())

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    again, _ = eng.run_log(eng.init(), seq,
                           torch.Generator(device="cuda").manual_seed(SEED))
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    # the same seed again must give the same bits
    rerun_identical = bool(torch.equal(again.poses, state.poses)
                           and torch.equal(again.logodds, state.logodds))
    say("surface", preset=preset, particles=cfg.num_particles,
        map=[cfg.map.cells_y, cfg.map.cells_x],
        crop=cfg.matcher.surface_crop_cells, scans=len(seq),
        launches=launches, ate_m=ate, ate_max_m=ate_max,
        final_neff=float(infos[-1].neff),
        resamples=int(sum(bool(i.resampled) for i in infos)),
        map_occupied=occ, map_free=free, finite=finite,
        rerun_identical=rerun_identical, peak_mem_bytes=peak,
        warm_seconds=sec, scans_per_sec=len(seq) / sec)
    if not finite:
        raise AssertionError(f"{preset}: non-finite poses, weights or map")
    if not rerun_identical:
        raise AssertionError(f"{preset}: a second run with seed {SEED} "
                             f"gave other poses or another map")
    if not (launches["log_likelihood_field"] > 0
            and launches["integrate_scan"] > 0):
        raise AssertionError(f"{preset}: K3 or K2 was not launched: "
                             f"{launches}")
    if not ate < ate_max:
        raise AssertionError(f"{preset} ATE {ate} >= {ate_max}")
    if not (occ > 50 and free > 1000):
        raise AssertionError(f"{preset}: map too empty: {occ} occupied, "
                             f"{free} free")
    return launches, eng, state, seq


def mega_phase(frames, gt):
    from gridmap_slam_tpu_torch import mega_config
    from gridmap_slam_tpu_torch.io import read_recording

    launches = surface_path("mega", mega_config(), frames, gt, ATE_MAX_M)[0]
    surface_path("mega room_loop_40", mega_config(),
                 read_recording("maps/room_loop_40.rec"),
                 np.load("maps/room_loop_40_gt.npy"), ROOM_LOOP_ATE_MAX_M)
    return launches


def city_kernels_phase(eng, state, frame):
    """K3 and K2 against their plain versions on the very arguments one
    city step passes them (recorded by wrapping the two calls of
    models/shared.py): K3 on the volume crop plus blur radius, K2 on the
    integration crop at its shifted origin."""
    from gridmap_slam_tpu_torch.models import shared
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood

    cfg = eng.config
    seen = {}

    def record(name, fn):
        def call(*args, **kw):
            seen[name] = (args, kw)
            return fn(*args, **kw)
        return call

    real = (shared.log_likelihood_field_batch, shared.integrate_scan_batch)
    shared.log_likelihood_field_batch = record("K3", real[0])
    shared.integrate_scan_batch = record("K2", real[1])
    try:
        eng.step_surface(state, frame,
                         torch.Generator(device="cuda").manual_seed(SEED))
    finally:
        shared.log_likelihood_field_batch, shared.integrate_scan_batch = real

    args, kw = seen["K3"]
    got = likelihood.log_likelihood_field_batch_cuda(*args, **kw)
    want = likelihood.log_likelihood_field_batch_plain(*args, **kw)
    err3 = float((got - want).abs().max())
    ms3 = cuda_ms(lambda: likelihood.log_likelihood_field_batch_cuda(
        *args, **kw), 50)
    plain3 = cuda_ms(lambda: likelihood.log_likelihood_field_batch_plain(
        *args, **kw), 20)
    shape3 = list(args[0].shape)
    unknown3 = float((args[0] == 0).float().mean())

    args, kw = seen["K2"]
    got = grid_update.integrate_scan_batch_cuda(*args, **kw)
    want = grid_update.integrate_scan_batch_plain(*args, **kw)
    diff = (got - want).abs()
    frac2 = float((diff > K2_ATOL).float().mean())
    changed = float((want != args[0]).float().mean())
    ms2 = cuda_ms(lambda: grid_update.integrate_scan_batch_cuda(
        *args, **kw), 50)
    plain2 = cuda_ms(lambda: grid_update.integrate_scan_batch_plain(
        *args, **kw), 20)
    shape2, origin2 = list(args[0].shape), list(kw["origin"])
    say("city_kernels", k3_shape=shape3, k3_unknown_frac=unknown3,
        k3_max_abs_err=err3, k3_atol=K3_ATOL, k3_ms=ms3, k3_plain_ms=plain3,
        k2_shape=shape2, k2_origin=origin2,
        map_origin=list(cfg.map.origin), k2_cells_updated_frac=changed,
        k2_frac_beyond_atol=frac2, k2_atol=K2_ATOL, k2_max_frac=K2_MAX_FRAC,
        k2_max_abs_err=float(diff.max()), k2_ms=ms2, k2_plain_ms=plain2)
    crop = cfg.matcher.surface_crop_cells
    r = cfg.map.likelihood_radius
    if shape3 != [1, crop + 2 * r, crop + 2 * r]:
        raise AssertionError(f"city K3 ran at {shape3}, not the crop plus "
                             f"radius")
    if not err3 <= K3_ATOL:
        raise AssertionError(f"city K3 max abs error {err3} > {K3_ATOL}")
    if shape2[1:] == [cfg.map.cells_y, cfg.map.cells_x] or \
            origin2 == list(cfg.map.origin):
        raise AssertionError(f"city K2 ran on {shape2} at {origin2}, not "
                             f"on a shifted crop")
    if not (frac2 <= K2_MAX_FRAC and changed > 1e-3):
        raise AssertionError(f"city K2: {frac2} of cells beyond {K2_ATOL} "
                             f"(limit {K2_MAX_FRAC}); {changed} updated")


def main() -> int:
    name = device_phase()
    build_phase()
    cfg = parity_config()
    frames, gt = parity_log()
    rows = kernel_phase(cfg, frames)
    agree_phase(frames)
    by_path = {"parity": main_phase(cfg, frames, gt)}
    k3_radii_phase(cfg)
    eng, batches, state = surface_setup(frames)
    surface_ops_phase(eng, batches, state)
    surface_agree_phase(eng, batches, state)
    del eng, batches, state
    from gridmap_slam_tpu_torch import city_config
    by_path["mega"] = mega_phase(frames, gt)
    by_path["city"], eng, state, seq = surface_path(
        "city", city_config(), frames, gt, ATE_MAX_M)
    city_kernels_phase(eng, state, seq[-1])
    del eng, state, seq
    for row in rows:
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path", "max_abs_err",
                             "ms", "plain_ms")}
        for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
