#!/usr/bin/env python3
"""Drive the PyTorch port (gridmap_slam_tpu_torch) on one NVIDIA GPU.

Phases, each printed on its own line:

1. device — the card's name and power limit (nvidia-smi) and CUDA version;
2. build  — compile gridmap_slam_tpu_torch/csrc/*.cu with nvcc; the
   registers, shared memory and spills of each K1 instantiation (shared
   and global variant), of K2's two (four cells a thread, one cell) and of
   K3's nine (radius 1 to 4 compiled in, each staging by 128-bit loads or
   cell by cell, and any radius) from `-Xptxas -v`; a
   spill in any of them fails the run;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the parity preset (500 particles, 120 x 120 maps,
   2048 bearing bins, the three matcher stages, score_pose's single
   candidate), with its tolerance, K1's variant, and its time beside the
   plain version's (CUDA events, after warm-up) and beside its bound (the
   larger of its float operations over the H100's FP32 peak and its bytes
   over its HBM rate), K3 with its launch plan; then K1 in both variants
   where taps leave the map (endpoints at cells -1, W, 200 cells off, and
   around them); then K2 and K3 at a width that is no multiple of 4 and on
   a window whose address is no multiple of 16 bytes, K3 at every
   compiled-in radius, at radius 0, across column tiles, and with taps
   whose squares underflow (the exact evidence sum in place of the window
   OR);
4. agree  — one filter step on the card against the same step in plain
   PyTorch on the CPU, from the same state and draws, on a small input;
5. main   — the parity preset (bench.py --preset parity: 500 particles,
   particle_chunk 250, 180 beams in 192 slots, a 12-scan synthetic
   square-path log, seed 0) through RBPF(cfg, device="cuda").run_log,
   with every kernel's launch count, the ATE and the scans/s of a warm run;
6. k3 radii — K3 against its plain version at blur radius 3, 12 and 30
   (sigma 1, 4 and 10 cells), 60 and 180 (past the map: a block takes a
   whole map, above the 48 KB shared-memory opt-in), 500 maps of
   120 x 120, each with its launch plan;
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
   radius, K2 on the 412 x 412 integration crop with its shifted origin;
12. grouped kernels — K1 with one shared 120 x 120 field for 2048
   particles (the three stages of the default matcher), K1 with one field
   and one scan a candidate for 32 closure candidates on 280 x 280 fields
   (the closure window, 15 x 15 x 13, and a refinement stage), K2 with
   cone fill and 32 bin tables at 280 x 280; each against its plain
   version, with times;
13. sync — one warm RBPF.step (parity preset) and one warm
   SharedMapSLAM.step_blocked (4096 particles, blocks of 2048) under
   torch.cuda.set_sync_debug_mode("error"): any call that waits on the
   card fails the run;
14. shared agree — one SharedMapSLAM.step at 4096 particles on the card
   against the same step on the CPU, from the same state and draws;
15. mega_blocked — bench.py's preset: 1M particles, each running the full
   three-stage matcher against the shared 120 x 120 map, through
   SharedMapSLAM.replay with the block of matcher_block_size (500 000),
   over the 12-scan log, twice with one seed (bit-identical); ATE, scans/s
   and peak memory beside the matcher workspace the block was sized for;
16. multi — scripts/config5_demo.py's setup (2 robots, 14 x 8 m at 0.1 m,
   96 beams, 20 revolutions) through MultiRobotSLAM.replay at 32 and at
   10 000 particles a robot, each twice with one seed (bit-identical);
   per-robot ATE;
17. posegraph — the CLI's posegraph flow on maps/grand_tour_216.rec: the
   RBPF at 200 particles on 14 x 14 m at 5 cm, keyframes, closure
   detection (32 candidates both ways), 10 Gauss-Newton iterations (with
   PyTorch's TF32 matmul flag on: the solve pins float32 itself) and the
   map rebuild, twice (bit-identical); keyframes, closures, chi2 first and
   last, ms per Gauss-Newton iteration at 216 keyframes and on synthetic
   graphs of 1000 and 3000 keyframes, with its peak memory;
18. chip — bench.py's chip preset: RBPF at 10 000 particles in chunks of
   500 over the 12-scan log; ATE and scans/s.

Each path (parity, mega, city, mega_blocked, multi at each particle count,
the posegraph flow's three parts: the filter, closure detection, the
rebuild; chip) is run with every launch count set to 0 just before it and
read just after.  In phase 11 and on the paths of phases 15-18 the first
run also records the arguments of the first kernel call of every call
shape (CallRecorder), and a path_kernels line holds each kernel against
its plain version on exactly those arguments, with K2's fraction of cells
beyond its atol and K3's launch plan (a call of more than 4096
particles on its first and last 2048: each particle's output depends on
its own rows only); a kernel that ran on a part but was not checked there
fails the run.  Then
one JSON line of kernels, with their launches per path and bounds, and last
{"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no "ok" line.
There is no CPU path: without a CUDA device it exits non-zero.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
MEGA_PARTICLES = 1_000_000
MULTI_PARTICLES = (32, 10_000)
MULTI_REVS = 20
GRAND_TOUR = "maps/grand_tour_216.rec"
GN_LARGE_KEYFRAMES = (1000, 3000)
CHIP_PARTICLES, CHIP_CHUNK = 10_000, 500       # bench.py:623-625
# The H100 SXM's published peaks (NVIDIA's data sheet, 700 W): FP32
# outside the tensor cores and HBM3.  A kernel's bound is the larger of its
# operations over the first and its bytes (each input read once, each
# output written once) over the second.
FP32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# Float operations (an FMA counted as two) a K1 sample: bilinear: 2
# coordinate adds, 2 floors, 2 fraction subtractions, 3 lerps (a
# subtraction and an FMA each), the add into the sum; nearest: 2 adds, 2
# roundings, the add.
K1_FLOPS = {False: 16, True: 5}
# A K2 cell: range (5) and bearing (about 15, an atan2) from the pose, the
# bin (3) and the footprint and return tests (about 7).
K2_FLOPS_CELL = 30
ODD_SHAPE = (37, 118, 123)         # a width that is no multiple of 4


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
    shared memory, spills per kernel) goes to stdout, and K1's
    instantiations (shared or global field, bilinear or nearest, runs of
    1 to 5 dx candidates a thread), K2's (four cells a thread or one) and
    K3's (radius 1 to 4 compiled in, staged by 128-bit loads or cell by
    cell, and any radius) are summed up on the
    build line.  K1's and K3's shared memory is dynamic: a call's plan sets
    it.  A spill in any of them fails the run."""
    from gridmap_slam_tpu_torch.ops.cuda import _build
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    _build.library()
    k1, k2, k3 = [], [], []
    for name, use in sorted(_build.ptxas_usage(log).items()):
        m = re.search(r"stage_scores_kernelILb([01])ELb([01])ELi(\d)E", name)
        if m:
            k1.append(dict(variant="shared" if m.group(1) == "1" else
                           "global", nearest=m.group(2) == "1",
                           run=int(m.group(3)), **use))
        m = re.search(r"grid_update_kernelILb([01])E", name)
        if m:
            k2.append(dict(cells_per_thread=4 if m.group(1) == "1" else 1,
                           **use))
        m = re.search(r"ll_field_(smallILi(\d)ELb([01])E|generic)", name)
        if m:
            k3.append(dict(variant="generic" if m.group(2) is None else
                           "small", radius=m.group(2) and int(m.group(2)),
                           loads_128_bit=m.group(3) and m.group(3) == "1",
                           **use))
    say("build", seconds=time.perf_counter() - t0,
        sources=[str(p.relative_to(_build.CSRC.parents[1]))
                 for p in _build.sources()],
        library=path.name, k1_registers_assumed=kmatch.REGISTERS,
        k1_variants=k1, k2_variants=k2, k3_variants=k3)
    if len(k2) != 2 or len(k3) != 9 or any(
            v["spill_stores"] or v["spill_loads"] for v in k2 + k3):
        raise AssertionError(f"K2: expected 2 instantiations, K3: 9, none "
                             f"with spills: {k2} {k3}")
    if len(k1) != 4 * kmatch.MAX_RUN or any(
            v["spill_stores"] or (v["run"] <= 3 and
                                  v["registers"] > kmatch.REGISTERS)
            for v in k1):
        raise AssertionError(f"K1: expected {4 * kmatch.MAX_RUN} "
                             f"instantiations without spills, runs of 1-3 "
                             f"within {kmatch.REGISTERS} registers: {k1}")


def _bound(flops: float, nbytes: float):
    """(bound ms, "operations" or "bytes") of work on the H100."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def k1_bound(args, kw):
    """K1's bound on these arguments: the samples this scan's used beams
    need (every candidate of particle p samples each used beam of its scan
    row once), and the inputs and the (P, nt, ny, nx) output."""
    field, px, py, use, pose0, dxs, dys, dts = args
    p = pose0.shape[0]
    cands = dts.shape[1] * dys.shape[1] * dxs.shape[1]
    rows = use.reshape(-1, use.shape[-1])
    samples = float(rows.sum()) * (p // rows.shape[0]) * cands
    return _bound(samples * K1_FLOPS[bool(kw.get("nearest"))],
                  _nbytes(args) + p * cands * 4)


def k2_bound(args, kw):
    """K2's bound: K2_FLOPS_CELL a cell; the map read and written once,
    the poses and tables read once."""
    lo = args[0]
    return _bound(K2_FLOPS_CELL * lo.numel(), _nbytes(args) + _nbytes([lo]))


def _taps_inside(n: int, r: int) -> int:
    """The taps of a (2r + 1)-tap blur along an axis of n cells that fall
    inside it, summed over its cells (a tap outside adds zero)."""
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def k3_bound(args, kw=None):
    """K3's bound: one blurred plane (the evidence mask is a window OR on
    bits, counted as nothing), two passes of an FMA for each tap that falls
    inside the map (4 (2r + 1) operations a cell away from the edges), and
    4 for the threshold and the log epilogue (a log counted as one); the
    map read and the field written once."""
    lo, taps = args
    p, h, w = lo.shape
    r = (taps.numel() - 1) // 2
    fmas = p * (h * _taps_inside(w, r) + w * _taps_inside(h, r))
    return _bound(2 * fmas + 4 * lo.numel(), _nbytes(args) + _nbytes([lo]))


def k3_plan(args) -> dict:
    """The launch plan K3 runs these arguments with."""
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    plan = likelihood.plan_for(*args)
    return dict(variant=plan.variant, tile=[plan.tile_h, plan.tile_w],
                grid=[args[0].shape[0], plan.bands, plan.tiles],
                threads=plan.threads, smem_bytes=plan.smem_bytes)


def k1_variant(args) -> str:
    """The K1 variant launch_plan picks for these arguments."""
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    field, px, _, _, pose0, dxs, dys, dts = args
    return kmatch.launch_plan(
        pose0.shape[0], field.shape[0], field.shape[1], field.shape[2],
        px.shape[-1], dts.shape[1], dys.shape[1], dxs.shape[1],
        **kmatch.device_limits(field.device.index)).variant


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
    bound, by = k3_bound((logodds, taps))
    say("kernel", name="K3 log_likelihood_field", shape=[p, h, w],
        plan=k3_plan((logodds, taps)),
        max_abs_err=err3, atol=K3_ATOL, ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, share_of_bound=bound / ms)
    if not err3 <= K3_ATOL:
        raise AssertionError(f"K3 max abs error {err3} > {K3_ATOL}")
    rows.append(dict(name="log_likelihood_field", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/likelihood.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/likelihood.py:62",
                     max_abs_err=err3, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=by, library_ms=None))
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
    bound, by = k2_bound((logodds, poses, keep, *tables), kw2)
    say("kernel", name="K2 integrate_scan", shape=[p, h, w],
        bins=cfg.beam_lut_bins, cells_updated_frac=changed,
        frac_beyond_atol=frac2, atol=K2_ATOL, max_frac=K2_MAX_FRAC,
        max_abs_err=err2, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, share_of_bound=bound / ms)
    if not (frac2 <= K2_MAX_FRAC and changed > 0.01):
        raise AssertionError(f"K2: {frac2} of cells beyond {K2_ATOL} "
                             f"(limit {K2_MAX_FRAC}); {changed} updated")
    rows.append(dict(name="integrate_scan", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/grid_update.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/grid_update.py:170",
                     max_abs_err=err2, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=by, library_ms=None))

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
    # score_pose's single candidate (the matcher switched off): a map a
    # particle takes the global variant, one shared map the shared one
    zero = torch.zeros((p, 1), device=dev)
    stages += [("score_pose", llf, px, py, use, zero, zero, zero, res),
               ("score_pose shared map", llf[:1].contiguous(), px, py, use,
                zero, zero, zero, res)]
    err1, ms1, plain1, bound1, by_ops = 0.0, 0.0, 0.0, 0.0, 0.0
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
        bound, by = k1_bound(args, kw1)
        limit = K1_NEAREST_MAX_FRAC if nearest else 0.0
        say("kernel", name=f"K1 stage_scores {name}", variant=k1_variant(args),
            field=list(field.shape), beams=int(sx.shape[0]),
            candidates=[dts.shape[1], dys.shape[1], dxs.shape[1]],
            max_abs_err=err, rtol=K1_RTOL, atol=K1_ATOL,
            frac_beyond_tol=frac, max_frac=limit, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, share_of_bound=bound / ms)
        if not frac <= limit:
            raise AssertionError(f"K1 {name}: {frac} of candidates beyond "
                                 f"rtol {K1_RTOL} / atol {K1_ATOL} (limit "
                                 f"{limit}; max abs {err})")
        if name in ("coarse", "fine", "refine"):   # the parity stages
            err1, ms1, plain1 = max(err1, err), ms1 + ms, plain1 + plain_ms
            bound1 += bound
            by_ops += bound if by == "operations" else 0.0
    err1 = max(err1, k1_ring_edges(cfg))
    err2, err3 = odd_shapes(cfg, scan, kw2, kw3)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], err3)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], err2)
    rows.append(dict(name="stage_scores", route="cuda",
                     source="gridmap_slam_tpu_torch/csrc/matcher.cu",
                     replaces="gridmap_slam_tpu/ops/pallas/matcher.py:287",
                     max_abs_err=err1, ms=ms1, plain_ms=plain1,
                     bound_ms=bound1,
                     bound_by="operations" if 2 * by_ops >= bound1
                     else "bytes", library_ms=None))
    return rows


def odd_shapes(cfg, scan, kw2, kw3, dev="cuda"):
    """K2 and K3 against their plain versions off the aligned path: maps
    whose width is no multiple of 4 (K2 moves one cell a thread), a
    120 x 120 window of a larger buffer that starts 4 bytes past a 16-byte
    boundary (K2 falls back from 128-bit words), K3 at every compiled-in
    radius and at radius 0, K3's generic variant over several column tiles,
    and K3 with sigma 1 at radius 12, whose outer taps squared underflow,
    so the kernel sums the evidence window exactly instead of taking the
    window OR.  Returns (K2's, K3's) largest error."""
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

    rng = np.random.default_rng(SEED + 6)
    tables = grid_update.scan_bin_tables(scan, cfg.beam_lut_bins)
    keep = torch.ones((), device=dev)
    p, h, w = ODD_SHAPE
    odd = _test_maps(p, h, w, rng, dev)
    buf = torch.zeros(p * 120 * 120 + 1, device=dev)
    buf[1:] = _test_maps(p, 120, 120, rng, dev).reshape(-1)
    window = buf[1:].view(p, 120, 120)
    assert window.is_contiguous() and window.data_ptr() % 16 == 4

    def poses(n, half):
        return torch.as_tensor(np.stack(
            [rng.uniform(-half, half, n), rng.uniform(-half, half, n),
             rng.uniform(-math.pi, math.pi, n)], 1).astype(np.float32),
            device=dev)

    err2 = err3 = 0.0
    k2_rows, k3_rows = [], []
    for name, lo in (("width 123", odd), ("offset window", window)):
        ps = poses(lo.shape[0], 1.5)
        for cone_fill in (False, True):
            kw = dict(kw2, cone_fill=cone_fill)
            got = grid_update.integrate_scan_batch_cuda(lo, ps, keep, *tables,
                                                        **kw)
            want = grid_update.integrate_scan_batch_plain(lo, ps, keep,
                                                          *tables, **kw)
            diff = (got - want).abs()
            frac = float((diff > K2_ATOL).float().mean())
            changed = float((want != lo).float().mean())
            err2 = max(err2, float(diff.max()))
            k2_rows.append(dict(name=name, shape=list(lo.shape),
                                cone_fill=cone_fill, frac_beyond_atol=frac,
                                cells_updated_frac=changed,
                                max_abs_err=float(diff.max())))
            if not (frac <= K2_MAX_FRAC and changed > 0.01):
                raise AssertionError(f"K2 at {name}: {k2_rows[-1]}")

    wide = _test_maps(3, 70, 1100, rng, dev)
    cases = [(name, lo, float(r) / 3 if r else 1.0, r)
             for name, lo in (("width 123", odd), ("offset window", window))
             for r in (0, 1, 2, 3, 4, 12)]
    cases += [("three column tiles", wide, 4.0, 12),
              ("column tiles, radius 3", wide, 1.0, 3),
              ("exact evidence sum", odd, 1.0, 12),
              ("exact evidence sum, compiled-in radius", odd, 0.3, 4)]
    for name, lo, sigma, r in cases:
        taps = torch.as_tensor(gaussian_kernel(sigma, r), device=dev)
        got = likelihood.log_likelihood_field_batch_cuda(lo, taps, **kw3)
        want = likelihood.log_likelihood_field_batch_plain(lo, taps, **kw3)
        err = float((got - want).abs().max())
        err3 = max(err3, err)
        k3_rows.append(dict(
            name=name, shape=list(lo.shape), radius=r, sigma_cells=sigma,
            window_or=likelihood.window_or_is_exact(taps),
            plan=k3_plan((lo, taps)), max_abs_err=err))
        if not err <= K3_ATOL:
            raise AssertionError(f"K3 at {name}: {k3_rows[-1]}")
    if [r["window_or"] for r in k3_rows[-2:]] != [False, False]:
        raise AssertionError("K3: the exact evidence sum was not exercised")
    say("odd_shapes", k2=k2_rows, k2_atol=K2_ATOL, k2_max_frac=K2_MAX_FRAC,
        k3=k3_rows, k3_atol=K3_ATOL)
    return err2, err3


def k1_ring_edges(cfg, dev="cuda") -> float:
    """K1 against its plain version where taps leave the map: a scan whose
    endpoints sit at cell coordinates 200 cells below the map, at -2.6,
    -2, -1.75, -1 (the low corner outside, the high one inside), -0.25, 0,
    the middle, W - 1.25, W - 1, W - 0.75 (the high corner outside), W,
    W + 1 (the ring's far cells) and 200 cells past W, in x and in y, for
    64 particles jittered by a few hundredths of a cell; on one 120 x 120
    field (the shared variant, whose ring of 2 cells the kernel clamps
    into) and one 280 x 280 field (the global variant), bilinear and
    nearest.  Returns the largest bilinear error."""
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    rng = np.random.default_rng(SEED + 5)
    res, maxr = cfg.map.resolution, cfg.sensor.max_range
    n = 64

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    worst = 0.0
    for cells in (cfg.map.cells_x, 280):
        origin = (-cells * res / 2,) * 2
        field = t(rng.uniform(-8.0, -0.5, (1, cells, cells)))
        at = np.array([-200.25, -2.6, -2.0, -1.75, -1.0, -0.25, 0.0,
                       cells // 2, cells - 1.25, cells - 1.0, cells - 0.75,
                       cells, cells + 1.0, cells + 200.75])
        fx, fy = (a.ravel() for a in np.meshgrid(at, at))
        # endpoints in the frame of a pose at the map's center
        px, py = t((fx + 0.5 - cells / 2) * res), t((fy + 0.5 - cells / 2)
                                                    * res)
        use = torch.ones(px.shape, dtype=torch.bool, device=dev)
        pose0 = t(np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)) * res,
                                  np.zeros((n, 1))], 1))
        # offsets whose sums with the coordinates above avoid half cells
        off = t(np.broadcast_to(np.array([-0.35, -0.1, 0.0, 0.15, 0.4])
                                * res, (n, 5)))
        dts = t(np.broadcast_to([0.0, 2e-4], (n, 2)))
        args = (field, px, py, use, pose0, off, off, dts)
        for nearest in (False, True):
            kw = dict(resolution=res, origin=origin, max_range=maxr,
                      nearest=nearest)
            got = kmatch.stage_scores_batch_cuda(*args, **kw)
            want = kmatch.stage_scores_batch_plain(*args, **kw)
            diff = (got - want).abs()
            err = float(diff.max())
            frac = float((diff > K1_ATOL + K1_RTOL * want.abs())
                         .float().mean())
            limit = K1_NEAREST_MAX_FRAC if nearest else 0.0
            say("kernel", name="K1 stage_scores ring edges",
                variant=k1_variant(args), field=list(field.shape),
                beams=int(px.shape[0]), nearest=nearest, max_abs_err=err,
                rtol=K1_RTOL, atol=K1_ATOL, frac_beyond_tol=frac,
                max_frac=limit)
            if not frac <= limit:
                raise AssertionError(f"K1 at the ring's edges ({cells} "
                                     f"cells, nearest {nearest}): {frac} "
                                     f"beyond tolerance (max abs {err})")
            if not nearest:
                worst = max(worst, err)
    return worst


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


def _test_maps(p, h, w, rng, device="cuda"):
    """Log-odds maps with free space, walls and unexplored cells in random
    places, and an unexplored band on every other map."""
    u = rng.uniform(size=(p, h, w))
    lo = np.where(u < 0.3, -rng.uniform(0.1, 4.0, (p, h, w)),
                  np.where(u < 0.4, rng.uniform(0.1, 4.0, (p, h, w)), 0.0))
    lo[::2, :, :w // 2] = 0.0
    return torch.as_tensor(lo.astype(np.float32), device=device)


def k3_radii_phase(cfg):
    """K3 against its plain version at the blur radii of surface-mode
    relocalization (config.py: sigma 0.2-0.5 m is 4-10 cells at 5 cm), and
    at radius 60 and 180, which reach past the map: a block takes a whole
    map and opts in to more than 48 KB of shared memory."""
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
        bound, by = k3_bound((logodds, taps))
        say("k3_radius", sigma_cells=sigma, radius=radius,
            plan=k3_plan((logodds, taps)), shape=[p, h, w],
            max_abs_err=err, atol=K3_ATOL, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            share_of_bound=bound / ms)
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


KERNEL_ROWS = {"K1": "stage_scores", "K2": "integrate_scan",
               "K3": "log_likelihood_field"}
_ENTRY = {"K1": ("matcher", "stage_scores_batch_cuda"),
          "K2": ("grid_update", "integrate_scan_batch_cuda"),
          "K3": ("likelihood", "log_likelihood_field_batch_cuda")}
PATH_MAX_ERR = {row: 0.0 for row in KERNEL_ROWS.values()}
BOUNDS = {"K1": k1_bound, "K2": k2_bound, "K3": k3_bound}
FULL_MAX = 4096      # a recorded call of more particles is compared on
SLICE = 2048         # its first and its last SLICE particles


def _sig(x):
    """What makes two calls the same call shape: the tensors' shapes and
    dtypes and every other argument's value."""
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    return repr(x)


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _entry(kernel):
    import importlib
    mod_name, attr = _ENTRY[kernel]
    return (importlib.import_module(
        f"gridmap_slam_tpu_torch.ops.cuda.{mod_name}"), attr)


class CallRecorder:
    """Records the arguments a path passes each kernel.  While it is
    active, each kernel's `*_cuda` entry point (which the dispatching
    function looks up at every call) is wrapped: the first call of every
    call shape under the current `path` label is kept, its tensors cloned,
    and the kernel then runs and counts its launch as before."""

    def __init__(self, path: str):
        self.path = path
        self.calls = []            # (path, kernel, args, kw)
        self._seen = set()
        self._real = []

    def __enter__(self):
        for kernel in _ENTRY:
            mod, attr = _entry(kernel)
            real = getattr(mod, attr)
            self._real.append((mod, attr, real))
            setattr(mod, attr, self._wrap(kernel, real))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self._real:
            setattr(mod, attr, real)
        self._real = []

    def bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for _, _, args, kw in self.calls
                   for t in (*args, *kw.values()) if torch.is_tensor(t))

    def _wrap(self, kernel, real):
        def call(*args, **kw):
            key = (self.path, kernel, _sig(args), _sig(kw))
            if key not in self._seen:
                self._seen.add(key)
                self.calls.append((self.path, kernel, _clone(args),
                                   _clone(kw)))
            return real(*args, **kw)
        return call


def _group_rows(t, p, a, n):
    """The rows of a per-group tensor t (G, ...) that particles [a, a + n)
    of p read, as a tensor those n particles read the same way."""
    g = t.shape[0]
    per = p // g
    if g == 1:
        return t
    if per == 1:
        return t[a:a + n]
    if a // per == (a + n - 1) // per:
        return t[a // per:a // per + 1]
    if a % per == 0 and n % per == 0:
        return t[a // per:(a + n) // per]
    raise ValueError(f"particles [{a}, {a + n}) cut a group of {per}")


def _particle_slice(kernel, args, a, n):
    """A kernel call's arguments for its particles [a, a + n) alone (each
    particle's output depends on its own rows only)."""
    if kernel == "K1":
        field, px, py, use, pose0, dxs, dys, dts = args
        p = pose0.shape[0]
        scan = [x if x.dim() == 1 else _group_rows(x, p, a, n)
                for x in (px, py, use)]
        return (_group_rows(field, p, a, n), *scan,
                *(x[a:a + n] for x in (pose0, dxs, dys, dts)))
    if kernel == "K2":
        lo, poses, keep, *tables = args
        p = lo.shape[0]
        return (lo[a:a + n], poses[a:a + n], keep,
                *(t if t.dim() == 1 else _group_rows(t, p, a, n)
                  for t in tables))
    lo, taps = args
    return (lo[a:a + n], taps)


def check_recorded(rec: CallRecorder, launches_by_path) -> list:
    """Each recorded call again, on the kernel and on its plain version, on
    the very arguments the path passed: whole up to FULL_MAX particles, else
    the real call's first and last SLICE particles' rows against the plain
    version on those particles.  Raises beyond the kernel's tolerance, or
    where a kernel launched on a path (`launches_by_path`) has no recorded
    call there.  Returns the checks, one dict a call."""
    checks = []
    for path, kernel, args, kw in rec.calls:
        mod, attr = _entry(kernel)
        cuda_fn = getattr(mod, attr)
        plain_fn = getattr(mod, attr.replace("_cuda", "_plain"))
        p = (args[4] if kernel == "K1" else args[0]).shape[0]
        parts = [(0, p)] if p <= FULL_MAX else [(0, SLICE), (p - SLICE, SLICE)]
        got_all = cuda_fn(*args, **kw)
        err, beyond, changed, n_out = 0.0, 0, 0, 0
        for a, n in parts:
            sub = args if n == p else _particle_slice(kernel, args, a, n)
            want = plain_fn(*sub, **kw)
            got = got_all[a:a + n]
            diff = (got - want).abs()
            err = max(err, float(diff.max()))
            n_out += diff.numel()
            if kernel == "K1":
                beyond += int((diff > K1_ATOL + K1_RTOL * want.abs()).sum())
            elif kernel == "K2":
                beyond += int((diff > K2_ATOL).sum())
                changed += int((want != sub[0]).sum())
            else:
                beyond += int((diff > K3_ATOL).sum())
        del got_all
        first = args if parts[0][1] == p else _particle_slice(
            kernel, args, *parts[0])
        ms = cuda_ms(lambda: cuda_fn(*args, **kw), 20 if p <= FULL_MAX else 3)
        plain_ms = cuda_ms(lambda: plain_fn(*first, **kw), 3)
        frac = beyond / n_out
        limit = {"K1": K1_NEAREST_MAX_FRAC if kw.get("nearest") else 0.0,
                 "K2": K2_MAX_FRAC, "K3": 0.0}[kernel]
        bound, by = BOUNDS[kernel](args, kw)
        row = dict(path=path, kernel=kernel,
                   shapes=[list(t.shape) for t in args if torch.is_tensor(t)],
                   particles=p, compared=sum(n for _, n in parts),
                   max_abs_err=err, frac_beyond_tol=frac, max_frac=limit,
                   ms=ms, plain_ms=plain_ms, plain_particles=parts[0][1],
                   bound_ms=bound, bound_by=by, share_of_bound=bound / ms)
        if kernel == "K1":
            row.update(variant=k1_variant(args),
                       nearest=bool(kw.get("nearest")), rtol=K1_RTOL,
                       atol=K1_ATOL)
        else:
            row.update(atol=K2_ATOL if kernel == "K2" else K3_ATOL)
        if kernel == "K2":
            row.update(cone_fill=bool(kw.get("cone_fill")),
                       frac_beyond_atol=frac,
                       cells_updated_frac=changed / n_out)
        if kernel == "K3":
            row.update(plan=k3_plan(args))
        checks.append(row)
        name = KERNEL_ROWS[kernel]
        PATH_MAX_ERR[name] = max(PATH_MAX_ERR[name], err)
        if not frac <= limit:
            say("path_kernels", calls=checks)
            raise AssertionError(f"{path} {kernel}: {frac} beyond its "
                                 f"tolerance (limit {limit}; max abs {err})")
    say("path_kernels", paths=sorted({row["path"] for row in checks}),
        recorded_bytes=rec.bytes(), calls=checks)
    checked = {(row["path"], KERNEL_ROWS[row["kernel"]]) for row in checks}
    for path, launches in launches_by_path.items():
        for name, n in launches.items():
            if n > 0 and (path, name) not in checked:
                raise AssertionError(f"{path}: {name} ran but no call of "
                                     f"it was checked")
    return checks


def city_kernels_phase(eng, state, frame):
    """K3 and K2 against their plain versions on the very arguments one
    city step passes them (CallRecorder): K3 on the volume crop plus blur
    radius, K2 on the integration crop at its shifted origin."""
    cfg = eng.config
    kernels = _zero_launches()
    with CallRecorder("city step") as rec:
        eng.step_surface(state, frame,
                         torch.Generator(device="cuda").manual_seed(SEED))
    launches = {k: mod.launches for k, mod in kernels.items()}
    calls = {kernel: (args, kw) for _, kernel, args, kw in rec.calls}
    shape3 = list(calls["K3"][0][0].shape)
    shape2 = list(calls["K2"][0][0].shape)
    origin2 = list(calls["K2"][1]["origin"])
    crop = cfg.matcher.surface_crop_cells
    r = cfg.map.likelihood_radius
    if shape3 != [1, crop + 2 * r, crop + 2 * r]:
        raise AssertionError(f"city K3 ran at {shape3}, not the crop plus "
                             f"radius")
    if shape2[1:] == [cfg.map.cells_y, cfg.map.cells_x] or \
            origin2 == list(cfg.map.origin):
        raise AssertionError(f"city K2 ran on {shape2} at {origin2}, not "
                             f"on a shifted crop")
    for row in check_recorded(rec, {"city step": launches}):
        if row["kernel"] == "K2" and not row["cells_updated_frac"] > 1e-3:
            raise AssertionError(f"city K2 updated too few cells: {row}")


def _k1_check(name, args, kw, rows_out, reps=20, plain_reps=3):
    """K1 against its plain version on `args`; raises beyond tolerance.
    Returns (max abs error, ms, plain ms)."""
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    got = kmatch.stage_scores_batch_cuda(*args, **kw)
    want = kmatch.stage_scores_batch_plain(*args, **kw)
    diff = (got - want).abs()
    err = float(diff.max())
    frac = float((diff > K1_ATOL + K1_RTOL * want.abs()).float().mean())
    ms = cuda_ms(lambda: kmatch.stage_scores_batch_cuda(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: kmatch.stage_scores_batch_plain(*args, **kw),
                       plain_reps)
    field, px, dxs, dys, dts = args[0], args[1], args[5], args[6], args[7]
    bound, by = k1_bound(args, kw)
    row = dict(name=name, variant=k1_variant(args),
               particles=int(args[4].shape[0]), field=list(field.shape),
               scans=list(px.shape), candidates=[dts.shape[1], dys.shape[1],
                                                  dxs.shape[1]],
               max_abs_err=err, rtol=K1_RTOL, atol=K1_ATOL,
               frac_beyond_tol=frac, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by, share_of_bound=bound / ms)
    rows_out.append(row)
    if not frac == 0.0:
        raise AssertionError(f"K1 {name}: {frac} of candidates beyond rtol "
                             f"{K1_RTOL} / atol {K1_ATOL} (max abs {err})")
    return err, ms, plain_ms


def grouped_kernel_phase(cfg, frames, dev="cuda", n_shared=2048,
                         n_closure=32, closure_cells=280):
    """The new call shapes of K1 and K2 against their plain versions: one
    field shared by every particle, one field and one scan a closure
    candidate, and K2 with cone fill and one bin table a candidate."""
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel
    from gridmap_slam_tpu_torch.ops.matcher import (_stage_offsets,
                                                    half_resolution)
    from gridmap_slam_tpu_torch.types import Scan

    rng = np.random.default_rng(SEED + 3)
    mc = cfg.matcher
    res, maxr = cfg.map.resolution, cfg.sensor.max_range
    ll_out = math.log(1.0 / maxr)
    taps = torch.as_tensor(gaussian_kernel(cfg.map.likelihood_sigma,
                                           cfg.map.likelihood_radius),
                           device=dev)
    kw3 = dict(z_hit=mc.z_hit, max_range=maxr)
    batch = frames_to_device(frames, cfg.max_beams, maxr, device=dev)
    scans = [deskew_scan(frame_at(batch, i).scan, frame_at(batch, i).odom)
             for i in range(len(frames))]
    stride = mc.coarse_beam_stride
    rows = []

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(n, half):
        return t(np.stack([rng.uniform(-half, half, n),
                           rng.uniform(-half, half, n),
                           rng.uniform(-math.pi, math.pi, n)], 1))

    def stages(llf, px, py, use, pose0, coarse, refine):
        """(name, args, resolution) of the coarse stage on the pooled field
        and the first refinement stage, around random argmax offsets."""
        n = pose0.shape[0]
        (c_xy, c_t) = coarse
        cx = c_xy.expand(n, -1).contiguous()
        ct = c_t.expand(n, -1).contiguous()
        off_xy, off_t = refine[0]
        center = t(rng.uniform(-1, 1, (n, 3))) * torch.stack(
            [c_xy[-1], c_xy[-1], c_t[-1]])
        return [("coarse", (half_resolution(llf, ll_out), px[..., ::stride]
                            .contiguous(), py[..., ::stride].contiguous(),
                            use[..., ::stride].contiguous(), pose0, cx, cx,
                            ct), 2 * res),
                ("fine", (llf, px, py, use, pose0,
                          center[:, :1] + off_xy, center[:, 1:2] + off_xy,
                          center[:, 2:] + off_t), res)]

    # ---- K1, one shared 120 x 120 field for every particle (G_f = 1)
    h, w = cfg.map.cells_y, cfg.map.cells_x
    lo = _test_maps(1, h, w, rng, dev)
    llf = likelihood.log_likelihood_field_batch(lo, taps, **kw3)
    px, py = scan_points(scans[3])
    use = scans[3].valid & scans[3].hit
    coarse, refine = _stage_offsets(mc, torch.device(dev))
    err_shared = 0.0
    for name, args, r in stages(llf, px, py, use, poses(n_shared, 1.5),
                                coarse, refine):
        err_shared = max(err_shared, _k1_check(
            f"shared field {name}", args, dict(
                resolution=r, origin=cfg.map.origin, max_range=maxr),
            rows)[0])

    # ---- K1, one field and one scan a closure candidate (G_f = G_b = C):
    # the frontend's closure window on 280 x 280 fields at 5 cm
    c = n_closure
    origin = (-closure_cells * res / 2,) * 2
    lo = _test_maps(c, closure_cells, closure_cells, rng, dev)
    llf_c = likelihood.log_likelihood_field_batch(lo, taps, **kw3)
    pick = [scans[i % len(scans)] for i in range(c)]
    stacked = Scan(*(torch.stack([getattr(sc, f) for sc in pick])
                     for f in ("angle", "dist", "hit", "valid")))
    pxc, pyc = scan_points(stacked)
    usec = stacked.valid & stacked.hit
    closure_mc = dataclasses.replace(
        mc, window_xy=1.0, window_theta_deg=30.0, coarse_nxy=15,
        coarse_nt=13, extra_refine_stages=3, prior_weight=0.0)
    coarse_c, refine_c = _stage_offsets(closure_mc, torch.device(dev))
    err_closure = 0.0
    for name, args, r in stages(llf_c, pxc, pyc, usec, poses(c, 0.5),
                                coarse_c, refine_c):
        err_closure = max(err_closure, _k1_check(
            f"closure {name}", args, dict(resolution=r, origin=origin,
                                          max_range=maxr), rows)[0])

    # ---- K2 with cone fill, one bin table a candidate, from zero maps
    tables = grid_update.scan_bin_tables(stacked, cfg.beam_lut_bins)
    zero = torch.zeros((c, closure_cells, closure_cells), device=dev)
    pz = poses(c, 0.3)
    one = torch.ones((), device=dev)
    kw2 = dict(resolution=res, origin=origin, l_free=cfg.sensor.l_free,
               l_occ=cfg.sensor.l_occ,
               tol_cells=cfg.sensor.hit_tolerance_cells, cone_fill=True)
    got = grid_update.integrate_scan_batch_cuda(zero, pz, one, *tables, **kw2)
    want = grid_update.integrate_scan_batch_plain(zero, pz, one, *tables,
                                                  **kw2)
    diff = (got - want).abs()
    frac2 = float((diff > K2_ATOL).float().mean())
    changed = float((want != 0).float().mean())
    ms2 = cuda_ms(lambda: grid_update.integrate_scan_batch_cuda(
        zero, pz, one, *tables, **kw2), 20)
    plain2 = cuda_ms(lambda: grid_update.integrate_scan_batch_plain(
        zero, pz, one, *tables, **kw2), 5)
    bound2, by2 = k2_bound((zero, pz, one, *tables), kw2)
    say("grouped_kernels", k1=rows, k2_cone_fill=dict(
        shape=list(zero.shape), tables=list(tables[0].shape),
        cells_updated_frac=changed, frac_beyond_atol=frac2, atol=K2_ATOL,
        max_frac=K2_MAX_FRAC, max_abs_err=float(diff.max()), ms=ms2,
        plain_ms=plain2, bound_ms=bound2, bound_by=by2,
        share_of_bound=bound2 / ms2))
    if not (frac2 <= K2_MAX_FRAC and changed > 0.05):
        raise AssertionError(f"K2 cone fill: {frac2} of cells beyond "
                             f"{K2_ATOL} (limit {K2_MAX_FRAC}); {changed} "
                             f"updated")
    return max(err_shared, err_closure), float(diff.max())


def sync_phase(cfg, frames, dev="cuda", shared_particles=AGREE_PARTICLES):
    """A warm RBPF.step and a warm SharedMapSLAM.step_blocked under
    torch.cuda.set_sync_debug_mode("error"): a call that waits on the card
    (a read back to the host, a copy from pageable host memory) raises."""
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rbpf = RBPF(cfg, device=dev)
    shared = SharedMapSLAM(cfg.replace(num_particles=shared_particles,
                                       particle_chunk=0), device=dev)
    block = shared_particles // 2
    st_r = rbpf.init()
    st_s = shared.init()
    for i in range(2):                 # warm: offsets cached, kernels loaded
        st_r, _ = rbpf.step(st_r, frame_at(batch, i), gen)
        st_s, _ = shared.step_blocked(st_s, frame_at(batch, i), block, gen)
    f2 = frame_at(batch, 2)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        st_r, info_r = rbpf.step(st_r, f2, gen)
        st_s, info_s = shared.step_blocked(st_s, f2, block, gen)
    finally:
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    say("sync", rbpf_particles=cfg.num_particles,
        shared_particles=shared_particles, block=block,
        rbpf_neff=float(info_r.neff), shared_neff=float(info_s.neff),
        synchronizing_calls=0)


def shared_agree_phase(cfg, frames, dev="cuda", particles=AGREE_PARTICLES):
    """One SharedMapSLAM.step on the card against the same step on the CPU,
    from the same state and draws (blocks of 1024 on both, so the CPU's
    plain matcher stays within memory)."""
    from gridmap_slam_tpu_torch import SharedMapSLAM, SharedMapState
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    cfg = cfg.replace(num_particles=particles,
                      particle_chunk=min(1024, particles))
    engines = {d: SharedMapSLAM(cfg, device=d) for d in (dev, "cpu")}
    batches = {d: frames_to_device(frames, cfg.max_beams,
                                   cfg.sensor.max_range, device=d)
               for d in engines}
    state, _ = engines[dev].replay(
        engines[dev].init(), [frame_at(batches[dev], i) for i in range(3)],
        torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    normals = rng.standard_normal((particles, 2)).astype(np.float32)
    u0 = np.float32(rng.uniform(0, 1 / particles))
    out = {}
    for d, e in engines.items():
        st = SharedMapState(poses=state.poses.to(d),
                            log_weights=state.log_weights.to(d),
                            logodds=state.logodds.to(d), step=state.step.to(d),
                            recov=state.recov.to(d))
        draws = (torch.as_tensor(normals, device=d),
                 torch.as_tensor(u0, device=d), None)
        out[d] = e.step(st, frame_at(batches[d], 3), draws=draws)
    (sc, ic), (sp, ip) = out[dev], out["cpu"]
    dpose = (sc.poses.cpu() - sp.poses).abs().amax(1)
    pose_frac = float((dpose <= 1e-4).float().mean())
    map_beyond = int(((sc.logodds.cpu() - sp.logodds).abs() > K2_ATOL).sum())
    say("shared_agree", particles=particles, poses_within_1e4=pose_frac,
        max_pose_diff=float(dpose.max()), map_cells_beyond_atol=map_beyond,
        map_cells_updated=int((sp.logodds != state.logodds.cpu()).sum()),
        neff_card=float(ic.neff), neff_cpu=float(ip.neff),
        resampled=[bool(ic.resampled), bool(ip.resampled)])
    if not (pose_frac == 1.0 and map_beyond == 0):
        raise AssertionError("card and CPU matcher steps disagree")


def _timed(fn):
    """(result, seconds) of fn() on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _zero_launches():
    kernels = _kernel_modules()
    for mod in kernels.values():
        mod.launches = 0
    return kernels


def mega_blocked_phase(frames, gt, particles=MEGA_PARTICLES, dev="cuda"):
    """bench.py's mega_blocked preset (bench.py:641-644, :315-359): 1M
    particles, each running the full three-stage matcher against the
    shared map, in blocks of matcher_block_size."""
    from gridmap_slam_tpu_torch import SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.models.shared import (matcher_block_size,
                                                      matcher_workspace_bytes)
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    cfg = parity_config().replace(num_particles=particles, particle_chunk=0)
    block = matcher_block_size(cfg)
    eng = SharedMapSLAM(cfg, device=dev)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=dev)
    seq = [frame_at(batch, i) for i in range(len(frames))]

    def run():
        return eng.replay(eng.init(), seq,
                          torch.Generator(device=dev).manual_seed(SEED),
                          block=block)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _zero_launches()
    with CallRecorder("mega_blocked") as rec:
        (state, infos), _ = _timed(run)
    launches = {k: mod.launches for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    (again, _), sec = _timed(run)
    traj = torch.stack([i.weighted_pose for i in infos]).cpu().numpy()
    ate = ate_rmse(traj, gt[:len(frames)])
    finite = bool(torch.isfinite(state.poses).all()
                  and torch.isfinite(state.logodds).all()
                  and np.isfinite(traj).all())
    identical = bool(torch.equal(again.poses, state.poses)
                     and torch.equal(again.logodds, state.logodds)
                     and torch.equal(again.log_weights, state.log_weights))
    del again
    occ, free = int((state.logodds > 0).sum()), int((state.logodds < 0).sum())
    say("mega_blocked", particles=particles, block=block,
        blocks_per_scan=particles // block,
        map=[cfg.map.cells_y, cfg.map.cells_x], scans=len(seq),
        launches=launches, ate_m=ate, ate_max_m=ATE_MAX_M,
        final_neff=float(infos[-1].neff),
        resamples=int(sum(bool(i.resampled) for i in infos)),
        map_occupied=occ, map_free=free, finite=finite,
        rerun_identical=identical, peak_mem_bytes=peak,
        recorded_args_bytes=rec.bytes(),
        matcher_workspace_bytes=block * matcher_workspace_bytes(cfg),
        state_bytes=particles * 4 * 4 + 4 * cfg.map.cells_x * cfg.map.cells_y,
        warm_seconds=sec, scans_per_sec=len(seq) / sec)
    if not (finite and identical):
        raise AssertionError(f"mega_blocked: finite {finite}, rerun "
                             f"identical {identical}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"mega_blocked: a kernel was not launched: "
                             f"{launches}")
    if not ate < ATE_MAX_M:
        raise AssertionError(f"mega_blocked ATE {ate} >= {ATE_MAX_M}")
    if not (occ > 50 and free > 1000):
        raise AssertionError(f"mega_blocked: map too empty: {occ} occupied, "
                             f"{free} free")
    del state, infos
    check_recorded(rec, {"mega_blocked": launches})
    return launches


def multi_phase(dev="cuda", particle_counts=MULTI_PARTICLES,
                revs=MULTI_REVS):
    """scripts/config5_demo.py:62-79 on MultiRobotSLAM: two robots from
    opposite rooms through the door, 14 x 8 m at 0.1 m, 96 beams, noisy
    encoders; each particle count run twice with one seed."""
    from gridmap_slam_tpu_torch import MultiRobotSLAM, SlamConfig
    from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     multi_room_world,
                                                     simulate_log)
    from gridmap_slam_tpu_torch.models.multi import stack_frames
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, math.pi)]
    logs = [simulate_log(world, [(0.25, 0.0)] * revs, params=params,
                         seed=11 + i, start_pose=starts[i]) for i in range(2)]
    total = {}
    for particles in particle_counts:
        cfg = SlamConfig(num_particles=particles, max_beams=96,
                         sensor=SensorConfig(max_range=8.0),
                         map=MapConfig(width_m=14.0, height_m=8.0,
                                       resolution=0.1, origin=(-7.0, -4.0)))
        eng = MultiRobotSLAM(cfg, num_robots=2, device=dev)
        batches = [frames_to_device(f, cfg.max_beams, cfg.sensor.max_range,
                                    device=dev) for f, _ in logs]
        ticks = [stack_frames([frame_at(b, i) for b in batches])
                 for i in range(revs)]

        def run():
            return eng.replay(eng.init(starts), ticks,
                              torch.Generator(device=dev).manual_seed(SEED))

        kernels = _zero_launches()
        with CallRecorder(f"multi {particles}") as rec:
            (state, infos), _ = _timed(run)
        launches = {k: mod.launches for k, mod in kernels.items()}
        (again, _), sec = _timed(run)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        traj = torch.stack([i.weighted_pose for i in infos]).cpu().numpy()
        ates = [ate_rmse(traj[:, r], logs[r][1]) for r in range(2)]
        identical = bool(torch.equal(again.poses, state.poses)
                         and torch.equal(again.logodds, state.logodds))
        finite = bool(torch.isfinite(state.poses).all()
                      and torch.isfinite(state.logodds).all())
        say("multi", robots=2, particles_per_robot=particles, ticks=revs,
            map=[cfg.map.cells_y, cfg.map.cells_x], launches=launches,
            ate_m=ates, ate_max_m=ATE_MAX_M, jax_demo_cpu_ate_m=[0.0246,
                                                                0.0297],
            rerun_identical=identical, finite=finite, warm_seconds=sec,
            ticks_per_sec=revs / sec)
        if not (finite and identical):
            raise AssertionError(f"multi at {particles}: finite {finite}, "
                                 f"rerun identical {identical}")
        if not all(n > 0 for n in launches.values()):
            raise AssertionError(f"multi: a kernel was not launched: "
                                 f"{launches}")
        if not max(ates) < ATE_MAX_M:
            raise AssertionError(f"multi at {particles}: ATE {ates}")
        check_recorded(rec, {f"multi {particles}": launches})
    return total


def posegraph_phase(dev="cuda", particles=200, path=GRAND_TOUR, scans=None):
    """app/cli.py:360-400 on the port: the RBPF over the log, keyframes,
    closures, Gauss-Newton and the rebuilt map, twice with one seed."""
    from gridmap_slam_tpu_torch import (RBPF, FrontendConfig, PoseGraphSLAM,
                                        SlamConfig)
    from gridmap_slam_tpu_torch.config import MapConfig
    from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                           read_recording)
    from gridmap_slam_tpu_torch.models import posegraph as PG
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    frames = read_recording(path)[:scans]
    gt = np.load(path.replace(".rec", "_gt.npy"))[:len(frames)]
    # the CLI's defaults (360 beam slots, no chunk) on the map of
    # docs/ate_parity_grand_tour_216.json
    cfg = SlamConfig(num_particles=particles, max_beams=360, particle_chunk=0,
                     map=MapConfig(width_m=14.0, height_m=14.0,
                                   resolution=0.05, origin=(-7.0, -7.0)))
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=dev)
    seq = [frame_at(batch, i) for i in range(len(frames))]

    def run(rec=None, counts=None):
        """The flow.  Each of its three parts (the filter, the closures,
        the solve and rebuild) starts with every launch count at 0; with
        `counts`, each part's launches are kept under its name, and with
        `rec`, its kernel calls are recorded under that name."""
        kernels = _zero_launches()

        def part_done(name, following):
            if counts is not None:
                counts[name] = {k: mod.launches
                                for k, mod in kernels.items()}
            for mod in kernels.values():
                mod.launches = 0
            if rec is not None:
                rec.path = following

        eng = RBPF(cfg, device=dev)
        _, infos = eng.run_log(eng.init(), seq,
                               torch.Generator(device=dev).manual_seed(SEED))
        traj = torch.stack([i.weighted_pose for i in infos])
        part_done("posegraph_rbpf", "posegraph_closures")
        fe = PoseGraphSLAM(cfg, FrontendConfig(), device=dev)
        for i, f in enumerate(seq):
            fe.add(traj[i], deskew_scan(f.scan, f.odom))
        n_closures = fe.detect_closures()
        part_done("posegraph_closures", "posegraph_rebuild")
        graph = fe.graph()
        # the solve pins float32 itself: run it with TF32 allowed
        torch.backends.cuda.matmul.allow_tf32 = dev == "cuda"
        try:
            opt, chi2 = fe.optimize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        rebuilt = fe.rebuild_map()
        part_done("posegraph_rebuild", None)
        return traj.cpu().numpy(), fe, n_closures, graph, opt, chi2, rebuilt

    launches = {}
    with CallRecorder("posegraph_rbpf") as rec:
        (traj, fe, n_closures, graph, opt, chi2, rebuilt), sec = _timed(
            lambda: run(rec, launches))
    (_, _, n2, _, opt2, chi2_2, rebuilt2), _ = _timed(run)
    identical = bool(n2 == n_closures and np.array_equal(opt, opt2)
                     and np.array_equal(chi2, chi2_2)
                     and torch.equal(rebuilt, rebuilt2))
    # the same graph with TF32 off and on, and on the CPU
    tf32 = {}
    for flag in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = flag and dev == "cuda"
        try:
            tf32[flag] = PG.optimize(graph, iterations=10)[0].nodes
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    cpu_graph = PG.PoseGraph(*(getattr(graph, f.name).cpu()
                               for f in dataclasses.fields(graph)))
    cpu_nodes = PG.optimize(cpu_graph, iterations=10)[0].nodes
    cpu_err = float((tf32[False].cpu() - cpu_nodes).abs().max())
    (_, gn_sec) = _timed(lambda: PG.optimize(graph, iterations=10))
    large = [gn_large_graph(PG, k, dev) for k in GN_LARGE_KEYFRAMES]
    ate = ate_rmse(traj, gt)
    say("posegraph", log=path, scans=len(seq), particles=particles,
        map=[cfg.map.cells_y, cfg.map.cells_x], launches=launches,
        online_ate_m=ate, keyframes=fe.num_keyframes,
        edges=int(graph.edge_i.shape[0]), closures=n_closures,
        chi2_first=float(chi2[0]), chi2_last=float(chi2[-1]),
        jax_reference=dict(keyframes=216, closures=32, chi2_first=8.234,
                           chi2_last=0.386),
        gn_ms_per_iteration=gn_sec * 1e3 / 10, gn_large_graphs=large,
        tf32_flag_changes_nothing=bool(torch.equal(tf32[False], tf32[True])),
        card_vs_cpu_nodes_max_abs=cpu_err,
        rebuilt_occupied=int((rebuilt > 0).sum()),
        rebuilt_free=int((rebuilt < 0).sum()),
        rerun_identical=identical, seconds=sec)
    if not identical:
        raise AssertionError("posegraph: a second run gave other results")
    if not (np.isfinite(chi2).all() and chi2[-1] < chi2[0]):
        raise AssertionError(f"posegraph: chi2 did not fall: {chi2}")
    if not (torch.equal(tf32[False], tf32[True]) and cpu_err < 1e-3):
        raise AssertionError(f"posegraph: Gauss-Newton not pinned to "
                             f"float32 (card vs CPU {cpu_err})")
    for g in large:
        if not (g["finite"] and g["chi2_last"] < g["chi2_first"]):
            raise AssertionError(f"posegraph: Gauss-Newton at "
                                 f"{g['keyframes']} keyframes: {g}")
    # every kernel in the filter and in closure verification, K2 in the
    # rebuild (Gauss-Newton runs none)
    for part, needed in (("posegraph_rbpf", KERNEL_ROWS.values()),
                         ("posegraph_closures", KERNEL_ROWS.values()),
                         ("posegraph_rebuild", ["integrate_scan"])):
        if not all(launches[part][k] > 0 for k in needed):
            raise AssertionError(f"{part}: a kernel was not launched: "
                                 f"{launches[part]}")
    del fe, graph, rebuilt, rebuilt2
    check_recorded(rec, launches)
    return launches


def gn_large_graph(PG, k, dev, iterations=10):
    """Gauss-Newton on a synthetic graph of k keyframes: a random-walk
    trajectory, noisy odometry edges along it and k // 10 noisy closures
    between keyframes at least 20 apart, started from dead reckoning.
    Returns the timing, the peak memory and chi2 first and last."""
    rng = np.random.default_rng(SEED + 4)
    steps = rng.normal(0.0, 1.0, (k - 1, 3)) * [0.3, 0.05, 0.15]
    truth = np.zeros((k, 3))
    for i, (dx, dy, dt) in enumerate(steps):
        x, y, t = truth[i]
        truth[i + 1] = (x + math.cos(t) * dx - math.sin(t) * dy,
                        y + math.sin(t) * dx + math.cos(t) * dy, t + dt)
    ei, ej, ez, ew = PG.odometry_edges(truth, 200.0, 400.0)
    ez = ez + rng.normal(0.0, 1.0, ez.shape).astype(np.float32) * [
        0.01, 0.01, 0.005]
    start = np.zeros_like(truth)
    for i, (dx, dy, dt) in enumerate(ez):
        x, y, t = start[i]
        start[i + 1] = (x + math.cos(t) * dx - math.sin(t) * dy,
                        y + math.sin(t) * dx + math.cos(t) * dy, t + dt)
    ci = rng.integers(0, k - 20, k // 10)
    cj = np.minimum(ci + rng.integers(20, k, k // 10), k - 1)
    cz = np.stack([PG._relative_np(truth[i], truth[j])
                   for i, j in zip(ci, cj)]).astype(np.float32)
    graph = PG.PoseGraph(
        nodes=torch.as_tensor(start, dtype=torch.float32, device=dev),
        edge_i=torch.as_tensor(np.concatenate([ei, ci]), dtype=torch.int64,
                               device=dev),
        edge_j=torch.as_tensor(np.concatenate([ej, cj]), dtype=torch.int64,
                               device=dev),
        edge_z=torch.as_tensor(np.concatenate([ez, cz]), dtype=torch.float32,
                               device=dev),
        edge_w=torch.as_tensor(np.concatenate(
            [ew, np.tile([400.0, 400.0, 800.0], (len(ci), 1))]),
            dtype=torch.float32, device=dev))
    PG.optimize(graph, iterations=1)           # warm: cuSOLVER, cuBLAS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (opt, chi2), sec = _timed(lambda: PG.optimize(graph,
                                                  iterations=iterations))
    return dict(keyframes=k, edges=int(graph.edge_i.shape[0]),
                ms_per_iteration=sec * 1e3 / iterations,
                peak_mem_bytes=torch.cuda.max_memory_allocated() - base,
                chi2_first=float(chi2[0]), chi2_last=float(chi2[-1]),
                finite=bool(torch.isfinite(opt.nodes).all()))


def chip_phase(frames, gt, dev="cuda", particles=CHIP_PARTICLES,
               chunk=CHIP_CHUNK):
    """bench.py's chip preset (bench.py:623-625): the RBPF at 10 000
    particles in chunks of 500 on the parity map and log."""
    from gridmap_slam_tpu_torch import RBPF, chip_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    cfg = parity_config().replace(num_particles=particles,
                                  particle_chunk=chunk)
    eng = RBPF(cfg, device=dev)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=dev)
    seq = [frame_at(batch, i) for i in range(len(frames))]

    def run():
        return eng.run_log(eng.init(), seq,
                           torch.Generator(device=dev).manual_seed(SEED))

    kernels = _zero_launches()
    with CallRecorder("chip") as rec:
        (state, infos), _ = _timed(run)
    launches = {k: mod.launches for k, mod in kernels.items()}
    _, sec = _timed(run)
    traj = torch.stack([i.weighted_pose for i in infos]).cpu().numpy()
    ate = ate_rmse(traj, gt[:len(frames)])
    finite = bool(torch.isfinite(state.poses).all()
                  and torch.isfinite(state.logodds).all())
    say("chip", particles=particles, particle_chunk=chunk,
        chip_config_chunk=chip_config().particle_chunk,
        map=[cfg.map.cells_y, cfg.map.cells_x], scans=len(seq),
        launches=launches, ate_m=ate, ate_max_m=ATE_MAX_M,
        final_neff=float(infos[-1].neff), finite=finite, warm_seconds=sec,
        scans_per_sec=len(seq) / sec)
    if not finite:
        raise AssertionError("chip: non-finite poses or maps")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"chip: a kernel was not launched: {launches}")
    if not ate < ATE_MAX_M:
        raise AssertionError(f"chip ATE {ate} >= {ATE_MAX_M}")
    check_recorded(rec, {"chip": launches})
    return launches


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
    k1_err, k2_err = grouped_kernel_phase(cfg, frames)
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], k1_err)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], k2_err)
    sync_phase(cfg, frames)
    shared_agree_phase(cfg, frames)
    by_path["mega_blocked"] = mega_blocked_phase(frames, gt)
    by_path["multi"] = multi_phase()
    by_path.update(posegraph_phase())
    by_path["chip"] = chip_phase(frames, gt)
    for row in rows:
        row["max_abs_err"] = max(row["max_abs_err"],
                                 PATH_MAX_ERR[row["name"]])
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path", "max_abs_err",
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
        for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
