#!/usr/bin/env python3
"""Drive the PyTorch port (gridmap_slam_tpu_torch) on one NVIDIA GPU.

Phases, each printed on its own line:

1. device — the card's name and power limit (nvidia-smi) and CUDA version;
2. build  — compile gridmap_slam_tpu_torch/csrc/*.cu with nvcc; the
   registers, shared memory and spills of each K1 instantiation (shared
   and global variant), of K2's two (four cells a thread, one cell), of
   K3's nine (radius 1 to 4 compiled in, each staging by 128-bit loads or
   cell by cell, and any radius) and of K4's two (the prologue, the
   correlation) from `-Xptxas -v`, and F1-F8's (F3's twelve
   instantiations: scores staged or read in place, 1, 2, 3, 4 or 8 (dy,
   dx) cells a lane, or 8 at a time where a lane walks more in groups;
   F7's four kernels, F8's two); a spill in K2, K3, K4, F3, F7 or F8 fails
   the run;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the parity preset (500 particles, 120 x 120 maps,
   2048 bearing bins, the three matcher stages, score_pose's single
   candidate), with its tolerance, K1's variant, and its time beside the
   plain version's (CUDA events, after warm-up) and beside its bound (the
   larger of its float operations over the H100's FP32 peak and its bytes
   over its HBM rate), K3 with its launch plan; then K1 in both variants
   where taps leave the map (endpoints at cells -1, W, 200 cells off, and
   around them); K1's nearest-cell coarse stage (coarse_halfres=False, the
   parity_fullres cell's) is timed beside the three stages, each stage's
   time, bound and variant in the kernels line's `stages`; then K2 and K3
   at a width that is no multiple of 4 and on
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
   default TF32 flag on, against the CPU and the FFT; the trilinear sample
   at 1M poses by F4 against the 8-tap form (its tolerance) and the packed
   form (every bit); times of the volume build, the three sample forms,
   the pack and the FFT at the exact, 5-smooth and power-of-two lengths of
   the mega and city volumes;
8. surface agree — one surface-mode step on the card against the same step
   on the CPU, from the same state and draws, at 4096 particles;
8a. k4 — K4, the bf16 surface correlation on the tensor cores (a
   prologue that lists the endpoint images' live 16-tap groups, and the
   correlation over those alone): a mega_bf16 engine (mega_config() with
   the direct correlation in bf16, 1M particles) runs 3 scans and a
   city_bf16 engine (city_config(), the same override: a 916 x 916 field)
   1, the next step of each is recorded (K4's two kernels launched once)
   and K4, K3 and K2 held against their plain versions on those very
   arguments; K4 again at K4_SHAPES (nt 1, 5, 7, 9 and 16, K 7, 25, 51,
   64 and 101, crops not square, one dense shape on every tile of the
   kernel, one sparse splat of random beams), each with its error,
   tolerance, launch plan, its prologue against the plain preparation and
   the share of live groups, twice (the same bits); its time at both
   steps' shapes (CUDA events around calls from Python, as every kernel's
   "ms", and device time inside a CUDA graph) beside its bound (the
   nonzero taps' products at the bf16 tensor-core peak, or the bytes) and
   share, the dense product count for context, its plain version's, the
   one PyTorch call that computes the same function (cuDNN's float32
   conv2d of the rounded operands) and, at mega, for context, a bf16
   conv2d and the float32 FFT at that crop; one more step of each engine
   runs under the sync check;
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
13. sync — one warm RBPF.step (parity preset), one warm
   SharedMapSLAM.step_blocked (4096 particles, blocks of 2048), one warm
   city step_surface (K2's window placed on the card), one warm mega
   step_surface with surface_refine_steps=2 and one warm
   surface_sharded step (world of one over NCCL) under
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
   500 over the 12-scan log; ATE and scans/s;
18'. pr1 — bench.py's pr1 preset (100 particles, 400 x 400 maps, one
   chunk) and the same with coarse_halfres=False, each over 3 scans with
   two calls of each call shape recorded: every K1 call (coarse on the
   pooled 200 x 200 field or on nearest cells of the full field, fine and
   refine, each with its variant), K2 and K3 at (100, 400, 400) held
   against their plain versions, their times beside their bounds;
18a. captured — the single-program replays (models/captured.py: a log of
   n scans captured as graphs of at most CHUNK_SCANS = 16 scans, the
   scans' draws inside them, ceil(n / 16) graph launches a replay call):
   RBPF.replay_jit at the parity preset (and step_jit scan by scan, one
   graph a scan), at chip's 10 000 particles, at pr1 and, a long log, at the
   posegraph phase's 200 particles and map over the 216 scans of
   grand_tour_216.rec (14 launches), SharedMapSLAM.replay_surface_jit at
   mega (the 12-scan log and the 40 scans of room_loop_40.rec, 3
   launches), at mega with
   two refine steps, at mega_bf16 (K4 a scan) and mega_direct (the float32
   direct correlation), at city and city_bf16 (K4 a scan),
   SharedMapSLAM.replay_jit(block=500 000) at
   mega_blocked over 6 scans, MultiRobotSLAM.replay_jit at 10 000 a
   robot (20 ticks, 2 launches); each against its eager loop from one
   seed in this process: every field of the final state and of every
   stacked info equal in bits, and the generator's next draw after the
   call equal, two captured runs equal, ceil(n / 16) graph launches in a
   replay call (torch.profiler), ATE under the path's limit, no
   synchronizing call and no kernel launched from Python in a warm replay
   (the launch counts move only while the first call warms up and
   captures), the first chunk's graph of m scans holding m times the
   eager launches a scan of each of the repo's kernels, and every graph
   of the replay a graph of one scan's nodes its length times over (the
   same replay's graph of a log of one scan, captured beside them, whose
   infos equal the eager first scan's),
   the kernels a scan as torch.profiler sees them within the graph's
   (where it sees them), and beside each other the eager and captured
   scans/s (CUDA events around a warm run, host loop included), device
   time a run, launches from the host a scan (kernels, copies, sets,
   graph launches) and peak memory, and for the first chunk's graph and
   the one-scan graph their nodes, capture-and-instantiation seconds and
   peak memory; and the resample gates (models/captured.cond): one
   conditional IF node a gate a scan in the first chunk's graph (a
   robot's a tick at multi), the kernels inside their bodies a scan, the
   scans whose gate fired, the captured replay's peak memory over the
   state's map bytes, its device ms a scan as the profiler records it and
   its ms a scan by the host clock;
18b. parallel — the distributed engines (gridmap_slam_tpu_torch/parallel/):
   K1's tile variant against its plain version at tiles cut from a
   4000 x 4000 city field (2 and 4 tiles: both edge tiles and one inside;
   poses around the tile boundaries and the world's edges; the three
   stages of the tiled schedule), the tiles summed against the untiled K1,
   and its time at the tiled path's shapes; then, in a world of one rank
   over NCCL in this process (mesh (1, 1)), on the 12-scan parity log:
   shmap at 1M particles in blocks of matcher_block_size over 6 scans
   (against SharedMapSLAM.step_blocked, bit for bit), shmap surface on
   `mega` (against step_surface, bit for bit), tiled on the city map at
   10 000 particles in chunks of 500 (against SharedMapSLAM.step with the
   tiled coarse stage: poses and map within 1e-4), surface_sharded on
   `city` (against step_surface: poses 2e-3, map 1e-3, Neff rtol 1e-3),
   the sharded RBPF at the parity preset (against RBPF.step, bit for
   bit), each twice with one seed (the same bits), with its launches a
   scan, a warm step under the sync check, its peak memory and scans/s,
   and its compiled replay of the whole log (MeshStep.replay_jit: one
   graph launch, the compiled step's graph n times over, the eager bits
   and the generator's next draw);
   and the distributed Gauss-Newton on grand_tour_216's graph and the
   1000 / 3000-keyframe synthetic graphs (against posegraph.optimize:
   chi2 rtol 1e-3, nodes atol 1e-3, chi2 falling), ms an iteration;
   every path's tail on F7's mesh form (its passes with the pmax and
   psums between them, the epilogue on the gathered candidates) and, on
   one rank, F8, each recorded call equal to its plain version bit for
   bit; then shmap and shmap in surface mode (p = 2) on 2 gloo ranks on
   the one card (CUDA tensors; NCCL refuses two ranks on one card) over 3
   scans at the parity width, their gates where two of them resample: the
   ranks agree, equal the mesh (1, 1) run within the CPU tests'
   tolerances, and each rank's F7 and F8 mesh-form calls (F8's walking
   the gathered rows) equal their plain versions bit for bit;
19. cli — the port's application layer, in this process on the card:
   `python -m gridmap_slam_tpu_torch.app.cli replay` at the parity width on
   maps/room_loop_40.rec (500 particles, chunk 250, 192 beam slots, with
   --save-map, --map-view likelihood, --map-select combined), replay again
   from that map (--load-map), each with ATE < 0.10 m, scans/s and launches
   a scan; --engine surface at 1M particles on the same log, whose poses
   and map must equal phase 9's room-loop run bit for bit; posegraph on
   grand_tour_216 at 200 particles, whose keyframes, closures and chi2 must
   equal phase 17's first run; run_with_recovery at parity on the 12-scan
   log, checkpoints every 4 scans and a fault after scan 6's draws,
   bit-identical to an unbroken run (the generator's state restored with
   the checkpoint); SlamApplication fed 5 frames by the loopback robot
   through RobotLink and SlamPipeline; replay --engine tiled (parity
   width) and --engine surface-sharded (1M particles) on room_loop_40.rec
   at a world of one, each with its launches a scan and ATE < 0.25 m.
   The CLI and the app step through the engine's captured step
   (step_jit); replay at the parity width (also from the saved map), the
   1M surface replay and posegraph run again on the eager step in this
   call (application.compiled_step patched): the same trajectory bit for
   bit, and beside each other the scans/s and the host's launches a scan
   (torch.profiler, the median over the scans), and the kernels a scan
   inside the graph against the eager step's launches; the live app's
   host launches a frame on both steps;
20. bench — the benchmark (python -m gridmap_slam_tpu_torch.bench) in
   this process through its own entry point: every cell file of
   bench/cells (chip, city_surface, mega_blocked, mega_surface, parity,
   parity_fullres, pr1), at 3 timed replays; its exit code 0, its last
   line parsed with
   "correct": true, headed by mega_surface (the fastest cell of most
   particles) with bench.py's vs_baseline, and every share of a kernel's
   bound at most 1 (mega_blocked's K1 calls held on their first and last
   2048 particles); then each cell's control (--control: a kernel reading
   its input in bf16) must fail the benchmark's check of each kernel call against its
   plain version; then bench.py's one-measurement command line `--preset
   parity --set matcher.coarse_halfres=false` (3 replays) must print a
   correct line.  The kernels' bounds everywhere in this script are the
   benchmark's (gridmap_slam_tpu_torch/bench/kernels/);
21. fusions — F1-F8 (csrc/fusions.cu: the motion model, the coarse
   pool, each matcher stage's prior, argmax and pick, the surface's
   trilinear sample and hill-climb (F4, reading the volume in place), the
   endpoint splat's tap weights (F5), the scan's deskew and bin tables
   (F6), the weights' tail (F7: the max, the first argmax and its pose,
   Neff, the weighted mean pose and the shared map's scalar epilogue, the
   sums in ops/resample's fixed order) and the systematic walk in the
   resample gate's body (F8), XLA's fusions of the JAX step), which every
   path launches where it runs that glue: every recorded call of them (CallRecorder records
   them on every path it records; check_fusion; the mega path's first
   run and a mega refine step are recorded for them too) is held against
   its plain version, the op sequence it replaced, on the card, and one
   differing bit fails the run; here the parity log once more with their
   calls recorded, which of three sum orders of a 2 x 2 block gives
   PyTorch's mean over the pooled axes on this card (F2 must give it),
   which of six orders of the packed sample's eight products gives its
   torch.sum (sample_order: F4 must give today's sample), F6 on planted
   scans (equal bearings, +-0.0, +-pi, padding, an all-invalid scan; 96
   slots, where the card's stable argsort is a merge sort, and 192 and 360,
   a radix sort: both keep -0.0 and +0.0 in index order), F7's exp against
   torch.exp over 1M values (exp_probe: every bit), F3 and F7 on planted
   inputs bit for bit against their plain versions (fusion_edges: F3 at 1,
   250, 500, 2 048 and 500 000 particles in its three modes, the coarse
   stage with the scan's mask writing offsets, a fine stage writing
   offsets, the last stage writing the best pose, on scores that tie at
   the split points of its launch plan, NaN, -inf, +-0 and all equal; F7 at
   1 to 1 048 576 weights a robot, one and two robots, with and without the
   epilogue, on tied maxima and -inf weights; F7's mesh form at 8 to
   1 048 576 weights split over 2 and 4 ranks emulated by threads, its
   tail with and without the epilogue and its center call, and F8's mesh
   form on each rank's slots of the gathered rows), and a line of
   every path's checks; it fails where a path
   has no checked F6 call, a path of WEIGHTS_PATHS no checked
   F7 (the mesh paths F7's mesh form's) and F8 call (its eager steps run
   the gate's body every scan), a matcher path (parity, chip, pr1, mega_blocked,
   multi (10 000), posegraph's filter and closures, tiled) no checked F3
   call, or a surface path (mega, the city step, the mega_bf16 and
   city_bf16 steps, mega refine, shmap_surface, surface_sharded) no checked
   F4 and F5 call (mega refine also its hill-climb).  The captured phase
   prints each graph's kernel nodes a scan, and among them PyTorch's reduce
   and scan kernels, beside the torch reductions an eager replay
   dispatched by call site; it fails where a graph holds more kernel nodes
   a scan than the tree before F7 and F8 (NODES_A_SCAN_MAX), where one of
   those reductions is the weights' tail's (ops/resample.py, a step's
   argmax), or where a path built a packed neighbourhood array on the card
   (ops/surface.packs_on_card).

Each path (parity, mega, city, mega_blocked, multi at each particle count,
the posegraph flow's three parts: the filter, closure detection, the
rebuild; chip; pr1 and pr1_fullres; the captured phase's thirteen,
captured_<path>, counted over
the call that warms up and captures; the parallel phase's five: shmap,
shmap_surface, tiled, surface_sharded, sharded; the cli phase's eight: cli_replay,
cli_load_map, cli_surface, cli_tiled, cli_surface_sharded, cli_posegraph,
cli_recovery, cli_live; the bench phase's run, bench, and its one
measurement, bench_measure) is run with every
launch count set
to 0 just before it and read just after.  In phase 11 and on the paths of phases 15-18 the first
run also records the arguments of the first kernel call of every call
shape (CallRecorder), and a path_kernels line holds each kernel against
its plain version on exactly those arguments, with K2's fraction of cells
beyond its atol and K3's launch plan (a call of more than 4096
particles on its first and last 2048: each particle's output depends on
its own rows only); a kernel that ran on a part but was not checked there
fails the run.  Then
one JSON line of kernels, with their launches per path, their launches a
scan inside each captured path's graph, bounds and, in `stages`, K1's
stages at the parity shapes (the nearest-cell coarse stage among them)
and at pr1's, K2's and K3's at pr1's, F1-F8's rows (max error 0: their
bits; ms, plain ms and bound on the parity path's calls, F4's, F5's, F7's
and F8's on the mega path's, F3's, F4's, F6's, F7's and F8's stages),
and last
{"ok": true, "device": {...}}.
Any failure raises: the script exits non-zero and prints no "ok" line.
There is no CPU path: without a CUDA device it exits non-zero.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Each kernel call's bound (the larger of its operations over the H100's
# peak for their type and its bytes over the HBM rate), counted from the
# call's own inputs, as the benchmark counts it
from gridmap_slam_tpu_torch.bench.bounds import BF16_TC_FLOPS
# a recorded call of more than FULL_PARTICLES particles is compared on its
# first and its last SLICE_PARTICLES, as the benchmark's agreement compares
from gridmap_slam_tpu_torch.bench.bounds import (FULL_PARTICLES,
                                                 compared_parts)
from gridmap_slam_tpu_torch.bench.bounds import \
    particle_slice as _particle_slice
from gridmap_slam_tpu_torch.bench.kernels.k1 import k1_bound
from gridmap_slam_tpu_torch.bench.kernels.k1t import k1t_bound, k1t_cells
from gridmap_slam_tpu_torch.bench.kernels.k2 import k2_bound, k2w_bound
from gridmap_slam_tpu_torch.bench.kernels.k3 import k3_bound
from gridmap_slam_tpu_torch.bench.kernels.k4 import k4_bound

K1_RTOL, K1_ATOL = 2e-5, 2e-4     # tests/test_pallas_matcher.py
# no nearest-cell score may leave the tolerance either: the kernel and the
# plain version compute a tap's cell coordinate in one float order
# (ops/cuda/matcher.cell_coords), so they round to the same cell at ties
K1_NEAREST_MAX_FRAC = 0.0
# the k1_ties phase counts a tap within this much of a half cell as a tie
# (a few ulps of a world coordinate 4 000 cells from the origin)
K1_TIE_CELLS = 4e-3
K2_ATOL, K2_MAX_FRAC = 1e-5, 5e-3  # tests/test_pallas.py:124-126
K3_ATOL = 1e-5                     # tests/test_pallas.py:91
ATE_MAX_M = 0.10
ROOM_LOOP_ATE_MAX_M = 0.25         # ROADMAP item 11: 40 scans at 1M
N_SCANS = 12
SEED = 0
FFT_ATOL, FFT_MEAN = 5e-2, 5e-3    # tests/test_surface.py:223-224
DIRECT_RTOL, DIRECT_ATOL = 1e-5, 1e-3
TAPS_RTOL, TAPS_ATOL = 1e-6, 1e-5  # tests/test_surface.py:248-249
# grid_sample's trilinear sample (F4's library call) against F4: its own
# float order and its coordinates through [-1, 1] move a sample by a few
# ulps of a cell coordinate times the volume's slope (at most twice its
# largest magnitude a cell), so at most this share of the volume's largest
# magnitude; half a cell off would move it by a tenth or more
F4_LIBRARY_RTOL = 1e-4
SPLAT_RTOL = 1e-5                  # of the largest endpoint-image cell
K3_RADII_SIGMAS = (1.0, 4.0, 10.0, 20.0, 60.0)
AGREE_PARTICLES = 4096
MEGA_PARTICLES = 1_000_000
MULTI_PARTICLES = (32, 10_000)
MULTI_REVS = 20
GRAND_TOUR = "maps/grand_tour_216.rec"
CLI_LOG = "maps/room_loop_40.rec"
CLI_ATE_MAX_M = 0.10   # the JAX engine's: 0.0287 m (docs/ate_parity_room_loop_40.json)
CLI_FAULT_AT, CLI_EVERY = 6, 4
LIVE_FRAMES = 5
GN_LARGE_KEYFRAMES = (1000, 3000)
# The posegraph phase's online ATE against the JAX package's at its
# configuration (200 particles, 360 beam slots, 14 x 14 m at 5 cm, all 216
# scans of grand_tour_216.rec; JAX RBPF.step_jit on the CPU: 0.0905 m at
# seed 0, 0.0888 m at seed 1) plus docs/DIVERGENCES.md's cross-backend 0.06
POSEGRAPH_JAX_ATE_M = 0.0905
POSEGRAPH_ATE_MAX_M = POSEGRAPH_JAX_ATE_M + 0.06
# The config-5 chain-broken graph's optimized ATE a robot by the JAX
# frontend's own Gauss-Newton (scripts/config5_posegraph_reference.py), and
# its closures (docs/config5_demo.json); the port is held to + 0.06
CONFIG5_JAX_OPT_ATE_M = (0.037901868964208295, 0.017296637668428316)
CONFIG5_CLOSURES = 32
# the kernels in the frontend's graphs: a detection's verify (K1 5 stages
# and K2, K3 once, each way) and one keyframe of the rebuild
# (and F3 a K1 stage, F2 the coarse stage's pool, F6 a map's bin tables)
FRONTEND_NODES = {"verify": {"stage_scores": 10, "integrate_scan": 2,
                             "log_likelihood_field": 2, "surface_corr": 0,
                             "stage_scores_tile": 0, "motion": 0, "pool": 2,
                             "pick": 10, "sample": 0, "splat": 0,
                             "scan": 2, "weights": 0, "walk": 0,
                             "weights_mesh": 0, "walk_mesh": 0},
                  "rebuild": {"stage_scores": 0, "integrate_scan": 1,
                              "log_likelihood_field": 0, "surface_corr": 0,
                              "stage_scores_tile": 0, "motion": 0,
                              "pool": 0, "pick": 0, "sample": 0, "splat": 0,
                              "scan": 1, "weights": 0, "walk": 0,
                              "weights_mesh": 0, "walk_mesh": 0}}
CHIP_PARTICLES, CHIP_CHUNK = 10_000, 500       # bench.py:623-625
PR1_SCANS = 3          # the pr1 phase's scans under CallRecorder
# the wide phase's coarse stage: 51 x 51 (dy, dx) cells, more than F3's
# lanes hold in registers at once
WIDE_COARSE_NXY = 51
# the bench phase's one measurement with bench.py's flags: the pr1 preset
# with its coarse stage on nearest cells of the full 400 x 400 field (the
# global variant), the calls at 100 particles in which one rounding tie
# shows
BENCH_MEASURE = ["--preset", "pr1", "--set",
                 "matcher.coarse_halfres=false"]
# K4 against its plain version: the direct correlation's float32 bound
# (tests/test_torch_surface_corr.py); its shapes beside a mega_bf16 and a
# city_bf16 step's: (nt, K, Hc, Wc, images) with nt and K no multiples of 8
# and 16, crops not square, one shape with every dimension on the kernel's
# tiles (dense: one tap in ten nonzero, so nearly every 16-tap group is
# live) and one sparse shape, a splat of K4_SPLAT_BEAMS random beams
K4_RTOL, K4_ATOL = 1e-5, 1e-3
K4_SHAPES = ((1, 7, 10, 13, "random"), (5, 51, 17, 29, "random"),
             (7, 25, 40, 31, "random"), (16, 64, 128, 128, "random"),
             (9, 101, 37, 45, "splat"))
K4_SPLAT_BEAMS = 60
ODD_SHAPE = (37, 118, 123)         # a width that is no multiple of 4
# the parallel phase: shmap at 1M particles over the first 6 scans; tiled
# on the city map at the chip rung's 10 000 particles in chunks of 500;
# K1's tile variant checked over 2 and 4 tiles
PAR_SHMAP_SCANS = 6
PAR_TILED_PARTICLES, PAR_TILED_CHUNK = 10_000, 500
TILE_SHARDS = (2, 4)
# A beam whose base column sits within an ulp of a tile boundary may fall to
# either tile in the kernel's and the plain version's float order: one
# tile's partial score then differs by that beam's whole term, the tiles'
# sum does not (held with no candidate beyond).
K1_TILE_MAX_FRAC = 1e-3
TILED_ATOL = 1e-4          # poses and map against SharedMapSLAM.step
SS_POSE_ATOL, SS_MAP_ATOL, SS_NEFF_RTOL = 2e-3, 1e-3, 1e-3  # tests/test_surface_sharded.py:66-73
BA_CHI2_RTOL, BA_NODES_ATOL = 1e-3, 1e-3   # tests/test_ba.py:43-45
# F1-F8 (csrc/fusions.cu): their rows, and the paths on which the fusions
# phase requires their recorded calls held bit for bit against their
# plain versions (multi at 10 000 a robot; the posegraph flow's filter and
# closures)
FUSION_ROWS = ("motion", "pool", "pick", "sample", "splat", "scan",
               "weights", "walk", "weights_mesh", "walk_mesh")
# the surface paths, each of which must hold a checked F4 (and F5) call
# (the mega refine path its hill-climb's too)
SURFACE_PATHS = ("mega", "city step", "mega_bf16 step", "city_bf16 step",
                 "mega refine", "shmap_surface", "surface_sharded")
# every path must hold a checked F6 call, the matcher paths an F3 call
FUSION_PATHS = ("parity", "chip", "pr1", "mega_blocked", "multi 10000",
                "posegraph_rbpf", "posegraph_closures", "shmap", "tiled",
                "sharded", "wide51", *SURFACE_PATHS)
# the parallel phase's paths at mesh (1, 1), whose tail is F7's mesh form
MESH_PATHS = ("shmap", "shmap_surface", "tiled", "surface_sharded",
              "sharded")
# the paths each of which must hold a checked F7 call (the mesh paths F7's
# mesh form's) and, where a gate fired, a checked F8 call
WEIGHTS_PATHS = ("parity", "chip", "pr1", "mega_blocked", "multi 10000",
                 "posegraph_rbpf", "mega", "city step", "mega_bf16 step",
                 "city_bf16 step", "mega refine", *MESH_PATHS)
FUSION_CHECKS = []         # every recorded F1-F8 call's check, in order
FUSION_ARGS = {}           # the first recorded call's (args, kw) a kernel
# the kernel rows held in the conditional bodies of the frontend's graphs
# captured so far in this process (the rebuild's K2): CUPTI was seen to
# name records of another graph's bodies after them (the captured phase)
FOREIGN_BODY_ROWS = set()
# F3's operations a candidate: three bias sums, three squares, their sum,
# two divisions, a difference, two products and the add to its score
F3_FLOPS = 13
# F4's operations a sample: 15 for the three coordinates, 6 floors and
# fractions, 3 complements, 16 for the eight weights, 8 products and 7 sums
F4_FLOPS = 55
# F5's operations a (bin, beam) row (a sine and a cosine one each, the
# rotation, scale, floor, clamp and fractions) and a tap (two where-sums'
# add and the weight's product... counted 3)
F5_ROW_FLOPS, F5_TAP_FLOPS = 22, 3
# F6's operations a beam's deskew (a division, the time factor's products,
# sine, cosine, atan2, the radius and its square root) and wrap (3), and a
# bin's (its center, two differences, two wraps, two magnitudes, the
# compare); the sort's and the search's comparisons are added at log2 B
F6_DESKEW_FLOPS, F6_WRAP_FLOPS, F6_BIN_FLOPS = 16, 3, 14
# F6's operations a beam's endpoint (a sine, a cosine and two products)
F6_POINT_FLOPS = 4
# F7's operations a weight: the max's compare; the difference, exp and sum
# of the total; the difference, exp and quotient again, four products, the
# wrap's sine, cosine and atan2, four sums
F7_FLOPS = 18
# F8's operations a weight: the difference, exp and quotient, the segment's
# and the carry's sums, u's product and sum; then two a probe of the
# binary search (the carry's sum and the compare), log2 P probes
F8_FLOPS = 7
# F7's exp against torch.exp on the card over this many values
EXP_PROBE_VALUES = 1 << 20
# F4's rsqrtf against torch.rsqrt on the card: every used-beam count up to
# this, and as many random floats
RSQRT_PROBE_VALUES = 1 << 16
# the torch reductions and scans a step may dispatch (aten op names): the
# captured phase fails where one comes from the weights' tail, which F7
# and F8 hold on the card
REDUCTION_OPS = frozenset((
    "sum", "mean", "max", "min", "amax", "amin", "argmax", "argmin", "prod",
    "cumsum", "cumprod", "logsumexp", "_softmax", "any", "all", "nonzero",
    "norm", "linalg_vector_norm", "std", "var", "sort", "topk"))
# kernel launches of a CLI replay outside its step, once a run: the final
# map's overlay pose and scan (app/cli._overlay: apply_odometry, F1; the
# deskew, F6)
CLI_RUN_LAUNCHES = {"motion": 1, "scan": 1}
# kernel nodes a scan (a conditional node's body counted) that a captured
# path's first graph may hold at most: what the graphs held before F7 and F8
# took the weights' tail (this script's count on an H100 80GB HBM3, 700 W)
NODES_A_SCAN_MAX = {"parity": 116.09, "chip": 475.09, "pr1": 93.09,
                    "grand_tour_216": 94.07, "mega": 140.09,
                    "mega room_loop_40": 140.07, "mega refine": 140.09,
                    "mega_bf16": 129.09, "mega_direct": 127.09,
                    "city": 173.09, "city_bf16": 162.09,
                    "mega_blocked": 114.17, "multi": 138.07}


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
    1 to 5 dx candidates a thread), K1t's staged kernel's (bilinear or
    nearest, runs of 1 to 5), K2's (four cells a thread or one) and
    K3's (radius 1 to 4 compiled in, staged by 128-bit loads or cell by
    cell, and any radius) are summed up on the
    build line; K1's untiled and tile variants, K2's whole-map and window
    variants, K4's prologue and correlation.  K1's, K3's and K4's
    shared memory is dynamic: a call's plan sets it.  A spill in K2, K3,
    K4, F3 (twelve instantiations), F7 (its mesh form's passes too) or F8,
    or a spill store in K1 or K1t's
    staged kernel, fails the run.  K4 is its prologue (surface_corr_prep)
    and the correlation (surface_corr_kernel)."""
    from gridmap_slam_tpu_torch.ops.cuda import _build
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    _build.library()
    k1, k1t, k2, k3, k4, fused = [], [], [], [], [], []
    for name, use in sorted(_build.ptxas_usage(log).items()):
        m = re.search(r"fusion_(\w+?)_kernel", name)
        if m:
            fused.append(dict(kernel=m.group(1), **use))
        m = re.search(r"stage_scores_tile_kernelILb([01])ELi(\d)E", name)
        if m:
            k1t.append(dict(kernel="staged", nearest=m.group(1) == "1",
                            run=int(m.group(2)), **use))
        m = re.search(r"surface_corr_(kernel|prep)", name)
        if m:
            k4.append(dict(kernel=m.group(0), **use))
        m = re.search(r"stage_scores_kernelILb([01])ELb([01])ELi(\d)ELb([01])E",
                      name)
        if m:
            k1.append(dict(variant="shared" if m.group(1) == "1" else
                           "global", nearest=m.group(2) == "1",
                           run=int(m.group(3)), tile=m.group(4) == "1",
                           **use))
        m = re.search(r"grid_update_kernelILb([01])ELb([01])E", name)
        if m:
            k2.append(dict(cells_per_thread=4 if m.group(1) == "1" else 1,
                           window=m.group(2) == "1", **use))
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
        k1_variants=k1, k1_tile_staged_variants=k1t, k2_variants=k2,
        k3_variants=k3, k4_kernels=k4, fusion_kernels=fused)
    tail = [v for v in fused
            if v["kernel"].startswith(("weights", "walk", "mesh"))]
    if len(tail) != 14 or any(v["spill_stores"] or v["spill_loads"]
                              for v in tail):
        raise AssertionError(f"F7 and F8: expected 14 kernels (F7's four "
                             f"and its mesh form's four, F8's two and its "
                             f"mesh form's four) without spills: {tail}")
    pick = [v for v in fused if v["kernel"] == "pick"]
    if len(pick) != 12 or any(v["spill_stores"] or v["spill_loads"]
                              for v in pick):
        raise AssertionError(f"F3: expected 12 instantiations (staged or "
                             f"not, 1, 2, 3, 4 or 8 cells a lane, and 8 a "
                             f"group of a lane's cells) without spills: "
                             f"{pick}")
    if len(k2) != 3 or len(k3) != 9 or len(k4) != 2 or any(
            v["spill_stores"] or v["spill_loads"] for v in k2 + k3 + k4):
        raise AssertionError(f"K2: expected 3 instantiations, K3: 9, K4: 2, "
                             f"none with spills: {k2} {k3} {k4}")
    # shared or global field, bilinear or nearest, and the tile variant's
    # shared-field instantiations
    if len(k1) != 6 * kmatch.MAX_RUN or any(
            v["spill_stores"] or (v["run"] <= 3 and
                                  v["registers"] > kmatch.REGISTERS)
            for v in k1):
        raise AssertionError(f"K1: expected {6 * kmatch.MAX_RUN} "
                             f"instantiations without spills, runs of 1-3 "
                             f"within {kmatch.REGISTERS} registers: {k1}")
    if len(k1t) != 2 * kmatch.MAX_RUN or any(v["spill_stores"] for v in k1t):
        raise AssertionError(f"K1t's staged kernel: expected "
                             f"{2 * kmatch.MAX_RUN} instantiations without "
                             f"spills: {k1t}")


def k4_dense_ms(args) -> float:
    """For context, not a bound: the nt K^2 Hc Wc products of the dense
    correlation (zero taps included) at the dense bf16 tensor-core peak."""
    fpad, e_stack = args[0], args[1]
    nt, k = e_stack.shape[0], e_stack.shape[1]
    hc, wc = fpad.shape[0] - k + 1, fpad.shape[1] - k + 1
    return 2.0 * nt * k * k * hc * wc / BF16_TC_FLOPS * 1e3


def k3_plan(args) -> dict:
    """The launch plan K3 runs these arguments with."""
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    plan = likelihood.plan_for(*args)
    return dict(variant=plan.variant, tile=[plan.tile_h, plan.tile_w],
                grid=[args[0].shape[0], plan.bands, plan.tiles],
                threads=plan.threads, smem_bytes=plan.smem_bytes)


def k4_plan(args) -> dict:
    """The launch plan K4 runs these arguments with."""
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr
    return surface_corr.plan_for(args[0], args[1])._asdict()


def k1_variant(args, tile=False) -> str:
    """The K1 variant launch_plan picks for these arguments; with `tile`,
    tile_launch_plan's (K1t): shared or staged."""
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    field, px, _, _, pose0, dxs, dys, dts = args
    shapes = (pose0.shape[0], field.shape[0], field.shape[1],
              field.shape[2], px.shape[-1], dts.shape[1], dys.shape[1],
              dxs.shape[1])
    limits = kmatch.device_limits(field.device.index)
    plan = kmatch.tile_launch_plan if tile else kmatch.launch_plan
    return plan(*shapes, **limits).variant


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
    # The nearest-cell branch (coarse_halfres=False: the parity_fullres
    # cell's coarse stage), timed and counted in the row's `stages` and its
    # error.
    stages.append(("coarse nearest", llf) + stages[0][2:-1] + (res,))
    # score_pose's single candidate (the matcher switched off): a map a
    # particle takes the global variant, one shared map the shared one
    zero = torch.zeros((p, 1), device=dev)
    stages += [("score_pose", llf, px, py, use, zero, zero, zero, res),
               ("score_pose shared map", llf[:1].contiguous(), px, py, use,
                zero, zero, zero, res)]
    err1, ms1, plain1, bound1, by_ops = 0.0, 0.0, 0.0, 0.0, 0.0
    by_stage = {}
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
        by_stage[name] = dict(variant=k1_variant(args), nearest=nearest,
                              field=list(field.shape), max_abs_err=err,
                              frac_beyond_tol=frac, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by,
                              share_of_bound=bound / ms)
        if name == "coarse nearest":
            err1 = max(err1, err)
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
                     else "bytes", library_ms=None, stages=by_stage))
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
    W + 1 (the ring's far cells) and 200 cells past W, in x and in y, under
    offsets of quarter cells, for 64 particles of which half sit on the
    cell grid (so that many taps land within an ulp of a half cell, where
    the nearest branch rounds) and half are jittered by a few hundredths
    of a cell; on one 120 x 120 field (the shared variant, whose ring of 2
    cells the kernel clamps into) and one 280 x 280 field (the global
    variant), bilinear and nearest, with no score beyond the tolerance.
    Returns the largest bilinear error."""
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
        jitter = rng.uniform(-0.05, 0.05, (n, 2)) * res
        jitter[: n // 2] = 0.0
        pose0 = t(np.concatenate([jitter, np.zeros((n, 1))], 1))
        off = t(np.broadcast_to(np.array([-0.5, -0.25, 0.0, 0.25, 0.5])
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


def _tie_inputs(rng, p, w_cells, h_cells, b, res, origin, rotated, dev):
    """A tie grid for p particles: poses on the cell grid, at heading 0
    (one scan, (B,)) or at random headings (a scan row a particle, (p, B)),
    whose endpoints, rotated and moved by the pose, land a few ulps from
    cell edges between 8 cells in and 8 cells short of w_cells x h_cells;
    nine cell-aligned offsets on each axis and eleven headings, all the
    pose's (dθ = 0), as many as the coarse stage's.  Returns the arguments
    of a K1 call after the field."""
    f32 = np.float32
    pose = np.zeros((p, 3), f32)
    pose[:, :2] = rng.integers(-3, 4, (p, 2)) * res
    if rotated:
        pose[:, 2] = rng.uniform(-math.pi, math.pi, p)
    rows = p if rotated else 1
    edge = (np.asarray(origin)[None, :, None]
            + np.stack([rng.integers(8, w_cells - 8, (rows, b)),
                        rng.integers(8, h_cells - 8, (rows, b))], 1) * res
            - pose[:rows, :2, None].astype(np.float64))
    th = pose[:rows, 2, None].astype(np.float64)
    c, s = np.cos(th), np.sin(th)
    pts = np.stack([c * edge[:, 0] + s * edge[:, 1],
                    -s * edge[:, 0] + c * edge[:, 1]], 1).astype(f32)
    steps = rng.integers(-3, 4, pts.shape)        # a few ulps off the edge
    toward = np.copysign(np.inf, steps).astype(f32)
    for k in range(1, 4):
        pts = np.where(np.abs(steps) >= k, np.nextafter(pts, toward), pts)
    px, py = (pts[:, i] if rotated else pts[0, i] for i in (0, 1))
    use = rng.uniform(size=px.shape) > 0.1
    offs = np.broadcast_to(((np.arange(9) - 4) * res).astype(f32), (p, 9))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (t(px), t(py), t(use), t(pose), t(offs), t(offs),
            torch.zeros((p, 11), device=dev))


def k1_ties_phase(cfg, dev="cuda"):
    """K1's nearest branch at rounding ties, kernel against plain version
    on the card with no score beyond the tolerance: tie grids
    (_tie_inputs) at heading 0 and at random headings, at the parity
    shapes (500 particles, a 120 x 120 field each: the shared variant),
    pr1's (100 particles, 400 x 400: the global variant) and on tiles:
    the sharded RBPF's 120 x 62 tiles of 250 particles' maps (kTiled) and
    both 4000 x 2002 tiles of the city map for 256 particles (the staged
    tile kernel); the offsets cell-aligned, as the coarse stage's; fields
    of random cells, so that a tap on another cell shows.  Also:
    the kernel's sin and cos (kmatch.kernel_rotation) equal torch's on the
    card in every bit, the plain version's coordinates (cell_coords) on
    the card equal its coordinates on the CPU in every bit at heading 0
    (where torch's sin and cos are exact on both), and the taps within
    K1_TIE_CELLS of a half cell are counted.  The errors go into the K1
    and K1t rows' max_abs_err (PATH_MAX_ERR)."""
    from gridmap_slam_tpu_torch import city_config
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch

    rng = np.random.default_rng(SEED + 8)
    res, origin, maxr = cfg.map.resolution, cfg.map.origin, \
        cfg.sensor.max_range
    theta = torch.as_tensor(rng.uniform(-4 * math.pi, 4 * math.pi, 1 << 20)
                            .astype(np.float32), device=dev)
    sn, cs = kmatch.kernel_rotation(theta)
    rotation_equal = bool(torch.equal(sn, torch.sin(theta))
                          and torch.equal(cs, torch.cos(theta)))
    v_out = math.log(1.0 / maxr)
    city = city_config().map
    cases = [("parity", 500, (500, 120, 120), origin, None),
             ("pr1", 100, (100, 400, 400), (-10.0, -10.0), None),
             ("sharded tile", 250, (250, 120, 120), origin, 2),
             ("city tile", 256, (1, city.cells_y, city.cells_x),
              city.origin, 2)]
    rows = []
    for name, p, shape, org, n_m in cases:
        field = torch.empty(shape, device=dev).uniform_(-8.0, -0.5)
        for rotated in (False, True):
            args = _tie_inputs(rng, p, shape[2], shape[1], 48, res, org,
                               rotated, dev)
            kw = dict(resolution=res, origin=org, max_range=maxr,
                      nearest=True)
            fx, fy = kmatch.cell_coords(
                *kmatch._scan_rows(*args[:3], p)[:2], *args[3:],
                resolution=res, origin=org)
            ties = int(((fx - fx.floor() - 0.5).abs() < K1_TIE_CELLS).sum()
                       + ((fy - fy.floor() - 0.5).abs() < K1_TIE_CELLS)
                       .sum())
            cpu_equal = None
            if not rotated:
                cpu = [a.cpu() for a in args]
                cx, cy = kmatch.cell_coords(
                    *kmatch._scan_rows(*cpu[:3], p)[:2], *cpu[3:],
                    resolution=res, origin=org)
                cpu_equal = bool(torch.equal(cx, fx.cpu())
                                 and torch.equal(cy, fy.cpu()))
            calls = []
            if n_m is None:
                calls.append(("untiled", (field,) + args, kw,
                              kmatch.stage_scores_batch_cuda,
                              kmatch.stage_scores_batch_plain))
            else:
                w_loc = shape[2] // n_m
                for j in range(n_m):
                    tkw = dict(kw, c0=j * w_loc, w_loc=w_loc, n_m=n_m,
                               ext=1)
                    calls.append((f"tile {j}",
                                  (_ext_tile(field, j, n_m, v_out),) + args,
                                  tkw, kmatch.stage_scores_tile_cuda,
                                  kmatch.stage_scores_tile_plain))
            for part, a, k, cuda_fn, plain_fn in calls:
                got, want = cuda_fn(*a, **k), plain_fn(*a, **k)
                diff = (got - want).abs()
                beyond = int((diff > K1_ATOL + K1_RTOL * want.abs()).sum())
                row = KERNEL_ROWS["K1" if n_m is None else "K1t"]
                PATH_MAX_ERR[row] = max(PATH_MAX_ERR[row],
                                        float(diff.max()))
                rows.append(dict(
                    case=name, part=part, rotated=rotated,
                    variant=k1_variant(a, tile=n_m is not None),
                    field=list(a[0].shape), ties=ties,
                    taps=fx.numel() + fy.numel(), scores=got.numel(),
                    beyond=beyond, max_abs_err=float(diff.max()),
                    cpu_cells_equal=cpu_equal))
    say("k1_ties", rotation_bits_equal=rotation_equal,
        headings=theta.numel(), tie_cells=K1_TIE_CELLS, rows=rows)
    variants = {(r["case"], r["variant"]) for r in rows}
    if not rotation_equal or any(r["beyond"] or r["cpu_cells_equal"] is False
                                 or not r["ties"] for r in rows):
        raise AssertionError(f"K1 at rounding ties: {rows}")
    if variants != {("parity", "shared"), ("pr1", "global"),
                    ("sharded tile", "shared"), ("city tile", "staged")}:
        raise AssertionError(f"K1 at rounding ties took {variants}")


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
    if not all(launches[k] > 0 for k in (*BASE_ROWS, "motion", "pool",
                                         "pick", "scan")):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if not ate < ATE_MAX_M:
        raise AssertionError(f"parity ATE {ate} >= {ATE_MAX_M}")
    if not (occ > 50 and free > 1000):
        raise AssertionError(f"best map too empty: {occ} occupied, "
                             f"{free} free")
    return launches


class _TileCount:
    """K1's tile variant's launch count (ops/cuda/matcher.tile_launches)
    read and set as a module's `launches`."""

    @property
    def launches(self):
        from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
        return kmatch.tile_launches

    @launches.setter
    def launches(self, n):
        from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
        kmatch.tile_launches = n


class _FusionCount:
    """One of F1-F8's launch counts (ops/cuda/fusions.motion_launches,
    pool_launches, pick_launches, sample_launches, splat_launches,
    scan_launches, weights_launches, walk_launches, and the mesh forms'
    weights_mesh_launches and walk_mesh_launches) read and set as a
    module's `launches`."""

    def __init__(self, attr: str):
        self.attr = attr

    @property
    def launches(self):
        from gridmap_slam_tpu_torch.ops.cuda import fusions
        return getattr(fusions, self.attr)

    @launches.setter
    def launches(self, n):
        from gridmap_slam_tpu_torch.ops.cuda import fusions
        setattr(fusions, self.attr, n)


def _kernel_modules():
    from gridmap_slam_tpu_torch.ops.cuda import grid_update, likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr
    return {"stage_scores": kmatch, "integrate_scan": grid_update,
            "log_likelihood_field": likelihood,
            "stage_scores_tile": _TileCount(), "surface_corr": surface_corr,
            **{row: _FusionCount(f"{row}_launches") for row in FUSION_ROWS}}


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
    from gridmap_slam_tpu_torch.ops.cuda import fusions, likelihood
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
    # the sample alone: the weights' temperature F4 also applies is held in
    # the fusions phase
    kw = {k: v for k, v in kw.items() if k not in ("temp", "n_used")}

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

    # the trilinear sample at 1M poses around the cloud, some past the
    # volume's span: the 8-tap form, the packed form (F4's plain version:
    # the pack and its gather) and F4 (the volume read in place)
    rng = np.random.default_rng(SEED + 2)
    n = 1_000_000
    noise = rng.uniform(-1, 1, (n, 3)) * np.array([1.0, 1.0, 0.6])
    poses = center + torch.as_tensor(noise.astype(np.float32), device="cuda")
    s_taps = sf.sample_surface(c_vol, poses, **kw)
    s_f4 = fusions.score_cuda(c_vol, poses, **kw)[1]
    t_err, _, t_ok = _close(s_f4, s_taps, TAPS_RTOL, TAPS_ATOL)
    f4_bits = _bits_differing(s_f4, fusions.score_plain(c_vol, poses,
                                                        **kw)[1])
    taps_ms = cuda_ms(lambda: sf.sample_surface(c_vol, poses, **kw), 10)
    pack_ms = cuda_ms(lambda: fusions.score_plain(c_vol, poses, **kw), 10)
    f4_ms = cuda_ms(lambda: fusions.score_cuda(c_vol, poses, **kw), 10)
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
        sample_poses=n, f4_vs_taps_max_abs=t_err,
        f4_vs_packed_bits_differing=f4_bits,
        volume_build_ms=volume_ms, sample_taps_ms=taps_ms,
        sample_packed_ms=pack_ms, sample_f4_ms=f4_ms,
        pack_build_ms=pack_build_ms,
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
    if not t_ok or f4_bits:
        raise AssertionError(f"F4 vs the 8-tap sample: max {t_err}; vs the "
                             f"packed sample: {f4_bits} bits differ")


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


def bf16_config(bf16: bool = True):
    """mega with the direct correlation: in bf16 on K4 (mega_bf16) or in
    float32 on cuDNN (mega_direct)."""
    from gridmap_slam_tpu_torch import mega_config
    return mega_config().with_overrides({"matcher.surface_corr": "direct",
                                         "matcher.surface_bf16": bf16})


def city_bf16_config():
    """city with the direct correlation in bf16 on K4 (city_bf16): a
    (916, 916) padded field, 25 bins of 405 x 405 taps."""
    from gridmap_slam_tpu_torch import city_config
    return city_config().with_overrides({"matcher.surface_corr": "direct",
                                         "matcher.surface_bf16": True})


def _k4_inputs(nt, k, hc, wc, images, rng):
    """A padded field in [log(1/10), 0] and endpoint images on the card, and
    K4's other arguments.  images "random": one cell in ten weighted in
    [0, 1); "splat": the bilinear splat (ops/surface.py) of K4_SPLAT_BEAMS
    beams at random bearings and ranges inside the kernel, over bins
    +-0.3 rad."""
    from gridmap_slam_tpu_torch.ops.surface import splat_endpoint_kernels
    fpad = torch.as_tensor(rng.uniform(math.log(0.1), 0.0, (
        hc + k - 1, wc + k - 1)).astype(np.float32), device="cuda")
    if images == "splat":
        kc = (k - 1) // 2
        bearing = rng.uniform(-math.pi, math.pi, K4_SPLAT_BEAMS)
        rng_cells = rng.uniform(0.2, 0.95, K4_SPLAT_BEAMS) * kc
        beams = [torch.as_tensor(v.astype(np.float32), device="cuda")
                 for v in (rng_cells * np.cos(bearing),
                           rng_cells * np.sin(bearing),
                           rng.uniform(0.5, 1.0, K4_SPLAT_BEAMS))]
        e = splat_endpoint_kernels(*beams, torch.linspace(
            -0.3, 0.3, nt, device="cuda"), kc, 1.0).contiguous()
    else:
        e = rng.uniform(0.0, 1.0, (nt, k, k)) * (rng.uniform(size=(nt, k, k))
                                                 < 0.1)
        e = torch.as_tensor(e.astype(np.float32), device="cuda")
    return fpad, e, -0.5 * math.log(0.1), e.sum((1, 2))


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() inside a CUDA graph of `reps` calls
    (captured after warm-up): the launches' host time left out, which at
    tens of microseconds a kernel would otherwise be what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def k4_kernels_ms(args, reps: int = 10) -> dict:
    """Device ms a call of each of K4's kernels (the prologue, the
    correlation) on `args`, from torch.profiler over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4
    k4.surface_corr_bf16_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            k4.surface_corr_bf16_cuda(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        m = re.search(r"surface_corr_(prep|kernel)", e.name)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return out


def _recorded_k4(name, cfg, frames, warm):
    """`warm` steps of SharedMapSLAM(cfg) on the card, then one step with
    its kernel calls recorded (CallRecorder) and held against their plain
    versions (check_recorded), then one more under the sync check.
    Returns K4's recorded arguments, the step's launches and the checks."""
    from gridmap_slam_tpu_torch import SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4

    eng = SharedMapSLAM(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = eng.init()
    for i in range(warm):
        state, _ = eng.step_surface(state, frame_at(batch, i), gen)
    kernels = _zero_launches()
    torch.cuda.synchronize()
    with CallRecorder(name) as rec:
        state, _ = eng.step_surface(state, frame_at(batch, warm), gen)
    torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in kernels.items()}
    if launches["surface_corr"] != k4.KERNELS:
        raise AssertionError(f"a {name} launched K4's kernels "
                             f"{launches['surface_corr']} times, not "
                             f"{k4.KERNELS}")
    checks = check_recorded(rec, {name: launches})
    args = next(a for _, kernel, a, _ in rec.calls if kernel == "K4")
    _sync_free(lambda: eng.step_surface(state, frame_at(batch, warm + 1),
                                        gen))
    return args, launches, [c for c in checks if c["kernel"] == "K4"]


def _prep_differs(got, want) -> list:
    """The buffers of two K4 preparations that differ (entries past a tap
    row's count are not compared)."""
    if not torch.equal(got.counts, want.counts):
        return ["counts"]
    kept = (torch.arange(got.ks.shape[-1], device=got.ks.device)
            < got.counts[..., None])
    bad = [] if torch.equal(got.field, want.field) else ["field"]
    if not torch.equal(torch.where(kept, got.ks, 0),
                       torch.where(kept, want.ks, 0)):
        bad.append("ks")
    keep = kept[..., None, None]
    if not torch.equal(torch.where(keep, got.frags, 0),
                       torch.where(keep, want.frags, 0)):
        bad.append("frags")
    return bad


def _k4_case(name, args) -> dict:
    """K4 on `args` against its plain version (twice: the same bits), its
    prologue against the plain preparation, and the live groups."""
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4
    fpad, e, shift, mass = args
    got = k4.surface_corr_bf16_cuda(fpad, e, shift, mass)
    again = k4.surface_corr_bf16_cuda(fpad, e, shift, mass)
    want = k4.surface_corr_bf16_plain(fpad, e, shift, mass)
    err, mean, ok = _close(got, want, K4_RTOL, K4_ATOL)
    plan = k4.plan_for(fpad, e)
    prep = k4.prepare_bf16_cuda(fpad, e, shift)
    live = int(prep.counts.sum())
    row = dict(case=name, nt=e.shape[0], K=e.shape[1],
               volume=list(got.shape[1:]), max_abs_err=err,
               mean_abs_err=mean, max_abs=float(want.abs().max()),
               rtol=K4_RTOL, atol=K4_ATOL, within=ok,
               repeats_bitwise=bool(torch.equal(got, again)),
               nonzero_taps=int((k4.round_bf16(e) != 0).sum()),
               live_groups=live,
               live_share=live / prep.counts.numel() / plan.ksteps,
               live_tap_rows_share=float((prep.counts > 0).float().mean()),
               prep_differs=_prep_differs(
                   prep, k4.prepare_bf16_plain(fpad, e, shift, plan)),
               plan=plan._asdict())
    if not (ok and row["repeats_bitwise"] and not row["prep_differs"]):
        say("k4", shapes=[row])
        raise AssertionError(f"K4 at {name}: {row}")
    return row


def k4_phase(frames):
    """K4 on the card.  A mega_bf16 engine (1M particles, the direct bf16
    correlation) runs 3 scans and a city_bf16 engine 1; the next step of
    each is recorded (CallRecorder: K4 launches its KERNELS kernels once,
    K4, K3 and K2 held against their plain versions on its very
    arguments) and one more runs under the sync check.  Then K4 on the two
    steps' arguments and at K4_SHAPES, each against its plain version,
    twice (the same bits), its prologue against the plain preparation
    (bit for bit on the live groups), with the live groups' share.  Times
    at both steps: K4 ("ms": CUDA events around back-to-back calls from
    Python, as every kernel's ms in the kernels line; "graph_ms": device
    time inside a CUDA graph of such calls, the launches' host time left
    out), its bound from the call's own nonzero taps and its share of the
    graph time, the dense product count at
    the bf16 peak for context, its plain version, the one PyTorch call
    that computes the same function (cuDNN's float32 conv2d of the rounded
    operands, TF32 off) and, at mega, for context only, a bf16 conv2d (a
    bf16 volume) and the float32 FFT at that crop.  Returns K4's row of
    the kernels line."""
    import torch.nn.functional as F

    from gridmap_slam_tpu_torch.ops import surface as sf
    from gridmap_slam_tpu_torch.ops.cuda import surface_corr as k4
    from gridmap_slam_tpu_torch.ops.precision import f32_conv

    args, launches, checks = _recorded_k4("mega_bf16 step", bf16_config(),
                                          frames, 3)
    city_args, city_launches, city_checks = _recorded_k4(
        "city_bf16 step", city_bf16_config(), frames, 1)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 4)
    cases = ([("mega_bf16 step", args), ("city_bf16 step", city_args)]
             + [(f"nt {nt} K {k} {hc}x{wc} {images}",
                 _k4_inputs(nt, k, hc, wc, images, rng))
                for nt, k, hc, wc, images in K4_SHAPES])
    shapes = [_k4_case(name, a) for name, a in cases]

    def timings(a, big):
        fpad, e, shift, mass = a
        ra, rb = k4.round_bf16(fpad + shift), k4.round_bf16(e)

        def library():
            with f32_conv():
                return F.conv2d(ra[None, None], rb[:, None])

        bound, by = k4_bound(a)
        reps = 10 if big else 50
        graph = graph_ms(lambda: k4.surface_corr_bf16_cuda(*a), reps)
        row = dict(
            ms=cuda_ms(lambda: k4.surface_corr_bf16_cuda(*a), reps),
            graph_ms=graph, bound_ms=bound, bound_by=by,
            share_of_bound=bound / graph,
            kernels_ms=k4_kernels_ms(a),
            dense_products_ms_at_bf16_peak=k4_dense_ms(a),
            plain_ms=cuda_ms(lambda: k4.surface_corr_bf16_plain(*a), 3),
            library_ms=cuda_ms(library, 3))
        if not big:
            ab, bb = ra.to(torch.bfloat16), rb.to(torch.bfloat16)
            n = sf._fft_size(fpad.shape[0])

            def fft():
                f_hat = torch.fft.rfft2(fpad, s=(n, n))
                e_hat = torch.fft.rfft2(e, s=(n, n))
                return torch.fft.irfft2(f_hat[None] * torch.conj(e_hat),
                                        s=(n, n))

            row.update(bf16_conv2d_ms=cuda_ms(
                lambda: F.conv2d(ab[None, None], bb[:, None]), 5),
                fft_f32_ms=cuda_ms(fft, 20), fft_len=n)
        return row

    mega_t, city_t = timings(args, False), timings(city_args, True)
    say("k4", shapes=shapes, **mega_t, library="cuDNN float32 conv2d of the "
        "rounded operands (TF32 off)", city=city_t,
        clusters_resident=k4.cluster_limits(0, k4.plan_for(*args[:2])
                                            .smem_bytes),
        step_launches=launches,
        city_step_launches=city_launches, warm_step_synchronizing_calls=0,
        recorded_checks=checks + city_checks)
    shares = [mega_t["share_of_bound"], city_t["share_of_bound"]] + [
        c["share_of_bound"] for c in checks + city_checks]
    if max(shares) > 1.0:
        raise AssertionError(f"K4 above its bound: shares {shares}")
    return dict(name="surface_corr", route="cuda",
                source="gridmap_slam_tpu_torch/csrc/surface_corr.cu",
                replaces="gridmap_slam_tpu/ops/surface.py:170",
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                ms=mega_t["ms"], plain_ms=mega_t["plain_ms"],
                bound_ms=mega_t["bound_ms"], bound_by=mega_t["bound_by"],
                library_ms=mega_t["library_ms"])


def surface_path(preset, cfg, frames, gt, ate_max, record=False):
    """Drive SharedMapSLAM(cfg, device="cuda").run_log over `frames` with
    every launch count set to 0 just before, then again with the same seed;
    returns (the counts, the engine, the first run's state, the frames, its
    trajectory of weighted poses).  record=True: the first run's kernel
    calls are recorded (CallRecorder, the path `preset`) and held against
    their plain versions (check_recorded; F1-F8 bit for bit)."""
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
    with (CallRecorder(preset) if record
          else contextlib.nullcontext()) as rec:
        state, infos = eng.run_log(
            eng.init(), seq,
            torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    if record:
        check_recorded(rec, {preset: launches})

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
    if not all(launches[k] > 0 for k in (
            "log_likelihood_field", "integrate_scan", "motion", "sample",
            "splat", "scan")):
        raise AssertionError(f"{preset}: K3, K2, F1, F4, F5 or F6 was not "
                             f"launched: {launches}")
    if not ate < ate_max:
        raise AssertionError(f"{preset} ATE {ate} >= {ate_max}")
    if not (occ > 50 and free > 1000):
        raise AssertionError(f"{preset}: map too empty: {occ} occupied, "
                             f"{free} free")
    return launches, eng, state, seq, traj


def mega_phase(frames, gt):
    """mega on the 12-scan log, then on room_loop_40.rec; returns the first
    run's launches and the room loop's trajectory and map (host arrays),
    which the cli phase's surface replay must repeat bit for bit."""
    from gridmap_slam_tpu_torch import mega_config
    from gridmap_slam_tpu_torch.io import read_recording

    launches = surface_path("mega", mega_config(), frames, gt, ATE_MAX_M,
                            record=True)[0]
    _, _, state, _, traj = surface_path(
        "mega room_loop_40", mega_config(), read_recording(CLI_LOG),
        np.load(CLI_LOG.replace(".rec", "_gt.npy")), ROOM_LOOP_ATE_MAX_M)
    return launches, (traj, state.logodds.cpu().numpy())


KERNEL_ROWS = {"K1": "stage_scores", "K2": "integrate_scan",
               "K3": "log_likelihood_field", "K1t": "stage_scores_tile",
               "K2w": "integrate_scan", "K4": "surface_corr",
               "F1": "motion", "F2": "pool", "F3": "pick", "F4": "sample",
               "F5": "splat", "F6": "scan", "F7": "weights", "F8": "walk",
               "F7m": "weights_mesh", "F8m": "walk_mesh"}
# the rows of the untiled paths (K1's tile variant runs on tiled maps only)
BASE_ROWS = ("stage_scores", "integrate_scan", "log_likelihood_field")
_ENTRY = {"K1": ("matcher", "stage_scores_batch_cuda"),
          "K1t": ("matcher", "stage_scores_tile_cuda"),
          "K2w": ("grid_update", "integrate_scan_window_cuda"),
          "K2": ("grid_update", "integrate_scan_batch_cuda"),
          "K3": ("likelihood", "log_likelihood_field_batch_cuda"),
          "K4": ("surface_corr", "surface_corr_bf16_cuda"),
          "F1": ("fusions", "motion_cuda"), "F2": ("fusions", "pool_cuda"),
          "F3": ("fusions", "pick_cuda"), "F4": ("fusions", "score_cuda"),
          "F5": ("fusions", "splat_cuda"),
          "F6": ("fusions", "scan_cuda"), "F7": ("fusions", "weights_cuda"),
          "F8": ("fusions", "walk_cuda"),
          "F7m": ("fusions", "weights_mesh_cuda"),
          "F8m": ("fusions", "walk_mesh_cuda")}
PATH_MAX_ERR = {row: 0.0 for row in KERNEL_ROWS.values()}
BOUNDS = {"K1": k1_bound, "K2": k2_bound, "K3": k3_bound, "K1t": k1t_bound,
          "K2w": k2w_bound, "K4": k4_bound}


def _sig(x):
    """What makes two calls the same call shape: the tensors' shapes and
    dtypes and every other argument's value."""
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if dataclasses.is_dataclass(x):        # Odom: its fields, not its repr
        return tuple(_sig(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    return repr(x)


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        vals = tuple(_clone(v) for v in x)
        return type(x)(*vals) if hasattr(x, "_fields") else vals
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
    function looks up at every call) is wrapped: the first
    `calls_a_shape` calls of every call shape under the current `path`
    label are kept, their tensors cloned, and the kernel then runs and
    counts its launch as before.  `kernels`: the _ENTRY keys to record
    (all of them, F1-F8 among them, by default)."""

    def __init__(self, path: str, calls_a_shape: int = 1, kernels=_ENTRY):
        self.path = path
        self.calls = []            # (path, kernel, args, kw)
        self.calls_a_shape = calls_a_shape
        self.kernels = tuple(kernels)
        self._seen = {}
        self._real = []

    def __enter__(self):
        for kernel in self.kernels:
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
            # under capture nothing runs: a capture's warm-up calls
            # recorded the real inputs of its call shapes
            if (self._seen.get(key, 0) < self.calls_a_shape
                    and not torch.cuda.is_current_stream_capturing()):
                self._seen[key] = self._seen.get(key, 0) + 1
                self.calls.append((self.path, kernel, _clone(args),
                                   _clone(kw)))
            return real(*args, **kw)
        return call


def check_recorded(rec: CallRecorder, launches_by_path) -> list:
    """Each recorded call again, on the kernel and on its plain version, on
    the very arguments the path passed: whole up to FULL_PARTICLES, else
    the real call's first and last SLICE_PARTICLES' rows against the plain
    version on those particles; F1-F8's calls whole, bit for bit
    (check_fusion, kept in FUSION_CHECKS).  Raises beyond the kernel's
    tolerance, or where a kernel launched on a path (`launches_by_path`)
    has no recorded call there.  Returns the checks of the other kernels,
    one dict a call."""
    checks, fused = [], []
    for path, kernel, args, kw in rec.calls:
        if kernel in FUSIONS:
            fused.append(check_fusion(path, kernel, args, kw))
            continue
        mod, attr = _entry(kernel)
        cuda_fn = getattr(mod, attr)
        plain_fn = getattr(mod, attr.replace("_cuda", "_plain"))
        p = (1 if kernel in ("K2w", "K4") else
             (args[4] if kernel in ("K1", "K1t") else args[0]).shape[0])
        parts = compared_parts(p)
        got_all = cuda_fn(*args, **kw)
        err, beyond, changed, n_out = 0.0, 0, 0, 0
        for a, n in parts:
            sub = args if n == p else _particle_slice(kernel, args, a, n)
            want = plain_fn(*sub, **kw)
            got = got_all if kernel in ("K2w", "K4") else got_all[a:a + n]
            diff = (got - want).abs()
            err = max(err, float(diff.max()))
            n_out += diff.numel()
            if kernel in ("K1", "K1t"):
                beyond += int((diff > K1_ATOL + K1_RTOL * want.abs()).sum())
            elif kernel in ("K2", "K2w"):
                beyond += int((diff > K2_ATOL).sum())
                changed += int((want != sub[0]).sum())
            elif kernel == "K4":
                beyond += int((diff > K4_ATOL + K4_RTOL * want.abs()).sum())
            else:
                beyond += int((diff > K3_ATOL).sum())
        del got_all
        first = args if parts[0][1] == p else _particle_slice(
            kernel, args, *parts[0])
        ms = cuda_ms(lambda: cuda_fn(*args, **kw),
                     20 if p <= FULL_PARTICLES else 3)
        plain_ms = cuda_ms(lambda: plain_fn(*first, **kw), 3)
        if kernel == "K2w":        # the window's cells, not the map's
            n_out = kw["size"][0] * kw["size"][1]
        frac = beyond / n_out
        nearest_frac = K1_NEAREST_MAX_FRAC if kw.get("nearest") else 0.0
        limit = {"K1": nearest_frac, "K1t": nearest_frac, "K2": K2_MAX_FRAC,
                 "K2w": K2_MAX_FRAC, "K3": 0.0, "K4": 0.0}[kernel]
        bound, by = BOUNDS[kernel](args, kw)
        row = dict(path=path, kernel=kernel,
                   shapes=[list(t.shape) for t in args if torch.is_tensor(t)],
                   particles=p, compared=sum(n for _, n in parts),
                   max_abs_err=err, frac_beyond_tol=frac, max_frac=limit,
                   ms=ms, plain_ms=plain_ms, plain_particles=parts[0][1],
                   bound_ms=bound, bound_by=by, share_of_bound=bound / ms)
        if kernel in ("K1", "K1t"):
            row.update(variant=k1_variant(args, kernel == "K1t"),
                       nearest=bool(kw.get("nearest")), rtol=K1_RTOL,
                       atol=K1_ATOL)
        elif kernel == "K4":
            row.update(rtol=K4_RTOL, atol=K4_ATOL, plan=k4_plan(args))
        else:
            row.update(atol=K3_ATOL if kernel == "K3" else K2_ATOL)
        if kernel == "K1t":
            row.update(tile=dict(c0=kw["c0"], w_loc=kw["w_loc"],
                                 n_m=kw["n_m"], ext=kw["ext"]))
        if kernel == "K2w":
            row.update(window=list(kw["size"]), col0=kw["col0"])
        if kernel in ("K2", "K2w"):
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
        if kernel == "K1t" and row["share_of_bound"] > 1.0:
            say("path_kernels", calls=checks)
            raise AssertionError(f"{path} K1t ran faster than its bound: "
                                 f"{row}")
    say("path_kernels", paths=sorted({row["path"] for row in checks}),
        recorded_bytes=rec.bytes(), calls=checks)
    checked = {(row["path"], KERNEL_ROWS[row["kernel"]])
               for row in (*checks, *fused)}
    for path, launches in launches_by_path.items():
        for name, n in launches.items():
            if n > 0 and (path, name) not in checked:
                raise AssertionError(f"{path}: {name} ran but no call of "
                                     f"it was checked")
    return checks


FUSIONS = ("F1", "F2", "F3", "F4", "F5", "F6", "F7", "F8", "F7m", "F8m")


def _outputs(out) -> list:
    """A kernel's outputs as a list of tensors (F1's, F3-F6's tuples, F7's
    Tail with its Window, the Nones of the outputs not asked for left
    out)."""
    if torch.is_tensor(out):
        return [out]
    return [t for x in out if x is not None for t in _outputs(x)]


def _bits_differing(a, b) -> int:
    """The elements of two float32 (or integer or bool) tensors whose bits
    differ (every element where their shapes or dtypes differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.dtype == torch.float32:
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a != b).sum())


def fusion_bound(kernel, args, kw):
    """(bound ms, "operations" or "bytes") of one F1-F8 call: each input
    read once and each output written once over the HBM rate, beside its
    float operations (F1 ~20 a sampled pose and 10 a propagated one, the
    sines, cosines and atan2 counted one each; F2 4 an output cell; F3
    F3_FLOPS a candidate; F4 F4_FLOPS a sample, one a pose and six a pose a
    climb step; F5 and F6 their constants above) over the FP32 peak, as
    bench/bounds.bound."""
    from gridmap_slam_tpu_torch.bench.bounds import bound, nbytes
    if kernel == "F7m":
        # the rank's weights and poses read once; the candidate, the rank's
        # total and moments written and the epilogue's outputs (the
        # collectives' bytes are theirs, not the kernels')
        lw, win = args[0], kw.get("window")
        out = 20 + 4 + 16 + (0 if kw.get("center") else 24)
        out += (17 if kw.get("resample_fraction") is not None else 0) + (
            12 if kw.get("recov") is not None else 0)
        if win is not None:
            out += 16 if not win.volume else 48 + 12 + 4 * (1 + win.nt)
        ins = [v for v in kw.values() if torch.is_tensor(v)]
        return bound(F7_FLOPS * lw.numel(),
                     nbytes([a for a in args if torch.is_tensor(a)] + ins)
                     + out)
    if kernel == "F8m":
        # the gathered rows read once, F8's operations over all of them;
        # the window's slots written
        n, count = args[0].shape[0], kw["count"]
        probes = math.ceil(math.log2(max(n, 2)))
        out = count * (20 + 4 * kw.get("gather_weights", True))
        return bound(n * F8_FLOPS + count * 2 * probes, nbytes(args) + out)
    if kernel == "F7":
        lw = args[0]
        rows, n = lw.numel() // lw.shape[-1], lw.numel()
        out = rows * 44 + (25 if kw.get("recov") is not None else 0)
        win = kw.get("window")
        if win is not None:      # the window's cells, center and bins
            out += 16 if not win.volume else 48 + 12 + 4 * (1 + win.nt)
        ins = [v for v in kw.values() if torch.is_tensor(v)]
        return bound(F7_FLOPS * n, nbytes([*args, *ins]) + out)
    if kernel == "F8":
        n = args[0].numel()
        probes = math.ceil(math.log2(max(n, 2)))
        out = n * (20 + 4 * kw.get("gather_weights", True))
        return bound(n * (F8_FLOPS + 2 * probes), nbytes(args) + out)
    if kernel == "F4":
        n, steps = args[1].numel() // 3, kw.get("steps", 0)
        return bound(F4_FLOPS * n * (1 + 6 * steps),
                     nbytes(args) + n * (16 if steps else 4))
    if kernel == "F5":
        rows, k = args[3].numel() * args[0].numel(), 2 * args[4] + 1
        return bound(rows * (F5_ROW_FLOPS + F5_TAP_FLOPS * k),
                     nbytes(args) + 2 * rows * k * 4)
    if kernel == "F6":
        angle, deskewed = args[0], args[4] is not None
        b = angle.shape[-1]
        g, n_bins = angle.numel() // b, kw.get("n_bins", 0)
        points, stride = bool(kw.get("points")), kw.get("stride", 1)
        log_b = math.ceil(math.log2(max(b, 2)))
        beams = g * b * (F6_DESKEW_FLOPS * deskewed
                         + (F6_WRAP_FLOPS + log_b) * (n_bins > 0)
                         + F6_POINT_FLOPS * points)
        bins = g * n_bins * (F6_BIN_FLOPS + log_b)
        b_c = -(-b // stride) if stride > 1 else 0
        out = (8 * g * b * deskewed + 12 * g * n_bins
               + points * (13 * g * b + 9 * g * b_c + 4 * g)
               + 4 * g * (kw.get("keep_below") is not None))
        return bound(beams + bins, nbytes(args) + out)
    if kernel == "F1":
        pose, normals = args[0], args[3]
        n = pose.numel() // 3
        outs = (normals is not None) + bool(kw.get("deterministic"))
        flops = n * (20 * (normals is not None)
                     + 10 * bool(kw.get("deterministic")))
        return bound(flops, nbytes(args) + outs * n * 12)
    if kernel == "F2":
        g, h, w = args[0].shape
        cells = g * ((h + 1) // 2) * ((w + 1) // 2)
        return bound(4 * cells, args[0].numel() * 4 + cells * 4)
    scores, off_xy, off_t = args[0], args[9], args[10]
    p = scores.shape[0]
    out = (p * (2 * off_xy.numel() + off_t.numel()) * 4
           if off_xy is not None else p * 16)
    return bound(F3_FLOPS * scores.numel(), nbytes(args) + out)


def check_fusion(path, kernel, args, kw) -> dict:
    """One recorded call of F1-F8 again, on the kernel and on its plain
    version (the op sequence it replaced) on the card, on the very
    arguments the path passed: every output equal bit for bit, or the run
    fails.  Times both (CUDA events) beside the bound.  Appends the row to
    FUSION_CHECKS (and the first call of each kernel to FUSION_ARGS) and
    returns it."""
    mod, attr = _entry(kernel)
    cuda_fn = getattr(mod, attr)
    plain_fn = getattr(mod, attr.replace("_cuda", "_plain"))
    # F8's outputs go to new tensors here, not to the path's (`out`)
    kw = {k: v for k, v in kw.items() if k != "out"}
    got, want = (_outputs(fn(*args, **kw)) for fn in (cuda_fn, plain_fn))
    differing = (sum(_bits_differing(a, b) for a, b in zip(got, want))
                 if len(got) == len(want) else -1)
    err = max((float((a.double() - b.double()).abs().nan_to_num(0.0).max())
               for a, b in zip(got, want) if a.shape == b.shape
               and a.numel() and a.dtype != torch.bool), default=0.0)
    del got, want
    ms = cuda_ms(lambda: cuda_fn(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 3)
    bound, by = fusion_bound(kernel, args, kw)
    row = dict(path=path, kernel=kernel,
               shapes=[list(t.shape) for t in args if torch.is_tensor(t)],
               bits_differing=differing, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               share_of_bound=bound / ms)
    if kernel == "F1":
        row.update(sampled=args[3] is not None,
                   deterministic=bool(kw.get("deterministic")))
    elif kernel == "F3":
        row.update(stage="coarse" if args[8] is not None else "refine",
                   last=args[9] is None, stride=kw.get("stride", 1))
    elif kernel == "F4":
        row.update(steps=kw.get("steps", 0), wrap_theta=kw["wrap_theta"],
                   temp=kw.get("temp", 1.0))
        if path == "mega" and not any(r["kernel"] == "F4"
                                      and r["path"] == "mega"
                                      for r in FUSION_CHECKS):
            row.update(f4_library(*args, kw))
    elif kernel == "F6":
        row.update(deskew=args[4] is not None, n_bins=kw.get("n_bins", 0),
                   points=bool(kw.get("points")), stride=kw.get("stride", 1),
                   keep=kw.get("keep_below") is not None)
    elif kernel == "F7":
        lw = args[0]
        win = kw.get("window")
        row.update(robots=lw.numel() // lw.shape[-1], weights=lw.shape[-1],
                   epilogue=kw.get("resample_fraction") is not None,
                   recovery=kw.get("recov") is not None,
                   window=None if win is None else
                   ("volume" if win.volume else "crop"),
                   # the library call for the normalized weights
                   library_ms=cuda_ms(lambda: torch.softmax(lw, -1), 20))
    elif kernel == "F8":
        row.update(weights=args[0].numel(),
                   gather_weights=kw.get("gather_weights", True))
    elif kernel == "F7m":
        lw, win = args[0], kw.get("window")
        row.update(weights=lw.shape[-1], center=bool(kw.get("center")),
                   epilogue=kw.get("resample_fraction") is not None,
                   recovery=kw.get("recov") is not None,
                   window=None if win is None else
                   ("volume" if win.volume else "crop"),
                   library_ms=cuda_ms(lambda: torch.softmax(lw, -1), 20))
    elif kernel == "F8m":
        row.update(weights=args[0].shape[0], slots=[kw["base"], kw["count"]],
                   gather_weights=kw.get("gather_weights", True))
    FUSION_CHECKS.append(row)
    FUSION_ARGS.setdefault(kernel, (args, kw))
    PATH_MAX_ERR[KERNEL_ROWS[kernel]] = max(
        PATH_MAX_ERR[KERNEL_ROWS[kernel]], err)
    if differing != 0:
        say("fusions", calls=FUSION_CHECKS)
        raise AssertionError(f"{path} {kernel}: {differing} output bits "
                             f"differ from its plain version's: {row}")
    return row


def city_kernels_phase(eng, state, frame):
    """K3 and K2 against their plain versions on the very arguments one
    city step passes them (CallRecorder): K3 on the volume crop plus blur
    radius, K2's window variant on the integration crop of the whole map,
    placed on the card."""
    cfg = eng.config
    kernels = _zero_launches()
    with CallRecorder("city step") as rec:
        eng.step_surface(state, frame,
                         torch.Generator(device="cuda").manual_seed(SEED))
    launches = {k: mod.launches for k, mod in kernels.items()}
    calls = {kernel: (args, kw) for _, kernel, args, kw in rec.calls}
    shape3 = list(calls["K3"][0][0].shape)
    shape2 = list(calls["K2w"][0][0].shape)
    window = list(calls["K2w"][1]["size"])
    crop = cfg.matcher.surface_crop_cells
    r = cfg.map.likelihood_radius
    if shape3 != [1, crop + 2 * r, crop + 2 * r]:
        raise AssertionError(f"city K3 ran at {shape3}, not the crop plus "
                             f"radius")
    if "K2" in calls or shape2 != [cfg.map.cells_y, cfg.map.cells_x] or \
            not window[0] < cfg.map.cells_y:
        raise AssertionError(f"city K2 ran on {shape2} in {window}, not in "
                             f"a window of the whole map")
    for row in check_recorded(rec, {"city step": launches}):
        if row["kernel"] == "K2w" and not row["cells_updated_frac"] > 1e-3:
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
    """A warm RBPF.step, a warm SharedMapSLAM.step_blocked, a warm city
    step_surface, a warm mega step_surface with two refine steps and a warm
    surface_sharded step (world of one, NCCL) under
    torch.cuda.set_sync_debug_mode("error"): a call that waits on the card
    (a read back to the host, a copy from pageable host memory) raises."""
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM, city_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.parallel.mesh import make_mesh
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        init_surface_sharded, make_surface_sharded_step)

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
    del rbpf, shared, st_r, st_s
    refine = SharedMapSLAM(refine_config(), device=dev)
    rb = frames_to_device(frames, refine.config.max_beams,
                          refine.config.sensor.max_range, device=dev)
    st_m = refine.init()
    st_m, _ = refine.step_surface(st_m, frame_at(rb, 0), gen)
    # the second step's F1-F8 calls (F4's hill-climb among them) recorded
    # and held bit for bit against their plain versions
    with CallRecorder("mega refine", kernels=FUSIONS) as rec:
        st_m, _ = refine.step_surface(st_m, frame_at(rb, 1), gen)
        torch.cuda.synchronize()
    for call in rec.calls:
        check_fusion(*call)
    del rec
    f2 = frame_at(rb, 2)
    st_m, info_m = _sync_free(lambda: refine.step_surface(st_m, f2, gen))
    del refine, rb, st_m
    # city: step_surface on the 4000 x 4000 map, K2's window placed on the
    # card; surface_sharded: the same on a world of one over NCCL
    city = SharedMapSLAM(city_config(), device=dev)
    cb = frames_to_device(frames, city.config.max_beams,
                          city.config.sensor.max_range, device=dev)
    world = _world_of_one()
    try:
        mesh = make_mesh(1, device=dev)
        ss_step = make_surface_sharded_step(city, mesh)
        st_c, st_ss = city.init(), init_surface_sharded(city, mesh)
        for i in range(2):
            st_c, _ = city.step_surface(st_c, frame_at(cb, i), gen)
            st_ss, _ = ss_step(st_ss, frame_at(cb, i), gen)
        f2 = frame_at(cb, 2)
        (st_c, info_c), (st_ss, info_ss) = _sync_free(lambda: (
            city.step_surface(st_c, f2, gen), ss_step(st_ss, f2, gen)))
    finally:
        _close_world(world)
    say("sync", rbpf_particles=cfg.num_particles,
        shared_particles=shared_particles, block=block,
        rbpf_neff=float(info_r.neff), shared_neff=float(info_s.neff),
        city_particles=city.config.num_particles,
        city_neff=float(info_c.neff), refine_steps=2,
        mega_refine_neff=float(info_m.neff),
        surface_sharded_neff=float(info_ss.neff), synchronizing_calls=0)


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
    if not all(launches[k] > 0 for k in BASE_ROWS):
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


def multi_setup(particles, dev="cuda", revs=MULTI_REVS):
    """scripts/config5_demo.py:62-79 on MultiRobotSLAM: two robots from
    opposite rooms through the door, 14 x 8 m at 0.1 m, 96 beams, noisy
    encoders.  Returns (the engine, the ticks (a Frame with a robot axis
    each), the start poses, the two (frames, ground truth) logs)."""
    from gridmap_slam_tpu_torch import MultiRobotSLAM, SlamConfig
    from gridmap_slam_tpu_torch.config import MapConfig, SensorConfig
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     multi_room_world,
                                                     simulate_log)
    from gridmap_slam_tpu_torch.models.multi import stack_frames

    world = multi_room_world(rooms_x=2, rooms_y=1, room=6.0, door=1.4)
    params = SimParams(beams_per_rev=90, encoder_noise_sd=6.0)
    starts = [(-5.2, -0.3, 0.0), (5.2, 0.3, math.pi)]
    logs = [simulate_log(world, [(0.25, 0.0)] * revs, params=params,
                         seed=11 + i, start_pose=starts[i]) for i in range(2)]
    cfg = SlamConfig(num_particles=particles, max_beams=96,
                     sensor=SensorConfig(max_range=8.0),
                     map=MapConfig(width_m=14.0, height_m=8.0,
                                   resolution=0.1, origin=(-7.0, -4.0)))
    eng = MultiRobotSLAM(cfg, num_robots=2, device=dev)
    batches = [frames_to_device(f, cfg.max_beams, cfg.sensor.max_range,
                                device=dev) for f, _ in logs]
    ticks = [stack_frames([frame_at(b, i) for b in batches])
             for i in range(revs)]
    return eng, ticks, starts, logs


def multi_phase(dev="cuda", particle_counts=MULTI_PARTICLES,
                revs=MULTI_REVS):
    """multi_setup at each particle count, run twice with one seed."""
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    total = {}
    for particles in particle_counts:
        eng, ticks, starts, logs = multi_setup(particles, dev, revs)
        cfg = eng.config

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
        if not all(launches[k] > 0 for k in BASE_ROWS):
            raise AssertionError(f"multi: a kernel was not launched: "
                                 f"{launches}")
        if not max(ates) < ATE_MAX_M:
            raise AssertionError(f"multi at {particles}: ATE {ates}")
        check_recorded(rec, {f"multi {particles}": launches})
    return total


# K1's tile variant: stage_scores_kernel<kShared, kNearest, kCw, true>
# (a tile staged in a block; mangled as a graph's kernel node names it,
# demangled as the profiler does) and its staged kernel,
# stage_scores_tile_kernel
K1_TILE_SYMBOL = re.compile(r"stage_scores_kernelILb[01]ELb[01]ELi\d+ELb1E"
                            r"|stage_scores_kernel<\w+, \w+, \d+, true>"
                            r"|stage_scores_tile_kernel")


def _kernel_row(name: str):
    """The kernel row of a kernel's name (KERNEL_SYMBOLS, K1's tile variant
    apart from K1), or None for another kernel."""
    if K1_TILE_SYMBOL.search(name):
        return "stage_scores_tile"
    return next((row for row, sym in KERNEL_SYMBOLS.items() if sym in name),
                None)


def _node_counts(names) -> dict:
    """Kernel nodes of a graph by kernel row (_kernel_row)."""
    counts = dict.fromkeys(GRAPH_ROWS, 0)
    for nm in names:
        row = _kernel_row(nm)
        if row is not None:
            counts[row] += 1
    return counts


def _library_kernels(names) -> dict:
    """The kernel nodes of a graph that are not PyTorch's own (at::native)
    nor the port's, by name cut to 96 characters, with their counts: the
    linear-algebra libraries' (cuBLAS, cuSOLVER, MAGMA)."""
    out = {}
    for nm in names:
        if _kernel_row(nm) is None and not any(
                sym in nm for sym in ("at6native", "at4cuda")):
            out[nm[:96]] = out.get(nm[:96], 0) + 1
    return out


def frontend_part(name, eager, captured, piece, per=1, graph_per=1,
                  launches_wanted=1):
    """One of the frontend's compiled pieces (a models/captured.Graphed),
    eager and captured in this call; eager() and captured() return tuples
    of tensors.  The eager call's kernel launches;
    each side's seconds (CUDA events around a warm call) and host launches
    (torch.profiler, LAUNCH_CALLS); the captured side's first call, a warm
    call under the sync check that must launch no kernel from Python, and
    its graph's kernel nodes (the driver API) over `graph_per` (the units
    a graph holds: the rebuild's keyframes), which must equal the eager
    launches over `per` (the units a call), inside the graph's conditional
    nodes' bodies too (their count and their kernels a unit are printed);
    the profiled call's graph launches must be `launches_wanted`.  The
    captured results must equal the eager ones bit for bit, twice.
    Returns the row."""
    from gridmap_slam_tpu_torch.models.captured import (
        graph_conditional_bodies, graph_kernel_names)
    torch.cuda.synchronize()
    kernels = _zero_launches()
    out_e = eager()
    torch.cuda.synchronize()
    eager_counts = {k: mod.launches for k, mod in kernels.items()}
    _, sec_e = _timed(eager)
    _, prof_e = _profiled(eager, 1)
    kernels = _zero_launches()
    out_c, sec_first = _timed(captured)
    first_counts = {k: mod.launches for k, mod in kernels.items()}
    kernels = _zero_launches()
    again = _sync_free(captured)
    torch.cuda.synchronize()
    replay_counts = {k: mod.launches for k, mod in kernels.items()}
    _, sec_c = _timed(captured)
    _, prof_c = _profiled(captured, 1)
    names = piece.kernel_names()
    in_graph = {k: v / graph_per for k, v in _node_counts(names).items()}
    bodies = graph_conditional_bodies(piece.graph.raw_cuda_graph())
    in_bodies = {k: v / graph_per for k, v in _node_counts(
        [nm for _, bs in bodies for b in bs
         for nm in graph_kernel_names(b)]).items()}
    FOREIGN_BODY_ROWS.update(k for k, v in in_bodies.items() if v)
    eager_per = {k: eager_counts[k] / per for k in KERNEL_SYMBOLS}
    differing = [i for i, (a, b) in enumerate(zip(out_e, out_c))
                 if not (a.dtype == b.dtype and torch.equal(a, b))]
    rerun = [i for i, (a, b) in enumerate(zip(out_c, again))
             if not torch.equal(a, b)]
    row = dict(part=name, replays_a_call=per,
               outputs_differing=differing, rerun_differing=rerun,
               eager=dict(seconds=sec_e, kernel_launches=eager_counts,
                          host_launches=prof_e["launches_per_scan"],
                          device_ms=prof_e["device_ms"]),
               captured=dict(seconds=sec_c, first_call_seconds=sec_first,
                             launches_in_first_call=first_counts,
                             host_launches=prof_c["launches_per_scan"],
                             device_ms=prof_c["device_ms"],
                             captures=piece.captures,
                             kernel_nodes_in_graph=len(names),
                             kernels_in_graph=in_graph,
                             units_a_graph=graph_per,
                             graph_launches=prof_c["graph_launches"],
                             graph_launches_wanted=launches_wanted,
                             conditional_nodes=len(bodies),
                             kernels_in_conditional_bodies=in_bodies,
                             python_launches_in_warm_replay=replay_counts),
               eager_launches_a_replay=eager_per, speedup=sec_e / sec_c)
    say("posegraph_part", **row)
    if differing or rerun:
        raise AssertionError(f"posegraph {name}: captured outputs "
                             f"{differing} differ from eager, {rerun} "
                             f"between captured calls")
    if any(replay_counts.values()):
        raise AssertionError(f"posegraph {name}: a warm replay launched a "
                             f"kernel from Python: {replay_counts}")
    if any(in_graph[k] != eager_per[k] for k in KERNEL_SYMBOLS):
        raise AssertionError(f"posegraph {name}: kernels in the graph "
                             f"{in_graph} != eager launches a replay "
                             f"{eager_per}")
    if prof_c["graph_launches"] != launches_wanted:
        raise AssertionError(f"posegraph {name}: {prof_c['graph_launches']}"
                             f" graph launches a call, not "
                             f"{launches_wanted}")
    return row


def posegraph_parts(cfg, traj, seq, flow_closures, dev="cuda"):
    """The frontend's three compiled pieces on a frontend fed as the flow
    feeds it, each eager and captured (frontend_part): the verifier on the
    detection's padded batch (then the detection itself, whose accepted
    closures must be the flow's, rels and scores bit for bit),
    Gauss-Newton on the graph and the rebuild at the optimized poses.
    Returns the kernels in the verify graph and in the rebuild graph a
    keyframe."""
    from gridmap_slam_tpu_torch import FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu_torch.models import posegraph as PG
    from gridmap_slam_tpu_torch.models.captured import CHUNK_SCANS
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan

    fe = PoseGraphSLAM(cfg, FrontendConfig(), device=dev)
    for i, f in enumerate(seq):
        fe.add(traj[i], deskew_scan(f.scan, f.odom))
    pairs, padded = fe.candidate_pairs()
    rows = {"closures": frontend_part(
        "closures", lambda: fe.verify_eager(padded),
        lambda: fe.verify(padded), fe.verifier)}
    fe.detect_closures()
    same = len(fe.closures) == len(flow_closures) and all(
        (a[0], a[1]) == (b[0], b[1]) and np.array_equal(a[2], b[2])
        and a[3] == b[3] for a, b in zip(fe.closures, flow_closures))
    if not same:
        raise AssertionError("posegraph closures: the accepted closures "
                             "differ from the flow's")
    graph = fe.graph()
    iters = fe.cfg.gn_iterations

    def solve_eager():
        g, chi2 = PG.optimize(graph, iterations=iters)
        return g.nodes, chi2

    def solve_captured():
        g, chi2 = fe.solver(graph, iterations=iters)
        return g.nodes, chi2

    rows["solve"] = frontend_part("solve", solve_eager, solve_captured,
                                  fe.solver)
    poses = solve_eager()[0].cpu().numpy()
    rows["rebuild"] = frontend_part(
        "rebuild", lambda: (fe.rebuild_map_eager(poses),),
        lambda: (fe.rebuild_map(poses),), fe.rebuilder,
        per=fe.num_keyframes, graph_per=CHUNK_SCANS,
        launches_wanted=-(-fe.num_keyframes // CHUNK_SCANS))
    in_graph = {"posegraph_verify": rows["closures"]["captured"][
                    "kernels_in_graph"],
                "posegraph_rebuild": rows["rebuild"]["captured"][
                    "kernels_in_graph"]}
    # the rebuild's K2 stands in its IF nodes' bodies, one a keyframe
    rebuild_bodies = rows["rebuild"]["captured"][
        "kernels_in_conditional_bodies"]
    if (rebuild_bodies != FRONTEND_NODES["rebuild"]
            or rows["rebuild"]["captured"]["conditional_nodes"]
            != CHUNK_SCANS):
        raise AssertionError(f"posegraph_rebuild: {rebuild_bodies} a "
                             f"keyframe in the bodies of "
                             f"{rows['rebuild']['captured']['conditional_nodes']}"
                             f" conditional nodes")
    say("posegraph_parts", pairs=len(pairs), padded=len(padded),
        accepted=len(fe.closures), accepted_equal_flow=same,
        keyframes=fe.num_keyframes, edges=int(graph.edge_i.shape[0]),
        library_kernels=_library_kernels(fe.solver.kernel_names()),
        preferred_linalg_library=str(
            torch.backends.cuda.preferred_linalg_library()),
        seconds={part: {side: r[side]["seconds"]
                        for side in ("eager", "captured")}
                 for part, r in rows.items()},
        host_launches={part: {side: r[side]["host_launches"]
                              for side in ("eager", "captured")}
                       for part, r in rows.items()},
        kernels_in_graph=in_graph)
    for part, want in (("posegraph_verify", FRONTEND_NODES["verify"]),
                       ("posegraph_rebuild", FRONTEND_NODES["rebuild"])):
        if in_graph[part] != want:
            raise AssertionError(f"{part}: graph kernels {in_graph[part]}, "
                                 f"want {want}")
    del fe
    return in_graph


def grand_tour_config(particles):
    """The CLI's defaults (360 beam slots, no chunk) on the map of
    docs/ate_parity_grand_tour_216.json: 14 x 14 m at 5 cm."""
    from gridmap_slam_tpu_torch import SlamConfig
    from gridmap_slam_tpu_torch.config import MapConfig
    return SlamConfig(num_particles=particles, max_beams=360,
                      particle_chunk=0,
                      map=MapConfig(width_m=14.0, height_m=14.0,
                                    resolution=0.05, origin=(-7.0, -7.0)))


def posegraph_phase(dev="cuda", particles=200, path=GRAND_TOUR, scans=None):
    """app/cli.py:360-400 on the port: the RBPF over the log, keyframes,
    closures, Gauss-Newton and the rebuilt map (the frontend on its
    captured pieces), twice with one seed; online ATE held to the JAX
    package's + 0.06 m; then the three pieces eager beside captured
    (posegraph_parts)."""
    from gridmap_slam_tpu_torch import RBPF, FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                           read_recording)
    from gridmap_slam_tpu_torch.models import posegraph as PG
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    frames = read_recording(path)[:scans]
    gt = np.load(path.replace(".rec", "_gt.npy"))[:len(frames)]
    cfg = grand_tour_config(particles)
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
        # the solve pins float32 itself: run (and capture) it with TF32
        # allowed
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
    # the same graph with TF32 off and on, eager and captured anew, and on
    # the CPU
    tf32, tf32_captured = {}, {}
    for flag in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = flag and dev == "cuda"
        try:
            tf32[flag] = PG.optimize(graph, iterations=10)[0].nodes
            tf32_captured[flag] = PG.CapturedOptimize(dev)(
                graph, iterations=10)[0].nodes
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    tf32_same = bool(all(torch.equal(tf32[False], t)
                         for t in (tf32[True], *tf32_captured.values()))
                     and np.array_equal(opt, tf32[False].cpu().numpy()
                                        .astype(np.float64)))
    cpu_graph = PG.PoseGraph(*(getattr(graph, f.name).cpu()
                               for f in dataclasses.fields(graph)))
    cpu_nodes = PG.optimize(cpu_graph, iterations=10)[0].nodes
    cpu_err = float((tf32[False].cpu() - cpu_nodes).abs().max())
    (_, gn_sec) = _timed(lambda: PG.optimize(graph, iterations=10))
    large = [gn_large_graph(PG, k, dev) for k in GN_LARGE_KEYFRAMES]
    ate = ate_rmse(traj, gt)
    say("posegraph", log=path, scans=len(seq), particles=particles,
        map=[cfg.map.cells_y, cfg.map.cells_x], launches=launches,
        online_ate_m=ate, online_ate_max_m=POSEGRAPH_ATE_MAX_M,
        jax_online_ate_m=dict(seed_0=POSEGRAPH_JAX_ATE_M, seed_1=0.0888),
        keyframes=fe.num_keyframes,
        edges=int(graph.edge_i.shape[0]), closures=n_closures,
        chi2_first=float(chi2[0]), chi2_last=float(chi2[-1]),
        jax_reference=dict(keyframes=216, closures=32, chi2_first=8.234,
                           chi2_last=0.386),
        gn_ms_per_iteration=gn_sec * 1e3 / 10, gn_large_graphs=large,
        tf32_flag_changes_nothing=tf32_same,
        card_vs_cpu_nodes_max_abs=cpu_err,
        rebuilt_occupied=int((rebuilt > 0).sum()),
        rebuilt_free=int((rebuilt < 0).sum()),
        rerun_identical=identical, seconds=sec)
    if not identical:
        raise AssertionError("posegraph: a second run gave other results")
    if not ate <= POSEGRAPH_ATE_MAX_M:
        raise AssertionError(f"posegraph: online ATE {ate} > "
                             f"{POSEGRAPH_ATE_MAX_M}")
    if not (np.isfinite(chi2).all() and chi2[-1] < chi2[0]):
        raise AssertionError(f"posegraph: chi2 did not fall: {chi2}")
    if not (tf32_same and cpu_err < 1e-3):
        raise AssertionError(f"posegraph: Gauss-Newton not pinned to "
                             f"float32 (card vs CPU {cpu_err})")
    for g in large:
        if not (g["finite"] and g["chi2_last"] < g["chi2_first"]
                and g["captured_bits_equal"]):
            raise AssertionError(f"posegraph: Gauss-Newton at "
                                 f"{g['keyframes']} keyframes: {g}")
    # every kernel in the filter and in closure verification, K2 in the
    # rebuild (Gauss-Newton runs none)
    for part, needed in (("posegraph_rbpf", BASE_ROWS),
                         ("posegraph_closures", BASE_ROWS),
                         ("posegraph_rebuild", ["integrate_scan"])):
        if not all(launches[part][k] > 0 for k in needed):
            raise AssertionError(f"{part}: a kernel was not launched: "
                                 f"{launches[part]}")
    first = dict(keyframes=fe.num_keyframes, closures=n_closures,
                 chi2_first=float(chi2[0]), chi2_last=float(chi2[-1]))
    flow_closures = list(fe.closures)
    del fe, rebuilt, rebuilt2
    check_recorded(rec, launches)
    return (launches, first, graph,
            posegraph_parts(cfg, traj, seq, flow_closures, dev))


def config5_posegraph_phase(dev="cuda", revs=MULTI_REVS):
    """scripts/config5_demo.py:104-135 on the port's frontend on the card:
    both robots' dead-reckoned chains (multi_setup's logs; odometry and
    deskew on the CPU, as the JAX demo's) in one PoseGraphSLAM, the seam
    edge dropped (chain_breaks), detect, optimize and rebuild on the
    captured pieces.  Closures and cross-robot closures must be the JAX
    demo's 32 / 32, chi2 finite and falling, the optimized ATE of each
    robot within 0.06 m of the JAX frontend's, and the captured solve and
    rebuild equal to the eager ones bit for bit.  Returns the launches."""
    from gridmap_slam_tpu_torch import FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.models import posegraph as PG
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    from gridmap_slam_tpu_torch.ops.motion import apply_odometry
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    eng, _, starts, logs = multi_setup(MULTI_PARTICLES[0], dev, revs)
    cfg = eng.config
    del eng
    fe = PoseGraphSLAM(cfg, FrontendConfig(
        keyframe_dist=0.0, closure_min_gap=4, closure_max_dist=1.6),
        device=dev)
    dead = []
    for r, (frames, _) in enumerate(logs):
        b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
        pose = torch.tensor(starts[r], dtype=torch.float32)
        for t in range(revs):
            f = frame_at(b, t)
            pose = apply_odometry(pose, f.odom)
            dead.append(pose.numpy().astype(np.float64))
            fe.add(pose, deskew_scan(f.scan, f.odom))
    brk = (revs - 1,)
    kernels = _zero_launches()
    with CallRecorder("config5_posegraph") as rec:
        (n_closures, (opt, chi2), rebuilt), sec = _timed(lambda: (
            fe.detect_closures(), fe.optimize(chain_breaks=brk),
            fe.rebuild_map()))
    launches = {k: mod.launches for k, mod in kernels.items()}
    cross = int(sum((i < revs) != (j < revs) for i, j, _, _ in fe.closures))
    # the eager pieces on the same inputs
    fe.kf_poses = dead
    eager, eager_chi2 = PG.optimize(fe.graph(brk), iterations=10)
    solve_equal = bool(np.array_equal(
        opt, eager.nodes.cpu().numpy().astype(np.float64))
        and np.array_equal(chi2, eager_chi2.cpu().numpy()))
    rebuild_equal = bool(torch.equal(rebuilt, fe.rebuild_map_eager(opt)))
    gts = [gt for _, gt in logs]
    ates = [ate_rmse(opt[r * revs:(r + 1) * revs], gts[r]) for r in range(2)]
    limits = [a + 0.06 for a in CONFIG5_JAX_OPT_ATE_M]
    dead_ates = [ate_rmse(np.asarray(dead[r * revs:(r + 1) * revs]), gts[r])
                 for r in range(2)]
    say("config5_posegraph", keyframes=fe.num_keyframes,
        edges=int(fe.graph(brk).edge_i.shape[0]), chain_breaks=list(brk),
        closures=n_closures, closures_cross_robot=cross,
        jax_closures=CONFIG5_CLOSURES, chi2_first=float(chi2[0]),
        chi2_last=float(chi2[-1]), dead_reckoning_ate_m=dead_ates,
        optimized_ate_m=ates, optimized_ate_max_m=limits,
        jax_optimized_ate_m=list(CONFIG5_JAX_OPT_ATE_M),
        captured_solve_equals_eager=solve_equal,
        captured_rebuild_equals_eager=rebuild_equal,
        rebuilt_occupied=int((rebuilt > 0).sum()),
        captures=dict(verify=fe.verifier.captures,
                      solve=fe.solver.captures,
                      rebuild=fe.rebuilder.captures),
        launches=launches, seconds=sec)
    if not (n_closures == cross == CONFIG5_CLOSURES):
        raise AssertionError(f"config5_posegraph: {n_closures} closures, "
                             f"{cross} cross-robot")
    if not (np.isfinite(chi2).all() and chi2[-1] < chi2[0]):
        raise AssertionError(f"config5_posegraph: chi2 {chi2}")
    if not (solve_equal and rebuild_equal):
        raise AssertionError("config5_posegraph: captured != eager")
    if not all(a <= m for a, m in zip(ates, limits)):
        raise AssertionError(f"config5_posegraph: ATE {ates} > {limits}")
    if not all(launches[k] > 0 for k in BASE_ROWS):
        raise AssertionError(f"config5_posegraph: a kernel was not "
                             f"launched: {launches}")
    check_recorded(rec, {"config5_posegraph": launches})
    return launches


def synthetic_graph(PG, k, dev):
    """A synthetic pose graph of k keyframes: a random-walk trajectory,
    noisy odometry edges along it and k // 10 noisy closures between
    keyframes at least 20 apart, started from dead reckoning."""
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
    return graph


def gn_large_graph(PG, k, dev, iterations=10):
    """Gauss-Newton on synthetic_graph(k), eager and captured
    (PG.CapturedOptimize).  Returns the timings, the peak memory, chi2
    first and last, whether the captured solve gave the eager bits, and
    the linear-algebra kernels its graph holds."""
    graph = synthetic_graph(PG, k, dev)
    PG.optimize(graph, iterations=1)           # warm: cuSOLVER, cuBLAS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (opt, chi2), sec = _timed(lambda: PG.optimize(graph,
                                                  iterations=iterations))
    peak = torch.cuda.max_memory_allocated() - base
    solver = PG.CapturedOptimize(dev)
    (c_opt, c_chi2), first = _timed(lambda: solver(graph, iterations))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _sync_free(lambda: solver(graph, iterations))
    _, sec_c = _timed(lambda: solver(graph, iterations))
    peak_c = torch.cuda.max_memory_allocated() - base
    row = dict(keyframes=k, edges=int(graph.edge_i.shape[0]),
               ms_per_iteration=sec * 1e3 / iterations,
               captured_ms_per_iteration=sec_c * 1e3 / iterations,
               captured_first_call_seconds=first,
               peak_mem_bytes=peak, captured_replay_peak_mem_bytes=peak_c,
               chi2_first=float(chi2[0]), chi2_last=float(chi2[-1]),
               finite=bool(torch.isfinite(opt.nodes).all()),
               captured_bits_equal=bool(torch.equal(opt.nodes, c_opt.nodes)
                                        and torch.equal(chi2, c_chi2)),
               library_kernels=_library_kernels(solver.kernel_names()))
    del solver
    torch.cuda.empty_cache()
    return row


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
    if not all(launches[k] > 0 for k in BASE_ROWS):
        raise AssertionError(f"chip: a kernel was not launched: {launches}")
    if not ate < ATE_MAX_M:
        raise AssertionError(f"chip ATE {ate} >= {ATE_MAX_M}")
    check_recorded(rec, {"chip": launches})
    return launches


def pr1_config(fullres: bool = False):
    """bench.py's pr1 preset (bench.py:621-622, make_engine's 192 beam
    slots): config.pr1_config(), the RBPF at 100 particles in one chunk on
    a 20 x 20 m map at 5 cm (400 x 400 cells); with `fullres`, its coarse
    stage on nearest cells of the full field (coarse_halfres=False,
    bench.py's parity_pallas rung)."""
    from gridmap_slam_tpu_torch import pr1_config as config
    cfg = config().replace(max_beams=192, particle_chunk=0)
    return (cfg.with_overrides({"matcher.coarse_halfres": False})
            if fullres else cfg)


def pr1_phase(frames, dev="cuda"):
    """The pr1 preset and its full-resolution coarse schedule, each over
    the first PR1_SCANS scans of the parity log through RBPF.run_log under
    CallRecorder, keeping two calls of each call shape (K1's fine and
    refine stages share one): each call held against its plain version on
    those arguments (check_recorded), K1's calls labelled by stage, with
    the variant launch_plan gives them.  Returns (launches by path, the
    stages' rows by kernel: K1's by stage, K2's and K3's at (100, 400,
    400))."""
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    launches_by_path, rows = {}, {"K1": {}, "K2": {}, "K3": {}}
    for path, fullres in (("pr1", False), ("pr1_fullres", True)):
        cfg = pr1_config(fullres)
        eng = RBPF(cfg, device=dev)
        batch = frames_to_device(frames[:PR1_SCANS], cfg.max_beams,
                                 cfg.sensor.max_range, device=dev)
        seq = [frame_at(batch, i) for i in range(PR1_SCANS)]
        kernels = _zero_launches()
        with CallRecorder(path, calls_a_shape=2) as rec:
            eng.run_log(eng.init(), seq,
                        torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
        launches = {k: mod.launches for k, mod in kernels.items()}
        launches_by_path[path] = launches
        if not all(launches[k] > 0 for k in BASE_ROWS):
            raise AssertionError(f"{path}: a kernel was not launched: "
                                 f"{launches}")
        checked = check_recorded(rec, {path: launches})
        fine = iter(("fine", "refine"))
        labelled = []
        kernel_calls = [c for c in rec.calls if c[1] not in FUSIONS]
        for (_, kernel, args, kw), row in zip(kernel_calls, checked):
            if kernel == "K1":
                stage = ("coarse nearest" if kw["nearest"] else "coarse"
                         if kw["resolution"] > cfg.map.resolution
                         else next(fine, "fine/refine"))
            else:
                stage = "x".join(str(d) for d in args[0].shape)
            key = f"{path} {stage}"
            labelled.append(dict(stage=key, kernel=kernel,
                                 variant=row.get("variant"),
                                 field=row["shapes"][0], ms=row["ms"],
                                 plain_ms=row["plain_ms"],
                                 bound_ms=row["bound_ms"],
                                 bound_by=row["bound_by"],
                                 share_of_bound=row["share_of_bound"],
                                 max_abs_err=row["max_abs_err"],
                                 frac_beyond_tol=row["frac_beyond_tol"]))
            rows[kernel].setdefault(key, labelled[-1])
        say("pr1", path=path, particles=cfg.num_particles,
            map=[cfg.map.cells_y, cfg.map.cells_x],
            coarse_halfres=cfg.matcher.coarse_halfres, scans=PR1_SCANS,
            launches=launches, calls=labelled)
        del eng, batch, seq, rec
        torch.cuda.empty_cache()
    return launches_by_path, rows


def wide_phase(frames, dev="cuda", coarse_nxy=WIDE_COARSE_NXY):
    """The parity preset with a coarse stage of coarse_nxy x coarse_nxy
    (dy, dx) cells (past F3's 2048 a lane's registers hold at once: its
    lanes walk their cells in groups), over the first PR1_SCANS scans of
    the parity log through RBPF.run_log under CallRecorder: every kernel
    call held against its plain version (check_recorded; F1-F8's bit for
    bit), the state finite.  Returns the path's launches."""
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import fusions

    cfg = parity_config().with_overrides({"matcher.coarse_nxy": coarse_nxy})
    eng = RBPF(cfg, device=dev)
    batch = frames_to_device(frames[:PR1_SCANS], cfg.max_beams,
                             cfg.sensor.max_range, device=dev)
    seq = [frame_at(batch, i) for i in range(PR1_SCANS)]
    kernels = _zero_launches()
    with CallRecorder("wide51") as rec:
        state, infos = eng.run_log(
            eng.init(), seq, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in kernels.items()}
    finite = bool(torch.isfinite(state.poses).all()
                  and torch.isfinite(state.logodds).all())
    mc = cfg.matcher
    say("wide51", particles=cfg.num_particles,
        coarse=[mc.coarse_nt, mc.coarse_nxy, mc.coarse_nxy],
        pick_plan=fusions.pick_plan(cfg.particle_chunk, mc.coarse_nt,
                                    mc.coarse_nxy, mc.coarse_nxy)._asdict(),
        scans=len(seq), launches=launches, finite=finite,
        weighted_pose=infos[-1].weighted_pose.tolist())
    if not finite:
        raise AssertionError("wide51: non-finite poses or maps")
    if not all(launches[k] > 0 for k in (*BASE_ROWS, "pick", "scan")):
        raise AssertionError(f"wide51: a kernel was not launched: "
                             f"{launches}")
    check_recorded(rec, {"wide51": launches})
    return launches


# ------------------------------------------------------------------ captured
# the kernels' symbols as the profiler names them, a row each (K4's row:
# its prologue and its correlation, KERNELS of them a call)
KERNEL_SYMBOLS = {"stage_scores": "stage_scores_kernel",
                  "integrate_scan": "grid_update_kernel",
                  "log_likelihood_field": "ll_field_",
                  "surface_corr": "surface_corr_",
                  "motion": "fusion_motion_kernel",
                  "pool": "fusion_pool_kernel",
                  "pick": "fusion_pick_kernel",
                  "sample": "fusion_sample_kernel",
                  "splat": "fusion_splat_kernel",
                  "scan": "fusion_scan_kernel",
                  "weights": "fusion_weights_",
                  # F8's mesh form (on more than one rank only), ahead of
                  # F8's row, whose symbol its names hold too
                  "walk_mesh": "fusion_walk_mesh_",
                  "walk": "fusion_walk_",
                  "weights_mesh": "fusion_mesh_"}
# the rows _node_counts gives
GRAPH_ROWS = (*KERNEL_SYMBOLS, "stage_scores_tile")
# the runtime calls that put work on the card from the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
CAPTURED_BLOCKED_SCANS = 6     # mega_blocked's captured path, for time


def _profiled(run, n: int, names=None):
    """run() once under torch.profiler: returns (its result, the device
    time of the run in ms, the host's launches a scan (kernels, copies,
    sets and graph launches) and its graph launches in the run, device
    events a scan and each kernel row's launches a scan as the profiler saw
    them, inside a graph too).  `names`, where given, are the kernel
    functions the run's graphs hold (as the profiler names them): a record
    of a repo kernel under another name is counted apart, in
    `records_named_outside_graph`, not in its row.  CUPTI names the
    records of kernels in conditional bodies through its own tables, and
    after IF nodes of other graphs in the process it was seen to name a
    short kernel of a parity graph's IF body after K2's batch-1 variant
    (the rebuild's), which that graph does not hold."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [_kernel_row(e.name) if names is None or e.name in names
            else None for e in dev]
    outside = {}
    for e, row in zip(dev, rows):
        if row is None and _kernel_row(e.name) is not None:
            outside[e.name[:96]] = outside.get(e.name[:96], 0) + 1
    ms_a_scan = dict.fromkeys((*GRAPH_ROWS, "other"), 0.0)
    for e, row in zip(dev, rows):
        ms_a_scan[row or "other"] += e.time_range.elapsed_us() / 1e3 / n
    # K1t's launches come as (coarse, fine, refine) a chunk, in order
    tile = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                  for e, row in zip(dev, rows) if row == "stage_scores_tile")
    stages = {}
    if tile and len(tile) % 3 == 0:
        stages = {name: sum(ms for _, ms in tile[i::3]) / n
                  for i, name in enumerate(("coarse", "fine", "refine"))}
    return out, dict(
        device_ms=sum(e.time_range.elapsed_us() for e in dev) / 1e3,
        launches_per_scan=sum(e.name in LAUNCH_CALLS for e in events) / n,
        graph_launches=sum(e.name.startswith("cudaGraphLaunch")
                           for e in events),
        device_events_per_scan=len(dev) / n,
        kernels_per_scan={row: sum(r == row for r in rows) / n
                          for row in GRAPH_ROWS},
        any_repo_kernel_seen=any(_kernel_row(e.name) for e in dev),
        device_ms_a_scan_by_kernel=ms_a_scan,
        k1t_device_ms_a_scan_by_stage=stages,
        records_named_outside_graph=outside)


def _reductions(run, n: int) -> dict:
    """run() (an eager replay of n scans) under a TorchDispatchMode: the
    torch reductions and scans it dispatched (REDUCTION_OPS), a scan, keyed
    by the op and the innermost frame of the package that called it
    (file:function)."""
    import traceback
    from torch.utils._python_dispatch import TorchDispatchMode
    sites = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in REDUCTION_OPS:
                site = next((f"{fr.filename.split('gridmap_slam_tpu_torch/')[1]}"
                             f":{fr.name}"
                             for fr in reversed(traceback.extract_stack())
                             if "gridmap_slam_tpu_torch/" in fr.filename),
                            "other")
                sites[f"{name} {site}"] = sites.get(f"{name} {site}", 0) + 1
            return func(*args, **(kwargs or {}))

    with Record():
        run()
        torch.cuda.synchronize()
    return {k: v / n for k, v in sorted(sites.items())}


def _tail_reductions(sites: dict) -> list:
    """The sites of _reductions that are the weights' tail's, which F7 and
    F8 hold on the card: any in ops/resample.py or in F7's and F8's plain
    versions, and the argmax of a step (models/)."""
    plain = (" ops/resample.py:", "fusions.py:_weights_row",
             "fusions.py:weights_plain", "fusions.py:walk_plain")
    return [k for k in sites if any(p in k for p in plain)
            or (k.startswith("argmax ") and " models/" in k)]


TORCH_SCAN_KERNEL = re.compile(r"tensor_kernel_scan|DeviceScan")


def _fields_differing(a, b) -> list:
    """The fields of two states or infos whose tensors differ in bits,
    shape or dtype."""
    return [f.name for f in dataclasses.fields(a)
            if not (getattr(a, f.name).dtype == getattr(b, f.name).dtype
                    and torch.equal(getattr(a, f.name), getattr(b, f.name)))]


def _one_scan_periods(names, one, n: int) -> bool:
    """Whether a graph's kernel names are a one-scan graph's with its scan
    n times over: the nodes before the scan (the counter's reset) once,
    then the scan's nodes n times."""
    if n == 1:
        return names == one
    per = (len(names) - len(one)) // (n - 1)
    head = len(one) - per
    return (0 <= head and len(names) == head + n * per
            and names == one[:head] + one[head:] * n)


def captured_path(name, eng, init, eager, jit, frames, n, gt, ate_max,
                  step_jit=None):
    """One path eager and captured from one seed: the eager loop (its
    launch counts, peak memory, a warm run's time, a profiled run), then
    the captured replay, the log's n scans in ceil(n / CHUNK_SCANS) graph
    launches (one up to CHUNK_SCANS scans): its first call (warm-up and
    capture: the launch counts), a warm call under the sync check that
    must launch no kernel from Python, a timed call and a profiled call,
    which must make that many graph launches.  Both captured runs must
    equal the eager one in every field of the final state and of every
    stacked info, and leave the generator where the eager run leaves it
    (its next draw); ATE under `ate_max`.  The kernel nodes of the graph of
    the first chunk (m scans), read from the graph itself, must be m times
    the eager loop's launches a scan of each of the repo's kernels, and
    every graph of the replay a graph of one scan's nodes its length times
    over: the same replay then takes a log of the first scan alone (a graph
    of its own beside the others), whose infos must equal the eager run's
    first.  The profiler's
    count of kernels a scan over the profiled replay is printed beside, and
    must see each one at least once and none more often than the graph
    holds it (its CUPTI records of graph kernels can drop a few hundredths
    of a busy run), counting the records named after a kernel function the
    replay's graphs hold; a record of a repo kernel the graphs do not hold
    (CUPTI's name for a conditional body's kernel, _profiled) is printed
    apart.  Nodes, capture and instantiation seconds and peak
    memory are printed for both graphs.  Returns (the counts of the first
    captured call, the kernels a scan inside the graph)."""
    from gridmap_slam_tpu_torch.bench.layers import demangle
    from gridmap_slam_tpu_torch.io import frame_at
    from gridmap_slam_tpu_torch.models.captured import (
        CHUNK_SCANS, WARMUP_STEPS, graph_conditional_bodies,
        graph_kernel_names, stack_steps, tree_map)
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def run_eager():
        st, infos = eager(s0, g0)
        return st, (stack_steps(infos) if isinstance(infos, list)
                    else infos)

    def next_draw(g):
        return torch.randn(8, generator=g, device="cuda")

    from gridmap_slam_tpu_torch.ops import surface as sf
    sf.packs_on_card = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _zero_launches()
    s0, g0 = init(), gen()
    (st_e, inf_e), _ = _timed(run_eager)
    next_e = next_draw(g0)
    eager_counts = {k: mod.launches for k, mod in kernels.items()}
    peak_e = torch.cuda.max_memory_allocated()
    s0, g0 = init(), gen()
    _, sec_e = _timed(run_eager)
    s0, g0 = init(), gen()
    _, prof_e = _profiled(run_eager, n)
    s0, g0 = init(), gen()
    reductions = _reductions(run_eager, n)
    tail_reductions = _tail_reductions(reductions)

    replay = jit()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _zero_launches()
    s0, g0 = init(), gen()
    (st_c, inf_c), sec_capture = _timed(lambda: replay(s0, frames, g0))
    next_c = next_draw(g0)
    capture_counts = {k: mod.launches for k, mod in kernels.items()}
    kernels = _zero_launches()
    s0, g0 = init(), gen()
    st_c2, inf_c2 = _sync_free(lambda: replay(s0, frames, g0))
    torch.cuda.synchronize()
    next_c2 = next_draw(g0)
    replay_counts = {k: mod.launches for k, mod in kernels.items()}
    peak_c = torch.cuda.max_memory_allocated()
    s0, g0 = init(), gen()
    _, sec_c = _timed(lambda: replay(s0, frames, g0))
    s0, g0 = init(), gen()
    held = {demangle(nm) for gr in replay.captured.graphs.values()
            for nm in graph_kernel_names(gr.raw_cuda_graph())}
    _, prof_c = _profiled(lambda: replay(s0, frames, g0), n, held)
    cap = replay.captured
    names = cap.kernel_names()
    m, launches = cap.scans, cap.launches
    graph = dict(scans=m, kernel_nodes=len(names),
                 nodes_by_type=cap.node_types(),
                 capture_seconds=cap.capture_seconds,
                 first_call_seconds=sec_capture, peak_gb=peak_c / 1e9)
    # the graph of one scan, beside it in the same replay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s0, g0 = init(), gen()
    (_, inf_1), sec_one = _timed(
        lambda: replay(s0, tree_map(lambda x: x[:1], frames), g0))
    names_one = cap.kernel_names()
    one_scan = dict(scans=cap.scans, kernel_nodes=len(names_one),
                    nodes_by_type=cap.node_types(),
                    capture_seconds=cap.capture_seconds,
                    first_call_seconds=sec_one,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    # every graph of the replay (the chunks' lengths and the one scan's)
    periodic = {k[0]: _one_scan_periods(
        graph_kernel_names(gr.raw_cuda_graph()), names_one, k[0])
        for k, gr in cap.graphs.items()}
    # the resample gates: an IF node a gate a scan (a robot's a tick)
    # (the bodies' kernels read now: their graphs are not held past here)
    bodies = graph_conditional_bodies(
        cap.graphs[(m, False)].raw_cuda_graph())
    body_names = [nm for _, bs in bodies for b in bs
                  for nm in graph_kernel_names(b)]
    gates = inf_c.resampled[0].numel()
    map_bytes = st_e.logodds.numel() * st_e.logodds.element_size()
    gate = dict(gates_a_scan=gates,
                conditional_nodes_a_scan=len(bodies) / m,
                kernels_in_bodies_a_scan=len(body_names) / m,
                fired=int(inf_c.resampled.sum()),
                gated=int(inf_c.resampled.numel()),
                map_bytes=map_bytes,
                peak_over_map_bytes=peak_c / map_bytes,
                # the profiler's device records (a body's kernels among
                # them, under correlation ids of their own) and the timed
                # replay's host clock
                profiler_device_ms_a_scan=prof_c["device_ms"] / n,
                replay_ms_a_scan=sec_c * 1e3 / n)

    bits = {"state": _fields_differing(st_e, st_c),
            "infos": _fields_differing(inf_e, inf_c),
            "next_draw": not torch.equal(next_e, next_c),
            "one_scan_infos": _fields_differing(
                tree_map(lambda x: x[:1], inf_e), inf_1)}
    rerun = {"state": _fields_differing(st_c, st_c2),
             "infos": _fields_differing(inf_c, inf_c2),
             "next_draw": not torch.equal(next_e, next_c2)}
    step_bits = None
    if step_jit is not None:            # the captured step, scan by scan
        sj, g = step_jit(), gen()
        st, infos = init(), []
        for i in range(n):
            st, info = sj(st, frame_at(frames, i), g)
            infos.append(info)
        step_bits = {"state": _fields_differing(st_e, st),
                     "infos": _fields_differing(inf_e, stack_steps(infos)),
                     "next_draw": not torch.equal(next_e, next_draw(g))}
        del sj, st, infos
    packs = sf.packs_on_card
    traj = inf_c.weighted_pose.cpu().numpy()
    ates = ([ate_rmse(traj, gt[:n])] if traj.ndim == 2 else
            [ate_rmse(traj[:, r], g) for r, g in enumerate(gt)])
    eager_per_scan = {k: eager_counts[k] / n for k in KERNEL_SYMBOLS}
    in_graph = {k: v / m for k, v in _node_counts(names).items()}
    seen = prof_c["kernels_per_scan"]
    visible = prof_c["any_repo_kernel_seen"]
    # CUPTI names some records of this graph's conditional bodies after a
    # kernel of another graph's body captured earlier in the process (the
    # rebuild's K2 at batch 1): a row of such a kernel may be seen up to
    # this graph's body kernels a scan more often than the graph holds it
    misnamable = {k: gate["kernels_in_bodies_a_scan"]
                  if k in FOREIGN_BODY_ROWS else 0.0 for k in GRAPH_ROWS}
    row = dict(path=name, scans=n, particles=eng.config.num_particles,
               bits_differing=bits, rerun_differing=rerun,
               step_jit_differing=step_bits, ate_m=ates, ate_max_m=ate_max,
               captures=cap.captures, capacity=cap.capacity,
               warmup_steps=WARMUP_STEPS, packed_arrays_built=packs,
               graph_launches_a_replay=prof_c["graph_launches"],
               graph_launches_wanted=-(-n // CHUNK_SCANS),
               chunk_scans=CHUNK_SCANS,
               launches_in_capture_call=capture_counts,
               python_launches_in_warm_replay=replay_counts,
               kernels_per_scan_eager=eager_per_scan,
               kernels_per_scan_in_graph=in_graph,
               kernel_nodes_in_graph=len(names),
               kernel_nodes_a_scan=len(names) / m,
               kernel_nodes_a_scan_max=NODES_A_SCAN_MAX.get(name),
               # torch's reduce and scan kernels in the graph, and the
               # reductions the eager steps dispatched, by call site
               torch_reduce_nodes_a_scan=sum(
                   "reduce_kernel" in nm for nm in names) / m,
               torch_scan_nodes_a_scan=sum(
                   bool(TORCH_SCAN_KERNEL.search(nm)) for nm in names) / m,
               torch_reductions_a_scan=reductions,
               tail_reductions=tail_reductions,
               log_graph=graph, one_scan_graph=one_scan, resample_gate=gate,
               log_graph_is_one_scan_n_times=periodic,
               kernels_per_scan_profiler=seen if visible else None,
               profiler_surplus_a_scan={
                   k: seen[k] - in_graph[k] for k in GRAPH_ROWS
                   if seen[k] > in_graph[k]},
               profiler_records_named_outside_graph=prof_c[
                   "records_named_outside_graph"],
               profiler_sees_graph_kernels=visible,
               eager=dict(scans_per_sec=n / sec_e, warm_seconds=sec_e,
                          peak_mem_bytes=peak_e, **prof_e),
               captured=dict(scans_per_sec=n / sec_c, warm_seconds=sec_c,
                             first_call_seconds=sec_capture,
                             peak_mem_bytes=peak_c, **prof_c),
               speedup=sec_e / sec_c)
    say("captured", **row)
    del replay, cap, st_c, st_c2, st_e
    torch.cuda.empty_cache()
    if any(bits.values()) or any(rerun.values()) or (
            step_bits is not None and any(step_bits.values())):
        raise AssertionError(f"captured {name}: fields or the generator's "
                             f"next draw differ from the eager loop or "
                             f"between captured runs")
    if not prof_c["graph_launches"] == launches == -(-n // CHUNK_SCANS):
        raise AssertionError(f"captured {name}: {prof_c['graph_launches']} "
                             f"graph launches in a replay call of {n} "
                             f"scans ({launches} chunks), not "
                             f"{-(-n // CHUNK_SCANS)}")
    if m != min(n, CHUNK_SCANS) or max(periodic) > CHUNK_SCANS:
        raise AssertionError(f"captured {name}: a graph of more than "
                             f"{CHUNK_SCANS} scans: {sorted(periodic)}")
    if any(replay_counts.values()):
        raise AssertionError(f"captured {name}: a warm replay launched a "
                             f"kernel from Python: {replay_counts}")
    needed = [k for k, v in eager_counts.items() if v > 0]
    if not all(capture_counts[k] > 0 for k in needed):
        raise AssertionError(f"captured {name}: a kernel of the eager path "
                             f"was not captured: {capture_counts}")
    if any(in_graph[k] != eager_per_scan[k] for k in KERNEL_SYMBOLS):
        raise AssertionError(f"captured {name}: kernels a scan inside the "
                             f"graph {in_graph} != eager {eager_per_scan}")
    if len(bodies) != gates * m:
        raise AssertionError(f"captured {name}: {len(bodies)} conditional "
                             f"nodes in a graph of {m} scans of {gates} "
                             f"resample gates each")
    if not all(periodic.values()):
        raise AssertionError(f"captured {name}: a graph's kernel nodes are "
                             f"not the one-scan graph's {len(names_one)} "
                             f"with its scan its length times: {periodic}")
    # a kernel that stands only in the gates' bodies (F8) runs only where a
    # gate fired, and CUPTI records a conditional body's kernels through
    # tables of its own: it was seen to drop every F8 record of a replay
    # whose gates fired (mega_bf16) while the graph's nodes, read through
    # cuGraphKernelNodeGetParams above, hold them exactly; such a row need
    # not be seen
    outside = {k: in_graph[k] - v / m
               for k, v in _node_counts(body_names).items()}
    if visible and not all(
            (0 < seen[k] or outside[k] == 0)
            and seen[k] <= in_graph[k] + misnamable[k]
            for k in needed if k in KERNEL_SYMBOLS):
        raise AssertionError(f"captured {name}: the profiler saw kernels a "
                             f"scan {seen}, the graph holds {in_graph} "
                             f"(records of its bodies' kernels that may "
                             f"carry another graph's body kernel's name: "
                             f"{misnamable})")
    if not max(ates) < ate_max:
        raise AssertionError(f"captured {name}: ATE {ates} >= {ate_max}")
    if packs:
        raise AssertionError(f"captured {name}: the step built {packs} "
                             f"packed neighbourhood arrays on the card (F4 "
                             f"reads the volume in place)")
    if tail_reductions:
        raise AssertionError(f"captured {name}: the weights' tail ran torch "
                             f"reductions on the card (F7 and F8 hold it): "
                             f"{tail_reductions}")
    if not len(names) / m <= NODES_A_SCAN_MAX.get(name, math.inf):
        raise AssertionError(f"captured {name}: {len(names) / m} kernel "
                             f"nodes a scan, more than "
                             f"{NODES_A_SCAN_MAX[name]}")
    return capture_counts, in_graph


def refine_config():
    """mega with two hill-climb steps on the surface a scan."""
    from gridmap_slam_tpu_torch import mega_config
    return mega_config().with_overrides({"matcher.surface_refine_steps": 2})


def captured_phase(frames, gt):
    """Every path eager and captured (captured_path): parity (with
    step_jit), chip, pr1, the RBPF at the posegraph phase's 200 particles and
    map over the 216 scans of grand_tour_216.rec (14 graph launches a
    call), mega (12 scans and the 40 of room_loop_40.rec, 3 launches), mega
    with two refine steps, mega with the direct correlation in bf16 on K4
    (mega_bf16) and in float32 (mega_direct), city and city in bf16 on K4
    (city_bf16), mega_blocked over 6 scans and multi at 10 000 a robot.
    Returns (the counts of each path's capturing call, keyed
    captured_<path>; each path's kernels a scan inside the graph)."""
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, city_config,
                                        mega_config)
    from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                           read_recording)
    from gridmap_slam_tpu_torch.models.captured import tree_map
    from gridmap_slam_tpu_torch.models.multi import stack_frames
    from gridmap_slam_tpu_torch.models.shared import matcher_block_size

    def stacked(cfg, log, n=None):
        b = frames_to_device(log, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
        b = tree_map(lambda x: x[:n], b)
        return b, [frame_at(b, i) for i in range(b.t.shape[0])]

    counts, seen = {}, {}

    def record(name, out):
        counts[f"captured_{name}"], seen[name] = out

    room = read_recording(CLI_LOG)
    room_gt = np.load(CLI_LOG.replace(".rec", "_gt.npy"))
    tour = read_recording(GRAND_TOUR)
    tour_gt = np.load(GRAND_TOUR.replace(".rec", "_gt.npy"))
    for name, cfg, log, log_gt, ate_max in (
            ("parity", parity_config(), frames, gt, ATE_MAX_M),
            ("chip", parity_config().replace(
                num_particles=CHIP_PARTICLES, particle_chunk=CHIP_CHUNK),
             frames, gt, ATE_MAX_M),
            ("pr1", pr1_config(), frames, gt, ATE_MAX_M),
            # a long log: 216 scans in chunks of CHUNK_SCANS
            ("grand_tour_216", grand_tour_config(200), tour, tour_gt,
             POSEGRAPH_ATE_MAX_M)):
        eng = RBPF(cfg, device="cuda")
        batch, seq = stacked(cfg, log)
        record(name, captured_path(
            name, eng, eng.init,
            lambda s, g, e=eng, q=seq: e.run_log(s, q, g), eng.replay_jit,
            batch, len(seq), log_gt, ate_max,
            step_jit=eng.step_jit if name == "parity" else None))
        del eng, batch, seq
    for name, cfg, log, log_gt, ate_max in (
            ("mega", mega_config(), frames, gt, ATE_MAX_M),
            ("mega room_loop_40", mega_config(), room, room_gt,
             ROOM_LOOP_ATE_MAX_M),
            ("mega refine", refine_config(), frames, gt, ATE_MAX_M),
            ("mega_bf16", bf16_config(), frames, gt, ATE_MAX_M),
            ("mega_direct", bf16_config(False), frames, gt, ATE_MAX_M),
            ("city", city_config(), frames, gt, ATE_MAX_M),
            ("city_bf16", city_bf16_config(), frames, gt, ATE_MAX_M)):
        eng = SharedMapSLAM(cfg, device="cuda")
        batch, seq = stacked(cfg, log)
        record(name, captured_path(
            name, eng, eng.init,
            lambda s, g, e=eng, q=seq: e.run_log(s, q, g),
            eng.replay_surface_jit, batch, len(seq), log_gt, ate_max))
        del eng, batch, seq
    cfg = parity_config().replace(num_particles=MEGA_PARTICLES,
                                  particle_chunk=0)
    block = matcher_block_size(cfg)
    eng = SharedMapSLAM(cfg, device="cuda")
    batch, seq = stacked(cfg, frames, CAPTURED_BLOCKED_SCANS)
    record("mega_blocked", captured_path(
        "mega_blocked", eng, eng.init,
        lambda s, g: eng.replay(s, seq, g, block=block),
        lambda: eng.replay_jit(block=block), batch, len(seq), gt, ATE_MAX_M))
    del eng, batch, seq
    meng, ticks, starts, logs = multi_setup(MULTI_PARTICLES[-1])
    record("multi", captured_path(
        "multi", meng, lambda: meng.init(starts),
        lambda s, g: meng.replay(s, ticks, g), meng.replay_jit,
        stack_frames(ticks), len(ticks), [g for _, g in logs], ATE_MAX_M))
    return counts, seen


# ------------------------------------------------------------------ parallel
def _sync_free(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any call that
    waits on the card (a read back to the host) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _world_of_one() -> str:
    """A world of one rank over NCCL in this process (a file rendezvous in
    a fresh directory, which is returned)."""
    import tempfile
    import torch.distributed as dist
    d = tempfile.mkdtemp(prefix="chip_smoke_world_")
    dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous",
                            rank=0, world_size=1)
    return d


def _close_world(d: str) -> None:
    import shutil
    import torch.distributed as dist
    dist.destroy_process_group()
    shutil.rmtree(d, ignore_errors=True)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("poses", "log_weights", "logodds"))


def _ext_tile(field, j, n, fill):
    """Column tile j of n of (G, H, W) fields with one column of each
    neighbour, `fill` at the world's edges: K1's tile field."""
    g, h, w = field.shape
    w_loc = w // n
    out = torch.full((g, h, w_loc + 2), fill, device=field.device)
    out[..., 1:-1] = field[..., j * w_loc:(j + 1) * w_loc]
    if j > 0:
        out[..., 0] = field[..., j * w_loc - 1]
    if j < n - 1:
        out[..., -1] = field[..., (j + 1) * w_loc]
    return out


def k1_tile_phase(frames, particles=256, timed_particles=PAR_TILED_CHUNK):
    """K1's tile variant on the card at tile shapes cut from the city map
    (4000 x 4000 at 5 cm, a random map through K3): against its plain
    version at n_m = 2 and 4 (both edge tiles and one inside), and the
    tiles summed against the untiled K1 on the whole field, for the three
    stages of the tiled schedule (coarse at full resolution over every
    4th beam, fine, refine) at `particles` poses around the tile
    boundaries and the world's edges, and the coarse stage once more on
    nearest cells; both of the kernel's paths (a block that staged its
    box, and a block that read the field) must have been checked; then the
    three stages timed at the tiled row's shapes (one tile, 500 particles
    at one pose) by CUDA events around calls from Python and by device
    time in a CUDA graph, each beside its bound (k1t_bound: the cells its
    taps read) and its share of it, which may not exceed 1, and the
    kernel's blocks by path (stage_scores_tile_cuda's `paths`).  Returns
    the kernels line's row."""
    from gridmap_slam_tpu_torch import city_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import likelihood
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan, scan_points
    from gridmap_slam_tpu_torch.ops.grid import gaussian_kernel

    dev = torch.device("cuda")
    cfg = city_config()
    mc = cfg.matcher
    h, w = cfg.map.cells_y, cfg.map.cells_x
    origin, res, maxr = cfg.map.origin, cfg.map.resolution, \
        cfg.sensor.max_range
    v_out = math.log(1.0 / maxr)
    rng = np.random.default_rng(SEED + 7)
    taps = torch.as_tensor(gaussian_kernel(cfg.map.likelihood_sigma,
                                           cfg.map.likelihood_radius),
                           device=dev)
    field = likelihood.log_likelihood_field_batch_cuda(
        _test_maps(1, h, w, rng), taps, z_hit=mc.z_hit, max_range=maxr)
    batch = frames_to_device(frames, cfg.max_beams, maxr, device=dev)
    scan = deskew_scan(frame_at(batch, 0).scan, frame_at(batch, 0).odom)
    px, py = scan_points(scan)
    use = scan.valid & scan.hit

    def offs(a, n):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=dev).expand(n, -1).contiguous()

    def stages(p):
        """(name, px, py, use, dxs, dys, dts, nearest) of each stage."""
        wt = math.radians(mc.window_theta_deg)
        c_xy = offs(np.linspace(-mc.window_xy, mc.window_xy, mc.coarse_nxy),
                    p)
        c_t = offs(np.linspace(-wt, wt, mc.coarse_nt), p)
        step_xy = 2 * mc.window_xy / (mc.coarse_nxy - 1)
        step_t = 2 * wt / (mc.coarse_nt - 1)
        s = mc.coarse_beam_stride
        out = [("coarse", px[::s].contiguous(), py[::s].contiguous(),
                use[::s].contiguous(), c_xy, c_xy, c_t, False)]
        for name, k in (("fine", 1.0), ("refine", 0.5)):
            oxy = offs(np.linspace(-k * step_xy, k * step_xy, mc.fine_nxy), p)
            ot = offs(np.linspace(-k * step_t, k * step_t, mc.fine_nt), p)
            out.append((name, px, py, use, oxy, oxy, ot, False))
        return out

    # poses within 5 m of the 2- and 4-tile boundaries and of the world's
    # west and east edges (beams past them are the edge tiles')
    xs = np.concatenate([rng.uniform(-5, 5, particles // 4),
                         rng.uniform(-55, -45, particles // 4),
                         rng.uniform(-99.5, -95, particles // 4),
                         rng.uniform(95, 99.5, particles - 3 * (
                             particles // 4))])
    poses = torch.as_tensor(np.stack(
        [xs, rng.uniform(-20, 20, particles),
         rng.uniform(-math.pi, math.pi, particles)], 1).astype(np.float32),
        device=dev)
    kw = dict(resolution=res, origin=origin, max_range=maxr)
    checks, err = [], 0.0
    paths = torch.zeros(2, dtype=torch.int32, device=dev)

    def beyond(got, want, scale):
        """Max |got - want| and the fraction beyond K1's tolerance, taken
        relative to `scale`: a tile's partial score sums a part of the
        candidate's terms, whose float error is the whole sum's."""
        diff = (got - want).abs()
        return (float(diff.max()),
                float((diff > K1_ATOL + K1_RTOL * scale.abs()).float()
                      .mean()))

    # the three stages, and the coarse one on nearest cells (no engine
    # path scores a tile so, but the kernel takes it)
    checked = stages(particles)
    checked.append(("coarse nearest", *checked[0][1:-1], True))
    for name, sx, sy, su, dxs, dys, dts, nearest in checked:
        args = (sx, sy, su, poses, dxs, dys, dts)
        untiled = kmatch.stage_scores_batch_cuda(field, *args, **kw,
                                                 nearest=nearest)
        for n in TILE_SHARDS:
            w_loc = w // n
            total = torch.zeros_like(untiled)
            plain_total = torch.zeros_like(untiled)
            for j in range(n):
                ext = _ext_tile(field, j, n, v_out)
                tkw = dict(kw, c0=j * w_loc, w_loc=w_loc, n_m=n, ext=1,
                           nearest=nearest)
                got = kmatch.stage_scores_tile_cuda(ext, *args, paths=paths,
                                                    **tkw)
                want = kmatch.stage_scores_tile_plain(ext, *args, **tkw)
                total += got
                plain_total += want
                if j in (0, 1, n - 1):
                    e, frac = beyond(got, want,
                                     torch.maximum(want.abs(), untiled.abs()))
                    err = max(err, e)
                    checks.append(dict(stage=name, n_m=n, tile=j,
                                       max_abs_err=e, frac_beyond_tol=frac,
                                       max_frac=K1_TILE_MAX_FRAC))
            for what, a, b, limit in (
                    ("sum vs plain sum", total, plain_total, 0.0),
                    ("sum vs untiled", total, untiled, 0.0)):
                e, frac = beyond(a, b, b)
                checks.append(dict(stage=name, n_m=n, tile=what,
                                   max_abs_err=e, frac_beyond_tol=frac,
                                   max_frac=limit))
            bad = [c for c in checks if c["frac_beyond_tol"] > c["max_frac"]]
            if bad:
                say("k1_tile", checks=checks)
                raise AssertionError(f"K1 tile {name} over {n} tiles: {bad}")
    # both of the kernel's paths were held: blocks whose box fit, and
    # blocks of far-apart particles that read the field
    checked_paths = dict(zip(("box", "field"), paths.tolist()))
    if min(checked_paths.values()) == 0:
        raise AssertionError(f"K1 tile: a path of the kernel was not "
                             f"checked: blocks {checked_paths}")
    # the tiled row's shapes: one tile of the whole map, 500 particles
    p = timed_particles
    ext = _ext_tile(field, 0, 1, v_out)
    poses = poses[:1].expand(p, -1).contiguous()
    ms = plain_ms = bound_total = by_ops = 0.0
    times = []
    for name, sx, sy, su, dxs, dys, dts, _ in stages(p):
        args = (ext, sx, sy, su, poses, dxs, dys, dts)
        tkw = dict(kw, c0=0, w_loc=w, n_m=1, ext=1)
        paths.zero_()
        kmatch.stage_scores_tile_cuda(*args, paths=paths, **tkw)
        blocks = dict(zip(("box", "field"), paths.tolist()))
        t = cuda_ms(lambda: kmatch.stage_scores_tile_cuda(*args, **tkw), 20)
        tg = graph_ms(lambda: kmatch.stage_scores_tile_cuda(*args, **tkw),
                      20)
        tp = cuda_ms(lambda: kmatch.stage_scores_tile_plain(*args, **tkw), 3)
        bound, by = k1t_bound(args, tkw)
        ms, plain_ms, bound_total = ms + t, plain_ms + tp, bound_total + bound
        by_ops += bound if by == "operations" else 0.0
        times.append(dict(stage=name, ms=t, graph_ms=tg,
                          plain_ms=tp, bound_ms=bound, bound_by=by,
                          share_of_bound=bound / t,
                          share_of_bound_graph=bound / tg,
                          cells_read=k1t_cells(args, tkw),
                          variant=k1_variant(args, tile=True),
                          blocks_by_path=blocks))
    say("k1_tile", field=[1, h, w], particles=particles,
        rtol=K1_RTOL, atol=K1_ATOL, checks=checks,
        checked_blocks_by_path=checked_paths, timed_particles=p,
        timed=times)
    if any(max(row["share_of_bound"], row["share_of_bound_graph"]) > 1.0
           for row in times):
        raise AssertionError(f"K1t ran faster than its bound: {times}")
    return dict(name="stage_scores_tile", route="cuda",
                source="gridmap_slam_tpu_torch/csrc/matcher.cu",
                replaces="gridmap_slam_tpu/ops/pallas/matcher.py:287",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_total,
                bound_by="operations" if 2 * by_ops >= bound_total
                else "bytes", library_ms=None)


# the kernel rows whose launches a scan a mesh graph holds
MESH_GRAPH_ROWS = ("stage_scores", "stage_scores_tile", "integrate_scan",
                   "log_likelihood_field",
                   *(row for row in FUSION_ROWS if row in KERNEL_SYMBOLS))


def _par_path(path, seq, make, init, ref, compare, needed, single):
    """One row of the parallel phase on the world of one: the distributed
    path over `seq` from init() with a seeded generator, eager
    (make(False)), then compiled (make(True), one CUDA graph with its NCCL
    collectives), from the same seed.

    Eager: every launch count at 0 before the run, its kernel calls
    recorded and its collectives kept; again (the same bits, timed); a warm
    step under the sync check; a profiled run.  Then the single-device
    reference `ref()` and `compare(state, infos, ref_state, ref_infos)` ->
    dict with "ok".  Compiled: the first run (warm-up and capture: the
    launch counts), then a warm run under the sync check that must launch
    no kernel from Python, a timed run and a profiled one; both runs must
    equal the eager run in every field of the final state and of every
    scan's info, and pass the same comparison with the reference.  The
    graph must hold, by kernel row, the eager run's launches a scan, and
    be captured once; its nodes are also counted by type, beside the
    collectives a scan and the single-device graph's nodes by type.
    single() -> (replay, init): the single-device engine's replay_jit over
    the same scans, timed and profiled in this call.  The resample gate:
    the step graph must hold one conditional IF node (one gate a scan)
    and the replay_jit graph one a scan, whose bodies' kernels a scan are
    printed with the scans that fired and the device ms a scan of
    replay_jit beside the single-device replay_jit's.  Returns (the eager
    launches, the graph's kernels a scan)."""
    from gridmap_slam_tpu_torch.models.captured import (
        graph_conditional_bodies, graph_kernel_nodes, stack_steps)
    from gridmap_slam_tpu_torch.parallel.mesh import recording

    def conditionals(graph):
        bodies = graph_conditional_bodies(graph.raw_cuda_graph())
        return len(bodies), sum(len(graph_kernel_nodes(b))
                                for _, bs in bodies for b in bs)

    start = init()              # (a shard of the engine's init: set-up)
    n = len(seq)

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def run(step):
        def go():
            g, st, infos = gen(), start, []
            for f in seq:
                st, info = step(st, f, g)
                infos.append(info)
            go.generator = g
            return st, infos
        return go

    def next_draw(g):
        return torch.randn(8, generator=g, device="cuda")

    eager = make(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _zero_launches()
    go = run(eager)
    with CallRecorder(path) as rec, recording() as colls:
        (state, infos), _ = _timed(go)
    next_e = next_draw(go.generator)
    launches = {k: mod.launches for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    (again, _), sec = _timed(run(eager))
    identical = _same(state, again)
    del again
    _sync_free(lambda: eager(state, seq[-1], gen()))
    _, prof_e = _profiled(run(eager), n)
    ref_state, ref_infos = ref()
    cmp = compare(state, infos, ref_state, ref_infos)

    comp = make(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _zero_launches()
    go = run(comp)
    (st_c, inf_c), first_sec = _timed(go)
    capture_counts = {k: mod.launches for k, mod in kernels.items()}
    eager_infos = stack_steps(infos)
    bits = {"state": _fields_differing(state, st_c),
            "infos": _fields_differing(eager_infos, stack_steps(inf_c)),
            "next_draw": not torch.equal(next_e, next_draw(go.generator))}
    cmp_c = compare(st_c, inf_c, ref_state, ref_infos)
    del ref_state, ref_infos
    kernels = _zero_launches()
    st_c, inf_c = _sync_free(run(comp))
    torch.cuda.synchronize()
    replay_counts = {k: mod.launches for k, mod in kernels.items()}
    peak_c = torch.cuda.max_memory_allocated()
    rerun = {"state": _fields_differing(state, st_c),
             "infos": _fields_differing(eager_infos, stack_steps(inf_c))}
    _, sec_c = _timed(run(comp))
    _, prof_c = _profiled(run(comp), n)
    cap = comp.captured
    names = cap.kernel_names()
    in_graph = _node_counts(names)
    eager_per_scan = {k: launches[k] / n for k in MESH_GRAPH_ROWS}

    # the compiled body's replay of the whole log: one graph of n scans
    log_replay = comp.replay_jit()
    batch = stack_steps(seq)
    g = gen()
    (st_r, inf_r), sec_r_first = _timed(lambda: log_replay(start, batch, g))
    log_bits = {"state": _fields_differing(state, st_r),
                "infos": _fields_differing(eager_infos, inf_r),
                "next_draw": not torch.equal(next_e, next_draw(g))}
    g = gen()
    _, sec_r = _timed(lambda: log_replay(start, batch, g))
    g = gen()
    _, prof_r = _profiled(lambda: log_replay(start, batch, g), n)
    log_names = log_replay.captured.kernel_names()
    log_periodic = _one_scan_periods(log_names, names, n)
    step_ifs, step_if_kernels = conditionals(cap.graph)
    log_ifs, log_if_kernels = conditionals(log_replay.captured.graph)
    log_row = dict(scans_per_sec=n / sec_r, first_call_seconds=sec_r_first,
                   capture_seconds=log_replay.captured.capture_seconds,
                   graph_launches_a_replay=prof_r["graph_launches"],
                   host_launches_a_scan=prof_r["launches_per_scan"],
                   kernel_nodes_in_graph=len(log_names),
                   kernel_nodes_in_step_graph=len(names),
                   graph_is_the_step_n_times=log_periodic,
                   bits_differing_from_eager=log_bits)
    del log_replay, st_r, inf_r, batch

    replay, single_init = single()
    batch = stack_steps(seq)
    replay(single_init(), batch, gen())                  # capture
    s0, g0 = single_init(), gen()
    _, sec_s = _timed(lambda: replay(s0, batch, g0))
    s0, g0 = single_init(), gen()
    _, prof_s = _profiled(lambda: replay(s0, batch, g0), n)
    single_nodes = replay.captured.node_types()
    single_ifs, _ = conditionals(replay.captured.graph)
    del replay, s0, batch
    fired = int(stack_steps(inf_c).resampled.sum())
    gate = dict(gates_a_scan=1, conditional_nodes_in_step_graph=step_ifs,
                kernels_in_bodies_in_step_graph=step_if_kernels,
                conditional_nodes_a_scan=log_ifs / n,
                kernels_in_bodies_a_scan=log_if_kernels / n,
                single_device_conditional_nodes_a_scan=single_ifs / n,
                fired=fired, gated=n,
                device_ms_a_scan=prof_r["device_ms"] / n,
                single_device_ms_a_scan=prof_s["device_ms"] / n)

    per_scan = {}
    for kind, axis, nbytes in colls:
        key = f"{kind} {axis}"
        per_scan[key] = per_scan.get(key, 0) + 1 / n
    say("parallel_path", path=path, mesh=[1, 1], backend="nccl",
        scans=n, particles=int(state.poses.shape[0]),
        launches_a_scan={k: v / n for k, v in launches.items()},
        rerun_identical=identical, final_neff=float(infos[-1].neff),
        collectives_a_scan=per_scan,
        eager=dict(scans_per_sec=n / sec, warm_seconds=sec,
                   peak_mem_bytes=peak, busy_pct=100 * prof_e["device_ms"]
                   / (sec * 1e3), host_syncs_warm_step=0, **prof_e),
        captured=dict(scans_per_sec=n / sec_c, warm_seconds=sec_c,
                      first_call_seconds=first_sec, peak_mem_bytes=peak_c,
                      busy_pct=100 * prof_c["device_ms"] / (sec_c * 1e3),
                      captures=cap.captures,
                      launches_in_capture_call=capture_counts,
                      python_launches_in_warm_replay=replay_counts,
                      kernels_a_scan_in_graph=in_graph,
                      kernel_nodes_in_graph=len(names),
                      graph_nodes_by_type=cap.node_types(),
                      bits_differing_from_eager=bits,
                      rerun_differing_from_eager=rerun,
                      against_reference=cmp_c, **prof_c),
        replay_jit=log_row, resample_gate=gate,
        single_device_captured=dict(scans_per_sec=n / sec_s,
                                    warm_seconds=sec_s,
                                    device_ms=prof_s["device_ms"],
                                    graph_nodes_by_type=single_nodes),
        speedup=sec / sec_c, **cmp)
    if not (identical and cmp["ok"] and cmp_c["ok"]):
        raise AssertionError(f"{path}: rerun identical {identical}, "
                             f"against its reference {cmp}, captured {cmp_c}")
    if any(bits.values()) or any(rerun.values()):
        raise AssertionError(f"{path}: the captured runs differ from the "
                             f"eager run: {bits} {rerun}")
    if any(log_bits.values()) or prof_r["graph_launches"] != 1 \
            or not log_periodic:
        raise AssertionError(f"{path}: replay_jit: {log_row}")
    if step_ifs != 1 or log_ifs != n:
        raise AssertionError(f"{path}: not one conditional node a resample "
                             f"gate a scan: {gate}")
    if not all(launches[k] > 0 and capture_counts[k] > 0 for k in needed):
        raise AssertionError(f"{path}: a kernel was not launched: "
                             f"{launches} {capture_counts}")
    if any(replay_counts.values()) or cap.captures != 1:
        raise AssertionError(f"{path}: {cap.captures} captures; a warm "
                             f"replay launched from Python {replay_counts}")
    if any(in_graph[k] != eager_per_scan[k] for k in MESH_GRAPH_ROWS):
        raise AssertionError(f"{path}: kernels a scan inside the graph "
                             f"{in_graph} != eager {eager_per_scan}")
    del state, infos, st_c, inf_c, comp, cap
    torch.cuda.empty_cache()
    check_recorded(rec, {path: launches})
    return launches, in_graph


def _bitwise(state, infos, ref, ref_infos):
    poses = float((state.poses - ref.poses).abs().max())
    lmap = float((state.logodds - ref.logodds).abs().max())
    same = _same(state, ref) and all(
        torch.equal(a.weighted_pose, b.weighted_pose)
        and torch.equal(a.neff, b.neff) for a, b in zip(infos, ref_infos))
    return dict(reference_bits_equal=same, max_pose_diff=poses,
                max_map_diff=lmap, ok=same)


def _within(pose_atol, map_atol, neff_rtol=None):
    def compare(state, infos, ref, ref_infos):
        poses = float((state.poses - ref.poses).abs().max())
        lmap = float((state.logodds - ref.logodds).abs().max())
        wp = max(float((a.weighted_pose - b.weighted_pose).abs().max())
                 for a, b in zip(infos, ref_infos))
        neff = max(abs(float(a.neff) / float(b.neff) - 1.0)
                   for a, b in zip(infos, ref_infos))
        ok = (poses <= pose_atol and lmap <= map_atol and wp <= pose_atol
              and (neff_rtol is None or neff <= neff_rtol))
        return dict(reference_bits_equal=_same(state, ref),
                    max_pose_diff=poses, max_map_diff=lmap,
                    max_weighted_pose_diff=wp, max_neff_rel_diff=neff,
                    pose_atol=pose_atol, map_atol=map_atol,
                    neff_rtol=neff_rtol, ok=ok)
    return compare


def _ba_rows(mesh, pg_graph, dev="cuda", iterations=10):
    """The distributed Gauss-Newton on the world of one against
    models/posegraph.optimize, on grand_tour_216's graph and the synthetic
    1000 / 3000-keyframe graphs; eager, then compiled (every iteration
    with its psum one CUDA graph, captured once a graph): the same bits,
    no synchronizing call in a warm call, ms an iteration of each."""
    from gridmap_slam_tpu_torch.models import posegraph as PG
    from gridmap_slam_tpu_torch.parallel.ba import (make_distributed_optimizer,
                                                    pad_edges, shard_graph)

    opt = make_distributed_optimizer(mesh, iterations=iterations)
    rows = []
    graphs = [("grand_tour_216", pg_graph)] + [
        (f"synthetic_{k}", synthetic_graph(PG, k, dev))
        for k in GN_LARGE_KEYFRAMES]
    for name, graph in graphs:
        arrays = [getattr(graph, f).cpu().numpy() for f in
                  ("nodes", "edge_i", "edge_j", "edge_z", "edge_w")]
        local = shard_graph((arrays[0],) + pad_edges(*arrays[1:], 1), mesh,
                            device=dev)
        opt(local)                               # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (got, chi2), sec = _timed(lambda: opt(local))
        peak = torch.cuda.max_memory_allocated() - base
        _sync_free(lambda: opt(local))
        want, chi2_ref = PG.optimize(graph, iterations=iterations)
        chi2_rel = float(((chi2 - chi2_ref).abs() / chi2_ref.abs()).max())
        nodes = float((got.nodes - want.nodes).abs().max())

        opt_c = make_distributed_optimizer(mesh, iterations=iterations,
                                           jit=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (got_c, chi2_c), first_c = _timed(lambda: opt_c(local))  # capture
        peak_c = torch.cuda.max_memory_allocated() - base
        again_c, _ = _sync_free(lambda: opt_c(local))
        _, sec_c = _timed(lambda: opt_c(local))
        solve = opt_c.captured
        bits_c = bool(torch.equal(got_c.nodes, got.nodes)
                      and torch.equal(chi2_c, chi2)
                      and torch.equal(again_c.nodes, got.nodes))
        row = dict(graph=name, keyframes=int(graph.nodes.shape[0]),
                   edges=int(graph.edge_i.shape[0]),
                   ms_per_iteration=sec * 1e3 / iterations,
                   peak_mem_bytes=peak, chi2_first=float(chi2[0]),
                   chi2_last=float(chi2[-1]), max_chi2_rel_diff=chi2_rel,
                   max_nodes_diff=nodes, host_syncs_an_iteration=0,
                   reference_bits_equal=bool(torch.equal(got.nodes,
                                                         want.nodes)),
                   captured=dict(ms_per_iteration=sec_c * 1e3 / iterations,
                                 first_call_seconds=first_c,
                                 peak_mem_bytes=peak_c,
                                 captures=solve.captures,
                                 kernel_nodes=len(solve.kernel_names()),
                                 graph_nodes_by_type=solve.node_types(),
                                 eager_bits_equal=bits_c,
                                 host_syncs_warm_call=0))
        rows.append(row)
        del opt_c, solve, got_c, again_c
        torch.cuda.empty_cache()
        if not (chi2_rel <= BA_CHI2_RTOL and nodes <= BA_NODES_ATOL
                and float(chi2[-1]) < float(chi2[0]) and bits_c
                and row["captured"]["captures"] == 1):
            say("parallel_ba", graphs=rows)
            raise AssertionError(f"distributed BA on {name}: {row}")
    say("parallel_ba", mesh=[1, 1], backend="nccl", iterations=iterations,
        chi2_rtol=BA_CHI2_RTOL, nodes_atol=BA_NODES_ATOL, graphs=rows)


def parallel_phase(frames, pg_graph):
    """The distributed engines (gridmap_slam_tpu_torch/parallel/) on the
    card: K1's tile variant (k1_tile_phase), then each engine at mesh
    (1, 1) over NCCL in a world of one in this process against its
    single-device reference, then the distributed BA.  Returns (launches
    by path, K1 tile's kernels row)."""
    import dataclasses as dc
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, city_config,
                                        mega_config)
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.models.shared import matcher_block_size
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh
    from gridmap_slam_tpu_torch.parallel.sharded import (init_sharded,
                                                         make_sharded_step)
    from gridmap_slam_tpu_torch.parallel.shmap import (init_shmap,
                                                       make_shmap_step)
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        init_surface_sharded, make_surface_sharded_step)
    from gridmap_slam_tpu_torch.parallel.tiled import (init_tiled,
                                                       make_tiled_step)

    t0 = time.perf_counter()
    tile_row = k1_tile_phase(frames)
    world = _world_of_one()
    launches, in_graph = {}, {}

    def record(path, out):
        launches[path], in_graph[f"parallel {path}"] = out

    try:
        mesh = pmesh.make_mesh(1, device="cuda")

        def seq_of(cfg, n):
            b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device="cuda")
            return [frame_at(b, i) for i in range(min(n, len(frames)))]

        def gen():
            return torch.Generator(device="cuda").manual_seed(SEED)

        def maker(make, eng, *args):
            return lambda jit: make(eng, mesh, *args, jit=jit)

        # shmap: mega_blocked's config, blocks of matcher_block_size
        cfg = parity_config().replace(num_particles=MEGA_PARTICLES,
                                      particle_chunk=0)
        block = matcher_block_size(cfg)
        eng = SharedMapSLAM(cfg, device="cuda")
        seq = seq_of(cfg, PAR_SHMAP_SCANS)
        record("shmap", _par_path(
            "shmap", seq, maker(make_shmap_step, eng),
            lambda: init_shmap(eng, mesh),
            lambda: eng.replay(eng.init(), seq, gen(), block=block),
            _bitwise, BASE_ROWS,
            lambda: (eng.replay_jit(block=block), eng.init)))

        eng = SharedMapSLAM(mega_config(), device="cuda")
        seq = seq_of(eng.config, N_SCANS)
        record("shmap_surface", _par_path(
            "shmap_surface", seq, maker(make_shmap_step, eng, True),
            lambda: init_shmap(eng, mesh),
            lambda: eng.run_log(eng.init(), seq, gen()), _bitwise,
            ("log_likelihood_field", "integrate_scan"),
            lambda: (eng.replay_surface_jit(), eng.init)))

        # tiled: the city map at the chip rung's particle count, against
        # SharedMapSLAM.step with _match_tiled's coarse stage
        cfg = city_config().replace(num_particles=PAR_TILED_PARTICLES,
                                    particle_chunk=PAR_TILED_CHUNK)
        eng = SharedMapSLAM(cfg, device="cuda")
        ref_eng = SharedMapSLAM(cfg.replace(matcher=dc.replace(
            cfg.matcher, coarse_halfres=False, coarse_nearest=False)),
            device="cuda")
        seq = seq_of(cfg, N_SCANS)
        record("tiled", _par_path(
            "tiled", seq, maker(make_tiled_step, eng),
            lambda: init_tiled(eng, mesh),
            lambda: ref_eng.replay(ref_eng.init(), seq, gen()),
            _within(TILED_ATOL, TILED_ATOL),
            ("stage_scores_tile", "integrate_scan", "log_likelihood_field"),
            lambda: (ref_eng.replay_jit(), ref_eng.init)))
        del ref_eng

        eng = SharedMapSLAM(city_config(), device="cuda")
        seq = seq_of(eng.config, N_SCANS)
        record("surface_sharded", _par_path(
            "surface_sharded", seq, maker(make_surface_sharded_step, eng),
            lambda: init_surface_sharded(eng, mesh),
            lambda: eng.run_log(eng.init(), seq, gen()),
            _within(SS_POSE_ATOL, SS_MAP_ATOL, SS_NEFF_RTOL),
            ("log_likelihood_field", "integrate_scan"),
            lambda: (eng.replay_surface_jit(), eng.init)))

        eng = RBPF(parity_config(), device="cuda")
        seq = seq_of(eng.config, N_SCANS)
        record("sharded", _par_path(
            "sharded", seq, maker(make_sharded_step, eng),
            lambda: init_sharded(eng, mesh),
            lambda: eng.run_log(eng.init(), seq, gen()), _bitwise,
            ("stage_scores_tile", "integrate_scan", "log_likelihood_field"),
            lambda: (eng.replay_jit(), eng.init)))
        del eng

        _ba_rows(mesh, pg_graph)
    finally:
        _close_world(world)
    launches.update(multi_rank_card_phase())
    say("parallel", seconds=time.perf_counter() - t0,
        paths=sorted(launches))
    return launches, tile_row, in_graph


MULTI_RANK_SCANS = 3
# the gates of the multi-rank phase, where its scans resample: the parity
# log's second and third scan (Neff 478 and 455 of 500 at the matcher, 142
# and 75 in surface mode, on the CPU)
MULTI_RANK_GATES = {"resample_fraction": 0.99,
                    "matcher.surface_resample_fraction": 0.5}
MULTI_RANK_PATHS = ("shmap", "shmap_surface")


def _two_rank_runs(mesh_of, scans=MULTI_RANK_SCANS, record=False):
    """shmap and shmap in surface mode (p = 2 or 1) at the parity width,
    their gates at MULTI_RANK_GATES, over the first `scans` scans of the
    parity log, seeded; returns the gathered global state and infos (host
    arrays), the scans whose gate fired and the launches by kernel row.
    record=True: each path's F7 and F8 calls, both mesh forms' among them,
    recorded (CallRecorder) and held against their plain versions on the
    card (check_fusion: on two ranks every rank checks its calls in the
    same order, their collectives with it).  The tiled engine is not run
    on two ranks of one card: its halos are point-to-point sends, and gloo
    refuses a CUDA tensor there (PERF.md section 7)."""
    from gridmap_slam_tpu_torch import SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.parallel.mesh import gather_state
    from gridmap_slam_tpu_torch.parallel.shmap import (init_shmap,
                                                       make_shmap_step)

    cfg = parity_config().with_overrides(MULTI_RANK_GATES)
    frames, _ = parity_log()
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    eng = SharedMapSLAM(cfg, device="cuda")
    out = {}
    for path in MULTI_RANK_PATHS:
        mesh = mesh_of(1)
        step = make_shmap_step(eng, mesh, surface=path == "shmap_surface")
        st = init_shmap(eng, mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        infos, fired = [], 0
        kernels = _zero_launches()
        rec = CallRecorder(f"two_rank {path}",
                           kernels=("F7", "F8", "F7m", "F8m"))
        with rec if record else contextlib.nullcontext():
            for i in range(scans):
                st, info = step(st, frame_at(batch, i), gen)
                infos.append([float(info.neff)]
                             + info.weighted_pose.cpu().tolist())
                fired += int(info.resampled)
        torch.cuda.synchronize()
        launches = {k: mod.launches for k, mod in kernels.items()}
        g = gather_state(st, mesh, False)
        out[path] = dict(poses=g.poses.cpu().numpy(),
                         log_weights=g.log_weights.cpu().numpy(),
                         logodds=g.logodds.cpu().numpy(),
                         infos=np.asarray(infos), fired=fired,
                         launches=launches,
                         checks=[check_fusion(*call) for call in rec.calls])
    return out


def _two_rank_worker(payload: str, rank: int, n: int) -> None:
    """Rank side of the multi-rank card phase (parallel/launch.run_ranks:
    2 gloo ranks on the one card, CUDA tensors): writes this rank's
    gathered results and its kernel checks next to `payload`."""
    import os
    import pickle
    from gridmap_slam_tpu_torch.parallel.mesh import make_mesh

    out = _two_rank_runs(lambda m: make_mesh(n, map_shards=m,
                                             device="cuda"), record=True)
    with open(os.path.join(payload, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def multi_rank_card_phase() -> dict:
    """2 ranks on the one H100 over gloo with CUDA tensors (NCCL refuses
    two ranks on one card): shmap and shmap in surface mode (p = 2) at the
    parity width.  Both ranks must agree on every replicated output, the
    run must equal its mesh (1, 1) run over NCCL within the CPU tests'
    tolerances (poses and map atol 1e-4, weights rtol / atol 1e-5), a gate
    must fire on each path (so that F8's mesh form walks the gathered
    rows), and each rank's recorded F7 and F8 calls of both mesh forms
    must equal their plain versions on the card in every bit (their rows
    join FUSION_CHECKS, path "two_rank <path> rank <r>").  Returns rank 0's
    launches by path ("two_rank <path>")."""
    import pickle
    import tempfile
    from gridmap_slam_tpu_torch.parallel.launch import run_ranks
    from gridmap_slam_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        run_ranks(2, "chip_smoke:_two_rank_worker", tmp, backend="gloo",
                  device="cuda", timeout=600)
        ranks = []
        for r in range(2):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    world = _world_of_one()
    try:
        one = _two_rank_runs(lambda m: make_mesh(1, device="cuda"))
    finally:
        _close_world(world)
    rows, launches = {}, {}
    for path in MULTI_RANK_PATHS:
        a, b, ref = ranks[0][path], ranks[1][path], one[path]
        fields = ("poses", "log_weights", "logodds", "infos")
        agree = all(np.array_equal(a[k], b[k]) for k in fields)
        diffs = {k: float(np.abs(a[k] - ref[k]).max()) for k in fields}
        checks = {}
        for r, rank in enumerate(ranks):
            for row in rank[path]["checks"]:
                row = dict(row, path=f"{row['path']} rank {r}")
                FUSION_CHECKS.append(row)
                name = KERNEL_ROWS[row["kernel"]]
                PATH_MAX_ERR[name] = max(PATH_MAX_ERR[name],
                                         row["max_abs_err"])
                k = checks.setdefault(row["kernel"],
                                      dict(calls=0, bits_differing=0))
                k["calls"] += 1
                k["bits_differing"] += row["bits_differing"]
        launches[f"two_rank {path}"] = a["launches"]
        ok = (agree and diffs["poses"] <= 1e-4 and diffs["logodds"] <= 1e-4
              and np.allclose(a["log_weights"], ref["log_weights"],
                              rtol=1e-5, atol=1e-5)
              and np.allclose(a["infos"], ref["infos"], rtol=1e-5,
                              atol=1e-4)
              and a["fired"] == b["fired"] > 0
              and {"F7m", "F8m"} <= set(checks)
              and not any(c["bits_differing"] for c in checks.values())
              and a["launches"]["walk_mesh"] > 0)
        rows[path] = dict(mesh=[2, 1], fired=a["fired"],
                          fired_mesh_1x1=ref["fired"],
                          ranks_agree=agree, max_diff_vs_mesh_1x1=diffs,
                          checks=checks,
                          launches={k: v for k, v in a["launches"].items()
                                    if v}, ok=bool(ok))
    say("multi_rank", ranks=2, backend="gloo", tensors="cuda",
        scans=MULTI_RANK_SCANS, gates=MULTI_RANK_GATES, paths=rows,
        seconds=time.perf_counter() - t0)
    if not all(r["ok"] for r in rows.values()):
        raise AssertionError(f"multi-rank card phase: {rows}")
    return launches


def _cli(argv):
    """gridmap_slam_tpu_torch.app.cli.main(argv) in this process, its stdout
    captured; returns (what main returns, the last JSON line it printed)."""
    import contextlib
    import io
    from gridmap_slam_tpu_torch.app.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli_main(argv)
    return out, json.loads(buf.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def _cli_steps(eager: bool = False):
    """While active, application.compiled_step (which the CLI's
    _run_frames and SlamApplication call for their step) keeps each step
    it hands out in the yielded list; with eager=True it hands out the
    engine's eager step in place of the captured one.  Each call of a step
    it hands out is marked "scan" for torch.profiler
    (_host_launches_a_scan); `captured` is the captured step's own."""
    from gridmap_slam_tpu_torch.app import application
    real = application.compiled_step
    taken = []

    def patched(engine):
        step = engine.step if eager else real(engine)

        def marked(*args, **kw):
            with torch.profiler.record_function("scan"):
                return step(*args, **kw)
        marked.captured = getattr(step, "captured", None)
        taken.append(marked)
        return marked

    application.compiled_step = patched
    try:
        yield taken
    finally:
        application.compiled_step = real


@contextlib.contextmanager
def _cli_frontends():
    """While active, every PoseGraphSLAM the CLI builds (cmd_posegraph
    imports the class at each call) is kept in the yielded list."""
    from gridmap_slam_tpu_torch.models import frontend
    real = frontend.PoseGraphSLAM
    made = []

    class Kept(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    frontend.PoseGraphSLAM = Kept
    try:
        yield made
    finally:
        frontend.PoseGraphSLAM = real


def _frontend_graphs(fe) -> dict:
    """Each compiled piece of a frontend: its captures and the kernels its
    graph holds by row (None where nothing was captured), the rebuild's a
    keyframe (its graph holds CHUNK_SCANS keyframes), with the rebuild's
    graph launches in its last call beside the ceil(keyframes /
    CHUNK_SCANS) wanted."""
    from gridmap_slam_tpu_torch.models.captured import CHUNK_SCANS

    out = {}
    for part, piece in (("verify", fe.verifier), ("solve", fe.solver),
                        ("rebuild", fe.rebuilder)):
        names = piece.kernel_names() if piece.graph is not None else None
        per = CHUNK_SCANS if part == "rebuild" else 1
        out[part] = dict(captures=piece.captures,
                         kernel_nodes=None if names is None else len(names),
                         kernels=None if names is None
                         else {k: v / per
                               for k, v in _node_counts(names).items()})
    out["rebuild"].update(
        launches=fe.rebuilder.launches,
        launches_wanted=-(-fe.num_keyframes // CHUNK_SCANS))
    return out


def _host_launches_a_scan(run):
    """run() under torch.profiler: (its result, the host's launches
    (LAUNCH_CALLS) a scan, the median over the intervals from one step
    call's start (its "scan" mark on the host, _cli_steps; the profiler
    also shows the mark on the card's timeline) to the next's, so the
    set-up and the work after the last scan are not counted; a captured
    step's warm-up and capture fall in its first interval)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = prof.events()
    marks = sorted(e.time_range.start for e in events if e.name == "scan"
                   and e.device_type == torch.autograd.DeviceType.CPU)
    calls = np.array(sorted(e.time_range.start for e in events
                            if e.name in LAUNCH_CALLS))
    per = [int(((calls >= a) & (calls < b)).sum())
           for a, b in zip(marks, marks[1:])]
    return out, float(np.median(per)) if per else None


def _read_replay(result, d):
    """(scans, scans/s, trajectory) of a CLI replay's result."""
    (_, traj, metrics), _ = result
    return metrics["frames"], metrics["scans_per_sec"], traj


def _cli_compare(name, invoke, read, tmp):
    """The CLI path `invoke(out_dir)` on its captured step beside the same
    run on the eager step, in this call: each run once as it is (scans/s
    from the CLI's own metrics, the kernels its Python wrappers launched:
    a scan's worth eager, only the warm-up's and the capture's captured)
    and once under the profiler (host launches a scan); the eager run must
    give the captured run's trajectory bit for bit.  read(result, out_dir)
    -> (scans, scans/s, trajectory).  The kernels a scan inside the
    captured graph are read from the graph.  Returns the figures."""
    import os
    row = {}
    for mode in ("captured", "eager"):
        d = os.path.join(tmp, f"{name}_{mode}")
        with _cli_steps(eager=mode == "eager") as steps:
            kernels = _zero_launches()
            result = invoke(d)
            counts = {k: mod.launches for k, mod in kernels.items()}
            _, launches = _host_launches_a_scan(lambda: invoke(d + "_prof"))
        scans, sps, traj = read(result, d)
        row[mode] = dict(scans=scans, scans_per_sec=sps,
                         host_launches_a_scan=launches,
                         python_kernel_launches_a_scan={
                             k: v / scans for k, v in counts.items()})
        if mode == "captured":
            cap = steps[0].captured
            names = cap.kernel_names() if cap.graph is not None else []
            row["captured"].update(captures=cap.captures,
                                   kernels_in_graph=_node_counts(names),
                                   kernel_nodes_in_graph=len(names))
            first = traj
        else:
            row["eager_equals_captured"] = bool(np.array_equal(traj, first))
    if row["captured"]["scans_per_sec"] and row["eager"]["scans_per_sec"]:
        row["speedup"] = (row["captured"]["scans_per_sec"]
                          / row["eager"]["scans_per_sec"])
    return row


def cli_phase(cfg, frames, room_loop, pg_first, dev="cuda",
              surface_particles=MEGA_PARTICLES, pg_particles=200):
    """The port's CLI on the card, in this process: replay at the parity
    width on room_loop_40.rec (map checkpoint, likelihood view, combined
    map), replay again from that map, the 1M-particle surface replay (which
    must repeat phase 9's room-loop run bit for bit) and posegraph on
    grand_tour_216 (which must repeat phase 17's first run); then
    run_with_recovery with a fault after scan 6's draws (bit-identical to an
    unbroken run) and SlamApplication fed by the loopback robot through
    RobotLink and SlamPipeline.  Each path starts with every launch count
    at 0 and records its kernel calls, which are then held against their
    plain versions (check_recorded); returns the counts by path.  `cfg` is the parity preset; `room_loop`
    (trajectory, map) and `pg_first` (keyframes, closures, chi2) are phase
    9's and phase 17's, run at `surface_particles` and `pg_particles`."""
    import os
    import tempfile
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.app.application import SlamApplication
    from gridmap_slam_tpu_torch.app.pipeline import (LoopbackRobot,
                                                     RobotLink, SlamPipeline)
    from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                           read_map_checkpoint)
    from gridmap_slam_tpu_torch.io.synthetic import default_world
    from gridmap_slam_tpu_torch.parallel.mesh import close_world
    from gridmap_slam_tpu_torch.utils.checkpoint import run_with_recovery
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    gt = np.load(CLI_LOG.replace(".rec", "_gt.npy"))
    launches, out = {}, {}

    def counted(path, fn):
        """fn() with every launch count at 0 and its kernel calls recorded;
        then each recorded call shape is held against its plain version,
        and a kernel launched on the path with no checked call fails."""
        kernels = _zero_launches()
        if dev == "cuda":
            torch.cuda.synchronize()
        with CallRecorder(path) as rec:
            result = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches[path] = {k: mod.launches for k, mod in kernels.items()}
        check_recorded(rec, {path: launches[path]})
        return result

    with tempfile.TemporaryDirectory() as tmp:
        parity = ["--log", CLI_LOG, "--particles", str(cfg.num_particles),
                  "--chunk", str(cfg.particle_chunk), "--max-beams",
                  str(cfg.max_beams), "--map-size", f"{cfg.map.width_m:g}",
                  "--resolution", f"{cfg.map.resolution:g}", "--seed",
                  str(SEED), "--device", dev]
        ckpt = os.path.join(tmp, "m.map")
        for path, extra in (
                ("cli_replay", ["--save-map", ckpt, "--map-view",
                                "likelihood", "--map-select", "combined"]),
                ("cli_load_map", ["--load-map", ckpt])):
            d = os.path.join(tmp, path)
            (state, traj, metrics), printed = counted(
                path, lambda: _cli(["replay", *parity, "--out", d, *extra]))
            pngs = sorted(n for n in os.listdir(d) if n.endswith(".png"))
            out[path] = dict(
                scans=metrics["frames"], ate_m=ate_rmse(traj, gt),
                scans_per_sec=metrics["scans_per_sec"],
                mean_scan_ms=metrics["mean_scan_ms"],
                launches_a_scan={k: v / metrics["frames"]
                                 for k, v in launches[path].items()},
                printed_metrics_equal=printed == metrics,
                trajectory_file_equal=bool(np.array_equal(
                    np.load(os.path.join(d, "replay_trajectory.npy")), traj)),
                finite=bool(np.isfinite(traj).all()
                            and torch.isfinite(state.logodds).all()),
                pngs=pngs)
        params, saved = read_map_checkpoint(ckpt)
        out["cli_replay"]["map_checkpoint"] = dict(
            bytes=os.path.getsize(ckpt), shape=list(saved.shape),
            occupied=int((saved > 0).sum()), free=int((saved < 0).sum()))

        d = os.path.join(tmp, "surface")
        (s_state, s_traj, s_metrics), _ = counted("cli_surface", lambda: _cli(
            ["replay", "--log", CLI_LOG, "--engine", "surface",
             "--particles", str(surface_particles), "--chunk", "0",
             "--max-beams", "192", "--set", "matcher.surface_refine_steps=0",
             "--seed", str(SEED), "--device", dev, "--out", d]))
        out["cli_surface"] = dict(
            particles=int(s_state.poses.shape[0]), ate_m=ate_rmse(s_traj, gt),
            scans_per_sec=s_metrics["scans_per_sec"],
            poses_equal_phase_9=bool(np.array_equal(s_traj, room_loop[0])),
            map_equal_phase_9=bool(np.array_equal(
                s_state.logodds.cpu().numpy(), room_loop[1])))
        del s_state

        # the mesh engines on a world of one (the CLI starts it), on their
        # compiled steps; beside the eager step below
        mesh_argv = {}
        for path, extra in (
                ("cli_tiled", ["--engine", "tiled", "--particles",
                               str(cfg.num_particles), "--chunk",
                               str(cfg.particle_chunk)]),
                ("cli_surface_sharded", [
                    "--engine", "surface-sharded", "--particles",
                    str(surface_particles), "--chunk", "0", "--set",
                    "matcher.surface_refine_steps=0"])):
            d = os.path.join(tmp, path)
            mesh_argv[path] = ["replay", "--log", CLI_LOG, "--max-beams",
                               "192", "--seed", str(SEED), "--device", dev,
                               *extra]
            (m_state, m_traj, m_metrics), printed = counted(path, lambda: _cli(
                [*mesh_argv[path], "--out", d]))
            out[path] = dict(
                particles=int(m_state.poses.shape[0]),
                ate_m=ate_rmse(m_traj, gt),
                scans_per_sec=m_metrics["scans_per_sec"],
                launches_a_scan={k: v / m_metrics["frames"]
                                 for k, v in launches[path].items()},
                printed_metrics_equal=printed == m_metrics,
                finite=bool(np.isfinite(m_traj).all()
                            and torch.isfinite(m_state.logodds).all()))
            del m_state
        mesh_figures = {
            path: _cli_compare(path, lambda d, a=argv: _cli([*a, "--out", d]),
                               _read_replay, tmp)
            for path, argv in mesh_argv.items()}
        close_world()

        d = os.path.join(tmp, "posegraph")
        with _cli_frontends() as fes:
            summary, printed = counted("cli_posegraph", lambda: _cli(
                ["posegraph", "--log", GRAND_TOUR, "--particles",
                 str(pg_particles), "--map-size", "14", "--seed", str(SEED),
                 "--device", dev, "--out", d]))
        pg_graphs = _frontend_graphs(fes[0])
        out["cli_posegraph"] = dict(summary, equal_phase_17=summary == pg_first
                                    and printed == summary,
                                    frontend_graphs=pg_graphs)
        del fes

        # each CLI path on its captured step beside the eager step
        def read_posegraph(result, d):
            m = json.loads(open(os.path.join(d, "pg_online_metrics.json"))
                           .read())
            return (m["frames"], m["scans_per_sec"],
                    np.load(os.path.join(d, "pg_online_trajectory.npy")))

        surface_argv = ["replay", "--log", CLI_LOG, "--engine", "surface",
                        "--particles", str(surface_particles), "--chunk",
                        "0", "--max-beams", "192", "--set",
                        "matcher.surface_refine_steps=0", "--seed",
                        str(SEED), "--device", dev]
        figures = {
            "cli_replay": _cli_compare(
                "cli_replay", lambda d: _cli(["replay", *parity, "--out",
                                              d]), _read_replay, tmp),
            "cli_load_map": _cli_compare(
                "cli_load_map", lambda d: _cli(["replay", *parity, "--out",
                                                d, "--load-map", ckpt]),
                _read_replay, tmp),
            "cli_surface": _cli_compare(
                "cli_surface", lambda d: _cli([*surface_argv, "--out", d]),
                _read_replay, tmp),
            "cli_posegraph": _cli_compare(
                "cli_posegraph", lambda d: _cli(
                    ["posegraph", "--log", GRAND_TOUR, "--particles",
                     str(pg_particles), "--map-size", "14", "--seed",
                     str(SEED), "--device", dev, "--out", d]),
                read_posegraph, tmp), **mesh_figures}

        # recovery: a fault after scan 6 has drawn its numbers
        eng = RBPF(cfg, device=dev)
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device=dev)
        seq = [frame_at(batch, i) for i in range(len(frames))]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        seen = []

        def flaky(state, frame):
            seen.append(len(seen))
            result = eng.step(state, frame, gen)
            if seen[-1] == CLI_FAULT_AT:
                raise RuntimeError("injected device fault")
            return result

        rec_state, rec_infos, report = counted("cli_recovery", lambda: (
            run_with_recovery(flaky, eng.init(), seq,
                              checkpoint_dir=os.path.join(tmp, "ck"),
                              every=CLI_EVERY, generator=gen)))
        ref, ref_infos = eng.run_log(
            eng.init(), seq, torch.Generator(device=dev).manual_seed(SEED))
        out["cli_recovery"] = dict(
            scans=len(seq), every=CLI_EVERY, fault_at=CLI_FAULT_AT,
            restarts=report["restarts"], steps_run=len(seen),
            bit_identical=all(torch.equal(getattr(rec_state, k),
                                          getattr(ref, k))
                              for k in ("poses", "log_weights", "logodds",
                                        "step"))
            and all(torch.equal(a.weighted_pose, b.weighted_pose)
                    for a, b in zip(rec_infos, ref_infos)))
        del eng, rec_state, ref, batch, seq

    # live: the loopback robot -> RobotLink -> SlamPipeline -> the app
    def live():
        robot = LoopbackRobot(default_world(), range_noise_sd=0.01)
        link = RobotLink(robot.host_sock)
        pipe = SlamPipeline(link)
        app = SlamApplication(cfg, RBPF(cfg, device=dev))
        app.init(seed=SEED)
        pipe.subscribe(app.on_frame)
        pipe.start()
        try:
            link.set_resolution(2)
            link.set_speeds(1.0, 1.0)
            link.sensor_enable()
            deadline = time.monotonic() + 60.0
            while app.frames_seen < LIVE_FRAMES and time.monotonic() < deadline:
                pipe.handle_events(1)
                time.sleep(0.002)
            link.sensor_disable()
        finally:
            app.dispose()
            pipe.stop()
            link.close()
            robot.close()
        return app

    with _cli_steps() as steps:
        app = counted("cli_live", live)
    live_launches = {}
    if dev == "cuda":               # a frame's host launches, both steps
        for mode in ("captured", "eager"):
            with _cli_steps(eager=mode == "eager"):
                _, live_launches[mode] = _host_launches_a_scan(live)
    tr = app.trajectory_array()
    cap = steps[0].captured
    out["cli_live"] = dict(frames=app.frames_seen, final_pose=tr[-1].tolist()
                           if len(tr) else None,
                           finite=bool(np.isfinite(tr).all() and torch.isfinite(
                               app.state.poses).all()),
                           captures=cap.captures,
                           kernel_nodes_in_graph=len(cap.kernel_names())
                           if cap.graph is not None else 0,
                           host_launches_a_frame=live_launches)
    sec = time.perf_counter() - t0
    say("cli", paths=out, launches=launches, ate_max_m=CLI_ATE_MAX_M,
        captured_vs_eager=figures, seconds=sec)

    for path in ("cli_replay", "cli_load_map"):
        r = out[path]
        if not (r["finite"] and r["ate_m"] < CLI_ATE_MAX_M
                and r["printed_metrics_equal"] and r["trajectory_file_equal"]):
            raise AssertionError(f"{path}: {r}")
    if out["cli_replay"]["pngs"] != ["replay_likelihood.png",
                                     "replay_map.png"]:
        raise AssertionError(f"cli_replay wrote {out['cli_replay']['pngs']}")
    if not (out["cli_replay"]["map_checkpoint"]["occupied"] > 50
            and params["resolution"] == np.float32(0.05)):
        raise AssertionError(f"map checkpoint: {params} "
                             f"{out['cli_replay']['map_checkpoint']}")
    if not (out["cli_surface"]["poses_equal_phase_9"]
            and out["cli_surface"]["map_equal_phase_9"]):
        raise AssertionError(f"cli_surface differs from phase 9's room-loop "
                             f"run: {out['cli_surface']}")
    for path in ("cli_tiled", "cli_surface_sharded"):
        r = out[path]
        if not (r["finite"] and r["ate_m"] < ROOM_LOOP_ATE_MAX_M
                and r["printed_metrics_equal"]):
            raise AssertionError(f"{path}: {r}")
    if not out["cli_posegraph"]["equal_phase_17"]:
        raise AssertionError(f"cli_posegraph {summary} != phase 17's "
                             f"{pg_first}")
    want_graphs = {"verify": FRONTEND_NODES["verify"],
                   "solve": {k: 0 for k in GRAPH_ROWS},
                   "rebuild": FRONTEND_NODES["rebuild"]}
    if dev == "cuda" and not all(
            g["captures"] == 1 and g["kernels"] == want_graphs[part]
            and g.get("launches") == g.get("launches_wanted")
            for part, g in pg_graphs.items()):
        raise AssertionError(f"cli_posegraph: the frontend's graphs "
                             f"{pg_graphs}")
    if not (out["cli_recovery"]["restarts"] == 1
            and out["cli_recovery"]["bit_identical"]):
        raise AssertionError(f"cli_recovery: {out['cli_recovery']}")
    if not (out["cli_live"]["frames"] >= LIVE_FRAMES
            and out["cli_live"]["finite"] and (dev != "cuda" or (
                out["cli_live"]["captures"] == 1
                and out["cli_live"]["kernel_nodes_in_graph"] > 0
                and live_launches["captured"] < live_launches["eager"]))):
        raise AssertionError(f"cli_live: {out['cli_live']}")
    for path, row in figures.items():
        cap, eag = row["captured"], row["eager"]
        eager_a_scan = eag["python_kernel_launches_a_scan"]
        # the eager run's launches: the step's a scan, and CLI_RUN_LAUNCHES
        # once a run outside the step
        in_graph_ok = path == "cli_posegraph" or all(
            round(eager_a_scan[k] * eag["scans"])
            == cap["kernels_in_graph"][k] * eag["scans"]
            + CLI_RUN_LAUNCHES.get(k, 0) for k in GRAPH_ROWS)
        if not (row["eager_equals_captured"] and (dev != "cuda" or (
                cap["captures"] == 1 and in_graph_ok
                and cap["host_launches_a_scan"]
                < eag["host_launches_a_scan"]))):
            raise AssertionError(f"{path} on its captured step: {row}")
    surface_kernels = ("log_likelihood_field", "integrate_scan")
    for path, counts in launches.items():
        needed = {"cli_surface": surface_kernels,
                  "cli_tiled": ("stage_scores_tile", *surface_kernels),
                  "cli_surface_sharded": surface_kernels}.get(path, BASE_ROWS)
        if not all(counts[k] > 0 for k in needed):
            raise AssertionError(f"{path}: a kernel was not launched: "
                                 f"{counts}")
    return launches


def _bench_run(argv):
    """The benchmark's entry point in this process: (exit code, its last
    line, its cell records), its output printed."""
    import io

    from gridmap_slam_tpu_torch.bench import run as bench_run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(argv)
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    return (rc, json.loads(lines[-1]),
            [json.loads(ln) for ln in lines if ln.startswith('{"cell"')])


def bench_phase():
    """The benchmark (gridmap_slam_tpu_torch/bench) through its own entry
    point in this process: every cell file of bench/cells at 3 timed
    replays.  Fails unless it exits 0, its last line parses with
    `"correct": true`, one record a cell file, the head `mega_surface` (the
    fastest of most particles) and bench.py's `vs_baseline`, and no share
    of a bound reads over 1; then each cell's control (--control) must fail
    its reference comparison; then one of bench.py's one-measurement
    command lines (BENCH_MEASURE: pr1 with the nearest-cell coarse stage
    on its full field) must print a correct line of one cell whose
    K1, K2 and K3 calls all kept their tolerance.  Returns the
    launches of the first run (`bench`) and of the measurement
    (`bench_measure`)."""
    from gridmap_slam_tpu_torch.bench.cells import load_cells
    n_cells = len(load_cells())
    kernels = _zero_launches()
    rc, last, cells = _bench_run(["--reps", "3", "--min-seconds", "0"])
    launches = {k: mod.launches for k, mod in kernels.items()}
    shares = {c["cell"]: {k: v for k, v in (c.get("per_layer") or {}).items()
                          if k.startswith("share_of_bound")} for c in cells}
    say("bench", rc=rc, correct=last["correct"], cells=sorted(last["cells"]),
        head=last["cell"], vs_baseline=last.get("vs_baseline"),
        line_bytes=len(json.dumps(last, separators=(",", ":"))),
        shares_of_bound=shares, launches=launches)
    if rc != 0 or last["correct"] is not True or len(cells) != n_cells:
        raise AssertionError(f"bench: rc {rc}, last line {last}")
    if last["cell"] != "mega_surface" or not last.get("vs_baseline", 0) > 0:
        raise AssertionError(f"bench: the line heads with {last['cell']}, "
                             f"vs_baseline {last.get('vs_baseline')}")
    if not all(shares.values()) or any(
            v > 1.0 for sh in shares.values() for v in sh.values()):
        raise AssertionError(f"bench: a share of a bound missing or over 1: "
                             f"{shares}")
    rc, last, controls = _bench_run(["--control", "--reps", "3",
                                     "--min-seconds", "0"])
    agree = {c["cell"]: {k: v["share"] for k, v in c["agreement"].items()}
             for c in controls}
    say("bench_control", rc=rc, correct=last["correct"],
        share_beyond_tolerance=agree)
    if rc == 0 or len(controls) != n_cells or any(
            c["correct"] or c["kernels_agree"] for c in controls):
        raise AssertionError(f"bench: a control passed: {agree}")
    kernels = _zero_launches()
    rc, last, (rec,) = _bench_run([*BENCH_MEASURE, "--reps", "3",
                                   "--min-seconds", "0"])
    measured = {k: mod.launches for k, mod in kernels.items()}
    if "error" in rec:
        raise AssertionError(f"bench measurement: {rec}")
    shares = {k: v for k, v in (rec["per_layer"] or {}).items()
              if k.startswith("share_of_bound")}
    say("bench_measure", argv=BENCH_MEASURE, rc=rc, correct=last["correct"],
        cell=rec["cell"], overrides=rec["overrides"],
        scans_per_sec=rec["scans_per_sec"]["value"],
        agreement=rec["agreement"], shares_of_bound=shares,
        launches=measured)
    if rc != 0 or last["correct"] is not True or \
            set(rec["agreement"]) != {"K1", "K2", "K3"} or \
            rec["overrides"] != {"matcher.coarse_halfres": False}:
        raise AssertionError(f"bench measurement: rc {rc}, {rec}")
    if len(shares) != 3 or any(v > 1.0 for v in shares.values()):
        raise AssertionError(f"bench measurement: shares of bound {shares}")
    return {"bench": launches, "bench_measure": measured}


# F1-F8: the kernels line's rows (kernel, the XLA fusion each replaces)
FUSION_REPLACES = {
    "motion": ("F1", "gridmap_slam_tpu/models/rbpf.py:180-182 (XLA's fusion "
               "of the vmapped sample_motion and apply_odometry, "
               "gridmap_slam_tpu/ops/motion.py:34-56)"),
    "pool": ("F2", "gridmap_slam_tpu/ops/matcher.py:246-252 (XLA's fusion of "
             "the coarse field's pad and 2 x 2 mean)"),
    "pick": ("F3", "gridmap_slam_tpu/ops/matcher.py:302-321 (XLA's fusions "
             "of _prior_grid :137-153, _argmax3 :156-162 and the take)"),
    "sample": ("F4", "gridmap_slam_tpu/ops/surface.py:231-318 (XLA's fusions "
               "of sample_surface with pack_neighborhoods :193-217 and its "
               "8-wide gather :258-268, and refine_on_surface's climb)"),
    "splat": ("F5", "gridmap_slam_tpu/ops/surface.py:60-97 (XLA's fusion of "
              "splat_endpoint_kernels' tap weights; the dot :98-99 stays "
              "torch.bmm)"),
    "scan": ("F6", "gridmap_slam_tpu/ops/geometry.py:67 deskew_scan, "
             "gridmap_slam_tpu/ops/raycast.py build_beam_lut and "
             "gridmap_slam_tpu/ops/pallas/grid_update.py:58 scan_bin_tables "
             "(XLA's fusions of the scan's preparation)"),
    "weights": ("F7", "gridmap_slam_tpu/ops/resample.py:21-35, :129-137 "
                "(normalized_weights, neff, weighted_mean_pose) in "
                "gridmap_slam_tpu/models/rbpf.py:254-278, "
                "models/shared.py:386-461, :501, :197-240 and "
                "models/multi.py:110-142 (XLA's reduce and loop fusions of "
                "the weights' tail)"),
    "walk": ("F8", "gridmap_slam_tpu/ops/resample.py:112-127 "
             "(systematic_indices' cumsum, searchsorted and clip) and the "
             "gathers of models/rbpf.py, models/shared.py and "
             "models/multi.py (XLA's fusions of the resample)"),
    "weights_mesh": ("F7m", "gridmap_slam_tpu/parallel/shmap.py:136-157 "
                     "(the weight statistics with their pmax and psums, "
                     "the strongest particle's all_gather), :94-103 (the "
                     "surface volume's center) and "
                     "gridmap_slam_tpu/parallel/surface_sharded.py:141-148, "
                     ":206-227 (XLA's fusions of the mesh engines' weights "
                     "tail)"),
    "walk_mesh": ("F8m", "gridmap_slam_tpu/parallel/shmap.py:178-205 and "
                  "surface_sharded.py:259-278 (systematic_indices of the "
                  "gathered log-weights, this rank's slice and the gathers: "
                  "XLA's fusions of the mesh engines' resample body)")}
# the order of an F4 sample's eight products that PyTorch's torch.sum over
# the packed gather's last axis takes on the card, and the others tried
SAMPLE_ORDERS = ("((0+4)+(2+6))+((1+5)+(3+7))", "((0+1)+(2+3))+((4+5)+(6+7))",
                 "(((0+1)+2)+3)+(((4+5)+6)+7)", "sequential",
                 "((0+4)+(1+5))+((2+6)+(3+7))", "(((0+4)+(1+5))+(2+6))+(3+7)")


def pool_order(field, fill: float) -> dict:
    """Bits differing from PyTorch's mean over the pooled axes on this card
    (fusions.pool_plain) of three sum orders of a 2 x 2 block (a, b its top
    row, c, d its bottom) and of F2, on `field` and on random fields of an
    odd and an even shape."""
    import torch.nn.functional as F
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fields = (field,
              torch.randn((3, 121, 119), generator=gen, device="cuda") * 5.0,
              torch.rand((2, 64, 64), generator=gen, device="cuda") * 1e3)
    out = {}
    for f in fields:
        want = fusions.pool_plain(f, fill)
        h, w = f.shape[-2:]
        e = F.pad(f, (0, w & 1, 0, h & 1), value=fill)
        a, b = e[:, 0::2, 0::2], e[:, 0::2, 1::2]
        c, d = e[:, 1::2, 0::2], e[:, 1::2, 1::2]
        for name, v in (("(a+b)+(c+d)", ((a + b) + (c + d)) * 0.25),
                        ("((a+b)+c)+d", (((a + b) + c) + d) * 0.25),
                        ("(a+c)+(b+d)", ((a + c) + (b + d)) * 0.25),
                        ("F2", fusions.pool_cuda(f, fill))):
            out.setdefault(name, []).append(_bits_differing(v, want))
    return out


def _sum_in(order: str, q):
    """The eight products q[0..7] summed in one of SAMPLE_ORDERS."""
    if order == SAMPLE_ORDERS[0]:
        return ((q[0] + q[4]) + (q[2] + q[6])) + ((q[1] + q[5]) + (q[3] + q[7]))
    if order == SAMPLE_ORDERS[1]:
        return ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]))
    if order == SAMPLE_ORDERS[2]:
        return (((q[0] + q[1]) + q[2]) + q[3]) + (((q[4] + q[5]) + q[6]) + q[7])
    if order == SAMPLE_ORDERS[3]:
        v = q[0]
        for t in q[1:]:
            v = v + t
        return v
    if order == SAMPLE_ORDERS[4]:
        return ((q[0] + q[4]) + (q[1] + q[5])) + ((q[2] + q[6]) + (q[3] + q[7]))
    return (((q[0] + q[4]) + (q[1] + q[5])) + (q[2] + q[6])) + (q[3] + q[7])


def f4_library(c_vol, poses, kw) -> dict:
    """F4's library call: torch.nn.functional.grid_sample of the volume as
    a 5-D input, trilinear ("bilinear"), padding_mode "border",
    align_corners True: the trilinear sample with every coordinate clamped
    to the volume's edge cells, the packed array's replicate padding, where
    theta does not wrap (grid_sample cannot wrap; a wrapped grid has no
    library call).  The poses go to grid_sample's (x, y, theta)
    coordinates in [-1, 1] outside the timed call, by the plain version's
    float32 arithmetic; the contiguous volume likewise.  Its ms (CUDA
    events, as `ms`), its and F4's device ms inside a CUDA graph
    (graph_ms), and its largest difference from F4's samples at the same
    poses beside F4_LIBRARY_RTOL of the volume's largest magnitude."""
    import torch.nn.functional as F
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    if kw["wrap_theta"] or kw.get("steps", 0):
        return dict(library_ms=None)
    # the sample itself: grid_sample has no temperature
    kw = {**kw, "temp": 1.0, "n_used": None}
    nt, hc, wc = c_vol.shape
    x, y, th = poses.reshape(-1, 3).unbind(-1)
    fx = (x - kw["origin"][0]) / kw["resolution"] - 0.5 - kw["crop_ix0"]
    fy = (y - kw["origin"][1]) / kw["resolution"] - 0.5 - kw["crop_iy0"]
    ft = (torch.remainder(th - kw["theta0"] + math.pi, 2.0 * math.pi)
          - math.pi) / kw["dtheta"]
    grid = torch.stack([fx * (2.0 / max(wc - 1, 1)) - 1.0,
                        fy * (2.0 / max(hc - 1, 1)) - 1.0,
                        ft * (2.0 / max(nt - 1, 1)) - 1.0], -1)
    grid = grid.reshape(1, 1, 1, -1, 3).contiguous()
    vol = c_vol.contiguous()[None, None]

    def library():
        return F.grid_sample(vol, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    def f4():
        return fusions.score_cuda(c_vol, poses, **kw)

    got = library().reshape(-1)
    want = f4()[1].reshape(-1)
    err = float((got - want).abs().max())
    scale = float(c_vol.abs().max())
    return dict(library_ms=cuda_ms(library, 20), library_max_abs_err=err,
                library_tol=F4_LIBRARY_RTOL * scale,
                library_graph_ms=graph_ms(library, 20),
                f4_graph_ms=graph_ms(f4, 20))


def sample_order(c_vol, poses, kw) -> dict:
    """Bits differing from today's packed sample on this card
    (fusions.score_plain with no climb, whose last op is torch.sum(g * w8,
    -1)) of the eight products g * w8 summed in each of SAMPLE_ORDERS and of
    F4 (fusions.score_cuda): at a recorded call's volume and poses (`kw` its
    keyword arguments, less the climb) and at a random volume and poses in each theta mode
    (crop edges, poses off the crop, headings around the circle).  The
    products are the plain version's own: torch.sum is wrapped for that one
    call to keep its argument."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(c_vol, poses, {**kw, "steps": 0, "temp": 1.0, "n_used": None})]
    lo = torch.tensor([-0.2, -0.1, -3.5], device="cuda")
    span = torch.tensor([2.4, 2.2, 7.0], device="cuda")
    for wrap in (False, True):
        nt = 9
        vol = torch.randn((nt, 37, 41), generator=gen, device="cuda") * 10.0
        pose = lo + span * torch.rand((200_000, 3), generator=gen,
                                      device="cuda")
        cases.append((vol, pose, dict(
            theta0=torch.full((), -0.3, device="cuda"),
            dtheta=2.0 * math.pi / nt if wrap else 0.07,
            crop_iy0=torch.full((), 3, dtype=torch.int64, device="cuda"),
            crop_ix0=torch.full((), 2, dtype=torch.int64, device="cuda"),
            resolution=0.05, origin=(0.0, 0.0), wrap_theta=wrap)))
    out = {name: [] for name in (*SAMPLE_ORDERS, "F4")}
    real_sum = torch.sum
    for vol, pose, k in cases:
        kept = []

        def keep(x, *a, **kk):
            kept.append(x)
            return real_sum(x, *a, **kk)

        torch.sum = keep
        try:
            want = fusions.score_plain(vol, pose, **k)[1]
        finally:
            torch.sum = real_sum
        q = [kept[-1][..., i] for i in range(8)]
        for name in SAMPLE_ORDERS:
            out[name].append(_bits_differing(_sum_in(name, q), want))
        out["F4"].append(_bits_differing(
            fusions.score_cuda(vol, pose, **k)[1], want))
    return out


def scan_ties(n_bins: int = 2048, details=None) -> dict:
    """F6 against its plain version on the card, bit for bit, on scans
    with planted beams: equal bearings (equal ranges too), +0.0 and -0.0,
    +-pi in float32, padding beams, and in batches of 3 an all-invalid scan;
    at 96 beam slots (where PyTorch's stable argsort on the card is a warp
    merge sort) and 192 and 360 (a radix sort), one scan and a batch, each
    with
    deskew and tables (the first scan of each with zero odometry, so its
    ties survive the deskew), tables only and deskew only, and with a
    step's outputs (deskew, tables, endpoints, used and every 4th beam,
    their count and the gate keep at |d_theta| <= 0.3, also frozen) and the
    endpoints alone (every 3rd beam; every beam beside the tables), the
    all-invalid scan's count clamped to 1.  Returns the
    differing bits by case (`details`, a dict where given, gets the first
    differing entries of each case that differs)."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for b in (96, 192, 360):
        for g in (1, 3):
            ang = rng.uniform(-math.pi, math.pi, (g, b)).astype(np.float32)
            dist = rng.uniform(0.2, 9.0, (g, b)).astype(np.float32)
            hit = rng.uniform(size=(g, b)) < 0.8
            valid = np.ones((g, b), bool)
            valid[:, b - b // 8:] = False
            for i, j in ((5, 9), (20, 21), (22, 21), (40, 60)):
                ang[:, i], dist[:, i] = ang[:, j], dist[:, j]
            ang[:, 10:14] = [0.0, -0.0, np.float32(math.pi),
                             -np.float32(math.pi)]
            ang[:, 14], ang[:, 15] = -0.0, 0.0
            dist[:, 10:16] = 3.0
            if g == 3:
                valid[2] = False
            dc = rng.uniform(-0.3, 0.3, g).astype(np.float32)
            dt = rng.uniform(-0.4, 0.4, g).astype(np.float32)
            dc[0] = dt[0] = 0.0
            t = [torch.as_tensor(a[0] if g == 1 else a, device="cuda")
                 for a in (ang, dist, hit, valid)]
            odo = [torch.as_tensor(d[0] if g == 1 else d, device="cuda")
                   for d in (dc, dt)]
            step = dict(points=True, stride=4, keep_below=0.3)
            for name, o, nb, kw in (
                    ("prepare", odo, n_bins, {}),
                    ("tables", (None, None), n_bins, {}),
                    ("deskew", odo, 0, {}),
                    ("step", odo, n_bins, step),
                    ("step frozen", odo, n_bins, {**step, "freeze": True}),
                    ("points", (None, None), 0, dict(points=True, stride=3)),
                    ("points stride 1", (None, None), n_bins,
                     dict(points=True))):
                got = _outputs(fusions.scan_cuda(*t, *o, n_bins=nb, **kw))
                want = _outputs(fusions.scan_plain(*t, *o, n_bins=nb, **kw))
                bits = (sum(_bits_differing(x, y) for x, y in zip(got, want))
                        if len(got) == len(want) else -1)
                out[f"{name} {g}x{b}"] = bits
                if bits and details is not None:
                    # the first differing table entries: (output, row, bin,
                    # the kernel's value, the plain version's)
                    details[f"{name} {g}x{b}"] = [
                        (k, *map(int, ix), float(x[tuple(ix)]),
                         float(y[tuple(ix)]))
                        for k, (x, y) in enumerate(zip(got, want))
                        if x.dtype == torch.float32 and x.shape == y.shape
                        for ix in (x.view(torch.int32) != y.view(
                            torch.int32)).reshape(x.shape).nonzero()[:3]
                        .reshape(-1, x.dim()).cpu().tolist()]
    return out


def rsqrt_probe(n: int = RSQRT_PROBE_VALUES) -> dict:
    """F4's rsqrtf (csrc/fusions.cu temper, through
    fusions.weight_exp_cuda(x, rsqrt=True)) against torch.rsqrt on the
    card, bit for bit: every used-beam count 1 to n and n random floats in
    [1, 1e6)."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.cat([torch.arange(1, n + 1, dtype=torch.float32,
                                device="cuda"),
                   1.0 + torch.rand(n, generator=gen, device="cuda") * 1e6])
    return dict(values=x.numel(), bits_differing=_bits_differing(
        fusions.weight_exp_cuda(x, rsqrt=True), torch.rsqrt(x)))


def exp_probe(n: int = EXP_PROBE_VALUES) -> dict:
    """F7's exp (csrc/fusions.cu weight_exp, through
    fusions.weight_exp_cuda) against torch.exp on the card, bit for bit,
    over n values in [-120, 0) and a few edges (+-0, the float32 underflow
    around -87 to -104, -inf, NaN, 1, 10)."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.cat([torch.rand(n, generator=gen, device="cuda") * -120.0,
                   torch.tensor([0.0, -0.0, -87.0, -88.7, -103.9, -104.0,
                                 -math.inf, math.nan, 1.0, 10.0],
                                device="cuda")])
    return dict(values=x.numel(), bits_differing=_bits_differing(
        fusions.weight_exp_cuda(x), torch.exp(x)))


# F3 and F7 on planted inputs (fusion_edges): F3's particle counts (one, the
# parity and chip chunks, the shared-field check's 2 048, a 500 000 block)
# and stages, F7's weights a robot (one, 500, a row less one, a row, a row
# and one, 10 000, the 1M of the surface cells) at one and two robots
EDGE_PICK_PARTICLES = (1, 250, 500, 2048, 500_000)
# the matcher's stages, and a window whose particle's scores pass a slab's
# staging (its scores read in place) at up to WIDE_PARTICLES particles, and
# stages of 51 x 51 and 101 x 101 (dy, dx) cells (a lane's cells walked in
# groups) at 11 headings (coarse) and 3 (fine)
EDGE_PICK_STAGES = {"coarse": (11, 9, 9), "fine": (5, 5, 5),
                    "wide": (5, 31, 31), "coarse 51": (11, 51, 51),
                    "fine 51": (3, 51, 51), "coarse 101": (11, 101, 101),
                    "fine 101": (3, 101, 101)}
WIDE_PARTICLES = 2048
EDGE_PICK_KINDS = ("ties", "nan", "neginf", "zeros", "equal")
EDGE_WEIGHTS = (1, 500, 1023, 1024, 1025, 10_000, 1 << 20)
EDGE_WEIGHT_KINDS = ("ties", "neginf")
# F7's and F8's mesh forms on planted weights split over emulated ranks:
# the weights in all, whose slices straddle a row of 1024 at 2 and 4 ranks
MESH_EDGE_WEIGHTS = (8, 2048, 2052, 4100, 1 << 20)
MESH_EDGE_RANKS = (2, 4)


class _ThreadRanks:
    """n ranks emulated in this process, a thread each on the card's
    current stream, whose collectives (ops/cuda/fusions.Collectives)
    combine the ranks' tensors in rank order (the elementwise max, the sum
    ((x0 + x1) + x2) ..., the stack): what a rank hands a collective was
    enqueued before the barrier, so the stream orders it before the
    combination."""

    def __init__(self, n: int):
        import threading
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def comm(self, rank: int):
        from gridmap_slam_tpu_torch.ops.cuda import fusions

        def collective(kind):
            def call(x):
                self.slots[rank] = x
                self.barrier.wait()
                xs = list(self.slots)
                self.barrier.wait()
                if kind == "all_gather":
                    return torch.stack(xs)
                out = xs[0].clone()
                for y in xs[1:]:
                    out = torch.maximum(out, y) if kind == "pmax" else out + y
                return out
            return call
        return fusions.Collectives(*(collective(k) for k in
                                     ("pmax", "psum", "all_gather")))

    def run(self, fn):
        """[fn(rank, comm) for each rank], run together."""
        import concurrent.futures
        with concurrent.futures.ThreadPoolExecutor(self.n) as pool:
            futures = [pool.submit(fn, r, self.comm(r))
                       for r in range(self.n)]
            return [f.result(timeout=300) for f in futures]


def _mesh_edges(gen) -> list:
    """F7's mesh form, and F8's, on planted inputs bit for bit against
    their plain versions on the card: MESH_EDGE_WEIGHTS log-weights and
    poses split over MESH_EDGE_RANKS emulated ranks (_ThreadRanks; the
    slices of one tensor, some not 16-byte aligned), on each of
    EDGE_WEIGHT_KINDS (the ties also at the ranks' edges): the tail
    without and with the epilogue (the recovery EMAs and the map update's
    crop), and the center call with the volume's window; then F8's mesh
    form on the gathered rows, each rank's slots, with and without the
    log-weights.  One row a call (the ranks' differing bits summed)."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    from gridmap_slam_tpu_torch.types import Odom
    dev = "cuda"
    crop = fusions.WindowSpec(crop=(40, 40), full=(120, 150),
                              resolution=0.05, origin=(-3.0, -3.5))
    volume = fusions.WindowSpec(crop=(48, 48), full=(120, 150),
                                resolution=0.05, origin=(-3.0, -3.5),
                                volume=True, radius=6, ext=(60, 60), nt=25,
                                t_off=-0.3, dtheta=0.025)
    odom = Odom(torch.tensor(0.12, device=dev),
                torch.tensor(-0.2, device=dev))
    modes = {"stats": {},
             "tail": dict(resample_fraction=0.5,
                          recov=torch.tensor([-3.0, -2.5], device=dev),
                          step=torch.tensor(3, dtype=torch.int32,
                                            device=dev),
                          reinject=(0.001, 0.1), window=crop),
             "center": dict(center=True, window=volume, odom=odom)}
    rows = []
    for p, n, kind in ((p, n, k) for p in MESH_EDGE_WEIGHTS
                       for n in MESH_EDGE_RANKS for k in EDGE_WEIGHT_KINDS):
        lw, poses = (t[0] for t in _edge_weights_inputs(1, p, kind, gen))
        p_loc = p // n
        if kind == "ties":
            edges = torch.tensor([e for r in range(1, n)
                                  for e in (r * p_loc - 1, r * p_loc)],
                                 device=dev)
            lw[edges] = 4.0
        for mode, kw in modes.items():
            def one(fn, kw=kw):
                def rank(r, comm):
                    sl = slice(r * p_loc, (r + 1) * p_loc)
                    return _outputs(fn(lw[sl], poses[sl], comm, **kw))
                return _ThreadRanks(n).run(rank)
            got = one(fusions.weights_mesh_cuda)
            want = one(fusions.weights_mesh_plain)
            rows.append(dict(
                kernel="F7m", weights=p, ranks=n, kind=kind, mode=mode,
                bits_differing=sum(
                    sum(map(_bits_differing, g, w)) if len(g) == len(w)
                    else -1 for g, w in zip(got, want))))
        gathered = torch.cat([lw[:, None], poses], 1)
        u0 = torch.rand((), generator=gen, device=dev) / p
        for r in range(n):
            for gather_weights in (True, False):
                kw = dict(base=r * p_loc, count=p_loc,
                          gather_weights=gather_weights)
                got = _outputs(fusions.walk_mesh_cuda(gathered, u0, **kw))
                want = _outputs(fusions.walk_mesh_plain(gathered, u0, **kw))
                rows.append(dict(kernel="F8m", weights=p, ranks=n, rank=r,
                                 kind=kind, gather_weights=gather_weights,
                                 bits_differing=sum(map(_bits_differing,
                                                        got, want))
                                 if len(got) == len(want) else -1))
    return rows


def _edge_candidates(p, nt, ny, nx) -> list:
    """The candidates where F3's plan splits a particle: the first and the
    last, each lane's and warp's edges (ops/cuda/fusions.pick_plan) and,
    where a lane walks its cells in groups, the groups' edges at the first,
    second and last heading."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    n, nyx = nt * ny * nx, ny * nx
    lanes = fusions.pick_plan(p, nt, ny, nx).lanes
    edges = {0, n - 1}
    for w in {lanes, 32}:
        edges |= {w - 1, w, n - w, n - w - 1, 2 * w - 1}
    group = fusions.PICK_CELLS * lanes
    for e in range(group, nyx, group):
        for h in {0, nyx, n - nyx}:
            edges |= {h + e - 1, h + e, h + e + lanes - 1}
    return sorted(e for e in edges if 0 <= e < n)


def _edge_pick_inputs(p, stage, kind, gen):
    """(args, kw) of one F3 call on planted scores: `ties` the same top
    score at the split points (a zero prior weight: the totals are the
    scores), `nan` NaNs at half of them, `neginf` every score -inf but at
    some, `zeros` +-0 everywhere (a zero prior weight), `equal` every score
    equal with offsets symmetric about 0 and the prior centered at pose0
    (mirrored candidates tie); the particles' patterns shifted by their
    index, so that a block's first and last particle differ."""
    nt, ny, nx = EDGE_PICK_STAGES[stage]
    n, dev = nt * ny * nx, "cuda"
    edges = torch.tensor(_edge_candidates(p, nt, ny, nx), device=dev)
    shift = torch.arange(p, device=dev)[:, None] % edges.numel()
    cols = edges[(torch.arange(edges.numel(), device=dev) + shift)
                 % edges.numel()][:, : max(edges.numel() // 2, 1)]
    rows = torch.arange(p, device=dev)[:, None].expand_as(cols)
    scores = torch.randn((p, n), generator=gen, device=dev) * 3.0 - 30.0
    weight = 0.7
    if kind == "ties":
        scores[rows, cols], weight = 1e4, 0.0
    elif kind == "nan":
        scores[rows[:, ::2], cols[:, ::2]] = math.nan
    elif kind == "neginf":
        scores.fill_(-math.inf)
        scores[rows[::2], cols[::2]] = -1e30
    elif kind == "zeros":
        scores = torch.where(torch.rand((p, n), generator=gen, device=dev)
                             < 0.5, 0.0, -0.0)
        weight = 0.0
    else:
        scores.fill_(-5.0)

    def offsets(m, span):
        base = torch.linspace(-span, span, m, device=dev)
        if kind == "equal":
            return base.expand(p, m).contiguous()
        return base + (torch.rand((p, 1), generator=gen, device=dev)
                       - 0.5) * 0.02

    pose0 = (torch.rand((p, 3), generator=gen, device=dev) - 0.5) * 6.0
    center = None if kind == "equal" else (
        pose0 + torch.randn((p, 3), generator=gen, device=dev) * 0.05)
    coarse = stage.startswith("coarse")
    use = (torch.rand(192, generator=gen, device=dev) < 0.7) if coarse \
        else None
    dxs, dys, dts = offsets(nx, 0.2), offsets(ny, 0.2), offsets(nt, 0.3)
    d_c, d_t = (torch.tensor(v, device=dev) for v in (0.12, -0.2))
    return (scores.reshape(p, nt, ny, nx), dxs, dys, dts, pose0, center, d_c,
            d_t, use), weight


def _edge_weights_inputs(r, p, kind, gen):
    """Log-weights (r, p) and poses (r, p, 3) on the card: `ties` the max
    at the first and last weight and at the rows' edges, `neginf` a third
    of the weights -inf; headings past +-pi (the mean wraps them)."""
    dev = "cuda"
    lw = torch.randn((r, p), generator=gen, device=dev) * 2.0 - 3.0
    if kind == "ties":
        at = torch.tensor(sorted({0, p - 1, min(1023, p - 1),
                                  min(1024, p - 1)}), device=dev)
        lw[:, at] = 4.0
    else:
        lw[torch.rand((r, p), generator=gen, device=dev) < 1.0 / 3.0] = \
            -math.inf
    poses = (torch.rand((r, p, 3), generator=gen, device=dev) - 0.5) * 10.0
    poses[..., 2] *= 2.0
    return lw, poses


def fusion_edges() -> dict:
    """F3 and F7 on planted inputs, bit for bit against their plain versions
    on the card: F3 at EDGE_PICK_PARTICLES in its three modes (the coarse
    stage with the scan's mask writing offsets, a fine stage writing
    offsets, the last stage writing the best pose and its score), and a
    window too wide to stage writing offsets and the best pose, on each of
    EDGE_PICK_KINDS; F7 at EDGE_WEIGHTS weights a robot, one and two robots,
    with the epilogue and without (with the recovery EMAs at one robot), on
    each of EDGE_WEIGHT_KINDS; F7's and F8's mesh forms over emulated ranks
    (_mesh_edges).  Returns each kernel's calls and differing bits; fails
    on one."""
    from gridmap_slam_tpu_torch.config import MotionConfig
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    motion = MotionConfig()
    off = (torch.linspace(-0.05, 0.05, 5, device="cuda"),
           torch.linspace(-0.02, 0.02, 5, device="cuda"))
    rows = []
    for p, kind in ((p, k) for p in EDGE_PICK_PARTICLES
                    for k in EDGE_PICK_KINDS):
        wide = (("wide", False), ("wide", True), ("coarse 51", False),
                ("fine 51", True), ("coarse 101", False),
                ("fine 101", True)) if p <= WIDE_PARTICLES else ()
        for stage, last in (("coarse", False), ("fine", False),
                            ("fine", True), *wide):
            args, weight = _edge_pick_inputs(p, stage, kind, gen)
            nxt = (None, None) if last else off
            kw = dict(motion=motion, prior_weight=weight, stride=3)
            got = fusions.pick_cuda(*args, *nxt, **kw)
            want = fusions.pick_plain(*args, *nxt, **kw)
            rows.append(dict(kernel="F3", particles=p, stage=stage,
                             last=last, kind=kind,
                             plan=fusions.pick_plan(
                                 p, *EDGE_PICK_STAGES[stage])._asdict(),
                             bits_differing=sum(map(_bits_differing, got,
                                                    want))))
            del args, got, want
    for p, r, kind in ((p, r, k) for p in EDGE_WEIGHTS for r in (1, 2)
                       for k in EDGE_WEIGHT_KINDS):
        lw, poses = _edge_weights_inputs(r, p, kind, gen)
        for epilogue in (False, True):
            kw = {}
            if epilogue:
                kw = dict(resample_fraction=0.5)
                if r == 1:
                    kw.update(recov=torch.tensor([-3.0, -2.5], device="cuda"),
                              step=torch.tensor(3, dtype=torch.int32,
                                                device="cuda"),
                              reinject=(0.001, 0.1))
            x = lw if r == 2 else lw[0]
            q = poses if r == 2 else poses[0]
            got = _outputs(fusions.weights_cuda(x, q, **kw))
            want = _outputs(fusions.weights_plain(x, q, **kw))
            rows.append(dict(kernel="F7", weights=p, robots=r, kind=kind,
                             epilogue=epilogue, launches=fusions.weights_plan(
                                 r, p).launches,
                             bits_differing=sum(map(_bits_differing, got,
                                                    want))
                             if len(got) == len(want) else -1))
    rows += _mesh_edges(gen)
    torch.cuda.synchronize()
    bad = [row for row in rows if row["bits_differing"]]
    out = {k: dict(calls=sum(row["kernel"] == k for row in rows),
                   bits_differing=sum(row["bits_differing"] for row in rows
                                      if row["kernel"] == k))
           for k in ("F3", "F7", "F7m", "F8m")}
    say("fusion_edges", **out, differing=bad)
    if bad:
        raise AssertionError(f"fusion_edges: {len(bad)} planted F3, F7 or "
                             f"mesh-form calls differ from their plain "
                             f"versions")
    return out


def fusions_phase(cfg, frames, paths=FUSION_PATHS) -> list:
    """F1-F8 (csrc/fusions.cu).  The parity preset's log again with F1-F8's
    calls recorded (CallRecorder) and held bit for bit against their plain
    versions (check_fusion); the sum order of PyTorch's mean over the pooled
    axes on this card among three, beside F2's (pool_order); the order of
    the packed sample's eight-term sum among SAMPLE_ORDERS, beside F4's
    (sample_order, on the first recorded F4 call's volume and poses and on
    random ones); F6 on planted scans (scan_ties); F7's exp against
    torch.exp (exp_probe); then one line of every
    F1-F8 check of this run by path and kernel (the other paths checked
    theirs in their own phases).  Fails where a path of FUSION_PATHS has no
    checked F6 call, a path outside SURFACE_PATHS no checked F3 call, a
    surface path no checked F4 and F5 call (mega refine no hill-climb), a
    path of WEIGHTS_PATHS no checked F7 (MESH_PATHS: F7's mesh form's) and
    F8 call, the
    parity path lacks one of F1-F3 and F6, F2 differs from the mean or F4
    from today's sample in a bit, or F6 from its plain version on a planted
    scan, F7's exp from torch.exp in a bit, F3, F7 or a mesh form from its
    plain version on planted inputs (fusion_edges),
    or grid_sample from F4 beyond its tolerance (f4_library, on the
    mega path's first F4 call) (`paths`: FUSION_PATHS, or the paths a
    shorter run took).  Returns the kernels line's rows of F1-F8 and the
    mesh forms: F1-F3 and
    F6 timed on the parity path's calls, F4, F5 and F8 on the mega path's,
    F7 on the mega path's call with the epilogue, F7's mesh form on
    shmap_surface's and F8's on the two-rank phase's first (F4's library_ms
    grid_sample's there, F7's torch.softmax's of the same log-weights;
    F7's and F8's `stages`, and the mesh forms', every recorded call's
    times)."""
    import torch.nn.functional as F
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    eng = RBPF(cfg, device="cuda")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    seq = [frame_at(batch, i) for i in range(len(frames))]
    with CallRecorder("parity", kernels=FUSIONS) as rec:
        eng.run_log(eng.init(), seq,
                    torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
    parity = [check_fusion(*call) for call in rec.calls]
    field = next(args[0] for _, k, args, _ in rec.calls if k == "F2")
    order = pool_order(field, math.log(1.0 / cfg.sensor.max_range))

    def first(kernel, path):
        return next(r for r in FUSION_CHECKS
                    if r["kernel"] == kernel and r["path"] == path)

    s_args, s_kw = FUSION_ARGS["F4"]
    s_order = sample_order(*s_args, s_kw)
    ties = scan_ties(cfg.beam_lut_bins)
    exp = exp_probe()
    rsqrt = rsqrt_probe()
    edges = fusion_edges()
    want, paths = paths, {}
    for row in FUSION_CHECKS:
        k = paths.setdefault(row["path"], {}).setdefault(
            row["kernel"] + (" climb" if row.get("steps") else ""),
            dict(calls=0, bits_differing=0, ms=[]))
        k["calls"] += 1
        k["bits_differing"] += row["bits_differing"]
        k["ms"].append(row["ms"])
    say("fusions", pool_order=order, sample_order=s_order, scan_ties=ties,
        f7_exp=exp, f4_rsqrt=rsqrt, edges=edges, paths=paths,
        parity_calls=parity,
        checked_calls=len(FUSION_CHECKS))
    needed = {p: ({"F4 climb" if p == "mega refine" else "F4", "F5", "F6"}
                  if p in SURFACE_PATHS else {"F3", "F6"})
                 | ({"F7m" if p in MESH_PATHS else "F7", "F8"}
                    if p in WEIGHTS_PATHS else set())
              for p in want}
    missing = {p: sorted(k - set(paths.get(p, {})))
               for p, k in needed.items() if k - set(paths.get(p, {}))}
    if missing or not {"F1", "F2", "F3", "F6"} <= set(paths["parity"]):
        raise AssertionError(f"fusions: no checked call of {missing}, or "
                             f"not F1-F3 and F6 on parity: "
                             f"{paths['parity']}")
    if any(order["F2"]):
        raise AssertionError(f"fusions: F2 differs from PyTorch's mean: "
                             f"{order}")
    if any(s_order["F4"]):
        raise AssertionError(f"fusions: F4 differs from today's sample: "
                             f"{s_order}")
    f4_lib = {k: v for k, v in first("F4", "mega").items()
              if k.startswith(("library", "f4_"))}
    say("f4_library", **f4_lib)
    if not f4_lib.get("library_max_abs_err", 0.0) <= f4_lib.get(
            "library_tol", 0.0):
        raise AssertionError(f"fusions: grid_sample differs from F4 beyond "
                             f"its tolerance: {f4_lib}")
    if any(ties.values()):
        raise AssertionError(f"fusions: F6 differs from its plain version "
                             f"on planted scans: {ties}")
    if exp["bits_differing"]:
        raise AssertionError(f"fusions: F7's exp differs from torch.exp: "
                             f"{exp}")
    if rsqrt["bits_differing"]:
        raise AssertionError(f"fusions: F4's rsqrtf differs from "
                             f"torch.rsqrt: {rsqrt}")

    rows = []
    for name, (kernel, replaces) in FUSION_REPLACES.items():
        if kernel in ("F7", "F7m"):
            # mega's tail, shmap_surface's at mesh (1, 1): 1M weights, the
            # epilogue
            timed = next(r for r in FUSION_CHECKS if r["kernel"] == kernel
                         and r["path"] == ("mega" if kernel == "F7"
                                           else "shmap_surface")
                         and r["epilogue"])
        elif kernel == "F8m":       # a rank's slots of the two-rank run
            timed = next(r for r in FUSION_CHECKS if r["kernel"] == "F8m")
        else:
            timed = first(kernel, "mega" if kernel in ("F4", "F5", "F8")
                          else "parity")
        row = dict(name=name, route="cuda",
                   source="gridmap_slam_tpu_torch/csrc/fusions.cu",
                   replaces=replaces, max_abs_err=PATH_MAX_ERR[name],
                   ms=timed["ms"], plain_ms=timed["plain_ms"],
                   bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
                   library_ms=timed.get("library_ms"))
        if kernel == "F2" and not (field.shape[1] % 2 or field.shape[2] % 2):
            # the same function on even fields: one PyTorch call
            row["library_ms"] = cuda_ms(lambda: F.avg_pool2d(field, 2), 20)
        if kernel == "F3":
            row["stages"] = {
                f"parity {r['stage']}{' last' if r['last'] else ''} "
                f"{'x'.join(map(str, r['shapes'][0]))}": {
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}
                for r in parity if r["kernel"] == "F3"}
        if kernel in ("F7", "F8", "F7m", "F8m"):
            row["stages"] = {
                f"{r['path']} {kernel} {r.get('robots', 1)}x{r['weights']}"
                + (" center" if r.get("center") else "")
                + (" epilogue" if r.get("epilogue") else "")
                + (" recovery" if r.get("recovery") else "")
                + (" slots {}+{}".format(*r["slots"]) if r.get("slots")
                   else ""): {
                    k: r.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
                for r in FUSION_CHECKS if r["kernel"] == kernel}
        if kernel in ("F4", "F6"):
            row["stages"] = {
                f"{r['path']} {r['kernel']} "
                f"{'x'.join(map(str, r['shapes'][1 if kernel == 'F4' else 0]))}"
                + (f" bins {r['n_bins']} deskew {r['deskew']}"
                   if kernel == "F6" else f" steps {r['steps']}"): {
                    k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}
                for r in FUSION_CHECKS if r["kernel"] == kernel}
        rows.append(row)
    return rows


def main() -> int:
    name = device_phase()
    build_phase()
    cfg = parity_config()
    frames, gt = parity_log()
    rows = kernel_phase(cfg, frames)
    k1_ties_phase(cfg)
    agree_phase(frames)
    by_path = {"parity": main_phase(cfg, frames, gt)}
    k3_radii_phase(cfg)
    eng, batches, state = surface_setup(frames)
    surface_ops_phase(eng, batches, state)
    surface_agree_phase(eng, batches, state)
    del eng, batches, state
    k4_row = k4_phase(frames)
    from gridmap_slam_tpu_torch import city_config
    by_path["mega"], room_loop = mega_phase(frames, gt)
    by_path["city"], eng, state, seq, _ = surface_path(
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
    pg_launches, pg_first, pg_graph, pg_in_graph = posegraph_phase()
    by_path.update(pg_launches)
    by_path["config5_posegraph"] = config5_posegraph_phase()
    by_path["chip"] = chip_phase(frames, gt)
    pr1_launches, pr1_rows = pr1_phase(frames)
    by_path.update(pr1_launches)
    by_path["wide51"] = wide_phase(frames)
    rows[2]["stages"].update(pr1_rows["K1"])
    rows[1]["stages"] = pr1_rows["K2"]
    rows[0]["stages"] = pr1_rows["K3"]
    cap_launches, in_graph = captured_phase(frames, gt)
    by_path.update(cap_launches)
    in_graph.update(pg_in_graph)
    par_launches, tile_row, par_in_graph = parallel_phase(frames, pg_graph)
    by_path.update(par_launches)
    in_graph.update(par_in_graph)
    rows.append(tile_row)
    rows.append(k4_row)
    by_path.update(cli_phase(cfg, frames, room_loop, pg_first))
    by_path.update(bench_phase())
    rows.extend(fusions_phase(cfg, frames))
    for row in rows:
        row["max_abs_err"] = max(row["max_abs_err"],
                                 PATH_MAX_ERR[row["name"]])
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        row["in_graph_per_scan"] = {
            path: nodes.get(row["name"], 0)
            for path, nodes in in_graph.items()}
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path",
                             "in_graph_per_scan", "max_abs_err", "ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "stages") if k in row}
        for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
