"""The captured replays of this tree against an earlier commit's, in
alternating processes on one card: device time, peak memory and bits.

For each path (chip_smoke.py's captured phase's engines and logs: parity,
pr1, chip, mega, city, mega_bf16, city_bf16, mega_refine (mega with two
hill-climb steps), mega_blocked over 6 scans, multi at 10 000 a robot over
20 ticks; and its parallel phase's compiled mesh steps at mesh (1, 1) over
NCCL, `MeshStep.replay_jit`: mesh_shmap at 1M particles over 6 scans,
mesh_shmap_surface (mega), mesh_tiled (city at 10 000), mesh_surface_sharded
(city), mesh_sharded (parity)) a process builds the kernels of its tree
(this one, or --root: an unpacked earlier commit), takes the engine's
captured replay, calls it once (warm-up and capture) and once warm,
then:

- peak device memory over those two calls (max_memory_allocated after
  reset_peak_memory_stats), less what was allocated before them, and the
  state's map bytes;
- device ms a scan: the device records of REPLAYS replays under
  torch.profiler, over their scans, and among them each F1-F8 kernel's
  (fusion_ms_a_scan; F3's, F7's and F7's mesh form's apart, the last
  F7's mesh passes, fusion_mesh_*); host ms a scan by CUDA events around
  the same number of replays (host loop included), and the same of
  EAGER_REPLAYS eager replays (the engine's `replay`, a Python loop of
  steps; after one warm-up);
- the graph of the first chunk's nodes by type (conditional nodes: the
  resample gates' IF nodes) and its kernel nodes a scan (a conditional
  node's body counted), and the scans whose gate fired (the infos'
  resampled);
- a digest of the final state, the stacked infos and the generator's next
  draw, which must be the same in every process of every tree (with
  --bits-change, in every process of each tree: where the trees' bits are
  meant to differ, each path's Neff, weighted poses and ATE of the two
  trees are set side by side instead);
- each scan's Neff and weighted pose, and the ATE against the log's ground
  truth (each robot's at multi).

The path `rebuild` is the pose-graph frontend's captured map rebuild
(models/frontend.MapRebuild) of the 216 scans of grand_tour_216.rec at
their dead-reckoned poses, 216 keyframes: after a first call (capture),
ms a rebuild by CUDA events around REBUILDS warm calls, and under
torch.profiler over REPLAYS calls the device ms, the host's launches
(kernels, copies, sets, graph launches) and the graph launches a rebuild;
a digest of the map.

The parent process runs the children in turns, ORDER (B = --root, A =
this tree: B A A B), prints the card's name and power limit, a JSON line a
child's path, then a summary line: each path's numbers of A and B side by
side, and whether every digest agreed.

Usage (needs a GPU; ~12 min for the default paths):
    python scripts/cond_ab.py --root DIR [--paths parity,pr1,...]
    python scripts/cond_ab.py --root DIR --paths mesh_shmap,...,rebuild
    python scripts/cond_ab.py --root DIR --bits-change
"""

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATHS = ("parity", "pr1", "chip", "mega", "city", "mega_bf16", "city_bf16",
         "mega_refine", "mega_blocked", "multi")
# the surface paths' configurations: the package's presets or
# chip_smoke.py's helpers
SURFACE = {"mega": "mega_config", "city": "city_config",
           "mega_bf16": "bf16_config", "city_bf16": "city_bf16_config",
           "mega_refine": "refine_config"}
MESH_PATHS = ("mesh_shmap", "mesh_shmap_surface", "mesh_tiled",
              "mesh_surface_sharded", "mesh_sharded")
ORDER = "BAAB"
REPLAYS = 5
EAGER_REPLAYS = 2
REBUILDS = 20
SEED = 0


def digest(*trees) -> str:
    import torch
    from gridmap_slam_tpu_torch.models.captured import leaves
    h = hashlib.sha256()
    for tree in trees:
        for x in leaves(tree):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def setup(name):
    """(engine, init, captured replay, stacked frames, scans, eager replay,
    ground truth) of a path, from the tree's own chip_smoke.py helpers; the
    eager replay takes (state, frames, generator); the ground truth is the
    log's poses, (scans, 3), or a list of them a robot."""
    import chip_smoke as cs
    import gridmap_slam_tpu_torch as port
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM
    from gridmap_slam_tpu_torch.io import frames_to_device
    from gridmap_slam_tpu_torch.models.captured import tree_map
    from gridmap_slam_tpu_torch.models.multi import stack_frames
    from gridmap_slam_tpu_torch.models.shared import matcher_block_size

    frames, gt = cs.parity_log()

    def stacked(cfg, n=None):
        b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
        return tree_map(lambda x: x[:n], b)

    if name.startswith("mesh_"):
        return (*mesh_setup(name[len("mesh_"):], frames, stacked), gt)
    if name == "multi":
        eng, ticks, starts, logs = cs.multi_setup(cs.MULTI_PARTICLES[-1])
        return (eng, lambda: eng.init(starts), eng.replay_jit(),
                stack_frames(ticks), len(ticks), eng.replay,
                [g for _, g in logs])
    if name in ("parity", "pr1", "chip"):
        cfg = {"parity": cs.parity_config(), "pr1": cs.pr1_config(),
               "chip": cs.parity_config().replace(
                   num_particles=cs.CHIP_PARTICLES,
                   particle_chunk=cs.CHIP_CHUNK)}[name]
        eng = RBPF(cfg, device="cuda")
        return (eng, eng.init, eng.replay_jit(), stacked(cfg), cs.N_SCANS,
                eng.replay, gt)
    if name in SURFACE:
        make = SURFACE[name]
        cfg = getattr(port if hasattr(port, make) else cs, make)()
        eng = SharedMapSLAM(cfg, device="cuda")
        return (eng, eng.init, eng.replay_surface_jit(),
                stacked(eng.config), cs.N_SCANS, eng.replay_surface, gt)
    cfg = cs.parity_config().replace(num_particles=cs.MEGA_PARTICLES,
                                     particle_chunk=0)
    eng = SharedMapSLAM(cfg, device="cuda")
    n = cs.CAPTURED_BLOCKED_SCANS
    block = matcher_block_size(cfg)
    return (eng, eng.init, eng.replay_jit(block=block), stacked(cfg, n), n,
            lambda s, f, g: eng.replay(s, f, g, block=block), gt)


def mesh_setup(kind, frames, stacked):
    """A compiled mesh step's replay_jit at mesh (1, 1) over NCCL, in the
    configurations of chip_smoke.py's parallel phase."""
    import chip_smoke as cs
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, city_config,
                                        mega_config)
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh
    from gridmap_slam_tpu_torch.parallel.sharded import (init_sharded,
                                                         make_sharded_step)
    from gridmap_slam_tpu_torch.parallel.shmap import (init_shmap,
                                                       make_shmap_step)
    from gridmap_slam_tpu_torch.parallel.surface_sharded import (
        init_surface_sharded, make_surface_sharded_step)
    from gridmap_slam_tpu_torch.parallel.tiled import (init_tiled,
                                                       make_tiled_step)

    pmesh.init_world("cuda")
    mesh = pmesh.make_mesh(1, device="cuda")
    n = cs.N_SCANS
    if kind == "shmap":
        cfg = cs.parity_config().replace(num_particles=cs.MEGA_PARTICLES,
                                         particle_chunk=0)
        eng, n = SharedMapSLAM(cfg, device="cuda"), cs.PAR_SHMAP_SCANS
        step, init = make_shmap_step(eng, mesh, jit=True), init_shmap
    elif kind == "shmap_surface":
        eng = SharedMapSLAM(mega_config(), device="cuda")
        step, init = make_shmap_step(eng, mesh, True, jit=True), init_shmap
    elif kind == "tiled":
        cfg = city_config().replace(num_particles=cs.PAR_TILED_PARTICLES,
                                    particle_chunk=cs.PAR_TILED_CHUNK)
        eng = SharedMapSLAM(cfg, device="cuda")
        step, init = make_tiled_step(eng, mesh, jit=True), init_tiled
    elif kind == "surface_sharded":
        eng = SharedMapSLAM(city_config(), device="cuda")
        step = make_surface_sharded_step(eng, mesh, jit=True)
        init = init_surface_sharded
    else:
        eng = RBPF(cs.parity_config(), device="cuda")
        step, init = make_sharded_step(eng, mesh, jit=True), init_sharded
    return (eng, lambda: init(eng, mesh), step.replay_jit(),
            stacked(eng.config, n), min(n, len(frames)), step.replay)


def rebuild_child() -> dict:
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gridmap_slam_tpu_torch import FrontendConfig, PoseGraphSLAM
    from gridmap_slam_tpu_torch.io import (frame_at, frames_to_device,
                                           read_recording)
    from gridmap_slam_tpu_torch.ops.geometry import deskew_scan
    from gridmap_slam_tpu_torch.ops.motion import apply_odometry

    frames = read_recording(cs.GRAND_TOUR)
    cfg = cs.grand_tour_config(200)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    fe = PoseGraphSLAM(cfg, FrontendConfig(), device="cuda")
    pose, poses, scans = torch.zeros(3, device="cuda"), [], []
    for i in range(len(frames)):
        f = frame_at(batch, i)
        pose = apply_odometry(pose, f.odom)
        poses.append(pose.cpu().numpy())
        scans.append(deskew_scan(f.scan, f.odom))
    fe.kf_scans, fe.kf_poses = scans, poses
    fe.rebuild_map()                            # capture
    out = fe.rebuild_map()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REBUILDS):
        fe.rebuild_map()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPLAYS):
            fe.rebuild_map()
        torch.cuda.synchronize()
    events = prof.events()
    dev_us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dict(path="rebuild", keyframes=len(scans),
                ms_a_rebuild=start.elapsed_time(end) / REBUILDS,
                device_ms_a_rebuild=dev_us / 1e3 / REPLAYS,
                host_launches_a_rebuild=sum(
                    e.name in cs.LAUNCH_CALLS for e in events) / REPLAYS,
                graph_launches_a_rebuild=sum(
                    e.name.startswith("cudaGraphLaunch")
                    for e in events) / REPLAYS,
                captures=fe.rebuilder.captures,
                digest=digest([out]))


def child(name: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gridmap_slam_tpu_torch.models import captured

    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    eng, init, replay, frames, n, eager, gt = setup(name)

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s0, g = init(), gen()
    replay(s0, frames, g)                       # warm-up and capture
    s0, g = init(), gen()
    st, infos = replay(s0, frames, g)
    nxt = torch.randn(8, generator=g, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    cap = replay.captured
    nodes = captured.graph_node_types(cap.graph.raw_cuda_graph())
    kernel_nodes = len(captured.graph_kernel_names(
        cap.graph.raw_cuda_graph()))
    s0, g = init(), gen()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPLAYS):
            replay(s0, frames, g)
        torch.cuda.synchronize()
    records = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in records)
    fusion_us = {}
    for e in records:
        m = re.search(r"fusion_(\w+?)_kernel", e.name)
        if m:
            fusion_us[m.group(1)] = (fusion_us.get(m.group(1), 0.0)
                                     + e.time_range.elapsed_us())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPLAYS):
        replay(s0, frames, g)
    end.record()
    torch.cuda.synchronize()
    host_ms = start.elapsed_time(end) / (REPLAYS * n)
    s0, g = init(), gen()
    eager(s0, frames, g)                        # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(EAGER_REPLAYS):
        s0, g = init(), gen()
        eager(s0, frames, g)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / (EAGER_REPLAYS * n)
    map_bytes = st.logodds.numel() * st.logodds.element_size()
    traj = infos.weighted_pose.cpu().numpy()
    ate = ([ate_rmse(traj, gt[:n])] if traj.ndim == 2 else
           [ate_rmse(traj[:, r], g[:n]) for r, g in enumerate(gt)])
    return dict(path=name, scans=n, particles=eng.config.num_particles,
                device_ms_a_scan=dev_us / 1e3 / (REPLAYS * n),
                fusion_ms_a_scan={k: v / 1e3 / (REPLAYS * n)
                                  for k, v in sorted(fusion_us.items())},
                f3_ms_a_scan=fusion_us.get("pick", 0.0) / 1e3 / (REPLAYS * n),
                f7_ms_a_scan=sum(v for k, v in fusion_us.items()
                                 if k.startswith("weights")) / 1e3
                / (REPLAYS * n),
                f7_mesh_ms_a_scan=sum(v for k, v in fusion_us.items()
                                      if k.startswith("mesh")) / 1e3
                / (REPLAYS * n),
                host_ms_a_scan=host_ms, scans_per_sec=1e3 / host_ms,
                eager_ms_a_scan=eager_ms, eager_scans_per_sec=1e3 / eager_ms,
                peak_bytes=peak, map_bytes=map_bytes,
                peak_over_map_bytes=peak / map_bytes,
                graph_scans=cap.scans, nodes_by_type=nodes,
                kernel_nodes_a_scan=kernel_nodes / cap.scans,
                fired=int(infos.resampled.sum()),
                gated=int(infos.resampled.numel()),
                neff=infos.neff.cpu().tolist(), weighted_pose=traj.tolist(),
                ate_m=ate, digest=digest(st, infos, nxt))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="an unpacked earlier commit (B)")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--bits-change", action="store_true",
                    help="the trees' bits are meant to differ: digests must "
                         "agree within each tree, and Neff, the weighted "
                         "poses and ATE are compared across them")
    ap.add_argument("--child", action="store_true",
                    help="run the paths in this process, on --root's tree")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if args.child:
        tree = Path(args.root or ROOT).resolve()
        sys.path.insert(0, str(tree))
        import torch
        if not torch.cuda.is_available():
            sys.exit("cond_ab: no CUDA device")
        from gridmap_slam_tpu_torch.ops.cuda import _build
        _build.library()
        for name in paths:
            row = rebuild_child() if name == "rebuild" else child(name)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
        return
    if not args.root:
        sys.exit("cond_ab: --root DIR (the earlier commit) is needed")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rows = {"A": {}, "B": {}}
    for turn, side in enumerate(ORDER):
        root = ROOT if side == "A" else Path(args.root).resolve()
        proc = subprocess.run(
            [sys.executable, __file__, "--child", "--root", str(root),
             "--paths", args.paths], cwd=root, capture_output=True,
            text=True)
        if proc.returncode:
            sys.exit(f"cond_ab: {side} failed:\n{proc.stdout}{proc.stderr}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = dict(json.loads(line), side=side, turn=turn)
                print(json.dumps(row), flush=True)
                rows[side].setdefault(row["path"], []).append(row)
    keys = ("device_ms_a_scan", "f3_ms_a_scan", "f7_ms_a_scan",
            "f7_mesh_ms_a_scan",
            "host_ms_a_scan", "scans_per_sec",
            "eager_scans_per_sec", "kernel_nodes_a_scan", "peak_bytes",
            "peak_over_map_bytes", "ms_a_rebuild", "device_ms_a_rebuild",
            "host_launches_a_rebuild", "graph_launches_a_rebuild")
    summary = {name: {side: {k: [r[k] for r in rows[side][name]]
                             for k in keys if k in rows[side][name][0]}
                      for side in "AB"} for name in paths}
    digests = {name: sorted({r["digest"] for s in "AB"
                             for r in rows[s][name]}) for name in paths}
    same = all(len(d) == 1 for d in digests.values())
    each = all(len({r["digest"] for r in rows[s][name]}) == 1
               for name in paths for s in "AB")
    apart = {name: across(rows["A"][name][0], rows["B"][name][0])
             for name in paths if name != "rebuild"}
    print(json.dumps(dict(summary=summary, digests=digests, bits_equal=same,
                          bits_equal_within_each_tree=each,
                          a_against_b=apart)), flush=True)
    sys.exit(0 if (each and args.bits_change) or same else 1)


def across(a: dict, b: dict) -> dict:
    """How far apart two trees' runs of a path are: the largest relative
    difference of a scan's Neff, the largest of a weighted pose's
    coordinates (m, and rad for theta), and both ATEs."""
    import numpy as np
    na, nb = np.asarray(a["neff"]), np.asarray(b["neff"])
    pa, pb = np.asarray(a["weighted_pose"]), np.asarray(b["weighted_pose"])
    return dict(neff_max_rel_diff=float((np.abs(na - nb) / nb).max()),
                weighted_pose_max_diff=float(np.abs(pa - pb).max()),
                ate_m={"A": a["ate_m"], "B": b["ate_m"]},
                fired={"A": a["fired"], "B": b["fired"]})


if __name__ == "__main__":
    main()
