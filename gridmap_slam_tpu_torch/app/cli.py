"""Command-line application: replay, live SLAM, synthetic data generation,
pose graph.

The PyTorch counterpart of gridmap_slam_tpu/app/cli.py (the reference's
desktop app shell, core/Main2 + app/GridMapApp): wires a data source
(recording, synthetic world, or live robot link) into the SLAM engine and
emits maps/trajectories/metrics — headless PNG + JSON instead of an OpenGL
window.  The engine runs on the card unless `--device cpu` is given; one
torch.Generator on the engine's device, seeded by `--seed`, feeds every
step of a run.  Each scan is one replay of the engine's step captured as a
CUDA graph (`step_jit`, the counterpart of the JAX CLI's `jax.jit(eng.
step)`; on the CPU the same static-buffer step), with the eager run's
bits; so do the distributed engines (shmap, shmap-surface, tiled,
surface-sharded), their compiled steps one graph each with the NCCL
collectives inside it.

Usage:
  python -m gridmap_slam_tpu_torch.app.cli replay --log maps/room_loop_40.rec \\
      --particles 500 --chunk 250 --max-beams 192 --out out/
  python -m gridmap_slam_tpu_torch.app.cli synth --revs 40 --out out/ --save-log r.rec
  python -m gridmap_slam_tpu_torch.app.cli posegraph --log maps/grand_tour_216.rec \\
      --particles 200 --map-size 14
  python -m gridmap_slam_tpu_torch.app.cli live --host esp32robot.local --scans 30
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

import numpy as np

MESH_ENGINES = ("shmap", "shmap-surface", "tiled", "surface-sharded")


class _MeshEngine:
    """A distributed engine behind the single-device interface that
    _run_frames consumes (.config, .device, .taps, .init, .init_from_map,
    .step, .step_jit); `gather` gives the global state on every rank and
    `base` the single-device engine that renders it.  make(jit) builds the
    engine's step (parallel/shmap.MeshStep): eager, or compiled."""

    def __init__(self, base, mesh, make, tiled: bool):
        self.base, self.config = base, base.config
        self.device, self.taps = base.device, base.taps
        self._make = make
        self.step = make(False)
        self._mesh, self._tiled = mesh, tiled

    def step_jit(self):
        """The compiled step (the engine's make_*_step(..., jit=True))."""
        return self._make(True)

    def init(self):
        from ..parallel.mesh import shard_state
        return shard_state(self.base.init(), self._mesh, self._tiled,
                           device=self.device)

    def init_from_map(self, logodds):
        from ..parallel.mesh import shard_state
        return shard_state(self.base.init_from_map(logodds), self._mesh,
                           self._tiled, device=self.device)

    def gather(self, state):
        from ..parallel.mesh import gather_state
        return gather_state(state, self._mesh, self._tiled)


def _mesh_engine(args, cfg, engine: str):
    """The distributed engine `engine` on the world's mesh: a world of one
    unless a launcher started the ranks.  Exits non-zero where --devices
    is not the world's size or --map-shards does not divide it."""
    import torch.distributed as dist
    from ..models.shared import SharedMapSLAM
    from ..parallel import mesh as pmesh

    pmesh.init_world(args.device)
    n = dist.get_world_size()
    if args.devices and args.devices != n:
        sys.exit(f"--devices {args.devices} needs a world of {args.devices} "
                 f"ranks, one a card; this world has {n} (start the ranks "
                 f"with a launcher, e.g. torchrun --nproc-per-node "
                 f"{args.devices})")
    tiled = engine in ("tiled", "surface-sharded")
    if not tiled and args.map_shards != 1:
        sys.exit(f"--engine {engine} replicates the map: --map-shards must "
                 f"be 1, got {args.map_shards} (tiled and surface-sharded "
                 f"split the map)")
    if args.map_shards < 1 or n % args.map_shards:
        sys.exit(f"--map-shards {args.map_shards} does not divide the world "
                 f"of {n} ranks")
    if getattr(args, "view", False) and n > 1:
        sys.exit("--view draws rank 0's view; run it on a world of one")
    base = SharedMapSLAM(cfg, device=args.device)
    mesh = pmesh.make_mesh(n, map_shards=args.map_shards, device=args.device)
    if engine == "tiled":
        from ..parallel.tiled import make_tiled_step
        make = functools.partial(make_tiled_step, base, mesh)
    elif engine == "surface-sharded":
        from ..parallel.surface_sharded import make_surface_sharded_step
        make = functools.partial(make_surface_sharded_step, base, mesh)
    else:
        from ..parallel.shmap import make_shmap_step
        make = functools.partial(make_shmap_step, base, mesh,
                                 engine == "shmap-surface")
    return _MeshEngine(base, mesh, make, tiled)


def _engine(args):
    from .. import RBPF, SlamConfig
    from ..config import MapConfig

    engine = getattr(args, "engine", "rbpf")
    if engine not in MESH_ENGINES and (args.map_shards != 1 or args.devices):
        sys.exit("--devices and --map-shards set the mesh of a distributed "
                 f"engine; the {engine} engine runs on one device "
                 "(--device)")
    cfg = SlamConfig(
        num_particles=args.particles,
        max_beams=args.max_beams,
        particle_chunk=args.chunk,
        map=MapConfig(width_m=args.map_size, height_m=args.map_size,
                      resolution=args.resolution,
                      origin=(-args.map_size / 2, -args.map_size / 2)),
    )
    if getattr(args, "set", None):
        cfg = cfg.with_overrides(SlamConfig.parse_overrides(args.set))
    if engine in MESH_ENGINES:
        eng = _mesh_engine(args, cfg, engine)
    elif engine in ("shared", "surface"):
        from ..models.shared import SharedMapSLAM
        eng = SharedMapSLAM(cfg, device=args.device)
        if engine == "surface":
            # route the generic step() through the surface-volume update
            eng.step = eng.step_surface
    else:
        eng = RBPF(cfg, device=args.device)
    return cfg, eng, eng.init()


def _host_scan(scan):
    """A Scan's tensors on the host, for the views and the PNG overlay."""
    from ..types import Scan
    return Scan(scan.angle.cpu(), scan.dist.cpu(), scan.hit.cpu(),
                scan.valid.cpu())


def _overlay(frame, traj, dev):
    """The deskewed scan of the frame whose estimate is traj[-1], and its
    raw (uncorrected) pose: the previous estimate advanced by odometry
    alone, the reference's blue scan overlay baseline
    (app/GridMapApp.java:396-412).  Taken only where they are read: the
    live view, and the last scan for the final map."""
    import torch
    from ..ops.cuda.fusions import deskew
    from ..ops.motion import apply_odometry

    prev = traj[-2] if len(traj) > 1 else np.zeros(3)
    raw = apply_odometry(torch.as_tensor(prev, dtype=torch.float32,
                                         device=dev), frame.odom)
    return deskew(frame.scan, frame.odom), raw.cpu().numpy()


def _run_frames(cfg, eng, state, frames, out_dir: Path, gt=None,
                label: str = "replay", live_view=None,
                map_view: str = "occupancy", map_select: str = "best",
                save_map=None, seed: int = 0):
    import torch
    from ..io import frames_to_device, frame_at
    from ..utils.metrics import ScanTimer, ate_rmse

    from .application import compiled_step

    dev = eng.device
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    on_card = dev.type == "cuda"
    step = compiled_step(eng)
    traj = []
    neffs = []
    timer = ScanTimer()
    last_scan = last_raw = None
    for i in range(len(frames)):
        frame = frame_at(batch, i)
        with timer:
            # the state returned is the capture's buffer: every read of it
            # comes before the next call
            state, info = step(state, frame, generator)
            if on_card:         # else the timer measures the launches
                torch.cuda.synchronize(dev)
        traj.append(info.weighted_pose.cpu().numpy())
        neffs.append(float(info.neff))
        if live_view is not None:
            last_scan, last_raw = _overlay(frame, traj, dev)
            live_view.update(eng.best_map(state).cpu().numpy(), traj[-1],
                             state.poses.cpu().numpy(), neffs[-1],
                             scan=_host_scan(last_scan), raw_pose=last_raw)
    if live_view is not None:
        live_view.finish()
    elif traj:
        last_scan, last_raw = _overlay(frame_at(batch, len(traj) - 1), traj,
                                       dev)
    traj = np.stack(traj)
    if isinstance(eng, _MeshEngine):
        # every rank gathers the global state; rank 0 alone writes
        import torch.distributed as dist
        eng, state = eng.base, eng.gather(state)
        if dist.get_rank() != 0:
            return state, traj, {"frames": len(frames)}

    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = {
        "frames": len(frames),
        "mean_scan_ms": timer.mean_ms,
        "scans_per_sec": timer.scans_per_sec(),
        "final_neff": neffs[-1] if neffs else None,
        "final_pose": traj[-1].tolist() if len(traj) else None,
    }
    if gt is not None:
        metrics["ate_rmse_m"] = ate_rmse(traj, gt)
    np.save(out_dir / f"{label}_trajectory.npy", traj)

    _dump_maps(cfg, eng, state, out_dir, label, traj, gt,
               map_view=map_view, map_select=map_select,
               scan=None if last_scan is None else _host_scan(last_scan),
               raw_pose=last_raw)
    if save_map:
        from ..io import write_map_checkpoint
        write_map_checkpoint(
            save_map,
            {"width_m": cfg.map.width_m, "height_m": cfg.map.height_m,
             "resolution": cfg.map.resolution, "origin": cfg.map.origin},
            eng.best_map(state).cpu().numpy().astype(np.float64))
        print(f"map checkpoint -> {save_map}", file=sys.stderr)
    (out_dir / f"{label}_metrics.json").write_text(json.dumps(metrics,
                                                              indent=2))
    print(json.dumps(metrics))
    return state, traj, metrics


def _dump_maps(cfg, eng, state, out_dir: Path, label: str, traj, gt,
               map_view: str = "occupancy", map_select: str = "best",
               scan=None, raw_pose=None):
    """Final map artifact(s) — the reference's map-type (occupancy /
    likelihood) and map-select (strongest / combined) views
    (app/GridMapApp.java:246-320)."""
    import torch
    from ..utils.viz import render_likelihood, render_map

    if map_select == "combined" and hasattr(eng, "combined_occupancy"):
        p = eng.combined_occupancy(state).cpu().numpy()
        m = np.log(np.clip(p, 1e-6, 1 - 1e-6) /
                   np.clip(1 - p, 1e-6, 1.0))     # back to log-odds for viz
    elif map_select not in ("best", "combined"):
        # specific-particle view (reference map-select "specific",
        # app/GridMapApp.java:246-320); rbpf engine only.
        try:
            i = int(map_select)
        except ValueError:
            sys.exit(f"--map-select must be 'best', 'combined', or a "
                     f"particle index; got {map_select!r}")
        if state.logodds.ndim != 3:
            sys.exit("--map-select <index> requires the rbpf engine "
                     "(per-particle maps)")
        if not (0 <= i < state.logodds.shape[0]):
            sys.exit(f"--map-select {i} out of range "
                     f"(0..{state.logodds.shape[0] - 1})")
        m = state.logodds[i].cpu().numpy()
    else:
        m = eng.best_map(state).cpu().numpy()
    render_map(m, out_dir / f"{label}_map.png", trajectory=traj,
               ground_truth=gt, particles=state.poses.cpu().numpy(),
               origin=cfg.map.origin, resolution=cfg.map.resolution,
               title=f"{label}: {len(traj)} scans ({map_select})",
               scan=scan, scan_pose=traj[-1] if len(traj) else None,
               raw_pose=raw_pose)
    if map_view == "likelihood":
        # the blurred occupancy (ops/grid.likelihood_field), not the log of
        # the mixture that the likelihood-field kernel builds for matching
        from ..ops.grid import likelihood_field
        field, _ = likelihood_field(
            torch.as_tensor(m, dtype=torch.float32, device=eng.device),
            eng.taps)
        render_likelihood(field.cpu().numpy(),
                          out_dir / f"{label}_likelihood.png",
                          origin=cfg.map.origin,
                          resolution=cfg.map.resolution)


def _make_view(args, cfg):
    if not getattr(args, "view", False):
        return None
    from ..utils.liveview import TerminalMapView
    return TerminalMapView(cfg.map.origin, cfg.map.resolution, force=True)


def cmd_replay(args):
    from ..io import read_recording

    frames = read_recording(args.log)
    cfg, eng, state = _engine(args)
    if args.load_map:
        # Start every particle from a previously-built map checkpoint
        # (reference GridMapLoader, slam/GridMapLoader.java:105-135):
        # localization-in-known-map / checkpoint-resume mapping.
        from ..io import read_map_checkpoint
        params, logodds = read_map_checkpoint(args.load_map)
        # A checkpoint with different geometry but coincidentally matching
        # cell counts would load silently and misalign all localization —
        # validate every geometry param against the engine config.
        mismatches = [
            (name, have, want)
            for name, have, want in [
                ("resolution", params["resolution"], cfg.map.resolution),
                ("width_m", params["width_m"], cfg.map.width_m),
                ("height_m", params["height_m"], cfg.map.height_m),
                ("origin_x", params["origin"][0], cfg.map.origin[0]),
                ("origin_y", params["origin"][1], cfg.map.origin[1]),
            ] if abs(have - want) > 1e-5
        ]
        if mismatches:
            detail = ", ".join(f"{n}: checkpoint={h:g} config={w:g}"
                               for n, h, w in mismatches)
            sys.exit(f"--load-map geometry mismatch ({detail}); rerun with "
                     f"--map-size/--resolution matching the checkpoint")
        state = eng.init_from_map(logodds)
        print(f"loaded map checkpoint {args.load_map} {logodds.shape}",
              file=sys.stderr)
    return _run_frames(cfg, eng, state, frames, Path(args.out),
                       label="replay", live_view=_make_view(args, cfg),
                       map_view=args.map_view, map_select=args.map_select,
                       save_map=args.save_map, seed=args.seed)


def cmd_synth(args):
    from ..io import write_recording
    from ..io.synthetic import (SimParams, default_world, multi_room_world,
                                simulate_log, square_path_controls)

    world = (multi_room_world() if args.world == "multi_room"
             else default_world())
    params = SimParams(beams_per_rev=args.beams)
    frames, gt = simulate_log(world, square_path_controls(args.revs),
                              params=params, seed=args.seed)
    if args.save_log:
        write_recording(args.save_log, frames)
        print(f"wrote {args.save_log}", file=sys.stderr)
    cfg, eng, state = _engine(args)
    return _run_frames(cfg, eng, state, frames, Path(args.out), gt=gt,
                       label="synth", live_view=_make_view(args, cfg),
                       map_view=args.map_view, map_select=args.map_select,
                       seed=args.seed)


def cmd_live(args):
    """Live operation: SLAM runs ON EACH FRAME as it arrives (the reference
    processes one TimeFrame per render frame, app/GridMapApp.java:215-217),
    with an in-terminal map/pose/particle view and optional recording."""
    from .application import SlamApplication
    from .pipeline import RobotLink, SlamPipeline
    from .recorder import DataRecorder

    cfg, eng, state = _engine(args)
    if args.serial:
        link = RobotLink.connect_serial(args.serial, args.baud)
    else:
        link = RobotLink.connect(args.host, args.port)
    link.set_resolution(args.degrees)
    link.sensor_enable()
    pipe = SlamPipeline(link)
    collected = []
    # The reference IApplication lifecycle (app/application.py): one SLAM
    # update per arriving frame + a view refresh per tick.
    app = SlamApplication(cfg, eng, view=_make_view(args, cfg))
    app.init(seed=args.seed, state=state)

    def on_frame(f):
        collected.append(f)
        app.on_frame(f)
        app.render()

    pipe.subscribe(on_frame)
    rec = DataRecorder(lambda f: None, directory=args.out)
    if args.record:
        rec.begin_record()
        pipe.subscribe(rec.on_frame)
    pipe.start()
    t0 = time.monotonic()
    teleop = keys = None
    if args.teleop:
        # Operator drive loop (reference teleop panel,
        # conn/ConnectionManager.java:143-215): WASD/arrows -> wheel-speed
        # refs via command 0x10; space stops, q ends the session early.
        from .teleop import StdinKeys, TeleopController
        teleop = TeleopController(link.set_speeds, speed=args.speed)
        keys = StdinKeys()
        keys.__enter__()
        print("teleop: WASD/arrows drive, space stops, +/- trims speed, "
              "q quits", file=sys.stderr)
    try:
        while len(collected) < args.scans:
            pipe.handle_events(4)     # subscribers run on THIS thread
            rec.update(time.monotonic() - t0 - rec.current_time)
            if teleop is not None:
                for k in keys.poll():
                    if not teleop.handle(k):
                        raise KeyboardInterrupt
            time.sleep(0.01)
    except KeyboardInterrupt:
        pass
    finally:
        if teleop is not None:
            teleop.stop()
            keys.__exit__(None, None, None)
        app.dispose()
        link.sensor_disable()
        pipe.stop()
        link.close()
    if args.record:
        path = rec.save(args.record)
        print(f"recorded {len(rec.frames)} frames -> {path}", file=sys.stderr)

    # final artifacts (map PNG, metrics) for the session just run
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from ..utils.viz import render_map
    tr = app.trajectory_array()
    np.save(out_dir / "live_trajectory.npy", tr)
    render_map(app.occupancy(), out_dir / "live_map.png",
               trajectory=tr, particles=app.state.poses.cpu().numpy(),
               origin=cfg.map.origin, resolution=cfg.map.resolution,
               title=f"live: {len(collected)} scans")
    print(json.dumps({"frames": len(collected),
                      "final_pose": tr[-1].tolist() if len(tr) else None}))


def cmd_posegraph(args):
    """SLAM a log, promote keyframes, close loops, optimize, rebuild —
    emits both the online map and the loop-corrected map."""
    from ..io import read_recording, frames_to_device, frame_at
    from ..io.synthetic import (SimParams, default_world, simulate_log,
                                square_path_controls)
    from ..models.frontend import FrontendConfig, PoseGraphSLAM
    from ..ops.cuda.fusions import deskew
    from ..utils.viz import render_map

    if args.log:
        frames = read_recording(args.log)
        gt = None
    else:
        frames, gt = simulate_log(default_world(),
                                  square_path_controls(args.revs),
                                  params=SimParams(beams_per_rev=args.beams),
                                  seed=args.seed)
    cfg, eng, state = _engine(args)
    out_dir = Path(args.out)
    state, traj, metrics = _run_frames(cfg, eng, state, frames, out_dir,
                                       gt=gt, label="pg_online",
                                       seed=args.seed)

    fe = PoseGraphSLAM(cfg, FrontendConfig(), device=eng.device)
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device=eng.device)
    for i, pose in enumerate(traj):
        f = frame_at(batch, i)
        fe.add(pose, deskew(f.scan, f.odom))
    n_closures = fe.detect_closures()
    opt, chi2 = fe.optimize()
    rebuilt = fe.rebuild_map()
    render_map(rebuilt.cpu().numpy(), out_dir / "pg_optimized_map.png",
               trajectory=opt, ground_truth=gt, origin=cfg.map.origin,
               resolution=cfg.map.resolution,
               title=f"pose-graph: {fe.num_keyframes} keyframes, "
                     f"{n_closures} closures")
    summary = {"keyframes": fe.num_keyframes, "closures": n_closures,
               "chi2_first": float(chi2[0]), "chi2_last": float(chi2[-1])}
    if gt is not None:
        summary["online_ate_m"] = metrics.get("ate_rmse_m")
    print(json.dumps(summary))
    return summary


def main(argv=None):
    """Parse `argv` and run the command.  replay and synth return
    _run_frames' (state, trajectory, metrics), posegraph its summary."""
    ap = argparse.ArgumentParser(prog="gridmap_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--particles", type=int, default=100)
        p.add_argument("--engine",
                       choices=["rbpf", "shared", "surface", *MESH_ENGINES],
                       default="rbpf",
                       help="rbpf: per-particle maps (reference parity); "
                            "shared: single shared map, 16 B/particle; "
                            "surface: shared map + per-scan likelihood "
                            "volume (~8 taps/particle — the 1M mode); "
                            "shmap/shmap-surface/tiled/surface-sharded: "
                            "the distributed engines (a world of one "
                            "unless a launcher started the ranks)")
        p.add_argument("--device", default="cuda",
                       help="device the engine runs on: cuda (the default; "
                            "raises when there is no CUDA device) or cpu")
        p.add_argument("--devices", type=int, default=0,
                       help="ranks in the mesh, one a card: must be the "
                            "world's size (0 = the world's size; "
                            "distributed engines only)")
        p.add_argument("--map-shards", type=int, default=1,
                       help="map-column shards 'm' for tiled / "
                            "surface-sharded (must divide the world's "
                            "size; 1 for shmap and shmap-surface)")
        p.add_argument("--max-beams", type=int, default=360)
        p.add_argument("--chunk", type=int, default=0)
        p.add_argument("--map-size", type=float, default=6.0)
        p.add_argument("--resolution", type=float, default=0.05)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--out", default="out")
        p.add_argument("--set", action="append", default=[],
                       metavar="KEY=VALUE",
                       help="config override, e.g. --set matcher.z_hit=0.95")
        p.add_argument("--view", action="store_true",
                       help="live terminal map view while processing "
                            "(reference GridMapApp render loop equivalent)")
        p.add_argument("--map-view", choices=["occupancy", "likelihood"],
                       default="occupancy",
                       help="also dump the likelihood-field view "
                            "(reference map-type selector)")
        p.add_argument("--map-select", default="best", metavar="WHICH",
                       help="'best' (strongest particle), 'combined' "
                            "(cell-wise 1 - prod(1-p_i)), or a particle "
                            "index for that specific particle's map "
                            "(reference map-select, GridMapApp.java:246-320)")

    p = sub.add_parser("replay", help="replay a recording file")
    common(p)
    p.add_argument("--log", required=True)
    p.add_argument("--save-map", default=None,
                   help="write the strongest particle's map as a reference-"
                        "format map checkpoint after the run")
    p.add_argument("--load-map", default=None,
                   help="initialize all particles from a map checkpoint "
                        "(localization in a known map)")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("synth", help="synthetic world run")
    common(p)
    p.add_argument("--revs", type=int, default=40)
    p.add_argument("--beams", type=int, default=180)
    p.add_argument("--world", choices=["default", "multi_room"],
                   default="default")
    p.add_argument("--save-log", default=None)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("posegraph",
                       help="SLAM + keyframes + loop closure + optimize")
    common(p)
    p.add_argument("--log", default=None,
                   help="recording to process (default: synthetic loop)")
    p.add_argument("--revs", type=int, default=40)
    p.add_argument("--beams", type=int, default=180)
    p.set_defaults(fn=cmd_posegraph)

    p = sub.add_parser("live", help="connect to a robot (or loopback sim)")
    common(p)
    p.add_argument("--host", default="esp32robot.local")
    p.add_argument("--port", type=int, default=5555)
    p.add_argument("--serial", default=None, metavar="PORT",
                   help="use a serial port instead of TCP "
                        "(e.g. /dev/ttyUSB0)")
    p.add_argument("--baud", type=int, default=115200)
    p.add_argument("--degrees", type=int, default=2)
    p.add_argument("--scans", type=int, default=20)
    p.add_argument("--record", default=None,
                   help="also save the received frames under this name")
    p.add_argument("--teleop", action="store_true",
                   help="interactive keyboard drive (WASD/arrows; the "
                        "reference's ImGui teleop panel equivalent)")
    p.add_argument("--speed", type=float, default=5.0,
                   help="teleop wheel-speed magnitude, rad/s")
    p.set_defaults(fn=cmd_live)

    args = ap.parse_args(argv)
    # Fail invalid --map-select at PARSE time, not after a full replay:
    # a specific-particle index needs per-particle maps (rbpf engine), and
    # the index must parse as an int (range check still happens against the
    # live state in _dump_maps).
    ms = getattr(args, "map_select", "best")
    if ms not in ("best", "combined"):
        try:
            int(ms)
        except ValueError:
            ap.error(f"--map-select must be 'best', 'combined', or a "
                     f"particle index; got {ms!r}")
        if getattr(args, "engine", "rbpf") != "rbpf":
            ap.error("--map-select <index> requires --engine rbpf "
                     "(per-particle maps); shared/surface engines keep one "
                     "shared map")
    return args.fn(args)


if __name__ == "__main__":
    main()
