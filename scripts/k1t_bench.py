"""Time K1's tile variant (K1t) on one NVIDIA GPU, on the calls of a tiled
step.

Times `stage_scores_tile_cuda` of the package found under --root (default:
this checkout; point it at an unpacked earlier commit to time that
commit's K1t on the same inputs) at three cases, each a chunk's three
stages (coarse at full resolution over every 4th beam, fine, refine):

- "tiled step": the calls one scan of the tiled engine makes at the
  `parallel_path` row's shapes (chip_smoke.py: the city map, 4000 x 4000
  at 5 cm, 10 000 particles in chunks of 500, mesh (1, 1) over NCCL), 20
  chunks x 3 stages, recorded from the eager step after `--warm` scans of
  chip_smoke.parity_log();
- "one pose": the first chunk's calls with its 500 particles all at the
  chunk's first pose (the shapes of chip_smoke's `k1_tile` timing row);
- "spread poses": the first chunk's calls with the 500 particles spread
  over the city map from a seed, so that a block's pairs reach further
  than the box its shared memory holds.

The run that finds no file at --inputs records the calls with this
checkout's package (run it without --root) and saves them there with
each call's bound (chip_smoke.k1t_bound: the used beams' samples at 16
operations, the field's cells the taps read); every later run reads them,
so two runs (two --root) time the same tensors.

Prints the card's name and power limit, nvcc's -Xptxas -v report for
K1t's instantiations, then one JSON line a case, for each stage: ms a call
twice (CUDA events around back-to-back calls from Python, and device time
inside a CUDA graph of the calls: the launches' host time left out), the
bound and the share of it, a digest of the scores' bits, the largest
difference from the plain version on the first chunk, and, where the
wrapper takes `paths`, the blocks that staged their box and those that
read the field.  Then, with --scans N, the package's compiled tiled step
(jit=True, one CUDA graph a scan): device ms a scan by kernel row and
K1t's by stage (torch.profiler over a warm run of N scans), scans/s by
CUDA events.  To compare two commits, run them in turns on one card: A,
B, B, A.

Usage: python scripts/k1t_bench.py --inputs FILE [--root DIR] [--warm N]
       [--scans N] [--reps N]
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("coarse", "fine", "refine")
SPREAD_SEED = 11


def _say(case: str, **fields) -> None:
    print(json.dumps({"case": case, **fields}), flush=True)


def _ptxas(smoke) -> None:
    """Registers, shared memory and spills of K1t's instantiations."""
    from gridmap_slam_tpu_torch.ops.cuda import _build
    path, log = _build.build(verbose=True)
    rows = [dict(kernel=name, **use)
            for name, use in sorted(_build.ptxas_usage(log).items())
            if smoke.K1_TILE_SYMBOL.search(name)]
    _say("ptxas", library=path.name, instantiations=rows)


def _engine(smoke):
    """The tiled row's engine, mesh (1, 1), and the log's frames on the
    card."""
    from gridmap_slam_tpu_torch import SharedMapSLAM, city_config
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(1, device="cuda")
    cfg = city_config().replace(num_particles=smoke.PAR_TILED_PARTICLES,
                                particle_chunk=smoke.PAR_TILED_CHUNK)
    eng = SharedMapSLAM(cfg, device="cuda")
    frames, _ = smoke.parity_log()
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    return eng, mesh, [frame_at(batch, i) for i in range(len(frames))]


def _record(smoke, warm):
    """The K1t calls of scan `warm` of the eager tiled step, their
    arguments cloned (the field once), and the derived cases."""
    import numpy as np
    import torch
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    from gridmap_slam_tpu_torch.parallel.tiled import (init_tiled,
                                                       make_tiled_step)

    eng, mesh, seq = _engine(smoke)
    step = make_tiled_step(eng, mesh)
    st = init_tiled(eng, mesh)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    for f in seq[:warm]:
        st, _ = step(st, f, gen)
    real, calls, fields = kmatch.stage_scores_tile_cuda, [], {}

    def record(field, *args, **kw):
        key = field.data_ptr()
        if key not in fields:
            fields[key] = field.clone()
        calls.append(((fields[key], *(a.clone() for a in args)), dict(kw)))
        return real(field, *args, **kw)

    kmatch.stage_scores_tile_cuda = record
    try:
        step(st, seq[warm], gen)
        torch.cuda.synchronize()
    finally:
        kmatch.stage_scores_tile_cuda = real
    if len(calls) % 3:
        raise AssertionError(f"{len(calls)} K1t calls a scan")
    cfg = eng.config
    rng = np.random.default_rng(SPREAD_SEED)
    one, spread = [], []
    for args, kw in calls[:3]:
        pose0 = args[4]
        p = pose0.shape[0]
        one.append(((*args[:4], pose0[:1].expand(p, -1).contiguous(),
                     *args[5:]), kw))
        lo, (w, h) = cfg.map.origin, (cfg.map.width_m, cfg.map.height_m)
        far = torch.as_tensor(np.stack(
            [rng.uniform(lo[0] + 5, lo[0] + w - 5, p),
             rng.uniform(lo[1] + 5, lo[1] + h - 5, p), pose0[:, 2].cpu()],
            1).astype(np.float32), device=pose0.device)
        spread.append(((*args[:4], far, *args[5:]), kw))
    return {"tiled step": calls, "one pose": one, "spread poses": spread}


def _inputs(smoke, path: Path, root: Path, warm: int) -> dict:
    """The cases and their bounds: recorded and saved at `path` on the
    first run, read from there after."""
    import torch
    if not path.exists():
        if root.resolve() != ROOT:
            raise SystemExit(f"no inputs at {path}: record them first with "
                             f"this checkout (no --root)")
        cases = _record(smoke, warm)
        bounds = {name: [(*smoke.k1t_bound(a, kw), smoke.k1t_cells(a, kw))
                         for a, kw in calls]
                  for name, calls in cases.items()}
        host = {}

        def cpu(t):                # the field once in the file
            if t.data_ptr() not in host:
                host[t.data_ptr()] = t.cpu()
            return host[t.data_ptr()]

        torch.save({"cases": {name: [(tuple(cpu(t) for t in a), kw)
                                     for a, kw in calls]
                              for name, calls in cases.items()},
                    "bounds": bounds}, path)
    saved = torch.load(path)
    field = {}

    def dev(t):                    # the field once on the card
        if t.data_ptr() not in field:
            field[t.data_ptr()] = t.cuda()
        return field[t.data_ptr()]

    return {name: ([((dev(a[0]), *(t.cuda() for t in a[1:])), kw)
                    for a, kw in calls], saved["bounds"][name])
            for name, calls in saved["cases"].items()}


def _case(smoke, name, calls, bounds, reps) -> None:
    import torch
    from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch
    fn = kmatch.stage_scores_tile_cuda
    counted = "paths" in inspect.signature(fn).parameters
    rows = {}
    for i, stage in enumerate(STAGES):
        mine = calls[i::3]
        digest = hashlib.sha256()
        paths = torch.zeros(2, dtype=torch.int32, device="cuda")
        for args, kw in mine:
            got = fn(*args, paths=paths, **kw) if counted else fn(*args, **kw)
            digest.update(got.cpu().numpy().tobytes())
        args, kw = mine[0]
        err = float((fn(*args, **kw)
                     - kmatch.stage_scores_tile_plain(*args, **kw))
                    .abs().max())

        def run():
            for a, k in mine:
                fn(*a, **k)

        ms, graph = [], []
        for _ in range(2):
            ms.append(smoke.cuda_ms(run, reps) / len(mine))
            graph.append(smoke.graph_ms(run, reps) / len(mine))
        mine_b = bounds[i::3]
        bound = sum(b for b, _, _ in mine_b) / len(mine_b)
        cells = [c for _, _, c in mine_b]
        rows[stage] = dict(
            calls=len(mine), bound_ms=bound,
            bound_by=sorted({by for _, by, _ in mine_b}),
            cells_read=[min(cells), max(cells)],
            field_cells=int(args[0].numel()), ms=ms, graph_ms=graph,
            share_of_bound=[bound / t for t in ms],
            share_of_bound_graph=[bound / t for t in graph],
            max_abs_err_vs_plain_first_call=err,
            bits=digest.hexdigest()[:16],
            blocks_box_field=paths.tolist() if counted else None)
    _say(name, calls=len(calls), rtol=smoke.K1_RTOL, atol=smoke.K1_ATOL,
         stages=rows,
         ms_a_chunk=[sum(rows[s]["ms"][k] for s in STAGES)
                     for k in range(2)],
         graph_ms_a_chunk=[sum(rows[s]["graph_ms"][k] for s in STAGES)
                           for k in range(2)],
         bound_ms_a_chunk=sum(rows[s]["bound_ms"] for s in STAGES))


def _compiled(smoke, scans) -> None:
    """The compiled tiled step: device ms a scan by kernel row, K1t's by
    stage, and scans/s."""
    import torch
    from gridmap_slam_tpu_torch.parallel.tiled import (init_tiled,
                                                       make_tiled_step)

    eng, mesh, seq = _engine(smoke)
    comp = make_tiled_step(eng, mesh, jit=True)
    start = init_tiled(eng, mesh)

    def run():
        g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
        st = start
        for f in seq[:scans]:
            st, _ = comp(st, f, g)
        return st

    first = run()                                          # capture
    first = (first.poses.clone(), first.logodds.clone())
    _, sec = smoke._timed(run)
    again, prof = smoke._profiled(run, scans)
    same = bool(torch.equal(first[0], again.poses)
                and torch.equal(first[1], again.logodds))
    _say("compiled tiled step", scans=scans, scans_per_sec=scans / sec,
         repeat_bits_equal=same,
         poses_bits=hashlib.sha256(
             again.poses.cpu().numpy().tobytes()).hexdigest()[:16], **prof)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", type=Path, required=True)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    # this checkout's chip_smoke.py, whichever package --root holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    t0 = time.perf_counter()
    _ptxas(smoke)
    world = smoke._world_of_one()
    try:
        cases = _inputs(smoke, args.inputs, args.root, args.warm)
        for name, (calls, bounds) in cases.items():
            _case(smoke, name, calls, bounds, args.reps)
        del cases
        torch.cuda.empty_cache()
        if args.scans:
            _compiled(smoke, args.scans)
        _say("done", root=str(args.root), seconds=time.perf_counter() - t0)
    finally:
        smoke._close_world(world)


if __name__ == "__main__":
    main()
