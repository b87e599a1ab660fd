"""The tensor operations one RBPF step launches, counted on the CPU.

Each non-view aten operation of one warm `RBPF.step` is one kernel node of
the step's captured graph on the card (less its copies, fills and
allocations); a hand-written kernel (K1-K4, F1-F8) and, here on the CPU,
its plain version counts as one.  The operations are grouped by the
function of the port that called them (the innermost frame of
gridmap_slam_tpu_torch/ops or models).  Small sizes: the count depends on
the chunks, not on the particles or the map.  Then the same of one warm
`SharedMapSLAM.step_surface` at mega_config() cut to 2048 particles (the
surface step's count depends on neither).

Usage (no GPU; a few seconds):
    python scripts/op_count.py [--root DIR] [--chunks 2,20]
`--root`: an unpacked earlier commit, whose port is counted instead.
"""

import argparse
import collections
import importlib
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PLAIN = {"matcher": "stage_scores_batch_plain",
         "grid_update": "integrate_scan_batch_plain",
         "likelihood": "log_likelihood_field_batch_plain",
         "surface_corr": "surface_corr_bf16_plain",
         "fusions": ("motion_plain", "pool_plain", "pick_plain",
                     "score_plain", "splat_plain", "scan_plain",
                     "weights_plain", "walk_plain")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--chunks", default="2,20")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, SlamConfig,
                                        mega_config)
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     default_world,
                                                     simulate_log,
                                                     square_path_controls)

    aten = torch.ops.aten
    views = {aten.view, aten._unsafe_view, aten.slice, aten.select,
             aten.expand, aten.unsqueeze, aten.squeeze, aten.reshape,
             aten.as_strided, aten.t, aten.permute, aten.alias, aten.detach,
             aten.transpose, aten.unbind, aten.split, aten.lift_fresh}
    state = {"inside": 0}
    by = collections.Counter()

    def source() -> str:
        for fr in reversed(traceback.extract_stack()[:-2]):
            if "gridmap_slam_tpu_torch/" in fr.filename and (
                    "/ops/" in fr.filename or "/models/" in fr.filename):
                mod = fr.filename.split("gridmap_slam_tpu_torch/")[1]
                return f"{mod}:{fr.name}"
        return "other"

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            if not state["inside"] and func.overloadpacket not in views:
                by[source()] += 1
            return func(*a, **(kw or {}))

    def as_one(mod, name):
        real = getattr(mod, name)

        def call(*a, **kw):
            if not state["inside"]:
                by[f"kernel {name.replace('_plain', '')}"] += 1
            state["inside"] += 1
            try:
                return real(*a, **kw)
            finally:
                state["inside"] -= 1
        setattr(mod, name, call)

    for mod_name, names in PLAIN.items():
        try:
            mod = importlib.import_module(
                f"gridmap_slam_tpu_torch.ops.cuda.{mod_name}")
        except ImportError:
            continue
        for name in (names,) if isinstance(names, str) else names:
            if hasattr(mod, name):
                as_one(mod, name)

    torch.set_num_threads(1)
    frames, _ = simulate_log(default_world(), square_path_controls(3),
                             params=SimParams(beams_per_rev=90), seed=7)
    for chunks in (int(c) for c in args.chunks.split(",")):
        cfg = SlamConfig(num_particles=2 * chunks, max_beams=96,
                         particle_chunk=2)
        eng = RBPF(cfg, device="cpu")
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
        gen = torch.Generator().manual_seed(0)
        st, _ = eng.step(eng.init(), frame_at(batch, 0), gen)
        by.clear()
        with Count():
            eng.step(st, frame_at(batch, 1), gen)
        print(json.dumps(dict(chunks=chunks, ops_a_scan=sum(by.values()),
                              by_source=dict(by.most_common()))), flush=True)
    cfg = mega_config().replace(num_particles=2048)
    eng = SharedMapSLAM(cfg, device="cpu")
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    gen = torch.Generator().manual_seed(0)
    st, _ = eng.step_surface(eng.init(), frame_at(batch, 0), gen)
    by.clear()
    with Count():
        eng.step_surface(st, frame_at(batch, 1), gen)
    print(json.dumps(dict(engine="step_surface", preset="mega",
                          ops_a_scan=sum(by.values()),
                          by_source=dict(by.most_common()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
