"""bench.py's one-measurement command line (`measure`, bench.py:617-672;
`make_engine`, :116-145; `_parse_override`, :104-113; its flags,
:570-615) as one in-memory cell of the port's benchmark.

`python -m gridmap_slam_tpu_torch.bench --preset pr1 --set K=V` or
`--particles N --chunk C --map-size M [--shared-map | --surface --crop K
--refine-steps S | --blocked B]` builds the config as bench.py does, in
its order: the preset's config (presets/<name>.json) or bench.py's
default (10 000 particles, chunks of 2048, a 6 m map at 5 cm, 192 beam
slots), then --particles and --chunk, the map from --map-size, then
`matcher.surface_crop_cells` and `matcher.surface_refine_steps`, then the
--set overrides.  Where bench.py's preset overwrites --particles,
--chunk or --map-size, the port takes the flag (as --particles does for
a cell file).  The engine is bench.py's: --blocked (0: the block from the
config, models/shared.matcher_block_size; every block runs one chunk, as
bench.py's blocked timing does) before --surface before --shared-map, a
preset's own mode counting as its flag; else the RBPF.

The cell runs through run.run_cell as a cell file does: the same log,
ATE limit and checks, per-layer metrics for the kernels its mode runs,
and a control that rounds K2's map (every engine runs K2).
"""

from __future__ import annotations

import dataclasses

from . import cells as C

# bench.py's engine modes: the engine's class and its eager replay (the
# captured replay is its `_jit`)
MODES = {"rbpf": ("rbpf.RBPF", "replay"),
         "shared": ("shared.SharedMapSLAM", "replay"),
         "surface": ("shared.SharedMapSLAM", "replay_surface"),
         "blocked": ("shared.SharedMapSLAM", "replay")}


def parse_override(kv: str):
    """bench.py's _parse_override: "key=value" -> (key, the value as an
    int, else a float, else true/false, else the string)."""
    key, _, raw = kv.partition("=")
    for cast in (int, float):
        try:
            return key, cast(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return key, raw.lower() == "true"
    return key, raw


def requested(args) -> bool:
    """Whether the command line asks for one measurement."""
    return bool(args.preset or args.overrides or args.shared_map
                or args.surface or args.blocked >= 0
                or args.chunk is not None or args.map_size is not None
                or args.crop or args.refine_steps >= 0)


def default_config():
    """bench.py's make_engine without a preset: 10 000 particles in chunks
    of 2048, 192 beam slots, a 6 x 6 m map at 5 cm centred on the
    origin."""
    from ..config import MapConfig, SlamConfig
    return SlamConfig(num_particles=10_000, max_beams=192,
                      particle_chunk=2048,
                      map=MapConfig(width_m=6.0, height_m=6.0,
                                    resolution=0.05, origin=(-3.0, -3.0)))


def mode_of(engine: dict) -> str:
    """The bench.py mode of a preset's engine."""
    name, kw = engine["captured"]
    if "block" in kw:
        return "blocked"
    if name == "replay_surface_jit":
        return "surface"
    return "shared" if engine["class"].startswith("shared.") else "rbpf"


def engine_spec(mode: str, block=None) -> dict:
    cls, eager = MODES[mode]
    kw = {} if block is None else {"block": block}
    return {"class": cls, "captured": [eager + "_jit", kw],
            "eager": [eager, kw]}


def overrides(args, mode: str) -> dict:
    """The dotted overrides of the flags, in bench.py's order."""
    out = {}
    if args.particles:
        out["num_particles"] = args.particles
    if mode == "blocked":       # bench.py's blocked timing: one chunk
        out["particle_chunk"] = 0
    elif args.chunk is not None:
        out["particle_chunk"] = args.chunk
    if args.map_size is not None:
        m = args.map_size
        out.update({"map.width_m": m, "map.height_m": m,
                    "map.origin": (-m / 2, -m / 2)})
    if args.crop:
        out["matcher.surface_crop_cells"] = args.crop
    if args.refine_steps >= 0:
        out["matcher.surface_refine_steps"] = args.refine_steps
    out.update(parse_override(kv) for kv in args.overrides)
    return out


def per_layer(mode: str, cfg) -> dict:
    """The per-layer metrics of a mode: each kernel it runs (K1 on the
    matcher's modes; K4 where surface mode correlates in bf16) and, in
    surface mode, the surface span."""
    kernels = (["K2", "K3"] if mode == "surface" else ["K1", "K2", "K3"])
    if mode == "surface" and cfg.matcher.surface_bf16:
        kernels.append("K4")
    spans = ["surface"] if mode == "surface" else []
    return {**{f"device_ms_a_scan.{k}": "ms" for k in kernels + spans},
            "device_ms_a_scan.glue": "ms",
            "host_launches_a_scan": "launches",
            "device_busy_share": "fraction",
            **{f"share_of_bound.{k}": "fraction" for k in kernels}}


def measurement(args, presets: dict, argv) -> tuple:
    """(cell, preset) of bench.py's one measurement on this command line;
    the cell holds every setting of the flags as its overrides, so the
    caller runs it with --particles spent."""
    preset = presets.get(args.preset)
    pmode = mode_of(preset.engine) if preset else "rbpf"
    blocked = (args.blocked if args.blocked >= 0
               else 0 if pmode == "blocked" else -1)
    mode = ("blocked" if blocked >= 0
            else "surface" if args.surface or pmode == "surface"
            else "shared" if args.shared_map or pmode == "shared"
            else "rbpf")
    base = preset.config if preset else default_config()
    name = args.preset or "custom"
    cell = C.Cell(
        name=name, config=name, preset=args.preset or "custom", chips=1,
        source="bench.py's one measurement (measure, :617-672): "
               + " ".join(argv),
        traffic="closed loop: the square-path synthetic log "
                "(square_path_controls, default_world()) made from --seed, "
                "replayed whole, each scan waiting for the last",
        who="a user timing one configuration with bench.py's flags",
        log={"scans": 12, "beams": 180}, limits={"ate_m": 0.10},
        bounds={}, control={"round_bf16": ["K2"]}, per_layer={},
        overrides=overrides(args, mode))
    about = f"bench.py's one measurement: {cell.source}"
    cfg = cell.make_config(C.Preset(name, about, {}, base))
    if mode == "blocked":
        from ..models.shared import matcher_block_size
        block = blocked or matcher_block_size(cfg)
        engine = engine_spec(mode, block)
    else:
        engine = engine_spec(mode)
    cell = dataclasses.replace(cell, per_layer=per_layer(mode, cfg))
    return cell, C.Preset(name, about, engine, base)
