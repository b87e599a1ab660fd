"""What the benchmark runs, read from the files beside this module.

- presets/<name>.json: bench.py's presets (`measure`, bench.py:617-646,
  with `make_engine`'s 192 beam slots and map, :116-145) in the port's own
  configs: an engine (a class of models/, its captured replay and its eager
  replay, each a method and its keywords) and a config (a function of
  config.py and dotted overrides, SlamConfig.with_overrides);
  tests/test_torch_bench.py holds them to bench.py's branch.
- cells/<name>.json: a cell, one preset under one traffic: its config's
  name, source, traffic, users and chips, its log, its correctness limits,
  the bound of each end-to-end metric, its control (the kernels made wrong
  on purpose, which the check against the plain versions must catch), its
  per-layer metrics with their units, and dotted overrides of the preset's
  config (`overrides`, none by default).
- spans/<name>.json: the calls of a module whose device work a per-layer
  metric `device_ms_a_scan.<name>` attributes.
- kernels/<name>.py: a kernel, its function names, entry points and bound.

run.py and layers.py find every file, so a cell, span or kernel is added
by adding its file.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
from pathlib import Path

from .. import config as config_module
from ..io.synthetic import (SimParams, default_world, simulate_log,
                            square_path_controls)

HERE = Path(__file__).resolve().parent

# End-to-end metrics: unit and the better direction
END_TO_END = {
    "scans_per_sec": ("scans/s", "higher"),
    "setup_s": ("s", "lower"),
    "peak_device_gb": ("GB", "lower"),
}


def build_log(n_frames: int, beams: int, seed: int = 0):
    """bench.py's build_log: (frames, ground-truth poses) of the synthetic
    square path on default_world(), `beams` beams a scan, from `seed`."""
    params = SimParams(beams_per_rev=beams)
    return simulate_log(default_world(), square_path_controls(n_frames),
                        params=params, seed=seed)


def _tuples(x):
    return tuple(x) if isinstance(x, list) else x


def make_config(spec: dict):
    """config.<spec["from"]>() with spec["overrides"] (dotted keys,
    SlamConfig.with_overrides; a list is a tuple)."""
    return getattr(config_module, spec["from"])().with_overrides(
        {k: _tuples(v) for k, v in spec["overrides"].items()})


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    about: str
    engine: dict
    config: object          # SlamConfig

    def make(self, cfg, device):
        """(engine, its captured replay, its eager replay) on `cfg`: each
        replay (state, stacked frames, generator) -> (state, infos)."""
        module, cls = self.engine["class"].rsplit(".", 1)
        eng = getattr(importlib.import_module(
            f"gridmap_slam_tpu_torch.models.{module}"), cls)(cfg,
                                                               device=device)
        name, kw = self.engine["captured"]
        replay = getattr(eng, name)(**kw)
        name, kw = self.engine["eager"]
        return eng, replay, functools.partial(getattr(eng, name), **kw)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    preset: str
    chips: int
    source: str
    traffic: str
    who: str
    log: dict               # scans, beams
    limits: dict            # ate_m
    bounds: dict            # end-to-end metric -> the share it may worsen
    control: dict           # round_bf16: the kernels it makes wrong
    per_layer: dict         # metric -> unit
    overrides: dict = dataclasses.field(default_factory=dict)

    def make_config(self, preset: "Preset"):
        """The preset's config with the cell's overrides (dotted keys,
        SlamConfig.with_overrides; a list is a tuple)."""
        return preset.config.with_overrides(
            {k: _tuples(v) for k, v in self.overrides.items()})


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    about: str
    module: str
    calls: tuple


def _files(kind: str):
    return sorted((HERE / kind).glob("*.json"))


def load_presets() -> dict:
    out = {}
    for path in _files("presets"):
        d = json.loads(path.read_text())
        out[path.stem] = Preset(path.stem, d["about"], d["engine"],
                                make_config(d["config"]))
    return out


def load_cells() -> dict:
    return {path.stem: Cell(path.stem, **json.loads(path.read_text()))
            for path in _files("cells")}


def load_spans() -> dict:
    out = {}
    for path in _files("spans"):
        d = json.loads(path.read_text())
        out[path.stem] = Span(path.stem, d["about"], d["module"],
                              tuple(d["calls"]))
    return out
