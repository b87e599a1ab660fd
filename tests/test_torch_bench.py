"""The port's benchmark entry point (gridmap_slam_tpu_torch/bench) on the CPU.

Its cells run through `main` at a tiny size (plain versions of the
kernels); its checks fail the run, its control among them; it refuses the
card where there is none; it imports no JAX; its log and presets are
bench.py's (the JAX package's benchmark); its cell, preset, span and kernel
files are whole; K1's bound counts the field cells the taps read; a
profiled replay's records split into its graph launches; each kernel call
is held against its plain version.
"""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench
import gridmap_slam_tpu
import gridmap_slam_tpu.models.shared as jshared
from gridmap_slam_tpu_torch.bench import (baseline, bounds, cells, layers,
                                          measure, run)
from gridmap_slam_tpu_torch.bench import kernels as K
from gridmap_slam_tpu_torch.bench.kernels import k1
from gridmap_slam_tpu_torch.models.shared import matcher_block_size
from gridmap_slam_tpu_torch.ops.cuda import grid_update
from gridmap_slam_tpu_torch.ops.cuda import matcher as kmatch

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--scans", "4", "--reps", "2",
        "--min-seconds", "0"]


def _run(capsys, argv):
    rc = run.main(argv)
    lines = capsys.readouterr().out.splitlines()
    return rc, lines, json.loads(lines[-1])


CELLS = cells.load_cells()


@pytest.mark.parametrize("cell,particles", [
    ("parity", 16), ("mega_surface", 256), ("city_surface", 16),
    ("mega_blocked", 16), ("chip", 16), ("parity_fullres", 16),
    ("pr1", 16), (None, 16)])
def test_cells_run_through_the_entry_point(capsys, cell, particles):
    argv = TINY + ["--particles", str(particles)]
    if cell:
        argv += ["--cell", cell]
    if cell in ("city_surface", None):  # city's 512-cell FFT volume: 0.8 s
        argv += ["--scans", "2"]        # a scan
    rc, lines, last = _run(capsys, argv)
    want = [cell] if cell else sorted(CELLS)
    assert rc == 0, lines
    assert len(lines[-1].encode()) < 2048
    assert last["correct"] is True and last["control"] is False
    assert last["unit"] == "scans/s" and last["metric"] == "scans_per_sec"
    assert last["value"] == last["cells"][last["cell"]]["scans_per_sec"] > 0
    assert list(last["cells"]) == want
    assert last["cell"] == run.head_cell(
        [json.loads(ln) for ln in lines if ln.startswith('{"cell"')])["cell"]
    assert last["vs_baseline"] > 0 and set(last) >= set(baseline.FIELDS)
    assert set(last["units"]) >= set(cells.END_TO_END)
    for name in want:
        got = last["cells"][name]
        assert got["correct"] is True
        assert got["ate_m"] < CELLS[name].limits["ate_m"]
        assert got["kernels_agree"] is True
        assert set(got) >= set(cells.END_TO_END)
        # every metric by name with its unit, or as not measured on the CPU
        for metric, (unit, _) in cells.END_TO_END.items():
            assert any(ln.startswith(f"{name} {metric} ")
                       and (ln.endswith("(cpu)") or f" {unit}" in ln)
                       for ln in lines), metric
        for metric in CELLS[name].per_layer:
            assert f"{name} {metric} not measured" in lines
        rec = next(json.loads(ln) for ln in lines
                   if ln.startswith(f'{{"cell":"{name}"'))
        sps = rec["scans_per_sec"]
        assert sps["count"] == 2
        assert sps["value"] == pytest.approx(rec["scans"] * 2
                                             / sps["seconds"])
        assert sps["q1"] <= sps["median"] <= sps["q3"]
        assert set(rec["bounds"]) == set(cells.END_TO_END)
        assert rec["repeat_bits_equal"] and rec["finite"]
        assert rec["peak_device_gb"] is None and rec["per_layer"] is None
        # on the CPU every kernel is its plain version: no error at all
        want_kernels = {"parity": {"K1", "K2", "K3"},
                        "mega_surface": {"K2", "K3"},
                        "city_surface": {"K2", "K3"},
                        "mega_blocked": {"K1", "K2", "K3"},
                        "chip": {"K1", "K2", "K3"},
                        "parity_fullres": {"K1", "K2", "K3"},
                        "pr1": {"K1", "K2", "K3"}}[name]
        assert set(rec["agreement"]) == want_kernels
        for row in rec["agreement"].values():
            assert row == dict(calls=row["calls"], share=0.0,
                               max_abs_err=0.0, ok=True) and row["calls"] > 0


def _nan_init(init):
    def bad(*args, **kw):
        state = init(*args, **kw)
        state.poses = torch.full_like(state.poses, float("nan"))
        return state
    return bad


def _with_limits(monkeypatch, **limits):
    cell = CELLS["parity"]
    monkeypatch.setattr(cells, "load_cells", lambda: {
        "parity": dataclasses.replace(cell, limits={**cell.limits,
                                                    **limits})})


@pytest.mark.parametrize("fault", ["ate", "finite", "bits", "control"])
def test_a_failed_check_fails_the_run(capsys, monkeypatch, fault):
    argv = TINY + ["--particles", "16", "--scans", "2", "--cell", "parity"]
    if fault == "ate":
        _with_limits(monkeypatch, ate_m=1e-9)
    elif fault == "finite":
        from gridmap_slam_tpu_torch.models.rbpf import RBPF
        monkeypatch.setattr(RBPF, "init", _nan_init(RBPF.init))
    elif fault == "bits":   # the repeated replay draws from another seed
        seeds = iter(range(10 ** 6))
        monkeypatch.setattr(run, "rep_seed", lambda seed, rep: next(seeds))
    else:   # K1 reads its field in bf16: off its plain version
        argv += ["--control"]
    rc, lines, last = _run(capsys, argv)
    assert rc != 0
    assert last["correct"] is False and last["cells"]["parity"]["correct"] \
        is False
    rec = next(json.loads(ln) for ln in lines if ln.startswith('{"cell"'))
    assert {"ate": rec["ate_m"]["max"] > rec["limits"]["ate_m"],
            "finite": not rec["finite"],
            "bits": not rec["repeat_bits_equal"],
            "control": rec["control"] and not rec["kernels_agree"]
            and not rec["agreement"]["K1"]["ok"]
            and rec["agreement"]["K2"]["ok"]}[fault]


def test_mega_surface_s_control_fails_the_run(capsys):
    """K2 reads the map in bf16: the agreement check fails it."""
    rc, lines, last = _run(capsys, TINY + [
        "--particles", "64", "--scans", "2", "--cell", "mega_surface",
        "--control"])
    rec = next(json.loads(ln) for ln in lines if ln.startswith('{"cell"'))
    assert rc != 0 and last["correct"] is False
    assert not rec["agreement"]["K2"]["ok"] and rec["agreement"]["K3"]["ok"]
    assert rec["agreement"]["K2"]["share"] > 0.01


def test_city_surface_s_control_fails_the_run(capsys):
    """K2's window variant reads the map in bf16: the agreement check,
    counting the cells beyond its tolerance over the window, fails it."""
    rc, lines, last = _run(capsys, TINY + [
        "--particles", "16", "--scans", "2", "--reps", "1", "--cell",
        "city_surface", "--control"])
    rec = next(json.loads(ln) for ln in lines if ln.startswith('{"cell"'))
    assert rc != 0 and last["correct"] is False
    assert not rec["agreement"]["K2"]["ok"] and rec["agreement"]["K3"]["ok"]
    assert rec["agreement"]["K2"]["share"] > 0.01


def test_k2_window_share_is_of_the_window():
    """The window variant's share of cells beyond atol is over its window,
    the batch kernel's over its whole output."""
    from gridmap_slam_tpu_torch.bench.kernels import k2
    ref = torch.zeros(100, 100)
    out = ref.clone()
    out[:5, :10] = 1.0                   # 50 cells wrong
    assert k2.k2_agreement(out, ref, {}) == (50 / 10_000, k2.K2_MAX_SHARE)
    assert k2.k2_agreement(out, ref, {"size": (20, 25)}) == (
        50 / 500, k2.K2_MAX_SHARE)


def test_cuda_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    assert run.main(["--device", "cuda"]) != 0
    assert capsys.readouterr().out == ""


def test_the_entry_point_imports_no_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['bench'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('gridmap_slam_tpu_torch.bench',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax', 'orbax', 'gridmap_slam_tpu'))\n"
            "print('RC', rc, 'IMPORTED', bad)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, *TINY, "--particles", "8", "--scans",
         "2", "--cell", "parity"], capture_output=True, text=True,
        timeout=300, check=True).stdout
    assert out.splitlines()[-1] == "RC 0 IMPORTED []", out


def test_no_port_module_and_not_chip_smoke_imports_jax():
    """Every import statement of the port's package and of chip_smoke.py,
    read from the source (a module imported only inside a function too)."""
    root = Path(__file__).resolve().parents[1]
    files = [root / "chip_smoke.py",
             *sorted((root / "gridmap_slam_tpu_torch").rglob("*.py"))]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(root)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in
                    ("jax", "jaxlib", "flax", "orbax", "gridmap_slam_tpu")]
    assert len(files) > 60 and not bad, bad


@pytest.mark.parametrize("seed", [0, 1])
def test_build_log_is_bench_py_s(seed):
    jf, jgt = bench.build_log(12, 180, seed)
    tf, tgt = cells.build_log(12, 180, seed)
    np.testing.assert_array_equal(jgt, tgt)
    assert len(jf) == len(tf) == 12
    for a, b in zip(jf, tf):
        assert (a.t, a.d_center, a.d_theta) == (b.t, b.d_center, b.d_theta)
        for f in ("angle", "dist", "hit"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


class _Stop(Exception):
    pass


def _bench_preset(monkeypatch, name):
    """What bench.py's `measure` gives the JAX engine for --preset name:
    (timing function, its keyword arguments, frames, the engine's
    config), stopped where the engine is made."""
    return _bench_measure(monkeypatch, ["--preset", name])


def _bench_measure(monkeypatch, argv):
    """_bench_preset for any of bench.py's command lines."""
    seen = {}

    def engine(cfg):
        seen["config"] = cfg
        raise _Stop

    def spy(fn_name):
        real = getattr(bench, fn_name)

        def call(frames, n_particles, chunk, **kw):
            seen.update(fn=fn_name, frames=len(frames), kw=kw)
            return real(frames, n_particles, chunk, **kw)
        return call

    monkeypatch.setattr(bench, "build_log",
                        lambda n, beams, seed=0: ([None] * n, None))
    monkeypatch.setattr(gridmap_slam_tpu, "RBPF", engine)
    monkeypatch.setattr(jshared, "SharedMapSLAM", engine)
    for fn in ("time_engine", "time_engine_marginal", "time_engine_blocked"):
        monkeypatch.setattr(bench, fn, spy(fn))
    with pytest.raises(_Stop):
        bench.measure(bench.build_parser().parse_args(
            [*argv, "--skip-oracle"]))
    return seen


# bench.py's engine mode -> the preset's engine class and captured replay
ENGINES = {"rbpf": ("rbpf.RBPF", "replay_jit"),
           "surface": ("shared.SharedMapSLAM", "replay_surface_jit"),
           "shared": ("shared.SharedMapSLAM", "replay_jit")}


@pytest.mark.parametrize("name", ["parity", "mega", "city", "chip",
                                  "mega_blocked", "pr1"])
def test_presets_are_bench_py_s(monkeypatch, name):
    seen = _bench_preset(monkeypatch, name)
    preset = cells.load_presets()[name]
    assert (dataclasses.asdict(seen["config"])
            == dataclasses.asdict(preset.config))
    mode = seen["kw"].get("mode", "shared")
    eng = preset.engine
    assert (eng["class"], eng["captured"][0]) == ENGINES[mode]
    assert eng["eager"][0] == eng["captured"][0][:-len("_jit")]
    if seen["fn"] == "time_engine_blocked":
        # bench.py's block 0: the block from the config, matcher_block_size
        assert seen["kw"]["block"] == 0
        block = matcher_block_size(preset.config)
        assert block == 500_000
        assert eng["captured"][1] == eng["eager"][1] == {"block": block}
    else:
        assert eng["captured"][1] == eng["eager"][1] == {}
    # every preset replays the whole 12-scan log: bench.py cuts mega's and
    # city's to 4 scans, a workaround of its TPU's dispatch (bench.py:630)
    assert seen["frames"] == (4 if name in ("mega", "city") else 12)
    assert bench.build_parser().parse_args([]).frames == 12


def test_parity_fullres_is_bench_py_s_parity_pallas_rung(monkeypatch):
    """The cell's config is what bench.py's parser and make_engine build
    from the LADDER rung parity_pallas's own argv (bench.py:381-384)."""
    rung = next(r for r in bench.LADDER if r[0] == "parity_pallas")
    seen = _bench_measure(monkeypatch, rung[2])
    cell = CELLS["parity_fullres"]
    preset = cells.load_presets()[cell.preset]
    cfg = cell.make_config(preset)
    assert dataclasses.asdict(seen["config"]) == dataclasses.asdict(cfg)
    assert cfg.matcher.coarse_halfres is False and cfg.matcher.coarse_nearest
    assert cfg.num_particles == rung[1] == 500
    assert seen["fn"] == "time_engine_marginal"     # its --marginal
    assert seen["kw"]["mode"] == "rbpf" and preset.engine["class"] == \
        ENGINES["rbpf"][0]


def _port_measure(argv):
    """The port's one measurement on bench.py's argv: (config, engine)."""
    presets = cells.load_presets()
    args = run.build_parser(sorted(CELLS), sorted(presets)).parse_args(argv)
    assert measure.requested(args)
    cell, preset = measure.measurement(args, presets, argv)
    return cell.make_config(preset), preset.engine


@pytest.mark.parametrize("argv", [
    ["--preset", "pr1", "--set", "matcher.coarse_halfres=false",
     "--set", "matcher.z_hit=0.9", "--set", "resample_fraction=1"],
    ["--particles", "64", "--chunk", "32", "--map-size", "8"],
    ["--particles", "64", "--chunk", "0", "--shared-map"],
    ["--particles", "4096", "--chunk", "0", "--surface", "--crop", "256",
     "--refine-steps", "2"],
    ["--particles", "1000", "--blocked", "0"],
    ["--preset", "mega", "--refine-steps", "1"],
    ["--preset", "city", "--crop", "256"]], ids=lambda a: " ".join(a))
def test_one_measurement_flags_build_make_engine_s_config(monkeypatch, argv):
    """The port's flags build the config bench.py's `measure` and
    `make_engine` (or its blocked timing) give the JAX engine, and its
    engine mode; --blocked 0 takes the block from the config."""
    seen = _bench_measure(monkeypatch, argv)
    cfg, engine = _port_measure(argv)
    assert dataclasses.asdict(seen["config"]) == dataclasses.asdict(cfg)
    if seen["fn"] == "time_engine_blocked":
        assert seen["kw"]["block"] == 0
        assert engine["class"] == "shared.SharedMapSLAM"
        block = matcher_block_size(cfg)
        assert engine["captured"] == ["replay_jit", {"block": block}]
        assert engine["eager"] == ["replay", {"block": block}]
    else:
        cls, captured = ENGINES[seen["kw"]["mode"]]
        assert (engine["class"], engine["captured"][0]) == (cls, captured)
        assert engine["captured"][1] == engine["eager"][1] == {}


def test_parse_override_is_bench_py_s():
    texts = ["a=1", "b=-2", "c=1.5", "d=1e3", "e=true", "f=False",
             "g=TRUE", "h=gather", "matcher.impl=matmul", "k=", "m=x=y",
             "n=0x10", "p=1_000"]
    for text in texts:
        got, want = measure.parse_override(text), bench._parse_override(text)
        assert got == want and type(got[1]) is type(want[1]), text


@pytest.mark.parametrize("flag", [["--preset", "pr1"],
                                  ["--set", "matcher.z_hit=0.9"],
                                  ["--shared-map"], ["--surface"],
                                  ["--blocked", "0"], ["--chunk", "8"]])
def test_cell_with_a_measurement_flag_exits_2(capsys, flag):
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu", "--cell", "parity", *flag])
    assert e.value.code == 2
    assert "one measurement" in capsys.readouterr().err


@pytest.mark.parametrize("argv,kernels", [
    (["--preset", "pr1", "--set", "matcher.coarse_halfres=false"],
     {"K1", "K2", "K3"}),
    (["--preset", "parity", "--particles", "16", "--chunk", "8",
      "--set", "matcher.coarse_halfres=false"], {"K1", "K2", "K3"}),
    (["--particles", "256", "--chunk", "0", "--surface", "--crop", "64",
      "--refine-steps", "1"], {"K2", "K3"}),
    (["--particles", "16", "--chunk", "0", "--shared-map"],
     {"K1", "K2", "K3"}),
    (["--preset", "mega_blocked", "--particles", "16", "--blocked", "8"],
     {"K1", "K2", "K3"})],
    ids=["pr1", "parity_fullres", "surface", "shared", "blocked"])
def test_one_measurement_runs_through_the_entry_point(capsys, argv,
                                                      kernels):
    """A measurement is one cell named after its preset (or custom), run
    through the same checks to the same last line."""
    argv = TINY + ["--scans", "2", *argv]
    if "--particles" not in argv:
        argv += ["--particles", "8"]
    rc, lines, last = _run(capsys, argv)
    name = argv[argv.index("--preset") + 1] if "--preset" in argv \
        else "custom"
    assert rc == 0, lines
    assert last["correct"] is True and list(last["cells"]) == [name]
    assert last["cell"] == name and last["vs_baseline"] > 0
    rec = next(json.loads(ln) for ln in lines if ln.startswith('{"cell"'))
    assert rec["repeat_bits_equal"] and rec["finite"]
    assert set(rec["agreement"]) == kernels
    assert all(row["ok"] and row["calls"] > 0
               for row in rec["agreement"].values())
    particles = int(argv[len(argv) - 1 - argv[::-1].index("--particles")
                         + 1])
    assert rec["particles"] == particles
    assert rec["overrides"]["num_particles"] == particles
    layer = [ln for ln in lines if ln.startswith(f"{name} device_ms_a_scan.")]
    assert f"{name} device_ms_a_scan.K2 not measured" in layer
    assert (f"{name} device_ms_a_scan.surface not measured" in layer) is (
        "--surface" in argv)
    assert all(ln.endswith(" not measured") for ln in layer)


def test_one_measurement_s_control_and_refusals_fail_the_run(capsys):
    """--control rounds K2's map (every engine runs K2): the check fails
    it.  A chunk that does not divide the particles raises, as the engine
    does, and fails the run."""
    rc, lines, last = _run(capsys, TINY + [
        "--scans", "2", "--preset", "parity", "--particles", "16",
        "--chunk", "8", "--control"])
    rec = next(json.loads(ln) for ln in lines if ln.startswith('{"cell"'))
    assert rc == 1 and last["correct"] is False
    assert not rec["agreement"]["K2"]["ok"] and rec["agreement"]["K1"]["ok"]
    rc, lines, last = _run(capsys, TINY + [
        "--scans", "2", "--particles", "16", "--chunk", "6"])
    assert rc == 1 and last["correct"] is False
    assert "particle_chunk" in last["cells"]["custom"]["error"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_files_are_whole(name):
    """Each cell names a preset, its ATE limit, a bound for every end-to-end
    metric, a control, and per-layer metrics whose parts exist."""
    cell = CELLS[name]
    presets, kernels, spans = (cells.load_presets(), K.load(),
                               cells.load_spans())
    assert cell.preset in presets and cell.chips == 1
    assert set(cell.limits) == {"ate_m"}
    assert set(cell.bounds) == set(cells.END_TO_END)
    assert all(b >= 0.03 for b in cell.bounds.values())
    assert set(cell.control) == {"round_bf16"}
    assert set(cell.control["round_bf16"]) <= set(kernels)
    for metric in cell.per_layer:
        kind, _, part = metric.partition(".")
        assert kind in ("device_ms_a_scan", "share_of_bound",
                        "host_launches_a_scan", "device_busy_share"), metric
        if kind == "device_ms_a_scan":
            assert part in kernels or part in spans or part == "glue"
        if kind == "share_of_bound":
            assert part in kernels
    assert cell.log == {"scans": 12, "beams": 180}


def test_kernels_are_told_apart_by_name():
    """Each kernel's functions, mangled (graph nodes) and demangled (the
    profiler), and K1's tiled instantiations apart from K1."""
    kernels = K.load()
    names = {
        "_ZN12_GLOBAL__N_119stage_scores_kernelILb1ELb0ELi1ELb0EEEvPKf": "K1",
        "void (anonymous namespace)::stage_scores_kernel<true, false, 3, "
        "false>(float const*)": "K1",
        "_ZN12_GLOBAL__N_119stage_scores_kernelILb1ELb1ELi2ELb1EEEvPKf":
            "K1t",
        "void (anonymous namespace)::stage_scores_kernel<false, true, 1, "
        "true>(float const*)": "K1t",
        "_ZN12_GLOBAL__N_124stage_scores_tile_kernelILb0ELi1EEEvv": "K1t",
        "void (anonymous namespace)::grid_update_kernel<true, false>()": "K2",
        "void (anonymous namespace)::ll_field_small(Args)": "K3",
        "ll_field_generic": "K3",
        "surface_corr_prep(CorrArgs)": "K4",
        "surface_corr_kernel(CorrArgs)": "K4",
        "void at::native::elementwise_kernel<128, 2>": None,
    }
    for name, want in names.items():
        assert K.kernel_of(kernels, name) == want, name


def test_agreement_holds_each_call_against_the_plain_version():
    """Agreement wraps an entry point: the plain version runs first on the
    same arguments (K2 updates its map in place through `out=`), then the
    entry point; a kernel beyond its tolerance is marked."""
    rng = np.random.default_rng(0)
    lo = torch.from_numpy(rng.normal(size=(3, 9, 11)).astype(np.float32))
    poses = torch.tensor([[0.0, 0.0, 0.1], [0.05, -0.02, 1.0],
                          [-0.1, 0.1, -2.0]])
    n_bins = 16
    tables = (torch.full((n_bins,), 0.2), torch.zeros(n_bins),
              torch.ones(n_bins))
    kw = dict(resolution=0.05, origin=(-0.275, -0.225), l_free=-0.4,
              l_occ=0.85)
    want = grid_update.integrate_scan_batch_plain(lo, poses, 1.0, *tables,
                                                  **kw)
    kernels = K.load()

    def off(lo, *args, out=None, **kw):      # a kernel off by 1e-4
        res = grid_update.integrate_scan_batch_plain(lo, *args, **kw) + 1e-4
        return res if out is None else out.copy_(res)

    for real, ok in ((grid_update.integrate_scan_batch_plain, True),
                     (off, False)):
        agreement = K.Agreement(kernels)
        call = agreement.wrap("K2", kernels["K2"].entries[0], real)
        buf = lo.clone()
        got = call(buf, poses, 1.0, *tables, out=buf, **kw)
        if ok:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        row = agreement.rows["K2"]
        assert row["calls"] == 1 and row["ok"] is ok
        assert row["share"] == (0.0 if ok else 1.0)


FUNCTIONS = {"K2": "grid_update_kernel", "K3": "ll_field_small"}


class _Range:
    def __init__(self, start, us):
        self.start = start
        self.us = us

    def elapsed_us(self):
        return self.us


def _events(pattern, n):
    """A profiled replay's events: a fill and n times (two draws, then a
    graph launch whose kernels and one copy node run), as the profiler
    gives them: the host's cudaGraphLaunch and the device records of its
    launch share its correlation id."""
    host, dev, t = [], [], 0
    for i in range(n):
        for name in (["fill"] if i == 0 else []) + ["randn", "rand"]:
            t += 1
            dev.append(SimpleNamespace(id=10 * i + 1, name=name,
                                       time_range=_Range(t, 1.0)))
        launch = 1000 + i
        host.append(SimpleNamespace(id=launch, name="cudaGraphLaunch",
                                    time_range=_Range(t, 5.0)))
        names = [FUNCTIONS.get(g, f"k{j}") for j, g in enumerate(pattern)]
        for name in names[:2] + ["memcpy32_post"] + names[2:]:
            t += 1
            dev.append(SimpleNamespace(id=launch, name=name,
                                       time_range=_Range(t, float(t))))
    return dev, host


def test_launches_by_id_split_a_replay_s_records():
    """Each launch's kernel records, grouped by its correlation id, its copy
    node's record left out; a launch of which a record was dropped is not
    whole."""
    pattern = [None, "K2", None, None, "K3", None]
    kernels = K.load()
    dev, host = _events(pattern, n=5)
    dev.remove(next(e for e in dev if e.id == 1001 and e.name == "k3"))
    runs = layers.launches_by_id(dev, host, kernels)
    assert [len(run) for run in runs] == [6, 5, 6, 6, 6]
    order = [(FUNCTIONS.get(g, f"k{j}"), j) for j, g in enumerate(pattern)]
    whole = [layers.align(run, order, kernels) for run in runs]
    assert [w is not None for w in whole] == [True, False, True, True, True]
    assert all([r[0] for r in run] == ["k0", "grid_update_kernel", "k2",
                                       "k3", "ll_field_small", "k5"]
               for run, w in zip(runs, whole) if w is not None)


def test_a_launch_s_records_take_the_bodies_filed_under_it():
    """A graph of 3 scans, each [k0, K2, IF(body b0, b1), K3]: a launch's
    records line up with the chain whether the profiler filed all, some or
    none of a body's records under the launch (by their names, where the
    IF node stands), and a span reads only its own nodes; a launch of which
    a record of the chain was dropped is not whole."""
    kernels = K.load()
    scans, order, node = 3, [], 0
    for _ in range(scans):
        order += [("k0", node), (FUNCTIONS["K2"], node + 1),
                  (None, node + 2, ["b0", "b1"]), (FUNCTIONS["K3"], node + 3)]
        node += 4
    names = [e[0] for e in order if e[0] is not None]
    span = {"surface": {e[1] for e in order if e[0] == "k0"}}
    filed = [[True, False, True], [False] * 3, [True] * 3, [True, None, True],
             [True, True, True]]
    host, dev, t = [], [], 0
    for r, bodies in enumerate(filed):
        launch = 1000 + r
        host.append(SimpleNamespace(id=launch, name="cudaGraphLaunch",
                                    time_range=_Range(t, 5.0)))
        for k in range(scans):
            got = (["k0", FUNCTIONS["K2"]]
                   + {True: ["b0", "b1"], False: [], None: ["b1"]}[bodies[k]]
                   + [FUNCTIONS["K3"]])
            if r == len(filed) - 1 and k == 1:    # a record dropped
                got.remove("k0")
            for name in got:
                t += 1
                dev.append(SimpleNamespace(
                    id=launch, name=name, time_range=_Range(
                        t, 2.0 if name == "k0" else 9.0)))
    out = layers.read_replays(kernels, ["K2", "K3"], span, names, order,
                              scans, dev, host, scans * len(filed))
    assert out["launches_whole"] == [4, 5]
    assert out["device_ms_a_scan.surface"] == pytest.approx(2e-3)
    assert out["kernels_run"] == 9
    # a body's names come from its nodes' mangled names, as the profiler's
    assert layers.demangle("_ZN2at6native18elementwise_kernelEv") == \
        "at::native::elementwise_kernel()"
    assert layers.demangle("set_conditional_kernel") == \
        "set_conditional_kernel"



def test_a_body_s_record_named_after_another_graph_s_body_aligns():
    """CUPTI may name a record of an IF node's body after a body kernel of a
    graph captured earlier in the process: such a record (its name among
    `foreign`) still stands where the IF node does, so the launch is whole
    and the span reads its own nodes; without `foreign` it is not whole.
    A foreign name that is the next kernel node's is that node's."""
    kernels = K.load()
    scans, order, node = 2, [], 0
    for _ in range(scans):
        order += [("k0", node), (FUNCTIONS["K2"], node + 1),
                  (None, node + 2, ["b0", "b1"]), (FUNCTIONS["K3"], node + 3)]
        node += 4
    names = [e[0] for e in order if e[0] is not None]
    span = {"surface": {e[1] for e in order if e[0] == "k0"}}
    host = [SimpleNamespace(id=1000, name="cudaGraphLaunch",
                            time_range=_Range(0, 5.0))]
    dev, t = [], 0
    for k in range(scans):
        for name in ["k0", FUNCTIONS["K2"], "rebuild_k2", "b1",
                     FUNCTIONS["K3"]]:
            t += 1
            dev.append(SimpleNamespace(
                id=1000, name=name,
                time_range=_Range(t, 2.0 if name == "k0" else 9.0)))
    foreign = frozenset({"b0", "b1", "rebuild_k2"})
    out = layers.read_replays(kernels, ["K2", "K3"], span, names, order,
                              scans, dev, host, scans, foreign)
    assert out["launches_whole"] == [1, 1]
    assert out["device_ms_a_scan.surface"] == pytest.approx(2e-3)
    out = layers.read_replays(kernels, ["K2", "K3"], span, names, order,
                              scans, dev, host, scans)
    assert out["launches_whole"] == [0, 1]
    assert out["device_ms_a_scan.surface"] is None
    run = [("k0", None, 1.0), (FUNCTIONS["K3"], "K3", 1.0)]
    chain = [("k0", 0), (None, 1, ["b0"]), (FUNCTIONS["K3"], 2)]
    assert layers.align(run, chain, kernels,
                        frozenset({FUNCTIONS["K3"]})) == [chain[0], chain[2]]
    # a kernel node's record named after another graph's body kernel
    run = [("k0", None, 1.0), ("rebuild_k2", None, 1.0)]
    chain = [("k0", 0), (FUNCTIONS["K3"], 1)]
    assert layers.align(run, chain, kernels, foreign) == chain
    why = []
    assert layers.align(run, chain, kernels, why=why) is None
    assert why == [dict(record=1, node=FUNCTIONS["K3"], got="rebuild_k2")]

def test_a_graph_of_the_whole_log_is_read_a_scan():
    """read_replays on two replays that each launch one graph of 3 scans:
    a kernel's time is the mean of its records times its nodes over the
    scans the graph holds, a span's the mean over whole launches over those
    scans, the graph's counts a scan too; the device records and the
    host's calls go over all the scans run.  The launch of which a record
    was dropped is left out of the span."""
    kernels = K.load()
    scan = [None, "K2", None, "K3"]         # a scan's kernel nodes
    scans, replays = 3, 2
    names = [FUNCTIONS.get(g, f"k{j}") for j, g in enumerate(scan)] * scans
    order = [(name, node) for node, name in enumerate(names)]
    span = {"surface": {node for node in range(len(names)) if node % 4 == 2}}
    host, dev, t = [], [], 0
    for r in range(replays):
        for _ in range(3):                  # the inputs copied in
            host.append(SimpleNamespace(id=0, name="cudaMemcpyAsync",
                                        time_range=_Range(t, 1.0)))
        launch = 1000 + r
        host.append(SimpleNamespace(id=launch, name="cudaGraphLaunch",
                                    time_range=_Range(t, 5.0)))
        for node, name in enumerate(names):
            t += 1
            dev.append(SimpleNamespace(
                id=launch, name=name,
                time_range=_Range(t, 10.0 * (node % 4 + 1) + r)))
    dev.remove(next(e for e in dev if e.id == 1001 and e.name == "k0"))
    out = layers.read_replays(kernels, ["K2", "K3"], span, names, order,
                              scans, dev, host, scans * replays)
    assert out["device_ms_a_scan.K2"] == pytest.approx(20.5e-3)
    assert out["device_ms_a_scan.K3"] == pytest.approx(40.5e-3)
    assert out["device_ms_a_scan.surface"] == pytest.approx(30e-3)
    total = sum(e.time_range.us for e in dev) / (scans * replays) / 1e3
    assert out["device_ms_a_scan.total"] == pytest.approx(total)
    assert out["device_ms_a_scan.glue"] == pytest.approx(
        total - (20.5 + 40.5 + 30) * 1e-3)
    assert out["host_launches_a_scan"] == pytest.approx(8 / 6)
    assert out["kernels_a_scan"] == {"K2": 1, "K3": 1, "all": 4}
    assert out["profiler_records_a_scan"] == {"K2": 1, "K3": 1}
    assert out["launches_whole"] == [1, 2] and out["scans_in_graph"] == 3

def _k1_args(g_f, p, nearest, seed):
    rng = np.random.default_rng(seed)
    h, w, b = 23, 31, 17
    field = torch.from_numpy(rng.normal(size=(g_f, h, w)).astype(np.float32))
    ang = rng.uniform(-np.pi, np.pi, b)
    rng_m = rng.uniform(0.1, 1.2, b)
    px = torch.from_numpy((rng_m * np.cos(ang)).astype(np.float32))
    py = torch.from_numpy((rng_m * np.sin(ang)).astype(np.float32))
    use = torch.from_numpy(rng.random(b) < 0.8)
    pose0 = torch.from_numpy(np.stack(
        [rng.uniform(-0.6, 0.6, p), rng.uniform(-0.6, 0.6, p),
         rng.uniform(-3, 3, p)], 1).astype(np.float32))
    offs = [torch.from_numpy(rng.uniform(-0.1, 0.1, (p, k)).astype(
        np.float32)) for k in (3, 4, 2)]
    kw = dict(resolution=0.05, origin=(-0.775, -0.575), max_range=10.0,
              nearest=nearest)
    return (field, px, py, use, pose0, *offs), kw


def _cells_by_loop(args, kw):
    """The field cells the plain version's taps read, one tap at a time."""
    field, px, py, use, pose0, dxs, dys, dts = (a.double().numpy()
                                                if a.is_floating_point()
                                                else a.numpy() for a in args)
    g, h, w = field.shape
    p = pose0.shape[0]
    res, (ox, oy) = kw["resolution"], kw["origin"]
    seen = set()
    for i in range(p):
        for t in dts[i]:
            th = pose0[i, 2] + t
            for bx, by, u in zip(px, py, use):
                if not u:
                    continue
                rx = bx * np.cos(th) - by * np.sin(th)
                ry = bx * np.sin(th) + by * np.cos(th)
                for dx in dxs[i]:
                    for dy in dys[i]:
                        fx = (rx + pose0[i, 0] + dx - ox) / res - 0.5
                        fy = (ry + pose0[i, 1] + dy - oy) / res - 0.5
                        if kw["nearest"]:
                            taps = [(round(fx), round(fy))]
                        else:
                            x0, y0 = int(np.floor(fx)), int(np.floor(fy))
                            taps = [(x0, y0), (x0 + 1, y0), (x0, y0 + 1),
                                    (x0 + 1, y0 + 1)]
                        for x, y in taps:
                            if 0 <= x < w and 0 <= y < h:
                                seen.add((i // (p // g), y, x))
    return len(seen)


@pytest.mark.parametrize("g_f,nearest", [(6, False), (1, True)])
def test_k1_bound_counts_the_cells_its_taps_read(monkeypatch, g_f, nearest):
    args, kw = _k1_args(g_f, 6, nearest, seed=3)
    monkeypatch.setattr(k1, "K1_BLOCK_TAPS", 2000)   # several blocks
    cells_read = k1.k1_cells(args, kw)
    # float64 coordinates may round a tap on a cell edge the other way
    assert abs(cells_read - _cells_by_loop(args, kw)) <= 2
    assert 0 < cells_read < args[0].numel()
    ms, by = k1.k1_bound(args, kw)
    others = bounds.nbytes(args[1:]) + 6 * 3 * 4 * 2 * 4
    assert ms == pytest.approx(max(
        k1.k1_samples(args, kw) / bounds.FP32_FLOPS,
        (cells_read * 4 + others) / bounds.HBM_BYTES_PER_S) * 1e3)
    # past the budget the whole field counts
    monkeypatch.setattr(k1, "K1_TAP_BUDGET", 10)
    assert k1.k1_cells(args, kw) is None
    whole, _ = k1.k1_bound(args, kw)
    assert whole >= ms
    assert kmatch.stage_scores_batch(*args, **kw).shape == (6, 2, 4, 3)


def _record(cell, particles, sps):
    return dict(cell=cell, particles=particles, correct=True,
                scans_per_sec=dict(value=sps), setup_s=1.0,
                peak_device_gb=0.1, ate_m=dict(max=0.01),
                kernels_agree=True)


@pytest.mark.parametrize("order", [0, 1])
def test_the_line_heads_with_the_fastest_of_most_particles(order):
    """bench.py:530-533: the cell of most particles, among equal counts
    the fastest, whatever order the cells ran in."""
    recs = [_record("city_surface", 1_000_000, 238.0),
            _record("mega_surface", 1_000_000, 425.0),
            _record("chip", 10_000, 71.0), _record("parity", 500, 750.0)]
    recs = recs if order == 0 else recs[::-1]
    line = run.last_line(recs + [dict(cell="x", correct=False,
                                      error="boom")],
                         torch.device("cpu"), False)
    assert line["cell"] == "mega_surface" and line["value"] == 425.0
    assert line["vs_baseline"] == round(425.0 / 0.0005, 2)
    assert run.head_cell(recs[:0]) is None
    empty = run.last_line([], torch.device("cpu"), False)
    assert empty["cell"] is None and empty["vs_baseline"] is None


@pytest.mark.parametrize("sps,particles", [
    (425.3, 1_000_000), (71.24, 10_000), (750.0, 500), (0.05, 50),
    (3.5, 16)])
def test_baseline_is_bench_py_s(sps, particles):
    want = bench.result_line(sps, particles, skip_oracle=False)
    got = baseline.baseline_fields(sps, particles)
    assert got == {k: want[k] for k in baseline.FIELDS}
    # the Java reference's assumed rate is the larger at every P
    assert got["vs_baseline"] == round(sps * particles / 500.0, 2)


def test_oracle_rate_is_bench_py_s_record(monkeypatch, tmp_path):
    """The port's copy of the oracle's recorded rate is bench.py's, byte
    for byte; it is read, scaled 1/P, and a missing copy raises."""
    assert baseline.ORACLE.read_bytes() == bench.ORACLE_CACHE.read_bytes()
    rec = json.loads(baseline.ORACLE.read_text())
    assert baseline.oracle_baseline(rec["probe_particles"] * 4) == (
        pytest.approx(rec["scans_per_sec"] / 4), rec["probe_particles"])
    missing = tmp_path / "oracle_baseline.json"
    with pytest.raises(FileNotFoundError):
        baseline.oracle_baseline(100, missing)
    monkeypatch.setattr(baseline, "ORACLE", missing)
    with pytest.raises(FileNotFoundError):
        baseline.baseline_fields(1.0, 100)


def _k1_kernel_and_control(args, kw):
    """K1's plain version, and a control: the same reading its field
    rounded to bf16."""
    plain = kmatch.stage_scores_batch_plain

    def control(field, *rest, **kw):
        return plain(field.to(torch.bfloat16).float(), *rest, **kw)
    return plain, control


@pytest.mark.parametrize("control", [False, True])
def test_k1_agreement_on_a_sliced_call(monkeypatch, control):
    """Past FULL_PARTICLES (made small here) a K1 call is held on its
    first and last SLICE_PARTICLES: the same row as the whole comparison
    of a call of those particles alone; a control still fails."""
    monkeypatch.setattr(bounds, "FULL_PARTICLES", 8)
    monkeypatch.setattr(bounds, "SLICE_PARTICLES", 3)
    kernels = K.load()
    entry = kernels["K1"].entries[0]
    args, kw = _k1_args(2, 12, False, seed=5)
    plain, wrong = _k1_kernel_and_control(args, kw)
    real = wrong if control else plain
    parts = entry.parts(args)
    assert [(a, n) for a, n, _ in parts] == [(0, 3), (9, 3)]
    # the first and last 3 particles alone: a call of 6 that fits whole
    rows = torch.cat([torch.arange(3), torch.arange(9, 12)])
    field = args[0][[0, 1]]       # particles 0-2 on field 0, 9-11 on 1
    pose0, dxs, dys, dts = (x[rows] for x in args[4:])
    small = (field, *args[1:4], pose0, dxs, dys, dts)
    assert entry.parts(small) is None
    got = {}
    for name, call_args in (("sliced", args), ("whole", small)):
        agreement = K.Agreement(kernels)
        out = agreement.wrap("K1", entry, real)(*call_args, **kw)
        assert out.shape[0] == call_args[4].shape[0]
        got[name] = agreement.rows["K1"]
    assert got["sliced"] == got["whole"]
    assert got["sliced"]["ok"] is (not control)
    if control:
        assert got["sliced"]["share"] > 0.01


def test_k2_window_bound_counts_the_window():
    """K2's window variant touches its window alone, in place or not: its
    bound counts the window's cells read and written, the pose, the
    window's place and the tables, never the whole map."""
    from gridmap_slam_tpu_torch.bench.kernels import k2
    lo = torch.zeros(400, 500)
    win = torch.tensor([10, 20])
    tables = [torch.zeros(64) for _ in range(3)]
    args = (lo, win, torch.zeros(3), 1.0, *tables)
    want = bounds.bound(k2.K2_FLOPS_CELL * 30 * 40,
                        2 * 30 * 40 * 4 + bounds.nbytes(args[1:]))
    for out in (None, lo, lo.clone()):
        kw = dict(size=(30, 40), out=out)
        assert k2.k2w_bound(args, kw) == want
