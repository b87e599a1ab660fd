"""The PyTorch port's copies of the jax-free modules, held to the originals.

config.py, io/recording.py, io/synthetic.py and utils/metrics.py are copied
into gridmap_slam_tpu_torch (importing the JAX package loads jax and flax);
these tests keep the copies from drifting, and check that the port imports
without jax.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gridmap_slam_tpu.config as jcfg
import gridmap_slam_tpu_torch.config as tcfg
from gridmap_slam_tpu.io import frames_to_device as j_frames_to_device
from gridmap_slam_tpu.io.recording import read_recording as j_read_recording
from gridmap_slam_tpu.io.synthetic import (default_world as j_world,
                                           multi_room_world as j_multi_room,
                                           simulate_log as j_simulate,
                                           square_path_controls as j_square)
from gridmap_slam_tpu.types import Scan as JScan
from gridmap_slam_tpu.utils import metrics as jmetrics
from gridmap_slam_tpu_torch.convert import config_from_jax
from gridmap_slam_tpu_torch.io import frame_at, frames_to_device, read_recording
from gridmap_slam_tpu_torch.io.recording import write_recording
from gridmap_slam_tpu_torch.io.synthetic import (default_world,
                                                 multi_room_world,
                                                 simulate_log,
                                                 square_path_controls)
from gridmap_slam_tpu_torch.types import Scan
from gridmap_slam_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

_DERIVED = {"sensor": ("l_free", "l_occ"),
            "map": ("cells_x", "cells_y", "likelihood_sigma",
                    "likelihood_radius"),
            "matcher": ("z_random",)}


@pytest.mark.parametrize("make", ["SlamConfig", "reference_parity_config",
                                  "pr1_config", "chip_config"])
def test_config_copy_matches(make):
    j, t = getattr(jcfg, make)(), getattr(tcfg, make)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for section, props in _DERIVED.items():
        for prop in props:
            assert (getattr(getattr(j, section), prop)
                    == getattr(getattr(t, section), prop)), (section, prop)
    assert config_from_jax(j) == t


def test_config_overrides_match():
    over = jcfg.SlamConfig.parse_overrides(
        ["num_particles=64", "map.resolution=0.1", "matcher.z_hit=0.95"])
    assert over == tcfg.SlamConfig.parse_overrides(
        ["num_particles=64", "map.resolution=0.1", "matcher.z_hit=0.95"])
    j = jcfg.SlamConfig().with_overrides(over)
    t = tcfg.SlamConfig().with_overrides(over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.map.cells_x == t.map.cells_x == 60


def test_simulate_log_copy_matches():
    jf, jgt = j_simulate(j_world(), j_square(8), seed=7)
    tf, tgt = simulate_log(default_world(), square_path_controls(8), seed=7)
    np.testing.assert_array_equal(jgt, tgt)
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert (a.t, a.d_center, a.d_theta) == (b.t, b.d_center, b.d_theta)
        np.testing.assert_array_equal(a.angle, b.angle)
        np.testing.assert_array_equal(a.dist, b.dist)
        np.testing.assert_array_equal(a.hit, b.hit)


@pytest.mark.parametrize("rooms", [(2, 1, 6.0, 1.0), (3, 3, 6.0, 1.0),
                                   (4, 2, 5.0, 0.8)])
def test_multi_room_world_copy_matches(rooms):
    np.testing.assert_array_equal(j_multi_room(*rooms),
                                  multi_room_world(*rooms))
    jf, jgt = j_simulate(j_multi_room(*rooms), j_square(2), seed=3)
    tf, tgt = simulate_log(multi_room_world(*rooms), square_path_controls(2),
                           seed=3)
    np.testing.assert_array_equal(jgt, tgt)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(a.dist, b.dist)


@pytest.mark.parametrize("preset", ["mega", "city"])
def test_surface_presets_match_bench(preset):
    """mega_config / city_config carry the values bench.py --preset mega /
    city gives the JAX engine (bench.py:124-128, :626-640)."""
    import bench
    size, crop = {"mega": (6.0, 0), "city": (200.0, 512)}[preset]
    refine = 0 if preset == "mega" else -1     # city keeps the default
    jcfg, _, _ = bench.make_engine(1_000_000, 0, size, "surface", crop=crop,
                                   refine_steps=refine)
    assert config_from_jax(jcfg) == getattr(tcfg, f"{preset}_config")()


def test_read_recording_matches_python_parser(tmp_path):
    jf = j_read_recording("maps/room_loop_40.rec", native="off")
    tf = read_recording("maps/room_loop_40.rec")
    assert len(jf) == len(tf) == 40
    for a, b in zip(jf, tf):
        assert (a.t, a.d_center, a.d_theta) == (b.t, b.d_center, b.d_theta)
        for f in ("angle", "dist", "hit"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # the port's writer round-trips to the same bytes
    p = tmp_path / "copy.rec"
    write_recording(p, tf)
    assert p.read_bytes() == open("maps/room_loop_40.rec", "rb").read()


def test_frames_to_device_matches():
    frames = read_recording("maps/room_loop_40.rec")[:5]
    jb = j_frames_to_device(frames, 192, 10.0)
    tb = frames_to_device(frames, 192, 10.0)
    for jv, tv in ((jb.scan.angle, tb.scan.angle), (jb.scan.dist, tb.scan.dist),
                   (jb.scan.hit, tb.scan.hit), (jb.scan.valid, tb.scan.valid),
                   (jb.odom.d_center, tb.odom.d_center),
                   (jb.odom.d_theta, tb.odom.d_theta), (jb.t, tb.t)):
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    f = frame_at(tb, 3)
    np.testing.assert_array_equal(f.scan.dist.numpy(),
                                  np.asarray(jb.scan.dist[3]))
    assert f.odom.d_theta.shape == ()


def test_scan_from_arrays_matches():
    rng = np.random.default_rng(0)
    ang, dist = rng.uniform(-3, 3, 50), rng.uniform(0.1, 9, 50)
    hit = rng.uniform(size=50) > 0.3
    for width in (32, 64):
        j = JScan.from_arrays(ang, dist, hit, max_beams=width)
        t = Scan.from_arrays(ang, dist, hit, max_beams=width)
        for f in ("angle", "dist", "hit", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy())


def test_metrics_copy_matches():
    rng = np.random.default_rng(3)
    est, gt = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for align in (False, True):
        assert (jmetrics.ate_rmse(est, gt, align=align)
                == tmetrics.ate_rmse(est, gt, align=align))
    np.testing.assert_array_equal(jmetrics.align_se2(est[:, :2], gt[:, :2]),
                                  tmetrics.align_se2(est[:, :2], gt[:, :2]))


def test_port_imports_without_jax():
    code = ("import gridmap_slam_tpu_torch, gridmap_slam_tpu_torch.models.rbpf,"
            " gridmap_slam_tpu_torch.models.shared,"
            " gridmap_slam_tpu_torch.ops.surface,"
            " gridmap_slam_tpu_torch.ops.cuda.matcher,"
            " gridmap_slam_tpu_torch.ops.cuda.likelihood,"
            " gridmap_slam_tpu_torch.ops.cuda.grid_update,"
            " gridmap_slam_tpu_torch.convert, gridmap_slam_tpu_torch.io,"
            " gridmap_slam_tpu_torch.io.synthetic,"
            " gridmap_slam_tpu_torch.utils.metrics, sys\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax')"
            " for m in sys.modules), sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
