"""The PyTorch port's application layer on the CPU: the CLI held to the JAX
package's CLI (the same recording bytes, map checkpoint bytes, metrics keys,
and ATEs within the cross-backend 0.06 m of docs/DIVERGENCES.md), the CLI's
own cases (the counterparts of tests/test_app.py), the live path through the
loopback robot, the recorder, teleop, live view, application lifecycle, the
PNG writer without matplotlib, and the metrics logger and profiler."""

import io
import json
import os
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from gridmap_slam_tpu.app.cli import main as j_main
from gridmap_slam_tpu.io import read_map_checkpoint as j_read_map
from gridmap_slam_tpu.io import write_map_checkpoint as j_write_map
from gridmap_slam_tpu_torch.app.cli import MESH_ENGINES, main
from gridmap_slam_tpu_torch.io import (read_map_checkpoint,
                                       write_map_checkpoint)
from gridmap_slam_tpu_torch.io.recording import RecordedFrame
from gridmap_slam_tpu_torch.io.synthetic import default_world

torch.set_num_threads(1)

SMALL = ["--particles", "6", "--max-beams", "64"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def synth_log(tmp_path_factory):
    """A 4-revolution synthetic log written by the port's synth command."""
    out = tmp_path_factory.mktemp("synth")
    state, traj, metrics = main(["synth", "--revs", "4", "--beams", "60",
                                 *SMALL, "--out", str(out), "--save-log",
                                 str(out / "log.rec"), *CPU])
    return out, metrics


def _frame(t, n=5):
    rng = np.random.RandomState(int(t * 100) + 1)
    return RecordedFrame(t=t, d_center=0.1, d_theta=0.0,
                         angle=rng.uniform(-3, 3, n), dist=rng.uniform(1, 5, n),
                         hit=np.ones(n, bool))


# ------------------------------------------------------------ the CLI vs JAX
def test_cli_synth_matches_jax(tmp_path, synth_log):
    out, metrics = synth_log
    j_main(["synth", "--revs", "4", "--beams", "60", *SMALL, "--out",
            str(tmp_path), "--save-log", str(tmp_path / "log.rec")])
    assert (out / "log.rec").read_bytes() == (tmp_path / "log.rec").read_bytes()
    want = json.loads((tmp_path / "synth_metrics.json").read_text())
    got = json.loads((out / "synth_metrics.json").read_text())
    assert got == metrics and sorted(got) == sorted(want)
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) < 0.06
    assert got["frames"] == want["frames"] == 4
    for name in ("synth_map.png", "synth_trajectory.npy"):
        assert (out / name).exists()


def test_map_checkpoint_writers_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    lo = rng.normal(size=(50, 60)) * 3
    params = {"width_m": 3.0, "height_m": 2.5, "resolution": 0.05,
              "origin": (-1.5, -1.25)}
    write_map_checkpoint(tmp_path / "t.map", params, lo)
    j_write_map(tmp_path / "j.map", params, lo)
    assert (tmp_path / "t.map").read_bytes() == (tmp_path / "j.map").read_bytes()
    p, got = read_map_checkpoint(tmp_path / "j.map")
    jp, want = j_read_map(tmp_path / "t.map")
    assert p == jp
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lo)


def test_cli_replay_save_and_load_map(tmp_path, synth_log):
    """replay --save-map writes the best map in the reference format (JAX's
    reader reads it back as the port's best map), with the likelihood view
    and the combined map select; --load-map starts from it, and a checkpoint
    of another geometry is refused."""
    log = str(synth_log[0] / "log.rec")
    ckpt = tmp_path / "map.ckpt"
    state, traj, metrics = main(
        ["replay", "--log", log, *SMALL, "--out", str(tmp_path),
         "--save-map", str(ckpt), "--map-view", "likelihood",
         "--map-select", "combined", *CPU])
    params, lo = j_read_map(ckpt)
    best = state.logodds[torch.argmax(state.log_weights)]
    np.testing.assert_array_equal(lo, best.numpy().astype(np.float64))
    assert params["resolution"] == pytest.approx(0.05)
    assert (lo > 0).sum() > 20 and (lo < 0).sum() > 200
    for name in ("replay_map.png", "replay_likelihood.png",
                 "replay_trajectory.npy", "replay_metrics.json"):
        assert (tmp_path / name).exists()
    np.testing.assert_array_equal(np.load(tmp_path / "replay_trajectory.npy"),
                                  traj)

    state2, traj2, _ = main(["replay", "--log", log, *SMALL, "--out",
                             str(tmp_path / "l"), "--load-map", str(ckpt),
                             *CPU])
    assert np.isfinite(traj2).all() and len(traj2) == len(traj)
    assert state2.logodds.shape == state.logodds.shape

    with pytest.raises(SystemExit, match="geometry mismatch"):
        main(["replay", "--log", log, *SMALL, "--out", str(tmp_path / "x"),
              "--load-map", str(ckpt), "--map-size", "5", *CPU])


# ------------------------------------------------------ the CLI's own cases
def test_cli_map_select_specific(tmp_path):
    """--map-select <index> dumps that particle's own map."""
    out = tmp_path / "out"
    main(["synth", "--revs", "3", "--beams", "60", "--particles", "8",
          "--max-beams", "64", "--out", str(out), "--map-select", "3", *CPU])
    assert (out / "synth_map.png").exists()
    with pytest.raises(SystemExit):
        main(["synth", "--revs", "3", "--particles", "8", "--out", str(out),
              "--map-select", "3", "--engine", "shared", *CPU])


@pytest.mark.parametrize("engine", ["surface", "shared"])
def test_cli_shared_map_engines(tmp_path, engine):
    out = tmp_path / "out"
    extra = (["--set", "matcher.surface_nt=9"] if engine == "surface"
             else ["--max-beams", "64"])
    state, traj, metrics = main(
        ["synth", "--revs", "3", "--beams", "60", "--particles", "64",
         "--engine", engine, "--out", str(out), "--set",
         "sensor.max_range=5.0", "--resolution", "0.1", *extra, *CPU])
    assert (out / "synth_map.png").exists()
    assert state.logodds.ndim == 2            # one shared map
    assert json.loads((out / "synth_metrics.json").read_text())[
        "ate_rmse_m"] == metrics["ate_rmse_m"] < 0.5


def test_cli_posegraph_synthetic_loop(tmp_path, capsys):
    summary = main(["posegraph", "--revs", "4", "--beams", "60",
                    "--particles", "8", "--max-beams", "64", "--out",
                    str(tmp_path), *CPU])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    assert summary["keyframes"] >= 2
    assert np.isfinite([summary["chi2_first"], summary["chi2_last"]]).all()
    assert summary["online_ate_m"] < 0.1
    for name in ("pg_online_map.png", "pg_optimized_map.png"):
        assert (tmp_path / name).exists()


@pytest.mark.parametrize("engine", MESH_ENGINES)
def test_cli_distributed_engines_exit_nonzero(tmp_path, synth_log, engine):
    """--devices 8 on a world of one rank: refused with the reason."""
    with pytest.raises(SystemExit, match="needs a world of 8 ranks"):
        main(["replay", "--log", str(synth_log[0] / "log.rec"), *SMALL,
              "--out", str(tmp_path), "--engine", engine, "--devices", "8",
              "--map-shards", "4", *CPU])


@pytest.mark.parametrize("flag", [["--map-shards", "4"], ["--devices", "2"]])
def test_cli_mesh_flags_are_not_dropped(tmp_path, synth_log, flag):
    with pytest.raises(SystemExit, match="one device"):
        main(["replay", "--log", str(synth_log[0] / "log.rec"), *SMALL,
              "--out", str(tmp_path), *flag, *CPU])


def test_cli_runs_on_the_card_by_default(tmp_path, synth_log):
    """No --device: the engine is built on CUDA, which raises where there is
    no card (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    with pytest.raises((AssertionError, RuntimeError)):
        main(["replay", "--log", str(synth_log[0] / "log.rec"), *SMALL,
              "--out", str(tmp_path)])


def test_cli_live_through_loopback(tmp_path, monkeypatch, capsys):
    """`live` end to end: the loopback robot stands behind RobotLink.connect,
    frames are recorded and SLAM runs on each."""
    from gridmap_slam_tpu_torch.app import pipeline
    from gridmap_slam_tpu_torch.app.pipeline import LoopbackRobot, RobotLink

    robot = LoopbackRobot(default_world(), range_noise_sd=0.0)
    monkeypatch.setattr(pipeline.RobotLink, "connect",
                        classmethod(lambda cls, host, port: cls(
                            robot.host_sock)))
    # `live` waits for its frames without a deadline: run it in a thread
    # that this test can give up on
    errors = []

    def run():
        try:
            main(["live", "--scans", "3", "--degrees", "4", *SMALL, "--out",
                  str(tmp_path), "--record", "live.rec", *CPU])
        except BaseException as e:          # reported below
            errors.append(e)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=60.0)
    robot.close()
    assert not worker.is_alive(), "live did not get 3 frames in 60 s"
    assert not errors, errors
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] >= 3 and np.isfinite(out["final_pose"]).all()
    assert (tmp_path / "live_map.png").exists()
    assert np.load(tmp_path / "live_trajectory.npy").shape[0] >= 3
    assert (tmp_path / "live.rec").exists()


# ------------------------------------------------ the captured step
def _eager_run(eng, frames, seed, state=None):
    """The engine's eager step (as the engine routes it) called directly
    over host frames from `state` (default eng.init()), drawing from one
    generator seeded `seed`, as the CLI's run: (state, trajectory, Neffs)."""
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device

    cfg = eng.config
    b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    gen = torch.Generator().manual_seed(seed)
    st = eng.init() if state is None else state
    traj, neffs = [], []
    for i in range(len(frames)):
        st, info = eng.step(st, frame_at(b, i), gen)
        traj.append(info.weighted_pose.numpy())
        neffs.append(float(info.neff))
    return st, np.stack(traj), neffs


@pytest.fixture
def captured_steps(monkeypatch):
    """The (engine, step) pairs application.compiled_step hands out."""
    from gridmap_slam_tpu_torch.app import application
    real = application.compiled_step
    taken = []

    def spy(engine):
        taken.append((engine, real(engine)))
        return taken[-1][1]
    monkeypatch.setattr(application, "compiled_step", spy)
    return taken


@pytest.mark.parametrize("case", ["replay_rbpf", "replay_surface", "synth",
                                  "posegraph"])
def test_cli_steps_through_the_captured_step(tmp_path, synth_log,
                                             captured_steps, case):
    """replay (RBPF and surface), synth and posegraph's filter run the
    engine's step captured (step_jit: on the CPU its static-buffer loop)
    and give the eager step's trajectory, metrics but the times, and saved
    map bit for bit."""
    from gridmap_slam_tpu_torch.io import read_map_checkpoint, read_recording
    from gridmap_slam_tpu_torch.io.synthetic import (SimParams,
                                                     simulate_log,
                                                     square_path_controls)
    from gridmap_slam_tpu_torch.utils.metrics import ate_rmse

    log = str(synth_log[0] / "log.rec")
    out = tmp_path / "out"
    sim = ["--revs", "4", "--beams", "60"]
    surface = ["--engine", "surface", "--particles", "64", "--set",
               "matcher.surface_nt=9", "--set", "sensor.max_range=5.0",
               "--resolution", "0.1", "--max-beams", "64"]
    argv, label = {
        "replay_rbpf": (["replay", "--log", log, *SMALL, "--save-map",
                         str(tmp_path / "m.map")], "replay"),
        "replay_surface": (["replay", "--log", log, *surface, "--save-map",
                            str(tmp_path / "m.map")], "replay"),
        "synth": (["synth", *sim, *SMALL], "synth"),
        "posegraph": (["posegraph", *sim, "--particles", "8",
                       "--max-beams", "64"], "pg_online"),
    }[case]
    main([*argv, "--out", str(out), "--seed", "3", *CPU])
    (eng, step), = captured_steps
    assert step.captured.captures == 0 and step.captured.capacity == 1
    if case.startswith("replay"):
        frames, gt = read_recording(log), None
    else:
        frames, gt = simulate_log(default_world(), square_path_controls(4),
                                  params=SimParams(beams_per_rev=60), seed=3)
    state, traj, neffs = _eager_run(eng, frames, 3)
    np.testing.assert_array_equal(np.load(out / f"{label}_trajectory.npy"),
                                  traj)
    metrics = json.loads((out / f"{label}_metrics.json").read_text())
    assert metrics["frames"] == len(frames)
    assert metrics["final_neff"] == neffs[-1]
    assert metrics["final_pose"] == traj[-1].tolist()
    if gt is not None:
        assert metrics["ate_rmse_m"] == ate_rmse(traj, gt)
    if case.startswith("replay"):
        _, saved = read_map_checkpoint(tmp_path / "m.map")
        np.testing.assert_array_equal(
            saved, eng.best_map(state).numpy().astype(np.float64))


@pytest.mark.parametrize("engine", MESH_ENGINES)
def test_cli_mesh_engines_step_through_the_captured_step(
        tmp_path, synth_log, captured_steps, capsys, engine):
    """replay --engine shmap|shmap-surface|tiled|surface-sharded on a
    world of one: the CLI steps through the engine's compiled step
    (step_jit: make_*_step(..., jit=True), on the CPU its static-buffer
    loop) and gives the eager step's trajectory, printed metrics but the
    times, and map bit for bit."""
    from gridmap_slam_tpu_torch.io import read_recording

    log = str(synth_log[0] / "log.rec")
    state, traj, metrics = main(
        ["replay", "--log", log, *SMALL, "--engine", engine, "--set",
         "matcher.surface_nt=7", "--out", str(tmp_path), "--seed", "3",
         *CPU])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == metrics
    (eng, step), = captured_steps
    assert step.captured.captures == 0 and step.captured.capacity == 1
    st, want, neffs = _eager_run(eng, read_recording(log), 3)
    np.testing.assert_array_equal(traj, want)
    np.testing.assert_array_equal(np.load(tmp_path / "replay_trajectory.npy"),
                                  want)
    assert metrics["final_neff"] == neffs[-1]
    assert metrics["final_pose"] == want[-1].tolist()
    assert torch.equal(state.logodds, eng.gather(st).logodds)


def test_compiled_step_needs_step_jit():
    """An engine without step_jit raises: no eager step in its place."""
    from gridmap_slam_tpu_torch.app.application import compiled_step

    class Eager:
        def step(self, state, frame, generator=None):
            return state, None

    with pytest.raises(AttributeError, match="step_jit"):
        compiled_step(Eager())


def test_application_steps_through_the_captured_step(captured_steps):
    """SlamApplication fed by the loopback robot through RobotLink and
    SlamPipeline steps through the captured step (captured at its first
    frame) and gives the eager step's states and trajectory."""
    from gridmap_slam_tpu_torch import RBPF, SlamConfig
    from gridmap_slam_tpu_torch.app.application import SlamApplication
    from gridmap_slam_tpu_torch.app.pipeline import (LoopbackRobot,
                                                     RobotLink, SlamPipeline)

    robot = LoopbackRobot(default_world(), range_noise_sd=0.01)
    link = RobotLink(robot.host_sock)
    pipe = SlamPipeline(link)
    cfg = SlamConfig(num_particles=8, max_beams=64)
    app = SlamApplication(cfg, RBPF(cfg, device="cpu"))
    app.init(seed=5)
    frames = []
    pipe.subscribe(frames.append)
    pipe.subscribe(app.on_frame)
    pipe.start()
    try:
        link.set_resolution(4)
        link.set_speeds(1.0, 1.0)
        link.sensor_enable()
        deadline = time.monotonic() + 60.0
        while app.frames_seen < 4 and time.monotonic() < deadline:
            pipe.handle_events(1)
            time.sleep(0.002)
        link.sensor_disable()
    finally:
        app.dispose()
        pipe.stop()
        link.close()
        robot.close()
    assert app.frames_seen == len(frames) >= 4
    (eng, step), = captured_steps
    assert step is app._step and step.captured.capacity == 1
    state, traj, _ = _eager_run(eng, frames, 5)
    np.testing.assert_array_equal(app.trajectory_array(), traj)
    for name in ("poses", "log_weights", "logodds", "step"):
        assert torch.equal(getattr(app.state, name), getattr(state, name))


# ------------------------------------------------ copies of the app shell
class TestRecorder:
    def test_record_and_save_load(self, tmp_path):
        from gridmap_slam_tpu_torch.app.recorder import DataRecorder

        rec = DataRecorder([].append, directory=tmp_path)
        rec.begin_record()
        for _ in range(4):
            rec.update(0.5)
            rec.on_frame(_frame(0.0))
        assert rec.frame_counter == 4
        path = rec.save("run1")
        assert path.exists() and rec.list_recordings() == ["run1"]
        assert rec.load(path) == 4
        assert [f.t for f in rec.frames] == [0.5, 1.0, 1.5, 2.0]

    def test_replay_timing_and_all(self, tmp_path):
        from gridmap_slam_tpu_torch.app.recorder import DataRecorder, State

        published = []
        rec = DataRecorder(published.append, directory=tmp_path)
        rec.frames = [_frame(0.5), _frame(1.0)]
        rec.begin_replay()
        assert rec.update(0.2) is None
        assert rec.update(0.4) is not None
        rec.step_once()
        assert rec.update(0.0) is not None and len(published) == 2
        rec.update(0.1)
        assert rec.state is State.IDLE
        rec.frames = [_frame(0.1), _frame(0.2), _frame(0.3)]
        assert rec.replay_all() == 3 and len(published) == 5


class TestLoopback:
    def test_live_pipeline_end_to_end(self):
        from gridmap_slam_tpu_torch.app.pipeline import (LoopbackRobot,
                                                         RobotLink,
                                                         SlamPipeline)

        robot = LoopbackRobot(default_world(), range_noise_sd=0.0)
        link = RobotLink(robot.host_sock)
        pipe = SlamPipeline(link)
        frames = []
        pipe.subscribe(frames.append)
        pipe.start()
        try:
            link.set_resolution(2)
            link.set_speeds(2.0, 2.0)
            link.sensor_enable()
            deadline = time.monotonic() + 20.0
            while len(frames) < 3 and time.monotonic() < deadline:
                pipe.handle_events(4)
                time.sleep(0.01)
            link.sensor_disable()
        finally:
            pipe.stop()
            link.close()
            robot.close()
        assert len(frames) >= 3
        f = frames[2]
        assert len(f.angle) == 180 and f.hit.all() and f.d_center > 0
        assert 0.05 < f.dist.min() < f.dist.max() < 6.0

    def test_loopback_sensor_once(self):
        from gridmap_slam_tpu_torch.app.pipeline import LoopbackRobot, RobotLink

        robot = LoopbackRobot(default_world())
        link = RobotLink(robot.host_sock)
        try:
            link.set_resolution(4)           # 90 beams
            link.sensor_once()
            frames = []
            deadline = time.monotonic() + 10.0
            while not frames and time.monotonic() < deadline:
                frames = link.poll()
            assert frames and len(frames[0].angle) == 90
        finally:
            link.close()
            robot.close()


class TestTeleop:
    def test_key_to_speeds_mapping(self):
        from gridmap_slam_tpu_torch.app.teleop import key_to_speeds
        v = 5.0
        assert key_to_speeds("w", v) == key_to_speeds("up", v) == (v, v)
        assert key_to_speeds("s", v) == (-v, -v)
        assert key_to_speeds("a", v) == (-v, v)
        assert key_to_speeds("right", v) == (v, -v)
        assert key_to_speeds(" ", v) == (0.0, 0.0)
        assert key_to_speeds("x", v) is None

    def test_controller_sends_on_change_and_trims(self):
        from gridmap_slam_tpu_torch.app.teleop import TeleopController
        sent = []
        t = TeleopController(lambda l, r: sent.append((l, r)), speed=2.0)
        assert t.handle("w") and t.handle("w") and t.handle(" ")
        assert not t.handle("q")
        assert sent == [(2.0, 2.0), (0.0, 0.0)]
        t.handle("w")
        t.handle("+")
        assert sent[-1] == (2.5, 2.5)

    def test_stdin_keys_parse_arrows(self):
        from gridmap_slam_tpu_torch.app.teleop import StdinKeys
        r, w = os.pipe()
        try:
            os.write(w, b"w\x1b[Aq")
            assert StdinKeys(fd=r).poll() == ["w", "up", "q"]
        finally:
            os.close(r)
            os.close(w)


def test_terminal_live_view_renders():
    from gridmap_slam_tpu_torch.utils.liveview import TerminalMapView

    lo = np.zeros((120, 120), np.float32)
    lo[60, :] = 3.0
    lo[30:50, 30:50] = -2.0
    buf = io.StringIO()
    view = TerminalMapView((-3.0, -3.0), 0.05, stream=buf, force=True)
    view.update(lo, pose=np.asarray([0.0, 0.0, 0.5]),
                particles=np.asarray([[0.1, 0.1, 0.0], [-0.2, 0.3, 0.0]]),
                neff=12.3)
    out = buf.getvalue()
    assert "▄" in out and "Neff" in out and "scan 1" in out
    assert "\x1b[91m" in out              # robot marker drawn
    buf2 = io.StringIO()
    ticker = TerminalMapView((-3.0, -3.0), 0.05, stream=buf2, force=False)
    ticker.update(lo, pose=np.asarray([0.0, 0.0, 0.0]), neff=5.0)
    assert "▄" not in buf2.getvalue() and "scan 1" in buf2.getvalue()


def test_application_lifecycle():
    """SlamApplication: init makes the state and a seeded generator on the
    engine's device, on_frame runs one step a frame, render refreshes the
    view, dispose tears down exactly once; the same seed gives the same
    trajectory as a run_log with a generator seeded the same."""
    from gridmap_slam_tpu_torch import RBPF, SlamConfig
    from gridmap_slam_tpu_torch.app.application import SlamApplication
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.io.synthetic import (simulate_log,
                                                     square_path_controls)

    frames, _ = simulate_log(default_world(), square_path_controls(4),
                             seed=0)
    cfg = SlamConfig(num_particles=8)
    eng = RBPF(cfg, device="cpu")

    class SpyView:
        updates = 0
        finished = 0

        def update(self, *a):
            SpyView.updates += 1

        def finish(self):
            SpyView.finished += 1

    disposed = []
    app = SlamApplication(cfg, eng, view=SpyView(),
                          on_dispose=[lambda: disposed.append(1)])
    with pytest.raises(RuntimeError, match="init"):
        app.on_frame(frames[0])
    app.init(seed=3)
    with app:
        for f in frames:
            app.on_frame(f)
            app.render()
        assert app.frames_seen == len(frames)
        tr = app.trajectory_array()
        assert tr.shape == (len(frames), 3) and np.isfinite(tr).all()
        assert app.occupancy().shape == (cfg.map.cells_y, cfg.map.cells_x)
    assert SpyView.updates == len(frames)
    assert SpyView.finished == 1 and disposed == [1]
    app.dispose()                       # idempotent
    assert SpyView.finished == 1 and disposed == [1]
    b = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range)
    _, infos = eng.run_log(eng.init(), [frame_at(b, i)
                                        for i in range(len(frames))],
                           torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        tr, torch.stack([i.weighted_pose for i in infos]).numpy())


# ------------------------------------------------------------- utilities
def _read_png(path):
    """(width, height, pixels (H, W, 3)) of an 8-bit RGB PNG without
    filters, as _write_png writes it."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, off = {}, 8
    while off < len(data):
        (n,) = struct.unpack_from(">I", data, off)
        tag, body = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        (crc,) = struct.unpack_from(">I", data, off + 8 + n)
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        off += 12 + n
    w, h, depth, colour = struct.unpack_from(">IIBB", chunks[b"IHDR"])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_viz_png_without_matplotlib(tmp_path, monkeypatch, capsys):
    from gridmap_slam_tpu_torch.utils.viz import render_likelihood, render_map

    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    lo = np.random.RandomState(0).normal(size=(40, 50))
    render_map(lo, tmp_path / "map.png",
               trajectory=np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0]]),
               ground_truth=np.asarray([[-0.5, 0.25]]),
               particles=np.asarray([[0.1, 0.1]]), origin=(-1.0, -1.0),
               resolution=0.05)
    w, h, px = _read_png(tmp_path / "map.png")
    assert (w, h) == (50, 40)
    grey = np.round(255 / (1.0 + np.exp(lo))).astype(np.uint8)[::-1]
    assert (px[h - 1 - 20, 20] == (220, 0, 0)).all()       # (0, 0): estimate
    assert (px[h - 1 - 25, 10] == (0, 160, 0)).all()       # ground truth
    untouched = np.ones((h, w), bool)
    untouched[[h - 1 - 20, h - 1 - 30, h - 1 - 25], [20, 30, 10]] = False
    np.testing.assert_array_equal(px[..., 0][untouched], grey[untouched])
    render_likelihood(np.abs(lo), tmp_path / "lik.png")
    w, h, px = _read_png(tmp_path / "lik.png")
    assert (w, h) == (50, 40) and px.max() == 255 and px.min() == 0
    assert "matplotlib is not installed" in capsys.readouterr().err


def test_viz_png_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    from gridmap_slam_tpu_torch.utils.viz import render_likelihood, render_map

    lo = np.random.RandomState(0).normal(size=(40, 40))
    render_map(lo, tmp_path / "map.png",
               trajectory=np.asarray([[0.0, 0.0], [0.5, 0.5]]),
               particles=np.asarray([[0.1, 0.1]]), origin=(-1.0, -1.0),
               resolution=0.05)
    assert (tmp_path / "map.png").stat().st_size > 1000
    render_likelihood(np.abs(lo) / np.abs(lo).max(), tmp_path / "lik.png")
    assert (tmp_path / "lik.png").read_bytes()[:4] == b"\x89PNG"


def test_metrics_logger_and_profiler(tmp_path):
    from gridmap_slam_tpu_torch.types import StepInfo
    from gridmap_slam_tpu_torch.utils.logging import MetricsLogger, Profiler

    info = StepInfo(neff=torch.tensor(12.5), weighted_pose=torch.zeros(3),
                    best_pose=torch.zeros(3), best_index=torch.tensor(3),
                    best_log_weight=torch.tensor(-100.0),
                    resampled=torch.tensor(True))
    path = tmp_path / "metrics.jsonl"
    log = MetricsLogger(path)
    log.log_scan(0, info, scan_ms=3.3)
    log.log_scan(1, info)
    log.log_event("resample", count=2)
    log.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 3
    assert lines[0]["neff"] == 12.5 and lines[0]["scan_ms"] == 3.3
    assert lines[0]["weighted_pose"] == [0.0, 0.0, 0.0]
    assert lines[2]["event"] == "resample"

    with Profiler(str(tmp_path / "trace")) as prof:
        torch.ones(8).cumsum(0)
    trace = json.loads(open(prof.trace_path).read())
    assert trace["traceEvents"]
