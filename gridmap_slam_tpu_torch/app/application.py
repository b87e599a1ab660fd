"""Application lifecycle — the reference `IApplication` surface, headless.

The reference defines an app lifecycle interface (init/render/dispose plus
input hooks, java/.../app/IApplication.java:22-36) implemented by
GridMapApp, whose real work is: wire SLAM + view + recorder at init
(GridMapApp.java:110-130), run one SLAM update per arriving TimeFrame
(onHandleData, :133-212), refresh the view each tick (render, :215-433),
and tear down on exit.  `SlamApplication` is that lifecycle for this
engine's headless surfaces: the CLI's live mode drives it from the
pipeline thread's drain, and any embedder (tests, notebooks, a future UI)
gets the same init/on_frame/render/dispose contract.  Mouse/keyboard
hooks have no headless analog; interactive input is the teleop controller
(app/teleop.py, reference ConnectionManager.java:143-215).

Counterpart of gridmap_slam_tpu/app/application.py: the engine runs on its
own device (the card unless it was built with device="cpu"), its draws come
from a torch.Generator on that device seeded at init, each frame is one
replay of the step captured as a CUDA graph at the first frame
(`compiled_step`, the counterpart of `jax.jit(engine.step)`), and the pose
is read back to the host once a frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def compiled_step(engine):
    """The engine's step as the applications run it: `engine.step_jit()`,
    its step (as the engine routes it) captured as a CUDA graph on the
    card and the same static-buffer step on the CPU, with the eager step's
    bits; the state it returns is the capture's buffer, which the next
    call consumes.  An engine without `step_jit` raises AttributeError."""
    return engine.step_jit()


class SlamApplication:
    """init/on_frame/render/dispose lifecycle around a SLAM engine.

    Parameters
    ----------
    cfg, engine : a SlamConfig and an engine exposing `step`, `init`,
        `best_map` and `device` (RBPF or SharedMapSLAM — both do).
    view : optional live view with .update(map, pose, particles, neff)
        and .finish() (utils/liveview.TerminalMapView).
    on_dispose : optional callables run exactly once at dispose (used by
        the CLI for link/pipeline teardown).
    """

    def __init__(self, cfg, engine, view=None, on_dispose=()):
        self.cfg = cfg
        self.engine = engine
        self.view = view
        self._on_dispose = list(on_dispose)
        self.generator: Optional[torch.Generator] = None
        self._step = None
        self.state = None
        self.trajectory: list[np.ndarray] = []
        self.frames_seen = 0
        self.last_info = None
        self._disposed = False

    # ---------------------------------------------------- lifecycle
    def init(self, seed: int = 0, pose=(0.0, 0.0, 0.0), state=None) -> None:
        """Create engine state, the generator the steps draw from, seeded
        with `seed` on the engine's device, and the captured step
        (GridMapApp.init).

        Pass `state` to adopt an existing one (e.g. the CLI's
        --load-map-initialized state) instead of creating it."""
        self.generator = torch.Generator(
            device=self.engine.device).manual_seed(seed)
        self.state = (state if state is not None
                      else self.engine.init(pose=pose))
        self._step = compiled_step(self.engine)

    def on_frame(self, frame) -> None:
        """One SLAM update for one arriving frame (GridMapApp.onHandleData).

        `frame` is a host-side io Frame record; transfer + step + pose
        tracking happen here so pipeline subscribers can pass frames
        through untouched."""
        from ..io import frame_at, frames_to_device
        if self.state is None:
            raise RuntimeError("SlamApplication.on_frame before init()")
        batch = frames_to_device([frame], self.cfg.max_beams,
                                 self.cfg.sensor.max_range,
                                 device=self.engine.device)
        self.state, info = self._step(self.state, frame_at(batch, 0),
                                      self.generator)
        self.last_info = info
        self.frames_seen += 1
        self.trajectory.append(info.weighted_pose.cpu().numpy())

    def render(self) -> None:
        """Refresh the live view from current state (GridMapApp.render)."""
        if self.view is None or self.last_info is None:
            return
        self.view.update(self.occupancy(), self.trajectory[-1],
                         self.state.poses.cpu().numpy(),
                         float(self.last_info.neff))

    def dispose(self) -> None:
        """Tear down the view and run registered teardown hooks once."""
        if self._disposed:
            return
        self._disposed = True
        if self.view is not None:
            self.view.finish()
        for fn in self._on_dispose:
            fn()

    # ---------------------------------------------------- conveniences
    def trajectory_array(self) -> np.ndarray:
        return (np.stack(self.trajectory) if self.trajectory
                else np.zeros((0, 3), np.float32))

    def occupancy(self) -> np.ndarray:
        return self.engine.best_map(self.state).cpu().numpy()

    def __enter__(self) -> "SlamApplication":
        if self.state is None:
            self.init()
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.dispose()
        return None
