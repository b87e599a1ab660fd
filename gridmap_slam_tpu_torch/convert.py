"""Carry configurations and filter state over from the JAX package.

Every function takes plain Python and numpy values, so this module needs no
jax: a caller converts a JAX `SlamState`, `SharedMapState`,
`MultiRobotState` or `PoseGraph` with `np.asarray` on each field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (MapConfig, MatcherConfig, MotionConfig, RobotConfig,
                     SensorConfig, SlamConfig)
from .models.frontend import FrontendConfig
from .models.multi import MultiRobotState
from .models.posegraph import PoseGraph
from .models.shared import SharedMapState
from .types import SlamState

_SECTIONS = {"robot": RobotConfig, "sensor": SensorConfig,
             "motion": MotionConfig, "map": MapConfig,
             "matcher": MatcherConfig}


def config_from_jax(cfg) -> SlamConfig:
    """The port's SlamConfig with every field of the JAX package's `cfg`
    (mapped field by field through dataclasses.asdict)."""
    d = dataclasses.asdict(cfg)
    for name, cls in _SECTIONS.items():
        d[name] = cls(**d[name])
    return SlamConfig(**d)


def _f32(a, device):
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _i32(a, device):
    return torch.as_tensor(np.array(a, np.int32), device=device)


def state_from_jax_arrays(poses, log_weights, logodds, step,
                          device="cpu") -> SlamState:
    """The port's SlamState from the numpy arrays of a JAX SlamState (its
    PRNG key has no counterpart here)."""
    return SlamState(poses=_f32(poses, device),
                     log_weights=_f32(log_weights, device),
                     logodds=_f32(logodds, device), step=_i32(step, device))


def shared_state_from_jax_arrays(poses, log_weights, logodds, step, recov,
                                 device="cpu") -> SharedMapState:
    """The port's SharedMapState from the numpy arrays of a JAX
    SharedMapState (its PRNG key has no counterpart here)."""
    return SharedMapState(poses=_f32(poses, device),
                          log_weights=_f32(log_weights, device),
                          logodds=_f32(logodds, device),
                          step=_i32(step, device), recov=_f32(recov, device))


def multi_state_from_jax_arrays(poses, log_weights, logodds, step,
                                device="cpu") -> MultiRobotState:
    """The port's MultiRobotState from the numpy arrays of a JAX
    MultiRobotState (its PRNG key has no counterpart here)."""
    return MultiRobotState(poses=_f32(poses, device),
                           log_weights=_f32(log_weights, device),
                           logodds=_f32(logodds, device),
                           step=_i32(step, device))


def posegraph_from_jax_arrays(nodes, edge_i, edge_j, edge_z, edge_w,
                              device="cpu") -> PoseGraph:
    """The port's PoseGraph from the numpy arrays of a JAX PoseGraph (the
    edge indices become int64, torch's index type)."""
    idx = lambda a: torch.as_tensor(np.array(a, np.int64), device=device)
    return PoseGraph(nodes=_f32(nodes, device), edge_i=idx(edge_i),
                     edge_j=idx(edge_j), edge_z=_f32(edge_z, device),
                     edge_w=_f32(edge_w, device))


def frontend_config_from_jax(cfg) -> FrontendConfig:
    """The port's FrontendConfig with every field of the JAX package's."""
    return FrontendConfig(**dataclasses.asdict(cfg))


def shard_arrays(poses, log_weights, logodds, *, n_p: int, i_p: int,
                 n_m: int = 1, i_m: int = 0, tiled: bool = False):
    """Rank (i_p, i_m)'s shard of a global state's numpy arrays on an
    (n_p, n_m) mesh: poses and log_weights sliced into the i_p-th of n_p
    contiguous runs; logodds, a shared (H, W) map or (P, H, W) maps a
    particle, sliced likewise over its particle axis and, with tiled=True,
    into the i_m-th of n_m column tiles.  Returns float32 copies
    (poses, log_weights, logodds)."""
    p = poses.shape[0]
    if p % n_p or not 0 <= i_p < n_p or not 0 <= i_m < n_m:
        raise ValueError(f"{p} particles do not shard as {i_p} of {n_p}")
    sl = slice(i_p * (p // n_p), (i_p + 1) * (p // n_p))
    lo = np.asarray(logodds, np.float32)
    if lo.ndim == 3:
        lo = lo[sl]
    if tiled:
        w = lo.shape[-1]
        if w % n_m:
            raise ValueError(f"a map {w} cells wide does not split into "
                             f"{n_m} column tiles")
        lo = lo[..., i_m * (w // n_m):(i_m + 1) * (w // n_m)]
    return (np.array(poses[sl], np.float32),
            np.array(log_weights[sl], np.float32), np.array(lo))
