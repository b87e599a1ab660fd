"""Carry configurations and filter state over from the JAX package.

Every function takes plain Python and numpy values, so this module needs no
jax: a caller converts a JAX `SlamState` or `SharedMapState` with
`np.asarray` on each field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (MapConfig, MatcherConfig, MotionConfig, RobotConfig,
                     SensorConfig, SlamConfig)
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
