"""Carry configurations and filter state over from the JAX package.

Both functions take plain Python and numpy values, so this module needs no
jax: a caller converts a JAX `SlamState` with `np.asarray` on each field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (MapConfig, MatcherConfig, MotionConfig, RobotConfig,
                     SensorConfig, SlamConfig)
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


def state_from_jax_arrays(poses, log_weights, logodds, step,
                          device="cpu") -> SlamState:
    """The port's SlamState from the numpy arrays of a JAX SlamState (its
    PRNG key has no counterpart here)."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return SlamState(poses=f32(poses), log_weights=f32(log_weights),
                     logodds=f32(logodds),
                     step=torch.as_tensor(np.array(step, np.int32),
                                          device=device))
