"""gridmap_slam_tpu_torch — the SLAM engine in PyTorch, with CUDA kernels.

The PyTorch counterpart of `gridmap_slam_tpu` (Rao-Blackwellized
particle-filter SLAM over per-particle log-odds grids, and the shared-map
filter in surface mode for 1M particles).  Module names follow the JAX
package.  On an NVIDIA H100 the three hot operations run as
hand-written CUDA kernels (ops/cuda, csrc/); on the CPU they run as plain
PyTorch.  The package imports torch and never jax.
"""

from .config import (MapConfig, MatcherConfig, MotionConfig, RobotConfig,
                     SensorConfig, SlamConfig, chip_config, city_config,
                     mega_config, pr1_config, reference_parity_config)
from .types import Frame, Odom, Scan, SlamState, StepInfo
from .models.rbpf import RBPF
from .models.shared import SharedMapSLAM, SharedMapState

__version__ = "0.1.0"

__all__ = [
    "SlamConfig", "MapConfig", "MatcherConfig", "MotionConfig", "RobotConfig",
    "SensorConfig", "chip_config", "city_config", "mega_config",
    "pr1_config", "reference_parity_config", "Frame", "Odom", "Scan",
    "SlamState", "StepInfo", "RBPF", "SharedMapSLAM", "SharedMapState",
]
