"""SLAM engines."""

from .frontend import FrontendConfig, PoseGraphSLAM
from .multi import MultiRobotSLAM, MultiRobotState
from .rbpf import RBPF
from .shared import SharedMapSLAM, SharedMapState

__all__ = ["RBPF", "SharedMapSLAM", "SharedMapState", "MultiRobotSLAM",
           "MultiRobotState", "FrontendConfig", "PoseGraphSLAM"]
