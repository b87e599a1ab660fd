"""SLAM engines."""

from .rbpf import RBPF
from .shared import SharedMapSLAM, SharedMapState

__all__ = ["RBPF", "SharedMapSLAM", "SharedMapState"]
