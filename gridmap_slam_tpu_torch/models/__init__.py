"""SLAM engines."""

from .rbpf import RBPF

__all__ = ["RBPF"]
