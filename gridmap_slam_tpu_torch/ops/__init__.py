"""Numerical building blocks of the SLAM step (counterparts of gridmap_slam_tpu/ops)."""
