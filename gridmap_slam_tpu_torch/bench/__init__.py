"""The port's benchmark: `python -m gridmap_slam_tpu_torch.bench`.

The counterpart of the root bench.py (which drives the JAX package): the
cells, presets and spans as files (cells/, presets/, spans/, read by
cells.py), the kernels with their bounds (kernels/, bounds.py), the timed
captured replays, the checks and the last line (run.py), bench.py's
baseline (baseline.py), the per-layer metrics from profiled replays
(layers.py) and the spread between processes (spread.py).
It imports torch and never jax.
"""
