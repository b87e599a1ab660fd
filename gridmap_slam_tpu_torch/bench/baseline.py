"""bench.py's baseline (bench.py:50-101), for the last line's
`vs_baseline`: the benchmark's scans/s over the larger of two rates, each
scaled 1/P to the head cell's particles P (the reference publishes no
numbers, BASELINE.md):

- MEASURED: the NumPy oracle of the reference's per-particle math
  (oracle/numpy_ref.OracleSLAM), its rate at `probe_particles` recorded in
  oracle_baseline.json beside this module (a copy of
  docs/bench/oracle_baseline.json, pinned byte for byte by
  tests/test_torch_bench.py);
- ASSUMED: the single-threaded Java reference at 1.0 scan/s at its own
  500 particles.

The field names and their rounding are bench.py's result_line's.  Both
rates scale 1/P, so the Java one is the larger at every P (500 against
the oracle's 3.59 scans/s at one particle).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

ORACLE = Path(__file__).resolve().parent / "oracle_baseline.json"
JAVA_SCANS_PER_SEC, JAVA_PARTICLES = 1.0, 500.0
# the last line's baseline fields, bench.py's names
FIELDS = ("vs_baseline", "baseline_oracle_scans_per_sec",
          "baseline_oracle_probe_particles", "baseline_oracle_extrapolated",
          "baseline_java_assumed_scans_per_sec")


def oracle_baseline(n_particles: int, path: Optional[Path] = None):
    """(the oracle's scans/s scaled to n_particles, its probe's
    particles), from the recorded rate at `path` (default ORACLE; a
    missing file raises)."""
    d = json.loads((path or ORACLE).read_text())
    return (d["scans_per_sec"] * d["probe_particles"] / n_particles,
            d["probe_particles"])


def baseline_fields(sps: float, n_particles: int) -> dict:
    """bench.py's result_line baseline fields for `sps` scans/s at
    n_particles: vs_baseline over the larger baseline, the oracle's rate,
    its probe's particles and whether it was scaled, and the Java rate
    assumed."""
    java = JAVA_SCANS_PER_SEC * JAVA_PARTICLES / n_particles
    oracle, probe = oracle_baseline(n_particles)
    return {
        "vs_baseline": round(sps / max(java, oracle), 2),
        "baseline_oracle_scans_per_sec": round(oracle, 6),
        "baseline_oracle_probe_particles": probe,
        "baseline_oracle_extrapolated": probe != n_particles or None,
        "baseline_java_assumed_scans_per_sec": round(java, 4),
    }
