"""Reader/writer for the reference recording ("maps/") file format.

A copy of the pure-Python parts of gridmap_slam_tpu/io/recording.py (the
JAX package cannot be imported without jax; tests/test_torch_config_io.py
holds the two readers equal).

Format (big-endian, app/DataRecorder.java:381-436 + app/ObjectSerializer.java:
36-83):

    u8  0xFF                      header
    i16 N                         frame count
    N x {
      f32 timeStamp               seconds since recording start
      f64 dCenter; f64 dTheta     odometry (ObjectSerializer.writeOdometry)
      i16 M                       measurement count
      M x { f64 angle; f64 distance; u8 wasHit }
    }
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Sequence

import numpy as np

_MEAS = np.dtype([("angle", ">f8"), ("dist", ">f8"), ("hit", "u1")])


@dataclasses.dataclass
class RecordedFrame:
    """Host-side frame: variable-length beams, as stored on disk."""

    t: float
    d_center: float
    d_theta: float
    angle: np.ndarray     # (M,) f64
    dist: np.ndarray      # (M,) f64
    hit: np.ndarray       # (M,) bool


def read_recording(path) -> List[RecordedFrame]:
    """Parse a reference-format recording."""
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    (header,) = struct.unpack_from(">B", data, off); off += 1
    if header != 0xFF:
        raise ValueError(f"bad header byte {header:#x}, want 0xff")
    (n,) = struct.unpack_from(">h", data, off); off += 2
    frames = []
    for _ in range(n):
        t, d_center, d_theta, m = struct.unpack_from(">fddh", data, off)
        off += 4 + 8 + 8 + 2
        # interleaved (angle, dist) pairs with a trailing bool each: the bool
        # breaks the stride, so parse per measurement via a structured dtype.
        rec = np.frombuffer(data, dtype=_MEAS, count=m, offset=off)
        off += m * _MEAS.itemsize
        frames.append(RecordedFrame(
            t=float(t), d_center=float(d_center), d_theta=float(d_theta),
            angle=rec["angle"].astype(np.float64),
            dist=rec["dist"].astype(np.float64),
            hit=rec["hit"].astype(bool)))
    return frames


def write_recording(path, frames: Sequence[RecordedFrame]) -> None:
    parent = os.path.dirname(os.fspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = bytearray()
    out += struct.pack(">B", 0xFF)
    out += struct.pack(">h", len(frames))
    for f in frames:
        m = len(f.angle)
        out += struct.pack(">fddh", f.t, f.d_center, f.d_theta, m)
        rec = np.empty(m, dtype=_MEAS)
        rec["angle"] = f.angle
        rec["dist"] = f.dist
        rec["hit"] = f.hit.astype(np.uint8)
        out += rec.tobytes()
    with open(path, "wb") as fh:
        fh.write(out)


def frames_to_arrays(frames: Sequence[RecordedFrame], max_beams: int,
                     max_range: float = 10.0):
    """Stack host frames into fixed-width arrays for device transfer.

    Returns a dict of numpy arrays with leading axis = frame count:
    t (F,), d_center (F,), d_theta (F,), angle/dist (F, B) f32,
    hit/valid (F, B) bool.
    """
    n = len(frames)
    t = np.zeros((n,), np.float32)
    dc = np.zeros((n,), np.float32)
    dt = np.zeros((n,), np.float32)
    angle = np.zeros((n, max_beams), np.float32)
    dist = np.full((n, max_beams), max_range, np.float32)
    hit = np.zeros((n, max_beams), bool)
    valid = np.zeros((n, max_beams), bool)
    for i, f in enumerate(frames):
        m = min(len(f.angle), max_beams)
        t[i], dc[i], dt[i] = f.t, f.d_center, f.d_theta
        angle[i, :m] = f.angle[:m]
        dist[i, :m] = f.dist[:m]
        hit[i, :m] = f.hit[:m]
        valid[i, :m] = True
    return dict(t=t, d_center=dc, d_theta=dt, angle=angle, dist=dist,
                hit=hit, valid=valid)
