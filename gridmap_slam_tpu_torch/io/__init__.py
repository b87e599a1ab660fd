"""Log I/O: the reference recording format, synthetic data, device transfer."""

import dataclasses

import torch

from ..types import Frame, Odom, Scan
from .recording import (RecordedFrame, frames_to_arrays, read_recording,
                        write_recording)


def frames_to_device(frames, max_beams: int, max_range: float = 10.0,
                     device="cpu") -> Frame:
    """Convert host RecordedFrames into a stacked `Frame` of tensors on
    `device`, with a leading frame axis (index it with `frame_at`)."""
    a = {k: torch.from_numpy(v).to(device)
         for k, v in frames_to_arrays(frames, max_beams, max_range).items()}
    return Frame(
        scan=Scan(angle=a["angle"], dist=a["dist"], hit=a["hit"],
                  valid=a["valid"]),
        odom=Odom(d_center=a["d_center"], d_theta=a["d_theta"]),
        t=a["t"],
    )


def frame_at(batch: Frame, i: int) -> Frame:
    """Select frame i from a stacked Frame batch."""
    return Frame(scan=Scan(*(getattr(batch.scan, f.name)[i]
                             for f in dataclasses.fields(Scan))),
                 odom=Odom(batch.odom.d_center[i], batch.odom.d_theta[i]),
                 t=batch.t[i])


__all__ = ["RecordedFrame", "read_recording", "write_recording",
           "frames_to_arrays", "frames_to_device", "frame_at"]
