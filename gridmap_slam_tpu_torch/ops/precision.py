"""float32 inside a block, whatever PyTorch's global TF32 flags say.

On a CUDA device PyTorch may run float32 matmuls (`torch.backends.cuda.
matmul.allow_tf32`) and cuDNN convolutions (`torch.backends.cudnn.
allow_tf32`, on by default) in TF32, a 10-bit mantissa.  The surface
correlation and the Gauss-Newton normal equations need honest float32, as
the JAX package pins it, so they run under these local flags.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """float32 matmuls inside the block, whatever the global TF32 flag."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def f32_conv():
    """cuDNN convolutions in float32 inside the block (cuDNN's default for
    float32 is TF32); the other cuDNN flags keep their values."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)
