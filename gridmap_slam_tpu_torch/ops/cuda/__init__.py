"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each module holds one kernel's wrapper, its plain PyTorch version and a
launch count (`fusions` eight of each):

- `likelihood`  — K3, the log-likelihood field build (csrc/likelihood.cu);
- `grid_update` — K2, the dense map update (csrc/grid_update.cu);
- `matcher`     — K1, the correlative-match stage scores (csrc/matcher.cu);
- `surface_corr` — K4, the surface correlation with bf16 products and
  float32 sums on the tensor cores (csrc/surface_corr.cu);
- `fusions` — F1-F8, eight of XLA's fusions of the JAX step as kernels:
  the motion model, the matcher's coarse pool, each matcher stage's
  prior, argmax and pick, the surface sample and climb, the splat's tap
  weights, the scan's preparation, the weights' tail and the systematic
  walk, and the last two's mesh forms for the distributed engines
  (csrc/fusions.cu), with a launch count each.

The dispatching function of each module runs the plain version for a tensor
on the CPU and the kernel for a tensor on the card; there is no fallback
from one to the other.  `_build` compiles `csrc/*.cu` with nvcc at first
use.
"""

from __future__ import annotations

import torch


def check_tensor(fn: str, name: str, t: torch.Tensor, shape, device,
                 dtype=torch.float32) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of `shape`
    on the CUDA `device`."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{fn}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
