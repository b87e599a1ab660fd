"""K3: batched log-likelihood field build, csrc/likelihood.cu.

Replaces gridmap_slam_tpu/ops/pallas/likelihood.py::
log_likelihood_field_pallas.  `log_likelihood_field_batch` runs the kernel
for a tensor on the card and the plain version for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from ..grid import likelihood_field
from ..matcher import log_likelihood_field
from . import _build, check_tensor, stream_handle

launches = 0   # kernel launches since the count was last set to 0


def log_likelihood_field_batch_plain(logodds, taps, *, z_hit: float,
                                     max_range: float):
    """Plain version: ops/grid.likelihood_field followed by
    ops/matcher.log_likelihood_field.  logodds: (..., H, W); taps: the 1-D
    blur kernel as a tensor."""
    field, unknown = likelihood_field(logodds, taps.tolist())
    return log_likelihood_field(field, unknown, z_hit, max_range)


def log_likelihood_field_batch_cuda(logodds, taps, *, z_hit: float,
                                    max_range: float):
    """The kernel.  logodds: (P, H, W) float32 on the card; taps: (2r+1,)
    float32 on the same card, r <= 7.  Returns (P, H, W)."""
    global launches
    fn = "log_likelihood_field_batch_cuda"
    if logodds.dim() != 3:
        raise ValueError(f"{fn}: logodds must be (P, H, W), got "
                         f"{tuple(logodds.shape)}")
    dev = logodds.device
    check_tensor(fn, "logodds", logodds, logodds.shape, dev)
    n_taps = taps.shape[0] if taps.dim() == 1 else -1
    check_tensor(fn, "taps", taps, (n_taps,), dev)
    radius = (n_taps - 1) // 2
    if n_taps % 2 != 1 or radius > 7:
        raise ValueError(f"{fn}: need an odd tap count of at most 15, got "
                         f"{n_taps}")
    p, h, w = logodds.shape
    uniform = 1.0 / max_range
    c_rand = (1.0 - z_hit) * uniform
    v_eq = (uniform - c_rand) / z_hit
    out = torch.empty_like(logodds)
    lib = _build.library()
    code = lib.gs_ll_field(logodds.data_ptr(), out.data_ptr(), taps.data_ptr(),
                           radius, p, h, w, z_hit, c_rand, v_eq,
                           stream_handle(dev))
    launches += 1
    _build.check("gs_ll_field", code)
    return out


def log_likelihood_field_batch(logodds, taps, *, z_hit: float,
                               max_range: float):
    """(P, H, W) log-odds -> (P, H, W) log-likelihood field."""
    fn = (log_likelihood_field_batch_cuda if logodds.is_cuda
          else log_likelihood_field_batch_plain)
    return fn(logodds, taps, z_hit=z_hit, max_range=max_range)
