"""Scan-likelihood surface: the measurement model evaluated everywhere once.

Counterpart of gridmap_slam_tpu/ops/surface.py.  Per scan the correlation
volume

    C[it, iy, ix] = sum_b w_b * bilinear(LLF)(R(theta_it) p_b + cell(iy, ix))

is built over a theta-bin grid and every integer cell translation of a crop
of the log-likelihood field (one correlation a scan, whatever the particle
count), after which any pose's measurement log-likelihood is a trilinear
sample of C (8 taps a particle).  The endpoint images are two-tap outer
products (a batched matmul), and the correlation runs as an f32 conv2d, as
an FFT (torch.fft) or, with `bf16`, as bf16 products with float32 sums
(kernel K4 on the card, ops/cuda/surface_corr.py).  None of this is a TPU
kernel in the JAX package; the map operations around it (field build K3,
map update K2) are.  On the card the engines sample the volume and climb on
it through F4 and splat the endpoints' factors through F5
(ops/cuda/fusions.py), which read the volume in place: the functions here
are those kernels' plain versions, with the bits of their tensor ops.

The float32 modes are honest float32 on a CUDA device whatever the global
TF32 flags say: the conv runs under a local cuDNN flag and the splat under
a local matmul flag.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .cuda.surface_corr import surface_corr_bf16
from .precision import f32_conv, f32_matmul


def crop_center_cells(center_xy, crop_hw: Tuple[int, int],
                      full_hw: Tuple[int, int], resolution: float, origin):
    """Top-left cell index (iy0, ix0), int64 scalar tensors, of a (Hc, Wc)
    crop centered as close to world-point `center_xy` as the map allows
    (clamped inside)."""
    hc, wc = crop_hw
    h, w = full_hw
    cx = (center_xy[0] - origin[0]) / resolution
    cy = (center_xy[1] - origin[1]) / resolution
    ix0 = torch.clamp(torch.round(cx).to(torch.int64) - wc // 2, 0, w - wc)
    iy0 = torch.clamp(torch.round(cy).to(torch.int64) - hc // 2, 0, h - hc)
    return iy0, ix0


def theta_grid(nt: int, span_rad: float):
    """Static theta-bin grid parameters: (dtheta, wrap_theta, offset) with
    bin t at center_theta + offset + t * dtheta.  span >= pi selects the
    full-circle wrapping grid (global relocalization); smaller spans a
    clamped window centered on the cloud heading."""
    wrap_theta = span_rad >= math.pi - 1e-9
    if wrap_theta:
        return 2.0 * math.pi / nt, True, -math.pi
    return 2.0 * span_rad / max(nt - 1, 1), False, -span_rad


def splat_factors(px, py, wgt, thetas, k_cells: int, resolution: float):
    """The factors of splat_endpoint_kernels' images: (A_y diag(w), A_x),
    each (nt, B, K) with K = 2*k_cells + 1, A_* the bilinear corner weights
    of each endpoint rotated by each bin's heading into the kernel frame
    (beams beyond the kernel radius clamp to the rim).  On the card one
    kernel writes both (ops/cuda/fusions.endpoint_factors, F5)."""
    k = 2 * k_cells + 1
    idx = torch.arange(k, dtype=torch.int64, device=px.device)
    c = torch.cos(thetas)[:, None]
    s = torch.sin(thetas)[:, None]
    ex = (px * c - py * s) / resolution + k_cells      # (nt, B) kernel frame
    ey = (px * s + py * c) / resolution + k_cells
    x0 = torch.clamp(torch.floor(ex), 0, k - 2)
    y0 = torch.clamp(torch.floor(ey), 0, k - 2)
    tx = ex - x0
    ty = ey - y0
    x0i = x0.to(torch.int64)[..., None]
    y0i = y0.to(torch.int64)[..., None]
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    a_y = (torch.where(idx == y0i, 1.0 - ty[..., None], zero)
           + torch.where(idx == y0i + 1, ty[..., None], zero))   # (nt, B, K)
    a_x = (torch.where(idx == x0i, 1.0 - tx[..., None], zero)
           + torch.where(idx == x0i + 1, tx[..., None], zero))
    return a_y * wgt[:, None], a_x


def endpoint_images(a_yw, a_x):
    """The (nt, K, K) endpoint images A_y^T diag(w) A_x of splat_factors'
    factors, as one batched matmul in float32."""
    with f32_matmul():
        return torch.bmm(a_yw.transpose(1, 2), a_x)


def splat_endpoint_kernels(px, py, wgt, thetas, k_cells: int,
                           resolution: float):
    """(nt, K, K) stack of bilinearly-splatted endpoint images, one per
    theta bin; K = 2*k_cells + 1 covers endpoints within k_cells of the
    robot.  Beams beyond the kernel radius clamp to the rim.

    Each image is the two-tap outer product E = A_y^T diag(w) A_x with A_*
    the (B, K) bilinear corner weights, as one batched matmul."""
    return endpoint_images(*splat_factors(px, py, wgt, thetas, k_cells,
                                          resolution))


def _fft_size(n: int) -> int:
    """FFT length for one axis: the exact linear-correlation length `n`
    rounded up to the next 5-smooth length (2^a 3^b 5^c), or to the next
    power of two when the 5-smooth length lands within 12.5 % of it.  The
    JAX package's policy, kept for parity (chip_smoke.py times the three
    lengths on the card).  Zero-padding past the exact length only adds
    zeros outside the kept correlation window: the output is unchanged."""
    p2 = 1 << max(n - 1, 1).bit_length()
    s5 = p2
    v3 = 1
    while v3 < p2:
        v35 = v3
        while v35 < p2:
            v = v35
            while v < n:
                v *= 2
            if n <= v < s5:
                s5 = v
            v35 *= 5
        v3 *= 3
    return p2 if s5 >= 0.875 * p2 else s5


def scan_surface(llf_crop, e_stack, ll_outside: float, bf16: bool = False,
                 fft: bool = False):
    """Correlate the cropped LL field with every theta bin's endpoint image.

    llf_crop: (Hc, Wc); e_stack: (nt, K, K) with K = 2*kc + 1.
    Returns C: (nt, Hc, Wc) where C[t, iy, ix] scores the pose whose
    position is cell (iy, ix) of the crop at theta bin t.  The field is
    padded by kc with ll_outside, so endpoints past the crop read the
    out-of-map constant.  fft=True correlates by rfft2/irfft2 at the
    lengths of `_fft_size`, whatever `bf16` says (the JAX order of
    branches).  Otherwise bf16=True correlates at bf16 precision with
    float32 sums (surface_corr_bf16: K4 on the card) with the field
    shifted by -ll_outside / 2 to centre its range on zero, and subtracts
    the exact shift mass (each bin's float32 endpoint weight, taken before
    the rounding) back; else an f32 conv2d."""
    kc = (e_stack.shape[-1] - 1) // 2
    fpad = F.pad(llf_crop, (kc, kc, kc, kc), value=ll_outside)
    hc, wc = llf_crop.shape
    if fft:
        h2, w2 = _fft_size(fpad.shape[0]), _fft_size(fpad.shape[1])
        f_hat = torch.fft.rfft2(fpad, s=(h2, w2))
        # the images' spectra are freed once multiplied, before the inverse
        # (whose input copy, output and work area are the build's peak)
        spec = f_hat[None] * torch.conj(torch.fft.rfft2(e_stack, s=(h2, w2)))
        out = torch.fft.irfft2(spec, s=(h2, w2))
        return out[:, :hc, :wc].to(torch.float32)
    if bf16:
        shift = -0.5 * ll_outside
        mass = torch.sum(e_stack, dim=(-2, -1))          # (nt,) = sum_b w_b
        return surface_corr_bf16(fpad, e_stack, shift, mass)
    # conv2d cross-correlates: out[t, y, x] = sum fpad[y+dy, x+dx] E[t, dy, dx]
    with f32_conv():
        out = F.conv2d(fpad[None, None], e_stack[:, None])
    return out[0]                                       # (nt, Hc, Wc)


packs_on_card = 0   # packed arrays built from a volume on the card since
                    # the count was last set to 0 (the engines build none)


def pack_neighborhoods(c_vol, wrap_theta: bool = False):
    """(nt, hc, wc) -> flattened ((nt+1)*(hc+1)*(wc+1), 8) array holding
    every base cell's full 2x2x2 tap neighborhood, edge-padded (wrapped
    along theta for full-circle grids), so clamped taps read the same values
    as `_tap`'s index clipping.  A trilinear sample becomes one contiguous
    8-wide gather; the array is 8x the volume's memory.  Counted in
    `packs_on_card` where the volume is on the card."""
    global packs_on_card
    packs_on_card += c_vol.is_cuda
    nt, hc, wc = c_vol.shape
    v = F.pad(c_vol[None], (1, 1, 1, 1), mode="replicate")[0]
    if wrap_theta:
        v = torch.cat([v[-1:], v, v[:1]], 0)
    else:
        v = torch.cat([v[:1], v, v[-1:]], 0)
    slices = [v[dt:dt + nt + 1, dy:dy + hc + 1, dx:dx + wc + 1]
              for dt in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(slices, -1).reshape(-1, 8)


def _tap(c_vol, it, iy, ix, wrap_theta=False):
    nt, hc, wc = c_vol.shape
    # full-circle bin grids wrap; partial spans clamp
    it = torch.remainder(it, nt) if wrap_theta else torch.clamp(it, 0, nt - 1)
    iy = torch.clamp(iy, 0, hc - 1)
    ix = torch.clamp(ix, 0, wc - 1)
    return c_vol.reshape(-1)[(it * hc + iy) * wc + ix]


def sample_surface(c_vol, poses, *, theta0, dtheta, crop_iy0, crop_ix0,
                   resolution: float, origin, wrap_theta: bool = False,
                   packed=None):
    """Trilinear sample of C at `poses` (..., 3) -> measurement log-lik.

    Bin t is at theta0 + t*dtheta; theta distance is taken on the circle.
    Positions clamp to the crop (out-of-crop poses read rim values).
    With `packed` (pack_neighborhoods), one 8-wide gather a pose; without,
    8 scalar taps."""
    x, y, th = poses[..., 0], poses[..., 1], poses[..., 2]
    fx = (x - origin[0]) / resolution - 0.5 - crop_ix0
    fy = (y - origin[1]) / resolution - 0.5 - crop_iy0
    # with wrap_theta the grid covers the whole circle, so the coordinate
    # lives in [0, nt) and taps wrap modulo nt
    if wrap_theta:
        dt = torch.remainder(th - theta0, 2.0 * math.pi)
    else:
        dt = torch.remainder(th - theta0 + math.pi, 2.0 * math.pi) - math.pi
    ft = dt / dtheta

    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    t0 = torch.floor(ft)
    tx = fx - x0
    ty = fy - y0
    tt = ft - t0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    t0i = t0.to(torch.int64)

    if packed is not None:
        nt, hc, wc = c_vol.shape
        if wrap_theta:
            t_b = torch.clamp(t0i, 0, nt - 1) + 1   # ft in [0, nt) by constr.
        else:
            t_b = torch.clamp(t0i, -1, nt - 1) + 1
        y_b = torch.clamp(y0i, -1, hc - 1) + 1
        x_b = torch.clamp(x0i, -1, wc - 1) + 1
        g = packed[(t_b * (hc + 1) + y_b) * (wc + 1) + x_b]   # (..., 8)
        w8 = torch.stack([(1 - tt) * (1 - ty) * (1 - tx),
                          (1 - tt) * (1 - ty) * tx,
                          (1 - tt) * ty * (1 - tx),
                          (1 - tt) * ty * tx,
                          tt * (1 - ty) * (1 - tx),
                          tt * (1 - ty) * tx,
                          tt * ty * (1 - tx),
                          tt * ty * tx], -1)
        return torch.sum(g * w8, -1)
    out = 0.0
    for ot, wt in ((0, 1.0 - tt), (1, tt)):
        for oy, wy in ((0, 1.0 - ty), (1, ty)):
            for ox, wx in ((0, 1.0 - tx), (1, tx)):
                out = out + wt * wy * wx * _tap(c_vol, t0i + ot, y0i + oy,
                                                x0i + ox,
                                                wrap_theta=wrap_theta)
    return out


def refine_on_surface(c_vol, poses, scores, *, steps: int, theta0, dtheta,
                      crop_iy0, crop_ix0, resolution: float, origin,
                      wrap_theta: bool = False, packed=None):
    """Greedy hill-climb on C: per step, try +/-1 cell / +/-1 bin moves along
    each axis (6 neighbors) and take the best improvement."""
    if steps <= 0:
        return poses, scores
    # the six moves filled in on the device: a tensor built from a Python
    # list would be a copy from pageable host memory (a host sync, and not
    # allowed in a captured graph)
    moves = torch.zeros((6, 3), dtype=torch.float32, device=poses.device)
    for axis, step in enumerate((resolution, resolution, dtheta)):
        moves[2 * axis, axis].fill_(step)
        moves[2 * axis + 1, axis].fill_(-step)
    for _ in range(steps):
        cand = poses[..., None, :] + moves            # (..., 6, 3)
        s = sample_surface(c_vol, cand, theta0=theta0, dtheta=dtheta,
                           crop_iy0=crop_iy0, crop_ix0=crop_ix0,
                           resolution=resolution, origin=origin,
                           wrap_theta=wrap_theta, packed=packed)
        k = torch.argmax(s, -1, keepdim=True)
        s_best = torch.take_along_dim(s, k, -1)[..., 0]
        p_best = torch.take_along_dim(cand, k[..., None], -2)[..., 0, :]
        better = s_best > scores
        poses = torch.where(better[..., None], p_best, poses)
        scores = torch.where(better, s_best, scores)
    return poses, scores
