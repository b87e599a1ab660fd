"""Particle weights and low-variance (systematic) resampling.

Counterpart of gridmap_slam_tpu/ops/resample.py (reference
slam/SLAM.java:120-153, slam/ParticleFilter.java:59-82): draw r ~ U[0, 1/N),
take U_m = r + (m-1)/N and select the first particle whose cumulative weight
exceeds U_m.  The walk is cumsum + searchsorted (side left) at every P; the
JAX package's sort-based rank paths work around slow TPU searchsorted and
are not ported.  The draw r is passed in.

Summing order.  On the CPU these are PyTorch's own reductions.  On the card
every reduction over the weights takes one fixed order that this module
spells out with elementwise operations alone, so that no PyTorch reduction
order (which its CUDA kernels pick from the size, the card and the version)
is left in it, and kernels F7 and F8 (ops/cuda/fusions.py) reproduce it bit
for bit.  The values are padded with +0.0 to rows of ROW = 1024, a row is
128 segments of SEG = 8 (the values one thread of F7 and F8 holds), and:

- `sum_fixed_order`: each segment summed left to right, a row's 128
  segment sums by a halving tree (s[:64] + s[64:], then 32, ... 1), then
  the row totals, padded to a power of two, by the same tree;
- `blocked_cumsum`: each segment scanned left to right, a row's segment
  totals by a Hillis-Steele inclusive scan (s[i] += s[i - k] for k = 1,
  2, ... 64) whose carry is added to the segments after, then the row
  totals by the same scan and their carry added to the rows after;
- `max_fixed_order`: the value at the first argmax.

Left to right within a segment, a vector of up to 8 weights is scanned as
numpy's and the JAX package's cumsum scan it on the CPU, so their
systematic ancestors agree at exact u == cum ties (tests/test_torch_ops.py,
tests/test_torch_weights.py); the trees above a segment are the ones a
block of threads takes.  ROW x ROW = 1 048 576 values at most (1M
particles); more raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import wrap_angle

ROW = 1024          # a row of the fixed orders: ROW * ROW values at most
SEG = 8             # a segment of a row: the values one thread adds in turn


def card_order(x) -> bool:
    """Whether reductions over `x` take the fixed orders: `x` is on the
    card.  (The tests replace this to run the card's orders on the CPU.)"""
    return x.is_cuda


def _rows(n: int) -> int:
    if n > ROW * ROW:
        raise ValueError(f"the fixed orders take at most {ROW * ROW} values "
                         f"a row, got {n}")
    return max(-(-n // ROW), 1)


def _pad_rows(x, rows: int):
    """(..., n) -> (..., rows, ROW), padded with +0.0."""
    n = x.shape[-1]
    return F.pad(x, (0, rows * ROW - n)).reshape(*x.shape[:-1], rows, ROW)


def _segments(x, rows: int):
    """(..., n) -> (..., rows, ROW // SEG, SEG), padded with +0.0."""
    return _pad_rows(x, rows).reshape(*x.shape[:-1], rows, ROW // SEG, SEG)


def _in_turn(m):
    """Sum over the last axis, left to right."""
    acc = m[..., 0]
    for j in range(1, m.shape[-1]):
        acc = acc + m[..., j]
    return acc


def _scan_in_turn(m):
    """Inclusive scan over the last axis, left to right."""
    cols = [m[..., 0]]
    for j in range(1, m.shape[-1]):
        cols.append(cols[-1] + m[..., j])
    return torch.stack(cols, -1)


def _halve(m):
    """Sum over the last axis, of a power-of-two length, by halving."""
    while m.shape[-1] > 1:
        h = m.shape[-1] // 2
        m = m[..., :h] + m[..., h:]
    return m[..., 0]


def _hillis_steele(m):
    """Inclusive scan over the last axis: m[i] += m[i - k] for k = 1, 2,
    4, ... below its length."""
    k = 1
    while k < m.shape[-1]:
        m = torch.cat([m[..., :k], m[..., k:] + m[..., :-k]], -1)
        k *= 2
    return m


def _carry(part, carry):
    """part (..., rows, L) with carry (..., rows) the inclusive scan of the
    rows' totals: each row after the first plus the carry before it."""
    return torch.cat([part[..., :1, :],
                      part[..., 1:, :] + carry[..., :-1, None]], -2)


def tree_sum(x):
    """The card's fixed-order sum over the last axis of x (any device)."""
    rows = _rows(x.shape[-1])
    totals = _halve(_in_turn(_segments(x, rows)))
    return _halve(F.pad(totals, (0, (1 << (rows - 1).bit_length()) - rows)))


def blocked_cumsum(x):
    """The card's fixed-order inclusive cumulative sum of a 1-D tensor (any
    device)."""
    n = x.shape[0]
    rows = _rows(n)
    local = _scan_in_turn(_segments(x, rows))        # (rows, 128, SEG)
    part = _carry(local, _hillis_steele(local[..., -1])).reshape(rows, ROW)
    return _carry(part, _hillis_steele(part[:, -1])).reshape(-1)[:n]


def sum_fixed_order(x, dim: int = -1):
    """torch.sum(x, dim); on the card tree_sum, the fixed order."""
    if card_order(x):
        return tree_sum(x.movedim(dim, -1))
    return torch.sum(x, dim)


def sums_fixed_order(*xs):
    """torch.stack([sum_fixed_order(x) for x in xs]) of 1-D tensors of one
    length, the same bits; on the card one tree_sum of their stack (its
    rows are summed apart, element by element)."""
    if card_order(xs[0]):
        return tree_sum(torch.stack(xs))
    return torch.stack([torch.sum(x, -1) for x in xs])


def max_fixed_order(x):
    """torch.max(x) of a 1-D tensor; on the card the value at its first
    argmax (the same value, with no reduction order)."""
    return x[torch.argmax(x)[None]][0] if card_order(x) else torch.max(x)


def cumsum_fixed_order(x):
    """torch.cumsum(x, 0) of a 1-D tensor; on the card blocked_cumsum, so
    that a run repeats from call to call (CUB's look-back scan, which
    torch.cumsum of a 1-D CUDA tensor runs, may add a 1M-weight vector in
    another order each call: 1 ulp apart, enough to move a systematic-
    resampling ancestor by hundreds of slots)."""
    return blocked_cumsum(x) if card_order(x) else torch.cumsum(x, 0)


def exp_weights(log_weights):
    """(max, exp(log_weights - max), their sum) of 1-D log weights."""
    m = max_fixed_order(log_weights)
    e = torch.exp(log_weights - m)
    return m, e, sum_fixed_order(e)


def normalized_weights(log_weights):
    """exp-normalize log weights to a probability vector."""
    _, e, s = exp_weights(log_weights)
    return e / s


def neff_of(w):
    """1 / sum(w^2) of normalized weights."""
    return 1.0 / sum_fixed_order(w * w)


def neff(log_weights):
    """Effective sample size 1 / sum(w^2) (slam/SLAM.java:180-190)."""
    return neff_of(normalized_weights(log_weights))


def systematic_indices(log_weights, u0):
    """Systematic resampling ancestor indices (slam/SLAM.java:133-153).
    u0: the start offset, a draw from U[0, 1/N) (scalar tensor or float)."""
    n = log_weights.shape[0]
    cum = cumsum_fixed_order(normalized_weights(log_weights))
    u = u0 + torch.arange(n, dtype=cum.dtype, device=cum.device) / n
    idx = torch.searchsorted(cum, u)
    return torch.clamp(idx, 0, n - 1)


def mean_pose_of(poses, w):
    """sum(w * pose) of normalized weights, theta wrapped first."""
    return sums_fixed_order(poses[:, 0] * w, poses[:, 1] * w,
                            wrap_angle(poses[:, 2]) * w)


def weighted_mean_pose(poses, log_weights):
    """Weighted mean pose; theta averaged after wrapping to (-pi, pi]
    (slam/SLAM.java:165-178 — the reference averages constrained angles
    linearly, which is reproduced)."""
    return mean_pose_of(poses, normalized_weights(log_weights))


def integration_pose(n_eff, num_particles: int, weighted, best_pose):
    """Pose the shared map is updated at: the argmax-weight particle, except
    when the weights are near-uniform (Neff >= 0.95 P, e.g. the first scan
    into an empty map), where the weighted mean is used."""
    return torch.where(n_eff >= 0.95 * num_particles, weighted, best_pose)


def recovery_ema(recov, step, l_ref, a_slow: float, a_fast: float):
    """AMCL's slow and fast EMAs of the max log-weight l_ref ([l_slow,
    l_fast], both set to l_ref at step 0) and the injection probability
    clamp(1 - exp(l_fast - l_slow), 0, 0.3)."""
    ema = torch.stack([recov[0] + a_slow * (l_ref - recov[0]),
                       recov[1] + a_fast * (l_ref - recov[1])])
    recov = torch.where(step == 0, l_ref.expand(2), ema)
    p_inject = torch.clamp(1.0 - torch.exp(recov[1] - recov[0]), 0.0, 0.3)
    return recov, p_inject
