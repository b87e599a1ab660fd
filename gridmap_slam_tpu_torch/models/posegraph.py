"""Pose-graph backend: keyframes, loop closure, Gauss-Newton optimization.

Counterpart of gridmap_slam_tpu/models/posegraph.py.  Residuals and
Jacobians of all edges are computed in one batch; the normal equations are
assembled as a dense product and solved by Cholesky.  That costs O(E K)
memory and O(E K^2) flops an iteration for E edges and K keyframes
(chip_smoke.py times it: on an H100, 0.9 ms at 216 keyframes, 3.3 ms at
1000 and 45 ms with a 1.7 GB peak at 3000); graphs much larger than that
need a sparse assembly.  Loop-closure candidates are verified with the same
correlative matcher the filters use, scoring a scan against a local grid
built from the paired keyframe's scan, for a whole batch of candidates at
once.

On the card the assembly must repeat exactly: the JAX package adds the
per-edge blocks with scatter-adds, and a scatter-add on CUDA
(`index_add_`, `index_put_(accumulate=True)`) adds with float atomics in
an order that changes from run to run.  Here H = J^T W J and b = J^T W e
are products of the dense (3E, 3K) Jacobian, built from one-hot node
selectors, so the sums run in a fixed order.  The products are pinned to
float32 (TF32 would lose the positive definiteness the JAX package pins
f32 matmul precision for, posegraph.py:144-160), and the solve is
`cholesky_ex` + `cholesky_solve`: no host read, and a matrix that is not
positive definite gives NaN, as the JAX solve does.

A batch of C closure candidates runs three kernel calls a direction: the
local maps by K2 with cone fill at (C, H, W) from zeros with one bin table
a candidate, their fields by K3 at batch C, and the search by K1 with one
field and one scan a candidate (G_f = G_b = C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.cuda.fusions import ScanPrep, bin_tables, prepare_scan
from ..ops.cuda.grid_update import integrate_scan_batch
from ..ops.cuda.likelihood import log_likelihood_field_batch
from ..ops.geometry import wrap_angle
from ..ops.matcher import correlative_match_batch
from ..ops.precision import f32_matmul
from ..types import Odom, Scan
from .captured import Graphed, copy_into, leaves, tree_map


@dataclasses.dataclass
class PoseGraph:
    """nodes: (K, 3) SE(2) poses; edges i->j with relative measurements.

    edge_i/edge_j: (E,) int64 node indices.
    edge_z:        (E, 3) measured relative pose of j in i's frame.
    edge_w:        (E, 3) diagonal information (weights) per residual
                   dimension; 0 rows are padding and contribute nothing.
    """

    nodes: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_z: torch.Tensor
    edge_w: torch.Tensor


def odometry_edges(poses: np.ndarray, w_xy: float = 100.0,
                   w_t: float = 400.0):
    """Build sequential edges from a trajectory of keyframe poses."""
    k = len(poses)
    i = np.arange(k - 1)
    j = i + 1
    z = np.stack([_relative_np(poses[a], poses[b]) for a, b in zip(i, j)])
    w = np.tile(np.asarray([w_xy, w_xy, w_t]), (k - 1, 1))
    return i.astype(np.int32), j.astype(np.int32), z.astype(np.float32), \
        w.astype(np.float32)


def _relative_np(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    dt = math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))
    return np.asarray([c * dx + s * dy, -s * dx + c * dy, dt])


def residuals_and_jacobians(nodes, edge_i, edge_j, edge_z):
    """Batched SE(2) edge residuals e = [R_i^T (t_j - t_i) - z_t,
    wrap(th_j - th_i - z_th)] and their 3x3 Jacobians wrt nodes i and j."""
    pi = nodes[edge_i]                       # (E, 3)
    pj = nodes[edge_j]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    ex = c * dx + s * dy - edge_z[:, 0]
    ey = -s * dx + c * dy - edge_z[:, 1]
    et = wrap_angle(pj[:, 2] - pi[:, 2] - edge_z[:, 2])
    e = torch.stack([ex, ey, et], -1)        # (E, 3)

    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    # d e / d (xi, yi, thi)
    ji = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], -1),
        torch.stack([s, -c, -c * dx - s * dy], -1),
        torch.stack([zeros, zeros, -ones], -1),
    ], -2)                                    # (E, 3, 3)
    # d e / d (xj, yj, thj)
    jj = torch.stack([
        torch.stack([c, s, zeros], -1),
        torch.stack([-s, c, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], -2)
    return e, ji, jj


def _dense_jacobian(ji, jj, edge_i, edge_j, k: int):
    """The (3E, 3K) Jacobian of all residuals: edge e's 3x3 blocks in the
    columns of nodes i and j, placed by one-hot selectors (exact; a
    self-edge adds its two blocks)."""
    e_count = ji.shape[0]
    node = torch.arange(k, device=ji.device)
    sel_i = (edge_i[:, None] == node).to(ji.dtype)       # (E, K)
    sel_j = (edge_j[:, None] == node).to(ji.dtype)
    dense = (ji[:, :, None, :] * sel_i[:, None, :, None]
             + jj[:, :, None, :] * sel_j[:, None, :, None])
    return dense.reshape(3 * e_count, 3 * k)


def normal_equations(nodes, edge_i, edge_j, edge_z, edge_w):
    """The normal equations of an edge set: H = J^T W J (3K, 3K),
    b = J^T W e (3K,) and chi2, assembled as dense products (a fixed
    summation order, the same bits on every run) in float32."""
    k = nodes.shape[0]
    e, ji, jj = residuals_and_jacobians(nodes, edge_i, edge_j, edge_z)
    chi2 = torch.sum(edge_w * e * e)
    jac = _dense_jacobian(ji, jj, edge_i, edge_j, k)
    wj = edge_w.reshape(-1, 1) * jac
    with f32_matmul():
        h = jac.T @ wj
        b = jac.T @ (edge_w * e).reshape(-1)
    return h, b, chi2


def damped_solve(nodes, h, b, damping: float = 1e-6, anchor_w: float = 1e6):
    """nodes + dx for (H + diag) dx = -b, node 0 anchored by a strong prior
    (gauge fixing) and the rest Levenberg-damped, solved by Cholesky;
    angles wrapped.  A system that is not positive definite gives NaN
    poses, as the JAX package's solve does."""
    k = nodes.shape[0]
    diag = torch.cat([torch.full((3,), anchor_w, dtype=nodes.dtype,
                                 device=nodes.device),
                      torch.full((3 * (k - 1),), damping, dtype=nodes.dtype,
                                 device=nodes.device)])
    h = h + torch.diag(diag)
    chol, info = torch.linalg.cholesky_ex(h)
    with f32_matmul():
        dx = torch.cholesky_solve(-b[:, None], chol)[:, 0]
    dx = torch.where(info == 0, dx, torch.full_like(dx, math.nan))
    new_nodes = nodes + dx.reshape(k, 3)
    return torch.cat([new_nodes[:, :2], wrap_angle(new_nodes[:, 2:])], 1)


def gauss_newton_step(graph: PoseGraph, damping: float = 1e-6,
                      anchor_w: float = 1e6):
    """One damped Gauss-Newton update of all node poses: the dense normal
    equations (normal_equations) solved by Cholesky (damped_solve).
    Returns (new_graph, chi2)."""
    h, b, chi2 = normal_equations(graph.nodes, graph.edge_i, graph.edge_j,
                                  graph.edge_z, graph.edge_w)
    new_nodes = damped_solve(graph.nodes, h, b, damping, anchor_w)
    return dataclasses.replace(graph, nodes=new_nodes), chi2


def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-6) -> Tuple[PoseGraph, torch.Tensor]:
    """Fixed-iteration Gauss-Newton; returns (graph, chi2 of each
    iteration's starting poses)."""
    chi2s = []
    for _ in range(iterations):
        graph, chi2 = gauss_newton_step(graph, damping)
        chi2s.append(chi2)
    return graph, torch.stack(chi2s)


class CapturedOptimize(Graphed):
    """`optimize` as one CUDA graph, the counterpart of the JAX package's
    jitted lax.scan (gridmap_slam_tpu/models/posegraph.py:154-160): all
    the iterations over static graph buffers, captured at a graph's size
    and replayed once a call.  One graph of every iteration rather than
    one step replayed a time: the frontend's iteration count is fixed
    (FrontendConfig.gn_iterations), and the whole solve is then one replay
    with no counter and no copy back between steps.

    Keyed by the graph's shapes and dtypes, the iterations and the
    damping: a graph that grew (new closures, chain breaks) recaptures.
    The products stay float32 under f32_matmul inside the capture, and
    the graph holds the kernels cuBLAS and cuSOLVER chose then, whatever
    the TF32 flag says at a later replay.  Calling it returns (graph,
    chi2) as `optimize` does, fresh tensors with the eager bits."""

    def __init__(self, device, solve: Callable = optimize):
        """solve(graph, iterations, damping) -> (graph, chi2): `optimize`,
        or the distributed one (parallel/ba.make_distributed_optimizer,
        whose psums the graph then holds)."""
        super().__init__(self._body, device)
        self._solve = solve
        self._key = None
        self.static = None          # the PoseGraph the graph reads
        self._iterations, self._damping = 0, 0.0
        self._out = None

    def _body(self):
        graph, chi2 = self._solve(self.static, self._iterations,
                                  self._damping)
        self._out = graph.nodes, chi2

    def __call__(self, graph: PoseGraph, iterations: int = 10,
                 damping: float = 1e-6) -> Tuple[PoseGraph, torch.Tensor]:
        key = (tuple((tuple(x.shape), x.dtype) for x in leaves(graph)),
               iterations, damping)
        if key != self._key:
            self._key = key
            self.static = tree_map(torch.clone, graph)
            self._iterations, self._damping = iterations, damping
            self.capture()
        else:
            tree_map(copy_into, self.static, graph)
        self.run()
        nodes, chi2 = self._out
        return dataclasses.replace(graph, nodes=nodes.clone()), chi2.clone()


# --------------------------------------------------------------- loop closure
class ClosureProposals(NamedTuple):
    pairs: np.ndarray          # (C, 2) keyframe index pairs (i < j)


def propose_closures(poses: np.ndarray, min_gap: int = 10,
                     max_dist: float = 1.0, max_candidates: int = 64
                     ) -> ClosureProposals:
    """Host-side candidate generation: keyframe pairs that are spatially close
    but temporally distant (odometry says 'near', the graph hasn't linked
    them).  When the candidate set exceeds `max_candidates` the LATEST pairs
    are kept (late closures span the most drift and are the valuable ones)
    and the truncation is logged."""
    p = np.asarray(poses)
    k = len(p)
    pairs = []
    for j in range(k):
        d = np.linalg.norm(p[:j - min_gap + 1, :2] - p[j, :2], axis=1) \
            if j - min_gap + 1 > 0 else np.empty((0,))
        for i in np.nonzero(d < max_dist)[0]:
            pairs.append((i, j))
    if len(pairs) > max_candidates:
        import logging
        logging.getLogger(__name__).warning(
            "propose_closures: %d candidates > max_candidates=%d; keeping "
            "the latest %d", len(pairs), max_candidates, max_candidates)
        pairs = pairs[-max_candidates:]
    return ClosureProposals(
        pairs=np.asarray(pairs, np.int32).reshape(-1, 2))


def closure_scans(scans: Scan, matcher_cfg, beam_lut_bins=2048):
    """A batch of closure scans (C, B) prepared once (F6 on the card): the
    bin tables of each as a local map's, its endpoints and used beams at
    the matcher's coarse stride as a matched scan's."""
    return prepare_scan(scans, None, beam_lut_bins,
                        stride=max(int(matcher_cfg.coarse_beam_stride), 1))


def verify_closure(scan_i, scan_j, rel_guess, *, map_cfg,
                   matcher_cfg, motion_cfg, sensor_cfg, taps,
                   beam_lut_bins=2048):
    """Score a batch of C candidate closures (i, j): for each, build a
    local grid from scan_i at the origin and correlatively match scan_j
    starting from the odometry-implied relative pose.  scan_i, scan_j:
    (C, B) scans, or their closure_scans; rel_guess: (C, 3); taps: the
    blur kernel as a tensor.  Returns (refined_rel (C, 3),
    mean_beam_loglik (C,)), the measurement log-likelihood at the best
    pose per used beam (the uniform level is log(1/max_range))."""
    c = rel_guess.shape[0]
    dev = rel_guess.device
    origin = (float(map_cfg.origin[0]), float(map_cfg.origin[1]))
    res = float(map_cfg.resolution)
    # cone_fill: a single scan's 1-cell-wide rays leave the local field
    # dominated by blurred unknown; carving the whole visibility polygon
    # makes free space free.
    tables_i = (scan_i.tables if isinstance(scan_i, ScanPrep)
                else bin_tables(scan_i, beam_lut_bins))
    if not isinstance(scan_j, ScanPrep):
        scan_j = closure_scans(scan_j, matcher_cfg, beam_lut_bins=0)
    zero = torch.zeros((c, map_cfg.cells_y, map_cfg.cells_x),
                       dtype=torch.float32, device=dev)
    local = integrate_scan_batch(
        zero, torch.zeros((c, 3), dtype=torch.float32, device=dev),
        torch.ones((), device=dev), *tables_i,
        resolution=res, origin=origin, l_free=sensor_cfg.l_free,
        l_occ=sensor_cfg.l_occ, tol_cells=sensor_cfg.hit_tolerance_cells,
        cone_fill=True)
    llf = log_likelihood_field_batch(local, taps, z_hit=matcher_cfg.z_hit,
                                     max_range=sensor_cfg.max_range)
    zc = torch.zeros((c,), dtype=torch.float32, device=dev)
    rel, logscore = correlative_match_batch(
        llf, scan_j, rel_guess, Odom(d_center=zc, d_theta=zc),
        matcher_cfg=matcher_cfg, motion_cfg=motion_cfg, resolution=res,
        origin=origin, max_range=sensor_cfg.max_range)
    return rel, logscore / scan_j.n_used


def _se2_inverse(rel):
    c, s = torch.cos(rel[..., 2]), torch.sin(rel[..., 2])
    return torch.stack([-(c * rel[..., 0] + s * rel[..., 1]),
                        -(-s * rel[..., 0] + c * rel[..., 1]),
                        -rel[..., 2]], -1)


def verify_closure_bidirectional(scan_i: Scan, scan_j: Scan, rel_guess, *,
                                 map_cfg, matcher_cfg, motion_cfg,
                                 sensor_cfg, taps, beam_lut_bins=2048):
    """Two-way verification of C candidates: match j against i's local map,
    then i against j's map starting from the inverse of the forward result
    (a second batch).

    Returns (rel_fwd (C, 3), min_score (C,), consistency_m (C,)):
      min_score      - the worse of the two per-beam mean log-likelihoods;
      consistency_m  - | rel_fwd o rel_rev | translation magnitude; a true
                       closure composes to ~identity, perceptual aliasing
                       shows up as a large disagreement."""
    kw = dict(map_cfg=map_cfg, matcher_cfg=matcher_cfg, motion_cfg=motion_cfg,
              sensor_cfg=sensor_cfg, taps=taps, beam_lut_bins=beam_lut_bins)
    # each scan prepared once, as a local map's tables one way and as the
    # matched scan the other
    prep_i, prep_j = (closure_scans(x, matcher_cfg, beam_lut_bins)
                      for x in (scan_i, scan_j))
    rel_f, s_f = verify_closure(prep_i, prep_j, rel_guess, **kw)
    rel_r, s_r = verify_closure(prep_j, prep_i, _se2_inverse(rel_f), **kw)
    c, s = torch.cos(rel_f[:, 2]), torch.sin(rel_f[:, 2])
    dx = rel_f[:, 0] + c * rel_r[:, 0] - s * rel_r[:, 1]
    dy = rel_f[:, 1] + s * rel_r[:, 0] + c * rel_r[:, 1]
    return rel_f, torch.minimum(s_f, s_r), torch.sqrt(dx * dx + dy * dy)
