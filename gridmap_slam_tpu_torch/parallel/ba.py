"""Distributed pose-graph bundle adjustment over collectives.

Counterpart of gridmap_slam_tpu/parallel/ba.py: the edges are split over
mesh axis 'p'; each rank builds the dense partial normal equations H, b and
chi2 of its own edges (models/posegraph.normal_equations: J^T W J as a
dense product, float32 pinned by ops/precision), one all_reduce sums them
(for SE(2) pose graphs the nodes are the reduced variables, so the summed
system is the Schur-reduced one), and the damped solve runs replicated on
every rank (models/posegraph.damped_solve).  At 3000 keyframes H is
9000^2 float32, 324 MB a rank.

Edges are padded with zero-information edges to a multiple of the rank
count (`pad_edges`), which keeps them inert.  With jit=True every
iteration runs inside one CUDA graph with its all_reduce.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.posegraph import (CapturedOptimize, PoseGraph, damped_solve,
                                normal_equations)
from .mesh import axis_index, axis_size, psum


def make_distributed_optimizer(mesh, iterations: int = 10,
                               damping: float = 1e-6, anchor_w: float = 1e6,
                               jit: bool = False):
    """A Gauss-Newton optimizer over `mesh`'s 'p' axis: fn(graph) ->
    (graph, chi2 of each iteration's starting poses), where `graph` holds
    the replicated nodes and this rank's edges (shard_graph).  jit=True:
    the counterpart of the JAX optimizer's jit of its lax.scan, every
    iteration with its psum one CUDA graph over static node and edge
    buffers (models/posegraph.CapturedOptimize, captured again when the
    graph's size changes; `fn.captured` is it), the same static-buffer
    body on the CPU, and the eager optimizer's bits."""
    def optimize(graph: PoseGraph, iterations: int = iterations,
                 damping: float = damping) -> Tuple[PoseGraph, torch.Tensor]:
        nodes, chi2s = graph.nodes, []
        for _ in range(iterations):
            h, b, chi2 = normal_equations(nodes, graph.edge_i, graph.edge_j,
                                          graph.edge_z, graph.edge_w)
            k3 = h.shape[0]
            total = psum(torch.cat([h.reshape(-1), b, chi2[None]]), mesh,
                         "p")
            h, b = total[:k3 * k3].reshape(k3, k3), total[k3 * k3:-1]
            chi2s.append(total[-1])
            nodes = damped_solve(nodes, h, b, damping, anchor_w)
        return PoseGraph(nodes=nodes, edge_i=graph.edge_i,
                         edge_j=graph.edge_j, edge_z=graph.edge_z,
                         edge_w=graph.edge_w), torch.stack(chi2s)
    if not jit:
        return optimize
    solve = CapturedOptimize(mesh.device_type, solve=optimize)

    def optimize_jit(graph: PoseGraph) -> Tuple[PoseGraph, torch.Tensor]:
        return solve(graph, iterations, damping)
    optimize_jit.captured = solve
    return optimize_jit


def pad_edges(edge_i, edge_j, edge_z, edge_w, multiple: int):
    """Pad the edge set with zero-information edges to a multiple
    (inert)."""
    e = len(edge_i)
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return edge_i, edge_j, edge_z, edge_w
    return (np.concatenate([edge_i, np.zeros(pad, edge_i.dtype)]),
            np.concatenate([edge_j, np.zeros(pad, edge_j.dtype)]),
            np.concatenate([edge_z, np.zeros((pad, 3), edge_z.dtype)]),
            np.concatenate([edge_w, np.zeros((pad, 3), edge_w.dtype)]))


def shard_graph(graph_arrays, mesh, device="cuda") -> PoseGraph:
    """This rank's graph from the global (nodes, ei, ej, ez, ew) numpy
    arrays, edges already padded to a multiple of n_p: the nodes whole,
    the edges of this rank's contiguous slice."""
    nodes, ei, ej, ez, ew = graph_arrays
    n, i = axis_size(mesh, "p"), axis_index(mesh, "p")
    if len(ei) % n:
        raise ValueError(f"{len(ei)} edges do not split over {n} ranks "
                         f"(pad_edges first)")
    sl = slice(i * (len(ei) // n), (i + 1) * (len(ei) // n))

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a[sl] if a is not nodes else a,
                                          dtype), device=device)
    return PoseGraph(nodes=t(nodes, np.float32), edge_i=t(ei, np.int64),
                     edge_j=t(ej, np.int64), edge_z=t(ez, np.float32),
                     edge_w=t(ew, np.float32))
