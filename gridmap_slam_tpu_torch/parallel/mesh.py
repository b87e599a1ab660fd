"""The world, the ('p', 'm') device mesh and the collectives of the
distributed engines, on torch.distributed.

Counterpart of gridmap_slam_tpu/parallel/mesh.py.  Axis 'p' carries the
particles (each rank holds P / n_p of them); axis 'm' carries column tiles
of the map (each rank holds W / n_m columns).  Rank (i, j) of the mesh
holds particle shard i and map tile j.

The JAX engines let shard_map place their collectives; here each is a
call on the process group of one mesh axis, named as in the JAX engines
so that the engine code reads like its counterpart: `psum`, `pmax`,
`all_gather` and `ppermute`, and `axis_index` / `axis_size`.  They use only
what both NCCL and gloo take: `all_reduce`, `all_gather_into_tensor`, and
`batch_isend_irecv` for `ppermute`.  Every call is made, also on an axis of
one rank, so that a world of one runs the same collectives (over NCCL on
the card) as a larger one.  While `recording()` is active each call is
kept with its payload bytes (parallel/comm_model.py's rows are held to
them).

The compiled steps (jit=True) capture these calls into a CUDA graph: NCCL
records them on the card, and a replay runs them without Python.  At a
world of one NCCL runs a collective as a copy on the card, or as nothing
where it is in place (all_reduce), so a graph's collectives show as copy
nodes, not kernels (models/captured.graph_node_types counts nodes by
type).

A world of one is the mesh (1, 1), not a fallback: `init_world` starts it
in-process when no launcher set RANK and WORLD_SIZE, over NCCL for a CUDA
device and gloo for the CPU, and never switches backends because one
failed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..convert import shard_arrays

AXES = ("p", "m")

_records: Optional[List[Tuple[str, str, int]]] = None
# all_gather_into_tensor, under the name newer releases give it
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_rendezvous: Optional[str] = None


def init_world(device="cuda") -> None:
    """Join the launcher's world (RANK and WORLD_SIZE set, env:// with
    MASTER_ADDR and MASTER_PORT) or start a world of one in this process
    (a file rendezvous in a fresh temporary directory).  The backend is
    NCCL for a CUDA device and gloo for the CPU.  A CUDA rank uses the card
    LOCAL_RANK (default 0).  Does nothing when a world exists."""
    global _rendezvous
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    _rendezvous = tempfile.mkdtemp(prefix="gridmap_world_")
    dist.init_process_group(
        backend, init_method=f"file://{_rendezvous}/rendezvous", rank=0,
        world_size=1)


def close_world() -> None:
    """Destroy the process group, if there is one, and the rendezvous
    directory of a world of one."""
    global _rendezvous
    if dist.is_initialized():
        dist.destroy_process_group()
    if _rendezvous is not None:
        shutil.rmtree(_rendezvous, ignore_errors=True)
        _rendezvous = None


def make_mesh(n_devices: Optional[int] = None, map_shards: int = 1,
              device="cuda") -> DeviceMesh:
    """The (n // map_shards, map_shards) mesh over the world's n ranks, with
    dims ('p', 'm').  n_devices, where given, must be the world size, and
    map_shards must divide it: a mesh is never silently reshaped."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of "
                         f"{n_devices} ranks; this world has {n}")
    if map_shards < 1 or n % map_shards:
        raise ValueError(f"map_shards={map_shards} does not divide the "
                         f"world of {n} ranks")
    return init_device_mesh(torch.device(device).type,
                            (n // map_shards, map_shards),
                            mesh_dim_names=AXES)


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis`."""
    return mesh.get_local_rank(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along `axis`."""
    return mesh.size(AXES.index(axis))


@contextlib.contextmanager
def recording():
    """Keep every collective called inside the block: a list of
    (collective, axis, payload bytes) — psum/pmax the reduced tensor,
    all_gather the gathered tensor, ppermute the tensor sent.  A call is
    kept where it runs in Python: every call of an eager step, and of a
    compiled one on the CPU; on the card a compiled step's warm-up and
    capture, and none of its replays."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def _record(kind: str, axis: str, nbytes: int) -> None:
    if _records is not None:
        _records.append((kind, axis, int(nbytes)))


def _reduce(x, mesh, axis, op, kind):
    y = x.detach().clone().contiguous()
    _record(kind, axis, y.numel() * y.element_size())
    dist.all_reduce(y, op=op, group=mesh.get_group(axis))
    return y


def psum(x, mesh: DeviceMesh, axis: str):
    """The sum of x over the ranks of `axis` (a new tensor)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def pmax(x, mesh: DeviceMesh, axis: str):
    """The elementwise maximum of x over the ranks of `axis`."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def all_gather(x, mesh: DeviceMesh, axis: str, tiled: bool = False):
    """x of every rank of `axis`, in axis order: stacked (n, ...) or, with
    tiled=True, concatenated along dim 0."""
    n = axis_size(mesh, axis)
    x = x.contiguous().reshape(-1) if x.dim() == 0 else x.contiguous()
    # gathered along dim 0, as gloo and NCCL both take it
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("all_gather", axis, out.numel() * out.element_size())
    _gather_into(out, x, group=mesh.get_group(axis))
    return out if tiled else out.reshape(n, *x.shape)


def ppermute(x, mesh: DeviceMesh, axis: str,
             perm: Sequence[Tuple[int, int]]):
    """Send x to the ranks `perm` names: for each (src, dst) pair (indices
    along `axis`), src sends its x to dst.  Returns what this rank
    received, or None where no pair sends to it (the JAX collective gives
    zeros there; the callers fill their own)."""
    me = axis_index(mesh, axis)
    group = mesh.get_group(axis)
    x = x.contiguous()
    ops, got = [], None
    for src, dst in perm:
        if src == me:
            _record("ppermute", axis, x.numel() * x.element_size())
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            got = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, got,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


def halo_cols(tile, width: int, mesh: DeviceMesh, fill: Optional[float]):
    """`tile` (..., H, Wt) with `width` columns of each neighbouring tile
    along 'm' appended (the left one's last, the right one's first).
    At the world's edges: `fill` columns, or, with fill=None, nothing (the
    tile extends only towards its neighbours).  Two ppermutes along the
    axis, none on an axis of one rank."""
    n = axis_size(mesh, "m")
    j = axis_index(mesh, "m")
    if width > tile.shape[-1] and n > 1:
        raise ValueError(f"a halo of {width} columns needs tiles at least "
                         f"that wide, got {tile.shape[-1]}")
    left = right = None
    if n > 1:
        left = ppermute(tile[..., -width:], mesh, "m",
                        [(i, i + 1) for i in range(n - 1)])
        right = ppermute(tile[..., :width], mesh, "m",
                         [(i + 1, i) for i in range(n - 1)])
    edge = tile.new_full(tile.shape[:-1] + (width,),
                         0.0 if fill is None else fill)
    parts = [left if j > 0 else (None if fill is None else edge), tile,
             right if j < n - 1 else (None if fill is None else edge)]
    return torch.cat([p for p in parts if p is not None], -1)


def shard_state(state, mesh: DeviceMesh, tiled: bool, device=None):
    """This rank's shard of a global state: a port state, or any object
    with the numpy arrays of a JAX state's fields (poses, log_weights,
    logodds, step and, for a shared map, recov).  poses and log_weights
    are sliced over 'p'; logodds, the shared (H, W) map or the RBPF's
    (P, H, W) maps, is sliced over 'p' where it has a particle axis and,
    with tiled=True, into its column tile over 'm'.  Returns a state of
    the same class as `state` where it is a port state, else a
    SharedMapState (2-D logodds) or SlamState (3-D)."""
    from ..models.shared import SharedMapState
    from ..types import SlamState

    def arr(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else \
            np.asarray(x)

    dev = torch.device(device) if device is not None else (
        state.poses.device if torch.is_tensor(state.poses)
        else torch.device("cpu"))
    local = shard_arrays(
        arr(state.poses), arr(state.log_weights), arr(state.logodds),
        n_p=axis_size(mesh, "p"), i_p=axis_index(mesh, "p"),
        n_m=axis_size(mesh, "m"), i_m=axis_index(mesh, "m"), tiled=tiled)
    fields = dict(zip(("poses", "log_weights", "logodds"),
                      (torch.as_tensor(a, device=dev) for a in local)))
    fields["step"] = torch.as_tensor(np.asarray(arr(state.step), np.int32),
                                     device=dev)
    if local[2].ndim == 2:
        fields["recov"] = torch.as_tensor(
            np.asarray(arr(state.recov), np.float32), device=dev)
        cls = SharedMapState
    else:
        cls = SlamState
    if dataclasses.is_dataclass(state) and isinstance(
            state, (SharedMapState, SlamState)):
        cls = type(state)
    return cls(**fields)


def gather_state(state, mesh: DeviceMesh, tiled: bool):
    """The global state from every rank's shard (the inverse of
    shard_state), on every rank: all_gathers over 'p' and, for a tiled
    map, over 'm'."""
    lo = state.logodds
    if lo.dim() == 3:                         # the RBPF's maps a particle
        lo = all_gather(lo, mesh, "p", tiled=True)
    if tiled:
        tiles = all_gather(lo, mesh, "m")
        lo = torch.cat(list(tiles.unbind(0)), -1)
    return dataclasses.replace(
        state, poses=all_gather(state.poses, mesh, "p", tiled=True),
        log_weights=all_gather(state.log_weights, mesh, "p", tiled=True),
        logodds=lo)
