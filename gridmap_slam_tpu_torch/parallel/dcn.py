"""Runs across hosts: joining the world and the multi-host mesh.

Counterpart of gridmap_slam_tpu/parallel/dcn.py.  The layout rule of the
JAX package holds: the particle axis 'p' goes across hosts (particle
shards exchange nothing but weight statistics and, on resampling scans,
(log-weight, pose) rows), and the map-tile axis 'm' stays inside a host so
that halos and crop assembly ride the card-to-card links.

One process a card:

    from gridmap_slam_tpu_torch.parallel import dcn
    dcn.initialize("tcp://host0:29500", num_processes=8, process_id=rank)
    mesh = dcn.make_multihost_mesh(map_shards=4)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join a world of num_processes ranks at `coordinator` (a tcp://host:port
    address).  Unset arguments come from the environment: MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK.  The backend is NCCL where CUDA is
    available, else gloo.  Does nothing when a process group exists."""
    if dist.is_initialized():
        return
    if coordinator is None:
        coordinator = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def make_multihost_mesh(map_shards: int = 1):
    """The ('p', 'm') mesh over every process's rank with hosts on 'p': ranks
    are numbered host-major, so (n // map_shards, map_shards) keeps each
    host's ranks contiguous along 'p' and 'm' inside a host (map_shards
    must divide the ranks a host)."""
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               dist.get_world_size()))
    if local % map_shards:
        raise ValueError(f"map_shards={map_shards} must divide the "
                         f"{local} ranks of a host")
    return make_mesh(None, map_shards=map_shards, device=device)
