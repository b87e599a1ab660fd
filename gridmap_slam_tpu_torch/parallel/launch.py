"""Start n ranks of one function and wait for them.

`run_ranks(n, "module:function", payload)` starts n Python processes, each
joining a world of n ranks through a file rendezvous in a fresh temporary
directory (never a fixed port) and calling function(payload, rank, n) with
the world up; it kills every rank when one fails or the time limit passes,
and returns each rank's standard output.  The backend is gloo on the CPU
(each rank pinned to one thread) or NCCL with one card a rank; gloo with
CUDA tensors on one card is backend="gloo", device="cuda".

The rank side is this module run as a program:

    python -m gridmap_slam_tpu_torch.parallel.launch module:function \\
        RANK N RENDEZVOUS BACKEND DEVICE PAYLOAD
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

_ROOT = Path(__file__).resolve().parents[2]


def run_ranks(n: int, target: str, payload: str = "", *, backend="gloo",
              device="cpu", timeout: float = 600.0) -> List[str]:
    """Run target(payload, rank, n) on n ranks (module docstring); raises
    RuntimeError with the failing rank's output if any rank fails or the
    time limit passes.  Returns the ranks' standard outputs."""
    if device == "cuda" and backend == "nccl":
        import torch
        cards = torch.cuda.device_count()
        if n > cards:
            raise RuntimeError(f"{n} NCCL ranks need {n} cards, one a rank; "
                               f"this machine has {cards}")
    with tempfile.TemporaryDirectory(prefix="gridmap_ranks_") as tmp:
        rdv = f"file://{tmp}/rendezvous"
        penv = dict(os.environ)
        penv["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in penv.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gridmap_slam_tpu_torch.parallel.launch",
             target, str(r), str(n), rdv, backend, device, payload],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True, env=penv,
            cwd=str(_ROOT)) for r in range(n)]

        def output(r):
            logs[r].seek(0)
            return logs[r].read()

        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {n} failed "
                        f"({procs[bad[0]].returncode}):\n"
                        f"{output(bad[0])[-4000:]}")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{target} on {n} ranks passed its "
                                       f"time limit of {timeout} s")
                time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {n} failed "
                                       f"({p.returncode}):\n"
                                       f"{output(r)[-4000:]}")
            return [output(r) for r in range(n)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()


def _rank_main(argv) -> int:
    target, rank, n, rdv, backend, device, payload = argv
    rank, n = int(rank), int(n)
    import torch
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)
    elif backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=rdv, rank=rank,
                            world_size=n)
    try:
        mod, fn = target.split(":")
        getattr(importlib.import_module(mod), fn)(payload, rank, n)
        # leave the world together: a rank closes its connections only when
        # every rank has finished its collectives (told through a file store
        # beside the rendezvous, not through those connections), so none
        # reads from a peer that is gone
        left = dist.FileStore(rdv[len("file://"):] + ".left", n)
        left.set(f"rank{rank}", "done")
        left.wait([f"rank{r}" for r in range(n)])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
