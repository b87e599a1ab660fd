"""Build and load the package's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by one `nvcc` call into a shared library
with a plain C interface, at first use, into `gridmap_slam_tpu_torch/build/`
(git-ignored).  The file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
library is bound with ctypes: pointers and the stream travel as `c_void_p`,
scalars as `c_int` or `c_float`, and every entry point returns the
`cudaGetLastError()` of its launch.

Nothing here runs when the module is imported: `nvcc` exists only on a
machine with the card, and the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# entry point -> argument types (the C signatures in csrc/*.cu)
SIGNATURES = {
    # lo, out, taps, radius, P, H, W, z_hit, c_rand, v_eq, then the launch
    # plan: small, tile_h, tile_w, threads, smem; stream
    "gs_ll_field": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
                    _I, _P],
    # lo, out, poses, keep, bin_dist, bin_alpha, bin_code, n_bins, G, P, H,
    # W, res, origin_x, origin_y, l_free, l_occ, tol_m, bin_scale,
    # cone_fill, stream
    "gs_grid_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _I, _P],
    # field, px, py, use, pose0, dxs, dys, dts, out, P, G_f, G_b, H, W, B,
    # nt, ny, nx, res, origin_x, origin_y, v_outside, nearest, then the
    # launch plan: shared, pitch, pairs a tile, run, splits, threads, smem;
    # stream
    "gs_stage_scores": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P],
    # &sm_count, &smem_block, &smem_sm
    "gs_device_limits": [_P, _P, _P],
}


def sources():
    """The CUDA sources the library is built from."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built only "
                           "on a machine with the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgridmap_kernels-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns its path and nvcc's output.  verbose=True always compiles, adds
    `-Xptxas -v` and prints that output (registers, shared memory and
    spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    if verbose:
        print(log, flush=True)
    os.replace(tmp, out)
    return out, log


def ptxas_usage(log: str) -> dict:
    """Each kernel's resources from a `-Xptxas -v` build log: its mangled
    name -> registers, static shared memory, stack frame and spill bytes."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = dict(registers=0, smem_bytes=0, stack_bytes=0,
                               spill_stores=0, spill_loads=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack_bytes=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return usage


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gs_error_string.argtypes = [ctypes.c_int]
    lib.gs_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().gs_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
