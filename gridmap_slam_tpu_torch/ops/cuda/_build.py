"""Build and load the package's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by an `nvcc` call of its own, all of them
started together, and the objects linked into one shared library with a
plain C interface, at first use, into `gridmap_slam_tpu_torch/build/`
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
_L = ctypes.c_longlong
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
    # lo, out, pose, keep, bin_dist, bin_alpha, bin_code, win, n_bins, Hf,
    # Wf, Hw, Ww, col0, res, origin_x, origin_y, l_free, l_occ, tol_m,
    # bin_scale, cone_fill, stream
    "gs_grid_update_window": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I,
                              _P],
    # field, px, py, use, pose0, dxs, dys, dts, out, P, G_f, G_b, H, W, B,
    # nt, ny, nx, res, origin_x, origin_y, v_outside, nearest, then the
    # launch plan: shared, pitch, pairs a tile, run, splits, threads, smem;
    # stream
    "gs_stage_scores": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P],
    # gs_stage_scores's arguments up to `nearest`, then the tile: c0,
    # w_loc, n_m, ext; then the shared variant's plan (pitch, pairs a tile,
    # run, splits, threads, smem) and the stream
    "gs_stage_scores_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # gs_stage_scores_tile's arguments up to `ext`, then the plan (run,
    # warps, grid, smem), the path counts (or null); stream
    "gs_stage_scores_tile_staged": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                    _F, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _P, _P],
    # theta, sin out, cos out, n; stream
    "gs_k1_rotation": [_P, _P, _P, _I, _P],
    # fpad, e, mass, out, scratch, Hp, Wp, K, nt, shift, then the launch
    # plan: runs, ksteps, pitch_w, smem, scratch words; stream, &launched
    "gs_surface_corr": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                        _I, _L, _P, _P],
    # fpad, e, scratch, Hp, Wp, K, nt, shift, ksteps, pitch_w, scratch
    # words, stream, &launched
    "gs_surface_corr_prep": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _L,
                             _P, _P],
    # smem_bytes, out (8 ints)
    "gs_surface_corr_clusters": [_I, _P],
    # &sm_count, &smem_block, &smem_sm
    "gs_device_limits": [_P, _P, _P],
    # a graph's conditional handle, pred (one bool on the card); stream
    "gs_set_conditional": [ctypes.c_uint64, _P, _P],
    # F1: pose, normals, d_center, d_theta, out_s, out_det, n, G, base_c,
    # rel_c, base_t, rel_t; stream
    "gs_fusion_motion": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                         _P],
    # F2: field, out, G, H, W, stride g, stride h, fill; stream
    "gs_fusion_pool": [_P, _P, _I, _I, _I, _L, _L, _F, _P],
    # F3: scores, dxs, dys, dts, pose0, center, d_center, d_theta, use,
    # off_xy, off_t, out_dxs, out_dys, out_dts, best, meas_best, P, nt, ny,
    # nx, G_o, G_b, B, stride, n_xy, n_t, then the launch plan: lanes,
    # particles a slab, staged; weight, base_c, rel_c, base_t, rel_t;
    # stream
    "gs_fusion_pick": [_P] * 16 + [_I] * 13 + [_F] * 5 + [_P],
    # F4: vol, poses, theta0, iy0, ix0, n_used, poses_out, scores_out, n,
    # nt, hc, wc, stride t, stride y, wrap_theta, steps, origin_x,
    # origin_y, 1 / res, 1 / dtheta, res, dtheta, temper, temp; stream
    "gs_fusion_sample": [_P] * 8 + [_I] * 4 + [_L, _L, _I, _I]
                        + [_F] * 6 + [_I, _F, _P],
    # F5: px, py, wgt, thetas, a_yw, a_x, nt, B, kc, 1 / res; stream
    "gs_fusion_splat": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # F6: angle, dist, hit, valid, d_center, d_theta, out_angle, out_dist,
    # t_dist, t_alpha, t_code, px, py, use, wgt, px_c, py_c, use_c, n_used,
    # keep, G, B, n_bins, 2 pi / n_bins, stride, keep_below, freeze; stream
    "gs_fusion_scan": [_P] * 20 + [_I, _I, _I, _F, _I, _F, _I, _P],
    # F7: lw, poses, recov, step, max, total, index, best, neff, weighted,
    # gate, integ, recov_out, p_inject, scratch f, scratch i, R, P,
    # thresholds (integ, gate), a_slow, a_fast, inject threshold, its
    # ceiling; the window: mode, its ints and floats (host arrays),
    # d_center, d_theta, center, thetas, cells; stream, &launched
    "gs_fusion_weights": [_P] * 16 + [_I, _I] + [_F] * 6 + [_I] + [_P] * 9,
    # F7's mesh form: pass, lw, poses, m, total, sums, candidates, ranks,
    # out, scratch f, scratch i, P; the epilogue's recov, step, index,
    # best, neff, gate, integ, recov_out, p_inject, its six floats and the
    # window (as F7's); stream, &launched
    "gs_fusion_weights_mesh": [_I] + [_P] * 6 + [_I] + [_P] * 3 + [_I]
                              + [_P] * 9 + [_F] * 6 + [_I] + [_P] * 9,
    # F8: lw, poses, u0, m, total, idx, poses_out, lw_out, scratch, P,
    # 1 / P; stream, &launched
    "gs_fusion_walk": [_P] * 9 + [_I, _F, _P, _P],
    # F8's mesh form: rows, u0, idx, poses_out, lw_out, scratch, scratch_i,
    # P, the slots' base and count, 1 / P; stream, &launched
    "gs_fusion_walk_mesh": [_P] * 7 + [_I] * 3 + [_F, _P, _P],
    # F7's exp (or F4's rsqrtf): x, out, n, rsqrt; stream
    "gs_fusion_exp": [_P, _P, _I, _I, _P],
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
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            cmd = [_nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            logs.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{stdout}{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = work / "lib.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        log = "".join(logs) + proc.stdout + proc.stderr
        if verbose:
            print(log, flush=True)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
