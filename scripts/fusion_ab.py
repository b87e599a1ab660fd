"""F3 (a matcher stage's pick) and F7 (the weights' tail) of this tree
against another commit's, in one process on one card: bits and times.

The other tree (--root, an unpacked earlier commit) has its
csrc/fusions.cu and csrc/errors.cu built with its own nvcc flags into a
library of their own, bound with its own signatures; this tree's kernels
run through their wrappers (ops/cuda/fusions.pick_cuda, weights_cuda).
Both take the same inputs, made on the card from a seed: F3 at the
matcher's stages (coarse 11 x 9 x 9 with the scan's mask writing the next
offsets, fine 5 x 5 x 5 writing offsets, refine writing the best pose) at
250 particles (parity's chunk), 500 (chip's), 20 000 (multi's two robots
of 10 000) and 500 000 (mega_blocked's block); F7 at 500, 10 000 and
1 048 576 weights a robot with its epilogue (the shared map's, with the
recovery EMAs) and 2 x 10 000 (multi) without.  For each call: every
output of the two trees equal bit for bit (else exit 1); then, in turns
B A A B (B the other tree), its time by CUDA events around calls from
Python ("ev") and its device time inside a CUDA graph of REPS calls
("graph"), each kernel's device time a call (torch.profiler), beside its
bound (chip_smoke.fusion_bound).  Prints the card's
name and power limit first, a JSON line a call, and a summary line.

Usage (needs a GPU; ~2 min):
    python scripts/fusion_ab.py --root DIR
"""

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 20
ORDER = "BAAB"
PICK_PARTICLES = (250, 500, 20_000, 500_000)
STAGES = {"coarse": (11, 9, 9), "fine": (5, 5, 5), "refine": (5, 5, 5)}
WEIGHTS = ((1, 500, True), (1, 10_000, True), (1, 1 << 20, True),
           (1, 1 << 20, False), (2, 10_000, False))


def other_library(root: Path):
    """The other tree's F1-F8 library, built from its csrc with its flags,
    and its entry points' argument types."""
    spec = importlib.util.spec_from_file_location(
        "other_build", root / "gridmap_slam_tpu_torch/ops/cuda/_build.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    out = root / "gridmap_slam_tpu_torch/build/libfusions_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    csrc = root / "gridmap_slam_tpu_torch/csrc"
    subprocess.run([other._nvcc(), *other.NVCC_FLAGS, "-o", str(out),
                    str(csrc / "fusions.cu"), str(csrc / "errors.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("gs_fusion_pick", "gs_fusion_weights"):
        getattr(lib, name).argtypes = other.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _p(t):
    return 0 if t is None else t.data_ptr()


def pick_inputs(p, stage, gen, shape=None):
    """A stage's F3 arguments at p particles: random scores of STAGES[stage]
    (or `shape`, nt x ny x nx), offsets, poses and, at the coarse stage, a
    scan's mask; the next stage's offsets but after the refine stage."""
    nt, ny, nx = STAGES[stage] if shape is None else shape
    dev = "cuda"
    scores = torch.randn((p, nt, ny, nx), generator=gen, device=dev) - 30.0

    def offsets(m, span):
        return (torch.linspace(-span, span, m, device=dev)
                + (torch.rand((p, 1), generator=gen, device=dev) - 0.5) * 0.02)

    pose0 = (torch.rand((p, 3), generator=gen, device=dev) - 0.5) * 6.0
    center = pose0 + torch.randn((p, 3), generator=gen, device=dev) * 0.05
    use = (torch.rand(192, generator=gen, device=dev) < 0.7
           if stage == "coarse" else None)
    off = ((None, None) if stage == "refine" else
           (torch.linspace(-0.05, 0.05, 5, device=dev),
            torch.linspace(-0.02, 0.02, 5, device=dev)))
    d_c, d_t = (torch.tensor(v, device=dev) for v in (0.12, -0.2))
    return (scores, offsets(nx, 0.2), offsets(ny, 0.2), offsets(nt, 0.3),
            pose0, center, d_c, d_t, use, *off)


def other_pick(lib, args, motion, weight, stride):
    """The other tree's F3 on `args`, into outputs made here."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    scores, dxs, dys, dts, pose0, center, d_c, d_t, use, off_xy, off_t = args
    p, nt, ny, nx = scores.shape
    dev = scores.device
    if off_xy is not None:
        outs = tuple(torch.empty((p, 5), device=dev) for _ in range(3))
        best = meas = None
    else:
        outs = (None, None, None)
        best = torch.empty((p, 3), device=dev)
        meas = torch.empty(p, device=dev)
    b = 0 if use is None else use.shape[-1]

    def run():
        code = lib.gs_fusion_pick(
            *(_p(t) for t in (scores, dxs, dys, dts, pose0, center, d_c, d_t,
                              use, off_xy, off_t, *outs, best, meas)),
            p, nt, ny, nx, 1, 1, b, stride,
            0 if off_xy is None else 5, 0 if off_t is None else 5,
            float(weight), *fusions._motion_args(motion),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other tree's F3 launch failed: {code}")
        return [t for t in (*outs, best, meas) if t is not None]
    return run


def other_weights(lib, lw, poses, kw):
    """The other tree's F7 on lw, poses, into outputs made here."""
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    lead = tuple(lw.shape[:-1])
    r, p = math.prod(lead), lw.shape[-1]
    dev = lw.device
    nb = -(-p // 1024)
    finish = kw.get("resample_fraction") is not None
    recov = kw.get("recov")
    out = [torch.empty(r, device=dev), torch.empty(r, device=dev),
           torch.empty(r, dtype=torch.int64, device=dev),
           torch.empty((r, 3), device=dev), torch.empty(r, device=dev),
           torch.empty((r, 3), device=dev),
           torch.empty(r, dtype=torch.bool, device=dev) if finish else None,
           torch.empty(3, device=dev) if finish and not lead else None,
           torch.empty(2, device=dev) if recov is not None else None,
           torch.empty(1, device=dev) if recov is not None else None]
    sf = torch.empty(6 * r * nb, device=dev)
    si = torch.empty(r * nb + 2 * r, dtype=torch.int32, device=dev)
    thr = ((cs_f32(0.95 * p), cs_f32(p * kw["resample_fraction"]))
           if finish else (0.0, 0.0))
    launched = (ctypes.c_int * 1)()

    def run():
        code = lib.gs_fusion_weights(
            lw.data_ptr(), poses.data_ptr(), _p(recov), _p(kw.get("step")),
            *(_p(t) for t in out), sf.data_ptr(), si.data_ptr(), r, p, *thr,
            *(cs_f32(v) for v in kw.get("reinject", (0.0, 0.0))),
            cs_f32(fusions.P_INJECT_FORCE), cs_f32(fusions.P_INJECT_MAX),
            torch.cuda.current_stream().cuda_stream, launched)
        if code:
            raise RuntimeError(f"the other tree's F7 launch failed: {code}")
        return [t for t in out if t is not None]
    return run


def cs_f32(x):
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    return fusions._f32(x)


def kernel_ms(fn) -> dict:
    """Each kernel's device ms a call of fn (torch.profiler over REPS
    calls after a warm-up), by the kernel's function name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1][:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / REPS for k, v in out.items()}


def timed(runs: dict) -> dict:
    """{"A": fn, "B": fn} timed in turns ORDER: ev and graph ms each, and
    each kernel's device ms from the profiler."""
    out = {k: dict(ev=[], graph=[]) for k in runs}
    for k in ORDER:
        out[k]["ev"].append(cs.cuda_ms(runs[k], REPS))
        out[k]["graph"].append(cs.graph_ms(runs[k], REPS))
    for k in runs:
        out[k]["kernels"] = kernel_ms(runs[k])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the other tree (B)")
    args = ap.parse_args()
    cs.device_phase()
    from gridmap_slam_tpu_torch.config import MotionConfig
    from gridmap_slam_tpu_torch.ops.cuda import fusions
    lib = other_library(Path(args.root).resolve())
    motion = MotionConfig()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows, same = [], True
    for p in PICK_PARTICLES:
        for stage in STAGES:
            call = pick_inputs(p, stage, gen)
            kw = dict(motion=motion, prior_weight=0.7, stride=3)
            runs = {"A": lambda: fusions.pick_cuda(*call, **kw),
                    "B": other_pick(lib, call, motion, 0.7, 3)}
            equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(runs["A"](), runs["B"]()))
            bound, by = cs.fusion_bound("F3", call, kw)
            plan = fusions.pick_plan(p, *STAGES[stage])
            rows.append(dict(kernel="F3", particles=p, stage=stage,
                             lanes=plan.lanes, per_slab=plan.per_slab,
                             bits_equal=equal, bound_ms=bound, bound_by=by,
                             **timed(runs)))
            same &= equal
            cs.say("fusion_ab", **rows[-1])
            del call, runs
            torch.cuda.empty_cache()
    for r, p, epilogue in WEIGHTS:
        lw = torch.randn((r, p), generator=gen, device="cuda") * 2.0 - 3.0
        poses = (torch.rand((r, p, 3), generator=gen, device="cuda") - 0.5) * 8
        if r == 1:
            lw, poses = lw[0], poses[0]
        kw = {}
        if epilogue:
            kw = dict(resample_fraction=0.5,
                      recov=torch.tensor([-3.0, -2.5], device="cuda"),
                      step=torch.tensor(3, dtype=torch.int32, device="cuda"),
                      reinject=(0.001, 0.1))
        runs = {"A": lambda: cs._outputs(fusions.weights_cuda(lw, poses, **kw)),
                "B": other_weights(lib, lw, poses, kw)}
        got, want = runs["A"](), runs["B"]()
        equal = len(got) == len(want) and all(
            cs._bits_differing(a.reshape(b.shape), b) == 0
            for a, b in zip(got, want))
        bound, by = cs.fusion_bound("F7", (lw, poses), kw)
        rows.append(dict(kernel="F7", robots=r, weights=p,
                         epilogue=epilogue, bits_equal=equal,
                         launches=fusions.weights_plan(r, p).launches,
                         bound_ms=bound, bound_by=by, **timed(runs)))
        same &= equal
        cs.say("fusion_ab", **rows[-1])
    print(json.dumps({"summary": [
        {k: v for k, v in row.items() if k not in ("A", "B")}
        | {f"{k}_{m}": [round(x, 5) for x in row[k][m]]
           for k in ("A", "B") for m in ("ev", "graph")}
        | {f"{k}_kernels": {n: round(x, 5) for n, x in
                            row[k]["kernels"].items()} for k in ("A", "B")}
        for row in rows], "bits_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
