"""F7 (the weights' tail) and F8 (the systematic walk) on the card, alone.

Builds the kernels with `-Xptxas -v` and prints F7's and F8's registers and
spills; holds F7's exp (csrc/fusions.cu weight_exp) to torch.exp bit for
bit over 1M values; then at P = 1, 7, 500, 1000, 1024, 1025, 10 000,
100 003 and 1 048 576 weights (one robot, and two robots at 10 000) holds
F7 (with and without the epilogue, the recovery EMAs at step 0 and after)
and F8 (its max and total F7's, its u0 drawn) against their plain versions
(ops/cuda/fusions.weights_plain, walk_plain: the op sequences they replace,
in ops/resample's fixed order on the card) in every output bit, on
log-weights spread wide and narrow, with ties at the max and with a NaN;
and times F7, F8, their plain versions and torch.softmax (the library call
for the normalized weights) at P = 500, 10 000 and 1 048 576 (CUDA events
around 20 calls after warm-up; the plain versions around 3).  One JSON line
a check, then a summary line; exits 1 on any differing bit.

Usage (needs a GPU; ~1 min with the build):
    python scripts/weights_probe.py
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZES = (1, 7, 500, 1000, 1024, 1025, 10_000, 100_003, 1_048_576)
TIMED = (500, 10_000, 1_048_576)
SEED = 0


def say(**fields):
    print(json.dumps(fields), flush=True)


def bits(a, b) -> int:
    """Elements whose bits differ (all of them where shapes differ)."""
    import torch
    if a is None or b is None:
        return 0 if a is None and b is None else -1
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel())
    if a.dtype.is_floating_point:
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return int((a != b).sum())


def ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    from gridmap_slam_tpu_torch.ops.cuda import _build, fusions
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    with contextlib.redirect_stdout(io.StringIO()):   # ptxas's report
        _, log = _build.build(verbose=True)
    say(check="registers", kernels={
        k: v for k, v in _build.ptxas_usage(log).items()
        if "weights" in k or "walk" in k or "fusion_exp" in k})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    failed = 0

    x = torch.cat([torch.rand(1 << 20, generator=gen, device=dev) * -120.0,
                   torch.tensor([0.0, -0.0, -87.0, -88.7, -103.9, -104.0,
                                 float("-inf"), float("nan"), 1.0, 10.0],
                                device=dev)])
    d = bits(fusions.weight_exp_cuda(x), torch.exp(x))
    failed += d != 0
    say(check="exp", values=x.numel(), bits_differing=d)

    def cases(p, r):
        shape = (r, p) if r > 1 else (p,)
        wide = torch.randn(shape, generator=gen, device=dev) * 40.0 - 500.0
        narrow = torch.randn(shape, generator=gen, device=dev) * 0.1
        ties = torch.floor(torch.randn(shape, generator=gen, device=dev))
        out = [("wide", wide), ("narrow", narrow), ("ties", ties)]
        if p > 1:
            nan = narrow.clone()
            nan.view(-1)[p // 2] = float("nan")
            out.append(("nan", nan))
        return out

    for p in SIZES:
        for r in ((1, 2) if p == 10_000 else (1,)):
            poses = (torch.rand((r, p, 3) if r > 1 else (p, 3),
                                generator=gen, device=dev) - 0.5) * 8.0
            for name, lw in cases(p, r):
                kws = [dict()]
                kws.append(dict(resample_fraction=0.5))
                if r == 1:
                    for step in (0, 5):
                        kws.append(dict(
                            resample_fraction=0.5,
                            recov=torch.tensor([-40.0, -45.0], device=dev),
                            step=torch.tensor(step, dtype=torch.int32,
                                              device=dev),
                            reinject=(0.05, 0.6)))
                for kw in kws:
                    got = fusions.weights_cuda(lw, poses, **kw)
                    want = fusions.weights_plain(lw, poses, **kw)
                    diff = {f: bits(a, b) for f, a, b in
                            zip(got._fields, got, want)}
                    failed += any(diff.values())
                    say(check="F7", weights=p, robots=r, case=name,
                        epilogue="resample_fraction" in kw,
                        recovery=kw.get("step") is not None and int(
                            kw["step"]), bits_differing=diff,
                        neff=got.neff.flatten()[0].item())
                if name == "nan":
                    continue
                for i in range(r):
                    row = lw[i] if r > 1 else lw
                    pr = poses[i] if r > 1 else poses
                    t = fusions.weights_cuda(row, pr)
                    u0 = torch.rand((), generator=gen, device=dev) / p
                    got = fusions.walk_cuda(row, u0, pr, t.max, t.total)
                    want = fusions.walk_plain(row, u0, pr, t.max, t.total)
                    diff = [bits(a, b) for a, b in zip(got, want)]
                    failed += any(diff)
                    say(check="F8", weights=p, robot=i, case=name,
                        bits_differing=diff,
                        distinct_ancestors=int(got[0].unique().numel()))

    for p in TIMED:
        lw = torch.randn(p, generator=gen, device=dev) * 3.0
        poses = torch.rand((p, 3), generator=gen, device=dev)
        t = fusions.weights_cuda(lw, poses)
        u0 = torch.rand((), generator=gen, device=dev) / p
        say(check="time", weights=p,
            f7_ms=ms(lambda: fusions.weights_cuda(lw, poses), 20),
            f7_plain_ms=ms(lambda: fusions.weights_plain(lw, poses), 3),
            softmax_ms=ms(lambda: torch.softmax(lw, -1), 20),
            f8_ms=ms(lambda: fusions.walk_cuda(lw, u0, poses, t.max,
                                               t.total), 20),
            f8_plain_ms=ms(lambda: fusions.walk_plain(lw, u0, poses, t.max,
                                                      t.total), 3))
    say(check="summary", failed=int(failed), card=card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
