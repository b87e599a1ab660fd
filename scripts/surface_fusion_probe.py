"""F4-F6 (csrc/fusions.cu: the surface sample and hill-climb, the splat's
tap weights, the scan's preparation) on the card in one short call.

Builds the kernels (nvcc -Xptxas -v: F4-F6's registers and spills), runs
two scans of each of mega (1M particles), mega with two hill-climb steps,
city (1M particles, a 512-cell crop), the parity RBPF (192 beam slots) and
multi (two robots, 96 beam slots) with F1-F6's calls recorded and holds
each call against its plain version bit for bit (chip_smoke.check_fusion,
every differing call printed),
prints which order of the packed sample's eight-term sum PyTorch takes on
this card beside F4's (chip_smoke.sample_order) and F6 on planted scans
(chip_smoke.scan_ties), city's peak device memory over an eager step and
over its volume build alone beside the packed array's bytes, then mega's
captured replay over the 12-scan log: its kernel nodes a scan and its
final state's bits against the eager run's.  Exits 1 on a differing bit.

Usage (needs a GPU; ~2 min with the build):
    python scripts/surface_fusion_probe.py
"""

import contextlib
import io
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.device_phase()
    from gridmap_slam_tpu_torch import (RBPF, SharedMapSLAM, city_config,
                                        mega_config)
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import _build

    with contextlib.redirect_stdout(io.StringIO()):
        _, log = _build.build(verbose=True)
    usage = {k: v for k, v in _build.ptxas_usage(log).items()
             if "fusion" in k}
    cs.say("fusion_build", kernels=usage)
    frames, _ = cs.parity_log()

    def gen():
        return torch.Generator(device="cuda").manual_seed(cs.SEED)

    def check(calls) -> int:
        """check_fusion on each call; the number that differed."""
        bad = 0
        for call in calls:
            try:
                cs.check_fusion(*call)
            except AssertionError as e:
                print(f"differs: {str(e)[:400]}", flush=True)
                bad += 1
        return bad

    failed = 0

    runs = (("mega", SharedMapSLAM, mega_config()),
            ("mega refine", SharedMapSLAM, cs.refine_config()),
            ("city step", SharedMapSLAM, city_config()),
            ("parity", RBPF, cs.parity_config()))
    for name, engine, cfg in runs:
        eng = engine(cfg, device="cuda")
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device="cuda")
        with cs.CallRecorder(name, kernels=cs.FUSIONS) as rec:
            eng.run_log(eng.init(), [frame_at(batch, i) for i in range(2)],
                        gen())
            torch.cuda.synchronize()
        failed += check(rec.calls)
        del eng, batch, rec
        torch.cuda.empty_cache()
    meng, ticks, starts, _ = cs.multi_setup(32)
    with cs.CallRecorder("multi 32", kernels=cs.FUSIONS) as rec:
        meng.replay(meng.init(starts), ticks[:2], gen())
        torch.cuda.synchronize()
    failed += check(rec.calls)
    # the card's stable argsort of keys with planted zeros of both signs,
    # ties and +inf, at 96, 192 and 360 slots: the sorted positions of
    # the planted beams
    planted = {}
    for b in (96, 192, 360):
        keys = torch.linspace(-3.0, 3.0, b, device="cuda")
        keys[b - b // 8:] = float("inf")
        idx = [3, 10, 11, 14, 15, 20, 21, 22]
        vals = [0.0, 0.0, -0.0, -0.0, 0.0, 1.0, 1.0, 1.0]
        for i, v in zip(idx, vals):
            keys[i] = v
        order = torch.argsort(keys, stable=True).cpu().tolist()
        planted[b] = [i for i in order if i in idx]
    cs.say("argsort_planted", order_of=planted,
           indices=[3, 10, 11, 14, 15, 20, 21, 22],
           values="+0 +0 -0 -0 +0 1 1 1")
    s_args, s_kw = cs.FUSION_ARGS["F4"]
    order = cs.sample_order(*s_args, s_kw)
    differing = {}
    ties = cs.scan_ties(details=differing)
    cs.say("scan_ties_details", entries=differing)
    by = {}
    for row in cs.FUSION_CHECKS:
        by.setdefault(f"{row['path']} {row['kernel']}", []).append(
            {k: row[k] for k in ("bits_differing", "ms", "plain_ms",
                                 "bound_ms")})
    cs.say("surface_fusions", sample_order=order, scan_ties=ties, calls=by)

    # city's peak device memory over an eager step, and over its volume
    # build alone (the FFT's spectra), beside the packed array F4 spares
    from gridmap_slam_tpu_torch.models.shared import surface_volume
    from gridmap_slam_tpu_torch.ops.cuda.fusions import prepare_scan
    from gridmap_slam_tpu_torch.ops.motion import apply_odometry
    from gridmap_slam_tpu_torch.ops.resample import weighted_mean_pose
    eng = SharedMapSLAM(city_config(), device="cuda")
    cfg = eng.config
    batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                             device="cuda")
    g = gen()
    st, _ = eng.step_surface(eng.init(), frame_at(batch, 0), g)
    f1 = frame_at(batch, 1)

    def peak(fn) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    scan = prepare_scan(f1.scan, f1.odom, cfg.beam_lut_bins).scan
    center = apply_odometry(weighted_mean_pose(st.poses, st.log_weights),
                            f1.odom)
    mc = cfg.matcher
    cells = (mc.surface_nt + 1) * (mc.surface_crop_cells + 1) ** 2
    cs.say("city_peak", step_bytes=peak(lambda: eng.step_surface(st, f1, g)),
           volume_bytes=peak(lambda: surface_volume(
               cfg, eng.taps, st.logodds, scan, center)),
           packed_array_bytes=cells * 8 * 4)
    del eng, batch, st

    eng = SharedMapSLAM(mega_config(), device="cuda")
    batch = frames_to_device(frames, eng.config.max_beams,
                             eng.config.sensor.max_range, device="cuda")
    eager, _ = eng.run_log(eng.init(), [frame_at(batch, i)
                                        for i in range(len(frames))], gen())
    replay = eng.replay_surface_jit()
    st, _ = replay(eng.init(), batch, gen())
    cap = replay.captured
    nodes = dict(kernel_nodes_a_scan=len(cap.kernel_names()) / cap.scans,
                 nodes_by_type=cap.node_types(), scans=cap.scans,
                 captured_bits_equal_eager=all(
                     torch.equal(getattr(st, f), getattr(eager, f))
                     for f in ("poses", "log_weights", "logodds")))
    print(json.dumps({"mega_captured": nodes}), flush=True)
    ok = (not failed and nodes["captured_bits_equal_eager"]
          and not any(order["F4"])
          and not any(ties.values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
