"""F1-F3 (csrc/fusions.cu) on the card in one short call.

Builds the kernels (nvcc -Xptxas -v: F1-F3's registers and spills), runs
the parity preset's 12-scan log and the chip preset's (10 000 particles in
chunks of 500) with F1-F3's calls recorded, holds each call against its
plain version bit for bit (chip_smoke.check_fusion), prints which sum order
of a 2 x 2 block PyTorch's mean over the pooled axes takes on this card
beside F2's (chip_smoke.pool_order), and the kernel nodes a scan of both
presets' captured replays (RBPF.replay_jit, a 12-scan graph) with their
final state's bits against the eager run's.  Exits 1 on a differing bit.

Usage (needs a GPU; ~2 min with the build):
    python scripts/fusion_probe.py
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
    from gridmap_slam_tpu_torch import RBPF
    from gridmap_slam_tpu_torch.io import frame_at, frames_to_device
    from gridmap_slam_tpu_torch.ops.cuda import _build

    with contextlib.redirect_stdout(io.StringIO()):
        _, log = _build.build(verbose=True)
    usage = {k: v for k, v in _build.ptxas_usage(log).items()
             if "fusion" in k}
    cs.say("fusion_build", kernels=usage)
    frames, _ = cs.parity_log()
    chip = cs.parity_config().replace(num_particles=cs.CHIP_PARTICLES,
                                      particle_chunk=cs.CHIP_CHUNK)
    nodes = {}
    for name, cfg in (("parity", cs.parity_config()), ("chip", chip)):
        eng = RBPF(cfg, device="cuda")
        batch = frames_to_device(frames, cfg.max_beams, cfg.sensor.max_range,
                                 device="cuda")
        seq = [frame_at(batch, i) for i in range(len(frames))]

        def gen():
            return torch.Generator(device="cuda").manual_seed(cs.SEED)

        with cs.CallRecorder(name, kernels=cs.FUSIONS) as rec:
            eager, _ = eng.run_log(eng.init(), seq, gen())
            torch.cuda.synchronize()
        for call in rec.calls:
            cs.check_fusion(*call)
        replay = eng.replay_jit()
        st, _ = replay(eng.init(), batch, gen())
        cap = replay.captured
        nodes[name] = dict(
            kernel_nodes_a_scan=len(cap.kernel_names()) / cap.scans,
            nodes_by_type=cap.node_types(), scans=cap.scans,
            captured_bits_equal_eager=all(
                torch.equal(getattr(st, f), getattr(eager, f))
                for f in ("poses", "log_weights", "logodds")))
        del eng, batch, seq, replay, cap, st, eager
        torch.cuda.empty_cache()
    rows = cs.fusions_phase(cs.parity_config(), frames,
                            paths=("parity", "chip"))
    print(json.dumps({"nodes": nodes, "rows": rows}), flush=True)
    ok = all(n["captured_bits_equal_eager"] for n in nodes.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
