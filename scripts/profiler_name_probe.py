"""Which kernel records torch.profiler names after a kernel the captured
graph does not run there: a captured replay of the parity preset and of
`mega` (the shared-map surface filter, whose K2 runs at batch 1), each
profiled once, with the records of the repo's kernels and of the
resample gates' set_conditional_kernel counted by name against the graph's
kernel nodes of each name (read from the graph), and each record named after
K2's batch-1 variant listed with its duration and the names of the
records before and after it.

Usage (needs a GPU; ~1 min): python scripts/profiler_name_probe.py
"""

import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

WATCH = ("set_conditional_kernel", "grid_update_kernel<false, false>",
         "grid_update_kernel<true, false>", "fusion_")


def main() -> int:
    cs.device_phase()
    from gridmap_slam_tpu_torch import RBPF, SharedMapSLAM, mega_config
    from gridmap_slam_tpu_torch.bench.layers import demangle
    from gridmap_slam_tpu_torch.io import frames_to_device
    from gridmap_slam_tpu_torch.models.captured import graph_kernel_names

    frames, _ = cs.parity_log()
    for name, eng, jit in (
            ("parity", RBPF(cs.parity_config(), device="cuda"), "replay_jit"),
            ("mega", SharedMapSLAM(mega_config(), device="cuda"),
             "replay_surface_jit")):
        batch = frames_to_device(frames, eng.config.max_beams,
                                 eng.config.sensor.max_range, device="cuda")
        replay = getattr(eng, jit)()

        def run():
            return replay(eng.init(), batch,
                          torch.Generator(device="cuda").manual_seed(0))

        run()
        torch.cuda.synchronize()
        held = Counter(demangle(n) for n in
                       graph_kernel_names(replay.captured.graph
                                          .raw_cuda_graph()))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = Counter(e.name for e in dev)
        rows = {w: dict(graph=sum(v for k, v in held.items() if w in k),
                        profiler=sum(v for k, v in seen.items() if w in k))
                for w in WATCH}
        odd = []
        for i, e in enumerate(dev):
            if "grid_update_kernel<false, false>" in e.name:
                odd.append(dict(
                    us=e.time_range.elapsed_us(),
                    before=dev[i - 1].name[:60] if i else None,
                    after=dev[i + 1].name[:60] if i + 1 < len(dev) else None))
        print(json.dumps(dict(path=name, scans=replay.captured.scans,
                              counts=rows, k2_batch1_records=odd)),
              flush=True)
        del replay, eng, batch
    return 0


if __name__ == "__main__":
    sys.exit(main())
