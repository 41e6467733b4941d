"""Time the port's unsharded default dense step of several checkouts on one
card, each in a process of its own, one after another (name them in ABBA
order: parent, change, change, parent, so that a drift of the card or the
host over the call shows as a gap between the two runs of one tree).

Each run renders ``chip_smoke``'s 16-frame 640x480 orbit with the
checkout's own code, then twice: ``slam.bootstrap`` and 12 tracked
``slam.step``s at ``chip_smoke.BENCH_CFG``, each step timed between two
``torch.cuda.synchronize`` calls, then 2 more steps under
``torch.profiler`` (device ops and device busy time per step).  It prints
one JSON line per run (median ms over steps 4-12 of both passes, every
timed step, device ops and busy ms per step, the final pose) and the
card's name and power limit.

    python3 scripts/torch_step_ab.py PARENT_DIR . . PARENT_DIR
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

STEPS, PROFILED = 12, 2


def one_run() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hrbffusion3d_tpu_torch.eval import synth
    from hrbffusion3d_tpu_torch.ops import kernels
    from hrbffusion3d_tpu_torch.pipeline import slam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build()
    scene = synth.default_room(dev)
    poses = synth.orbit_trajectory(cs.N_FRAMES, angle_per_frame=0.004)
    frames = [slam.FrameInput(*synth.render_frame(scene, p, cs.TUM1)) for p in poses]
    cfg, intr = cs.BENCH_CFG, cs.TUM1
    step_ms, ops, busy = [], [], []
    for _ in range(2):
        state = slam.bootstrap(frames[0], intr, cfg, init_pose=poses[0])
        times = []
        for f in frames[1:STEPS + 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = slam.step(state, f, intr, cfg)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(times)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in frames[STEPS + 1:STEPS + 1 + PROFILED]:
                state = slam.step(state, f, intr, cfg)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        ops.append(sum(e.count for e in events) / PROFILED)
        busy.append(sum(cs._dev_time(e) for e in events) / PROFILED / 1e3)
    return {"checkout": os.getcwd(),
            "median_step_ms": float(np.median([t for ts in step_ms for t in ts[3:]])),
            "step_ms": step_ms, "device_ops_per_step": ops, "device_busy_ms_per_step": busy,
            "t": state.t.tolist(), "map_count": int(state.map.count)}


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        sys.path.insert(0, os.getcwd())
        print("RUN " + json.dumps(one_run()), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    runs = []
    for d in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one"], cwd=d,
                             capture_output=True, text=True, timeout=900)
        line = [x for x in out.stdout.splitlines() if x.startswith("RUN ")]
        if out.returncode != 0 or not line:
            print(out.stdout[-3000:], out.stderr[-3000:], sep="\n")
            raise SystemExit(f"the run in {d} failed ({out.returncode})")
        run = json.loads(line[-1][4:])
        run["dir"] = d
        runs.append(run)
        print(json.dumps(run), flush=True)
    for r in runs:
        print(f"{r['dir']}: median step {r['median_step_ms']:.2f} ms, device ops per step "
              f"{r['device_ops_per_step']}, device busy ms per step "
              f"{[round(b, 3) for b in r['device_busy_ms_per_step']]} ({smi})")


if __name__ == "__main__":
    main()
