"""The port's tracker with its Gauss-Newton sums and pose arithmetic in
float32 or float64: step times and card-vs-CPU track gaps on the H100.

The port sums each Gauss-Newton system in float64 (``ops/icp._sums``) and
does the pose arithmetic between iterations in float64
(``tracking/odometry``: ``current_pose``, ``apply_increment``,
``so3_bases``, ``so3_update``, ``rgb_warp``), each rounded to float32 once.
This script runs ``chip_smoke.py``'s dense-step cell (bootstrap + 15 steps
of the orbit at 640x480 under its bench config) with those parts swapped
in the process, in the order given, then reversed, ``--passes`` times in
all:

  tree     the port as it is in ``--root``
  f32      the sums by a float32 matrix product and the pose arithmetic in
           float32 (the tracker before the float64 sums)
  f32pose  the tree's sums, the pose arithmetic in float32
  f64red   the sums' float64 products formed elementwise and reduced over
           the pixels (instead of a float64 matrix product), the pose
           arithmetic as the tree's

and prints per run the median step and the median ``odometry.track`` call
(synchronised around it) over steps 4-15, and the ATE; per variant, the
profiler's device ops and device busy time per step (two steps of a
second short run).  For each
variant in ``--check`` it then runs each tracking mode of ``--modes``
(``chip_smoke.TRACKING_MODES`` and the default) for
``chip_smoke.MODE_STEPS`` steps and repeats every track on the CPU: the
largest gap of each mode, every track's gap, and the tracks over 1e-4.
It also times the sum forms alone at each pyramid level's pixel count
(CUDA events, a spin kernel queued first).

    python3 scripts/torch_track_sums.py [--root DIR] [--variants tree,f32,...]
        [--passes 2] [--check tree,...] [--modes default,topk,...] [--out FILE]

``--root`` is the checkout whose ``hrbffusion3d_tpu_torch`` and
``chip_smoke.py`` run (default: the one holding this script); ``f32pose``
and ``f64red`` need the float64 tracker, ``tree`` and ``f32`` run on any.
The last line of its output is a JSON object of every number; ``--out``
writes it to a file too.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
GAP_TOL = 1e-4
SUM_SIZES = (640 * 480, 320 * 240, 160 * 120)


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(REPO))
    p.add_argument("--variants", default="tree")
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--check", default="")
    p.add_argument("--modes", default="")
    p.add_argument("--out", default="")
    return p.parse_args()


def _sums_f32(rows, weight=None):
    wr = rows if weight is None else rows * weight[:, None]
    return wr.T @ rows


def _sums_f64mm(rows, weight=None):
    wr = rows if weight is None else rows * weight[:, None]
    return wr.double().T @ rows.double()


def _sums_f64red(rows, weight=None):
    wr = rows if weight is None else rows * weight[:, None]
    return (wr.double()[:, :, None] * rows.double()[:, None, :]).sum(0)


def _pose_f32(lie):
    """The tracker's pose arithmetic in float32."""
    import torch

    def current_pose(prev_T, result_rt):
        return prev_T @ lie.se3_inverse(result_rt)

    def apply_increment(result_rt, x):
        inc = torch.eye(4, dtype=torch.float32, device=x.device)
        inc[:3, :3] = lie.so3_exp(x[3:])
        inc[:3, 3] = x[:3]
        return inc @ result_rt

    def so3_bases(K, R_lr, Kinv):
        return K @ R_lr @ Kinv, K @ R_lr

    def so3_update(w, R_lr):
        return lie.so3_exp(w) @ R_lr

    def rgb_warp(K, Kinv, result_rt):
        rt_inv = lie.se3_inverse(result_rt)
        return K @ rt_inv[:3, :3] @ Kinv, K @ rt_inv[:3, 3]

    return dict(current_pose=current_pose, apply_increment=apply_increment,
                so3_bases=so3_bases, so3_update=so3_update, rgb_warp=rgb_warp)


class Variant:
    """Swap the port's sums and pose arithmetic in the process while
    active."""

    def __init__(self, name, icp, odometry, lie):
        self.saved, self.patches = [], []
        if name not in ("tree", "f32", "f32pose", "f64red"):
            raise SystemExit(f"unknown variant {name}")
        if not hasattr(icp, "_sums"):
            # the float32 tracker: "tree" and "f32" are the tree as it is
            if name not in ("tree", "f32"):
                raise SystemExit(f"variant {name} needs the float64 tracker (ops/icp._sums)")
            return
        sums = {"f32": _sums_f32, "f64red": _sums_f64red}.get(name)
        if sums is not None:
            self.patches.append((icp, "_sums", sums))
        if name in ("f32", "f32pose"):
            self.patches += [(odometry, k, v) for k, v in _pose_f32(lie).items()]

    def __enter__(self):
        for mod, attr, fn in self.patches:
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []


def _main_path(cs, torch, poses, frames):
    """bootstrap + 15 steps; (step ms, track ms, ATE mm)."""
    cfg = cs.BENCH_CFG
    track_ms = []
    fn = cs.odometry.track

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        track_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    cs.odometry.track = timed
    try:
        state = cs.slam.bootstrap(frames[0], cs.TUM1, cfg, init_pose=poses[0])
        est, step_ms = [cs.lie.rt_to_mat(state.R, state.t)], []
        for f in frames[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = cs.slam.step(state, f, cs.TUM1, cfg)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            est.append(cs.lie.rt_to_mat(state.R, state.t))
    finally:
        cs.odometry.track = fn
    est_np = torch.stack(est).cpu().numpy()
    ate = cs.ate_rmse(est_np, poses[:len(est)], align=False)
    return step_ms, track_ms, ate * 1e3


def _profiled(cs, torch, poses, frames) -> dict:
    """Device ops and device busy ms per step over steps 2-3 of a short
    run (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = cs.BENCH_CFG
    state = cs.slam.bootstrap(frames[0], cs.TUM1, cfg, init_pose=poses[0])
    state = cs.slam.step(state, frames[1], cs.TUM1, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[2:4]:
            state = cs.slam.step(state, f, cs.TUM1, cfg)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return {"device_ops_per_step": sum(e.count for e in events) / 2,
            "device_busy_ms_per_step": sum(cs._dev_time(e) for e in events) / 2e3}


def _track_gaps(cs, torch, name, cfg, poses, frames):
    """Every track of a MODE_STEPS run of ``cfg``, card against CPU."""
    calls = []
    with cs._tracks(calls):
        state = cs.slam.bootstrap(frames[0], cs.TUM1, cfg, init_pose=poses[0])
        for f in frames[1:cs.MODE_STEPS + 1]:
            state = cs.slam.step(state, f, cs.TUM1, cfg)
    torch.cuda.synchronize()
    gaps = []
    for args, kwargs, card in calls:
        prev_R, prev_t, inp, intr = args[:4]
        cpu_inp = cs.odometry.TrackingInputs(*(tuple(x.cpu() for x in f) for f in inp))
        cpu = cs.odometry.track(prev_R.cpu(), prev_t.cpu(), cpu_inp, intr, cfg,
                                rgb_only=kwargs.get("rgb_only", False))
        gaps.append((cs._rot_gap(card.R, cpu.R), float((card.t.cpu() - cpu.t).abs().max())))
    over = [i for i, (r, t) in enumerate(gaps) if r > GAP_TOL or t > GAP_TOL]
    return {"rad": [g[0] for g in gaps], "m": [g[1] for g in gaps],
            "max_rad": max(g[0] for g in gaps), "max_m": max(g[1] for g in gaps),
            "tracks_over_1e-4": over}


def _time_sums(torch, cs) -> dict:
    """ms of each sum form alone on (N, 7) rows, per pyramid level's N."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in SUM_SIZES:
        rows = torch.randn(n, 7, device="cuda", generator=g)
        w = torch.rand(n, device="cuda", generator=g)
        row = {}
        for name, fn in (("f32", _sums_f32), ("f64mm", _sums_f64mm), ("f64red", _sums_f64red)):
            fn(rows, w)
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(cs.PRIME_CYCLES)
                a.record()
                fn(rows, w)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            row[name] = float(np.median(times))
        out[n] = row
        print(f"sums alone, N={n}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))
    return out


def main() -> None:
    a = _args()
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from hrbffusion3d_tpu_torch.core import lie
    from hrbffusion3d_tpu_torch.ops import icp
    from hrbffusion3d_tpu_torch.tracking import odometry

    name, smi = cs.phase_card()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    poses, frames = cs.phase_frames(dev)
    variants = [v for v in a.variants.split(",") if v]
    modes = [m for m in a.modes.split(",") if m] or ["default", *cs.TRACKING_MODES]
    out = {"root": str(root), "device": smi, "sums_alone_ms": _time_sums(torch, cs),
           "runs": [], "profiled": {}, "gaps": {}}
    for v in variants:
        with Variant(v, icp, odometry, lie):
            prof = out["profiled"][v] = _profiled(cs, torch, poses, frames)
        print(f"{v}: profiler {prof['device_ops_per_step']:.0f} device ops per step, device "
              f"busy {prof['device_busy_ms_per_step']:.2f} ms per step")
    order = [variants if i % 2 == 0 else variants[::-1] for i in range(a.passes)]
    for v in [v for block in order for v in block]:
        with Variant(v, icp, odometry, lie):
            step_ms, track_ms, ate = _main_path(cs, torch, poses, frames)
        run = {"variant": v, "median_step_ms": float(np.median(step_ms[3:])),
               "median_track_ms": float(np.median(track_ms[3:])), "ate_mm": ate,
               "step_ms": step_ms, "track_ms": track_ms}
        out["runs"].append(run)
        print(f"{v}: median step {run['median_step_ms']:.2f} ms, median track "
              f"{run['median_track_ms']:.2f} ms (steps 4-15), ATE {ate:.3f} mm; {smi}")
    for v in [c for c in a.check.split(",") if c]:
        with Variant(v, icp, odometry, lie):
            for m in modes:
                cfg = cs.BENCH_CFG if m == "default" else dataclasses.replace(
                    cs.BENCH_CFG, **cs.TRACKING_MODES[m])
                g = out["gaps"].setdefault(v, {})[m] = _track_gaps(cs, torch, m, cfg, poses,
                                                                   frames)
                print(f"{v} {m}: every track card vs CPU, largest {g['max_rad']:.3g} rad, "
                      f"{g['max_m']:.3g} m; over 1e-4: {g['tracks_over_1e-4']} "
                      f"(rad {', '.join(f'{x:.3g}' for x in g['rad'])})")
    line = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
