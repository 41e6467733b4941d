"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's dense SLAM step — ``bootstrap`` then 15 ``step``s on
synthetic 640x480 RGB-D frames under the bench configuration — through its
four hand-written CUDA kernels, checks the trajectory and each kernel
against its plain PyTorch version, drives the sparse keyframe backend
(which has no hand-written kernel) and the full system (``FullSLAM``),
and prints:
  - the card's name and power limit (nvidia-smi);
  - each kernel source's build time, each kernel's ptxas registers and
    spills, and for every kernel the registers, spilled bytes and resident
    warps per SM the runtime reports (the K = 10 ray cast must stay within
    128 registers, unspilled, at 16 warps; the bilateral and PCA kernels
    unspilled);
  - the median ms per step, the host syncs of the last step and every
    kernel's launches on the main path;
  - each kernel (and each ray-cast refinement variant) against its plain
    version: error and times (CUDA events, median of 20): the kernel's
    device time (the card kept busy while the host issues the call), one
    call with the wrapper's host work in it (the card idle meanwhile)
    and the plain version's; the ray cast with two bounds, on the least work
    (the plain version's evaluations) and on the work the kernel does (its
    batched ladder); the bilateral and PCA kernels with two, on the least
    work and on the per-tap counts of their first design;
  - a short ``use_pallas=True`` run (the Pallas bilateral denominator);
  - a per-phase breakdown of the step (each phase synchronised), the
    device ops and busy time per step and each kernel's device time per
    launch on the step (torch.profiler);
  - the sparse keyframe backend at FullSLAM's production settings
    (``phase_backend``): six 640x480 keyframes inserted with a local BA
    after each, per keyframe the keypoints, landmarks, BA sizes, ms and
    host syncs of both calls, the profiler's device ops and busy time of
    the last one, and its checks against the CPU (detection, local BA, a
    128-camera PCG BA, the pose graph, quantisation; the solvers twice on
    the card, bit for bit), a JSON line ``{"backend": {...}}``;
  - the full system with TF32 on (``phase_full_system``): (a) the
    replayed out-and-back of tests/test_full_slam_loop.py at 640x480,
    with the test's drift and with it scaled to the test's pixels (a loop
    must fire and cut the error below 0.7 of itself), the closing
    ``correct()`` repeated bit for bit on the card and held to the CPU's
    on every keyframe its global BA determines (each keyframe's
    observations in it printed, and how far a 1e-7 nudge of the poses
    moves each keyframe on the CPU); (b) bench.py's
    full-system protocol, 121 frames async through ``process_batch``
    (fps steady and all-in, worst chunk, ATE under 5 cm, loops,
    ``archive_dropped``, active and archive counts, keyframes inserted of
    due, the worker's stage seconds, host syncs per chunk) and 21 of its
    frames through a synchronous ``process``, the next 10 as bare steps
    and through ``process``, 10 more profiled; each
    run with the kernels' launch counts reset before it and every kernel
    launched; a JSON line ``{"full_system": {...}}``;
  - the real-data entry point (``phase_run_tum``) on a TUM-format
    fixture it writes (bench.py's full-system frames, 41 at 640x480, PNG
    rows through all five filters): (a) ``python -m
    hrbffusion3d_tpu_torch.run_tum`` as a subprocess (exit 0, every
    artefact parsed, ATE gate, keyframes inserted = due; fps, ATE,
    keyframes, loops, ``archive_dropped``) and the same frames decoded
    beforehand through FullSLAM alone (fps), (b) ``--load-trajectory``
    replay (the input trajectory written back within 1e-6), (c) the same
    frames as .klg through the native loader and the Python reader, (d)
    checkpoint / resume (two runs and a resumed one, bit for bit when the
    two repeat), (e) 16 steps of splat prediction (``raycast_period`` 2;
    0 host syncs, the ray cast on the HRBF frames only), (f) the (a) map's
    accuracy against the scene and its mesh on the card, a subset against
    the CPU; PNG decode ms per filter type; a JSON line
    ``{"run_tum": {...}}``;
  - a JSON line ``{"kernels": [...]}``: per kernel its launches on the main
    path (the bilateral kernel's keyframe call site apart, and the
    launches of each ``phase_run_tum`` path beside them), max abs error
    against the plain version, both times and the bound (the least time
    the card could take for the same work);
  - last, ``{"ok": true, "device": {...}}``.
Every phase raises on failure; without a CUDA device the script raises
before printing any result.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from hrbffusion3d_tpu_torch import run_tum
from hrbffusion3d_tpu_torch.backend import ba, features, keyframes, loop, posegraph, vocab
from hrbffusion3d_tpu_torch.config import TUM1, SLAMConfig
from hrbffusion3d_tpu_torch.core import camera, lie
from hrbffusion3d_tpu_torch.eval import mesh, recon, synth
from hrbffusion3d_tpu_torch.eval.ate import ate_rmse
from hrbffusion3d_tpu_torch.io import klg, native_loader, ply, png, traj, tum
from hrbffusion3d_tpu_torch.map import surfel_map as sm
from hrbffusion3d_tpu_torch.ops import kernels, preprocess, pyramid, raycast
from hrbffusion3d_tpu_torch.pipeline import full_slam, slam
from hrbffusion3d_tpu_torch.tracking import odometry
from hrbffusion3d_tpu_torch.utils import checkpoint

N_FRAMES = 16
N_PALLAS_FRAMES = 6
# bench.py's configuration (the TPU layout switches are read and ignored)
BENCH_CFG = SLAMConfig(map_capacity=393216, predict_conf_threshold=0.2,
                       use_pallas_raycast=True, clean_compact_period=4,
                       raycast_block_height=16, raycast_bisection_iters=6,
                       raycast_false_position=3, clean_crowd_period=4)
RAYCAST_VARIANTS = {
    "false_position": BENCH_CFG,
    "bisection": dataclasses.replace(BENCH_CFG, raycast_bisection_iters=10,
                                     raycast_false_position=0),
    "ksection": dataclasses.replace(BENCH_CFG, raycast_bisection_iters=10,
                                    raycast_false_position=0, raycast_bisection_batch=7),
}
# the name of each kernel's __global__ function, as the profiler reports it
KERNEL_SYMBOLS = {"raycast_core": "raycast_kernel", "bilateral_filter": "bilateral_kernel",
                  "normal_pca": "pca_kernel", "curvature_gradient": "curvature_kernel"}
SOURCES = {"raycast_core": "raycast.cu", "bilateral_filter": "preprocess.cu",
           "normal_pca": "preprocess.cu", "curvature_gradient": "preprocess.cu"}
REPLACES = {"raycast_core": 476, "bilateral_filter": 74, "normal_pca": 140,
            "curvature_gradient": 605}   # wrapper lines in pallas_kernels.py
# H100 SXM peaks: device memory (NVIDIA data sheet); float32 instructions,
# one per lane per clock (the data sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations); special-function (MUFU) instructions,
# 16 per SM per clock: 132 SMs at the 1.98 GHz boost clock
MEM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
MUFU_PER_S = 132 * 16 * 1.98e9
# (float32, MUFU) instructions per tap or per pixel, counted from the CUDA
# sources: a fused multiply-add is one float32 instruction; an approximate
# square root, reciprocal, exp2, sine or cosine one MUFU instruction; an IEEE
# division is a MUFU reciprocal and about 6 float32 instructions around it,
# a sqrtf a MUFU reciprocal square root and about 5, an expf a MUFU exp2
# and about 4, an atan2f about 25 and a reciprocal, a sinf / cosf pair
# about 40 and none
DIV, SQRT, EXP = np.array([6, 1]), np.array([5, 1]), np.array([4, 1])
ATAN2, SINCOS = np.array([25, 1]), np.array([40, 0])
# float32 instructions of one exponential taken on the FMA pipe instead of
# the MUFU (Cody-Waite split: round, subtract, a degree-5 polynomial, the
# exponent's shift and add, a clamp)
EXP_ON_FMA = 11
OPS = {
    # the least work, which bounds the bilateral and PCA kernels: per
    # weighted bilateral tap sub, square, fma, fma into num, add into den
    # and one exponential (on either pipe: see _balanced); per PCA input
    # pixel the z > depth_min test, per tested tap (centre valid) sub and
    # compare, per accepted tap 2 sub, the count, 3 adds and 6 fma, per
    # valid pixel the eigen-solve of the current source
    # (one reciprocal of the count, 2 approximate roots, atan2f, a MUFU
    # sine and cosine, an approximate reciprocal square root)
    "bilateral_tap_least": np.array([5, 0]),
    "pca_stage_least": np.array([1, 0]),
    "pca_test_least": np.array([2, 0]),
    "pca_accept_least": np.array([12, 0]),
    "pca_pixel_least": np.array([120, 6]) + ATAN2,
    # the same kernels' first design (one pixel per thread, IEEE expf and
    # divisions), as its sources counted them: its bound then
    "bilateral_tap": np.array([6, 0]) + EXP,         # test, sub, mul, fma, fma, add
    "pca_test": np.array([3, 0]),                    # two compares, sub
    "pca_accept": np.array([12, 0]),                 # 3 sub, 3 add, 6 fma
    "pca_pixel": np.array([100, 0]) + 12 * DIV + 3 * SQRT + ATAN2 + SINCOS,  # eigen-solve
    # per input pixel: |n|^2, mask, T^2, 1/T^2, 60/T^4, c
    "curv_stage": np.array([12, 0]) + 2 * DIV,
    "curv_test": np.array([3, 0]),                   # sub, |.|, compare
    "curv_masked": np.array([9, 0]),                 # count, v, d2, support tests
    "curv_inside": np.array([66, 2]),                # the HRBF terms, sqrt + rcp
    # per pixel: principal curvatures, directions, normal, radius, validity
    "curv_pixel": np.array([95, 0]) + 22 * DIV + 6 * SQRT,
    # per input pixel: stability tests, T^2, 1/T^2, h = 20/T^2 10 n
    "ray_stage": np.array([18, 0]) + DIV,
    "ray_visit": np.array([2, 0]),                   # one ring tap tested
    "ray_select": np.array([5, 0]),                  # its projection for t0
    "ray_support": np.array([8, 0]),                 # one tap of the count at t0
    "ray_field": np.array([11, 1]),                  # one tap of one evaluation of f
    "ray_grad": np.array([30, 0]) + SQRT + DIV,      # one tap of the gradient
}
# spin cycles queued before a primed timing (~0.5 ms at 1.98 GHz), more
# than the host needs to issue one wrapper call
PRIME_CYCLES = 1_000_000
# the K = 10 ray cast's launch bounds: two blocks of 256 threads per SM
RAYCAST_MAX_REGISTERS = 128
RAYCAST_MIN_BLOCKS = 2
# the curvature sums against their plain version: each channel within this
# share of the summed magnitude of its terms (the check prints the plain
# float32 sums' own error against float64 in the same unit); the count
# channel exact
CURV_SUMS_RTOL = 1e-5
# k1, k2 divide by g_z^3 (hrbf.principal_curvatures): their rule holds
# where |g_z| >= this share of |g|; at most 1 % of the valid pixels may fall
# below it
CURV_COND_FLOOR = 0.1
# the sparse backend at FullSLAM's production settings (full_slam.py:90-91):
# a keyframe every keyframe_period = 10 frames of orbit_trajectory(60), local
# BA after each, the last keyframe's pose drifted
BACKEND_ARGS = dict(n_features=1024, fast_threshold=12.0, local_window=5,
                    ba_pad_min=(16384, 8192, 32))
BACKEND_N_FRAMES = 60
BACKEND_KF_FRAMES = (1, 11, 21, 31, 41, 51)
# tests/test_keyframes.py drifts se3_exp(TEST_DRIFT) at fx = 103 and asserts
# an error over 0.05 m before local BA and under 0.55 of it after.  Here the
# drift and the 0.05 m scale by 103 / TUM1.fx, so that the drift moves the
# keyframe's landmarks by as many pixels as there: at full size the unscaled
# drift (~15 px) puts every landmark outside the 4 px projection gate of
# insert_keyframe, the keyframe shares none and no BA can move it
TEST_DRIFT = np.array([0.06, -0.05, 0.04, 0.01, -0.015, 0.012], np.float32)
DRIFT_SCALE = 103.0 / TUM1.fx
BACKEND_DRIFT = TEST_DRIFT * DRIFT_SCALE
DRIFT_MIN, DRIFT_KEEP = 0.05 * DRIFT_SCALE, 0.55
# card against CPU: keypoints at the same pixel of their level, descriptor
# bits, solver poses (norm of se3_log of the difference) and chi2 (relative)
KP_AGREE, BITS_AGREE, POSE_TOL, CHI2_RTOL = 0.99, 0.995, 1e-4, 1e-4
# a keyframe's pose is determined by global BA from three observations (3-D
# points in the camera, three residuals each, not on one line); with fewer
# only the damping holds it and its pose follows rounding.  NUDGE: the size
# of the seeded change of the keyframe poses that shows which ones do
MIN_BA_OBS, NUDGE = 3, 1e-7
# the full system, (a): tests/test_full_slam_loop.py::
# test_loop_closure_fires_in_pipeline at 640x480 (a keyframe every 2 frames
# of a replayed out-and-back whose last 4 frames drift by STEP_XI each;
# the loop must cut the drifted trajectory's error below LOOP_KEEP of it)
LOOP_CFG = dataclasses.replace(BENCH_CFG, keyframe_period=2)
LOOP_BACKEND = dict(n_features=1024, fast_threshold=12.0, ba_pad_min=(16384, 8192, 32))
LOOP_ARGS = dict(min_score=0.05, min_inliers=12, consistency=1)
STEP_XI = np.array([0.11, -0.05, 0.045, 0.014, -0.017, 0.022], np.float32)
LOOP_KEEP = 0.7
# (b): bench.py's full-system protocol (bench.py:132-147) with async BA in
# chunks of keyframe_period frames, cut from 281 frames to FULL_FRAMES; a
# SYNC_FRAMES-frame synchronous run on the same frames beside it
FULL_CFG = dataclasses.replace(BENCH_CFG, keyframe_period=10, use_global_ba=True,
                               active_capacity=393216, archive_capacity=2097152)
FULL_FRAMES, SYNC_FRAMES, FULL_ATE_MAX = 121, 21, 0.05


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs only on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}")
    print(f"nvidia-smi: {smi}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build() -> dict:
    t0 = time.perf_counter()
    kernels.build()
    print(f"build: {len(set(SOURCES.values()))} sources loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for src in sorted(set(SOURCES.values())):
        secs = kernels.BUILD_SECONDS.get(src)
        print(f"build: {src} nvcc {'cached' if secs is None else f'{secs:.2f} s'}")
        for line in kernels.PTXAS.get(src, []):
            print(f"ptxas {src} {line}")
    cfg = BENCH_CFG
    attrs = {f"raycast_core K={k}": kernels.kernel_attributes(
                 "raycast_core", k, cfg.predict_window_multiplier) for k in (10, 16)}
    attrs["bilateral_filter"] = kernels.kernel_attributes("bilateral_filter")
    attrs["normal_pca"] = kernels.kernel_attributes("normal_pca")
    attrs["curvature_gradient"] = kernels.kernel_attributes(
        "curvature_gradient", cfg.curv_window)
    for name, a in attrs.items():
        print(f"attributes {name}: {a['registers']} registers, {a['local_bytes']} bytes "
              f"spilled per thread, {a['blocks_per_sm']} blocks = "
              f"{a['blocks_per_sm'] * 8} warps resident per SM")
    a = attrs["raycast_core K=10"]
    if (a["registers"] > RAYCAST_MAX_REGISTERS or a["local_bytes"] > 0
            or a["blocks_per_sm"] < RAYCAST_MIN_BLOCKS):
        raise RuntimeError(f"the K = 10 ray cast compiled outside its launch bounds: {a}")
    for name in ("bilateral_filter", "normal_pca"):
        if attrs[name]["local_bytes"] > 0:
            raise RuntimeError(f"the {name} kernel spills: {attrs[name]}")
    return attrs


def phase_frames(dev):
    scene = synth.default_room(dev)
    poses = synth.orbit_trajectory(N_FRAMES, angle_per_frame=0.004)
    frames = [slam.FrameInput(*synth.render_frame(scene, p, TUM1)) for p in poses]
    torch.cuda.synchronize()
    d = frames[0].depth
    if not (d.device.type == "cuda" and torch.isfinite(d).all()
            and (d > 0).float().mean() > 0.9):
        raise RuntimeError("synthetic frames are not valid depth images on the card")
    print(f"frames: {N_FRAMES} x {TUM1.width}x{TUM1.height} rendered on {d.device}")
    return poses, frames


@contextlib.contextmanager
def _sync_counts():
    """CUDA sync-debug mode over the block; yields the running counts
    [host synchronisations made by the main thread, those made by other
    threads: FullSLAM's keyframe worker]."""
    counts = [0, 0]

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message):
            counts[threading.current_thread() is not threading.main_thread()] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            yield counts
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _count_syncs_by_thread(fn):
    """(result of ``fn``, the host synchronisations made by the main thread
    in it, those made by other threads meanwhile)."""
    with _sync_counts() as counts:
        out = fn()
    return out, counts[0], counts[1]


def _count_syncs(fn):
    """(result of ``fn``, the host synchronisations it made)."""
    out, main, other = _count_syncs_by_thread(fn)
    return out, main + other


def _check_run(name, state, est, poses):
    """ATE, density and ICP bounds of a run (tests/test_slam_e2e.py)."""
    est_np = torch.stack(est).cpu().numpy()
    ate = ate_rmse(est_np, poses[:len(est)], align=False)
    dense = float(state.dense_frac)
    icp_count = float(state.last_icp_count)
    if not np.isfinite(est_np).all() or not torch.isfinite(state.pred_vertex).all():
        raise RuntimeError(f"{name}: non-finite poses or prediction")
    if not (ate < 0.025 and dense > 0.5 and icp_count > 2000):
        raise RuntimeError(f"{name} out of bounds: ATE {ate}, dense_frac {dense}, "
                           f"last_icp_count {icp_count}")
    return ate, dense, icp_count


def phase_main_path(poses, frames):
    """bootstrap + 15 steps; returns the final state, the launches of each
    kernel in this run and the median step.  Steps 4-14 are timed; the
    last step runs under sync-debug mode (which slows it) to count the host
    syncs a step makes."""
    cfg = BENCH_CFG
    step_ms = []
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    state = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
    torch.cuda.synchronize()
    boot_ms = 1e3 * (time.perf_counter() - t0)
    est = [lie.rt_to_mat(state.R, state.t)]
    for f in frames[1:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = slam.step(state, f, TUM1, cfg)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        est.append(lie.rt_to_mat(state.R, state.t))
    state, syncs = _count_syncs(lambda: slam.step(state, frames[-1], TUM1, cfg))
    est.append(lie.rt_to_mat(state.R, state.t))
    launches = dict(kernels.LAUNCHES)

    ate, dense, icp_count = _check_run("main path", state, est, poses)
    med = float(np.median(step_ms[3:]))
    print(f"main path: bootstrap {boot_ms:.1f} ms, median step {med:.2f} ms over steps "
          f"4-{len(step_ms)} (all timed steps ms: {', '.join(f'{x:.1f}' for x in step_ms)})")
    print(f"main path: ATE {ate * 1000:.3f} mm, dense_frac {dense:.4f}, "
          f"last_icp_count {icp_count:.0f}, map count {int(state.map.count)}, "
          f"host syncs in step {N_FRAMES - 1}: {syncs}, launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count != N_FRAMES:
            raise RuntimeError(f"{name} kernel launched {count} times, expected {N_FRAMES}")
    if syncs != 0:
        raise RuntimeError(f"the counted step made {syncs} host syncs")
    return state, launches, med


def _median_ms(fn, n=20, primed=False) -> float:
    """Median ms between CUDA events around one call of ``fn``.  Unprimed,
    the card idles while the host runs the wrapper, so the time holds that
    host work too; primed, a spin kernel queued first keeps the card busy
    meanwhile, so the time is the device's alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(n_bytes: float, n_ops) -> tuple[float, str]:
    """(least ms for the work, what bounds it) at the card's peaks;
    ``n_ops`` is (float32, MUFU) instructions."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = max(n_ops[0] / FP32_INSTR_PER_S, n_ops[1] / MUFU_PER_S)
    return 1e3 * float(max(t_bytes, t_ops)), "bytes" if t_bytes >= t_ops else "operations"


def _balanced(n_ops, n_exp: float) -> np.ndarray:
    """(float32, MUFU) instructions of ``n_ops`` plus ``n_exp``
    exponentials, the share f of them taken on the FMA pipe (EXP_ON_FMA
    each) chosen so that both pipes finish together: max(float32 time, MUFU
    time) is least over every f in [0, 1] where the two are equal."""
    a, m = float(n_ops[0]), float(n_ops[1])
    f = (((m + n_exp) / MUFU_PER_S - a / FP32_INSTR_PER_S)
         / (n_exp * (EXP_ON_FMA / FP32_INSTR_PER_S + 1 / MUFU_PER_S)))
    f = min(max(f, 0.0), 1.0)
    return np.array([a + f * n_exp * EXP_ON_FMA, m + (1 - f) * n_exp])


def phase_raycast_vs_plain(state):
    """The ray cast against raycast_core_ref on the last frame's attribute
    image (the final map rendered at the final pose), for the bench variant
    (false position), the default one (bisection) and k-section."""
    pose_inv = lie.se3_inverse(lie.rt_to_mat(state.R, state.t))
    idx = sm.render_index(state.map, pose_inv, TUM1)
    attr = sm.render_attr_image(state.map, idx, pose_inv)
    attr9 = torch.cat([attr[..., 0:sm.A_RADIUS + 1],
                       attr[..., sm.A_VALID:sm.A_VALID + 1]], dim=-1).contiguous()
    results = {}
    for variant, cfg in RAYCAST_VARIANTS.items():
        out = kernels.raycast_core(attr9, TUM1, cfg)
        *ref, st = kernels.raycast_core_ref(attr9, TUM1, cfg, stats=True)
        torch.cuda.synchronize()
        f_k, f_r = out[3], ref[3]
        agree = (f_k == f_r).float().mean().item()
        both = f_k & f_r
        max_err = (out[0] - ref[0]).abs().amax(-1)[both].max().item()
        gk = torch.nn.functional.normalize(out[1][both], dim=-1)
        gr = torch.nn.functional.normalize(ref[1][both], dim=-1)
        dots = ((gk * gr).sum(-1) > 0.9999).float().mean().item()
        near = (out[2][both] == ref[2][both]).float().mean().item()
        ms = _median_ms(lambda: kernels.raycast_core(attr9, TUM1, cfg), primed=True)
        call_ms = _median_ms(lambda: kernels.raycast_core(attr9, TUM1, cfg))
        plain_ms = _median_ms(lambda: kernels.raycast_core_ref(attr9, TUM1, cfg))
        # the work, from the plain version's counts: per pixel f0, the
        # ladder up to the bracket and the refinement (least work) or the
        # kernel's batched ladder and k-section (work done), the count at
        # t0 and the gradient, each over the selected taps; the ring walk
        # up to the K-th selection; staging once per input pixel (least
        # work) or per halo-tile pixel (work done)
        px = attr9.shape[0] * attr9.shape[1]
        blocks = -(-attr9.shape[0] // 16) * -(-attr9.shape[1] // 16)
        tile_px = (16 + 2 * cfg.predict_window_multiplier) ** 2
        n_sel = st.n_sel.double()
        common = (float(n_sel.sum()) * (OPS["ray_support"] + OPS["ray_grad"] + OPS["ray_select"])
                  + float(st.n_visit.sum()) * OPS["ray_visit"])
        n_bytes = attr9.numel() * 4 + px * (12 + 12 + 4 + 1)
        bound_ms, bound_by = _bound(n_bytes, common + px * OPS["ray_stage"] + float(
            (n_sel * st.n_eval).sum()) * OPS["ray_field"])
        done_ms, done_by = _bound(n_bytes, common + blocks * tile_px * OPS["ray_stage"] + float(
            (n_sel * kernels.raycast_kernel_evals(st, cfg)).sum()) * OPS["ray_field"])
        print(f"raycast_core vs plain [{variant}]: found agree {agree:.5f} "
              f"(both {both.float().mean().item():.4f}), p_surf max abs err {max_err:.3e} m, "
              f"normal dot>0.9999 {dots:.5f}, nearest equal {near:.5f}; "
              f"kernel {ms:.3f} ms (one call with its host work {call_ms:.3f} ms), "
              f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}) on the least work, {done_ms * 1e3:.2f} us ({done_by}) on the "
              f"work done; evaluations of f per pixel with taps: "
              f"{float(st.n_eval[st.n_sel > 0].double().mean()):.3f} least, "
              f"{float(kernels.raycast_kernel_evals(st, cfg)[st.n_sel > 0].double().mean()):.3f} "
              f"done")
        if not (agree > 0.995 and both.float().mean().item() > 0.5 and max_err < 1e-4
                and dots > 0.99 and near >= 0.99):
            raise RuntimeError(f"raycast kernel disagrees with its plain version ({variant})")
        results[variant] = dict(max_abs_err=max_err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                bound_done_ms=done_ms, bound_done_by=done_by)
    return results


def _pca_rule(name, out, ref):
    """Valid agreement >= 0.999 and dot > 0.9999 on >= 99 % of the pixels
    valid in both; returns the max abs error there."""
    vo, vr = out.norm(dim=-1) > 0.5, ref.norm(dim=-1) > 0.5
    agree = (vo == vr).float().mean().item()
    both = vo & vr
    dots = ((out[both] * ref[both]).sum(-1) > 0.9999).float().mean().item()
    err = (out[both] - ref[both]).abs().max().item()
    print(f"{name}: valid agree {agree:.5f} (both {both.float().mean().item():.4f}), "
          f"dot>0.9999 {dots:.5f}, max abs err {err:.3e}")
    if not (agree >= 0.999 and dots >= 0.99 and both.float().mean().item() > 0.5):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def _curv_rule(name, pre, cfg):
    """The window sums within CURV_SUMS_RTOL of their terms' magnitude (the
    count exact); then, of the fused kernel's fields: valid agreement
    > 0.999; k1/k2 within atol 5e-2 rtol 1e-3 and dir1/dir2 |dot| > 0.9999
    on >= 99 % where well conditioned (CURV_COND_FLOOR: both divide by
    g_z); normal_opt dot > 0.9999 on >= 99 % of the pixels valid in both;
    gradient_mag within rtol 1e-4 + atol 1e-6 there (|<g, n>| of sums held
    to 1e-5 of their terms, which may partly cancel); radius_opt within
    1e-6 m there (z / |n_z| at |n_z| >= 0.5: twice normal_opt's error on a
    radius of a few cm); k = 1000 exactly where not valid, in both.
    Returns the max abs error of normal_opt there."""
    args = (pre.vertex_filtered, pre.normal, pre.radius, cfg)
    sums, scale, _ = preprocess.curvature_sums_ref(*args, stats=True)
    diff = (preprocess.curvature_sums(*args) - sums).abs()
    sums_ok = bool((diff <= CURV_SUMS_RTOL * scale).all())
    rel = (diff[..., :9] / scale[..., :9].clamp(min=1e-30)).max().item()
    f64 = preprocess.curvature_sums_ref(*(x.double() for x in args[:3]), cfg)
    rel64 = ((sums.double() - f64).abs()[..., :9] / scale[..., :9].double().clamp(min=1e-30)
             ).max().item()
    out = preprocess.curvature_gradient(pre, TUM1, cfg)
    ref = preprocess.curvature_gradient_ref(pre, TUM1, cfg)
    agree = (out.valid == ref.valid).float().mean().item()
    both = out.valid & ref.valid
    g = sums[..., 0:3]
    held = both & (g[..., 2].abs() >= CURV_COND_FLOOR * g.norm(dim=-1))
    left_out = 1.0 - held.sum().item() / max(both.sum().item(), 1)
    k_bad = sum(int(((getattr(out, k)[held] - getattr(ref, k)[held]).abs()
                     > 5e-2 + 1e-3 * getattr(ref, k)[held].abs()).sum()) for k in ("k1", "k2"))
    k_err = max((getattr(out, k)[held] - getattr(ref, k)[held]).abs().max().item()
                for k in ("k1", "k2"))
    dots = ((out.normal_opt[both] * ref.normal_opt[both]).sum(-1) > 0.9999).float().mean().item()
    err = (out.normal_opt[both] - ref.normal_opt[both]).abs().max().item()
    dir_dots = min(((getattr(out, f)[held] * getattr(ref, f)[held]).sum(-1).abs() > 0.9999)
                   .float().mean().item() for f in ("dir1", "dir2"))
    gm_o, gm_r = out.gradient_mag[both], ref.gradient_mag[both]
    gm_bad = int(((gm_o - gm_r).abs() > 1e-6 + 1e-4 * gm_r.abs()).sum())
    gm_err = ((gm_o - gm_r).abs() / gm_r.abs().clamp(min=1e-30)).max().item()
    rad_err = (out.radius_opt[both] - ref.radius_opt[both]).abs().max().item()
    sentinel = all(bool((r.k1[~r.valid] == 1000.0).all() and (r.k2[~r.valid] == 1000.0).all())
                   for r in (out, ref))
    print(f"{name}: sums max err {rel:.3e} of their terms' magnitude (plain float32 vs "
          f"float64: {rel64:.3e}), count equal "
          f"{bool((diff[..., 9] == 0).all())}; valid agree {agree:.5f} "
          f"(both {both.float().mean().item():.4f}), k1/k2 held on {1 - left_out:.5f} of "
          f"those (|g_z| >= {CURV_COND_FLOOR} |g|), outside tolerance on {k_bad} values "
          f"(max abs err {k_err:.3e}); dir1/dir2 |dot|>0.9999 {dir_dots:.5f}; normal_opt "
          f"dot>0.9999 {dots:.5f}, max abs err {err:.3e}; gradient_mag out of tolerance on "
          f"{gm_bad} (max rel err {gm_err:.3e}); radius_opt max abs err {rad_err:.3e} m; "
          f"k = 1000 where invalid {sentinel}")
    if not (sums_ok and agree > 0.999 and k_bad == 0 and left_out <= 0.01 and dots >= 0.99
            and dir_dots >= 0.99 and gm_bad == 0 and rad_err <= 1e-6 and sentinel
            and both.float().mean().item() > 0.5):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


def border_case(depth: torch.Tensor, seed: int) -> torch.Tensor:
    """``depth`` with 10 % of its pixels zeroed (seeded), its 3 leftmost
    columns stepped 0.25 m back, its last 2 rows zeroed and a 4x5 hole in
    its top-right corner: depth edges and holes at the image border, so a
    tiled kernel's border blocks meet them.  The CPU tests build the same
    case in numpy (``_border_case`` of tests/test_torch_kernels_preprocess.py):
    a change here goes there too."""
    gen = torch.Generator(device=depth.device).manual_seed(seed)
    holes = torch.rand(depth.shape, generator=gen, device=depth.device) < 0.1
    d = torch.where(holes, 0.0, depth)
    d[:, :3] += 0.25
    d[-2:, :] = 0.0
    d[:4, -5:] = 0.0
    return d.contiguous()


def _bilateral_rule(label, depth, cfg):
    """Both denominators within 1e-5 m of their plain versions; returns the
    larger error."""
    err = 0.0
    for pallas_form in (False, True):
        out = preprocess.bilateral_filter(depth, cfg, pallas_form=pallas_form)
        ref = preprocess.bilateral_filter_ref(depth, cfg, pallas_form=pallas_form)
        e = (out - ref).abs().max().item()
        form = "pallas" if pallas_form else "shader"
        print(f"bilateral_filter [{form} form, {label}]: max abs err {e:.3e} m")
        if not e <= 1e-5:
            raise RuntimeError(f"bilateral_filter ({form} form, {label}) disagrees: {e}")
        err = max(err, e)
    return err


def phase_preprocess_vs_plain(frames):
    """Each preprocessing kernel against its plain version, with the inputs
    the main path gives it: on frame 0 at 640x480 and on a copy with 10 %
    of its pixels zeroed (seeded); the bilateral and PCA kernels also on
    ``border_case`` of frame 0 and of a 61x47 crop of it (no multiple of
    their tiles).  Both bilateral denominators throughout."""
    cfg = BENCH_CFG
    depth0 = frames[0].depth.contiguous()
    gen = torch.Generator(device=depth0.device).manual_seed(0)
    holes = torch.rand(depth0.shape, generator=gen, device=depth0.device) < 0.1
    inputs = {"frame 0": depth0, "frame 0 with holes": torch.where(holes, 0.0, depth0)}
    px = depth0.numel()
    errs = defaultdict(float)
    for label, depth in inputs.items():
        errs["bilateral_filter"] = max(errs["bilateral_filter"],
                                       _bilateral_rule(label, depth, cfg))
        gap = (preprocess.bilateral_filter_ref(depth, cfg)
               - preprocess.bilateral_filter_ref(depth, cfg, pallas_form=True)).abs().max().item()
        print(f"bilateral_filter [{label}]: shader vs pallas form max gap {gap:.3e} m")
        depth_f = preprocess.bilateral_filter(depth, cfg)
        v_f = camera.unproject(depth_f, TUM1)
        errs["normal_pca"] = max(errs["normal_pca"], _pca_rule(
            f"normal_pca [{label}]", preprocess.normal_pca(v_f, cfg),
            preprocess.normal_pca_ref(v_f, cfg)))
        pre = preprocess.vertex_normal_radius(depth, depth_f, TUM1, cfg)
        errs["curvature_gradient"] = max(errs["curvature_gradient"], _curv_rule(
            f"curvature_gradient [{label}]", pre, cfg))
    h, w = depth0.shape
    edges = {"frame 0, border case": border_case(depth0, 1),
             "61x47 crop, border case": border_case(
                 depth0[h // 2 - 23:h // 2 + 24, w // 2 - 30:w // 2 + 31], 2)}
    for label, depth in edges.items():
        errs["bilateral_filter"] = max(errs["bilateral_filter"],
                                       _bilateral_rule(label, depth, cfg))
        v_f = camera.unproject(preprocess.bilateral_filter(depth, cfg), TUM1).contiguous()
        errs["normal_pca"] = max(errs["normal_pca"], _pca_rule(
            f"normal_pca [{label}]", preprocess.normal_pca(v_f, cfg),
            preprocess.normal_pca_ref(v_f, cfg)))

    # the denominators differ where an invalid neighbour's weight counts:
    # at near range (2 % of the depths, depth_min 0)
    near_cfg = dataclasses.replace(cfg, depth_min=0.0)
    near = 0.02 * inputs["frame 0 with holes"]
    gap = (preprocess.bilateral_filter(near, near_cfg)
           - preprocess.bilateral_filter(near, near_cfg, pallas_form=True)).abs().max().item()
    print(f"bilateral_filter [near range, holes]: shader vs pallas form kernels max gap "
          f"{gap:.3e} m")
    if not gap > 1e-3:
        raise RuntimeError("the bilateral forms do not differ at near range")
    for label, depth in edges.items():
        errs["bilateral_filter"] = max(errs["bilateral_filter"], _bilateral_rule(
            f"near range, {label}", 0.02 * depth, near_cfg))

    # times on frame 0 (main-path inputs) and the bounds of each
    depth = depth0
    depth_f = preprocess.bilateral_filter(depth, cfg)
    v_f = camera.unproject(depth_f, TUM1)
    pre = preprocess.vertex_normal_radius(depth, depth_f, TUM1, cfg)
    res = {}
    # the work each needs on these inputs, from its plain version's counts
    taps = float(preprocess.bilateral_filter_ref(depth, cfg, stats=True)[1].sum())
    res["bilateral_filter"] = dict(
        ms=_median_ms(lambda: preprocess.bilateral_filter(depth, cfg), primed=True),
        call_ms=_median_ms(lambda: preprocess.bilateral_filter(depth, cfg)),
        plain_ms=_median_ms(lambda: preprocess.bilateral_filter_ref(depth, cfg)),
        pallas_form_ms=_median_ms(lambda: preprocess.bilateral_filter(depth, cfg, True),
                                  primed=True),
        pallas_form_plain_ms=_median_ms(
            lambda: preprocess.bilateral_filter_ref(depth, cfg, True)),
        bound=_bound(2 * px * 4, _balanced(taps * OPS["bilateral_tap_least"], taps)),
        bound_first=_bound(2 * px * 4, taps * OPS["bilateral_tap"]))
    normals, accepted = preprocess.normal_pca_ref(v_f, cfg, stats=True)
    centre = v_f[..., 2] > cfg.depth_min
    tested, accepted = float(centre.sum()) * 49, float(accepted[centre].sum())
    valid = float((normals != 0).any(-1).sum())
    res["normal_pca"] = dict(
        ms=_median_ms(lambda: preprocess.normal_pca(v_f, cfg), primed=True),
        call_ms=_median_ms(lambda: preprocess.normal_pca(v_f, cfg)),
        plain_ms=_median_ms(lambda: preprocess.normal_pca_ref(v_f, cfg)),
        bound=_bound(2 * px * 12, px * OPS["pca_stage_least"] + tested * OPS["pca_test_least"]
                     + accepted * OPS["pca_accept_least"] + valid * OPS["pca_pixel_least"]),
        bound_first=_bound(2 * px * 12, tested * OPS["pca_test"] + accepted * OPS["pca_accept"]
                         + valid * OPS["pca_pixel"]))
    sums_in = (pre.vertex_filtered, pre.normal, pre.radius, cfg)
    sums, _, inside = preprocess.curvature_sums_ref(*sums_in, stats=True)
    n_ops = (px * (OPS["curv_stage"] + (2 * cfg.curv_window + 1) ** 2 * OPS["curv_test"]
                   + OPS["curv_pixel"])
             + float(sums[..., 9].sum()) * OPS["curv_masked"]
             + float(inside.sum()) * OPS["curv_inside"])
    # reads vertex, normal, radius (28 B), writes 13 floats and valid (53 B)
    res["curvature_gradient"] = dict(
        ms=_median_ms(lambda: preprocess.curvature_gradient(pre, TUM1, cfg), primed=True),
        call_ms=_median_ms(lambda: preprocess.curvature_gradient(pre, TUM1, cfg)),
        plain_ms=_median_ms(lambda: preprocess.curvature_gradient_ref(pre, TUM1, cfg)),
        with_sums_ms=_median_ms(lambda: preprocess.curvature_sums(*sums_in), primed=True),
        bound=_bound(px * (28 + 53), n_ops))
    for name, r in res.items():
        r["max_abs_err"] = errs[name]
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        if "bound_first" in r:
            r["bound_first_ms"], r["bound_first_by"] = r.pop("bound_first")
        extra = ", ".join(f"{k} {v:.3f}" for k, v in r.items() if k.endswith("ms")
                          and k not in ("ms", "plain_ms", "bound_ms", "bound_first_ms"))
        first = (f", {r['bound_first_ms'] * 1e3:.2f} us ({r['bound_first_by']}) on the "
                 "first design's counts" if "bound_first_ms" in r else "")
        print(f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms"
              f"{', ' + extra if extra else ''}, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}){' on the least work' if first else ''}{first} "
              f"(median of 20, CUDA events)")
    return res


def phase_use_pallas(poses, frames):
    """bootstrap + 5 steps with use_pallas=True: the bilateral kernel's
    Pallas denominator on the main path, held to the same bounds."""
    cfg = dataclasses.replace(BENCH_CFG, use_pallas=True)
    before = kernels.LAUNCHES["bilateral_filter"]
    state = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
    est = [lie.rt_to_mat(state.R, state.t)]
    for f in frames[1:N_PALLAS_FRAMES]:
        state = slam.step(state, f, TUM1, cfg)
        est.append(lie.rt_to_mat(state.R, state.t))
    ate, dense, icp_count = _check_run("use_pallas run", state, est, poses)
    launched = kernels.LAUNCHES["bilateral_filter"] - before
    print(f"use_pallas run: bootstrap + {N_PALLAS_FRAMES - 1} steps, ATE {ate * 1000:.3f} mm, "
          f"dense_frac {dense:.4f}, last_icp_count {icp_count:.0f}, "
          f"bilateral launches {launched}")
    if launched != N_PALLAS_FRAMES:
        raise RuntimeError(f"bilateral kernel launched {launched} times in the use_pallas run")


# (module, attribute, phase name) of the step's phases, outermost first
_PHASES = [
    (slam, "_preprocess", "preprocess"),
    (preprocess, "bilateral_filter", "  bilateral_filter (kernel)"),
    (preprocess, "normal_pca", "  normal_pca (kernel)"),
    (preprocess, "curvature_gradient", "  curvature_gradient (fused kernel)"),
    (odometry, "build_inputs", "track: build_inputs (pyramids)"),
    (odometry, "track", "track: odometry.track"),
    (sm, "render_index", "render_index"),
    (sm, "fuse", "fuse"),
    (sm, "render_attr_image", "render_attr_image"),
    (sm, "clean_with_remap", "clean_with_remap"),
    (raycast, "predict_hrbf", "predict_hrbf"),
    (kernels, "raycast_core", "  raycast_core (kernel)"),
    (raycast, "fill_in", "fill_in"),
    (preprocess, "confidence_map", "confidence_map"),
]


@contextlib.contextmanager
def _phase_timers(totals):
    """Wrap each phase's function so that it is synchronised before and
    after and its wall time adds to ``totals[name]``."""
    saved = []

    def timed(fn, name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    try:
        for mod, attr, name in _PHASES:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, timed(getattr(mod, attr), name))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _dev_time(e) -> float:
    """A profiler event's own device time, µs."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def phase_breakdown(poses, frames, n_steps=6):
    """Per-phase ms of a step (median over steps 2-6 after a bootstrap),
    each phase synchronised; then a profiler's device time and kernel
    count over 2 more steps.  Returns each kernel's device ms per launch
    there."""
    cfg = BENCH_CFG
    state = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
    per_step, step_ms = [], []
    for f in frames[1:n_steps + 1]:
        totals = defaultdict(float)
        with _phase_timers(totals):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = slam.step(state, f, TUM1, cfg)
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append(totals)
    rows = {name: float(np.median([s[name] for s in per_step[1:]])) for _, _, name in _PHASES}
    print(f"breakdown: step (phases synchronised) median {np.median(step_ms[1:]):.2f} ms "
          f"over steps 2-{n_steps}; phase medians ms: " + "; ".join(
              f"{name.strip()} {ms:.2f}" for name, ms in rows.items()))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[n_steps + 1:n_steps + 3]:
            state = slam.step(state, f, TUM1, cfg)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(_dev_time(e) for e in events)
    n_ops = sum(e.count for e in events)
    print(f"breakdown: profiler over 2 steps: {n_ops / 2:.0f} device ops per step, "
          f"device busy {dev_us / 2e3:.2f} ms per step")
    per_launch = {}
    for kname, symbol in KERNEL_SYMBOLS.items():
        hits = [e for e in events if symbol in e.key]
        count = sum(e.count for e in hits)
        per_launch[kname] = sum(_dev_time(e) for e in hits) / max(count, 1) / 1e3
        print(f"breakdown: profiler {kname}: {count} launches in 2 steps, "
              f"{per_launch[kname] * 1e3:.2f} us of device time per launch")
    return per_launch


def _to(prob, device):
    return type(prob)(*(x.to(device) for x in prob))


def _pose_gaps(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Norm of se3_log(a_i^-1 b_i) for each pose of a batch (float64)."""
    a, b = a.cpu().double(), b.cpu().double()
    return torch.linalg.norm(lie.se3_log(torch.linalg.inv(a) @ b), dim=-1).numpy()


def _pose_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest norm of se3_log(a_i^-1 b_i) over a batch of poses."""
    return float(_pose_gaps(a, b).max())


def _ba_sizes(prob) -> dict:
    """Real and padded sizes of a padded BA problem (padding edges are the
    ones with zero weight on entry)."""
    real = prob.edge_valid.cpu().numpy() > 0
    return dict(edges=int(real.sum()), lms=len(np.unique(prob.lm_idx.cpu().numpy()[real])),
                cams=len(np.unique(prob.cam_idx.cpu().numpy()[real])),
                padded=[prob.obs.shape[0], prob.points.shape[0], prob.cams.shape[0]])


def _card_vs_cpu(label, solve, inputs_cpu, dev, poses_of):
    """``solve`` on the CPU and three times on the card, the third with the
    global TF32 flag off (the solvers take one path whatever it says); the
    card's results must be bit-identical and its poses within POSE_TOL of
    the CPU's.  Returns (CPU result, card result, pose gap)."""
    ref = solve(inputs_cpu)
    inputs = _to(inputs_cpu, dev)
    first, second = solve(inputs), solve(inputs)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        third = solve(inputs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    # (problem or graph, chi2): every tensor of each
    if not all(torch.equal(u, v) for other in (second, third)
               for u, v in zip([*first[0], first[1]], [*other[0], other[1]])):
        raise RuntimeError(f"{label}: runs on the card differ (the third with TF32 off)")
    gap = _pose_gap(poses_of(first), poses_of(ref))
    if not gap < POSE_TOL:
        raise RuntimeError(f"{label}: card poses {gap:.3g} from the CPU's (limit {POSE_TOL})")
    return ref, first, gap


def _synthetic_ba(n_cams=128, n_lms=60, noise=0.002, perturb=0.05, seed=0):
    """tests/test_ba.py::_make_problem at 128 cameras, on the CPU: every
    camera sees every landmark, the first two fixed; the arc's step is
    5/127 of the 6-camera problem's so that it spans the same poses."""
    rng = np.random.default_rng(seed)
    step = torch.tensor([0.1, 0.02, 0.0, 0.0, 0.05, 0.0]) * 5.0 / (n_cams - 1)
    gt_cams = lie.se3_exp(torch.arange(n_cams, dtype=torch.float32)[:, None] * step)
    pts = torch.from_numpy(rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 3.5],
                                       (n_lms, 3)).astype(np.float32))
    cam_idx = torch.arange(n_cams).repeat_interleave(n_lms)
    lm_idx = torch.arange(n_lms).repeat(n_cams)
    T = gt_cams[cam_idx]
    obs = torch.einsum("eij,ej->ei", T[:, :3, :3], pts[lm_idx]) + T[:, :3, 3]
    obs = obs + torch.from_numpy((noise * rng.standard_normal(obs.shape)).astype(np.float32))
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[:2] = True
    dx = torch.from_numpy((perturb * rng.standard_normal((n_cams, 6))).astype(np.float32))
    dx[fixed] = 0.0
    return ba.BAProblem(
        cams=lie.se3_exp(dx) @ gt_cams,
        points=pts + torch.from_numpy((perturb * rng.standard_normal((n_lms, 3))
                                       ).astype(np.float32)),
        obs=obs, cam_idx=cam_idx, lm_idx=lm_idx, info=ba.depth_information(obs, 500.0, 500.0),
        edge_valid=torch.ones(obs.shape[0]), fixed=fixed)


def _keypoint_agreement(kp_card, kp_cpu) -> tuple[float, float]:
    """Shares of the CPU's valid keypoints at the same pixel of their level
    on the card, and of descriptor bits equal on those keypoints."""
    v = kp_cpu.valid.numpy()
    scale = 1.5 ** kp_cpu.level.numpy()[:, None]
    same_px = (np.round(kp_card.xy.cpu().numpy() / scale)
               == np.round(kp_cpu.xy.numpy() / scale)).all(-1)
    bits = (np.unpackbits(features.desc_to_numpy(kp_card.desc).view(np.uint8), axis=-1)
            == np.unpackbits(features.desc_to_numpy(kp_cpu.desc).view(np.uint8), axis=-1))
    return float(same_px[v].mean()), float(bits[v].mean())


def _profile_call(label: str, fn, phase: str = "backend") -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, device ops,
    device busy ms and the three device ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(_dev_time(e) for e in events) / 1e3
    top = sorted(events, key=_dev_time, reverse=True)[:3]
    out = dict(wall_ms=wall, device_ops=sum(e.count for e in events), device_busy_ms=busy,
               top=[[e.key[:60], e.count, _dev_time(e) / 1e3] for e in top])
    print(f"{phase}: profiler {label}: {out['device_ops']} device ops, device busy "
          f"{busy:.2f} ms of {wall:.1f} ms (profiled); most device time: "
          + "; ".join(f"{k} x{c} {ms:.2f} ms" for k, c, ms in out["top"]))
    return out


def phase_backend(dev) -> dict:
    """The sparse backend at FullSLAM's production settings: six keyframes
    of 640x480 frames inserted into a ``SparseBackend`` on the card, local
    BA after each (the last keyframe's pose drifted), each call timed with
    the card synchronised around it and its host syncs counted.  Then held
    to the port on the CPU: detection, the last local BA's padded problem,
    a 128-camera PCG BA, the pose graph of the six keyframes with a loop
    edge and the vocabulary tree's quantisation; the solvers also twice on
    the card, bit for bit, and once more there with TF32 off.  The
    caller's TF32 is on for the rest of the phase: the solvers pin full
    float32 themselves.  No hand-written kernel runs
    on this path.  The last keyframe's insert and local BA run once more,
    on a copy of the backend, under the profiler."""
    t_phase = time.perf_counter()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        scene = synth.default_room(dev)
        gt = synth.orbit_trajectory(BACKEND_N_FRAMES)
        drift = lie.se3_exp(torch.from_numpy(BACKEND_DRIFT)).numpy()
        be = keyframes.SparseBackend(TUM1, BENCH_CFG, device=dev, **BACKEND_ARGS)
        captured = {}
        optimize = ba.optimize

        def capture(prob, **kw):
            captured["prob"], captured["solver"] = prob, kw["solver"]
            return optimize(prob, **kw)

        rows, before, frame = [], None, None
        ba.optimize = capture
        try:
            for k, t in enumerate(BACKEND_KF_FRAMES):
                last = k == len(BACKEND_KF_FRAMES) - 1
                depth, rgb = synth.render_frame(scene, gt[t - 1], TUM1)
                frame = (pyramid.rgb_to_intensity(rgb), depth)
                est = (drift @ gt[t - 1]).astype(np.float32) if last else gt[t - 1]
                if last:
                    replay = copy.deepcopy(be)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, ins_syncs = _count_syncs(lambda: be.insert_keyframe(*frame, est, time=t))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if last:
                    before = float(np.linalg.norm(be.keyframes[-1].pose[:3, 3] - gt[t - 1][:3, 3]))
                captured.clear()
                deltas, ba_syncs = _count_syncs(be.local_ba)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                kf = be.keyframes[-1]
                row = dict(kf=k, frame=t, valid_keypoints=int(kf.kp_valid.sum()),
                           landmarks=len(be.landmarks),
                           shared=sum(len(o) >= 2 for o in be.lm_obs.values()),
                           insert_ms=1e3 * (t1 - t0), insert_syncs=ins_syncs,
                           local_ba_ms=1e3 * (t2 - t1), local_ba_syncs=ba_syncs,
                           ba=_ba_sizes(captured["prob"]) if deltas is not None else None)
                rows.append(row)
                b = row["ba"]
                print(f"backend kf {k} (frame {t}): {row['valid_keypoints']} valid keypoints, "
                      f"{row['landmarks']} landmarks ({row['shared']} shared), BA "
                      + (f"{b['edges']} edges / {b['lms']} landmarks / {b['cams']} cameras "
                         f"(padded {' / '.join(map(str, b['padded']))})" if b else "none")
                      + f"; insert_keyframe {row['insert_ms']:.1f} ms ({ins_syncs} host syncs), "
                        f"local_ba {row['local_ba_ms']:.1f} ms ({ba_syncs} host syncs)")
        finally:
            ba.optimize = optimize
        t = BACKEND_KF_FRAMES[-1]
        profiled = {"insert_keyframe": _profile_call(
                        f"insert_keyframe (frame {t})",
                        lambda: replay.insert_keyframe(*frame, est, time=t)),
                    "local_ba": _profile_call(f"local_ba (frame {t})", replay.local_ba)}
        after = float(np.linalg.norm(be.keyframes[-1].pose[:3, 3] - gt[t - 1][:3, 3]))
        print(f"backend: drifted keyframe position error {before * 1e3:.2f} mm before local BA, "
              f"{after * 1e3:.2f} mm after")
        if not (before > DRIFT_MIN and after < DRIFT_KEEP * before):
            raise RuntimeError(f"local BA did not correct the drift: {before} -> {after} "
                               f"(needs > {DRIFT_MIN} before and < {DRIFT_KEEP} of it after)")

        # detection: the last keyframe's frame on the card and on the CPU
        n_per_level = BACKEND_ARGS["n_features"] // 4
        thr = BACKEND_ARGS["fast_threshold"]
        kp_card = features.detect_and_describe(frame[0], n_per_level=n_per_level, threshold=thr)
        kp_cpu = features.detect_and_describe(frame[0].cpu(), n_per_level=n_per_level,
                                              threshold=thr)
        kp_agree, bit_agree = _keypoint_agreement(kp_card, kp_cpu)
        print(f"backend: detection card vs CPU: {kp_agree:.5f} of {int(kp_cpu.valid.sum())} valid "
              f"keypoints at the same pixel (>= {KP_AGREE}), {bit_agree:.6f} of their "
              f"descriptor bits equal (>= {BITS_AGREE})")
        if not (kp_agree >= KP_AGREE and bit_agree >= BITS_AGREE):
            raise RuntimeError("detection on the card disagrees with the CPU")

        # the last local BA's padded problem
        prob, solver = captured["prob"], captured["solver"]
        n_real = int((prob.edge_valid > 0).sum())

        def local(p):
            return ba.optimize(p, solver=solver,
                               plans=ba.build_plans(_to(p, "cpu"), solver, n_real=n_real,
                                                    device=p.cams.device))
        (ref, chi_ref), (out, chi), gap = _card_vs_cpu(
            "local BA", local, _to(prob, "cpu"), dev, lambda r: r[0].cams)
        chi_rel = abs(float(chi) - float(chi_ref)) / abs(float(chi_ref))
        print(f"backend: last local BA ({solver}, padded {list(prob.obs.shape[:1])} edges) card "
              f"vs CPU: poses within {gap:.3g}, chi2 {float(chi):.6g} vs {float(chi_ref):.6g} "
              f"(relative {chi_rel:.3g}); three card runs bit-identical, one with TF32 off")
        if not chi_rel < CHI2_RTOL:
            raise RuntimeError(f"local BA chi2 on the card {chi_rel} from the CPU's")

        # a 128-camera PCG BA
        syn = _synthetic_ba()
        t0 = time.perf_counter()
        (ref, chi_ref), (out, chi), gap = _card_vs_cpu(
            "128-camera cg BA", lambda p: ba.optimize(p, solver="cg"), syn, dev,
            lambda r: r[0].cams)
        chi_rel = abs(float(chi) - float(chi_ref)) / abs(float(chi_ref))
        print(f"backend: 128-camera cg BA ({syn.obs.shape[0]} edges) card vs CPU: poses within "
              f"{gap:.3g}, chi2 relative {chi_rel:.3g}; three card runs bit-identical, one with TF32 "
              f"off ({time.perf_counter() - t0:.1f} s for the four solves)")
        if not chi_rel < CHI2_RTOL:
            raise RuntimeError(f"128-camera BA chi2 on the card {chi_rel} from the CPU's")

        # the pose graph of the six keyframes: odometry edges from the
        # current poses, one loop edge 5 -> 0 measured from the ground truth
        K = len(be.keyframes)
        P = np.stack([kf.pose for kf in be.keyframes]).astype(np.float32)
        G = np.stack([gt[t - 1] for t in BACKEND_KF_FRAMES]).astype(np.float32)
        ei, ej = list(range(K - 1)) + [K - 1], list(range(1, K)) + [0]
        meas = np.stack([np.linalg.inv(P[i]) @ P[j] for i, j in zip(ei[:-1], ej[:-1])]
                        + [np.linalg.inv(G[K - 1]) @ G[0]]).astype(np.float32)
        fixed = torch.zeros(K, dtype=torch.bool)
        fixed[0] = True
        graph = posegraph.PoseGraph(
            poses=torch.from_numpy(P), edge_i=torch.tensor(ei), edge_j=torch.tensor(ej),
            meas=torch.from_numpy(meas), info=torch.eye(6).expand(len(ei), 6, 6).contiguous(),
            edge_valid=torch.ones(len(ei)), fixed=fixed)
        _, (g_out, _), gap = _card_vs_cpu("pose graph", lambda g: posegraph.optimize(g), graph,
                                          dev, lambda r: r[0].poses)
        print(f"backend: pose graph of {K} keyframes + 1 loop edge card vs CPU: poses within "
              f"{gap:.3g}; three card runs bit-identical, one with TF32 off")

        # the vocabulary tree over the keyframes' descriptors
        train = np.concatenate([kf.desc[kf.kp_valid] for kf in be.keyframes])
        tree = vocab.VocabularyTree.train(train, device=dev)
        tree_cpu = vocab.VocabularyTree([c.cpu().numpy() for c in tree.centroids],
                                        tree.idf.cpu().numpy(), tree.k, tree.depth, device="cpu")
        for kf in be.keyframes:
            w_card = tree.quantize(features.desc_from_numpy(kf.desc, dev)).cpu()
            w_cpu = tree_cpu.quantize(features.desc_from_numpy(kf.desc, "cpu"))
            if not torch.equal(w_card, w_cpu):
                raise RuntimeError(f"vocabulary quantisation of keyframe {kf.kf_id} differs")
        print(f"backend: vocabulary tree ({tree.n_words} words, trained on {train.shape[0]} "
              f"descriptors) quantises all {K} keyframes equally on card and CPU")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    secs = time.perf_counter() - t_phase
    print(f"backend: phase {secs:.1f} s")
    return dict(keyframes=rows, profiled=profiled, drift_mm=[before * 1e3, after * 1e3],
                seconds=secs)

@contextlib.contextmanager
def _recorded(mod, attr, sink, label=None):
    """Wrap ``mod.attr`` so that each call's wall ms (card synchronised
    around it) and result are appended to ``sink``."""
    fn = getattr(mod, attr)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(dict(ms=1e3 * (time.perf_counter() - t0), out=out, label=label))
        return out

    setattr(mod, attr, run)
    try:
        yield
    finally:
        setattr(mod, attr, fn)


@contextlib.contextmanager
def _keyframe_bilateral_launches(counter):
    """Count the bilateral kernel's launches made by FullSLAM._kf_inputs
    (the keyframe call site) apart from the step's."""
    fn = full_slam.FullSLAM._kf_inputs

    def run(self, frame):
        before = kernels.LAUNCHES["bilateral_filter"]
        out = fn(self, frame)
        counter[0] += kernels.LAUNCHES["bilateral_filter"] - before
        return out

    full_slam.FullSLAM._kf_inputs = run
    try:
        yield
    finally:
        full_slam.FullSLAM._kf_inputs = fn


def _driven(label, launches):
    """Fail unless every kernel launched in the run whose counts these are."""
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise RuntimeError(f"{label}: kernels {idle} were not launched")


def _out_and_back(n_out=6, step=0.12) -> np.ndarray:
    """tests/test_full_slam_loop.py::_out_and_back."""
    poses = []
    for i in list(range(n_out)) + list(range(n_out - 2, -1, -1)):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [step * i, 0.0, 0.0]
        poses.append(T)
    return np.stack(poses)


def _closer_poses(lc) -> torch.Tensor:
    return torch.from_numpy(np.stack([kf.pose for kf in lc.backend.keyframes]).astype(np.float32))


def _replay_loop(dev, label: str, scale: float):
    """FullSLAM.process in replay mode at 640x480 on the out-and-back of
    tests/test_full_slam_loop.py, the return leg's drift steps scaled by
    ``scale``.  Returns (results, the system, its closer's state just before
    each correct(), each correct()'s result)."""
    gt = _out_and_back()
    step = lie.se3_exp(torch.from_numpy(STEP_XI * scale)).numpy()
    D = np.eye(4, dtype=np.float32)
    drifted = []
    for k in range(gt.shape[0]):
        if k >= gt.shape[0] - 4:
            D = step @ D
        drifted.append((D @ gt[k]).astype(np.float32))
    drifted = np.stack(drifted)
    scene = synth.default_room(dev)
    frames = [slam.FrameInput(*synth.render_frame(scene, p, TUM1)) for p in gt]
    sys_ = full_slam.FullSLAM(TUM1, LOOP_CFG, backend_kwargs=LOOP_BACKEND, loop_kwargs=LOOP_ARGS,
                              init_pose=gt[0], device=dev)
    lc = sys_.loop_closer
    adds, corrects, closings = [], [], []
    kf_launch = [0]
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    with _recorded(lc, "add_keyframe", adds), _recorded(lc, "correct", corrects), \
            _keyframe_bilateral_launches(kf_launch):
        timed_correct = lc.correct

        def correct(cand, run_global_ba=True):
            # the closer's state just before the correction, outside its timing
            closings.append(dict(cand=cand, before=copy.deepcopy(lc.__dict__)))
            return timed_correct(cand, run_global_ba)

        lc.correct = correct
        for i, f in enumerate(frames):
            sys_.process(f, timestamp=float(i), fixed_pose=drifted[i])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _driven(f"full system (a) {label}", launches)
    err_in = ate_rmse(drifted, gt, align=False)
    est = sys_.poses()
    err_out = ate_rmse(est, gt, align=False)
    kf_gt = gt[[kf.frame_time - 1 for kf in sys_.backend.keyframes]]
    kf_err = [float(np.linalg.norm(kf.pose[:3, 3] - g[:3, 3])) * 1e3
              for kf, g in zip(sys_.backend.keyframes, kf_gt)]
    out = dict(drift_scale=scale, frames=len(frames), size=[TUM1.width, TUM1.height],
               seconds=wall, keyframes=len(sys_.backend.keyframes), loops=sys_.loop_closures,
               ate_drifted_mm=err_in * 1e3, ate_corrected_mm=err_out * 1e3,
               ratio=err_out / err_in, keyframe_err_mm=kf_err,
               frame_err_mm=(np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1) * 1e3).tolist(),
               add_keyframe_ms=[a["ms"] for a in adds], correct_ms=[c["ms"] for c in corrects],
               launches=launches, keyframe_bilateral_launches=kf_launch[0])
    print(f"full system (a) {label}: {len(frames)} replayed 640x480 frames in {wall:.1f} s, "
          f"{out['keyframes']} keyframes, loops {sys_.loop_closures}; ATE drifted "
          f"{err_in * 1e3:.2f} mm -> {err_out * 1e3:.2f} mm ({err_out / err_in:.3f} of it); "
          f"keyframe errors mm {', '.join(f'{x:.1f}' for x in kf_err)}; add_keyframe ms "
          f"{', '.join(f'{x:.1f}' for x in out['add_keyframe_ms'])}; correct ms "
          f"{', '.join(f'{x:.1f}' for x in out['correct_ms'])}; launches {json.dumps(launches)} "
          f"(+{kf_launch[0]} bilateral at keyframes)")
    if not sys_.loop_closures:
        raise RuntimeError(f"full system (a) {label}: no loop closure fired at 640x480")
    return out, sys_, closings, corrects


def _global_ba_obs(lc) -> np.ndarray:
    """Each keyframe's observations in the closer's global BA: those of the
    landmarks seen twice or more (LoopCloser._global_ba's selection)."""
    counts = np.zeros(len(lc.backend.keyframes), np.int64)
    for obs in lc.backend.lm_obs.values():
        if len(obs) >= 2:
            for kf_id, _ in obs:
                counts[kf_id] += 1
    return counts


def _closing_again(dev, label, out, sys_, closings, corrects):
    """The run's last correct() again, from copies of the closer taken just
    before it: on the card (it must repeat the system's run bit for bit),
    on the CPU, and on the CPU with the keyframe poses nudged by NUDGE.  The
    card's keyframe poses must be within POSE_TOL of the CPU's on every
    keyframe with at least MIN_BA_OBS observations in the global BA, and
    its chi2 within CHI2_RTOL; the keyframes with fewer, and how far the
    nudge moves each keyframe, are printed."""
    last = closings[-1]
    chis = []

    def rerun(device, nudge=0.0):
        other = object.__new__(loop.LoopCloser)
        other.__dict__.update(copy.deepcopy(last["before"]))
        other.backend.device = torch.device(device)
        rng = np.random.default_rng(0)
        for kf in other.backend.keyframes:
            kf.pose = (kf.pose + nudge * rng.standard_normal((4, 4))
                       * np.array([1, 1, 1, 0])[:, None]).astype(np.float32)
        with _recorded(ba, "optimize", chis, label=str(device)):
            deltas = loop.LoopCloser.correct(other, last["cand"])
        return deltas, _closer_poses(other), _global_ba_obs(other)

    card_deltas, card_poses, obs = rerun(dev)
    _, cpu_poses, cpu_obs = rerun("cpu")
    _, nudged_poses, _ = rerun("cpu", NUDGE)
    if not (np.array_equal(card_deltas, corrects[-1]["out"])
            and torch.equal(card_poses, _closer_poses(sys_.loop_closer))):
        raise RuntimeError(f"full system (a) {label}: two runs of the closing correct() on the "
                           f"card differ")
    if not np.array_equal(obs, cpu_obs):
        raise RuntimeError(f"full system (a) {label}: global BA observations differ: card {obs}, "
                           f"CPU {cpu_obs}")
    gaps = _pose_gaps(card_poses, cpu_poses)
    moved = _pose_gaps(nudged_poses, cpu_poses)
    held = obs >= MIN_BA_OBS
    gap = float(gaps[held].max())
    chi_card, chi_cpu = (float(c["out"][1]) for c in chis[:2])
    chi_rel = abs(chi_card - chi_cpu) / abs(chi_cpu)
    out.update(global_ba_obs=obs.tolist(), correct_card_vs_cpu_gaps=gaps.tolist(),
               correct_card_vs_cpu_pose_gap=gap, nudge=NUDGE, nudge_moves=moved.tolist(),
               global_ba_chi2=[chi_card, chi_cpu], global_ba_chi2_rel=chi_rel,
               global_ba_ms={c["label"]: c["ms"] for c in chis[:2]})
    print(f"full system (a) {label}: closing correct() card vs CPU: global BA observations per "
          f"keyframe {obs.tolist()}; keyframe poses within {gap:.3g} on the {int(held.sum())} "
          f"with >= {MIN_BA_OBS} (held), per keyframe {', '.join(f'{x:.3g}' for x in gaps)}; "
          f"a {NUDGE:g} nudge of the poses moves them on the CPU by "
          f"{', '.join(f'{x:.3g}' for x in moved)}; global BA chi2 {chi_card:.6g} vs "
          f"{chi_cpu:.6g} (relative {chi_rel:.3g}); two card runs bit-identical; global BA ms "
          f"card {chis[0]['ms']:.1f}, CPU {chis[1]['ms']:.1f}")
    if not (gap < POSE_TOL and chi_rel < CHI2_RTOL):
        raise RuntimeError(f"full system (a) {label}: correct() on the card {gap} / {chi_rel} "
                           f"from the CPU's (limits {POSE_TOL} / {CHI2_RTOL})")


def phase_full_system_loop(dev) -> dict:
    """(a) The replayed out-and-back at 640x480, with the test's drift
    (metres) and with it scaled by DRIFT_SCALE (the test's pixels): the
    loop must fire and cut the drifted trajectory's error below LOOP_KEEP
    of it (the test's margin; on the scaled drift over an error above the
    test's 0.10 m scaled alike); each closing correct() re-run from a copy
    on the card (bit-identical) and held to the CPU's (_closing_again).
    On the test's drift the pose graph leaves the drifted keyframe ~130 mm
    off, ~30 px at fx = 517 and outside SearchAndFuse's 4 px gate: few
    loop-side landmarks merge into it and global BA may not determine its
    pose, which then follows float rounding, in the JAX package as in the
    port; the held card-vs-CPU check leaves such a keyframe out and the
    print shows its observations and its nudge."""
    test, *run = _replay_loop(dev, "test drift", 1.0)
    _closing_again(dev, "test drift", test, *run)
    scaled, *run = _replay_loop(dev, "drift x 103 / fx", DRIFT_SCALE)
    _closing_again(dev, "drift x 103 / fx", scaled, *run)
    if not test["ratio"] < LOOP_KEEP:
        raise RuntimeError(f"full system (a): the loop cut the test drift's error from "
                           f"{test['ate_drifted_mm']} to {test['ate_corrected_mm']} mm, "
                           f"not below {LOOP_KEEP} of it")
    if not (scaled["ate_drifted_mm"] > 100.0 * DRIFT_SCALE and scaled["ratio"] < LOOP_KEEP):
        raise RuntimeError(f"full system (a): the loop cut the scaled drift's error from "
                           f"{scaled['ate_drifted_mm']} to {scaled['ate_corrected_mm']} mm, "
                           f"not below {LOOP_KEEP} of it")
    return dict(test_drift=test, pixel_drift=scaled)


def _kinect_frame(scene, pose, i, dev):
    d, c = synth.render_frame_kinect(scene, pose, TUM1,
                                     torch.Generator(dev).manual_seed(1000 + i), 1.0)
    return d, c


def phase_full_system_tracked(dev) -> dict:
    """(b) bench.py's full-system protocol, FULL_FRAMES frames: complex_room
    on panorama_trajectory at 1.8 deg/frame through the Kinect model (noise
    drawn from a generator seeded per frame), FullSLAM with async BA,
    frame 0 by process, then process_batch in chunks of keyframe_period;
    rendering is outside the timed calls.  Host syncs: the main thread's
    per chunk, the worker's over the whole run.  fps as bench.py:182-185
    computes it.  Then SYNC_FRAMES of the same frames through a synchronous
    FullSLAM.process, ms and host syncs per frame; the next
    keyframe_period frames as bare slam.step calls from its state and
    then through its process() (what FullSLAM adds to a step on the same
    frames and map); the keyframe_period after them under the profiler."""
    n, k = FULL_FRAMES, FULL_CFG.keyframe_period
    scene = synth.complex_room(dev)
    gt = synth.panorama_trajectory(n, n_turns=1.8 * (n - 1) / 360.0)
    sys_ = full_slam.FullSLAM(TUM1, FULL_CFG, init_pose=gt[0], async_ba=True, device=dev)
    kf_launch = [0]
    chunk_walls, chunk_syncs = [], []
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    with _keyframe_bilateral_launches(kf_launch), _sync_counts() as syncs:
        d0, c0 = _kinect_frame(scene, gt[0], 0, dev)
        t0 = time.perf_counter()
        sys_.process(slam.FrameInput(d0, c0), timestamp=0.0)
        first_ms = 1e3 * (time.perf_counter() - t0)
        i = 1
        while i < n:
            m = min(k, n - i)
            ds, cs = zip(*(_kinect_frame(scene, gt[i + j], i + j, dev) for j in range(m)))
            batch = slam.FrameInput(torch.stack(ds), torch.stack(cs))
            torch.cuda.synchronize()
            main_before = syncs[0]
            t0 = time.perf_counter()
            sys_.process_batch(batch, timestamps=[float(i + j) for j in range(m)])
            chunk_walls.append(time.perf_counter() - t0)
            chunk_syncs.append(syncs[0] - main_before)
            i += m
        t0 = time.perf_counter()
        sys_.join_backend()
        join_s = time.perf_counter() - t0
        # every keyframe the worker took, from the first frame's on
        worker_syncs = syncs[1]
    sys_.close()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    _driven("full system (b)", launches)
    chunk_times = [w / min(k, n - 1 - j * k) for j, w in enumerate(chunk_walls)]
    floor = min(chunk_times)
    steady = [t for t in chunk_times[1:] if t < 3 * floor] or chunk_times
    fps = 1.0 / float(np.median(steady))
    fps_allin = (n - 1) / sum(chunk_walls)
    est = sys_.poses()
    ate = ate_rmse(est, gt[:len(est)], align=False)
    out = dict(
        frames=n, size=[TUM1.width, TUM1.height], async_ba=True, fps=fps, fps_allin=fps_allin,
        max_chunk_s=max(chunk_walls), chunk_s=chunk_walls, first_frame_ms=first_ms,
        join_backend_s=join_s, ate_mm=ate * 1e3, loops=sys_.loop_closures,
        archive_dropped=sys_.archive_dropped, active_count=int(sys_.state.map.count),
        archive_count=sys_._archive_count, map_capacity=sys_.cfg.map_capacity,
        keyframes_inserted=len(sys_.backend.keyframes), keyframes_due=1 + (n - 1) // k,
        async_corrections=sys_.async_corrections, inflight=sys_._inflight,
        stage_s=sys_.stage_s, host_syncs_per_chunk=chunk_syncs,
        worker_host_syncs=worker_syncs, launches=launches,
        keyframe_bilateral_launches=kf_launch[0])
    print(f"full system (b): {n} Kinect-noisy 640x480 frames of bench.py's protocol, async: "
          f"{fps:.2f} fps steady, {fps_allin:.2f} fps all-in, worst chunk "
          f"{max(chunk_walls):.2f} s, join_backend {join_s:.2f} s; ATE {ate * 1e3:.2f} mm; "
          f"loops {sys_.loop_closures}; archive_dropped {sys_.archive_dropped}; active "
          f"{out['active_count']} / archive {out['archive_count']} surfels; keyframes "
          f"{out['keyframes_inserted']} of {out['keyframes_due']} due; host syncs per chunk "
          f"(main thread) {chunk_syncs}, worker {worker_syncs} over the run; stage_s "
          + json.dumps({key: round(v, 3) for key, v in sys_.stage_s.items()})
          + f"; launches {json.dumps(launches)} (+{kf_launch[0]} bilateral at keyframes)")
    if not (np.isfinite(est).all() and ate < FULL_ATE_MAX):
        raise RuntimeError(f"full system (b): ATE {ate} (limit {FULL_ATE_MAX})")
    if sys_._inflight != 0:
        raise RuntimeError(f"full system (b): join_backend left {sys_._inflight} in flight")

    # the same first SYNC_FRAMES frames, synchronous process()
    sync = full_slam.FullSLAM(TUM1, FULL_CFG, init_pose=gt[0], device=dev)
    ms, syncs = [], []
    for i in range(SYNC_FRAMES):
        frame = slam.FrameInput(*_kinect_frame(scene, gt[i], i, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, main_s, _ = _count_syncs_by_thread(lambda: sync.process(frame, timestamp=float(i)))
        ms.append(1e3 * (time.perf_counter() - t0))
        syncs.append(main_s)
    kf_frames = [kf.frame_time - 1 for kf in sync.backend.keyframes]
    plain = [x for j, x in enumerate(ms) if j not in kf_frames]
    out["sync"] = dict(frames=SYNC_FRAMES, ms_per_frame=float(np.mean(ms[1:])),
                       ms_per_plain_frame=float(np.median(plain)),
                       ms_keyframes=[ms[j] for j in kf_frames if j > 0],
                       host_syncs_per_frame=syncs,
                       ate_mm=ate_rmse(sync.poses(), gt[:SYNC_FRAMES], align=False) * 1e3)
    # the next keyframe_period frames (the last a keyframe): first as bare
    # slam.step calls from a snapshot of the synchronous system's state
    # (the same frames and map, no FullSLAM around them), then through its
    # process(); then the keyframe_period after them under the profiler
    nxt = [slam.FrameInput(*_kinect_frame(scene, gt[i], i, dev))
           for i in range(SYNC_FRAMES, SYNC_FRAMES + 2 * k)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, 1e3 * (time.perf_counter() - t0)

    state, bare = sync.state, []
    for f in nxt[:k - 1]:
        state, step_ms = timed(lambda: slam.step(state, f, TUM1, sync.cfg))
        bare.append(step_ms)
    del state
    again = [timed(lambda: sync.process(f, timestamp=float(SYNC_FRAMES + j)))[1]
             for j, f in enumerate(nxt[:k])]
    out["sync"].update(bare_step_ms=bare, process_same_frames_ms=again)

    def frames_after():
        for j, f in enumerate(nxt[k:]):
            sync.process(f, timestamp=float(SYNC_FRAMES + k + j))

    out["sync"]["profiled"] = _profile_call(
        f"sync process() of frames {SYNC_FRAMES + k}-{SYNC_FRAMES + 2 * k - 1}", frames_after,
        "full system (b)")
    print(f"full system (b): frames {SYNC_FRAMES}-{SYNC_FRAMES + k - 2}: bare slam.step median "
          f"{np.median(bare):.1f} ms, the same frames through sync process() median "
          f"{np.median(again[:-1]):.1f} ms (keyframe frame {SYNC_FRAMES + k - 1}: "
          f"{again[-1]:.1f} ms)")
    async_ms = 1e3 * float(np.mean(chunk_times[:(SYNC_FRAMES - 1) // k]))
    out["async_ms_per_frame_first_chunks"] = async_ms
    print(f"full system (b): sync process() over frames 1-{SYNC_FRAMES - 1}: "
          f"{out['sync']['ms_per_frame']:.1f} ms per frame (median {out['sync']['ms_per_plain_frame']:.1f} "
          f"without a keyframe; keyframe frames ms {', '.join(f'{x:.0f}' for x in out['sync']['ms_keyframes'])}); "
          f"async process_batch over the same frames {async_ms:.1f} ms per frame; host syncs "
          f"per sync frame {syncs}")
    return out


def phase_full_system(dev) -> dict:
    """The full system with TF32 on (the solvers pin full float32 on
    whichever thread they run)."""
    t_phase = time.perf_counter()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = dict(replay_loop=phase_full_system_loop(dev),
                   tracked=phase_full_system_tracked(dev))
        if not torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the full system changed the caller's TF32 setting")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    out["seconds"] = time.perf_counter() - t_phase
    print(f"full system: phase {out['seconds']:.1f} s")
    return out


# phase_run_tum: the real-data entry point on a TUM-format fixture
RUN_TUM_FRAMES, REPLAY_FRAMES, KLG_FRAMES = 41, 20, 8
# (a) ATE gate, aligned (run_tum's metric): about 2.7x the 3.73 mm these
# 41 frames give on an NVIDIA H100 80GB HBM3 at 700 W; phase_full_system
# (b) runs the same scene, noise model and heading rate on bench.py's
# config and gives 35.54 mm unaligned over 121 frames (gate 50 mm)
RUN_TUM_ATE_MAX = 0.010
CKPT_FRAMES, CKPT_AT = 16, 8
CKPT_CFG = dataclasses.replace(FULL_CFG, keyframe_period=5)
SPLAT_STEPS = 16
SPLAT_CFG = dataclasses.replace(BENCH_CFG, raycast_period=2)
MESH_CPU_POINTS = 1024
# the one build failure of the native loader a run may pass: a missing
# library or header on the host (the Python reader then runs)
NATIVE_MISSING = ("jpeglib.h", "zlib.h", "-ljpeg", "-lz")
ROOT = Path(__file__).resolve().parent


def _tum_fixture(root: Path, dev, intr=TUM1, n=RUN_TUM_FRAMES):
    """A TUM RGB-D layout at ``root``: bench.py's full-system frames
    (complex_room on panorama_trajectory at 1.8 deg/frame, the Kinect model
    seeded per frame), PNG rows cycling through all five filter types.
    Returns (ground truth poses, timestamps, depths, colours) as numpy."""
    scene = synth.complex_room(dev)
    gt = synth.panorama_trajectory(n, n_turns=1.8 * (n - 1) / 360.0)
    depths, rgbs = [], []
    for i in range(n):
        d, c = synth.render_frame_kinect(scene, gt[i], intr,
                                         torch.Generator(dev).manual_seed(1000 + i), 1.0)
        depths.append(d.cpu().numpy())
        rgbs.append(c.cpu().numpy())
    ts = 1305031102.175304 + np.arange(n) / 30.0
    tum.write_sequence(str(root), np.stack(depths), np.stack(rgbs), ts, gt,
                       filters=np.arange(intr.height) % 5)
    return gt, ts, depths, rgbs


def _png_decode_ms(depth: np.ndarray, rgb: np.ndarray) -> dict:
    """Median ms of 3 decodes of one depth and one colour frame, for each
    filter type on every row and for the fixture's cycle."""
    d16 = np.clip(np.round(depth * 5000.0), 0, 65535).astype(np.uint16)
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    out = {}
    for name, rows in (("none", 0), ("sub", 1), ("up", 2), ("average", 3), ("paeth", 4),
                       ("cycle", np.arange(d16.shape[0]) % 5)):
        for kind, img in (("depth", d16), ("rgb", rgb8)):
            data = png.encode(img, filters=rows)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = png.decode(data)
                times.append(1e3 * (time.perf_counter() - t0))
            if not np.array_equal(got, img):
                raise RuntimeError(f"run_tum: PNG round trip of {kind} with filter {name} differs")
            out[f"{kind}_{name}"] = float(np.median(times))
    return out


def _ply_map(path: Path) -> sm.SurfelMap:
    """The positions of an ``io/ply.save_ply`` file as a CPU surfel map
    (confidence 1, the other channels zero)."""
    pos = ply.load_ply_positions(str(path))
    if not np.isfinite(pos).all():
        raise RuntimeError(f"run_tum: non-finite positions in {path.name}")
    data = np.zeros((max(len(pos), 1), sm.N_CHANNELS), np.float32)
    data[:len(pos), sm.POS] = pos
    data[:len(pos), sm.CONF] = 1.0
    data[:len(pos), sm.VALID] = 1.0
    return sm.SurfelMap(data=torch.from_numpy(data),
                        count=torch.tensor(len(pos), dtype=torch.int32))


def _run_tum_cli(fixture: Path, out: Path, n: int, cmd) -> dict:
    """(a) the command line as a user runs it; checks every artefact."""
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, str(fixture), "--camera", "TUM1", "--out", str(out),
                           "--stats", "--views", "4"], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"run_tum (a): exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["run_tum"]
    ts_gt = tum.load_groundtruth(str(fixture / "groundtruth.txt"))[0]
    ts, poses = traj.load_tum(str(out / "hrbf_trajectory.freiburg"))
    kts, kposes = traj.load_tum(str(out / "KeyFrameTrajectory.txt"))
    rows = [json.loads(line) for line in open(out / "stats.jsonl")]
    timing_txt = (out / "sequence_processing_time.txt").read_text()
    views = [png.read(str(p)) for p in sorted((out / "views").glob("view_*.png"))]
    ply_map = _ply_map(out / "hrbf_globalModel.ply")
    problems = []
    if not (len(ts) == n and np.allclose(ts, ts_gt, atol=1e-6) and np.isfinite(poses).all()):
        problems.append("hrbf_trajectory.freiburg")
    if len(kts) != res["keyframes"] or not np.isfinite(kposes).all():
        problems.append("KeyFrameTrajectory.txt")
    if [r["frame"] for r in rows] != list(range(n)):
        problems.append("stats.jsonl")
    if "processFrame" not in timing_txt or f"n={n}" not in timing_txt:
        problems.append("sequence_processing_time.txt")
    if len(views) != 4 or any(v.shape != (TUM1.height, TUM1.width, 3) for v in views):
        problems.append("views/")
    if int(ply_map.count) != res["surfels"]:
        problems.append("hrbf_globalModel.ply")
    due = 1 + (n - 1) // SLAMConfig().keyframe_period
    ate_m = res.get("ate_m", float("nan"))
    print(f"run_tum (a): `python -m hrbffusion3d_tpu_torch.run_tum` on {n} "
          f"{TUM1.width}x{TUM1.height} frames, "
          f"exit 0 in {wall:.1f} s: {res['fps']:.2f} fps over the frames ({res['seconds']:.2f} s, "
          f"the first frame after {res['first_frame_s']:.2f} s: the decoder pool's start), "
          f"ATE {ate_m * 1e3:.2f} mm (aligned, {res.get('ate_matched')} matched), keyframes "
          f"{res['keyframes']} of {due} due, loops {res['loops']}, archive_dropped "
          f"{res['archive_dropped']}, map {res['surfels']} surfels, launches "
          f"{json.dumps(res['launches'])}; artefacts parsed: trajectory {len(ts)} poses, "
          f"{len(kts)} keyframe poses, {len(rows)} stats rows, {len(views)} views")
    if problems:
        raise RuntimeError(f"run_tum (a): artefacts missing or wrong: {problems}")
    if not (np.isfinite(ate_m) and ate_m < RUN_TUM_ATE_MAX):
        raise RuntimeError(f"run_tum (a): ATE {ate_m} (limit {RUN_TUM_ATE_MAX})")
    if res["keyframes"] != due:
        raise RuntimeError(f"run_tum (a): {res['keyframes']} keyframes inserted, {due} due")
    _driven("run_tum (a)", res["launches"])
    res.update(wall_s=wall, keyframes_due=due, ply_map=ply_map, first_pose=poses[0])
    return res


def _fullslam_alone(dev, depths, rgbs, ts) -> dict:
    """The frames of (a), already decoded, through the FullSLAM that
    run_tum drives (its config, async): what the entry point adds."""
    cfg = dataclasses.replace(SLAMConfig(), map_capacity=1 << 19)
    frames = [slam.FrameInput(torch.from_numpy(d), torch.from_numpy(c))
              for d, c in zip(depths, rgbs)]
    sys_ = full_slam.FullSLAM(TUM1, cfg, async_ba=True, device=dev)
    t0 = time.perf_counter()
    for f, stamp in zip(frames, ts):
        sys_.process(f, timestamp=float(stamp))
    sys_.close()
    secs = time.perf_counter() - t0
    due = 1 + (len(frames) - 1) // cfg.keyframe_period
    print(f"run_tum (a): the same {len(frames)} frames decoded beforehand, through FullSLAM "
          f"alone (run_tum's config, async): {len(frames) / secs:.2f} fps ({secs:.2f} s), "
          f"keyframes {len(sys_.backend.keyframes)} of {due} due")
    return dict(fps=len(frames) / secs, seconds=secs, keyframes=len(sys_.backend.keyframes))


def _replay(fixture: Path, out: Path, n: int, dev) -> dict:
    """(b) --load-trajectory on the ground truth: the poses come back as given."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    run_tum.main([str(fixture), "--camera", "TUM1", "--end", str(n), "--out", str(out),
                  "--load-trajectory", str(fixture / "groundtruth.txt")])
    launches = dict(kernels.LAUNCHES)
    _, gt = traj.load_tum(str(fixture / "groundtruth.txt"))
    _, poses = traj.load_tum(str(out / "hrbf_trajectory.freiburg"))
    err = float(np.abs(poses - gt[:n]).max()) if poses.shape == gt[:n].shape else float("inf")
    print(f"run_tum (b): replay of {n} frames from groundtruth.txt: written trajectory vs input "
          f"max abs {err:.3g}; launches {json.dumps(launches)}")
    if err > 1e-6:
        raise RuntimeError(f"run_tum (b): replayed trajectory differs from its input by {err}")
    _driven("run_tum (b)", launches)
    return dict(frames=n, max_abs=err, launches=launches)


def _klg(tmp: Path, depths, rgbs) -> dict:
    """(c) the same frames as .klg: native loader vs the Python reader."""
    path = str(tmp / "seq.klg")
    klg.write(path, np.stack(depths), np.stack(rgbs), depth_scale=1.0 / 5000.0)
    h, w = depths[0].shape
    py = list(klg.frames(path, w, h, 1.0 / 5000.0))
    t0 = time.perf_counter()
    nat = list(native_loader.frames(path, w, h, 1.0 / 5000.0))
    nat_s = time.perf_counter() - t0
    st = native_loader.status()
    if st["reader"] != "native":
        print(f"run_tum (c): native loader unavailable, the Python reader ran: {st['build_error']}")
        if not any(key in (st["build_error"] or "") for key in NATIVE_MISSING):
            raise RuntimeError(f"run_tum (c): native loader failed: {st['build_error']}")
        return dict(reader=st["reader"], build_error=st["build_error"])
    same = len(nat) == len(py) == len(depths) and all(
        a.timestamp == b.timestamp and np.array_equal(a.depth, b.depth)
        and np.array_equal(np.round(a.rgb * 255), np.round(b.rgb * 255))
        and np.abs(a.rgb.view(np.int32) - b.rgb.view(np.int32)).max() <= 1
        for a, b in zip(py, nat))
    rgb_exact = all(np.array_equal(a.rgb, b.rgb) for a, b in zip(py, nat))
    print(f"run_tum (c): {len(nat)} frames through the native loader ({st['library']}, "
          f"{1e3 * nat_s / max(len(nat), 1):.1f} ms per frame) and the Python reader: "
          f"timestamps and depth bit for bit {same}, colour floats bit for bit {rgb_exact} "
          f"(else within one ulp: the library scales by 1/255, the reader divides)")
    if not same:
        raise RuntimeError("run_tum (c): the native loader's frames differ from the Python reader's")
    return dict(reader="native", frames=len(nat), rgb_bit_exact=rgb_exact,
                ms_per_frame=1e3 * nat_s / max(len(nat), 1))


def _ckpt_run(dev, frames, gt, stop=None, path=None):
    sys_ = full_slam.FullSLAM(TUM1, CKPT_CFG, init_pose=gt[0], device=dev)
    for i, f in enumerate(frames):
        if i == stop:
            checkpoint.save(path, sys_)
            sys_ = checkpoint.load(path, full_slam.FullSLAM(TUM1, CKPT_CFG, init_pose=gt[0],
                                                            device=dev))
        sys_.process(f, timestamp=float(i))
    return sys_


def _ckpt_gaps(a, b) -> dict:
    """Largest differences of two systems: poses, live map rows, archive
    rows (inf where the counts differ)."""
    out = {"poses": float(np.abs(a.poses() - b.poses()).max())}
    for name, x, y in (("map", a.state.map, b.state.map), ("archive", a.archive, b.archive)):
        if x is None or y is None:
            out[name] = 0.0 if x is y else float("inf")
            continue
        nx, ny = int(x.count), int(y.count)
        out[name] = (float("inf") if nx != ny else
                     float((x.data[:nx] - y.data[:ny]).abs().max()) if nx else 0.0)
    return out


def _checkpoint(dev, depths, rgbs, gt, tmp: Path) -> dict:
    """(d) two uninterrupted sync runs and one saved and resumed mid-way."""
    frames = [slam.FrameInput(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev))
              for d, c in zip(depths[:CKPT_FRAMES], rgbs[:CKPT_FRAMES])]
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    a = _ckpt_run(dev, frames, gt)
    launches = dict(kernels.LAUNCHES)
    b = _ckpt_run(dev, frames, gt)
    path = str(tmp / "ckpt.bin")
    t0 = time.perf_counter()
    c = _ckpt_run(dev, frames, gt, stop=CKPT_AT, path=path)
    c_s = time.perf_counter() - t0
    ab, ac = _ckpt_gaps(a, b), _ckpt_gaps(a, c)
    repeat = all(v == 0.0 for v in ab.values())
    mb = Path(path).stat().st_size / 2 ** 20
    print(f"run_tum (d): {CKPT_FRAMES} sync frames, keyframes "
          f"{[k.frame_time for k in a.backend.keyframes]}, archive {a._archive_count} "
          f"surfels; A = B bit for bit on the card: {repeat} (A vs B {ab}); C saved at frame "
          f"{CKPT_AT} ({mb:.1f} MiB) and resumed: A vs C {ac}; run C {c_s:.1f} s; launches of "
          f"A {json.dumps(launches)}")
    _driven("run_tum (d)", launches)
    if repeat and any(v != 0.0 for v in ac.values()):
        raise RuntimeError(f"run_tum (d): the resumed run differs from the uninterrupted one: {ac}")
    if not repeat and any(ac[k] > ab[k] for k in ac):
        raise RuntimeError(f"run_tum (d): the resumed run is outside the A-vs-B spread: {ac} {ab}")
    return dict(repeat_bit_exact=repeat, a_vs_b=ab, a_vs_c=ac, file_mib=mb,
                keyframes=[k.frame_time for k in a.backend.keyframes], launches=launches)


def _splat(dev) -> dict:
    """(e) SPLAT_STEPS steps at raycast_period 2 on the bench config: the
    ray cast on the frames whose time is even, splat prediction between."""
    scene = synth.default_room(dev)
    poses = synth.orbit_trajectory(SPLAT_STEPS + 1, angle_per_frame=0.004)
    frames = [slam.FrameInput(*synth.render_frame(scene, p, TUM1)) for p in poses]
    cfg = SPLAT_CFG
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    state = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
    est, step_ms, syncs = [lie.rt_to_mat(state.R, state.t)], [], 0
    for f in frames[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, s = _count_syncs(lambda: slam.step(state, f, TUM1, cfg))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        syncs += s
        est.append(lie.rt_to_mat(state.R, state.t))
    launches = dict(kernels.LAUNCHES)
    ate, dense, icp = _check_run("run_tum (e) splat", state, est, poses)
    hrbf_frames = 1 + sum(1 for time_ in range(2, SPLAT_STEPS + 2) if time_ % cfg.raycast_period == 0)
    print(f"run_tum (e): bootstrap + {SPLAT_STEPS} steps at raycast_period {cfg.raycast_period}: "
          f"ATE {ate * 1e3:.3f} mm, dense_frac {dense:.4f}, last_icp_count {icp:.0f}, host syncs "
          f"{syncs} over the steps, median step {np.median(step_ms):.1f} ms (under sync-debug "
          f"mode), launches {json.dumps(launches)} (ray cast on the {hrbf_frames} HRBF frames)")
    if syncs != 0:
        raise RuntimeError(f"run_tum (e): {syncs} host syncs over the splat steps")
    if launches["raycast_core"] != hrbf_frames:
        raise RuntimeError(f"run_tum (e): ray cast launched {launches['raycast_core']} times, "
                           f"expected {hrbf_frames}")
    _driven("run_tum (e)", launches)
    return dict(steps=SPLAT_STEPS, ate_mm=ate * 1e3, host_syncs=syncs, launches=launches,
                hrbf_frames=hrbf_frames, median_step_ms=float(np.median(step_ms)))


def _eval(ply_map: sm.SurfelMap, to_world: np.ndarray, dev) -> dict:
    """(f) the (a) map's accuracy against the scene and its tessellation on
    the card; a subset against the same function on the CPU.  The run
    starts at the identity: ``to_world`` (4,4) takes its map to the
    scene's frame."""
    data = ply_map.data.to(dev)
    T = torch.from_numpy(to_world.astype(np.float32)).to(dev)
    data[:, sm.POS] = data[:, sm.POS] @ T[:3, :3].T + T[:3, 3]
    m = sm.SurfelMap(data, ply_map.count.to(dev))
    scene = synth.complex_room(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = recon.map_accuracy(m, scene)
    acc_ms = 1e3 * (time.perf_counter() - t0)
    mesh_ = mesh.scene_to_mesh(scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc_mesh = mesh.map_accuracy_mesh(m, mesh_)
    mesh_ms = 1e3 * (time.perf_counter() - t0)
    n = int(m.count)
    pick = np.random.default_rng(0).choice(n, min(MESH_CPU_POINTS, n), replace=False)
    sub = m.pos[torch.from_numpy(pick).to(dev)]
    d_card = mesh.point_to_mesh_distance(sub, mesh_).cpu().numpy()
    d_cpu = mesh.point_to_mesh_distance(sub.cpu(), mesh_).numpy()
    gap = float(np.abs(d_card - d_cpu).max())
    print(f"run_tum (f): map of (a), {n} surfels: map_accuracy (scene) mean "
          f"{acc['mean'] * 1e3:.2f} mm, rmse {acc['rmse'] * 1e3:.2f} mm in {acc_ms:.1f} ms; "
          f"map_accuracy_mesh ({mesh_.faces.shape[0]} triangles, float64) mean "
          f"{acc_mesh['mean'] * 1e3:.2f} mm, rmse {acc_mesh['rmse'] * 1e3:.2f} mm in "
          f"{mesh_ms:.1f} ms ({n * mesh_.faces.shape[0] / 1e9:.2f} G point-triangle pairs); "
          f"{len(pick)} points card vs CPU max abs {gap:.3g} m")
    if not (np.isfinite(acc["rmse"]) and np.isfinite(acc_mesh["rmse"])):
        raise RuntimeError(f"run_tum (f): non-finite accuracy {acc} {acc_mesh}")
    if gap > 1e-9:
        raise RuntimeError(f"run_tum (f): point_to_mesh_distance card vs CPU {gap} > 1e-9")
    return dict(surfels=n, triangles=int(mesh_.faces.shape[0]), scene=acc, scene_ms=acc_ms,
                mesh=acc_mesh, mesh_ms=mesh_ms, cpu_points=len(pick), card_vs_cpu=gap)


def phase_run_tum(dev, cmd=None) -> dict:
    """The real-data entry point on a TUM-format fixture written here:
    (a) the command line, (b) replay, (c) .klg through the native loader,
    (d) checkpoint / resume, (e) splat prediction, (f) reconstruction
    accuracy.  ``cmd``: how (a) starts the entry point."""
    t_phase = time.perf_counter()
    cmd = cmd or [sys.executable, "-m", "hrbffusion3d_tpu_torch.run_tum"]
    with tempfile.TemporaryDirectory(prefix="run_tum_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        gt, ts, depths, rgbs = _tum_fixture(tmp / "seq", dev)
        fixture_s = time.perf_counter() - t0
        decode = _png_decode_ms(depths[0], rgbs[0])
        h, w = depths[0].shape
        print(f"run_tum: fixture of {len(gt)} frames written in {fixture_s:.1f} s; PNG decode ms "
              f"(one {w}x{h} frame, median of 3) "
              + json.dumps({k: round(v, 2) for k, v in decode.items()}))
        out = dict(fixture_s=fixture_s, png_decode_ms=decode)
        out["cli"] = _run_tum_cli(tmp / "seq", tmp / "out_a", len(gt), cmd)
        ply_map = out["cli"].pop("ply_map")
        to_world = gt[0].astype(np.float64) @ np.linalg.inv(out["cli"].pop("first_pose"))
        out["fullslam_alone"] = _fullslam_alone(dev, depths, rgbs, ts)
        out["replay"] = _replay(tmp / "seq", tmp / "out_b", REPLAY_FRAMES, dev)
        out["klg"] = _klg(tmp, depths[:KLG_FRAMES], rgbs[:KLG_FRAMES])
        out["checkpoint"] = _checkpoint(dev, depths, rgbs, gt, tmp)
        out["splat"] = _splat(dev)
        out["eval"] = _eval(ply_map, to_world, dev)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"run_tum: phase {out['seconds']:.1f} s")
    return out


def main() -> None:
    name, smi = phase_card()
    dev = torch.device("cuda", 0)
    attrs = phase_build()
    poses, frames = phase_frames(dev)
    state, launches, _ = phase_main_path(poses, frames)
    ray = phase_raycast_vs_plain(state)
    pre = phase_preprocess_vs_plain(frames)
    phase_use_pallas(poses, frames)
    profiled = phase_breakdown(poses, frames)
    backend = phase_backend(dev)
    print(json.dumps({"backend": backend}))
    full = phase_full_system(dev)
    full["device"] = smi
    print(json.dumps({"full_system": full}, default=float))
    real = phase_run_tum(dev)
    real["device"] = smi
    print(json.dumps({"run_tum": real}, default=float))

    rows = []
    for kname in kernels.LAUNCHES:
        r = ray["false_position"] if kname == "raycast_core" else pre[kname]
        row = {"name": kname, "route": "cuda",
               "source": f"hrbffusion3d_tpu_torch/csrc/{SOURCES[kname]}",
               "replaces": f"hrbffusion3d_tpu/ops/pallas_kernels.py:{REPLACES[kname]}",
               "launches": launches[kname], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "profiled_ms": profiled[kname]}
        row.update({k: v for k, v in r.items() if k not in row})
        row["run_tum_launches"] = real["cli"]["launches"][kname]
        row["replay_launches"] = real["replay"]["launches"][kname]
        row["checkpoint_launches"] = real["checkpoint"]["launches"][kname]
        row["splat_launches"] = real["splat"]["launches"][kname]
        if kname == "bilateral_filter":
            row["keyframe_launches"] = full["tracked"]["keyframe_bilateral_launches"]
        if kname == "raycast_core":
            row["variants"] = ray
            row["attributes"] = {k: attrs[f"raycast_core K={k}"] for k in (10, 16)}
        elif kname in attrs:
            row["attributes"] = attrs[kname]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
