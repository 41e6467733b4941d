"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's dense SLAM step — ``bootstrap`` then 15 ``step``s on
synthetic 640x480 RGB-D frames under the bench configuration — through its
four hand-written CUDA kernels, checks the trajectory and each kernel
against its plain PyTorch version, and prints:
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
  - a JSON line ``{"kernels": [...]}``: per kernel its launches on the main
    path, max abs error against the plain version, both times and the
    bound (the least time the card could take for the same work);
  - last, ``{"ok": true, "device": {...}}``.
Every phase raises on failure; without a CUDA device the script raises
before printing any result.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

from hrbffusion3d_tpu_torch.config import TUM1, SLAMConfig
from hrbffusion3d_tpu_torch.core import camera, lie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.eval.ate import ate_rmse
from hrbffusion3d_tpu_torch.map import surfel_map as sm
from hrbffusion3d_tpu_torch.ops import kernels, preprocess, raycast
from hrbffusion3d_tpu_torch.pipeline import slam
from hrbffusion3d_tpu_torch.tracking import odometry

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
    return name


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


def _count_syncs(fn):
    """Run ``fn`` under CUDA sync-debug mode; returns (its result, the
    number of host synchronisations it made)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


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

    def dev_time(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
    dev_us = sum(dev_time(e) for e in events)
    n_ops = sum(e.count for e in events)
    print(f"breakdown: profiler over 2 steps: {n_ops / 2:.0f} device ops per step, "
          f"device busy {dev_us / 2e3:.2f} ms per step")
    per_launch = {}
    for kname, symbol in KERNEL_SYMBOLS.items():
        hits = [e for e in events if symbol in e.key]
        count = sum(e.count for e in hits)
        per_launch[kname] = sum(dev_time(e) for e in hits) / max(count, 1) / 1e3
        print(f"breakdown: profiler {kname}: {count} launches in 2 steps, "
              f"{per_launch[kname] * 1e3:.2f} us of device time per launch")
    return per_launch


def main() -> None:
    name = phase_card()
    dev = torch.device("cuda", 0)
    attrs = phase_build()
    poses, frames = phase_frames(dev)
    state, launches, _ = phase_main_path(poses, frames)
    ray = phase_raycast_vs_plain(state)
    pre = phase_preprocess_vs_plain(frames)
    phase_use_pallas(poses, frames)
    profiled = phase_breakdown(poses, frames)

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
