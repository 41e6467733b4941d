"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

Drives the port's dense SLAM step — ``bootstrap`` then 15 ``step``s on
synthetic 640x480 RGB-D frames under the bench configuration — through its
four hand-written CUDA kernels, checks the trajectory and each kernel
against its plain PyTorch version, drives the sparse keyframe backend
(which has no hand-written kernel) and the full system (``FullSLAM``),
and prints:
  - the card's name and power limit (nvidia-smi);
  - the float32 square root: the share of 4 M draws on which the card's
    ``torch.sqrt`` and the port's ``tensors.sqrt`` differ from the
    correctly rounded root, and the host CPU's beside them (the helper must
    be bit-exact on both), a JSON line ``{"sqrt": {...}}``;
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
    on every keyframe (global BA holds those it cannot determine; each
    keyframe's observations in it printed, and how far a 1e-7 nudge of the poses
    moves each keyframe on the CPU); (b) bench.py's
    full-system protocol, 61 frames async through ``process_batch``
    (fps steady and all-in, worst chunk, ATE under 5 cm, loops,
    ``archive_dropped``, active and archive counts, keyframes inserted of
    due, the worker's stage seconds, host syncs per chunk) and 21 of its
    frames through a synchronous ``process``, the next 10 as bare steps
    and through ``process``, 10 more profiled; each
    run with the kernels' launch counts reset before it and every kernel
    launched; a JSON line ``{"full_system": {...}}``;
  - the real-data entry point (``phase_run_tum``) on a TUM-format
    fixture it writes (bench.py's full-system frames, 20 at 640x480, PNG
    rows through all five filters): (a) ``python -m
    hrbffusion3d_tpu_torch.run_tum`` as a subprocess (exit 0, every
    artefact parsed, ATE gate, keyframes inserted = due; fps, ATE,
    keyframes, loops, ``archive_dropped``) and the same frames decoded
    beforehand through FullSLAM alone (fps), (b) ``--load-trajectory``
    replay (the input trajectory written back within 1e-6), (c) the same
    frames as .klg through the native loader (which must build: the port's
    own zlib-only library) and the Python reader, and a JPEG-colour .klg
    at 640x480 (the committed fixture ``tests/data/klg_jpeg``'s 20 Pillow
    JPEGs with the card's depth): both readers' colour bytes equal the
    fixture's Pillow digests, FullSLAM (run_tum's config, async) on the
    native loader's frames in turns with the same frames stored raw, then
    with the card's raw colour (ATE gate, 0 host syncs and every kernel in
    each dense step), the host's
    decode ms per frame, and a corrupt JPEG and a truncated zlib payload
    raise in both readers at their frame, (d)
    checkpoint / resume (two runs and a resumed one, bit for bit when the
    two repeat), (e) 16 steps of splat prediction (``raycast_period`` 2;
    0 host syncs, the ray cast on the HRBF frames only), (f) the (a) map's
    accuracy against the scene and its mesh on the card, a subset against
    the CPU, (g) a TUM-layout sequence of the committed progressive JPEG
    fixture ``tests/data/tum_jpeg_progressive`` (the same 20 frames as
    (c)'s, progressive) as colour and the card's depth as 16-bit PNG, one
    frame in five Adam7-interlaced: the decoder's library loaded, every
    colour file decoded to its Pillow digest and its baseline frame's, the
    depth read back as written, the CLI on it (all 20 frames, ATE gate)
    and ``run_tum.main`` again in this process (0 host syncs and every
    kernel in each dense step), the host's decode ms per frame progressive
    beside baseline, the CLI's fps after its first frame beside (a)'s on
    PNG colour, (h) a TUM-layout sequence of the committed JPEG-forms
    fixture ``tests/data/jpeg_forms`` (the same 20 frames in CMYK, YCCK,
    luma 4x1, lossless, arithmetic sequential and progressive, and
    progressive left unrefined) with the card's depth as 16-bit PNG: every
    file to its Pillow digest through ``jpeg.decode`` and both .klg
    readers, the host's decode ms per form beside the baseline frame's,
    ``run_tum.main`` in this process (all 20 frames, ATE gate, 0 host
    syncs and every kernel in each dense step), (i) a TUM-layout sequence
    of the committed depth-forms fixture ``tests/data/depth_forms`` (the
    first 9 frames' depth as 16-bit PGM and as 16-bit TIFF with no
    compression, PackBits, deflate and LZW with predictor 2, each in both
    byte orders) with (c)'s JPEGs as colour, every second one as PNG:
    every file to its Pillow digest through the TUM reader's decoders, the
    host's decode ms per depth form beside the baseline JPEG's,
    ``run_tum.main`` in this process (every frame, ATE gate, 0 host syncs
    and every kernel in each dense step), (j) a TUM-layout sequence of the
    colour-forms fixture ``tests/data/colour_forms`` (the first 9 frames'
    colour as PPM, BMP 24-bit, RLE8 and 32-bit bitfields, TIFF RGB with
    LZW and predictor 2, planar deflate and tiled PackBits, palette and
    CMYK TIFF) with the depth-forms fixture's depth as PNG, two frames as
    tiled 16-bit TIFF in each byte order: the same checks, (k) a
    TUM-layout sequence of the TIFF-forms fixture ``tests/data/tiff_forms``
    (the first 9 frames' colour as JPEG-in-TIFF RGB strips and YCbCr tiles
    and strips, with and without JPEGTables, YCbCr LZW (2, 2), deflate
    (4, 2) and PackBits (1, 1), and BigTIFF RGB, plain, LZW tiled and
    JPEG) with the depth-forms fixture's depth as PNG, two frames as
    16-bit BigTIFF: the same checks, and greyscale JPEG and JPEG-in-TIFF
    depth to their digests, (l) a TUM-layout sequence of the TIFF-codecs
    fixture ``tests/data/tiff_codecs`` (the first 9 frames' 16-bit depth as
    ZSTD with predictor 1 and 2 in both byte orders, tiled and BigTIFF,
    and LZMA with predictor 1 and 2, one tiled big-endian; frames 0-2's
    colour as ZSTD and LZMA RGB with predictor 2 and ZSTD YCbCr (2, 2),
    the rest the baseline JPEG): the same checks, and CCITT group 3 2D,
    group 4, RLE/W and ThunderScan files to their digests; PNG decode ms
    per filter type; a JSON line ``{"run_tum": {...}}``;
  - every tracking and normal setting of ``SLAMConfig``
    (``phase_tracking_modes``): the correspondence search, sparse ICP,
    bilinear photometric lookups (separate and joint), fixed
    correspondences, the early exit (its live iterations per level),
    subsampling, top-k, the patch association, both together, central-
    difference normals, ICP only and RGB only, each bootstrap + 3 steps of
    the orbit beside the default mode's in one call: ATE (gated but for
    the one-term modes), 0 host syncs in every step, the kernels' launches
    (PCA none with central differences), the median step, and every
    step's ``track`` repeated on the CPU (within 1e-4 rad and 1e-4 m; the
    largest gap per mode printed; for the default mode's last track the
    CPU's own 1-thread spread beside it); one ``track(rgb_only=True)``
    the same way within 1e-3 (its float32 spread is ~1e-4); a JSON line
    ``{"tracking_modes": {...}}``;
  - the landmark-sharded local BA (``phase_distributed``): (a)
    ``phase_backend``'s last local-BA problem, padded as the mesh path
    pads it, on 1-, 4- and 8-shard meshes of the card (0 host syncs, a
    repeat bit for bit, card vs the port's CPU run of the same mesh and
    n shards vs 1 within 1e-4, ms per solve beside ``ba.optimize``); (b)
    the same problem in 2 spawned ``gloo`` processes of 4 shards (their
    tensors on the card) and in 1 ``nccl`` process of 8, each bit for bit
    to the in-process 8-shard solve; (c) ``FullSLAM(mesh=make_mesh(4))``
    on 21 frames of (b)'s protocol through a synchronous
    ``process_batch`` (every local BA sharded, ATE under 5 cm, 0 host
    syncs and every kernel in each dense step; the map's rows on the 4
    shards: its dense state is row-sharded) beside
    ``mesh=None`` on the same frames (the keyframe-pose gap printed); a
    JSON line ``{"distributed": {...}}``;
  - the row-sharded dense step (``phase_sharded_step``) on 4- and 8-shard
    meshes of the card, the dense-step cell's first 8 frames: (a) replayed at
    the main path's poses, equal to the unsharded step bit for bit after
    every step; (b) tracked beside the unsharded step (each frame's pose
    within 1e-4, equal counts; each step also against the unsharded step
    from its own previous state, and the unsharded step replayed at its
    tracked pose bit for bit; ATE under 2.5 cm); (c) each kernel launched
    on one shard's slab against its plain version and against its
    whole-image launch on the slab's rows (bit for bit); (d) 0 host syncs
    in a sharded step; (e) distributed (c); (f) every tracking mode of
    ``phase_tracking_modes`` tracked on ``make_mesh(4)`` over its frames,
    bit for bit to that phase's unsharded run after every step, 0 host
    syncs per step; (g) 2 spawned ``gloo`` processes x 4 shards on the
    card (the same 8 frames from the sharded bootstrap:
    replayed, tracked, and tracked with the correspondence search), every
    step's pose and count and the last state bit for bit to the in-process
    ``make_mesh(8)`` run; ms per step beside the unsharded step, launches
    per shard per step, bytes per shard, bytes put into the collectives
    per step in (g); a JSON line ``{"sharded_step": {...}}``;
  - ``FullSLAM`` over a process group (``phase_group_full_system``, (h)):
    2 spawned ``gloo`` processes x 2 shards on the card, launched once:
    (i) phase_distributed (c)'s 21 frames sync through one
    ``process_batch``, bit for bit to (c)'s in-process ``make_mesh(4)``
    run (every pose and keyframe pose, each process's map rows, the
    count, the archive, ``archive_dropped``); (ii) the same frames
    through ``process`` with async BA, the two processes bit for bit to
    each other (the corrections applied at the same frames), ATE under 5
    cm; (iii) phase_full_system (a)'s out-and-back replayed, the loop
    closing on both processes with the same pair and deltas, bit for bit
    to the same run on an in-process ``make_mesh(4)``; per part the fps
    per process beside the in-process run's, host syncs per dense step,
    every kernel in every dense step of every process, bytes into the
    collectives per frame (dense step, backend) and the backend's ms per
    keyframe per process; a JSON line ``{"group_full_system": {...}}``;
  - a JSON line ``{"kernels": [...]}``: per kernel its launches on the main
    path (the bilateral kernel's keyframe call site apart, and the
    launches of each ``phase_run_tum`` path (the JPEG-colour .klg runs of
    (c), the CLI and in-process runs of (g) and the run of (h) included),
    each tracking
    mode,
    ``phase_distributed`` (c) and each ``phase_sharded_step`` run, (f)'s
    modes, (g)'s runs and (h)'s parts beside them, with its slab check),
    max abs error
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
import hashlib
import json
import lzma
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib
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
from hrbffusion3d_tpu_torch.io import image, jpeg, klg, native_loader, ply, png, traj, tum
from hrbffusion3d_tpu_torch.map import surfel_map as sm
from hrbffusion3d_tpu_torch.ops import kernels, preprocess, pyramid, raycast
from hrbffusion3d_tpu_torch.parallel import dist_ba, multihost, sharded_step, sharding
from hrbffusion3d_tpu_torch.pipeline import full_slam, slam
from hrbffusion3d_tpu_torch.tracking import odometry
from hrbffusion3d_tpu_torch.utils import checkpoint, tensors

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
# global BA holds a keyframe with fewer than loop.MIN_BA_OBS observations at
# its pose-graph pose.  NUDGE: the size of the seeded change of the keyframe
# poses that shows how far rounding moves each keyframe through correct()
MIN_BA_OBS, NUDGE = loop.MIN_BA_OBS, 1e-7
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
# chunks of keyframe_period frames, cut from 281 frames to FULL_FRAMES (121
# until the script outgrew half its time limit); a
# SYNC_FRAMES-frame synchronous run on the same frames beside it
FULL_CFG = dataclasses.replace(BENCH_CFG, keyframe_period=10, use_global_ba=True,
                               active_capacity=393216, archive_capacity=2097152)
FULL_FRAMES, SYNC_FRAMES, FULL_ATE_MAX = 61, 21, 0.05


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
    # the port reads LZMA TIFF strips with Python's lzma (no decoder of its own)
    if not all(lzma.is_check_supported(c) for c in (lzma.CHECK_CRC32, lzma.CHECK_CRC64,
                                                      lzma.CHECK_SHA256)):
        raise RuntimeError("Python's lzma lacks an .xz check: the port's LZMA TIFF route")
    print(f"build: Python {sys.version.split()[0]}'s lzma reads .xz (CRC32, CRC64, SHA-256)")
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


# phase_sqrt: float32 draws, half uniform over every finite non-negative
# bit pattern, half uniform in [0, 4)
SQRT_DRAWS = 1 << 22
# pixels of the grey conversion held card against CPU
INTENSITY_PIXELS = 200_000


def _mismatch(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of float32 elements whose bits differ."""
    return float((got.view(torch.int32) != ref.view(torch.int32)).double().mean())


def phase_sqrt(dev) -> dict:
    """The card's float32 ``torch.sqrt`` and the port's ``tensors.sqrt``
    (its only float32 square root) against the float64 square root rounded
    to float32, which is correctly rounded, on SQRT_DRAWS draws; beside
    them the host's: torch's CPU float32 ``sqrt`` and ``tensors.sqrt`` on
    the CPU against numpy's.  Fails unless the helper is bit-exact on
    both.  Also ``pyramid.rgb_to_intensity`` (XLA's rounding of the JAX
    package's grey conversion, in float64) on INTENSITY_PIXELS seeded
    pixels: the card's must equal the CPU's bit for bit."""
    g = torch.Generator(dev).manual_seed(16)
    half = SQRT_DRAWS // 2
    bits = torch.randint(0, 0x7F800000, (half,), generator=g, device=dev, dtype=torch.int64)
    x = torch.cat([bits.to(torch.int32).view(torch.float32),
                   4.0 * torch.rand(half, generator=g, device=dev)])
    ref = torch.sqrt(x.double()).to(torch.float32)
    out = dict(draws=SQRT_DRAWS, card_torch_sqrt=_mismatch(torch.sqrt(x), ref),
               card_helper=_mismatch(tensors.sqrt(x), ref))
    xc = x.cpu()
    ref_c = torch.from_numpy(np.sqrt(xc.numpy()))
    out["cpu_torch_sqrt"] = _mismatch(torch.sqrt(xc), ref_c)
    out["cpu_helper"] = _mismatch(tensors.sqrt(xc), ref_c)
    print(f"sqrt: float32 square roots on {SQRT_DRAWS} draws, share differing from the "
          f"correctly rounded root: card torch.sqrt {out['card_torch_sqrt']:.6f}, card "
          f"tensors.sqrt {out['card_helper']:.6f} (against the float64 root rounded); host "
          f"CPU torch.sqrt {out['cpu_torch_sqrt']:.6f}, CPU tensors.sqrt "
          f"{out['cpu_helper']:.6f} (against numpy's)")
    if out["card_helper"] or out["cpu_helper"]:
        raise RuntimeError(f"sqrt: tensors.sqrt is not correctly rounded: {out}")
    rgb = torch.rand((INTENSITY_PIXELS, 3), generator=g, device=dev)
    grey = pyramid.rgb_to_intensity(rgb)
    out["intensity_card_vs_cpu"] = _mismatch(grey.cpu(), pyramid.rgb_to_intensity(rgb.cpu()))
    print(f"sqrt: rgb_to_intensity on {INTENSITY_PIXELS} pixels, share of the card's differing "
          f"from the CPU's: {out['intensity_card_vs_cpu']:.6f}")
    if out["intensity_card_vs_cpu"]:
        raise RuntimeError(f"sqrt: rgb_to_intensity differs between the card and the CPU: {out}")
    return out


def _render_frames(dev):
    """The dense-step cell's orbit and its frames, rendered on ``dev``."""
    scene = synth.default_room(dev)
    poses = synth.orbit_trajectory(N_FRAMES, angle_per_frame=0.004)
    return poses, [slam.FrameInput(*synth.render_frame(scene, p, TUM1)) for p in poses]


def phase_frames(dev):
    poses, frames = _render_frames(dev)
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
    return state, launches, med, est


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
        agree, both, max_err, dots, near = _raycast_agreement(out, ref)
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
        _raycast_gate(f"raycast_core [{variant}]", agree, both, max_err, dots, near)
        results[variant] = dict(max_abs_err=max_err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                bound_done_ms=done_ms, bound_done_by=done_by)
    return results


def _raycast_agreement(out, ref):
    """(found agreement, found in both, p_surf max abs error there, share of
    gradients with dot > 0.9999 there, share of equal nearest taps there)."""
    f_k, f_r = out[3], ref[3]
    both = f_k & f_r
    gk = torch.nn.functional.normalize(out[1][both], dim=-1)
    gr = torch.nn.functional.normalize(ref[1][both], dim=-1)
    return ((f_k == f_r).float().mean().item(), both,
            (out[0] - ref[0]).abs().amax(-1)[both].max().item(),
            ((gk * gr).sum(-1) > 0.9999).float().mean().item(),
            (out[2][both] == ref[2][both]).float().mean().item())


def _raycast_gate(name, agree, both, max_err, dots, near):
    """The ray cast's rule against its plain version: found agreement >
    0.995 on > 50 % found, p_surf within 1e-4 m, gradients dot > 0.9999
    on > 99 % and nearest taps equal on >= 99 % where both found."""
    if not (agree > 0.995 and both.float().mean().item() > 0.5 and max_err < 1e-4
            and dots > 0.99 and near >= 0.99):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")


def _raycast_rule(name, out, ref) -> float:
    """``_raycast_gate`` on a kernel's output and its plain version's;
    returns the p_surf max abs error."""
    agree, both, max_err, dots, near = _raycast_agreement(out, ref)
    print(f"{name}: found agree {agree:.5f} (both {both.float().mean().item():.4f}), p_surf "
          f"max abs err {max_err:.3e} m, normal dot>0.9999 {dots:.5f}, nearest equal "
          f"{near:.5f}")
    _raycast_gate(name, agree, both, max_err, dots, near)
    return max_err


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
    BA after each (the last keyframe's pose drifted; its unpadded problem
    is returned beside the results, on the host), each call timed with
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
                    # the problem this local BA solves: phase_distributed's
                    last_problem = be.local_problem()[0]
                t_ba = time.perf_counter()
                captured.clear()
                deltas, ba_syncs = _count_syncs(be.local_ba)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                kf = be.keyframes[-1]
                row = dict(kf=k, frame=t, valid_keypoints=int(kf.kp_valid.sum()),
                           landmarks=len(be.landmarks),
                           shared=sum(len(o) >= 2 for o in be.lm_obs.values()),
                           insert_ms=1e3 * (t1 - t0), insert_syncs=ins_syncs,
                           local_ba_ms=1e3 * (t2 - t_ba), local_ba_syncs=ba_syncs,
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
                seconds=secs), last_problem

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


def _loop_frames(dev, scale: float):
    """The out-and-back of tests/test_full_slam_loop.py at 640x480: (its
    poses, the replayed poses whose return leg drifts by STEP_XI * scale
    per step over the last 4 frames, the frames rendered on ``dev``)."""
    gt = _out_and_back()
    step = lie.se3_exp(torch.from_numpy(STEP_XI * scale)).numpy()
    D = np.eye(4, dtype=np.float32)
    drifted = []
    for k in range(gt.shape[0]):
        if k >= gt.shape[0] - 4:
            D = step @ D
        drifted.append((D @ gt[k]).astype(np.float32))
    scene = synth.default_room(dev)
    return (gt, np.stack(drifted),
            [slam.FrameInput(*synth.render_frame(scene, p, TUM1)) for p in gt])


def _replay_loop(dev, label: str, scale: float):
    """FullSLAM.process in replay mode at 640x480 on the out-and-back of
    tests/test_full_slam_loop.py, the return leg's drift steps scaled by
    ``scale``.  Returns (results, the system, its closer's state just before
    each correct(), each correct()'s result)."""
    gt, drifted, frames = _loop_frames(dev, scale)
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
    keyframe (global BA holds those with fewer than MIN_BA_OBS
    observations at their pose-graph poses), and its chi2 within
    CHI2_RTOL; the observations and how far the nudge moves each keyframe
    are printed."""
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
    held = obs < MIN_BA_OBS
    gap = float(gaps.max())
    chi_card, chi_cpu = (float(c["out"][1]) for c in chis[:2])
    chi_rel = abs(chi_card - chi_cpu) / abs(chi_cpu)
    out.update(global_ba_obs=obs.tolist(), correct_card_vs_cpu_gaps=gaps.tolist(),
               correct_card_vs_cpu_pose_gap=gap, nudge=NUDGE, nudge_moves=moved.tolist(),
               global_ba_chi2=[chi_card, chi_cpu], global_ba_chi2_rel=chi_rel,
               global_ba_ms={c["label"]: c["ms"] for c in chis[:2]})
    print(f"full system (a) {label}: closing correct() card vs CPU: global BA observations per "
          f"keyframe {obs.tolist()} ({int(held.sum())} held, < {MIN_BA_OBS}); keyframe poses "
          f"within {gap:.3g} on all {len(gaps)}, per keyframe "
          f"{', '.join(f'{x:.3g}' for x in gaps)}; "
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
    loop-side landmarks merge into it, and global BA holds it at its
    pose-graph pose when it has fewer than MIN_BA_OBS observations (the
    JAX package leaves it free, to follow float rounding)."""
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
# the fixture's trajectory has RUN_TUM_FRAMES poses; its first TUM_SEQ_FRAMES
# are written (all 41 until the script outgrew half its time limit; 20 are
# (g)'s length, so (a) and (g) run the same frames)
RUN_TUM_FRAMES, TUM_SEQ_FRAMES, REPLAY_FRAMES, KLG_FRAMES = 41, 20, 20, 8
# (a) ATE gate, aligned (run_tum's metric): about 2.7x the 3.73 mm the
# 41 frames gave on an NVIDIA H100 80GB HBM3 at 700 W; phase_full_system
# (b) runs the same scene, noise model and heading rate on bench.py's
# config and gives 35.54 mm unaligned over 121 frames (gate 50 mm)
RUN_TUM_ATE_MAX = 0.010
CKPT_FRAMES, CKPT_AT = 16, 8
CKPT_CFG = dataclasses.replace(FULL_CFG, keyframe_period=5)
SPLAT_STEPS = 16
SPLAT_CFG = dataclasses.replace(BENCH_CFG, raycast_period=2)
MESH_CPU_POINTS = 1024
ROOT = Path(__file__).resolve().parent
# (c) the JPEG-colour .klg: the committed fixture (scripts/make_klg_jpeg_fixture.py)
KLG_JPEG_DIR = ROOT / "tests" / "data" / "klg_jpeg"
KLG_DEPTH_SCALE = 1.0 / 5000.0
KLG_DECODE_REPEATS = 3
KLG_BAD_FRAMES, KLG_BAD_AT = 4, 2
# (ii): "jpeg" the JPEG .klg; "raw" its decoded pixels stored raw (the same
# frames into FullSLAM: the gap is the loader's decoding); "card" the card's
# rendered colour stored raw
KLG_RUN_ORDER = ("jpeg", "raw", "raw", "jpeg", "card")
# (g) a TUM-layout sequence: the committed progressive JPEG fixture
# (scripts/make_klg_jpeg_fixture.py, the same frames as KLG_JPEG_DIR's) as
# colour, the card's depth as 16-bit PNG, every TUM_JPEG_ADAM7_EVERY-th
# depth frame Adam7-interlaced
TUM_JPEG_DIR = ROOT / "tests" / "data" / "tum_jpeg_progressive"
TUM_JPEG_ADAM7_EVERY = 5
# (h) a TUM-layout sequence of the JPEG forms beyond Huffman DCT of 1 or 3
# components sampled at most 2x2 (scripts/make_jpeg_forms_fixture.py: the
# same frames as KLG_JPEG_DIR's, frame i in form i mod 7) as colour, the
# card's depth as 16-bit PNG
FORMS_DIR = ROOT / "tests" / "data" / "jpeg_forms"
# (i) a TUM-layout sequence of depth in PGM and TIFF (the committed fixture,
# scripts/make_depth_forms_fixture.py: the first frames of KLG_JPEG_DIR's,
# frame i in form i) with KLG_JPEG_DIR's JPEGs as colour, every second one
# written as PNG here
DEPTH_FORMS_DIR = ROOT / "tests" / "data" / "depth_forms"
# (j) a TUM-layout sequence of colour in netpbm, BMP and TIFF (the committed
# fixture, scripts/make_colour_forms_fixture.py: the first frames of
# KLG_JPEG_DIR's, frame i in form i; the two forms too large to commit are
# written here from their JPEG by the tests' encoders) beside
# DEPTH_FORMS_DIR's depth, as PNG but for two frames as tiled TIFF
COLOUR_FORMS_DIR = ROOT / "tests" / "data" / "colour_forms"


def colour_form_bytes(entry: dict) -> bytes:
    """A file of the colour-forms fixture (an entry of its digests.json):
    read from the fixture, or, for a form written at run time, written from
    its JPEG (decoded by the port, bit for bit with Pillow) by
    ``tests/torch_bmp_encoder.py`` or ``tests/torch_tiff_encoder.py``."""
    if "writer" not in entry:
        return (COLOUR_FORMS_DIR / entry["file"]).read_bytes()
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_bmp_encoder
    import torch_tiff_encoder

    rgb = jpeg.decode((KLG_JPEG_DIR / entry["source"]).read_bytes())
    if entry["writer"] == "bmp32_bitfields_top_down":
        return torch_bmp_encoder.encode(rgb, 32, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                        header=124, top_down=True)
    if entry["writer"] == "tiff_rgb_tiled_packbits":
        return torch_tiff_encoder.encode(rgb, "II", 32773, photometric=2, tile=(96, 64))
    raise ValueError(f"no writer {entry['writer']!r}")


# (l) a TUM-layout sequence of depth in ZSTD and LZMA TIFF, colour in ZSTD
# and LZMA RGB and ZSTD YCbCr TIFF for its first frames, and CCITT and
# ThunderScan files held to their digests (the committed fixture,
# scripts/make_tiff_codecs_fixture.py: the card's machine has no zstandard)
TIFF_CODECS_DIR = ROOT / "tests" / "data" / "tiff_codecs"

# (k) a TUM-layout sequence of colour in BigTIFF, JPEG-in-TIFF and YCbCr
# TIFF (the committed fixture, scripts/make_tiff_forms_fixture.py: the first
# frames of KLG_JPEG_DIR's, frame i in form i; the forms that are large or
# wrap a committed JPEG are written here by the tests' TIFF encoder) beside
# DEPTH_FORMS_DIR's depth, as PNG but for two frames as 16-bit BigTIFF; and
# greyscale JPEG and JPEG-in-TIFF depth held to their digests
TIFF_FORMS_DIR = ROOT / "tests" / "data" / "tiff_forms"


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> full-range YCbCr (JFIF's equations in float64,
    rounded half away from zero and clipped): the samples of the YCbCr
    TIFF forms, the same bytes on every machine."""
    m = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]])
    v = rgb.astype(np.float64) @ m.T + np.array([0.0, 128.0, 128.0])
    return np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), 0, 255).astype(np.uint8)


def tiff_form_bytes(entry: dict) -> bytes:
    """A file of the TIFF-forms fixture (an entry of its digests.json): read
    from the fixture, or, for a form written at run time, written by
    ``tests/torch_tiff_encoder.py`` from its JPEG (decoded by the port, bit
    for bit with Pillow) or its depth file."""
    if "writer" not in entry:
        return (TIFF_FORMS_DIR / entry["file"]).read_bytes()
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_tiff_encoder as enc

    form = entry["writer"]
    if form == "bigtiff_depth16":
        d16 = image.read_depth(str(DEPTH_FORMS_DIR / entry["source"])).astype(np.uint16)
        return enc.encode(d16, bigtiff=True)
    stream = (KLG_JPEG_DIR / entry["source"]).read_bytes()
    rgb = jpeg.decode(stream)
    if form == "bigtiff_rgb":
        return enc.encode(rgb, photometric=2, bigtiff=True)
    if form == "tiff_jpeg_ycbcr420_strip_no_530":
        return enc.encode(rgb, compression=7, photometric=6, chunks=[stream])
    if form == "tiff_ycbcr11_packbits_mm":
        return enc.encode(rgb_to_ycbcr(rgb), "MM", 32773, photometric=6, rows_per_strip=32,
                          extra={530: (enc.SHORT, [1, 1])})
    if form == "bigtiff_jpeg_ycbcr420_tables":
        tables, body = enc.jpeg_tables(stream)
        return enc.encode(rgb, compression=7, photometric=6, chunks=[body], bigtiff=True,
                          extra={347: (enc.UNDEFINED, tables), 530: (enc.SHORT, [2, 2])})
    raise ValueError(f"no writer {form!r}")


def tum_frames(dev, intr=TUM1, n=RUN_TUM_FRAMES, first=None):
    """bench.py's full-system frames (complex_room on panorama_trajectory at
    1.8 deg/frame, the Kinect model seeded per frame), rendered on ``dev``:
    (the n ground truth poses, the first ``first`` (default n) depths and
    colours as numpy).  ``scripts/make_klg_jpeg_fixture.py`` renders the
    colours of the committed JPEG fixture with it."""
    scene = synth.complex_room(dev)
    gt = synth.panorama_trajectory(n, n_turns=1.8 * (n - 1) / 360.0)
    depths, rgbs = [], []
    for i in range(n if first is None else first):
        d, c = synth.render_frame_kinect(scene, gt[i], intr,
                                         torch.Generator(dev).manual_seed(1000 + i), 1.0)
        depths.append(d.cpu().numpy())
        rgbs.append(c.cpu().numpy())
    return gt, depths, rgbs


def _tum_fixture(root: Path, dev, intr=TUM1, n=RUN_TUM_FRAMES, first=None):
    """A TUM RGB-D layout at ``root``: the first ``first`` (default n)
    frames of ``tum_frames``, PNG rows cycling through all five filter
    types.  Returns (ground truth poses, timestamps, depths, colours) as
    numpy."""
    gt, depths, rgbs = tum_frames(dev, intr, n, first)
    n = len(depths)
    gt = gt[:n]
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
    klg.write(path, np.stack(depths), np.stack(rgbs), depth_scale=KLG_DEPTH_SCALE)
    h, w = depths[0].shape
    t0 = time.perf_counter()
    if not native_loader.available():
        raise RuntimeError("run_tum (c): the native loader did not build: "
                           f"{native_loader.status()['build_error']}")
    build_s = time.perf_counter() - t0
    py = list(klg.frames(path, w, h, KLG_DEPTH_SCALE))
    t0 = time.perf_counter()
    nat = list(native_loader.frames(path, w, h, KLG_DEPTH_SCALE))
    nat_s = time.perf_counter() - t0
    st = native_loader.status()
    if st["reader"] != "native":
        raise RuntimeError(f"run_tum (c): the {st['reader']} reader ran, not the native loader")
    same = len(nat) == len(py) == len(depths) and all(
        a.timestamp == b.timestamp and np.array_equal(a.depth, b.depth)
        and np.array_equal(np.round(a.rgb * 255), np.round(b.rgb * 255))
        and np.abs(a.rgb.view(np.int32) - b.rgb.view(np.int32)).max() <= 1
        for a, b in zip(py, nat))
    rgb_exact = all(np.array_equal(a.rgb, b.rgb) for a, b in zip(py, nat))
    print(f"run_tum (c): the native loader built in {build_s:.2f} s ({st['library']}); "
          f"{len(nat)} frames through it ({1e3 * nat_s / max(len(nat), 1):.1f} ms per frame) and "
          f"the Python reader: "
          f"timestamps and depth bit for bit {same}, colour floats bit for bit {rgb_exact} "
          f"(else within one ulp: the library scales by 1/255, the reader divides)")
    if not same:
        raise RuntimeError("run_tum (c): the native loader's frames differ from the Python reader's")
    return dict(reader="native", library=st["library"], build_s=build_s, frames=len(nat),
                rgb_bit_exact=rgb_exact, ms_per_frame=1e3 * nat_s / max(len(nat), 1))


def _zlib_depth(d: np.ndarray) -> bytes:
    """A depth payload as io/klg.write makes it (u16 at KLG_DEPTH_SCALE)."""
    return zlib.compress(np.round(d / KLG_DEPTH_SCALE).astype(np.uint16).tobytes())


def _write_klg(path: Path, depth_payloads, colours, stamps):
    """A .klg of the given payloads; a colour is JPEG bytes or a raw
    (H, W, 3) uint8 frame."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(depth_payloads)))
        for dbuf, c, stamp in zip(depth_payloads, colours, stamps):
            ibuf = c if isinstance(c, bytes) else c.tobytes()
            f.write(struct.pack("<qii", int(stamp), len(dbuf), len(ibuf)))
            f.write(dbuf)
            f.write(ibuf)


def _klg_read(reader, path: Path, w: int, h: int):
    """(the frames ``reader`` yields, the seconds it took)."""
    t0 = time.perf_counter()
    out = list(reader(str(path), w, h, KLG_DEPTH_SCALE))
    return out, time.perf_counter() - t0


def _klg_fullslam(dev, path: Path, w: int, h: int, gt) -> dict:
    """FullSLAM (run_tum's config, async: ``_fullslam_alone``'s) on the
    frames the native loader yields from ``path`` as it decodes them; the
    host syncs and the kernels' launches of every dense step."""
    cfg = dataclasses.replace(SLAMConfig(), map_capacity=1 << 19)
    sys_ = full_slam.FullSLAM(TUM1, cfg, async_ba=True, device=dev)
    steps = []
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    with _sync_counts() as syncs, _per_frame(steps, syncs):
        t0 = time.perf_counter()
        for f in native_loader.frames(str(path), w, h, KLG_DEPTH_SCALE):
            sys_.process(slam.FrameInput(torch.from_numpy(f.depth), torch.from_numpy(f.rgb)),
                         timestamp=f.timestamp * 1e-6)
        sys_.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if native_loader.status()["reader"] != "native":
        raise RuntimeError("run_tum (c): FullSLAM's frames did not come from the native loader")
    est = sys_.poses()
    n = len(est)
    ate = ate_rmse(est, gt[:n]) if n == len(gt) and np.isfinite(est).all() else float("nan")
    return dict(frames=n, seconds=secs, fps=n / secs, ate_mm=ate * 1e3,
                keyframes=len(sys_.backend.keyframes),
                host_syncs_per_step=[s for s, _ in steps], launches=launches,
                idle_steps=[i for i, (_, per) in enumerate(steps) if min(per.values()) == 0])


def _klg_must_raise(reader, path: Path, w: int, h: int, at: int) -> str:
    """The message with which ``reader`` stops at frame ``at`` of ``path``,
    after yielding every frame before it."""
    got = []
    try:
        for f in reader(str(path), w, h, KLG_DEPTH_SCALE):
            got.append(f)
    except RuntimeError as e:
        if len(got) != at or f"frame {at}:" not in str(e):
            raise RuntimeError(f"run_tum (c): {path.name}: {len(got)} frames, then {e}") from e
        return str(e)
    raise RuntimeError(f"run_tum (c): {path.name}: the reader yielded {len(got)} frames and "
                       f"raised nothing on the corrupt frame {at}")


def _klg_jpeg(tmp: Path, dev, depths, rgbs, gt, ts, smi) -> dict:
    """(c) a JPEG-colour .klg at 640x480: the committed fixture's colour
    (Pillow, quality 90, 4:2:0) with the card's depth frames.  (i) both
    readers' colour bytes equal the fixture's Pillow digests; (ii)
    FullSLAM on the native loader's frames, in turns with the same frames
    with their colour stored raw, then with the card's raw colour; (iii)
    decode ms per frame on the host; and a corrupt JPEG payload and a
    truncated zlib payload make both readers raise."""
    meta = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    n = len(meta)
    payloads = [(KLG_JPEG_DIR / e["file"]).read_bytes() for e in meta]
    h, w = depths[0].shape
    stamps = np.round(ts[:n] * 1e6).astype(np.int64)
    dbufs = [_zlib_depth(d) for d in depths[:n]]
    paths = {label: tmp / f"{label}.klg" for label in ("jpeg", "raw", "card")}
    _write_klg(paths["jpeg"], dbufs, payloads, stamps)
    _write_klg(paths["card"], dbufs, [(np.clip(c, 0, 1) * 255).astype(np.uint8)
                                      for c in rgbs[:n]], stamps)

    # (i) digests, through both readers
    reads = {}
    for label, reader in (("native", native_loader.frames), ("python", klg.frames)):
        got, secs = _klg_read(reader, paths["jpeg"], w, h)
        digests = [hashlib.sha256(np.round(f.rgb * 255).astype(np.uint8).tobytes()).hexdigest()
                   for f in got]
        wrong = [i for i, (dg, e) in enumerate(zip(digests, meta)) if dg != e["rgb_sha256"]]
        reads[label] = (got, secs)
        print(f"run_tum (c): JPEG .klg, {len(got)} frames of {n} through the {label} reader: "
              f"colour vs the committed Pillow digests: {n - len(wrong) if len(got) == n else 0} "
              f"equal, differing frames {wrong}")
        if len(got) != n or wrong:
            raise RuntimeError(f"run_tum (c): the {label} reader's JPEG colour differs from "
                               f"Pillow's on frames {wrong} ({len(got)} frames of {n})")
    if native_loader.status()["reader"] != "native":
        raise RuntimeError("run_tum (c): the native loader did not run")
    _write_klg(paths["raw"], dbufs, [np.round(f.rgb * 255).astype(np.uint8)
                                     for f in reads["native"][0]], stamps)
    raw_nat, _ = _klg_read(native_loader.frames, paths["raw"], w, h)
    same = all(a.timestamp == b.timestamp == c.timestamp and np.array_equal(a.depth, b.depth)
               and np.array_equal(a.depth, c.depth) and np.array_equal(a.rgb, c.rgb)
               for a, b, c in zip(reads["native"][0], reads["python"][0], raw_nat))
    if not (same and len(raw_nat) == n):
        raise RuntimeError("run_tum (c): timestamps, depth or the raw copy's colour differ "
                           "between the readers or files")

    # (ii) FullSLAM on the decoded frames, beside raw colour, in turns
    runs = {label: [] for label in paths}
    for label in KLG_RUN_ORDER:
        runs[label].append(_klg_fullslam(dev, paths[label], w, h, gt[:n]))
    due = 1 + (n - 1) // SLAMConfig().keyframe_period
    for label, r in ((label, r) for label in runs for r in runs[label]):
        print(f"run_tum (c): FullSLAM (run_tum's config, async) on the native loader's {label}-"
              f"colour frames: {r['frames']} {w}x{h} frames, {r['fps']:.2f} fps "
              f"({r['seconds']:.2f} s, decoding included), ATE {r['ate_mm']:.3f} mm (aligned), "
              f"keyframes {r['keyframes']} of {due} due, host syncs per dense step "
              f"{sorted(set(r['host_syncs_per_step']))}, launches {json.dumps(r['launches'])}")
        if not (np.isfinite(r["ate_mm"]) and r["ate_mm"] < RUN_TUM_ATE_MAX * 1e3):
            raise RuntimeError(f"run_tum (c) {label}: ATE {r['ate_mm']} mm "
                               f"(limit {RUN_TUM_ATE_MAX * 1e3} mm)")
        _driven(f"run_tum (c) {label}", r["launches"])
        if any(r["host_syncs_per_step"]) or r["idle_steps"] or len(r["host_syncs_per_step"]) != n:
            raise RuntimeError(f"run_tum (c) {label}: host syncs per dense step "
                               f"{r['host_syncs_per_step']}, steps without every kernel "
                               f"{r['idle_steps']}")
    fps = {label: ", ".join(f"{r['fps']:.2f}" for r in rs) for label, rs in runs.items()}
    ate = {label: rs[0]["ate_mm"] for label, rs in runs.items()}
    print(f"run_tum (c): runs in the order {' '.join(KLG_RUN_ORDER)}: the JPEG frames "
          f"{fps['jpeg']} fps against their decoded pixels stored raw {fps['raw']} (the same "
          f"frames into FullSLAM: the gap is the loader's decoding; ATE "
          f"{ate['jpeg'] - ate['raw']:+.3f} mm) "
          f"and the card's raw colour {fps['card']} (ATE {ate['jpeg'] - ate['card']:+.3f} mm: the "
          f"fixture's colour was rendered on the CPU and compressed, the depth noise drawn on "
          f"the card)")

    # (iii) decode time on the host
    jpeg_ms = []
    for _ in range(KLG_DECODE_REPEATS):
        for data in payloads:
            t0 = time.perf_counter()
            jpeg.decode(data)
            jpeg_ms.append(1e3 * (time.perf_counter() - t0))
    per_frame = {}
    for label in ("jpeg", "raw"):
        for name, reader in (("native", native_loader.frames), ("python", klg.frames)):
            secs = [_klg_read(reader, paths[label], w, h)[1]
                    for _ in range(KLG_DECODE_REPEATS)]
            per_frame[f"{name}_{label}"] = 1e3 * float(np.median(secs)) / n
    timing = dict(jpeg_decode_ms=float(np.median(jpeg_ms)), reader_ms_per_frame=per_frame,
                  payload_bytes=[len(p) for p in payloads], host_cpus=os.cpu_count(), device=smi)
    print(f"run_tum (c): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"jpeg.decode of one {w}x{h} 4:2:0 frame {timing['jpeg_decode_ms']:.2f} ms (median of "
          f"{len(jpeg_ms)}, {min(timing['payload_bytes'])}-{max(timing['payload_bytes'])} bytes); "
          f"ms per frame over the whole file, median of {KLG_DECODE_REPEATS} passes: "
          + json.dumps({k: round(v, 2) for k, v in per_frame.items()}))

    # a corrupt JPEG payload and a truncated zlib payload raise in both readers
    bad_jpeg = list(payloads[:KLG_BAD_FRAMES])
    data = bytearray(bad_jpeg[KLG_BAD_AT])
    mid = data.index(b"\xff\xda") + (len(data) - data.index(b"\xff\xda")) // 2
    data[mid:mid + 16] = b"\xff" * 16
    bad_jpeg[KLG_BAD_AT] = bytes(data)
    cut = list(dbufs[:KLG_BAD_FRAMES])
    cut[KLG_BAD_AT] = cut[KLG_BAD_AT][:len(cut[KLG_BAD_AT]) // 2]   # the header says so too
    bad = {"jpeg": tmp / "bad_jpeg.klg", "zlib": tmp / "bad_zlib.klg"}
    _write_klg(bad["jpeg"], dbufs[:KLG_BAD_FRAMES], bad_jpeg, stamps)
    _write_klg(bad["zlib"], cut, payloads[:KLG_BAD_FRAMES], stamps)
    raised = {f"{kind} {name}": _klg_must_raise(reader, path, w, h, KLG_BAD_AT)
              for kind, path in bad.items()
              for name, reader in (("native", native_loader.frames), ("python", klg.frames))}
    for k, msg in raised.items():
        print(f"run_tum (c): corrupt frame {KLG_BAD_AT} of {KLG_BAD_FRAMES}, {k} reader: "
              f"{KLG_BAD_AT} frames, then RuntimeError: {msg[-160:]}")
    return dict(frames=n, digests_equal=True, fullslam=runs, timing=timing, corrupt=raised)


def _adam7_png(img: np.ndarray) -> bytes:
    """An Adam7-interlaced PNG of a 16-bit grey image (the port's writer
    writes non-interlaced files only), each pass's rows cycling through the
    five filter types of the PNG standard."""
    h, w = img.shape
    data = bytearray()
    k = 0
    for r0, c0, dr, dc in png.ADAM7:
        x = img[r0::dr, c0::dc]
        if x.size == 0:
            continue
        x = x.astype(">u2").view(np.uint8).reshape(len(x), -1).astype(np.int16)
        a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
        a[:, 2:], b[1:], c[1:, 2:] = x[:, :-2], x[:-1], x[:-1, :-2]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        preds = (np.zeros_like(x), a, b, (a + b) >> 1,
                 np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
        for i in range(len(x)):
            f = (k + i) % 5
            data.append(f)
            data += ((x[i] - preds[f][i]) & 0xFF).astype(np.uint8).tobytes()
        k += len(x)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(bytes(data))) + chunk(b"IEND", b""))


def _tum_jpeg_fixture(root: Path, depths, gt, ts) -> tuple[list, list]:
    """(g)'s TUM layout at ``root``: ``rgb/<ts>.jpg`` the progressive
    fixture, ``depth/<ts>.png`` the card's depth; returns (the colour
    files' bytes, the 16-bit depth images)."""
    meta = json.loads((TUM_JPEG_DIR / "digests.json").read_text())["frames"]
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    colours, d16s, lines = [], [], []
    for i, e in enumerate(meta):
        name = f"{ts[i]:.6f}"
        colours.append((TUM_JPEG_DIR / e["file"]).read_bytes())
        (root / "rgb" / f"{name}.jpg").write_bytes(colours[-1])
        d16 = np.clip(np.round(depths[i] / tum.TUM_DEPTH_SCALE), 0, 65535).astype(np.uint16)
        d16s.append(d16)
        (root / "depth" / f"{name}.png").write_bytes(
            _adam7_png(d16) if i % TUM_JPEG_ADAM7_EVERY == 0 else png.encode(d16))
        lines.append(f"{name} rgb/{name}.jpg {name} depth/{name}.png\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:len(meta)], gt[:len(meta)])
    return colours, d16s


def _steady_fps(res: dict) -> float:
    """A run_tum result's fps after its first frame (the decoder pool's
    start and the first frame's wait left out)."""
    return (res["frames"] - 1) / (res["seconds"] - res["first_frame_s"])


def _tum_jpeg(tmp: Path, dev, depths, gt, ts, png_cli: dict, klg_jpeg: dict, cmd, smi) -> dict:
    """(g) a TUM-layout sequence with progressive JPEG colour and partly
    Adam7-interlaced depth: the decoder library loaded; every colour file
    decoded to its Pillow digest and its baseline frame's; every depth file
    read back as written; the CLI on the sequence (all frames, ATE);
    ``run_tum.main`` on it again in this process, 0 host syncs and every
    kernel in each dense step; decode ms, progressive beside baseline; the
    CLI's fps beside (a)'s (``png_cli``) on PNG colour."""
    root = tmp / "seq_jpeg"
    colours, d16s = _tum_jpeg_fixture(root, depths, gt, ts)
    n = len(colours)
    if not native_loader.available():
        raise RuntimeError("run_tum (g): the JPEG decoder's library did not build: "
                           f"{native_loader.status()['build_error']}")
    meta = json.loads((TUM_JPEG_DIR / "digests.json").read_text())["frames"]
    base_meta = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    baseline = [(KLG_JPEG_DIR / e["file"]).read_bytes() for e in base_meta[:n]]
    ms = {"progressive": [], "baseline": []}
    wrong = []
    for repeat in range(KLG_DECODE_REPEATS):    # the two encodings of a frame in turns
        for i, (prog, base) in enumerate(zip(colours, baseline)):
            for label, data in (("progressive", prog), ("baseline", base)):
                t0 = time.perf_counter()
                rgb = jpeg.decode(data)
                ms[label].append(1e3 * (time.perf_counter() - t0))
                digest = hashlib.sha256(rgb.tobytes()).hexdigest()
                if repeat == 0 and (digest != meta[i]["rgb_sha256"]
                                    or digest != base_meta[i]["rgb_sha256"]):
                    wrong.append((label, i))
    depth_bad = [i for i, d in enumerate(d16s)
                 if not np.array_equal(png.read(str(root / "depth" / f"{ts[i]:.6f}.png")), d)]
    adam7_ms = {}
    for label, i in (("adam7", 0), ("plain", 1)):
        data = (root / "depth" / f"{ts[i]:.6f}.png").read_bytes()
        times = []
        for _ in range(KLG_DECODE_REPEATS):
            t0 = time.perf_counter()
            png.decode(data)
            times.append(1e3 * (time.perf_counter() - t0))
        adam7_ms[label] = float(np.median(times))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"run_tum (g): {n} progressive JPEG colour files (the library {native_loader.status()['library']}): "
          f"io/jpeg.decode vs the Pillow digests and the baseline frames' digests: "
          f"{n - len({i for _, i in wrong})} of {n} frames equal, differing {wrong}; depth "
          f"files read back as written (every {TUM_JPEG_ADAM7_EVERY}th Adam7-interlaced): "
          f"{n - len(depth_bad)} of {n}, differing {depth_bad}")
    if wrong or depth_bad:
        raise RuntimeError(f"run_tum (g): decoded colour {wrong} or depth {depth_bad} differ")
    print(f"run_tum (g): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"jpeg.decode of one {TUM1.width}x{TUM1.height} 4:2:0 frame, median of "
          f"{len(ms['progressive'])}: progressive {decode_ms['progressive']:.2f} ms, baseline "
          f"{decode_ms['baseline']:.2f} ms (each frame's two encodings in turns; "
          f"{min(map(len, colours))}-{max(map(len, colours))} bytes progressive); png.decode of "
          f"one 16-bit depth frame, median of {KLG_DECODE_REPEATS}: Adam7 {adam7_ms['adam7']:.1f} "
          f"ms, non-interlaced {adam7_ms['plain']:.1f} ms")

    cli = _tum_jpeg_cli(root, tmp / "out_g", n, cmd)
    steps = []
    with _sync_counts() as syncs, _per_frame(steps, syncs):
        res = run_tum.main([str(root), "--camera", "TUM1", "--out", str(tmp / "out_g2")])
    idle = [i for i, (_, per) in enumerate(steps) if min(per.values()) == 0]
    step_syncs = [s for s, _ in steps]
    ate_c = klg_jpeg["fullslam"]["jpeg"][0]["ate_mm"]
    print(f"run_tum (g): `run_tum.main` on the same sequence in this process: {res['frames']} "
          f"frames, {res['fps']:.2f} fps (under sync-debug mode), ATE {res['ate_m'] * 1e3:.3f} "
          f"mm; host syncs per dense step {sorted(set(step_syncs))} over {len(steps)} steps, "
          f"steps without every kernel {idle}; launches {json.dumps(res['launches'])}")
    print(f"run_tum (g): ATE {cli['ate_m'] * 1e3:.3f} mm on the progressive JPEG sequence "
          f"(the CLI) beside {ate_c:.3f} mm on (c)'s JPEG .klg of the same colour and depth "
          f"(FullSLAM on the native loader's frames); the CLI's fps after its first frame "
          f"{_steady_fps(cli):.2f} on progressive JPEG colour ({n} frames) beside "
          f"{_steady_fps(png_cli):.2f} for (a) on PNG colour ({png_cli['frames']} frames), over all "
          f"frames {cli['fps']:.2f} beside {png_cli['fps']:.2f} (the first frame after "
          f"{cli['first_frame_s']:.2f} / {png_cli['first_frame_s']:.2f} s: the decoder pool's "
          f"start)")
    if res["frames"] != n or len(steps) != n or any(step_syncs) or idle:
        raise RuntimeError(f"run_tum (g): in-process run of {res['frames']} frames, {len(steps)} "
                           f"dense steps, host syncs {step_syncs}, steps without every kernel "
                           f"{idle}")
    _driven("run_tum (g) in process", res["launches"])
    return dict(frames=n, library=native_loader.status()["library"], digests_equal=True,
                decode_ms=decode_ms, decode_ms_all=ms, depth_png_ms=adam7_ms, cli=cli,
                in_process=dict(fps=res["fps"], ate_mm=res["ate_m"] * 1e3,
                                launches=res["launches"], host_syncs_per_step=step_syncs),
                klg_jpeg_ate_mm=ate_c, steady_fps=_steady_fps(cli),
                png_steady_fps=_steady_fps(png_cli), progressive_bytes=[len(c) for c in colours],
                device=smi)


def _tum_jpeg_cli(root: Path, out: Path, n: int, cmd) -> dict:
    """(g) the command line on the JPEG-colour sequence: every frame
    consumed, the ATE gate, every kernel launched."""
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, str(root), "--camera", "TUM1", "--out", str(out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"run_tum (g): exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["run_tum"]
    _, poses = traj.load_tum(str(out / "hrbf_trajectory.freiburg"))
    ate_m = res.get("ate_m", float("nan"))
    print(f"run_tum (g): `python -m hrbffusion3d_tpu_torch.run_tum` on {n} progressive-JPEG "
          f"{TUM1.width}x{TUM1.height} frames, exit 0 in {wall:.1f} s: {res['frames']} frames "
          f"consumed, {res['fps']:.2f} fps over the frames ({res['seconds']:.2f} s, the first "
          f"frame after {res['first_frame_s']:.2f} s), ATE {ate_m * 1e3:.3f} mm (aligned, "
          f"{res.get('ate_matched')} matched), keyframes {res['keyframes']}, launches "
          f"{json.dumps(res['launches'])}")
    if res["frames"] != n or len(poses) != n:
        raise RuntimeError(f"run_tum (g): {res['frames']} frames consumed, {len(poses)} poses "
                           f"written, of {n}")
    if not (np.isfinite(ate_m) and ate_m < RUN_TUM_ATE_MAX):
        raise RuntimeError(f"run_tum (g): ATE {ate_m} (limit {RUN_TUM_ATE_MAX})")
    _driven("run_tum (g)", res["launches"])
    res["wall_s"] = wall
    return res


def _main_in_process(label: str, what: str, root: Path, n: int, out: Path) -> dict:
    """``run_tum.main`` on the TUM-layout sequence at ``root`` in this
    process, under ``_sync_counts`` / ``_per_frame``: fails unless all ``n``
    frames are consumed with 0 host syncs and every kernel in each dense
    step, within the ATE gate.  Returns its fps, first-frame seconds, ATE
    (mm), launches and host syncs per step."""
    steps = []
    with _sync_counts() as syncs, _per_frame(steps, syncs):
        res = run_tum.main([str(root), "--camera", "TUM1", "--out", str(out)])
    idle = [i for i, (_, per) in enumerate(steps) if min(per.values()) == 0]
    step_syncs = [s for s, _ in steps]
    ate_m = res.get("ate_m", float("nan"))
    print(f"run_tum ({label}): `run_tum.main` on the {what} sequence in this process: "
          f"{res['frames']} frames of {n} consumed, {res['fps']:.2f} fps (under sync-debug mode, "
          f"the first frame after {res['first_frame_s']:.2f} s), ATE {ate_m * 1e3:.3f} mm "
          f"(aligned, {res.get('ate_matched')} matched), keyframes {res['keyframes']}; host "
          f"syncs per dense step {sorted(set(step_syncs))} over {len(steps)} steps, steps "
          f"without every kernel {idle}; launches {json.dumps(res['launches'])}")
    if res["frames"] != n or len(steps) != n or any(step_syncs) or idle:
        raise RuntimeError(f"run_tum ({label}): {res['frames']} frames consumed, {len(steps)} "
                           f"dense steps, host syncs {step_syncs}, steps without every kernel "
                           f"{idle}")
    if not (np.isfinite(ate_m) and ate_m < RUN_TUM_ATE_MAX):
        raise RuntimeError(f"run_tum ({label}): ATE {ate_m} (limit {RUN_TUM_ATE_MAX})")
    _driven(f"run_tum ({label})", res["launches"])
    return dict(fps=res["fps"], first_frame_s=res["first_frame_s"], ate_mm=ate_m * 1e3,
                launches=res["launches"], host_syncs_per_step=step_syncs)


def _tum_forms(tmp: Path, depths, gt, ts, smi) -> dict:
    """(h) a TUM-layout sequence whose colour files are the JPEG forms
    fixture (CMYK, YCCK, luma 4x1, lossless, arithmetic sequential and
    progressive, progressive left unrefined): the decoder's library
    loaded; every file decoded by ``jpeg.decode`` and read from a .klg of
    the same payloads by both readers to its Pillow digest; the host's
    decode ms per form, each file in turns with the baseline fixture's
    frame; ``run_tum.main`` in this process on the sequence: every frame
    consumed, the ATE gate, 0 host syncs and every kernel in each dense
    step."""
    meta = json.loads((FORMS_DIR / "digests.json").read_text())
    entries = meta["frames"]
    n = len(entries)
    if not native_loader.available():
        raise RuntimeError("run_tum (h): the JPEG decoder's library did not build: "
                           f"{native_loader.status()['build_error']}")
    root = tmp / "seq_forms"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    colours, lines = [], []
    for i, e in enumerate(entries):
        name = f"{ts[i]:.6f}"
        colours.append((FORMS_DIR / e["file"]).read_bytes())
        (root / "rgb" / f"{name}.jpg").write_bytes(colours[-1])
        d16 = np.clip(np.round(depths[i] / tum.TUM_DEPTH_SCALE), 0, 65535).astype(np.uint16)
        (root / "depth" / f"{name}.png").write_bytes(png.encode(d16))
        lines.append(f"{name} rgb/{name}.jpg {name} depth/{name}.png\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:n], gt[:n])

    # (i) every file to its Pillow digest: io/jpeg and both .klg readers
    h, w = depths[0].shape
    wrong = {"jpeg.decode": [i for i, (c, e) in enumerate(zip(colours, entries))
                             if hashlib.sha256(jpeg.decode(c).tobytes()).hexdigest()
                             != e["rgb_sha256"]]}
    path = tmp / "forms.klg"
    _write_klg(path, [_zlib_depth(d) for d in depths[:n]], colours,
               np.round(ts[:n] * 1e6).astype(np.int64))
    for label, reader in (("native", native_loader.frames), ("python", klg.frames)):
        got, _ = _klg_read(reader, path, w, h)
        digests = [hashlib.sha256(np.round(f.rgb * 255).astype(np.uint8).tobytes()).hexdigest()
                   for f in got]
        wrong[label] = [i for i, e in enumerate(entries)
                        if i >= len(digests) or digests[i] != e["rgb_sha256"]]
    if native_loader.status()["reader"] != "native":
        raise RuntimeError("run_tum (h): the native loader did not run")
    print(f"run_tum (h): {n} colour files in {len(meta['forms'])} forms "
          f"({', '.join(meta['forms'])}; the library {native_loader.status()['library']}): "
          f"equal to their Pillow digests through "
          + ", ".join(f"{k} {n - len(v)} of {n}" for k, v in wrong.items())
          + f"; differing {wrong}")
    if any(wrong.values()):
        raise RuntimeError(f"run_tum (h): decoded colour differs from Pillow's: {wrong}")

    # (ii) host decode ms per form, each file in turns with its baseline frame
    base_meta = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    baseline = [(KLG_JPEG_DIR / e["file"]).read_bytes() for e in base_meta[:n]]
    ms = {label: [] for label in meta["forms"] + ["baseline"]}
    for _ in range(KLG_DECODE_REPEATS):
        for e, data, base in zip(entries, colours, baseline):
            for label, payload in ((e["form"], data), ("baseline", base)):
                t0 = time.perf_counter()
                jpeg.decode(payload)
                ms[label].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    sizes = {f: [e["bytes"] for e in entries if e["form"] == f] for f in meta["forms"]}
    print(f"run_tum (h): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"jpeg.decode of one {w}x{h} frame, median per form (of {KLG_DECODE_REPEATS} x its "
          f"frames, each in turns with the baseline fixture's frame): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + "; bytes per form " + json.dumps(sizes))

    # (iii) run_tum.main on the sequence in this process
    run = _main_in_process("h", "JPEG-forms", root, n, tmp / "out_h")
    return dict(frames=n, forms=meta["forms"], library=native_loader.status()["library"],
                digests_equal=True, decode_ms=decode_ms, decode_ms_all=ms, bytes=sizes,
                device=smi, **run)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def _tum_depth_forms(tmp: Path, gt, ts, smi) -> dict:
    """(i) a TUM-layout sequence whose depth files are the depth-forms
    fixture (16-bit PGM; 16-bit TIFF with no compression, PackBits,
    deflate and LZW with predictor 2, in both byte orders) and whose colour
    is the baseline JPEG fixture's, every second frame re-encoded as PNG:
    every depth file through ``image.read_depth`` to its Pillow digest and
    every colour file through ``image.read_colour`` to its JPEG's; the
    host's decode ms per depth form, each file in turns with its baseline
    JPEG; ``run_tum.main`` in this process on the sequence: every frame
    consumed, the ATE gate, 0 host syncs and every kernel in each dense
    step."""
    meta = json.loads((DEPTH_FORMS_DIR / "digests.json").read_text())
    entries = meta["frames"]
    n = len(entries)
    base = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"][:n]
    root = tmp / "seq_depth_forms"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines, depth_files, jpegs = [], [], []
    for i, (e, b) in enumerate(zip(entries, base)):
        name = f"{ts[i]:.6f}"
        jpegs.append((KLG_JPEG_DIR / b["file"]).read_bytes())
        rgb = f"rgb/{name}.png" if i % 2 else f"rgb/{name}.jpg"
        (root / rgb).write_bytes(png.encode(jpeg.decode(jpegs[-1])) if i % 2 else jpegs[-1])
        depth_files.append((DEPTH_FORMS_DIR / e["file"]).read_bytes())
        dep = f"depth/{name}{Path(e['file']).suffix}"
        (root / dep).write_bytes(depth_files[-1])
        lines.append(f"{name} {rgb} {name} {dep}\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:n], gt[:n])

    # (i) every file to its digest, read as the TUM reader reads it
    rows = [ln.split() for ln in lines]
    wrong = {"depth": [i for i, (r, e) in enumerate(zip(rows, entries))
                       if _sha(image.read_depth(str(root / r[3]))) != e["depth_sha256"]],
             "colour": [i for i, (r, b) in enumerate(zip(rows, base))
                        if _sha(image.read_colour(str(root / r[1]))) != b["rgb_sha256"]]}
    print(f"run_tum (i): {n} depth files in {len(meta['forms'])} forms "
          f"({', '.join(meta['forms'])}) beside JPEG and PNG colour: equal to their Pillow "
          f"digests through image.read_depth {n - len(wrong['depth'])} of {n} and "
          f"image.read_colour {n - len(wrong['colour'])} of {n}; differing {wrong}")
    if any(wrong.values()):
        raise RuntimeError(f"run_tum (i): decoded frames differ from Pillow's: {wrong}")

    # (ii) host decode ms per depth form, each file in turns with its JPEG
    ms = {label: [] for label in meta["forms"] + ["baseline_jpeg", "png_colour"]}
    colour_png = [(root / r[1]).read_bytes() for r in rows[1::2]]
    for _ in range(KLG_DECODE_REPEATS):
        for i, (e, data) in enumerate(zip(entries, depth_files)):
            for label, fn, payload in ((e["form"], image.decode_depth, data),
                                       ("baseline_jpeg", jpeg.decode, jpegs[i])):
                t0 = time.perf_counter()
                fn(payload)
                ms[label].append(1e3 * (time.perf_counter() - t0))
        for data in colour_png:
            t0 = time.perf_counter()
            png.decode_rgb(data)
            ms["png_colour"].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    h, w = entries[0]["height"], entries[0]["width"]
    print(f"run_tum (i): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"decode of one {w}x{h} frame, median (of {KLG_DECODE_REPEATS} x its files, each "
          f"depth file in turns with its baseline JPEG colour): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + "; bytes per form " + json.dumps({e["form"]: e["bytes"] for e in entries}))

    # (iii) run_tum.main on the sequence in this process
    run = _main_in_process("i", "depth-forms", root, n, tmp / "out_i")
    return dict(frames=n, forms=meta["forms"], digests_equal=True, decode_ms=decode_ms,
                decode_ms_all=ms, bytes={e["form"]: e["bytes"] for e in entries},
                device=smi, **run)


def _tum_colour_forms(tmp: Path, gt, ts, smi) -> dict:
    """(j) a TUM-layout sequence whose colour files are the colour-forms
    fixture (netpbm, BMP and TIFF colour, frame i in form i; two forms
    written here from their JPEG) and whose depth is the depth-forms
    fixture's frames as 16-bit PNG, but for the fixture's two tiled TIFF
    depth files: every file through ``image.read_colour`` /
    ``image.read_depth`` to its Pillow digest; the host's decode ms per
    colour form, each file in turns with its baseline JPEG; ``run_tum.main``
    in this process on the sequence: every frame consumed, the ATE gate, 0
    host syncs and every kernel in each dense step."""
    meta = json.loads((COLOUR_FORMS_DIR / "digests.json").read_text())
    colour = [e for e in meta["frames"] if e["kind"] == "colour"]
    depth_tiff = {e["frame"]: e for e in meta["frames"] if e["kind"] == "depth"}
    depth_meta = json.loads((DEPTH_FORMS_DIR / "digests.json").read_text())["frames"]
    n = len(colour)
    base = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"][:n]
    root = tmp / "seq_colour_forms"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines, colour_files, jpegs, depth_sha = [], [], [], []
    for i, (e, b) in enumerate(zip(colour, base)):
        name = f"{ts[i]:.6f}"
        jpegs.append((KLG_JPEG_DIR / b["file"]).read_bytes())
        colour_files.append(colour_form_bytes(e))
        rgb = f"rgb/{name}{Path(e['file']).suffix}"
        (root / rgb).write_bytes(colour_files[-1])
        if i in depth_tiff:
            dep = f"depth/{name}.tif"
            (root / dep).write_bytes((COLOUR_FORMS_DIR / depth_tiff[i]["file"]).read_bytes())
            depth_sha.append(depth_tiff[i]["depth_sha256"])
        else:
            dep = f"depth/{name}.png"
            d16 = image.read_depth(str(DEPTH_FORMS_DIR / depth_meta[i]["file"]))
            d16 = d16.astype(np.uint16)
            (root / dep).write_bytes(png.encode(d16))
            depth_sha.append(_sha(d16))
        lines.append(f"{name} {rgb} {name} {dep}\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:n], gt[:n])

    # (i) every file to its digest, read as the TUM reader reads it
    rows = [ln.split() for ln in lines]
    wrong = {"colour": [i for i, (r, e) in enumerate(zip(rows, colour))
                        if _sha(image.read_colour(str(root / r[1]))) != e["rgb_sha256"]],
             "depth": [i for i, (r, sha) in enumerate(zip(rows, depth_sha))
                       if _sha(image.read_depth(str(root / r[3]))) != sha]}
    print(f"run_tum (j): {n} colour files in {len(meta['forms'])} forms "
          f"({', '.join(meta['forms'])}; {', '.join(meta['runtime'])} written here) beside PNG "
          f"and tiled TIFF depth: equal to their Pillow digests through image.read_colour "
          f"{n - len(wrong['colour'])} of {n} and image.read_depth {n - len(wrong['depth'])} "
          f"of {n} ({len(depth_tiff)} tiled TIFF); differing {wrong}")
    if any(wrong.values()):
        raise RuntimeError(f"run_tum (j): decoded frames differ from Pillow's: {wrong}")

    # (ii) host decode ms per colour form, each file in turns with its JPEG
    ms = {label: [] for label in meta["forms"] + ["baseline_jpeg"]
          + [e["form"] for e in depth_tiff.values()]}
    for _ in range(KLG_DECODE_REPEATS):
        for i, (e, data) in enumerate(zip(colour, colour_files)):
            for label, fn, payload in ((e["form"], image.decode_colour, data),
                                       ("baseline_jpeg", jpeg.decode, jpegs[i])):
                t0 = time.perf_counter()
                fn(payload)
                ms[label].append(1e3 * (time.perf_counter() - t0))
        for e in depth_tiff.values():
            data = (COLOUR_FORMS_DIR / e["file"]).read_bytes()
            t0 = time.perf_counter()
            image.decode_depth(data)
            ms[e["form"]].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    h, w = colour[0]["height"], colour[0]["width"]
    print(f"run_tum (j): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"decode of one {w}x{h} frame, median (of {KLG_DECODE_REPEATS} x its files, each "
          f"colour file in turns with its baseline JPEG): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + "; bytes per form " + json.dumps({e["form"]: e["bytes"] for e in meta["frames"]}))

    # (iii) run_tum.main on the sequence in this process
    run = _main_in_process("j", "colour-forms", root, n, tmp / "out_j")
    return dict(frames=n, forms=meta["forms"], digests_equal=True, decode_ms=decode_ms,
                decode_ms_all=ms, bytes={e["form"]: e["bytes"] for e in meta["frames"]},
                device=smi, **run)


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


def _tum_tiff_forms(tmp: Path, gt, ts, smi) -> dict:
    """(k) a TUM-layout sequence whose colour files are the TIFF-forms
    fixture (JPEG-in-TIFF RGB and YCbCr in strips and tiles, with and
    without JPEGTables; YCbCr LZW, deflate and PackBits at subsamplings
    (2, 2), (4, 2) and (1, 1); BigTIFF RGB; frame i in form i, the large
    ones written here from their JPEG) and whose depth is the depth-forms
    fixture's frames as 16-bit PNG, but for the fixture's two 16-bit
    BigTIFF depth files: every file through ``image.read_colour`` /
    ``image.read_depth`` to its Pillow digest, and the fixture's greyscale
    JPEG and JPEG-in-TIFF depth (8 bits: not TUM depth) to theirs; the
    host's decode ms per form, each file in turns with its baseline JPEG;
    ``run_tum.main`` in this process on the sequence: every frame consumed,
    the ATE gate, 0 host syncs and every kernel in each dense step."""
    meta = json.loads((TIFF_FORMS_DIR / "digests.json").read_text())
    colour = [e for e in meta["frames"] if e["kind"] == "colour"]
    depth_tiff = {e["frame"]: e for e in meta["frames"]
                  if e["kind"] == "depth" and e.get("sequence", True)}
    grey = [e for e in meta["frames"] if e["kind"] == "depth" and not e.get("sequence", True)]
    depth_meta = json.loads((DEPTH_FORMS_DIR / "digests.json").read_text())["frames"]
    n = len(colour)
    base = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"][:n]
    root = tmp / "seq_tiff_forms"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines, colour_files, jpegs, depth_sha, depth_files = [], [], [], [], {}
    for i, (e, b) in enumerate(zip(colour, base)):
        name = f"{ts[i]:.6f}"
        jpegs.append((KLG_JPEG_DIR / b["file"]).read_bytes())
        colour_files.append(tiff_form_bytes(e))
        rgb = f"rgb/{name}.tif"
        (root / rgb).write_bytes(colour_files[-1])
        if i in depth_tiff:
            dep = f"depth/{name}.tif"
            depth_files[i] = tiff_form_bytes(depth_tiff[i])
            (root / dep).write_bytes(depth_files[i])
            depth_sha.append(depth_tiff[i]["depth_sha256"])
        else:
            dep = f"depth/{name}.png"
            d16 = image.read_depth(str(DEPTH_FORMS_DIR / depth_meta[i]["file"]))
            d16 = d16.astype(np.uint16)
            (root / dep).write_bytes(png.encode(d16))
            depth_sha.append(_sha(d16))
        lines.append(f"{name} {rgb} {name} {dep}\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:n], gt[:n])
    grey_files = [tiff_form_bytes(e) for e in grey]
    for e, data in zip(grey, grey_files):
        (root / e["file"]).write_bytes(data)

    # (i) every file to its digest, read as the TUM reader reads it
    rows = [ln.split() for ln in lines]
    wrong = {"colour": [i for i, (r, e) in enumerate(zip(rows, colour))
                        if _sha(image.read_colour(str(root / r[1]))) != e["rgb_sha256"]],
             "depth": [i for i, (r, sha) in enumerate(zip(rows, depth_sha))
                       if _sha(image.read_depth(str(root / r[3]))) != sha],
             "grey": [e["form"] for e in grey
                      if _sha(image.read_depth(str(root / e["file"]))) != e["depth_sha256"]]}
    print(f"run_tum (k): {n} colour files in {len(meta['forms'])} forms "
          f"({', '.join(meta['forms'])}; {', '.join(meta['runtime'])} written here) beside PNG "
          f"and BigTIFF depth: equal to their Pillow digests through image.read_colour "
          f"{n - len(wrong['colour'])} of {n} and image.read_depth {n - len(wrong['depth'])} "
          f"of {n} ({len(depth_tiff)} BigTIFF); greyscale depth "
          f"{len(grey) - len(wrong['grey'])} of {len(grey)} ({', '.join(e['form'] for e in grey)})"
          f"; differing {wrong}")
    if any(wrong.values()):
        raise RuntimeError(f"run_tum (k): decoded frames differ from Pillow's: {wrong}")

    # (ii) host decode ms per form, each file in turns with its JPEG
    extra = [(depth_tiff[i]["form"], image.decode_depth, data)
             for i, data in depth_files.items()]
    extra += [(e["form"], image.decode_depth, data) for e, data in zip(grey, grey_files)]
    ms = {label: [] for label in meta["forms"] + ["baseline_jpeg"] + [x[0] for x in extra]}
    for _ in range(KLG_DECODE_REPEATS):
        for i, (e, data) in enumerate(zip(colour, colour_files)):
            for label, fn, payload in ((e["form"], image.decode_colour, data),
                                       ("baseline_jpeg", jpeg.decode, jpegs[i])):
                t0 = time.perf_counter()
                fn(payload)
                ms[label].append(1e3 * (time.perf_counter() - t0))
        for label, fn, payload in extra:
            t0 = time.perf_counter()
            fn(payload)
            ms[label].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    h, w = colour[0]["height"], colour[0]["width"]
    print(f"run_tum (k): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"decode of one {w}x{h} frame, median (of {KLG_DECODE_REPEATS} x its files, each "
          f"colour file in turns with its baseline JPEG): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + "; bytes per form " + json.dumps({e["form"]: e["bytes"] for e in meta["frames"]}))

    # (iii) run_tum.main on the sequence in this process
    run = _main_in_process("k", "TIFF-forms", root, n, tmp / "out_k")
    return dict(frames=n, forms=meta["forms"], digests_equal=True, decode_ms=decode_ms,
                decode_ms_all=ms, bytes={e["form"]: e["bytes"] for e in meta["frames"]},
                device=smi, **run)


def _tum_tiff_codecs(tmp: Path, gt, ts, smi) -> dict:
    """(l) a TUM-layout sequence whose depth files are the TIFF-codecs
    fixture's (16-bit ZSTD with predictor 1 and 2 in both byte orders, in
    tiles and as BigTIFF, and LZMA with predictor 1 and 2, frame i in form
    i) and whose colour is the fixture's ZSTD and LZMA RGB and ZSTD YCbCr
    TIFF for its first frames and the baseline JPEG fixture's after them:
    every file through ``image.read_depth`` / ``image.read_colour`` to its
    Pillow digest, and the fixture's CCITT and ThunderScan files (1 and 4
    bits: not TUM depth) to theirs; the host's decode ms per form, each
    depth file in turns with its baseline JPEG; ``run_tum.main`` in this
    process on the sequence: every frame consumed, the ATE gate, 0 host
    syncs and every kernel in each dense step."""
    meta = json.loads((TIFF_CODECS_DIR / "digests.json").read_text())
    depth = [e for e in meta["frames"] if e["kind"] == "depth" and e.get("sequence", True)]
    colour = {e["frame"]: e for e in meta["frames"] if e["kind"] == "colour"}
    other = [e for e in meta["frames"] if not e.get("sequence", True)]
    n = len(depth)
    base = json.loads((KLG_JPEG_DIR / "digests.json").read_text())["frames"][:n]
    root = tmp / "seq_tiff_codecs"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines, depth_files, colour_files, jpegs, colour_sha = [], [], {}, [], []
    for i, (e, b) in enumerate(zip(depth, base)):
        name = f"{ts[i]:.6f}"
        jpegs.append((KLG_JPEG_DIR / b["file"]).read_bytes())
        if i in colour:
            colour_files[i] = (TIFF_CODECS_DIR / colour[i]["file"]).read_bytes()
            rgb = f"rgb/{name}.tif"
            (root / rgb).write_bytes(colour_files[i])
            colour_sha.append(colour[i]["rgb_sha256"])
        else:
            rgb = f"rgb/{name}.jpg"
            (root / rgb).write_bytes(jpegs[-1])
            colour_sha.append(b["rgb_sha256"])
        depth_files.append((TIFF_CODECS_DIR / e["file"]).read_bytes())
        dep = f"depth/{name}.tif"
        (root / dep).write_bytes(depth_files[-1])
        lines.append(f"{name} {rgb} {name} {dep}\n")
    (root / "associations.txt").write_text("".join(lines))
    traj.save_tum(str(root / "groundtruth.txt"), ts[:n], gt[:n])
    other_files = [(TIFF_CODECS_DIR / e["file"]).read_bytes() for e in other]

    # (i) every file to its digest, read as the TUM reader reads it
    rows = [ln.split() for ln in lines]
    wrong = {"depth": [i for i, (r, e) in enumerate(zip(rows, depth))
                       if _sha(image.read_depth(str(root / r[3]))) != e["depth_sha256"]],
             "colour": [i for i, (r, sha) in enumerate(zip(rows, colour_sha))
                        if _sha(image.read_colour(str(root / r[1]))) != sha],
             "other": [e["form"] for e in other
                       if _sha(image.read_depth(str(TIFF_CODECS_DIR / e["file"])))
                       != e["depth_sha256"]]}
    print(f"run_tum (l): {n} depth files in {len(meta['forms'])} forms "
          f"({', '.join(meta['forms'])}) beside {len(colour)} colour TIFF "
          f"({', '.join(meta['colour_forms'])}) and {n - len(colour)} JPEG colour: equal to "
          f"their Pillow digests through image.read_depth {n - len(wrong['depth'])} of {n} and "
          f"image.read_colour {n - len(wrong['colour'])} of {n}; bilevel and 4-bit "
          f"{len(other) - len(wrong['other'])} of {len(other)} "
          f"({', '.join(e['form'] for e in other)}); differing {wrong}")
    if any(wrong.values()):
        raise RuntimeError(f"run_tum (l): decoded frames differ from Pillow's: {wrong}")

    # (ii) host decode ms per form, each depth file in turns with its JPEG
    extra = [(colour[i]["form"], image.decode_colour, data) for i, data in colour_files.items()]
    extra += [(e["form"], image.decode_depth, data) for e, data in zip(other, other_files)]
    ms = {label: [] for label in meta["forms"] + ["baseline_jpeg"] + [x[0] for x in extra]}
    for _ in range(KLG_DECODE_REPEATS):
        for i, (e, data) in enumerate(zip(depth, depth_files)):
            for label, fn, payload in ((e["form"], image.decode_depth, data),
                                       ("baseline_jpeg", jpeg.decode, jpegs[i])):
                t0 = time.perf_counter()
                fn(payload)
                ms[label].append(1e3 * (time.perf_counter() - t0))
        for label, fn, payload in extra:
            t0 = time.perf_counter()
            fn(payload)
            ms[label].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: float(np.median(v)) for k, v in ms.items()}
    h, w = depth[0]["height"], depth[0]["width"]
    print(f"run_tum (l): host time on the card's machine ({smi}; {os.cpu_count()} CPUs): "
          f"decode of one {w}x{h} frame, median (of {KLG_DECODE_REPEATS} x its files, each "
          f"depth file in turns with its baseline JPEG colour): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in decode_ms.items())
          + "; bytes per form " + json.dumps({e["form"]: e["bytes"] for e in meta["frames"]}))

    # (iii) run_tum.main on the sequence in this process
    run = _main_in_process("l", "TIFF-codecs", root, n, tmp / "out_l")
    return dict(frames=n, forms=meta["forms"], colour_forms=meta["colour_forms"],
                digests_equal=True, decode_ms=decode_ms, decode_ms_all=ms,
                bytes={e["form"]: e["bytes"] for e in meta["frames"]}, device=smi, **run)


def phase_run_tum(dev, cmd=None, smi="") -> dict:
    """The real-data entry point on a TUM-format fixture written here:
    (a) the command line, (b) replay, (c) .klg through the native loader
    (raw colour, and JPEG colour into FullSLAM), (d) checkpoint / resume,
    (e) splat prediction, (f) reconstruction accuracy, (g) a TUM-layout
    sequence with progressive JPEG colour and Adam7 depth, (h) one with
    colour in the JPEG forms beyond Huffman DCT (CMYK, YCCK, 4x1, lossless,
    arithmetic, unrefined progressive), (i) one with depth in PGM and TIFF
    and JPEG and PNG colour, (j) one with colour in netpbm, BMP and TIFF and
    PNG and tiled TIFF depth, (k) one with colour in BigTIFF, JPEG-in-TIFF
    and YCbCr TIFF and PNG and BigTIFF depth, (l) one with depth in ZSTD
    and LZMA TIFF and colour in ZSTD and LZMA TIFF and JPEG.  ``cmd``: how
    (a) and (g) start the entry point; ``smi``: the card's name and power
    limit."""
    t_phase = time.perf_counter()
    cmd = cmd or [sys.executable, "-m", "hrbffusion3d_tpu_torch.run_tum"]
    with tempfile.TemporaryDirectory(prefix="run_tum_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        gt, ts, depths, rgbs = _tum_fixture(tmp / "seq", dev, first=TUM_SEQ_FRAMES)
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
        out["klg_jpeg"] = _klg_jpeg(tmp, dev, depths, rgbs, gt, ts, smi)
        out["checkpoint"] = _checkpoint(dev, depths, rgbs, gt, tmp)
        out["splat"] = _splat(dev)
        out["eval"] = _eval(ply_map, to_world, dev)
        t0 = time.perf_counter()
        out["tum_jpeg"] = _tum_jpeg(tmp, dev, depths, gt, ts, out["cli"], out["klg_jpeg"], cmd,
                                    smi)
        out["tum_jpeg"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (g): {out['tum_jpeg']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tum_forms"] = _tum_forms(tmp, depths, gt, ts, smi)
        out["tum_forms"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (h): {out['tum_forms']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tum_depth_forms"] = _tum_depth_forms(tmp, gt, ts, smi)
        out["tum_depth_forms"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (i): {out['tum_depth_forms']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tum_colour_forms"] = _tum_colour_forms(tmp, gt, ts, smi)
        out["tum_colour_forms"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (j): {out['tum_colour_forms']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tum_tiff_forms"] = _tum_tiff_forms(tmp, gt, ts, smi)
        out["tum_tiff_forms"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (k): {out['tum_tiff_forms']['seconds']:.1f} s")
        t0 = time.perf_counter()
        out["tum_tiff_codecs"] = _tum_tiff_codecs(tmp, gt, ts, smi)
        out["tum_tiff_codecs"]["seconds"] = time.perf_counter() - t0
        print(f"run_tum (l): {out['tum_tiff_codecs']['seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"run_tum: phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase_tracking_modes: every tracking and normal setting of SLAMConfig on
# the dense step's cell (bench.py's config, the orbit at 640x480)
# ---------------------------------------------------------------------- #
# bootstrap + MODE_STEPS steps per mode (7 until the script outgrew half its
# time limit: every track is repeated on the CPU, most of the phase's time)
MODE_STEPS = 3
# the finest level's Gauss-Newton increments at 640x480 on this orbit fall
# to 1e-4-1e-3 while the coarser levels' stay above 1.8e-3 (the port on
# the CPU, three steps), so 1e-3 stops finest-level loops early only
MODE_EPS = 1e-3
MODE_TOPK = dict(tracking_topk=76800, tracking_topk_full_iters=3)
TRACKING_MODES = {
    "corr_search": dict(icp_use_correspondence_search=True, icp_search_radius=2),
    "sparse_icp": dict(icp_use_sparse=True),
    "bilinear_separate": dict(tracking_rgb_nearest=False),
    "bilinear_joint": dict(tracking_rgb_nearest=False, tracking_joint_gather=True),
    "reassoc": dict(tracking_reassoc_period=2),
    "converge_eps": dict(tracking_converge_eps=MODE_EPS),
    "subsample": dict(tracking_subsample=2),
    "topk": MODE_TOPK,
    "patch": dict(tracking_patch_assoc=True),
    "topk_patch": dict(MODE_TOPK, tracking_patch_assoc=True),
    "central_diff_normals": dict(normal_pca=False),
    "icp_only": dict(icp_weight=100.0),
    "rgb_only": dict(icp_weight=0.0),
}
# one-term tracking: ATE printed, not gated
UNGATED_MODES = ("icp_only", "rgb_only")
MODE_R_TOL, MODE_T_TOL = 1e-4, 1e-4     # card vs CPU: rad, m
# track(rgb_only=True) (unit weights, no robustifier) is float32-sensitive
# at 640x480: the port on the CPU alone moves 1.2e-4-2.2e-4 rad and
# 2.0e-4-4.7e-4 m between 1, 2 and 4 threads (three steps into the orbit)
RGB_ONLY_TOL = (1e-3, 1e-3)


@contextlib.contextmanager
def _tracks(sink):
    """Append each ``odometry.track`` call's (args, kwargs, result) to
    ``sink``; nothing is synchronised (the step looks the function up in
    the module when it calls it)."""
    fn = odometry.track

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append((args, kwargs, out))
        return out

    odometry.track = run
    try:
        yield
    finally:
        odometry.track = fn


def _rot_gap(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """Geodesic angle (rad) between two rotations, from their chord in
    float64."""
    chord = float(torch.linalg.norm(Ra.cpu().double() - Rb.cpu().double()))
    return 2.0 * float(np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))


def _track_card_vs_cpu(label, args, cfg, rgb_only=False, tol=(MODE_R_TOL, MODE_T_TOL),
                       one_thread=True) -> dict:
    """One ``track`` on the card and on the CPU from the same inputs (a
    step's own), and (``one_thread``) on the CPU again on one thread
    (another float32 summation order: the CPU's own spread, printed
    beside); fails when the card is more than ``tol`` (rad, m) from the
    CPU."""
    prev_R, prev_t, inp, intr = args[:4]
    card = odometry.track(prev_R, prev_t, inp, intr, cfg, rgb_only=rgb_only)
    cpu_inp = odometry.TrackingInputs(*(tuple(x.cpu() for x in f) for f in inp))
    t0 = time.perf_counter()
    cpu = odometry.track(prev_R.cpu(), prev_t.cpu(), cpu_inp, intr, cfg, rgb_only=rgb_only)
    cpu_s = time.perf_counter() - t0
    d_r = _rot_gap(card.R, cpu.R)
    d_t = float((card.t.cpu() - cpu.t).abs().max())
    if not (d_r <= tol[0] and d_t <= tol[1]):
        raise RuntimeError(f"{label}: track card vs CPU {d_r} rad, {d_t} m")
    out = dict(card_vs_cpu_rad=d_r, card_vs_cpu_m=d_t, cpu_track_s=cpu_s,
               moved_m=float(torch.linalg.norm(cpu.t - prev_t.cpu())))
    if one_thread:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu1 = odometry.track(prev_R.cpu(), prev_t.cpu(), cpu_inp, intr, cfg,
                                  rgb_only=rgb_only)
        finally:
            torch.set_num_threads(threads)
        out.update(cpu_threads=threads, cpu_1_thread_rad=_rot_gap(cpu1.R, cpu.R),
                   cpu_1_thread_m=float((cpu1.t - cpu.t).abs().max()))
    return out


def _mode_run(name, cfg, poses, frames) -> tuple[dict, list, list]:
    """bootstrap + MODE_STEPS steps under ``cfg``: every step counted in
    sync-debug mode and timed, the kernels' launches counted over the run,
    the trajectory gated (but for the one-term modes), and every step's
    track repeated on the CPU (the default mode's last also on one CPU
    thread).  Returns (results, the tracks' calls, the states from the
    bootstrap on)."""
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    calls, step_ms, syncs = [], [], 0
    with _tracks(calls):
        state = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
        states = [state]
        est = [lie.rt_to_mat(state.R, state.t)]
        for f in frames[1:MODE_STEPS + 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, s = _count_syncs(lambda: slam.step(state, f, TUM1, cfg))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            syncs += s
            states.append(state)
            est.append(lie.rt_to_mat(state.R, state.t))
    launches = dict(kernels.LAUNCHES)
    label = f"tracking mode {name}"
    if name in UNGATED_MODES:
        est_np = torch.stack(est).cpu().numpy()
        if not np.isfinite(est_np).all():
            raise RuntimeError(f"{label}: non-finite poses")
        ate = ate_rmse(est_np, poses[:len(est)], align=False)
        dense, icp = float(state.dense_frac), float(state.last_icp_count)
    else:
        ate, dense, icp = _check_run(label, state, est, poses)
    frames_run = MODE_STEPS + 1
    want = dict.fromkeys(launches, frames_run)
    if not cfg.normal_pca:
        want["normal_pca"] = 0
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want}")
    if syncs:
        raise RuntimeError(f"{label}: {syncs} host syncs over {MODE_STEPS} steps")
    live = torch.stack([c[2].live_iters for c in calls]).cpu().numpy()
    out = dict(ate_mm=ate * 1e3, dense_frac=dense, last_icp_count=icp, host_syncs=syncs,
               launches=launches, step_ms=step_ms,
               median_step_ms=float(np.median(step_ms[1:])),
               live_iters=live.tolist(), budget=list(cfg.pyramid_iterations))
    every = [_track_card_vs_cpu(f"{label} track {i + 1}", c[0], cfg,
                                one_thread=name == "default" and i == len(calls) - 1)
             for i, c in enumerate(calls)]
    out.update(every[-1])
    out["tracks_card_vs_cpu_rad"] = [g["card_vs_cpu_rad"] for g in every]
    out["tracks_card_vs_cpu_m"] = [g["card_vs_cpu_m"] for g in every]
    out["largest_card_vs_cpu"] = [max(out["tracks_card_vs_cpu_rad"]),
                                  max(out["tracks_card_vs_cpu_m"])]
    print(f"{label}: ATE {out['ate_mm']:.3f} mm{' (not gated)' if name in UNGATED_MODES else ''}, "
          f"dense_frac {dense:.4f}, last_icp_count {icp:.0f}, median step "
          f"{out['median_step_ms']:.2f} ms (steps 2-{MODE_STEPS}), host syncs {syncs}, "
          f"launches {json.dumps(launches)}; every track ({len(every)}) card vs CPU: largest "
          f"{out['largest_card_vs_cpu'][0]:.3g} rad, {out['largest_card_vs_cpu'][1]:.3g} m "
          f"(last CPU track {out['cpu_track_s']:.1f} s"
          + (f"; the CPU on 1 vs {out['cpu_threads']} threads {out['cpu_1_thread_rad']:.3g} rad, "
             f"{out['cpu_1_thread_m']:.3g} m)" if "cpu_threads" in out else ")"))
    return out, calls, states


def phase_tracking_modes(poses, frames, smi) -> tuple[dict, dict]:
    """The dense step under each tracking and normal setting (13 modes) and
    the default beside them, each bootstrap + MODE_STEPS steps on the
    card in one call, every track held to the CPU's; then one
    ``track(rgb_only=True)`` from the default run's last inputs, card
    against CPU.  Returns (results, per mode: its config, its states and
    step ms, for phase_sharded_step (f))."""
    t_phase = time.perf_counter()
    out, runs = {}, {}
    default, calls, states = _mode_run("default", BENCH_CFG, poses, frames)
    out["default"] = default
    runs["default"] = (BENCH_CFG, states, default["step_ms"])
    r = out["rgb_only_track"] = _track_card_vs_cpu(
        "track(rgb_only=True)", calls[-1][0], BENCH_CFG, rgb_only=True, tol=RGB_ONLY_TOL)
    print(f"tracking modes: track(rgb_only=True) from the default run's last inputs: moved "
          f"{r['moved_m'] * 1e3:.3f} mm, card vs CPU {r['card_vs_cpu_rad']:.3g} rad, "
          f"{r['card_vs_cpu_m']:.3g} m (the CPU on 1 vs {r['cpu_threads']} threads "
          f"{r['cpu_1_thread_rad']:.3g} rad, {r['cpu_1_thread_m']:.3g} m)")
    for name, fields in TRACKING_MODES.items():
        cfg = dataclasses.replace(BENCH_CFG, **fields)
        out[name], _, states = _mode_run(name, cfg, poses, frames)
        runs[name] = (cfg, states, out[name]["step_ms"])
    live = np.array(out["converge_eps"]["live_iters"])
    print(f"tracking modes: converge_eps {MODE_EPS}: live iterations per step and level "
          f"(finest first) {live.tolist()} of {out['converge_eps']['budget']}")
    if not (live[:, 0] < BENCH_CFG.pyramid_iterations[0]).any():
        raise RuntimeError(f"converge_eps {MODE_EPS} never stopped the finest level early")
    print(f"tracking modes: median step ms (steps 2-{MODE_STEPS}, sync-debug mode on, {smi}): "
          + ", ".join(f"{k} {v['median_step_ms']:.2f}" for k, v in out.items()
                      if "median_step_ms" in v))
    print("tracking modes: largest card vs CPU gap over every track (rad, m): "
          + ", ".join(f"{k} {v['largest_card_vs_cpu'][0]:.3g} / {v['largest_card_vs_cpu'][1]:.3g}"
                      for k, v in out.items() if "largest_card_vs_cpu" in v))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tracking modes: phase {out['seconds']:.1f} s")
    return out, runs


# phase_distributed: the landmark-sharded local BA (parallel/dist_ba) on
# meshes of DIST_SHARDS shards of the one card; card against the port's CPU
# run of the same mesh and n shards against 1 within DIST_TOL (poses: norm
# of se3_log of the difference; landmarks: metres) and DIST_CHI2_RTOL
# (tests/test_torch_ba.py's solver bounds); the multi-process solves of
# the unpadded problem equal to the in-process 8-shard one bit for bit
# (Mesh.psum adds every shard's system in the global shard order over a
# group too; tests/test_multihost_2proc.py bounds the JAX pair by 2e-5);
# FullSLAM(mesh=make_mesh(4)) on
# phase_full_system (b)'s protocol cut to DIST_FRAMES frames (3 keyframes;
# 41 frames, 5 keyframes, until the script outgrew half its time limit),
# its keyframe poses within DIST_TOL of mesh=None's
DIST_SHARDS = (1, 4, 8)
DIST_TOL, DIST_CHI2_RTOL = 1e-4, 1e-4
DIST_FRAMES, DIST_FULL_SHARDS = 21, 4
# (b): (backend, processes, shards per process); NCCL refuses two ranks on
# one card, so the gloo ranks share it and the nccl group has one rank
DIST_PROCESS_RUNS = (("gloo", 2, 4), ("nccl", 1, 8))
DIST_TIMEOUT_S = 180.0


def _dist_rank(addr, n_processes, rank, backend, local_shards, device, problem_path, out_path):
    """One process of phase_distributed (b): the sharded solve of the
    problem saved at ``problem_path`` on ``local_shards`` shards of
    ``device`` (None: the card) per process; process 0 writes the cameras,
    the landmarks of every shard and chi2 to ``out_path`` (.npz)."""
    multihost.initialize(addr, n_processes, rank, backend=backend)
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device=device)
        prob = ba.BAProblem(*torch.load(problem_path))
        sb = multihost.globalize_sharded_ba(dist_ba.partition_problem(prob, mesh.size), mesh)
        cams, points, chi = dist_ba.make_optimizer(mesh)(sb)
        pts = dist_ba.gather_points(points, prob.points.shape[0], mesh)
        if multihost.is_coordinator():
            np.savez(out_path, cams=cams.cpu().numpy(), points=pts, chi=chi.cpu().numpy(),
                     device=str(mesh.devices[0]))
    finally:
        torch.distributed.destroy_process_group()


def _dist_gaps(a, b, n_lms: int) -> dict:
    """Gaps of sharded solve a = (cams, points, chi2) from b: the largest
    pose gap, the largest landmark gap (m) and chi2's relative gap."""
    pa, pb = dist_ba.gather_points(a[1], n_lms), dist_ba.gather_points(b[1], n_lms)
    return dict(pose=_pose_gap(a[0], b[0]), points=float(np.abs(pa - pb).max()),
                chi2_rel=abs(float(a[2]) - float(b[2])) / abs(float(b[2])))


def _dist_check(label, gaps, pose_tol, chi2_rtol):
    if not (gaps["pose"] < pose_tol and gaps["points"] < pose_tol
            and gaps["chi2_rel"] < chi2_rtol):
        raise RuntimeError(f"distributed {label}: {gaps} (limits {pose_tol}, chi2 {chi2_rtol})")


def _dist_solver(prob, dev) -> dict:
    """(a) The padded problem on make_mesh(n) of the card for each n of
    DIST_SHARDS: host syncs of the solve, a repeat bit for bit, ms per
    call, the port's CPU run of the same mesh and the 1-shard run as
    references; ba.optimize on the same problem beside it."""
    n_lms = int(prob.points.shape[0])
    rows, card = {}, {}
    for n in DIST_SHARDS:
        mesh = sharding.make_mesh(n, devices=[dev])
        run = dist_ba.make_optimizer(mesh)
        sb = multihost.globalize_sharded_ba(dist_ba.partition_problem(prob, n), mesh)
        torch.cuda.synchronize()
        out, syncs = _count_syncs(lambda: run(sb))
        again, syncs_again = _count_syncs(lambda: run(sb))
        torch.cuda.synchronize()
        same = (torch.equal(out[0], again[0]) and float(out[2]) == float(again[2])
                and all(torch.equal(x, y) for x, y in zip(out[1], again[1])))
        ms = _median_ms(lambda: run(sb), n=5)
        cpu_mesh = sharding.make_mesh(n, devices=["cpu"])
        cpu = dist_ba.make_optimizer(cpu_mesh)(
            multihost.globalize_sharded_ba(dist_ba.partition_problem(prob, n), cpu_mesh))
        card[n] = out
        row = rows[n] = dict(ms=ms, host_syncs=[syncs, syncs_again], bitwise_repeat=same,
                             chi2=float(out[2]), vs_cpu=_dist_gaps(out, cpu, n_lms),
                             edges_per_shard=[int(s.obs.shape[0]) for s in sb.shards],
                             valid_edges_per_shard=[int((s.edge_valid > 0).sum())
                                                    for s in sb.shards])
        if n != DIST_SHARDS[0]:
            row["vs_1_shard"] = _dist_gaps(out, card[DIST_SHARDS[0]], n_lms)
        print(f"distributed (a): make_mesh({n}) on {dev}: {ms:.1f} ms per solve, host syncs "
              f"{syncs} and {syncs_again}, repeat bit for bit {same}; card vs CPU {row['vs_cpu']}"
              + (f"; vs 1 shard {row['vs_1_shard']}" if "vs_1_shard" in row else ""))
        if syncs or syncs_again:
            raise RuntimeError(f"distributed (a): the {n}-shard solve made host syncs")
        if not same:
            raise RuntimeError(f"distributed (a): the {n}-shard solve did not repeat bit for bit")
        _dist_check(f"(a) {n} shards, card vs CPU", row["vs_cpu"], DIST_TOL, DIST_CHI2_RTOL)
        if "vs_1_shard" in row:
            _dist_check(f"(a) {n} shards vs 1", row["vs_1_shard"], DIST_TOL, DIST_CHI2_RTOL)
    on_card = _to(prob, dev)
    plans = ba.build_plans(prob, "dense", device=dev)
    single = ba.optimize(on_card, solver="dense", plans=plans)
    ms = _median_ms(lambda: ba.optimize(on_card, solver="dense", plans=plans), n=5)
    gap = _pose_gap(single[0].cams, card[DIST_SHARDS[0]][0])
    print(f"distributed (a): ba.optimize on the same problem: {ms:.1f} ms per solve, poses "
          f"{gap:.3g} from the 1-shard solve")
    return dict(shards=rows, ba_optimize_ms=ms, ba_optimize_pose_gap=gap)


def _dist_processes(problem, dev, device=None) -> dict:
    """(b) phase_backend's last local-BA problem, unpadded, in separate
    processes: 2 ``gloo`` ranks with 4 shards each, every rank's tensors
    on the card, and 1 ``nccl`` rank with 8 shards; each against the
    in-process 8-shard solve of the same problem on the card, bit for bit.
    Unpadded, its landmarks fill all 8 shards, so each gloo rank holds
    several non-empty shards, whose systems a per-process sum would group
    otherwise than the in-process order (the padded problem of (a) leaves
    rank 1 one shard with edges)."""
    n_lms = int(problem.points.shape[0])
    mesh = sharding.make_mesh(8, devices=[dev])
    sb = dist_ba.partition_problem(problem, mesh.size)
    ref = dist_ba.make_optimizer(mesh)(multihost.globalize_sharded_ba(sb, mesh))
    ref_pts = dist_ba.gather_points(ref[1], n_lms)
    valid = [int((s.edge_valid > 0).sum()) for s in sb.shards]
    out = dict(valid_edges_per_shard=valid)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "problem.pt")
        torch.save(tuple(problem), path)
        for backend, n_proc, local in DIST_PROCESS_RUNS:
            held = [sum(v > 0 for v in valid[r * local:(r + 1) * local]) for r in range(n_proc)]
            if n_proc > 1 and min(held) < 2:
                raise RuntimeError(f"distributed (b): the {backend} ranks hold {held} shards "
                                   f"with edges ({valid}): the sum's grouping goes untested")
            dest = Path(tmp) / f"{backend}.npz"
            t0 = time.perf_counter()
            multihost.launch_local(_dist_rank, n_proc,
                                   args=(backend, local, device, path, str(dest)),
                                   timeout_s=DIST_TIMEOUT_S)
            got = np.load(dest)
            row = out[backend] = dict(
                processes=n_proc, shards_each=local, device=str(got["device"]),
                nonempty_shards_per_rank=held, seconds=time.perf_counter() - t0,
                cams=float(np.abs(got["cams"] - ref[0].cpu().numpy()).max()),
                points=float(np.abs(got["points"][:n_lms] - ref_pts).max()),
                chi2_rel=abs(float(got["chi"]) - float(ref[2])) / abs(float(ref[2])))
            print(f"distributed (b): {n_proc} {backend} process(es) x {local} shards on "
                  f"{row['device']} ({row['seconds']:.1f} s with start-up; shards with edges "
                  f"per rank {held}, valid edges per shard {valid}): cameras "
                  f"{row['cams']:.3g}, landmarks {row['points']:.3g} m, chi2 relative "
                  f"{row['chi2_rel']:.3g} from the in-process 8-shard solve (exact required)")
            if not (row["cams"] == 0 and row["points"] == 0 and row["chi2_rel"] == 0):
                raise RuntimeError(f"distributed (b): {backend} run {row} differs from the "
                                   "in-process solve")
    return out


@contextlib.contextmanager
def _per_frame(sink, syncs, mesh=None):
    """Record, for every slam.bootstrap and slam.step call, the host syncs
    (of the main thread) and the kernels' launches it made; with ``mesh``
    also the host reads its collectives made (``Mesh.host_reads``)."""
    fns = {name: getattr(slam, name) for name in ("bootstrap", "step")}

    def recorder(fn):
        def run(*args, **kwargs):
            before, s0 = dict(kernels.LAUNCHES), syncs[0]
            r0 = mesh.host_reads if mesh is not None else 0
            out = fn(*args, **kwargs)
            rec = (syncs[0] - s0, {k: v - before[k] for k, v in kernels.LAUNCHES.items()})
            sink.append(rec if mesh is None else rec + (mesh.host_reads - r0,))
            return out
        return run

    for name, fn in fns.items():
        setattr(slam, name, recorder(fn))
    try:
        yield
    finally:
        for name, fn in fns.items():
            setattr(slam, name, fn)


def _dist_frames(dev, n=DIST_FRAMES):
    """phase_full_system (b)'s protocol cut to ``n`` frames: (the poses, the
    Kinect-noisy frames stacked on ``dev``)."""
    scene = synth.complex_room(dev)
    gt = synth.panorama_trajectory(n, n_turns=1.8 * (n - 1) / 360.0)
    ds, cs = zip(*(_kinect_frame(scene, gt[i], i, dev) for i in range(n)))
    return gt, slam.FrameInput(torch.stack(ds), torch.stack(cs))


def _dist_full_system(dev, mesh) -> tuple[dict, dict]:
    """(c) FullSLAM with ``mesh`` on phase_full_system (b)'s protocol cut
    to DIST_FRAMES frames, sync through one process_batch, then the same
    frames with mesh=None.  Returns (the results, the mesh run's record
    for phase_group_full_system (h)(i): ``_gfs_record``)."""
    n = DIST_FRAMES
    gt, batch = _dist_frames(dev, n)
    solves, problems, frames = [], [], []
    make_optimizer = dist_ba.make_optimizer

    def counted(m, **kw):
        run = make_optimizer(m, **kw)
        return lambda sb: solves.append(len(sb.shards)) or run(sb)

    sys_ = full_slam.FullSLAM(TUM1, FULL_CFG, init_pose=gt[0], mesh=mesh, device=dev)
    local_problem = sys_.backend.local_problem

    def recorded():
        built = local_problem()
        problems.append(built is not None)
        return built

    sys_.backend.local_problem = recorded
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    dist_ba.make_optimizer = counted
    try:
        with _sync_counts() as syncs, _per_frame(frames, syncs):
            t0 = time.perf_counter()
            sys_.process_batch(batch, timestamps=[float(i) for i in range(n)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        dist_ba.make_optimizer = make_optimizer
    launches = dict(kernels.LAUNCHES)
    _driven("distributed (c)", launches)
    record = _gfs_record(sys_, mesh, GFS_PROCESSES)
    record.update(frames_digest=multihost.digest([batch.depth, batch.rgb]), fps=(n - 1) / secs)
    data = sys_.state.map.data
    map_shards = (sum(p.shape[0] > 0 for p in data.parts)
                  if isinstance(data, sharding.ShardedRows) else 1)
    if map_shards != mesh.size:
        raise RuntimeError(f"distributed (c): the map's rows lie on {map_shards} shards, the "
                           f"mesh has {mesh.size}")
    est = sys_.poses()
    ate = ate_rmse(est, gt[:len(est)], align=False)

    plain = full_slam.FullSLAM(TUM1, FULL_CFG, init_pose=gt[0], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.process_batch(batch, timestamps=[float(i) for i in range(n)])
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    kf_a = np.stack([kf.pose for kf in sys_.backend.keyframes]).astype(np.float32)
    kf_b = np.stack([kf.pose for kf in plain.backend.keyframes]).astype(np.float32)
    k = min(len(kf_a), len(kf_b))
    gaps = _pose_gaps(torch.from_numpy(kf_a[:k]), torch.from_numpy(kf_b[:k]))
    t_gaps = np.linalg.norm(kf_a[:k, :3, 3] - kf_b[:k, :3, 3], axis=1)
    frame_syncs = [s for s, _ in frames]
    idle = [i for i, (_, per) in enumerate(frames) if min(per.values()) == 0]
    out = dict(frames=n, shards=mesh.size, map_row_shards=map_shards, seconds=secs,
               fps=(n - 1) / secs,
               ate_mm=ate * 1e3, keyframes=len(kf_a), local_ba_problems=sum(problems),
               sharded_solves=len(solves), host_syncs_per_frame=frame_syncs,
               launches=launches, plain=dict(seconds=plain_secs, fps=(n - 1) / plain_secs,
                                             ate_mm=ate_rmse(plain.poses(), gt[:n],
                                                             align=False) * 1e3,
                                             keyframes=len(kf_b)),
               keyframe_pose_gap=float(gaps.max()), keyframe_gap_mm=float(t_gaps.max() * 1e3),
               keyframe_gaps_mm=(t_gaps * 1e3).tolist())
    print(f"distributed (c): FullSLAM(mesh=make_mesh({mesh.size})) on {n} Kinect-noisy "
          f"{TUM1.width}x{TUM1.height} frames of bench.py's protocol, sync process_batch: "
          f"{out['fps']:.2f} fps "
          f"(mesh=None {out['plain']['fps']:.2f}); map rows on {map_shards} shards; ATE {ate * 1e3:.2f} mm (mesh=None "
          f"{out['plain']['ate_mm']:.2f}); keyframes {len(kf_a)} ({len(kf_b)}); local BA "
          f"problems {sum(problems)}, sharded solves {solves}; host syncs per dense step "
          f"{sorted(set(frame_syncs))}; launches {json.dumps(launches)}; keyframe poses vs "
          f"mesh=None: largest gap {out['keyframe_pose_gap']:.3g} (se3_log), "
          f"{out['keyframe_gap_mm']:.4f} mm (per keyframe "
          + ", ".join(f"{x:.4f}" for x in out["keyframe_gaps_mm"]) + ")")
    if not (sum(problems) >= 1 and solves == [mesh.size] * sum(problems)):
        raise RuntimeError(f"distributed (c): {sum(problems)} local BA problems, sharded "
                           f"solves {solves}")
    if not (np.isfinite(est).all() and ate < FULL_ATE_MAX):
        raise RuntimeError(f"distributed (c): ATE {ate} (limit {FULL_ATE_MAX})")
    if not out["keyframe_pose_gap"] <= DIST_TOL:
        raise RuntimeError(f"distributed (c): keyframe poses {out['keyframe_pose_gap']} from "
                           f"mesh=None (limit {DIST_TOL})")
    if any(frame_syncs):
        raise RuntimeError(f"distributed (c): host syncs in dense steps {frame_syncs}")
    if len(frames) != n or idle:
        raise RuntimeError(f"distributed (c): {len(frames)} dense steps for {n} frames; a kernel "
                           f"was not launched on frames {idle}")
    return out, record


def phase_distributed(problem, dev, smi) -> tuple[dict, dict]:
    """The landmark-sharded local BA: (a) phase_backend's last local-BA
    problem, padded as the mesh path pads it, on 1-, 4- and 8-shard meshes
    of the card; (b) the same problem unpadded in 2 gloo processes and 1
    nccl process; (c) FullSLAM(mesh=) end to end.  Returns (the results,
    (c)'s record for phase_group_full_system)."""
    t_phase = time.perf_counter()
    prob = ba.pad_problem(problem)
    print(f"distributed: problem of {problem.obs.shape[0]} edges, {problem.points.shape[0]} "
          f"landmarks, {problem.cams.shape[0]} cameras (padded "
          f"{prob.obs.shape[0]} / {prob.points.shape[0]} / {prob.cams.shape[0]}); {smi}")
    solver = _dist_solver(prob, dev)
    processes = _dist_processes(problem, dev)
    full_system, record = _dist_full_system(dev, sharding.make_mesh(DIST_FULL_SHARDS,
                                                                    devices=[dev]))
    out = dict(problem=_ba_sizes(prob), solver=solver, processes=processes,
               full_system=full_system)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"distributed: phase {out['seconds']:.1f} s")
    return out, record


# phase_sharded_step: the row-sharded dense step (parallel/sharded_step) on
# make_mesh(n) of the one card for n in SHARD_MESHES, on the dense-step
# cell's frames under the bench config: (a) replayed at the main path's
# tracked poses, equal to the unsharded step bit for bit after every step;
# (b) tracked (tracking_converge_eps 0, the bench config's), beside a
# free-running unsharded run: each frame's pose within SHARD_POSE_TOL
# (largest |R - R'|, |t - t'|: tests/test_aa_sharded_step.py's bound) and
# the same map count; each sharded step also held to the unsharded step
# from the same state (the sharded run's previous state, gathered), by the
# same rule, and the unsharded step replayed at the sharded step's tracked
# pose equal to it bit for bit (all but the tracking is exact); ATE under
# 2.5 cm (the Gram sums are float64 in both steps, rounded once; in
# float32 their order moved the pose by up to 1.1e-3 on 8 shards and the
# count by a surfel now and then, PERF.md); (c) each kernel's slab launch
# held to its plain version on the slab (the main path's rules) and to its
# whole-image launch on the rows the shard keeps (bit for bit); (d) 0 host
# syncs in a sharded step (CUDA sync-debug mode); (e) is
# phase_distributed (c): FullSLAM with a 4-shard mesh, whose dense state
# is sharded
SHARD_MESHES = (4, 8)
# (a), (b) and (g) run the dense-step cell's first SHARD_FRAMES frames (all
# N_FRAMES until the script outgrew half its time limit)
SHARD_FRAMES = 8
SHARD_POSE_TOL = 1e-4
SHARD_ATE_MAX = 0.025
SHARD_SLAB_MESH, SHARD_SLAB_SHARD = 4, 1


def _state_diff(ref: slam.SLAMState, got: slam.SLAMState, skip=()) -> list:
    """The fields of two states that are not equal bit for bit (the map's
    rows and count apart); ``dense_frac`` (a float mean) and ``skip`` are
    left out."""
    got = sharding.gather_state(got)
    bad = []
    if not torch.equal(ref.map.count, got.map.count):
        bad.append("map.count")
    if not torch.equal(ref.map.data, got.map.data):
        bad.append("map.data")
    for name in slam.SLAMState._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if name in ("map", "dense_frac") or name in skip:
            continue
        if isinstance(a, torch.Tensor) and not torch.equal(a, b) or (
                not isinstance(a, torch.Tensor) and a != b):
            bad.append(name)
    return bad


def _shard_bytes(state: slam.SLAMState) -> list:
    """Bytes of each shard's blocks of the state (map rows and image rows)."""
    out = [0] * len(state.map.data.parts)
    for x in [state.map.data] + [getattr(state, f) for f in slam.SLAMState._fields]:
        if isinstance(x, sharding.ShardedRows):
            for k, p in enumerate(x.parts):
                out[k] += p.numel() * p.element_size()
    return out


def _gap(a: slam.SLAMState, b: slam.SLAMState) -> float:
    return max((a.R - b.R).abs().max().item(), (a.t - b.t).abs().max().item())


def _lockstep(label, mesh, frames, poses, fixed):
    """bootstrap + the frames' steps, unsharded and on ``mesh`` one after
    the other per frame (``fixed``: each step's pose, replay; None:
    tracked, each sharded step also held to the unsharded step from its
    own previous state); each step synchronised and timed; the kernels'
    launches counted in the sharded steps alone; the host syncs of the
    last sharded step counted.  Returns (results, the sharded run's
    ``_run_record``)."""
    cfg = BENCH_CFG
    ref = slam.bootstrap(frames[0], TUM1, cfg, init_pose=poses[0])
    got = sharding.shard_state(ref, mesh, cfg)
    ms_ref, ms_got, diffs, gaps, counts = [], [], [], [], []
    anchored_gaps, anchored_counts, replayed = [], [], []
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    est = [lie.rt_to_mat(got.R, got.t)]
    syncs = None
    record = []
    for i in range(1, len(frames)):
        pose = None if fixed is None else fixed[i]
        prev = sharding.gather_state(got) if fixed is None else None
        anchor = slam.step(prev, frames[i], TUM1, cfg) if fixed is None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = slam.step(ref, frames[i], TUM1, cfg, fixed_pose=pose)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        if i == len(frames) - 1:
            got, syncs = _count_syncs(lambda: slam.step(got, frames[i], TUM1, cfg,
                                                        fixed_pose=pose))
        else:
            got = slam.step(got, frames[i], TUM1, cfg, fixed_pose=pose)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v - before[k]
        ms_ref.append(1e3 * (t1 - t0))
        ms_got.append(1e3 * (t2 - t1))
        record.append((got.R, got.t, got.map.count))
        est.append(lie.rt_to_mat(got.R, got.t))
        if fixed is not None:
            diffs.append(_state_diff(ref, got))
        gaps.append(_gap(ref, got))
        counts.append((int(ref.map.count), int(got.map.count)))
        if anchor is not None:
            anchored_gaps.append(_gap(anchor, got))
            anchored_counts.append((int(anchor.map.count), int(got.map.count)))
            at_pose = slam.step(prev, frames[i], TUM1, cfg,
                                fixed_pose=lie.rt_to_mat(got.R, got.t))
            replayed.append(_state_diff(at_pose, got, skip=("last_icp_error", "last_icp_count")))
            del prev, anchor, at_pose
    n_steps = len(frames) - 1
    out = dict(shards=mesh.size, steps=n_steps, syncs_last_step=syncs, launches=launches,
               launches_per_shard_step={k: v / (n_steps * mesh.size) for k, v in launches.items()},
               median_step_ms=float(np.median(ms_got[3:])),
               median_unsharded_ms=float(np.median(ms_ref[3:])),
               step_ms=ms_got, unsharded_ms=ms_ref, pose_gaps=gaps,
               counts_equal=all(a == b for a, b in counts), final_count=counts[-1],
               bytes_per_shard=_shard_bytes(got),
               map_rows_per_shard=[p.shape[0] for p in got.map.data.parts],
               image_rows_per_shard=[b - a for a, b in got.pred_vertex.bounds])
    est_np = torch.stack(est).cpu().numpy()
    out["ate_mm"] = ate_rmse(est_np, poses[:len(est)], align=False) * 1e3
    if fixed is not None:
        out["steps_bit_for_bit"] = sum(not d for d in diffs)
        out["differing_fields"] = [d for d in diffs if d]
    else:
        out["anchored_pose_gaps"] = anchored_gaps
        out["anchored_counts_equal"] = sum(a == b for a, b in anchored_counts)
        out["anchored_count_gaps"] = [b - a for a, b in anchored_counts]
        out["replayed_at_pose_bit_for_bit"] = sum(not d for d in replayed)
        out["replayed_differing_fields"] = [d for d in replayed if d]
    print(f"sharded step {label} on make_mesh({mesh.size}): median {out['median_step_ms']:.2f} "
          f"ms per step (unsharded {out['median_unsharded_ms']:.2f} ms) over steps 4-{n_steps}; "
          + (f"bit for bit after {out['steps_bit_for_bit']} of {n_steps} steps; "
             if fixed is not None else
             f"each step vs the unsharded step from its state: largest pose gap "
             f"{max(anchored_gaps):.3g}, counts equal in {out['anchored_counts_equal']} of "
             f"{n_steps} (gaps {out['anchored_count_gaps']}), the unsharded step at the "
             f"sharded step's pose bit for bit in {out['replayed_at_pose_bit_for_bit']} of "
             f"{n_steps}; free-running: ")
          + f"largest pose gap {max(gaps):.3g}; counts equal {out['counts_equal']} (final "
          f"{counts[-1]}); ATE {out['ate_mm']:.3f} mm; host syncs in the last step {syncs}; "
          f"launches {json.dumps(launches)}; bytes per shard {out['bytes_per_shard']} "
          f"(map rows {out['map_rows_per_shard']}, image rows {out['image_rows_per_shard']})")
    for k, v in launches.items():
        if v != n_steps * mesh.size:
            raise RuntimeError(f"sharded step {label}, {mesh.size} shards: {k} launched {v} "
                               f"times, expected {n_steps * mesh.size} (one per shard per step)")
    if syncs != 0:
        raise RuntimeError(f"sharded step {label}: {syncs} host syncs in a step")
    return out, _run_record(record, got)


def _run_record(steps, last: slam.SLAMState) -> dict:
    """A sharded run's record for (g): each step's (R, t, count) and the
    last state whole (numpy)."""
    last = sharding.gather_state(last)
    rec = {k: np.stack([x.cpu().numpy() for x in col])
           for k, col in zip(("R", "t", "count"), zip(*steps))}
    rec["map"] = last.map.data.cpu().numpy()
    for name in GROUP_IMAGES:
        rec[name] = getattr(last, name).cpu().numpy()
    return rec


def _slab_checks(frames, state, mesh) -> dict:
    """(c): each kernel launched on one shard's slab (as the sharded step
    launches it) against its plain version on the slab and against its
    whole-image launch on the shard's rows."""
    cfg = BENCH_CFG
    img = sharding.ShardedRows.split(frames[1].depth, mesh,
                                     sharding.row_unit(cfg.num_pyramid_levels))
    a, b = img.bounds[SHARD_SLAB_SHARD]
    label = f"slab rows {a}-{b} of make_mesh({mesh.size})"
    out = {}

    def same(name, slab_out, whole_out, rows, s0):
        for x, y in zip(slab_out, whole_out):
            if not torch.equal(x[rows[0] - s0:rows[1] - s0], y[rows[0]:rows[1]]):
                raise RuntimeError(f"{name}: the slab launch ({label}) differs from the whole "
                                   "image's on its rows")

    halo = sharded_step.preprocess_halo(cfg)
    depth = frames[1].depth
    slab, s0 = depth[max(a - halo, 0):b + halo].contiguous(), max(a - halo, 0)
    out["bilateral_filter"] = _bilateral_rule(label, slab, cfg)
    f_slab, f_whole = (preprocess.bilateral_filter(x, cfg) for x in (slab, depth))
    same("bilateral_filter", [f_slab], [f_whole], (a - 6, b + 6), s0)
    v_slab = camera.unproject(f_slab, TUM1, row0=s0)
    v_whole = camera.unproject(f_whole, TUM1)
    out["normal_pca"] = _pca_rule(f"normal_pca [{label}]", preprocess.normal_pca(v_slab, cfg),
                                  preprocess.normal_pca_ref(v_slab, cfg))
    same("normal_pca", [preprocess.normal_pca(v_slab, cfg)],
         [preprocess.normal_pca(v_whole, cfg)], (a - 3, b + 3), s0)
    pre_slab = preprocess.vertex_normal_radius(slab, f_slab, TUM1, cfg, row0=s0)
    pre_whole = preprocess.vertex_normal_radius(depth, f_whole, TUM1, cfg)
    out["curvature_gradient"] = _curv_rule(f"curvature_gradient [{label}]", pre_slab, cfg)
    same("curvature_gradient", preprocess.curvature_gradient(pre_slab, TUM1, cfg),
         preprocess.curvature_gradient(pre_whole, TUM1, cfg), (a, b), s0)

    pose_inv = lie.se3_inverse(lie.rt_to_mat(state.R, state.t))
    idx = sm.render_index(state.map, pose_inv, TUM1)
    attr = sm.render_attr_image(state.map, idx, pose_inv)
    attr9 = torch.cat([attr[..., 0:sm.A_RADIUS + 1],
                       attr[..., sm.A_VALID:sm.A_VALID + 1]], dim=-1).contiguous()
    R = cfg.predict_window_multiplier
    s0 = max(a - R, 0)
    slab9 = attr9[s0:b + R].contiguous()
    args = dict(top=a - s0, height=b - a, row0=a)
    got = kernels.raycast_core(slab9, TUM1, cfg, **args)
    same("raycast_core", got, kernels.raycast_core(attr9, TUM1, cfg), (a, b), a)
    out["raycast_core"] = _raycast_rule(f"raycast_core [{label}]", got,
                                        kernels.raycast_core_ref(slab9, TUM1, cfg, **args))
    print(f"sharded step (c): every kernel's slab launch ({label}) equals its whole-image "
          "launch on the slab's rows bit for bit")
    return {k: {"max_abs_err": v, "rows": [a, b]} for k, v in out.items()}


# (f): every tracking setting of TRACKING_MODES on make_mesh(SHARD_MODE_MESH),
# tracked over phase_tracking_modes' frames, each state bit for bit to that
# phase's unsharded run of the mode after every step, 0 host syncs per step
SHARD_MODE_MESH = 4
# (g): GROUP_PROCESSES gloo processes x GROUP_SHARDS shards on the one card
# (NCCL refuses two ranks on one card) run the dense-step cell's frames:
# replayed at the main path's poses, tracked, and tracked with the
# correspondence search; every step's pose and count and the last state
# bit for bit to the in-process make_mesh(GROUP_PROCESSES * GROUP_SHARDS)
# run of the same frames
GROUP_PROCESSES, GROUP_SHARDS = 2, 4
GROUP_TIMEOUT_S = 480.0
GROUP_RUNS = ("replay", "tracked", "corr_search")
GROUP_IMAGES = ("pred_vertex", "pred_normal", "pred_intensity", "pred_icp_weight", "pred_k1",
                "pred_k2", "prev_intensity")


def _group_cfg(run: str) -> SLAMConfig:
    return (dataclasses.replace(BENCH_CFG, **TRACKING_MODES["corr_search"])
            if run == "corr_search" else BENCH_CFG)


def _sharded_modes(mode_runs, frames) -> dict:
    """(f) Each mode of phase_tracking_modes tracked on make_mesh(
    SHARD_MODE_MESH) from its unsharded bootstrap: after every step the
    state bit for bit to the unsharded run's, every step's host syncs
    counted (CUDA sync-debug mode, as the unsharded steps were) and timed,
    the kernels launched once per shard per step."""
    out = {}
    dev = frames[0].depth.device
    for name, (cfg, states, unsharded_ms) in mode_runs.items():
        mesh = sharding.make_mesh(SHARD_MODE_MESH, devices=[dev])
        got = sharding.shard_state(states[0], mesh, cfg)
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        ms, syncs, differing = [], 0, []
        for i, f in enumerate(frames[1:len(states)], start=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, n = _count_syncs(lambda: slam.step(got, f, TUM1, cfg))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            syncs += n
            bad = _state_diff(states[i], got)
            if bad:
                differing.append((i, bad))
        launches = dict(kernels.LAUNCHES)
        n_steps = len(states) - 1
        want = dict.fromkeys(launches, n_steps * mesh.size)
        if not cfg.normal_pca:
            want["normal_pca"] = 0
        r = out[name] = dict(steps=n_steps, bit_for_bit_steps=n_steps - len(differing),
                             differing=differing, host_syncs=syncs, launches=launches,
                             step_ms=ms, median_step_ms=float(np.median(ms[1:])),
                             median_unsharded_ms=float(np.median(unsharded_ms[1:])))
        print(f"sharded step (f) {name} on make_mesh({mesh.size}): bit for bit after "
              f"{r['bit_for_bit_steps']} of {n_steps} steps, host syncs {syncs}, median "
              f"{r['median_step_ms']:.2f} ms per step (unsharded {r['median_unsharded_ms']:.2f}; "
              f"steps 2-{n_steps}, sync-debug mode on), launches {json.dumps(launches)}")
        if differing or syncs or launches != want:
            raise RuntimeError(f"sharded step (f) {name}: differing {differing}, host syncs "
                               f"{syncs}, launches {launches} (expected {want})")
        del got
    return out


def _group_rank(addr, n_processes, rank, local_shards, est, device, out_dir):
    """One process of (g): the GROUP_RUNS on ``global_mesh(local_shards)``
    of ``device``, from the sharded bootstrap; writes per run each step's
    pose, count, ms, bytes put into the collectives and rows that
    ``move_rows`` brought from the other process, its kernels' launches
    and its own rows of the last state to ``out_dir/<run>_<rank>.npz``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        dev = torch.device(device)
        mesh = multihost.global_mesh(local_shards=local_shards, device=dev)
        poses, frames = _render_frames(dev)
        poses, frames = poses[:SHARD_FRAMES], frames[:SHARD_FRAMES]
        for run in GROUP_RUNS:
            cfg = _group_cfg(run)
            torch.cuda.synchronize()
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            st = slam.bootstrap(sharding.shard_frame(frames[0], mesh, cfg), TUM1, cfg,
                                init_pose=poses[0])
            steps, ms, sent, came = [], [], [], []
            for i in range(1, len(frames)):
                torch.cuda.synchronize()
                b0, r0, t0 = mesh.sent_bytes, mesh.received_rows, time.perf_counter()
                st = slam.step(st, frames[i], TUM1, cfg,
                               fixed_pose=est[i] if run == "replay" else None)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                sent.append(mesh.sent_bytes - b0)
                came.append(mesh.received_rows - r0)
                steps.append((st.R, st.t, st.map.count))
            rows = {k: np.stack([x.cpu().numpy() for x in col])
                    for k, col in zip(("R", "t", "count"), zip(*steps))}
            rows["map"] = torch.cat(st.map.data.parts).cpu().numpy()
            for name in GROUP_IMAGES:
                rows[name] = torch.cat(getattr(st, name).parts).cpu().numpy()
            np.savez(f"{out_dir}/{run}_{rank}.npz", **rows, ms=np.array(ms),
                     sent=np.array(sent), came=np.array(came),
                     launches=json.dumps(dict(kernels.LAUNCHES)),
                     devices=json.dumps([str(p.device) for p in st.map.data.parts]))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _group(records, est, frames) -> dict:
    """(g) GROUP_PROCESSES gloo processes x GROUP_SHARDS shards on the card
    against the in-process make_mesh(GROUP_PROCESSES * GROUP_SHARDS) runs
    (records of (a) and (b); the correspondence search's run here), every
    step's pose and count and the last state bit for bit; the sharded
    bootstrap in-process first held to the unsharded one bit for bit (the
    ranks start from it, the in-process runs from the unsharded one)."""
    n = GROUP_PROCESSES * GROUP_SHARDS
    dev = frames[0].depth.device
    mesh = sharding.make_mesh(n, devices=[dev])
    boot = slam.bootstrap(frames[0], TUM1, BENCH_CFG, init_pose=est[0])
    sboot = slam.bootstrap(sharding.shard_frame(frames[0], mesh, BENCH_CFG), TUM1, BENCH_CFG,
                           init_pose=est[0])
    bad = _state_diff(boot, sboot)
    print(f"sharded step (g): the sharded bootstrap on make_mesh({n}) equals the unsharded one "
          f"bit for bit: {not bad} {bad or ''}")
    if bad:
        raise RuntimeError(f"sharded step (g): the sharded bootstrap differs in {bad}")
    cfg = _group_cfg("corr_search")
    st = sharding.shard_state(slam.bootstrap(frames[0], TUM1, cfg, init_pose=est[0]), mesh, cfg)
    steps = []
    for f in frames[1:]:
        st = slam.step(st, f, TUM1, cfg)
        steps.append((st.R, st.t, st.map.count))
    refs = {"replay": records[("replay", n)], "tracked": records[("tracked", n)],
            "corr_search": _run_record(steps, st)}
    del st, boot, sboot
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        multihost.launch_local(_group_rank, GROUP_PROCESSES,
                               args=(GROUP_SHARDS, torch.stack(est).cpu(), str(dev), tmp),
                               timeout_s=GROUP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for run in GROUP_RUNS:
            ranks = [np.load(f"{tmp}/{run}_{r}.npz") for r in range(GROUP_PROCESSES)]
            ref = refs[run]
            differing = [k for k in ("R", "t", "count") if not all(
                np.array_equal(g[k], ref[k]) for g in ranks)]
            differing += [k for k in ("map",) + GROUP_IMAGES if not np.array_equal(
                np.concatenate([g[k] for g in ranks]), ref[k])]
            launches = [json.loads(str(g["launches"])) for g in ranks]
            ms = np.median(np.stack([g["ms"] for g in ranks]), axis=0)
            sent = np.sum(np.stack([g["sent"] for g in ranks]), axis=0)
            r = out[run] = dict(
                differing=differing, steps=len(ref["count"]),
                devices=[json.loads(str(g["devices"])) for g in ranks],
                map_rows_per_process=[int(g["map"].shape[0]) for g in ranks],
                launches={k: sum(x[k] for x in launches) for k in launches[0]},
                step_ms=ms.tolist(), median_step_ms=float(np.median(ms[3:])),
                bytes_per_step=sent.tolist(), median_bytes_per_step=float(np.median(sent)),
                moved_in_rows_per_step=[g["came"].tolist() for g in ranks])
            print(f"sharded step (g) {run}: {GROUP_PROCESSES} gloo processes x {GROUP_SHARDS} "
                  f"shards on {r['devices'][0][0]} vs in-process make_mesh({n}): every step's "
                  f"pose and count and the last state bit for bit: {not differing} "
                  f"{differing or ''}; median {r['median_step_ms']:.1f} ms per step (steps "
                  f"4-{r['steps']}), {r['median_bytes_per_step'] / 1e6:.2f} MB put into the "
                  f"collectives per step by both processes; map rows per process "
                  f"{r['map_rows_per_process']}, rows moved in from the other process per "
                  f"step, most / median: {[int(g['came'].max()) for g in ranks]} / "
                  f"{[float(np.median(g['came'])) for g in ranks]}; launches "
                  f"{json.dumps(r['launches'])}")
            if differing:
                raise RuntimeError(f"sharded step (g) {run}: differs from the in-process mesh "
                                   f"in {differing}")
            want = len(frames) * n
            if any(v != want for v in r["launches"].values()):
                raise RuntimeError(f"sharded step (g) {run}: launches {r['launches']}, "
                                   f"expected {want}")
    out["seconds_with_start_up"] = secs
    return out


def phase_sharded_step(poses, frames, est, state, smi, full_system, mode_runs) -> dict:
    """The row-sharded dense step on 4- and 8-shard meshes of the card:
    (a) replay bit for bit, (b) tracked, (c) the kernels' slab launches,
    (d) host syncs; (e) phase_distributed (c)'s sharded FullSLAM; (f) every
    tracking mode on 4 shards; (g) 2 gloo processes x 4 shards."""
    t_phase = time.perf_counter()
    out = {"replay": {}, "tracked": {}}
    records = {}
    slab_frames = frames
    poses, frames, est = poses[:SHARD_FRAMES], frames[:SHARD_FRAMES], est[:SHARD_FRAMES]
    for n in SHARD_MESHES:
        mesh = sharding.make_mesh(n, devices=[frames[0].depth.device])
        r, records[("replay", n)] = _lockstep("(a) replay", mesh, frames, poses, est)
        out["replay"][str(n)] = r
        if r["differing_fields"] or r["steps_bit_for_bit"] != SHARD_FRAMES - 1:
            raise RuntimeError(f"sharded replay on {n} shards differs from the unsharded step: "
                               f"{r['differing_fields']}")
        r, records[("tracked", n)] = _lockstep("(b) tracked", mesh, frames, poses, None)
        out["tracked"][str(n)] = r
        if not (max(r["pose_gaps"] + r["anchored_pose_gaps"]) <= SHARD_POSE_TOL
                and r["counts_equal"] and r["anchored_counts_equal"] == SHARD_FRAMES - 1
                and r["replayed_at_pose_bit_for_bit"] == SHARD_FRAMES - 1
                and r["ate_mm"] < SHARD_ATE_MAX * 1e3):
            raise RuntimeError(f"sharded tracked run on {n} shards: pose gaps "
                               f"{r['pose_gaps']} (to the unsharded step from the same state "
                               f"{r['anchored_pose_gaps']}), counts equal {r['counts_equal']} "
                               f"(count gaps {r['anchored_count_gaps']}), at its pose "
                               f"{r['replayed_differing_fields']}, ATE {r['ate_mm']} mm")
    out["slabs"] = _slab_checks(slab_frames, state, sharding.make_mesh(
        SHARD_SLAB_MESH, devices=[frames[0].depth.device]))
    out["full_system"] = {k: full_system[k] for k in (
        "shards", "map_row_shards", "fps", "ate_mm", "keyframes", "local_ba_problems",
        "sharded_solves", "keyframe_pose_gap", "keyframe_gap_mm")}
    out["modes"] = _sharded_modes(mode_runs, frames)
    mode_runs.clear()
    torch.cuda.empty_cache()
    out["group"] = _group(records, est, frames)
    print("sharded step: median ms per step, sharded (unsharded in the same run), bytes per "
          "shard: " + "; ".join(
              f"{m} {n} shards {r['median_step_ms']:.2f} ({r['median_unsharded_ms']:.2f}), "
              f"{r['bytes_per_shard'][0]} B" for m in ("replay", "tracked")
              for n, r in out[m].items()) + f"; {smi}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sharded step (e) = distributed (c): FullSLAM(mesh=make_mesh("
          f"{full_system['shards']})), map rows on {full_system['map_row_shards']} shards, "
          f"ATE {full_system['ate_mm']:.2f} mm; {smi}")
    print("sharded step (f): median ms per step on make_mesh(4) (unsharded): " + ", ".join(
        f"{k} {v['median_step_ms']:.2f} ({v['median_unsharded_ms']:.2f})"
        for k, v in out["modes"].items()) + f"; {smi}")
    print("sharded step (g): median ms per step, MB into the collectives per step: " + ", ".join(
        f"{k} {out['group'][k]['median_step_ms']:.1f}, "
        f"{out['group'][k]['median_bytes_per_step'] / 1e6:.2f}" for k in GROUP_RUNS)
        + f"; {smi}")
    print(f"sharded step: phase {out['seconds']:.1f} s")
    return out


# phase_group_full_system: FullSLAM over a process group, GFS_PROCESSES gloo
# processes x GFS_SHARDS shards on the one card (NCCL refuses two ranks on
# one card), launched once: (i) phase_distributed (c)'s protocol (DIST_FRAMES
# frames, FULL_CFG) sync through one process_batch, bit for bit to (c)'s
# in-process make_mesh(4) run (every pose and keyframe pose, each process's
# map rows, the count, the archive, archive_dropped); (ii) the same frames
# through process with async BA, both processes bit for bit to each other
# (the whole map gathered, the archive, poses, keyframes, the corrections
# and the frames they applied at), ATE under FULL_ATE_MAX; (iii)
# phase_full_system (a)'s out-and-back (the test's drift) replayed, the loop
# firing on both processes with the same pair and deltas, bit for bit to the
# same run on an in-process make_mesh(4); every dense step of every process
# launching every kernel, host syncs per dense step counted
GFS_PROCESSES, GFS_SHARDS = 2, 2
GFS_TIMEOUT_S = 900.0
GFS_PARTS = ("sync", "async", "loop")
GFS_ASYNC_FRAMES = DIST_FRAMES


def _gfs_record(sys_, mesh, halves: int = 1) -> dict:
    """What phase_group_full_system compares of a FullSLAM run on ``mesh``:
    the poses, keyframe poses, map count, archive count and digest,
    ``archive_dropped``, the loops, the async corrections applied, and a
    digest of the map rows of each of ``halves`` equal runs of the local
    shards (a group process's rows: ``halves`` 1; the same rows of an
    in-process mesh: ``halves`` = the group's process count)."""
    parts = sys_.state.map.data.parts
    k = len(parts) // halves
    arch = sys_.archive
    return dict(poses=sys_.poses().astype(np.float32),
                kf_poses=np.stack([kf.pose for kf in sys_.backend.keyframes]).astype(np.float32),
                count=int(sys_.state.map.count), archive_dropped=int(sys_.archive_dropped),
                archive_count=-1 if arch is None else int(arch.count),
                archive_digest=0 if arch is None else multihost.digest([arch.data]),
                map_digests=[multihost.digest([torch.cat(parts[h * k:(h + 1) * k])])
                             for h in range(halves)],
                loops=np.array(sys_.loop_closures, dtype=np.int64).reshape(-1, 2),
                applied=np.array(sys_.async_applied, dtype=np.int64).reshape(-1, 2))


@contextlib.contextmanager
def _backend_ms(sys_, sink):
    """Sum into ``sink[name]`` the wall ms of every call of the system's
    backend and loop closer entry points (on whichever thread)."""
    targets = [(sys_.backend, n) for n in ("insert_keyframe", "active_submap_mask", "local_ba")]
    if sys_.loop_closer is not None:
        targets += [(sys_.loop_closer, n) for n in ("add_keyframe", "correct")]
    for obj, name in targets:
        fn = getattr(obj, name)

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            sink[_name] = sink.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out

        setattr(obj, name, timed)
    try:
        yield
    finally:
        for obj, name in targets:
            delattr(obj, name)


def _gfs_run(part, mesh, dev, halves: int = 1) -> dict:
    """One part of phase_group_full_system on ``mesh`` (a group's or an
    in-process one): the system driven through its entry points, with the
    kernels' launches, host syncs and launches per dense step, bytes into
    the collectives, wall seconds and backend ms recorded."""
    if part == "loop":
        gt, drifted, frames = _loop_frames(dev, 1.0)
        sys_ = full_slam.FullSLAM(TUM1, LOOP_CFG, backend_kwargs=LOOP_BACKEND,
                                  loop_kwargs=LOOP_ARGS, init_pose=gt[0], mesh=mesh, device=dev)
    else:
        n = DIST_FRAMES if part == "sync" else GFS_ASYNC_FRAMES
        gt, batch = _dist_frames(dev, n)
        sys_ = full_slam.FullSLAM(TUM1, FULL_CFG, init_pose=gt[0], mesh=mesh, device=dev,
                                  async_ba=part == "async")
    corrects, ms, steps = [], {}, []
    lc = sys_.loop_closer
    if lc is not None:
        correct = lc.correct

        def recorded(cand, run_global_ba=True):
            deltas = correct(cand, run_global_ba)
            corrects.append((cand.match_kf, cand.query_kf, deltas))
            return deltas

        lc.correct = recorded
    bmesh = sys_.backend.mesh
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    b0, bb0 = mesh.sent_bytes, bmesh.sent_bytes
    with _sync_counts() as syncs, _per_frame(steps, syncs, mesh), _backend_ms(sys_, ms):
        t0 = time.perf_counter()
        if part == "loop":
            for i, f in enumerate(frames):
                sys_.process(f, timestamp=float(i), fixed_pose=drifted[i])
        elif part == "sync":
            sys_.process_batch(batch, timestamps=[float(i) for i in range(n)])
        else:
            for i in range(n):
                sys_.process(slam.FrameInput(batch.depth[i], batch.rgb[i]), timestamp=float(i))
            sys_.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        worker_syncs = syncs[1]
    rec = _gfs_record(sys_, mesh, halves)
    if lc is not None:
        lc.correct = correct
    n_frames = len(sys_.trajectory)
    rec.update(
        frames=n_frames, seconds=secs, fps=(n_frames - 1) / secs, keyframes=len(rec["kf_poses"]),
        ate_mm=ate_rmse(rec["poses"], gt[:n_frames], align=False) * 1e3,
        whole_digest=multihost.digest([sharded_step.whole_map(sys_.state.map).data]),
        corrects=np.array(multihost.digest([corrects]), dtype=np.int64),
        loop_pairs=np.array([(a, b) for a, b, _ in corrects], dtype=np.int64).reshape(-1, 2),
        step_syncs=np.array([s for s, _, _ in steps]),
        step_reads=np.array([r for _, _, r in steps]),
        idle_steps=np.array([i for i, (_, per, _) in enumerate(steps) if min(per.values()) == 0]),
        launches=json.dumps(dict(kernels.LAUNCHES)), worker_syncs=worker_syncs,
        dense_bytes=mesh.sent_bytes - b0, backend_bytes=bmesh.sent_bytes - bb0,
        backend_ms=json.dumps(ms))
    if part != "loop":
        rec["frames_digest"] = multihost.digest([batch.depth, batch.rgb])
    del sys_
    torch.cuda.empty_cache()
    return rec


def _gfs_rank(addr, n_processes, rank, local_shards, device, out_dir):
    """One process of phase_group_full_system: each of GFS_PARTS on
    ``global_mesh(local_shards)`` of ``device``; writes each part's record
    to ``out_dir/<part>_<rank>.npz``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        dev = torch.device(device)
        mesh = multihost.global_mesh(local_shards=local_shards, device=dev)
        for part in GFS_PARTS:
            np.savez(f"{out_dir}/{part}_{rank}.npz", **_gfs_run(part, mesh, dev))
        multihost.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _gfs_differing(ranks, ref, keys) -> list:
    """The keys of ``keys`` in which some process's record differs from
    ``ref``'s."""
    return [k for k in keys if not all(np.array_equal(g[k], ref[k]) for g in ranks)]


def phase_group_full_system(dev, ref_sync, smi) -> dict:
    """(h) FullSLAM over GFS_PROCESSES gloo processes x GFS_SHARDS shards:
    (i) sync against phase_distributed (c)'s in-process run, (ii) async,
    the processes against each other, (iii) the out-and-back's loop
    against the same run on an in-process make_mesh(4)."""
    t_phase = time.perf_counter()
    n = GFS_PROCESSES * GFS_SHARDS
    ref_loop = _gfs_run("loop", sharding.make_mesh(n, devices=[dev]), dev, GFS_PROCESSES)
    print(f"group full system (iii) in process: FullSLAM(mesh=make_mesh({n})) on the "
          f"out-and-back: {ref_loop['fps']:.2f} fps, loops {ref_loop['loops'].tolist()}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        multihost.launch_local(_gfs_rank, GFS_PROCESSES, args=(GFS_SHARDS, str(dev), tmp),
                               timeout_s=GFS_TIMEOUT_S)
        secs = time.perf_counter() - t0
        parts = {p: [dict(np.load(f"{tmp}/{p}_{r}.npz")) for r in range(GFS_PROCESSES)]
                 for p in GFS_PARTS}
    out, failed = {"seconds_with_start_up": secs}, []
    for part, ranks in parts.items():
        if part == "sync":
            ref = ref_sync
            keys = ("poses", "kf_poses", "count", "archive_count", "archive_dropped",
                    "archive_digest", "frames_digest")
        elif part == "async":
            ref = ranks[0]
            keys = ("poses", "kf_poses", "count", "archive_count", "archive_dropped",
                    "archive_digest", "whole_digest", "loops", "corrects", "applied")
        else:
            ref = ref_loop
            keys = ("poses", "kf_poses", "count", "loops", "corrects", "loop_pairs")
        differing = _gfs_differing(ranks, ref, keys)
        if part != "async":
            differing += [f"map rows of process {r}" for r, g in enumerate(ranks)
                          if int(g["map_digests"][0]) != int(ref["map_digests"][r])]
        launches = [json.loads(str(g["launches"])) for g in ranks]
        step_syncs = sorted({int(x) for g in ranks for x in g["step_syncs"]})
        step_reads = sorted({int(x) for g in ranks for x in g["step_reads"]})
        # the dense step's host syncs over a group are the split-size reads
        # of move_rows (Mesh.host_reads), one per move, and nothing else
        unexplained = [r for r, g in enumerate(ranks)
                       if not np.array_equal(g["step_syncs"], g["step_reads"])]
        frames = int(ranks[0]["frames"])
        r = out[part] = dict(
            differing=differing, frames=frames, keyframes=int(ranks[0]["keyframes"]),
            fps=[float(g["fps"]) for g in ranks], seconds=[float(g["seconds"]) for g in ranks],
            ref_fps=float(ref["fps"]) if part != "async" else float(ref_sync["fps"]),
            ate_mm=float(ranks[0]["ate_mm"]), host_syncs_per_dense_step=step_syncs,
            move_rows_reads_per_dense_step=step_reads,
            host_syncs_per_process=[int(g["step_syncs"].sum()) for g in ranks],
            worker_syncs=[int(g["worker_syncs"]) for g in ranks],
            dense_steps=[len(g["step_syncs"]) for g in ranks],
            idle_steps=[g["idle_steps"].tolist() for g in ranks],
            launches={k: sum(x[k] for x in launches) for k in launches[0]},
            dense_bytes_per_frame=[float(g["dense_bytes"]) / frames for g in ranks],
            backend_bytes_per_frame=[float(g["backend_bytes"]) / frames for g in ranks],
            backend_ms_per_keyframe=[
                {k: v / int(g["keyframes"]) for k, v in json.loads(str(g["backend_ms"])).items()}
                for g in ranks],
            loops=ranks[0]["loops"].tolist(), loop_pairs=ranks[0]["loop_pairs"].tolist(),
            applied=ranks[0]["applied"].tolist(), archive_dropped=int(ranks[0]["archive_dropped"]),
            count=int(ranks[0]["count"]))
        total_ms = [sum(x.values()) for x in r["backend_ms_per_keyframe"]]
        print(f"group full system ({part}): {GFS_PROCESSES} gloo processes x {GFS_SHARDS} shards "
              f"on {dev}, {frames} frames: {', '.join(f'{x:.2f}' for x in r['fps'])} fps per "
              f"process (in-process make_mesh({n}) {r['ref_fps']:.2f}); bit for bit to "
              f"{'each other' if part == 'async' else f'make_mesh({n})'}: {not differing} "
              f"{differing or ''}; ATE {r['ate_mm']:.2f} mm; keyframes {r['keyframes']}, loops "
              f"{r['loops']} (pairs corrected {r['loop_pairs']}); async corrections applied "
              f"(state time, keyframe) {r['applied']}; host syncs per dense step {step_syncs}, "
              f"of them move_rows' split-size reads {step_reads} (syncs per process "
              f"{r['host_syncs_per_process']} in {r['dense_steps']} dense steps; keyframe worker "
              f"{r['worker_syncs']}; async: one agreement per frame boundary, a host integer "
              f"over gloo, no device read); bytes into "
              f"the collectives per frame: dense "
              f"{', '.join(f'{x / 1e6:.2f}' for x in r['dense_bytes_per_frame'])} MB, backend "
              f"{', '.join(f'{x / 1e3:.1f}' for x in r['backend_bytes_per_frame'])} kB; backend "
              f"ms per keyframe per process {', '.join(f'{x:.1f}' for x in total_ms)} "
              f"({json.dumps(r['backend_ms_per_keyframe'])}); archive_dropped "
              f"{r['archive_dropped']}; launches {json.dumps(r['launches'])}; {smi}")
        if differing:
            failed.append(f"({part}) differs in {differing}")
        if any(r["idle_steps"]) or any(k != frames for k in r["dense_steps"]):
            failed.append(f"({part}) {r['dense_steps']} dense steps for {frames} frames; a "
                          f"kernel idle in steps {r['idle_steps']}")
        if unexplained:
            failed.append(f"({part}) processes {unexplained}: host syncs in dense steps other "
                          f"than move_rows' split sizes ({step_syncs} against {step_reads})")
        if not np.isfinite(ranks[0]["poses"]).all() or (
                part != "loop" and not r["ate_mm"] < FULL_ATE_MAX * 1e3):
            failed.append(f"({part}) ATE {r['ate_mm']} mm")
        if part == "loop" and not (r["loops"] and r["loop_pairs"]):
            failed.append("(loop) no loop closed")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"group full system: phase {out['seconds']:.1f} s ({secs:.1f} s the launch)")
    if failed:
        raise RuntimeError("group full system: " + "; ".join(failed))
    return out


def main() -> None:
    t_start = time.perf_counter()
    name, smi = phase_card()
    dev = torch.device("cuda", 0)
    attrs = phase_build()
    print(json.dumps({"sqrt": phase_sqrt(dev)}))
    poses, frames = phase_frames(dev)
    state, launches, _, est = phase_main_path(poses, frames)
    ray = phase_raycast_vs_plain(state)
    pre = phase_preprocess_vs_plain(frames)
    phase_use_pallas(poses, frames)
    profiled = phase_breakdown(poses, frames)
    backend, last_problem = phase_backend(dev)
    print(json.dumps({"backend": backend}))
    full = phase_full_system(dev)
    full["device"] = smi
    print(json.dumps({"full_system": full}, default=float))
    real = phase_run_tum(dev, smi=smi)
    real["device"] = smi
    print(json.dumps({"run_tum": real}, default=float))
    modes, mode_runs = phase_tracking_modes(poses, frames, smi)
    modes["device"] = smi
    print(json.dumps({"tracking_modes": modes}, default=float))
    distributed, sync_record = phase_distributed(last_problem, dev, smi)
    distributed["device"] = smi
    print(json.dumps({"distributed": distributed}, default=float))
    sharded = phase_sharded_step(poses, frames, est, state, smi, distributed["full_system"],
                                 mode_runs)
    sharded["device"] = smi
    print(json.dumps({"sharded_step": sharded}, default=float))
    group_full = phase_group_full_system(dev, sync_record, smi)
    group_full["device"] = smi
    print(json.dumps({"group_full_system": group_full}, default=float))

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
        row["klg_jpeg_launches"] = [r["launches"][kname]
                                    for r in real["klg_jpeg"]["fullslam"]["jpeg"]]
        row["tum_jpeg_launches"] = [real["tum_jpeg"]["cli"]["launches"][kname],
                                    real["tum_jpeg"]["in_process"]["launches"][kname]]
        row["tum_forms_launches"] = real["tum_forms"]["launches"][kname]
        row["tum_depth_forms_launches"] = real["tum_depth_forms"]["launches"][kname]
        row["tum_colour_forms_launches"] = real["tum_colour_forms"]["launches"][kname]
        row["tum_tiff_forms_launches"] = real["tum_tiff_forms"]["launches"][kname]
        row["tracking_modes_launches"] = {k: v["launches"][kname] for k, v in modes.items()
                                          if isinstance(v, dict) and "launches" in v}
        row["distributed_launches"] = distributed["full_system"]["launches"][kname]
        row["sharded_step_launches"] = {f"{m} {n}": sharded[m][str(n)]["launches"][kname]
                                        for m in ("replay", "tracked") for n in SHARD_MESHES}
        row["sharded_slab"] = sharded["slabs"][kname]
        row["sharded_modes_launches"] = {k: v["launches"][kname]
                                         for k, v in sharded["modes"].items()}
        row["group_launches"] = {k: sharded["group"][k]["launches"][kname] for k in GROUP_RUNS}
        row["group_full_system_launches"] = {k: group_full[k]["launches"][kname]
                                             for k in GFS_PARTS}
        if kname == "bilateral_filter":
            row["keyframe_launches"] = full["tracked"]["keyframe_bilateral_launches"]
        if kname == "raycast_core":
            row["variants"] = ray
            row["attributes"] = {k: attrs[f"raycast_core K={k}"] for k in (10, 16)}
        elif kname in attrs:
            row["attributes"] = attrs[kname]
        rows.append(row)
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s ({smi})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
