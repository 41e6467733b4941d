"""Engine configuration of the port: its own copy of the JAX package's
``SLAMConfig`` and ``CameraIntrinsics`` (every field, default and comment),
the TUM / ICL-NUIM camera presets and ``small_test_config``.  The port imports nothing
of the JAX package; ``tests/test_torch_core.py`` holds the two copies equal
field by field.

The reference's parameter singleton (``Core/src/Utils/GlobalStateParams.h``
parsed from ``GUI/GlobalStateParam.txt``) becomes a frozen dataclass.  The
timings quoted in the field comments are the JAX package's, measured on a
TPU; they say nothing about the port.

How the port reads the TPU-specific switches:
  - ``use_pallas`` selects the bilateral filter's denominator: False is the
    shader form (invalid in-image neighbours stay in the denominator), True
    the Pallas kernel's form (they are dropped), as the JAX step computes
    under either setting.  The PCA-normal and curvature kernels run either
    way;
  - ``use_pallas_raycast``, ``raycast_block_height``, ``fuse_gather_quarter``,
    ``pyramid_gather_decimate`` and ``tracking_joint_gather`` are layout
    switches of the TPU code: read and ignored.  The port always runs its one
    semantics, and always its kernel where it has one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics; reference: ``Core/src/Utils/Intrinsics.h`` and
    the OpenCV YAML load at ``Core/src/HRBFFusion.cpp:682-781`` (TUM1.yaml)."""

    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    width: int = 640
    height: int = 480

    def level(self, lvl: int) -> "CameraIntrinsics":
        """Pyramid-level intrinsics (reference ``Intrinsics::operator()``:
        each level halves resolution and focal lengths)."""
        s = 1.0 / (1 << lvl)
        return CameraIntrinsics(
            fx=self.fx * s,
            fy=self.fy * s,
            cx=self.cx * s,
            cy=self.cy * s,
            width=self.width >> lvl,
            height=self.height >> lvl,
        )


# TUM camera presets (fr1/fr2/fr3 + ICL-NUIM), values from the standard
# TUM1/2/3.yaml calibration files the reference ships with ORB_SLAM2_m.
TUM1 = CameraIntrinsics(517.306408, 516.469215, 318.643040, 255.313989, 640, 480)
TUM2 = CameraIntrinsics(520.908620, 521.007327, 325.141442, 249.701764, 640, 480)
TUM3 = CameraIntrinsics(535.4, 539.2, 320.1, 247.6, 640, 480)
ICL_NUIM = CameraIntrinsics(481.20, -480.00, 319.50, 239.50, 640, 480)


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Engine parameters.

    Field provenance (reference file:line) is given per group; names are
    de-hungarianised versions of ``GlobalStateParam`` fields.
    """

    # -- preprocessing (GlobalStateParam.txt:20-31) --
    use_bilateral_filter: bool = True
    radius_multiplier: float = 4.0          # preprocessingInitRadiusMultiplier
    curv_window: int = 3                    # preprocessingCurvEstimationWindow
    curv_valid_threshold: float = 300.0     # preprocessingCurvValidThreshold
    normal_pca: bool = True                 # preprocessingNormalEstimationPCA
    use_conf_eval: bool = False             # preprocessingUseConfEval
    conf_eval_epsilon: float = 1000.0
    bilateral_sigma_space: float = 4.5      # depth_bilateral.frag constants
    bilateral_sigma_depth: float = 0.03
    bilateral_radius: int = 3

    # -- registration (GlobalStateParam.txt:36-58, RGBDOdometry.cpp) --
    so3_prealign: bool = True               # registrationPreAlignSO3
    icp_weight: float = 10.0                # registrationJointICPWeight
    icp_use_correspondence_search: bool = False
    icp_search_radius: int = 2
    # single shared row gather per GN iteration for the ICP+photometric
    # joint system (equivalence-tested vs the separate formulations in
    # tests/test_odometry.py).  With BILINEAR photometric lookups the
    # joint table is 36-ch/144-B rows and measured SLOWER than the
    # separate 2x8-ch gathers (row-gather cost grows with row bytes past
    # ~100 B — ab15: 117 vs 102 ms/frame), so the default is OFF; with
    # tracking_rgb_nearest the joint table is one 9-ch row and wins big
    # (94 ms/frame) — the autotuned config enables both
    tracking_joint_gather: bool = False
    # nearest-pixel photometric lookups (intensity at the rounded warp) —
    # the REFERENCE's semantics (reduce.cu fetches lastImage unfiltered at
    # the rounded coordinate).  Also collapses the association to ONE
    # 9-channel gather per GN iteration (vs 36-ch joint or 2x8-ch separate
    # — per-row gather cost grows with row bytes past ~100 B): 117 -> 94
    # ms/frame (ab15).  Bilinear interpolation (False) looked strictly
    # better on the 128x96 CPU harness but measured 5x WORSE ATE at the
    # native 640x480 (scripts/tpu_ate.py: 37.6 vs 7.0 mm on the synth
    # orbit — interpolation blends intensity across depth edges), so
    # nearest is both reference parity AND the accurate default
    tracking_rgb_nearest: bool = True
    icp_use_weighted: bool = True           # registrationICPUseWeightedICP
    icp_curv_weight_lambda: float = 10.0    # registrationICPCurvWeightImpactControl
    rgb_use_gradient_weight: bool = False
    # sparse ICP: ADMM Lp-shrinkage on the point-to-plane target
    # (reduce.cu:296-315, 479-492, cudafuncs.cu:1030-1075; default OFF in
    # the reference — registrationICPUseSparseICP)
    icp_use_sparse: bool = False
    sparse_icp_mu: float = 10.0             # reduce.cu:653
    sparse_icp_p: float = 0.5               # reduce.cu:652 (L_p norm)
    sparse_icp_shrink_iters: int = 3        # reduce.cu:654
    dist_threshold: float = 0.10            # RGBDOdometry.h distThres_
    angle_threshold: float = 0.342          # sin(20deg), RGBDOdometry.h
    curvature_threshold: float = 100.0
    pyramid_iterations: Tuple[int, int, int] = (10, 5, 4)   # RGBDOdometry.cpp:916-918
    so3_iterations: int = 10                # RGBDOdometry.cpp:845
    num_pyramid_levels: int = 3             # NUM_PYRS
    max_depth_delta_rgb: float = 0.07       # RGBDOdometry.h maxDepthDeltaRGB
    min_gradient_magnitudes: Tuple[float, float, float] = (5.0, 3.0, 1.0)
    sobel_scale: float = 1.0 / 8.0          # 1/(2*4) standard Sobel normalisation
    tracking_divergence_limit: float = 0.3  # RGBDOdometry.cpp:1232 ||dt||>0.3 revert

    # -- prediction (GlobalStateParam.txt:63-69) --
    predict_window_multiplier: int = 3      # preictionWindowMultiplier
    predict_min_neighbors: int = 6
    predict_max_neighbors: int = 10
    predict_conf_threshold: float = 3.0
    raycast_coarse_step: float = 0.004      # predict_hrbf.frag:166 (4 mm)
    raycast_coarse_steps: int = 25          # predict_hrbf.frag:163
    raycast_bisection_iters: int = 10       # predict_hrbf.frag:236
    # geometric ladder: taps at {1,2,3,5,8,13,18,25}*step instead of every
    # step (same +-25*step range, 4 mm granularity within +-3 steps of the
    # nearest-neighbor init where the crossing almost always is); 3 extra
    # bisection iterations recover the precision lost to the wider far
    # brackets.  8 HRBF ladder evals per direction instead of 25 — the
    # evals, not HBM traffic, bound the raycast kernel.
    raycast_geometric_ladder: bool = True
    # batched k-section root refinement: instead of N sequential bisection
    # iterations (each a full pass over the 49-tap neighbor stacks), evaluate
    # B interior points per pass in ONE batched HRBF evaluation and keep the
    # sign-change sub-interval — ceil(N / log2(B+1)) passes reach the same
    # bracket width.  More FLOPs (B evals/pass) but ~3x fewer passes over
    # the tap stacks; the fused kernel is pass-bound, not FLOP-bound.
    # 0 = sequential bisection (reference semantics, predict_hrbf.frag:236)
    raycast_bisection_batch: int = 0
    # false-position (regula falsi) root refinement: N iterations replace
    # the bisection entirely.  The HRBF field is smooth near the surface so
    # false position converges superlinearly — 3 iterations from the 4 mm
    # ladder bracket reach micrometre error where 9 bisections reach ~8 um
    # — with 3x fewer field evaluations (the fused kernel is
    # evaluation-FLOP-bound).  0 = bisection (reference semantics)
    raycast_false_position: int = 0

    # -- fusion / cleaning (GlobalStateParam.txt:74-77, copy_unstable.vert) --
    fuse_window_multiplier: int = 2         # fusionMergeWindowMultiplier
    clean_window_multiplier: int = 2        # fusionCleanWindowMultiplier
    depth_consistency: float = 0.05         # data.vert:145 (0.05*lambda)
    fuse_angle_limit: float = 0.5           # data.vert:154 (rad)
    unstable_time_limit: int = 200          # copy_unstable.vert:161
    clean_overlap_limit: int = 8            # copy_unstable.vert:149
    clean_freespace_limit: int = 4          # copy_unstable.vert:149

    # -- global (GlobalStateParam.txt:79-81) --
    confidence_threshold: float = 5.0       # globalConfidenceThreshold
    dense_enough_threshold: float = 0.75    # globalDenseEnoughThresh
    depth_cutoff: float = 3.5               # globalDepthCutoff
    depth_min: float = 0.3                  # hard-coded 0.3 in shaders

    # -- keyframes / submaps / BA (HRBFFusion.cpp:289-335, local mapping) --
    use_local_ba: bool = True
    use_global_ba: bool = True
    keyframe_period: int = 10               # NeedNewSubMap: every 10 frames
    max_submaps: int = 3600                 # GlobalModel.cpp:25 MAX_SUBMAPS

    # -- capacities (TPU static shapes; reference: GlobalModel.cpp:21-22
    #    TEXTURE_DIMENSION=4596 => 21.1M; we keep it configurable) --
    map_capacity: int = 1 << 20
    new_surfels_capacity: int = 1 << 17     # max insertions per frame (checkerboarded)

    # -- TPU-specific --
    compute_dtype: str = "float32"
    # pixel-chunk sizes for the two heaviest per-pixel kernels: on TPU the
    # full image in one shot lets XLA fuse the neighbor reductions (the
    # sequential lax.map chunks serialize); small chunks bound CPU memory
    raycast_chunk: int = 1 << 20
    curvature_chunk: int = 1 << 20
    # use the Pallas VMEM-stencil kernels (ops/pallas_kernels.py) for the
    # bilateral / PCA-normal / curvature passes (TPU only)
    use_pallas: bool = False
    # fused Pallas HRBF raycast (ladder+bisection+gradient in VMEM) — the
    # XLA path re-reads the neighbor patches ~61x from HBM per frame
    use_pallas_raycast: bool = False
    # rows per raycast grid block (VMEM: BH x (w+2R) x 9ch tap stacks +
    # accumulators; 16 needs a ~66 MB scoped-vmem cap — raised
    # automatically — and saves ~6 ms/frame over 8 in per-block fixed
    # costs; falls back to a divisor of the image height when needed)
    raycast_block_height: int = 16
    # run the kill rules every frame (reference parity) but stream-compact
    # the surfel array only every N-th frame (tombstones in between); the
    # compaction is a full-capacity sort + row gather
    clean_compact_period: int = 1
    # evaluate the crowd/free-space kill rules (copy_unstable.vert:149-152)
    # only every N-th frame (1 = reference parity: every frame).  These two
    # rules are clean's entire gather cost (a full-capacity 9-tap patch
    # gather, ~7 ms at 512k); the curvature/unstable rules (elementwise)
    # still run every frame.  Redundancy/free-space violations accumulate
    # over many frames, so delaying their detection by one frame is
    # map-hygiene latency, not accuracy
    clean_crowd_period: int = 1
    # fuse's checkerboard-quarter views as row gathers at the quarter's
    # flat pixel ids instead of stride-2 slices (slices on T(8,128)-tiled
    # tensors pay a layout shuffle per array)
    fuse_gather_quarter: bool = True
    # pyramid downsamplers decimate via flat gathers / reduce_window pools
    # instead of stride-2 slices (same layout-shuffle tax; ~41 slices per
    # frame across the 14 tracking pyramids)
    pyramid_gather_decimate: bool = True
    # Gauss-Newton early exit: stop a pyramid level's iterations once the
    # SE(3) increment norm drops below this (GN contracts quadratically, so
    # the reference's fixed {10,5,4} budgets mostly run converged no-op
    # iterations at the finest level — each costs a full-image
    # correspondence gather).  0 = fixed budgets (exact reference parity).
    # Default 0: at 640x480 the increments plateau ~1e-5 (linear, not
    # quadratic, convergence — NOTES_R1), so a tiny eps never fires and the
    # lax.while_loop it forces costs scheduler overhead vs the static
    # fori_loop for nothing.
    tracking_converge_eps: float = 0.0
    # run the HRBF implicit-surface raycast (predictHRBF) every N-th frame
    # and the cheap surfel-splat prediction (combinedPredict,
    # IndexMap.cpp:359-412) in between.  1 = reference parity (HRBF every
    # frame); >1 trades prediction smoothness for speed (the raycast is the
    # single most expensive stage)
    raycast_period: int = 1
    # re-gather tracking correspondences every N-th GN iteration and run
    # fixed-correspondence iterations in between (classic ICP inner
    # iterations: the carried association (model point/normal/weight,
    # photometric target) stays fixed while the residuals, gates and
    # Jacobians are recomputed under the updated pose — all elementwise).
    # The per-iteration correspondence row gather is the single most
    # expensive tracking op (~3 ms at 640x480); pose increments move the
    # warp subpixel after the first finest-level iterations, so stale
    # associations cost little accuracy.  1 = reference parity (re-gather
    # every iteration, as reduce.cu does)
    tracking_reassoc_period: int = 1
    # decimate the CURRENT-frame pixel set of the finest-level GN
    # iterations by this stride in both image dims (stride 2 = 4x fewer
    # residual rows).  The model-side association table stays at full
    # resolution, so correspondence precision is unchanged — only the
    # sampling density of the (massively overdetermined) 6-DoF normal
    # equations drops: ~77k rows still estimate 6 parameters.  The LAST
    # ``tracking_subsample_full_iters`` finest-level iterations always run
    # at full resolution to polish with every pixel.  1 = reference parity
    # (reduce.cu runs every pixel every iteration).
    tracking_subsample: int = 1
    tracking_subsample_full_iters: int = 3
    # bounded-displacement streaming association for the finest-level GN
    # iterations (ops/icp.PatchAssoc): anchor the correspondence patch once
    # at level entry (one wide row gather), select taps arithmetically per
    # iteration (zero gathers inside the GN loop).  Association is
    # identical to per-iteration re-gathering while the rounded warp stays
    # within tracking_patch_radius of the anchor; pixels that drift
    # further lose their correspondence for that iteration.  Requires the
    # joint-nearest path (tracking_rgb_nearest).  1 = the reference's
    # re-gather-every-iteration semantics (reduce.cu re-searches per iter).
    tracking_patch_assoc: bool = False
    tracking_patch_radius: int = 1
    # saliency-weighted pixel selection for the finest-level GN iterations:
    # run them on the k most informative pixels (normalised
    # intensity-gradient + curvature score with a uniform dither filling
    # the remaining slots — ops/icp.saliency_ids) instead of all H*W.
    # The model-side association table stays full-resolution.  0 = every
    # pixel (reference parity).  The last tracking_topk_full_iters
    # finest-level iterations run at full resolution to polish.
    tracking_topk: int = 0
    tracking_topk_full_iters: int = 0
    # translate the post-fuse index map through clean in PIXEL space on
    # tombstone frames (no compaction, no crowd evaluation): the only
    # active kill rules there read the pixel's own surfel attributes,
    # already present in the extended attr image — skips the full remap
    # row gather (surfel_map.pixel_keep_mask; exact equivalence tested).
    # False = always gather the remap (the pre-r3 formulation).
    clean_pixel_remap: bool = True
    # active-window/archive map split (surfel_map.exchange_active): > 0
    # enables it, the value is the INITIAL archive capacity (grows by
    # doubling).  map_capacity then sizes the ACTIVE map — the per-frame
    # working set slam.step runs on — so dense per-frame cost is bounded
    # by the active window regardless of total map size (the reference
    # masks inactive submaps per-frame, index_map.vert:41-51, but still
    # pays a full-buffer pass; on TPU the inactive rows physically leave).
    # 0 = single-map mode (everything in map_capacity, r1/r2 behavior).
    active_capacity: int = 0
    # initial archive allocation for the active/archive split.  Pre-size
    # for the expected final map (like the reference's up-front 21.1M
    # allocation, GlobalModel.cpp:21-27) so long runs never grow mid-run;
    # growth still works (bucketed, checked BEFORE each exchange so a
    # worst-case exchange cannot overflow).  0 = start at active_capacity.
    archive_capacity: int = 0


def small_test_config(**overrides) -> SLAMConfig:
    """A scaled-down config for unit tests (small capacity, fewer iters)."""
    base = dict(
        map_capacity=1 << 14,
        new_surfels_capacity=1 << 12,
        pyramid_iterations=(4, 3, 2),
        so3_iterations=4,
        raycast_chunk=8192,
        curvature_chunk=16384,
    )
    base.update(overrides)
    return dataclasses.replace(SLAMConfig(), **base)
