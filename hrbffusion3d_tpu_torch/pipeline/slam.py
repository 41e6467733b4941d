"""The dense SLAM step on torch tensors (port of
``hrbffusion3d_tpu/pipeline/slam.py``): ``bootstrap`` and
``step(state, frame) -> state``, the per-frame pipeline
preprocess -> track -> fuse -> clean -> predict (HRBFFusion::processFrame).

Host/device split: the frame counter ``time`` and ``submap_idx`` are host
ints, so every periodic branch (compaction, crowd rules, pixel-space
remap, the HRBF ray cast every ``raycast_period``-th frame with splat
prediction between) is a Python ``if``; everything else stays on the device, and a step
reads nothing back to the host.

A state (or frame) split over a mesh (``parallel.sharding.shard_state``)
runs the row-sharded step (``parallel.sharded_step``): ``bootstrap``,
``step``, ``step_many*``, ``step_chunk`` and ``ensure_capacity`` take it
as they take a whole one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..core import lie
from ..map import surfel_map as sm
from ..ops import preprocess, pyramid, raycast
from ..tracking import odometry
from ..utils.tensors import const


class SLAMState(NamedTuple):
    map: sm.SurfelMap
    R: torch.Tensor                # (3,3) current pose (world <- camera)
    t: torch.Tensor                # (3,)
    time: int                      # frame counter (host int)
    submap_idx: int                # current submap/keyframe index (host int)
    prev_intensity: torch.Tensor   # (H,W) previous live intensity (SO3)
    pred_vertex: torch.Tensor      # (H,W,3) prediction, current camera frame
    pred_normal: torch.Tensor
    pred_intensity: torch.Tensor   # (H,W) predicted grey
    pred_icp_weight: torch.Tensor  # (H,W)
    pred_k1: torch.Tensor          # (H,W)
    pred_k2: torch.Tensor
    active_submaps: torch.Tensor   # (max_submaps,) bool covisible-KF set
    last_icp_error: torch.Tensor
    last_icp_count: torch.Tensor
    dense_frac: torch.Tensor       # () denseEnough indicator of last predict


class FrameInput(NamedTuple):
    depth: torch.Tensor   # (H,W) metric depth (0 = invalid)
    rgb: torch.Tensor     # (H,W,3) in [0,1]


def _preprocess(frame: FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig):
    """filter -> vertex/normal/radius -> curvature/gradient -> update normal.
    ``cfg.use_pallas`` picks the bilateral denominator as the JAX step's
    choice of filter does (shader form when False, Pallas form when True)."""
    depth_f = (preprocess.bilateral_filter(frame.depth, cfg, pallas_form=cfg.use_pallas)
               if cfg.use_bilateral_filter else frame.depth)
    pre = preprocess.vertex_normal_radius(frame.depth, depth_f, intr, cfg)
    curv = preprocess.curvature_gradient(pre, intr, cfg)
    pre = preprocess.update_normal_rad(pre, curv, cfg)
    return depth_f, pre, curv, pyramid.rgb_to_intensity(frame.rgb)


def _state_from_prediction(m, R, t, time, submap_idx, intensity, filled,
                           active_submaps, icp_error, icp_count) -> SLAMState:
    return SLAMState(
        map=m, R=R, t=t, time=time, submap_idx=submap_idx,
        prev_intensity=intensity,
        pred_vertex=filled.vertex, pred_normal=filled.normal,
        pred_intensity=pyramid.rgb_to_intensity(filled.color),
        pred_icp_weight=filled.icp_weight,
        pred_k1=filled.k1, pred_k2=filled.k2,
        active_submaps=active_submaps,
        last_icp_error=icp_error, last_icp_count=icp_count,
        dense_frac=filled.from_model.to(torch.float32).mean(),
    )


def bootstrap(frame: FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig,
              init_pose=None) -> SLAMState:
    """First-frame initialisation (HRBFFusion.cpp:1026-1059).  A frame
    split over a mesh gives a state split over it
    (``parallel.sharded_step.bootstrap``)."""
    if _sharded(frame):
        from ..parallel import sharded_step

        return sharded_step.bootstrap(frame, intr, cfg, init_pose)
    return _bootstrap(frame, intr, cfg, init_pose)


def _bootstrap(frame: FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig,
               init_pose=None) -> SLAMState:
    """``bootstrap`` of a whole frame."""
    dev = frame.depth.device
    pose = (torch.eye(4, dtype=torch.float32, device=dev) if init_pose is None
            else const(init_pose, dev))
    depth_f, pre, curv, intensity = _preprocess(frame, intr, cfg)
    conf = preprocess.confidence_map(pre, curv, intr, cfg, weighting=1.0)
    meas = sm.measurement_from_preprocess(pre, curv, frame.rgb, conf)
    m = sm.initialise(cfg.map_capacity, meas, pose, cfg, time=1, submap_idx=0)
    pose_inv = lie.se3_inverse(pose)
    idx = sm.render_index(m, pose_inv, intr)
    pred = raycast.predict_hrbf(m, pose_inv, idx, intr, cfg)
    filled = raycast.fill_in(pred, pre.vertex_filtered, pre.normal, pre.radius,
                             frame.rgb, conf, curv.k1, curv.k2, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return _state_from_prediction(
        m, pose[:3, :3], pose[:3, 3], 1, 0, intensity, filled,
        torch.ones((cfg.max_submaps,), dtype=torch.bool, device=dev), zero, zero)


def step(state: SLAMState, frame: FrameInput, intr: CameraIntrinsics,
         cfg: SLAMConfig, fixed_pose: torch.Tensor | None = None) -> SLAMState:
    """One tracked + fused frame (HRBFFusion.cpp:991-1241, BA hooks
    excluded).  ``fixed_pose``: optional (4,4) camera-to-world pose; when
    given, tracking is skipped (trajectory replay mode).  A state split
    over a mesh runs the row-sharded step
    (``parallel.sharded_step.step``)."""
    if _sharded(state):
        from ..parallel import sharded_step

        return sharded_step.step(state, frame, intr, cfg, fixed_pose)
    time = state.time + 1
    depth_f, pre, curv, intensity = _preprocess(frame, intr, cfg)

    if fixed_pose is None:
        tr = track_frame(state, depth_f, pre, curv, intensity, intr, cfg)
        new_R, new_t = tr.R, tr.t
        icp_error, icp_count = tr.icp_error, tr.icp_count
    else:
        fixed_pose = const(fixed_pose, state.R.device)
        new_R, new_t = fixed_pose[:3, :3], fixed_pose[:3, 3]
        icp_error = icp_count = torch.zeros((), dtype=torch.float32, device=state.R.device)
    pose = lie.rt_to_mat(new_R, new_t)
    pose_inv = lie.se3_inverse(pose)

    # velocity weighting (l.1112-1126): down-weight fast motion
    dt = torch.linalg.vector_norm(new_t - state.t)
    w_rot = torch.linalg.vector_norm(lie.so3_log(state.R.T @ new_R))
    weighting = torch.clamp(1.0 - (dt * 5.0 + w_rot * 2.0), 0.25, 1.0)
    conf = preprocess.confidence_map(pre, curv, intr, cfg, weighting=weighting)
    meas = sm.measurement_from_preprocess(pre, curv, frame.rgb, conf)

    # fusion: one z-buffer render per frame, updated in place by fuse
    n_sub = state.active_submaps.shape[0]
    act_cur = state.active_submaps[min(max(state.submap_idx, 0), n_sub - 1)].to(torch.float32)
    idx = sm.render_index(state.map, pose_inv, intr, active=state.map.active)
    m, idx2 = sm.fuse(state.map, meas, pose, idx, intr, cfg, time=time,
                      submap_idx=state.submap_idx, act=act_cur)
    # one extended attr render after fuse, shared by clean and prediction
    attr_ext = sm.render_attr_image(m, idx2, pose_inv, extended=True)
    m, remap = sm.clean_with_remap(m, pose, idx2, intr, cfg, time=time,
                                   attr=attr_ext[..., :sm.ATTR_CHANNELS])

    # prediction: translate the post-fuse render through clean (in pixel
    # space on tombstone frames)
    cp = max(cfg.clean_compact_period, 1)
    cw = max(cfg.clean_crowd_period, 1)
    if cfg.clean_pixel_remap and cp > 1 and cw > 1 and time % cp != 0 and time % cw != 0:
        keep_pix = sm.pixel_keep_mask(attr_ext, cfg, time)
        idx3 = torch.where((idx2 >= 0) & keep_pix, idx2, -1)
    else:
        idx3 = sm.remap_index_map(idx2, remap)
    if cfg.raycast_period > 1 and time % cfg.raycast_period != 0:
        # surfel-splat prediction between the HRBF frames (combinedPredict
        # alternative path): the ray cast kernel is not launched
        pred = raycast.predict_splat(m, pose_inv, idx3, intr, cfg)
    else:
        pred_attr = torch.where((idx3 >= 0)[..., None], attr_ext, 0.0)
        pred = raycast.predict_hrbf(m, pose_inv, idx3, intr, cfg, attr_ext=pred_attr)
    filled = raycast.fill_in(pred, pre.vertex_filtered, pre.normal, pre.radius,
                             frame.rgb, conf, curv.k1, curv.k2, cfg)
    return _state_from_prediction(m, new_R, new_t, time, state.submap_idx, intensity,
                                  filled, state.active_submaps, icp_error, icp_count)


def _sharded(x) -> bool:
    """Whether a state or frame is split over a mesh
    (``parallel.sharding``)."""
    from ..parallel.sharding import is_sharded

    return is_sharded(x)


def track_frame(state: SLAMState, depth_f, pre, curv, intensity,
                intr: CameraIntrinsics, cfg: SLAMConfig) -> odometry.TrackResult:
    """The step's tracking: the frame's pyramids against the state's
    prediction, then ``odometry.track``."""
    inp = odometry.build_inputs(
        next_depth=depth_f, next_intensity=intensity,
        next_vmap=pre.vertex_filtered, next_nmap=pre.normal,
        pred_vmap=state.pred_vertex, pred_nmap=state.pred_normal,
        pred_intensity=state.pred_intensity, icp_weight=state.pred_icp_weight,
        prev_R=state.R, prev_t=state.t, prev_intensity=state.prev_intensity,
        cfg=cfg,
        **({"next_k1": curv.k1, "next_k2": curv.k2,
            "pred_k1": state.pred_k1, "pred_k2": state.pred_k2}
           if cfg.icp_use_correspondence_search else {}),
        **({"sal_k1": curv.k1, "sal_k2": curv.k2} if cfg.tracking_topk > 0 else {}))
    return odometry.track(state.R, state.t, inp, intr, cfg)


def step_many(state: SLAMState, frames, intr: CameraIntrinsics, cfg: SLAMConfig):
    """Step over an iterable of FrameInput.  Returns (final state, list of
    per-frame translations)."""
    ts = []
    for f in frames:
        state = step(state, f, intr, cfg)
        ts.append(state.t)
    return state, ts


def _frames_of(frames):
    """The frames of a stacked FrameInput (leading frame axis; whole or
    split by rows over a mesh), or of an iterable of FrameInput."""
    if isinstance(frames, FrameInput) and len(frames.depth.shape) == 3:
        return [FrameInput(frames.depth[i], frames.rgb[i])
                for i in range(frames.depth.shape[0])]
    return list(frames)


def step_many_traj(state: SLAMState, frames, intr: CameraIntrinsics, cfg: SLAMConfig):
    """Step over a stacked FrameInput (or an iterable of them).  Returns
    (final state, (N,4,4) camera-to-world poses on the device)."""
    poses = []
    for f in _frames_of(frames):
        state = step(state, f, intr, cfg)
        poses.append(lie.rt_to_mat(state.R, state.t))
    return state, torch.stack(poses)


def step_chunk(state: SLAMState, frames, intr: CameraIntrinsics, cfg: SLAMConfig):
    """``step_many_traj`` plus everything the host loop needs in ONE packed
    device vector, read back once per chunk:
      packed = [poses.ravel() (k*16), map.count, last_icp_error,
                last_icp_count, dense_frac]
    Returns (final state, packed (k*16+4,) float32)."""
    state, poses = step_many_traj(state, frames, intr, cfg)
    aux = torch.stack([state.map.count.to(torch.float32), state.last_icp_error,
                       state.last_icp_count, state.dense_frac])
    return state, torch.cat([poses.reshape(-1), aux])


def step_many_replay(state: SLAMState, frames, poses, intr: CameraIntrinsics,
                     cfg: SLAMConfig):
    """Trajectory replay over a stacked FrameInput: tracking is skipped and
    the (N,4,4) camera-to-world ``poses`` are used as they are
    (globalInputLoadTrajectory).  Returns (final state, (N,3) translations)."""
    ts = []
    for f, p in zip(_frames_of(frames), poses):
        state = step(state, f, intr, cfg, fixed_pose=p)
        ts.append(state.t)
    return state, torch.stack(ts)


def ensure_capacity(state: SLAMState, cfg: SLAMConfig, threshold: float = 0.75,
                    count: int | None = None):
    """Double the map's backing array while the live count exceeds
    ``threshold`` of capacity (reads the count on the host unless given).
    Returns (state, cfg) with cfg.map_capacity updated."""
    if count is None:
        count = int(state.map.count)
    cap = cfg.map_capacity
    if count <= threshold * cap:
        return state, cfg
    new_cap = cap
    while count > threshold * new_cap:
        new_cap *= 2
    if _sharded(state):
        from ..parallel import sharded_step

        grown = sharded_step.grow(state.map, new_cap)
    else:
        grown = sm.grow(state.map, new_cap)
    return state._replace(map=grown), dataclasses.replace(cfg, map_capacity=new_cap)


def run_sequence(frames, intr: CameraIntrinsics, cfg: SLAMConfig, init_pose=None,
                 grow: bool = True, input_trajectory=None):
    """Host-side frame loop.  ``frames``: iterable of FrameInput;
    ``input_trajectory``: optional (N,4,4) camera-to-world poses (replay).
    Returns (final state, poses (N,4,4) numpy)."""
    state = None
    poses = []
    for i, f in enumerate(frames):
        if state is None:
            p0 = input_trajectory[0] if input_trajectory is not None else init_pose
            state = bootstrap(f, intr, cfg, p0)
        elif input_trajectory is not None:
            state = step(state, f, intr, cfg, fixed_pose=input_trajectory[i])
        else:
            state = step(state, f, intr, cfg)
        if grow:
            state, cfg = ensure_capacity(state, cfg)
        poses.append(lie.rt_to_mat(state.R, state.t).cpu().numpy())
    return state, np.stack(poses)
