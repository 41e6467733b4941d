"""The port's ``FullSLAM`` with loop closing (``tests/test_full_slam_loop.py``
at 128x96): the replay out-and-back whose return leg drifts past the
projection gate fires a verified loop closure and the correction pulls the
recorded trajectory back; no loop closer without ``use_global_ba``.

The whole-run parity test (``slow``, never part of tier-1: the JAX side
alone takes ~2 minutes on a CPU) runs that replay through JAX's FullSLAM
and the port's on the same frames, with ``ba_pad_min=(0, 0, 0)`` on both:
``kf_of_frame``, the keyframes' frame times and ``loop_closures`` exactly,
the trajectory within 5e-3 m / 5e-3 rad, the final map count within 2 %.

The port-only runs use ``ba_pad_min=(0, 0, 0)`` as well: padding adds only
zero-weight edges and fixed cameras, and the production pre-sizing that
FullSLAM applies by default multiplies the CPU's BA time."""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_cfg, port_intr, rot_angle

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import ate, synth
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
PINTR = port_intr(INTR)
CFG = small_test_config(map_capacity=1 << 16, pyramid_iterations=(10, 5, 4), so3_iterations=10,
                        predict_conf_threshold=0.2, keyframe_period=2)
BACKEND = dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0))
LOOP = dict(min_score=0.05, min_inliers=12, consistency=1)
STEP_XI = (0.11, -0.05, 0.045, 0.014, -0.017, 0.022)


def _out_and_back(n_out=8, step=0.06):
    poses = []
    for i in list(range(n_out)) + list(range(n_out - 2, -1, -1)):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [step * i, 0.0, 0.0]
        poses.append(T)
    return np.stack(poses)


def _replay_inputs():
    """(gt, drifted poses, frames as numpy) of test_loop_closure_fires_in_pipeline."""
    gt = _out_and_back(n_out=6, step=0.12)
    D = np.eye(4, dtype=np.float32)
    drifted = []
    for k in range(gt.shape[0]):
        if k >= gt.shape[0] - 4:   # drift accrues on the return leg
            D = n(tlie.se3_exp(torch.tensor(STEP_XI))) @ D
        drifted.append((D @ gt[k]).astype(np.float32))
    scene = synth.default_room("cpu")
    frames = [tuple(n(a) for a in synth.render_frame(scene, p, PINTR)) for p in gt]
    return gt, np.stack(drifted), frames


def _port_replay(gt, drifted, frames):
    sys_ = FullSLAM(PINTR, port_cfg(CFG), backend_kwargs=BACKEND, loop_kwargs=LOOP,
                    init_pose=gt[0], device="cpu")
    for i, (d, c) in enumerate(frames):
        sys_.process(tslam.FrameInput(torch.from_numpy(d), torch.from_numpy(c)),
                     timestamp=float(i), fixed_pose=drifted[i])
    return sys_


def test_loop_closure_fires_in_pipeline():
    """Frames rendered at GT, fused and keyframed at drifted poses: the
    return leg revisits the start disconnected from it in the covisibility
    graph, so the loop closer must fire, and the correction must cut the
    trajectory error below 0.7 of the drifted one."""
    gt, drifted, frames = _replay_inputs()
    sys_ = _port_replay(gt, drifted, frames)
    assert len(sys_.loop_closures) >= 1, "no loop closure detected"
    err_in = ate.ate_rmse(drifted, gt, align=False)
    err_out = ate.ate_rmse(sys_.poses(), gt, align=False)
    assert err_in > 0.10, err_in
    assert err_out < 0.7 * err_in, (err_in, err_out)


def test_no_loop_without_global_ba():
    """Without use_global_ba there is no loop closer; the keyframe path
    runs without one (the first 3 frames of the JAX test's 7: keyframes at
    frames 0 and 2)."""
    cfg = port_cfg(dataclasses.replace(CFG, use_global_ba=False))
    gt = _out_and_back(4)[:3]
    scene = synth.default_room("cpu")
    sys_ = FullSLAM(PINTR, cfg, backend_kwargs=BACKEND, init_pose=gt[0], device="cpu")
    for p in gt:
        sys_.process(tslam.FrameInput(*synth.render_frame(scene, p, PINTR)))
    assert sys_.loop_closer is None
    assert len(sys_.backend.keyframes) == 2
    assert len(sys_.loop_closures) == 0


@pytest.mark.slow
def test_replay_matches_jax_full_slam():
    """The whole replay run through JAX's FullSLAM and the port's."""
    import jax.numpy as jnp

    from hrbffusion3d_tpu.pipeline import slam as jslam
    from hrbffusion3d_tpu.pipeline.full_slam import FullSLAM as JaxFullSLAM

    gt, drifted, frames = _replay_inputs()
    ps = _port_replay(gt, drifted, frames)
    js = JaxFullSLAM(INTR, CFG, backend_kwargs=BACKEND, loop_kwargs=LOOP, init_pose=gt[0])
    for i, (d, c) in enumerate(frames):
        js.process(jslam.FrameInput(depth=jnp.asarray(d), rgb=jnp.asarray(c)),
                   timestamp=float(i), fixed_pose=drifted[i])
    assert ps.kf_of_frame == js.kf_of_frame
    assert [k.frame_time for k in ps.backend.keyframes] == \
        [k.frame_time for k in js.backend.keyframes]
    assert ps.loop_closures == js.loop_closures and ps.loop_closures
    pt, pj = ps.poses(), js.poses()
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=5e-3)
    assert max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(pt, pj)) < 5e-3
    ct, cj = int(ps.state.map.count), int(js.state.map.count)
    assert abs(ct - cj) <= 0.02 * cj, (ct, cj)
