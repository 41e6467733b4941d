"""The port's synchronous ``FullSLAM`` on a tracked orbit
(``tests/test_full_slam.py`` at 128x96, 18 frames instead of 26 to stay
within this file's time budget; 18 is test_full_slam.py:61's length):
dense tracking, keyframes, local BA and the dense-map corrections keep the
trajectory within 3 cm ATE, keyframes follow the cadence, the TUM and PLY
exports round-trip, and after the corrections the map still predicts the
rendered depth.  ``ba_pad_min=(0, 0, 0)`` as in
test_torch_full_slam_loop.py."""

import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import ate, synth
from hrbffusion3d_tpu_torch.io import ply, traj
from hrbffusion3d_tpu_torch.map import surfel_map as tsm
from hrbffusion3d_tpu_torch.ops import raycast
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

INTR = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96))
CFG = port_cfg(small_test_config(map_capacity=1 << 16, pyramid_iterations=(10, 5, 4),
                                 so3_iterations=10, predict_conf_threshold=0.2,
                                 keyframe_period=8))
N_FRAMES = 18


@pytest.fixture(scope="module")
def run():
    gt = synth.orbit_trajectory(N_FRAMES, angle_per_frame=0.004)
    scene = synth.default_room("cpu")
    sys_ = FullSLAM(INTR, CFG, backend_kwargs=dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0)),
                    init_pose=gt[0], device="cpu")
    for i in range(N_FRAMES):
        sys_.process(tslam.FrameInput(*synth.render_frame(scene, gt[i], INTR)),
                     timestamp=i / 30.0)
    return sys_, gt, scene


def test_full_slam_with_ba(run, tmp_path):
    sys_, gt, _ = run
    err = ate.ate_rmse(sys_.poses(), gt, align=False)
    assert err < 0.030, err
    assert len(sys_.backend.keyframes) >= 3
    assert [k.frame_time for k in sys_.backend.keyframes] == [1, 9, 17]
    tum = str(tmp_path / "traj.freiburg")
    sys_.save_trajectory_tum(tum)
    ts, poses = traj.load_tum(tum)
    assert poses.shape[0] == N_FRAMES
    np.testing.assert_allclose(poses, sys_.poses(), atol=1e-5)
    np.testing.assert_allclose(ts, np.arange(N_FRAMES) / 30.0, atol=1e-6)
    ply_path = str(tmp_path / "map.ply")
    n_pts = sys_.save_map_ply(ply_path)
    assert n_pts > 3000
    pts = ply.load_ply_positions(ply_path)
    live = n(sys_.state.map.data)[:int(sys_.state.map.count)]
    np.testing.assert_array_equal(pts, live[:, tsm.POS])


def test_full_slam_dense_map_follows_correction(run):
    """After the BA corrections the surfels stay registered to the scene:
    predicting from the final pose matches the rendered depth."""
    sys_, gt, scene = run
    state = sys_.state
    pose = n(torch.linalg.inv(torch.from_numpy(sys_.poses()[-1].astype(np.float32))))
    d_render, _ = synth.render_frame(scene, sys_.poses()[-1], INTR)
    idx = tsm.render_index(state.map, torch.from_numpy(pose), INTR)
    pred = raycast.predict_hrbf(state.map, torch.from_numpy(pose), idx, INTR, CFG)
    found = n(pred.found)
    d = n(d_render)
    mask = found & (d > 0.3)
    err = np.abs(n(pred.vertex[..., 2]) - d)[mask]
    assert mask.sum() > 1000 and np.median(err) < 0.02, np.median(err)
