"""The port's ``FullSLAM.process_batch`` against per-frame ``process``
(``tests/test_full_slam_loop.py::test_process_batch_matches_per_frame`` at
128x96): the chunked path (``slam.step_chunk``, the backend at the chunk
boundaries) keeps the same keyframe cadence and frame tagging exactly, and
the poses within 0.03 (the JAX test's bound).  ``ba_pad_min=(0, 0, 0)`` as
in test_torch_full_slam_loop.py."""

import numpy as np
import torch
from torch_parity_utils import n, port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

INTR = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96))
CFG = port_cfg(small_test_config(map_capacity=1 << 16, pyramid_iterations=(10, 5, 4),
                                 so3_iterations=10, predict_conf_threshold=0.2,
                                 keyframe_period=2))
KWARGS = dict(backend_kwargs=dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0)),
              loop_kwargs=dict(min_score=0.05, min_inliers=12, consistency=1), device="cpu")


def test_process_batch_matches_per_frame():
    gt = []
    for i in [0, 1, 2, 3, 2, 1, 0]:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.08 * i, 0.0, 0.0]
        gt.append(T)
    scene = synth.default_room("cpu")
    frames = [synth.render_frame(scene, p, INTR) for p in gt]

    sys_a = FullSLAM(INTR, CFG, init_pose=gt[0], **KWARGS)
    for i, (d, c) in enumerate(frames):
        sys_a.process(tslam.FrameInput(d, c), timestamp=float(i))
    sys_b = FullSLAM(INTR, CFG, init_pose=gt[0], **KWARGS)
    batch = tslam.FrameInput(torch.stack([d for d, _ in frames]),
                             torch.stack([c for _, c in frames]))
    out = sys_b.process_batch(batch, timestamps=[float(i) for i in range(len(gt))])

    assert len(sys_b.trajectory) == len(sys_a.trajectory) == out.shape[0]
    assert len(sys_b.backend.keyframes) == len(sys_a.backend.keyframes) >= 3
    assert ([k.frame_time for k in sys_b.backend.keyframes]
            == [k.frame_time for k in sys_a.backend.keyframes])
    assert sys_b.kf_of_frame == sys_a.kf_of_frame
    assert sys_b.timestamps == sys_a.timestamps
    np.testing.assert_allclose(sys_b.poses(), sys_a.poses(), atol=0.03)
    np.testing.assert_array_equal(out, sys_b.poses())
    assert sys_b.stage_s["dense_scan"] > 0 and sys_b.stage_s["local_ba"] > 0
    assert n(sys_b.state.map.count) > 0
