"""``tests/test_loop.py::test_two_loops_sequential_correction``'s
assertions on the port's loop closer (``backend/loop.py``) alone, at
128x96 on the CPU: two out-and-back excursions, drift injected on each
return leg, each closure corrected by the pose graph."""

import numpy as np
import torch
from torch_parity_utils import n, port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.backend import keyframes as tkf
from hrbffusion3d_tpu_torch.backend import loop as tloop
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid

INTR = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96))
CFG = port_cfg(small_test_config())


def test_two_loops_sequential_correction():
    """test_loop.py::test_two_loops_sequential_correction on the port: two
    out-and-back excursions with drift on each return leg, each closure
    (pose graph only) reduces the revisiting keyframe's error, the second
    keeps the first loop's edge, and the whole trajectory ends near GT."""
    bt = tkf.SparseBackend(INTR, CFG, fast_threshold=8.0, device="cpu")
    lc = tloop.LoopCloser(bt, min_score=0.05, min_inliers=15, consistency=1)
    scene = synth.default_room("cpu")
    steps = [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0]
    gt = []
    for s in steps:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.25 * s, 0.0, 0.0]
        gt.append(T)
    step1 = n(tlie.se3_exp(torch.tensor([0.15, -0.07, 0.06, 0.018, -0.022, 0.028])))
    step2 = n(tlie.se3_exp(torch.tensor([-0.13, 0.09, -0.07, -0.020, 0.018, -0.026])))
    D = np.eye(4, dtype=np.float32)
    for k, gt_pose in enumerate(gt):
        if 4 <= k <= 5:
            D = step1 @ D
        elif 10 <= k <= 11:
            D = step2 @ D
        est = (D @ gt_pose).astype(np.float32)
        d, rgb = synth.render_frame(scene, gt_pose, INTR)
        kf_id = bt.insert_keyframe(pyramid.rgb_to_intensity(rgb), d, est, time=k * 10 + 1)
        cand = lc.add_keyframe(kf_id)
        if cand is not None:
            before = np.linalg.norm(bt.keyframes[kf_id].pose[:3, 3] - gt_pose[:3, 3])
            lc.correct(cand, run_global_ba=False)
            after = np.linalg.norm(bt.keyframes[kf_id].pose[:3, 3] - gt_pose[:3, 3])
            if before > 0.02:
                assert after < before, (k, before, after)
            D = (bt.keyframes[kf_id].pose @ np.linalg.inv(gt_pose)).astype(np.float32)
    assert len(lc.loop_edges) >= 2, "second loop closure never fired"
    final_err = max(np.linalg.norm(bt.keyframes[k].pose[:3, 3] - gt[k][:3, 3])
                    for k in range(len(gt)))
    assert final_err < 0.15, final_err
