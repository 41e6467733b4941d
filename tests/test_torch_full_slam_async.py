"""The port's ``FullSLAM`` in pipeline-parallel mode
(``tests/test_full_slam.py::test_full_slam_async_ba`` at 128x96, 18 frames
instead of 26 to stay within this file's time budget): keyframe insertion,
local BA and loop closing run on the worker thread, corrections apply at
frame boundaries, the worker produced corrections and ``join_backend``
returns with nothing in flight; the trajectory stays within 3 cm ATE;
``close`` stops the worker thread.
``ba_pad_min=(0, 0, 0)`` as in test_torch_full_slam_loop.py."""

from torch_parity_utils import port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import ate, synth
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

INTR = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96))
CFG = port_cfg(small_test_config(map_capacity=1 << 16, pyramid_iterations=(10, 5, 4),
                                 so3_iterations=10, predict_conf_threshold=0.2,
                                 keyframe_period=8))


def test_full_slam_async_ba():
    n_frames = 18
    gt = synth.orbit_trajectory(n_frames, angle_per_frame=0.004)
    scene = synth.default_room("cpu")
    sys_ = FullSLAM(INTR, CFG, backend_kwargs=dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0)),
                    init_pose=gt[0], async_ba=True, device="cpu")
    for i in range(n_frames):
        sys_.process(tslam.FrameInput(*synth.render_frame(scene, gt[i], INTR)),
                     timestamp=i / 30.0)
    sys_.join_backend()
    err = ate.ate_rmse(sys_.poses(), gt, align=False)
    assert err < 0.03, err
    assert len(sys_.backend.keyframes) >= 3
    assert sys_.async_corrections >= 1
    assert sys_._inflight == 0
    assert [k.kf_id for k in sys_.backend.keyframes] == list(range(sys_._next_kf_id))
    assert sys_.stage_s["w_kf_insert"] > 0 and sys_.stage_s["w_local_ba"] > 0
    sys_.close()
    assert not sys_._worker.is_alive()
