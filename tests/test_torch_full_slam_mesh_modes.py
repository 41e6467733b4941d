"""``FullSLAM(mesh=)`` in each of its modes with the dense state sharded: the
synchronous per-frame ``process`` and the async keyframe worker through
``process_batch``, both with the active-window / archive split (its
exchange gathers only the rows that leave for the archive) on a 3-shard CPU
mesh at 128x96; every dense step is the row-sharded one and the state
stays sharded; a checkpoint of the sharded system resumes sharded and bit
for bit; ``full_map`` is the gathered map.  ATE under 5 cm is a sanity
bound only (the protocol is chaotic at this size, see
``test_torch_full_slam_mesh.py``)."""

import numpy as np
import pytest
import torch

from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import ate, synth
from hrbffusion3d_tpu_torch.parallel import sharded_step, sharding
from hrbffusion3d_tpu_torch.pipeline import slam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM
from hrbffusion3d_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
CFG = small_test_config(map_capacity=1 << 13, pyramid_iterations=(4, 3, 2), so3_iterations=4,
                        predict_conf_threshold=0.2, keyframe_period=3,
                        active_capacity=1 << 13, archive_capacity=1 << 14)
N = 7


@pytest.fixture(scope="module")
def frames():
    gt = synth.orbit_trajectory(N, angle_per_frame=0.004)
    room = synth.default_room("cpu")
    return gt, [synth.render_frame(room, p, INTR) for p in gt]


@pytest.mark.parametrize("mode", ["process", "async_batch"])
def test_modes_on_a_mesh(frames, mode, tmp_path, monkeypatch):
    gt, fr = frames
    steps, exchanges = [], []
    step, exchange = sharded_step.step, sharded_step.exchange_active
    monkeypatch.setattr(sharded_step, "step", lambda *a, **k: steps.append(1) or step(*a, **k))
    monkeypatch.setattr(sharded_step, "exchange_active",
                        lambda *a, **k: exchanges.append(1) or exchange(*a, **k))
    mesh = sharding.make_mesh(3, devices=["cpu"])
    sys_ = FullSLAM(INTR, CFG, init_pose=gt[0], mesh=mesh, async_ba=mode == "async_batch",
                    backend_kwargs=dict(fast_threshold=8.0), device="cpu")
    if mode == "process":
        for i, (d, c) in enumerate(fr):
            sys_.process(slam.FrameInput(d, c), timestamp=float(i))
    else:
        sys_.process_batch(slam.FrameInput(torch.stack([d for d, _ in fr]),
                                           torch.stack([c for _, c in fr])))
        sys_.close()
    assert len(steps) == N - 1 and len(exchanges) >= 1
    assert sharding.is_sharded(sys_.state) and len(sys_.state.map.data.parts) == 3
    assert len(sys_.backend.keyframes) >= 2
    poses = sys_.poses()
    assert poses.shape == (N, 4, 4) and np.isfinite(poses).all()
    assert ate.ate_rmse(poses, gt, align=False) < 0.05

    whole = sharding.gather_state(sys_.state)
    m = sys_.full_map()
    assert int(m.count) == int(whole.map.count)
    assert torch.equal(m.data[:int(m.count)], whole.map.data[:int(m.count)])
    path = str(tmp_path / "run.ckpt")
    checkpoint.save(path, sys_)
    resumed = checkpoint.load(path, FullSLAM(INTR, CFG, init_pose=gt[0], mesh=mesh,
                                             backend_kwargs=dict(fast_threshold=8.0),
                                             device="cpu"))
    assert sharding.is_sharded(resumed.state)
    back = sharding.gather_state(resumed.state)
    for name in slam.SLAMState._fields:
        a, b = getattr(whole, name), getattr(back, name)
        if name == "map":
            assert torch.equal(a.data, b.data) and torch.equal(a.count, b.count)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name
