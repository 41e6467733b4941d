"""Checkpoint / resume of the port's ``FullSLAM`` (``utils/checkpoint.py``),
bit-exact on the CPU (tests/test_checkpoint_params.py's protocol, 64x48):
run A processes 10 frames and is saved after frame 5; a fresh system B
loads that file and processes frames 5-9.  B's poses, map rows, archive,
keyframes, landmarks and counters equal A's bit for bit.  The config runs
the active-window / archive split (``active_capacity``), so the archive is
saved and restored too; keyframes every 3 frames, so the resumed run
inserts keyframes and runs local BA on restored ones.

An async system is joined by ``save``: nothing is in flight in the file.
"""

import dataclasses

import numpy as np
import pytest
from torch_parity_utils import PINTR, n, port_cfg

from hrbffusion3d_tpu.config import small_test_config
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.pipeline import slam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM
from hrbffusion3d_tpu_torch.utils import checkpoint

CFG = port_cfg(small_test_config(map_capacity=1 << 13, pyramid_iterations=(3, 2, 2),
                                 predict_conf_threshold=0.2, keyframe_period=3,
                                 active_capacity=1 << 13))
BACKEND = dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0))
GT = synth.orbit_trajectory(10)


@pytest.fixture(scope="module")
def frames():
    scene = synth.default_room("cpu")
    return [slam.FrameInput(*synth.render_frame(scene, p, PINTR)) for p in GT]


def _system(**kw):
    return FullSLAM(PINTR, CFG, backend_kwargs=BACKEND, init_pose=GT[0], device="cpu", **kw)


def _run(sys_, frames, start, end):
    for i in range(start, end):
        sys_.process(frames[i], timestamp=float(i))


def test_checkpoint_resume_bit_exact(frames, tmp_path):
    p = str(tmp_path / "ckpt.bin")
    a = _system()
    _run(a, frames, 0, 5)
    checkpoint.save(p, a)
    _run(a, frames, 5, 10)

    b = checkpoint.load(p, _system())
    _run(b, frames, 5, 10)

    assert a.archive is not None and int(a.archive.count) > 0
    assert [k.frame_time for k in a.backend.keyframes] == [1, 4, 7, 10]
    np.testing.assert_array_equal(a.poses(), b.poses())
    assert a.timestamps == b.timestamps and a.kf_of_frame == b.kf_of_frame
    for x, y in ((a.state.map, b.state.map), (a.archive, b.archive)):
        np.testing.assert_array_equal(n(x.data), n(y.data))
        assert int(x.count) == int(y.count)
    for f in a.state._fields:
        if f != "map":
            np.testing.assert_array_equal(n(getattr(a.state, f)), n(getattr(b.state, f)), f)
    assert a.cfg == b.cfg
    assert (a._archive_count, a._active_count, a.archive_dropped) == \
        (b._archive_count, b._active_count, b.archive_dropped)
    np.testing.assert_array_equal(a._active_mask_host, b._active_mask_host)
    for ka, kb in zip(a.backend.keyframes, b.backend.keyframes):
        for f, va in dataclasses.asdict(ka).items():
            np.testing.assert_array_equal(va, getattr(kb, f), f)
    assert a.backend.landmarks.keys() == b.backend.landmarks.keys()
    for k, v in a.backend.landmarks.items():
        np.testing.assert_array_equal(v, b.backend.landmarks[k])
    assert a.backend.lm_obs == b.backend.lm_obs
    assert a.loop_closer.loop_edges == b.loop_closer.loop_edges
    assert a.loop_closer._consistent_groups == b.loop_closer._consistent_groups
    for va, vb in zip(a.loop_closer.db.vectors, b.loop_closer.db.vectors):
        np.testing.assert_array_equal(va, vb)


def test_save_joins_the_async_worker(frames, tmp_path):
    p = str(tmp_path / "ckpt.bin")
    a = _system(async_ba=True)
    try:
        _run(a, frames, 0, 5)
        checkpoint.save(p, a)
        assert a._inflight == 0 and a._kf_queue.empty()
        b = checkpoint.load(p, _system())
    finally:
        a.close()
    np.testing.assert_array_equal(b.poses(), a.poses())
    assert len(b.backend.keyframes) == len(a.backend.keyframes) == 2
    with pytest.raises(ValueError, match="no frame"):
        checkpoint.save(p, _system())
