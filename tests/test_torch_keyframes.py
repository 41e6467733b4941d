"""Parity of the port's ``SparseBackend`` (``backend/keyframes.py``) with the
JAX package's, on the frames of ``tests/test_keyframes.py``: 128x96
keyframes at frames 1, 11, 21 and 31 of ``orbit_trajectory(40)``, the last
inserted with its pose drifted by se3_exp([0.06, -0.05, 0.04, 0.01, -0.015,
0.012]), then one local BA over a window of 4.

Tolerances: each keyframe's detection (four pyramid levels) equal to
JAX's: the same valid keypoints at the same pixels of their levels, every
descriptor bit equal (chip_smoke.py's card rule is >= 99 % and >= 99.5 %);
the same number of keyframes; landmark and shared-landmark counts within
2 %; local-BA deltas within 5e-3 m / 5e-3 rad of JAX's; the
drift corrected as ``tests/test_keyframes.py`` asserts (before > 0.05 m,
after < 0.55 before).  The JAX backend runs once for the file (its
detector's compile is most of the file's time)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_cfg, port_intr, rot_angle, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.backend import keyframes as jkf
from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.backend import keyframes as tkf
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
CFG = small_test_config()
PINTR = port_intr(INTR)
TIMES = (1, 11, 21, 31)
DRIFT = (0.06, -0.05, 0.04, 0.01, -0.015, 0.012)


@pytest.fixture(scope="module")
def runs():
    """(JAX backend, port backend, JAX deltas, port deltas, gt pose of the
    drifted keyframe, its position error before BA) after the same
    inserts and one local BA each."""
    scene = synth.default_room("cpu")
    poses = synth.orbit_trajectory(40)
    drift = n(tlie.se3_exp(torch.tensor(DRIFT)))
    frames = []
    for k, time in enumerate(TIMES):
        d, rgb = synth.render_frame(scene, poses[time - 1], PINTR)
        est = poses[time - 1] if k < 3 else (drift @ poses[time - 1]).astype(np.float32)
        frames.append((n(d), n(pyramid.rgb_to_intensity(rgb)), est, time))
    bj = jkf.SparseBackend(INTR, CFG, fast_threshold=8.0, local_window=4)
    bt = tkf.SparseBackend(PINTR, port_cfg(CFG), fast_threshold=8.0, local_window=4,
                           device="cpu")
    for d, i, est, time in frames:
        bj.insert_keyframe(jnp.asarray(i), jnp.asarray(d), est, time=time)
        bt.insert_keyframe(t(i), t(d), est, time=time)
    gt = poses[TIMES[-1] - 1]
    before = np.linalg.norm(bt.keyframes[3].pose[:3, 3] - gt[:3, 3])
    return bj, bt, bj.local_ba(), bt.local_ba(), gt, before


def test_keyframes_and_landmarks(runs):
    bj, bt, *_ = runs
    assert len(bt.keyframes) == len(bj.keyframes) == len(TIMES)
    assert abs(len(bt.landmarks) - len(bj.landmarks)) <= 0.02 * len(bj.landmarks)
    shared_j = sum(len(o) >= 2 for o in bj.lm_obs.values())
    shared_t = sum(len(o) >= 2 for o in bt.lm_obs.values())
    assert shared_j > 20
    assert abs(shared_t - shared_j) <= 0.02 * shared_j
    for kj, kt in zip(bj.keyframes, bt.keyframes):
        assert kt.desc.dtype == np.uint32
        assert kt.kf_id == kj.kf_id and kt.frame_time == kj.frame_time


def test_keyframe_detection_matches_jax(runs):
    bj, bt, *_ = runs
    for kj, kt in zip(bj.keyframes, bt.keyframes):
        v = kj.kp_valid
        assert v.sum() > 50
        np.testing.assert_array_equal(kt.kp_valid, v)
        np.testing.assert_array_equal(kt.kp_level, kj.kp_level)
        scale = 1.5 ** kj.kp_level[:, None]
        np.testing.assert_array_equal(np.round(kt.kp_xy / scale)[v], np.round(kj.kp_xy / scale)[v])
        np.testing.assert_allclose(kt.kp_xy[v], kj.kp_xy[v], atol=1e-4)
        bits_t = np.unpackbits(kt.desc.view(np.uint8), axis=-1)
        bits_j = np.unpackbits(np.asarray(kj.desc).view(np.uint8), axis=-1)
        np.testing.assert_array_equal(bits_t[v], bits_j[v])


def test_local_ba_deltas_and_drift(runs):
    _, bt, dj, dt, gt, before = runs
    assert dj is not None and dt is not None and dt.shape == dj.shape
    np.testing.assert_allclose(dt[:, :3, 3], dj[:, :3, 3], atol=5e-3)
    for a, b in zip(dt, dj):
        assert rot_angle(a[:3, :3], b[:3, :3]) < 5e-3
    after = np.linalg.norm(bt.keyframes[3].pose[:3, 3] - gt[:3, 3])
    assert before > 0.05
    assert after < 0.55 * before, (before, after)
    np.testing.assert_allclose(dt[0], np.eye(4), atol=1e-5)
    assert np.linalg.norm(dt[3][:3, 3]) > 0.005


def test_covisibility_mask_and_trajectory(runs):
    bj, bt, *_ = runs
    for k in range(len(TIMES)):
        assert bt.covisible_keyframes(k, min_shared=5) == bj.covisible_keyframes(k, min_shared=5)
        np.testing.assert_array_equal(bt.active_submap_mask(k, 10), bj.active_submap_mask(k, 10))
    (tt, pt), (tj, pj) = bt.keyframe_trajectory(), bj.keyframe_trajectory()
    assert tt == tj
    np.testing.assert_allclose(pt, pj, atol=5e-3)
    assert bt.need_new_keyframe(41) == bj.need_new_keyframe(41)
    assert bt.need_new_keyframe(35) == bj.need_new_keyframe(35)


def test_host_hamming_matches_jax(runs):
    bj, bt, *_ = runs
    a, b = bt.keyframes[0].desc, bt.keyframes[1].desc
    np.testing.assert_array_equal(tkf._hamming(a, b), jkf._hamming(a, b))


def test_parametric_information(runs):
    """``use_patch_covariance=False``: edge_info is ba.depth_information of
    the keypoint (held to JAX's in test_torch_ba.py)."""
    from hrbffusion3d_tpu_torch.backend import ba as tba

    _, bt, *_ = runs
    kf = bt.keyframes[1]
    i = int(np.flatnonzero(kf.kp_valid)[0])
    kf_no_info = tkf.Keyframe(**{**kf.__dict__, "kp_info": None})
    ref = tba.depth_information(t(kf.kp_cam[i:i + 1].astype(np.float32)), PINTR.fx, PINTR.fy)
    np.testing.assert_array_equal(bt.edge_info(kf_no_info, i), n(ref)[0])


def test_mesh_and_missing_card_raise():
    """A mesh that is not the port's (a JAX one, say) is refused."""
    with pytest.raises(TypeError, match="parallel.sharding.Mesh"):
        tkf.SparseBackend(PINTR, port_cfg(CFG), mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkf.SparseBackend(PINTR, port_cfg(CFG))


@pytest.mark.cuda
def test_backend_on_card_matches_cpu(runs):
    """On the card: the same inserts and local BA against the port on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    _, bt, _, dt, gt, _ = runs
    scene = synth.default_room("cpu")
    poses = synth.orbit_trajectory(40)
    drift = n(tlie.se3_exp(torch.tensor(DRIFT)))
    bg = tkf.SparseBackend(PINTR, port_cfg(CFG), fast_threshold=8.0, local_window=4)
    for k, time in enumerate(TIMES):
        d, rgb = synth.render_frame(scene, poses[time - 1], PINTR)
        est = poses[time - 1] if k < 3 else (drift @ poses[time - 1]).astype(np.float32)
        bg.insert_keyframe(pyramid.rgb_to_intensity(rgb).cuda(), d.cuda(), est, time=time)
    dg = bg.local_ba()
    assert len(bg.keyframes) == len(bt.keyframes)
    np.testing.assert_allclose(dg[:, :3, 3], dt[:, :3, 3], atol=5e-3)
