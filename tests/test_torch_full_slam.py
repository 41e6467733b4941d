"""Parity of the port's ``FullSLAM`` (``pipeline/full_slam.py``) keyframe
boundary with the JAX package's: ``_apply_correction`` (the O(changed)
dense-map, pose and trajectory correction) and ``_refresh_active`` (the
activity-channel refresh, or the active <-> archive exchange).

The JAX system is not bootstrapped: its state is built from the port's
(numpy -> jnp), so both corrections start from the same map, pose and
history.  Setups: ``tests/test_corrections.py``'s (64x48, no backend) and
``tests/test_active_archive.py``'s forced deactivation, here after a
5-frame 64x48 replay with a keyframe every 2 frames.

Tolerances: map rows and the trajectory rewrite within 1e-6; counts,
``archive_dropped``, the activity masks and the host mirrors exactly.
Whole-run behaviour is held in test_torch_full_slam_{loop,batch,run,async}.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu.pipeline import full_slam as jfs
from hrbffusion3d_tpu.pipeline import slam as jslam
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.map import surfel_map as tsm
from hrbffusion3d_tpu_torch.pipeline import full_slam as tfs
from hrbffusion3d_tpu_torch.pipeline import slam as tslam

INTR = CameraIntrinsics(fx=52.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
PINTR = port_intr(INTR)
# tests/test_corrections.py's configuration
CFG = small_test_config(map_capacity=1 << 13, new_surfels_capacity=1 << 10,
                        use_local_ba=False, predict_conf_threshold=0.2)
# with the backend: a keyframe every 2 frames
CFG_KF = dataclasses.replace(CFG, use_local_ba=True, keyframe_period=2)
POSES = synth.orbit_trajectory(5, angle_per_frame=0.01)
SCENE = synth.default_room("cpu")


def _frame(i):
    return tslam.FrameInput(*synth.render_frame(SCENE, POSES[i], PINTR))


def _port_system(cfg, n_frames):
    ps = tfs.FullSLAM(PINTR, port_cfg(cfg), backend_kwargs=dict(fast_threshold=8.0,
                                                                 ba_pad_min=(0, 0, 0)),
                      init_pose=POSES[0], device="cpu")
    for i in range(n_frames):
        ps.process(_frame(i), timestamp=float(i), fixed_pose=POSES[i])
    return ps


def _jmap(m):
    return None if m is None else jsm.SurfelMap(data=jnp.asarray(n(m.data)),
                                                count=jnp.int32(int(m.count)))


def _jax_system(ps, cfg):
    """A JAX FullSLAM holding the port system's state and history."""
    js = jfs.FullSLAM(INTR, cfg, init_pose=POSES[0])
    fields = {}
    for name, x in ps.state._asdict().items():
        if name == "map":
            fields[name] = _jmap(x)
        elif name in ("time", "submap_idx"):
            fields[name] = jnp.int32(x)
        else:
            fields[name] = jnp.asarray(n(x))
    js.state = jslam.SLAMState(**fields)
    js._time_host, js._submap_host = ps.state.time, ps.state.submap_idx
    js.trajectory = [p.copy() for p in ps.trajectory]
    js.kf_of_frame = list(ps.kf_of_frame)
    js.archive = _jmap(ps.archive)
    js._archive_count, js._active_count = ps._archive_count, ps._active_count
    js.archive_dropped = ps.archive_dropped
    js._active_mask_host = None if ps._active_mask_host is None else ps._active_mask_host.copy()
    return js


def _assert_same(ps, js, atol=1e-6):
    for a, b in ((ps.state.map, js.state.map), (ps.archive, js.archive)):
        assert (a is None) == (b is None)
        if a is not None:
            assert int(a.count) == int(b.count)
            np.testing.assert_allclose(n(a.data), np.asarray(b.data), atol=atol)
    np.testing.assert_allclose(np.stack(ps.trajectory), np.stack(js.trajectory), atol=atol)
    np.testing.assert_allclose(n(ps.state.R), np.asarray(js.state.R), atol=atol)
    np.testing.assert_allclose(n(ps.state.t), np.asarray(js.state.t), atol=atol)
    np.testing.assert_array_equal(n(ps.state.active_submaps), np.asarray(js.state.active_submaps))
    assert (ps.archive_dropped, ps._archive_count, ps._active_count) == \
        (js.archive_dropped, js._archive_count, js._active_count)


def _delta(tx):
    d = np.eye(4, dtype=np.float32)
    d[0, 3] = tx
    return d


def _toy_archive(n_rows=64, submap=5, cap=256):
    data = np.zeros((cap, jsm.N_CHANNELS), np.float32)
    data[:n_rows, 0:3] = np.arange(3 * n_rows).reshape(n_rows, 3) * 0.01
    data[:n_rows, jsm.SUBMAP] = submap
    data[:n_rows, jsm.CONF] = 50.0
    data[:n_rows, jsm.VALID] = 1.0
    return tsm.SurfelMap(data=torch.from_numpy(data), count=torch.tensor(n_rows, dtype=torch.int32))


@pytest.mark.parametrize("case", ["identity", "trajectory", "archive_skipped", "archive_moved"])
def test_apply_correction_matches_jax(case):
    """test_corrections.py's four cases on both systems: identity deltas
    change nothing; the vectorized trajectory rewrite over a synthetic
    12-frame history; the archive pass skipped when only covisible submaps
    move, run when an archived one does.  The port system is
    test_corrections.py::_boot's: one frame, no backend."""
    ps = _port_system(CFG, 1)
    eye = np.eye(4, dtype=np.float32)
    if case == "identity":
        deltas, kf = np.tile(eye, (4, 1, 1)), 0
    elif case == "trajectory":
        rng = np.random.default_rng(3)
        ps.trajectory = []
        for _ in range(12):
            p = np.asarray(np.eye(4) + 0.01 * rng.standard_normal((4, 4)), np.float32)
            p[3] = [0, 0, 0, 1]
            ps.trajectory.append(p)
        ps.kf_of_frame = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
        deltas, kf = np.stack([eye, _delta(0.05), eye, _delta(-0.02)]), 3
    else:
        ps.archive = _toy_archive()
        ps._archive_count = 64
        mask = np.zeros(CFG.max_submaps, bool)
        mask[:3] = True
        ps._active_mask_host = mask
        if case == "archive_skipped":
            deltas, kf = np.stack([eye, _delta(0.05), eye]), 1
        else:
            deltas, kf = np.tile(eye, (6, 1, 1)), 1
            deltas[5] = _delta(0.1)
    js = _jax_system(ps, CFG)
    before = (n(ps.state.map.data).copy(), None if ps.archive is None else n(ps.archive.data).copy())
    ps._apply_correction(deltas, current_kf=kf)
    js._apply_correction(deltas, current_kf=kf)
    _assert_same(ps, js)
    if case == "identity":
        np.testing.assert_array_equal(n(ps.state.map.data), before[0])
    if case == "archive_skipped":
        np.testing.assert_array_equal(n(ps.archive.data), before[1])
    if case == "archive_moved":
        np.testing.assert_allclose(n(ps.archive.data)[:64, 0], before[1][:64, 0] + 0.1, atol=1e-6)


@pytest.fixture(params=["act_channel", "archive"])
def keyframed(request):
    """(JAX config, port system) after a 5-frame replay with a keyframe
    every 2 frames, in single-map mode or with the active/archive split."""
    cfg = CFG_KF if request.param == "act_channel" else dataclasses.replace(
        CFG_KF, active_capacity=CFG_KF.map_capacity)
    return cfg, _port_system(cfg, 5)


def test_forced_deactivation_matches_jax(keyframed):
    """test_active_archive.py's forced deactivation: every submap but the
    current one leaves the covisible set.  The activity channel (single
    map) or the exchange (split) gives JAX's map, archive, counts and
    mirrors; then a correction of every submap gives JAX's again."""
    cfg, ps = keyframed
    assert ps.state.submap_idx == len(ps.backend.keyframes) - 1 >= 2
    js = _jax_system(ps, cfg)
    _assert_same(ps, js)
    mask = np.zeros(cfg.max_submaps, bool)
    mask[ps.state.submap_idx] = True
    ps._refresh_active(mask)
    js._refresh_active(mask)
    _assert_same(ps, js)
    if cfg.active_capacity > 0:
        assert ps._archive_count > 0 and ps.archive_dropped == 0
        full = ps.full_map()
        assert int(full.count) == int(ps.state.map.count) + ps._archive_count
    rng = np.random.default_rng(7)
    deltas = np.tile(np.eye(4, dtype=np.float32), (len(ps.backend.keyframes), 1, 1))
    deltas[:, :3, 3] = 0.01 * rng.standard_normal((len(deltas), 3))
    ps._apply_correction(deltas, current_kf=ps.state.submap_idx)
    js._apply_correction(deltas, current_kf=int(js._submap_host))
    _assert_same(ps, js)
    # the dense step runs on the shrunken active map (port)
    ps.process(_frame(4), timestamp=5.0, fixed_pose=POSES[4])
    assert np.isfinite(n(ps.state.t)).all() and int(ps.state.map.count) > 0


def test_device_and_mesh():
    """No card and no device: FullSLAM raises (no fall-back to the CPU);
    a mesh that is not the port's (a JAX one, say) is refused."""
    with pytest.raises(TypeError, match="parallel.sharding.Mesh"):
        tfs.FullSLAM(PINTR, port_cfg(CFG), mesh=object(), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfs.FullSLAM(PINTR, port_cfg(CFG))
