"""Parity of the port's loop closer (``backend/loop.py``) with the JAX
package's, on ``tests/test_loop.py``'s scenes at 128x96.

The JAX detector is not run: one port ``SparseBackend`` (CPU) inserts the
keyframes, and after each insert its state (keyframes, landmarks, their
observations, the next landmark id) is mirrored field for field into a JAX
``SparseBackend``; then both closers see the same keyframe graph.

Tolerances: Horn alignment atol 1e-5 (``test_loop_edge_convention``'s);
the keyframes at which a loop fires (consistency 1 and 2), ``match_kf`` and
``n_inliers`` exactly, ``score`` within 1e-5 and ``rel_pose`` within 1e-4;
the essential graph's edge set exactly; ``correct``'s deltas and corrected
poses within 5e-3 m / 5e-3 rad (the local-BA tolerance of
test_torch_keyframes.py).  ``test_two_loops_sequential_correction``'s
assertions run on the port alone in test_torch_loop_sequential.py."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_cfg, port_intr, rot_angle
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.backend import keyframes as jkf
from hrbffusion3d_tpu.backend import loop as jloop
from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.backend import keyframes as tkf
from hrbffusion3d_tpu_torch.backend import loop as tloop
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
CFG = small_test_config()
PINTR = port_intr(INTR)
LOOP_ARGS = dict(min_score=0.05, min_inliers=15)
DRIFT = (0.25, -0.12, 0.10, 0.03, -0.04, 0.05)
N_OUT = 4
SCENE = synth.default_room("cpu")


def _frame(pose):
    d, rgb = synth.render_frame(SCENE, pose, PINTR)
    return pyramid.rgb_to_intensity(rgb), d


def _out_and_back(n_out):
    poses = []
    for i in list(range(n_out)) + list(range(n_out - 2, -1, -1)):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.25 * i, 0.0, 0.0]
        poses.append(T)
    return poses


def _mirror(bt, bj):
    """The port backend's keyframe graph into the JAX backend."""
    bj.keyframes = [jkf.Keyframe(**{f.name: copy.deepcopy(getattr(k, f.name))
                                    for f in dataclasses.fields(k)}) for k in bt.keyframes]
    bj.landmarks = {lid: x.copy() for lid, x in bt.landmarks.items()}
    bj.lm_obs = {lid: list(o) for lid, o in bt.lm_obs.items()}
    bj._next_lm = bt._next_lm


def _new_backends():
    return (tkf.SparseBackend(PINTR, port_cfg(CFG), fast_threshold=8.0, device="cpu"),
            jkf.SparseBackend(INTR, CFG, fast_threshold=8.0))


def _assert_same_candidate(ct, cj):
    assert (ct is None) == (cj is None)
    if ct is None:
        return
    assert (ct.query_kf, ct.match_kf, ct.n_inliers) == (cj.query_kf, cj.match_kf, cj.n_inliers)
    assert abs(ct.score - cj.score) <= 1e-5
    np.testing.assert_allclose(ct.rel_pose, cj.rel_pose, atol=1e-4)


def test_horn_and_edge_convention():
    """robust_se3_3d3d(p_query, p_match) = pose_match^-1 pose_query
    (test_loop_edge_convention), equal to JAX's."""
    rng = np.random.default_rng(1)
    pose_q = n(tlie.se3_exp(torch.tensor([0.3, -0.1, 0.2, 0.1, 0.2, -0.05])))
    pose_m = n(tlie.se3_exp(torch.tensor([-0.2, 0.4, 0.0, -0.1, 0.05, 0.1])))
    X = rng.uniform(-1, 1, (50, 3)).astype(np.float64)
    X[:, 2] += 3
    p_q = (X - pose_q[:3, 3]) @ pose_q[:3, :3]
    p_m = (X - pose_m[:3, 3]) @ pose_m[:3, :3]
    T, k = tloop.robust_se3_3d3d(p_q, p_m)
    assert k == 50
    np.testing.assert_allclose(T, np.linalg.inv(pose_m) @ pose_q, atol=1e-5)
    Tj, kj = jloop.robust_se3_3d3d(p_q, p_m)
    assert kj == k
    np.testing.assert_allclose(T, Tj, atol=1e-5)
    for a, b in zip(tloop.horn_se3(p_q, p_m), jloop.horn_se3(p_q, p_m)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.fixture(scope="module")
def sequence():
    """test_loop.py::_run_sequence (n_out 4, the return leg drifted) with
    consistency 1 and 2 on both sides; returns the backends at the end,
    the keyframes at which each fired and the last consistency-1
    candidates."""
    bt, bj = _new_backends()
    closers = {c: (tloop.LoopCloser(bt, consistency=c, **LOOP_ARGS),
                   jloop.LoopCloser(bj, consistency=c, **LOOP_ARGS)) for c in (1, 2)}
    drift = n(tlie.se3_exp(torch.tensor(DRIFT)))
    fired = {1: [], 2: []}
    last = {}
    for k, gt_pose in enumerate(_out_and_back(N_OUT)):
        est = gt_pose if k < N_OUT else (drift @ gt_pose).astype(np.float32)
        kf_id = bt.insert_keyframe(*_frame(gt_pose), est, time=k * 10 + 1)
        _mirror(bt, bj)
        for c, (tc, jc) in closers.items():
            ct, cj = tc.add_keyframe(kf_id), jc.add_keyframe(kf_id)
            _assert_same_candidate(ct, cj)
            if ct is not None:
                fired[c].append(k)
                if c == 1:
                    last = dict(port=ct, jax=cj)
    return bt, fired, last


def test_detection_and_consistency_gate(sequence):
    """The same keyframes fire on both sides (compared candidate by
    candidate in the fixture); consistency 2 fires later than 1
    (test_consistency_gate_delays_detection)."""
    _, fired, last = sequence
    assert fired[1] and fired[2], fired
    assert fired[2][0] > fired[1][0], fired
    assert last["port"].match_kf == 0


def test_correct_matches_jax(sequence):
    """The last consistency-1 closure corrected on copies of the final
    graph: the same essential-graph edges, deltas and corrected poses
    within 5e-3 m / 5e-3 rad, the drifted keyframe pulled back."""
    bt, _, last = sequence
    bt = copy.deepcopy(bt)
    bj = jkf.SparseBackend(INTR, CFG, fast_threshold=8.0)
    _mirror(bt, bj)
    tc, jc = tloop.LoopCloser(bt, **LOOP_ARGS), jloop.LoopCloser(bj, **LOOP_ARGS)
    ct, cj = last["port"], last["jax"]
    old = np.stack([kf.pose for kf in bt.keyframes])
    et, ej = tc._essential_edges(ct, old), jc._essential_edges(cj, old)
    assert list(et) == list(ej)
    for key in et:
        np.testing.assert_allclose(et[key], ej[key], atol=1e-4)
    gt_last = _out_and_back(N_OUT)[ct.query_kf]
    before = np.linalg.norm(bt.keyframes[ct.query_kf].pose[:3, 3] - gt_last[:3, 3])
    dt, dj = tc.correct(ct), jc.correct(cj)
    assert dt.shape == dj.shape == (len(bt.keyframes), 4, 4)
    np.testing.assert_allclose(dt[:, :3, 3], dj[:, :3, 3], atol=5e-3)
    assert max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(dt, dj)) < 5e-3
    for kt, kj in zip(bt.keyframes, bj.keyframes):
        np.testing.assert_allclose(kt.pose[:3, 3], kj.pose[:3, 3], atol=5e-3)
        assert rot_angle(kt.pose[:3, :3], kj.pose[:3, :3]) < 5e-3
    after = np.linalg.norm(bt.keyframes[ct.query_kf].pose[:3, 3] - gt_last[:3, 3])
    assert before > 0.08 and after < 0.5 * before, (before, after)
    assert tc.loop_edges[0][:2] == jc.loop_edges[0][:2]


def _ba_obs(be):
    """Each keyframe's observations in global BA (landmarks seen twice)."""
    counts = np.zeros(len(be.keyframes), np.int64)
    for obs in be.lm_obs.values():
        if len(obs) >= 2:
            for kf_id, _ in obs:
                counts[kf_id] += 1
    return counts


def test_global_ba_holds_undetermined_keyframes(sequence):
    """The last consistency-1 closure's pose-graph correction, then global
    BA with the query keyframe cut to one observation (its other landmarks
    seen by it alone), as at 640x480 (chip_smoke full system (a)): the port
    holds that keyframe at its pose-graph pose bit for bit, and every
    keyframe with >= MIN_BA_OBS observations stays within 5e-3 m / 5e-3
    rad of JAX's ``_global_ba`` on the same problem, where the keyframe is
    free (and wanders off)."""
    bt, _, last = sequence
    bt = copy.deepcopy(bt)
    ct = last["port"]
    k = ct.query_kf
    old = np.stack([kf.pose for kf in bt.keyframes])
    tloop.LoopCloser(bt, **LOOP_ARGS).correct(ct, run_global_ba=False)
    seen = [lid for lid, obs in bt.lm_obs.items()
            if len(obs) >= 2 and any(kf_id == k for kf_id, _ in obs)]
    assert len(seen) >= 2, seen
    for lid in seen[1:]:
        bt.lm_obs[lid] = [o for o in bt.lm_obs[lid] if o[0] != k]
    obs = _ba_obs(bt)
    determined = obs >= tloop.MIN_BA_OBS
    assert obs[k] == 1 and determined.sum() == len(obs) - 1, obs
    bj = jkf.SparseBackend(INTR, CFG, fast_threshold=8.0)
    _mirror(bt, bj)
    pg = bt.keyframes[k].pose.copy()
    dt = tloop.LoopCloser(bt, **LOOP_ARGS)._global_ba(old)
    dj = jloop.LoopCloser(bj, **LOOP_ARGS)._global_ba(old)
    assert dt is not None and dj is not None
    assert np.array_equal(bt.keyframes[k].pose, pg)
    assert np.array_equal(dt[k], (pg @ np.linalg.inv(old[k])).astype(np.float32))
    for i in np.flatnonzero(determined):
        kt, kj = bt.keyframes[i].pose, bj.keyframes[i].pose
        np.testing.assert_allclose(kt[:3, 3], kj[:3, 3], atol=5e-3)
        assert rot_angle(kt[:3, :3], kj[:3, :3]) < 5e-3
        np.testing.assert_allclose(dt[i, :3, 3], dj[i, :3, 3], atol=5e-3)


def test_loop_closer_runs_on_the_backends_device():
    """The closer has no device of its own: it solves where its backend
    does (jax's _ba_ctx collapses onto the backend's device)."""
    bt, _ = _new_backends()
    assert tloop.LoopCloser(bt).device == torch.device("cpu")
