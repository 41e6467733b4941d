"""The port's host-side frame loop (``ensure_capacity``, ``run_sequence``,
``step_many`` and FullSLAM's batched entry points ``step_many_traj``,
``step_chunk``, ``step_many_replay``) at 64x48: capacity growth against
the JAX package's, and the loops against plain ``bootstrap`` + ``step``
calls (exact: the same calls in the same order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import CFG, PCFG, PINTR, n, port_frames, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu.pipeline import slam as jslam
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.map import surfel_map as tsm
from hrbffusion3d_tpu_torch.pipeline import slam as tslam

POSES, FRAMES = port_frames(3, angle_per_frame=0.004)


@pytest.mark.parametrize("count,threshold", [(1810, 0.75), (1810, 0.3), (4000, 0.75)])
def test_ensure_capacity_matches_jax(count, threshold):
    """Below the threshold nothing changes; above it the backing array
    doubles until the count fits, with pristine rows appended."""
    cap = CFG.map_capacity
    jm = jsm.empty_map(cap)._replace(count=jnp.int32(count))
    js = jslam.SLAMState(*([jm] + [None] * (len(jslam.SLAMState._fields) - 1)))
    tm = tsm.empty_map(cap, "cpu")._replace(count=t(np.int32(count)))
    ts = tslam.SLAMState(*([tm] + [None] * (len(tslam.SLAMState._fields) - 1)))
    js2, jcfg = jslam.ensure_capacity(js, CFG, threshold=threshold)
    ts2, tcfg = tslam.ensure_capacity(ts, PCFG, threshold=threshold)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.map_capacity > cap) == (count > threshold * cap)
    np.testing.assert_array_equal(n(ts2.map.data), n(js2.map.data))


def _frames():
    return [tslam.FrameInput(t(d), t(c)) for d, c in FRAMES]


def test_run_sequence_replay():
    """Replay mode takes the given poses as they are."""
    state, poses = tslam.run_sequence(_frames(), PINTR, PCFG, input_trajectory=POSES)
    np.testing.assert_array_equal(poses, POSES)
    assert state.time == len(FRAMES)


def test_step_many_and_run_sequence_match_steps():
    frames = _frames()
    s = tslam.bootstrap(frames[0], PINTR, PCFG, init_pose=POSES[0])
    s_many, ts = tslam.step_many(s, frames[1:], PINTR, PCFG)
    s_seq, poses = tslam.run_sequence(frames, PINTR, PCFG, init_pose=POSES[0], grow=False)
    for i, f in enumerate(frames[1:]):
        s = tslam.step(s, f, PINTR, PCFG)
        np.testing.assert_array_equal(n(ts[i]), n(s.t))
        np.testing.assert_array_equal(poses[i + 1, :3, 3], n(s.t))
    for a in (s_many, s_seq):
        np.testing.assert_array_equal(n(a.map.data), n(s.map.data))
        assert a.time == s.time == len(FRAMES)


def test_batched_entry_points_match_steps():
    """step_many_traj, step_chunk (its packed vector) and step_many_replay
    over a stacked FrameInput against plain step calls (exact)."""
    frames = _frames()
    batch = tslam.FrameInput(t(np.stack([d for d, _ in FRAMES[1:]])),
                             t(np.stack([c for _, c in FRAMES[1:]])))
    s0 = tslam.bootstrap(frames[0], PINTR, PCFG, init_pose=POSES[0])
    s, s_rep, poses, ts_rep = s0, s0, [], []
    for i, f in enumerate(frames[1:]):
        s = tslam.step(s, f, PINTR, PCFG)
        poses.append(n(tlie.rt_to_mat(s.R, s.t)))
        s_rep = tslam.step(s_rep, f, PINTR, PCFG, fixed_pose=POSES[i + 1])
        ts_rep.append(n(s_rep.t))
    s_traj, p_traj = tslam.step_many_traj(s0, batch, PINTR, PCFG)
    np.testing.assert_array_equal(n(p_traj), np.stack(poses))
    s_chunk, packed = tslam.step_chunk(s0, batch, PINTR, PCFG)
    k = len(poses)
    packed = n(packed)
    assert packed.shape == (k * 16 + 4,)
    np.testing.assert_array_equal(packed[:k * 16].reshape(k, 4, 4), np.stack(poses))
    np.testing.assert_array_equal(packed[k * 16:], [float(n(s.map.count)), n(s.last_icp_error),
                                                    n(s.last_icp_count), n(s.dense_frac)])
    s_r, t_r = tslam.step_many_replay(s0, batch, POSES[1:], PINTR, PCFG)
    np.testing.assert_array_equal(n(t_r), np.stack(ts_rep))
    for a, b in ((s_traj, s), (s_chunk, s), (s_r, s_rep)):
        np.testing.assert_array_equal(n(a.map.data), n(b.map.data))
        assert a.time == b.time == len(FRAMES)
