"""The port's host-side frame loop (``ensure_capacity``, ``run_sequence``,
``step_many``) at 64x48: capacity growth against the JAX package's, and the
loops against plain ``bootstrap`` + ``step`` calls (exact: the same calls
in the same order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import CFG, PCFG, PINTR, n, port_frames, t

from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu.pipeline import slam as jslam
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
