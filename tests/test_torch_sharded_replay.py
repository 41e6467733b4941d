"""The row-sharded dense step in replay (``fixed_pose``: tracking skipped)
equals the port's unsharded step bit for bit: map count, every map row,
and every image of the state (prediction maps, previous intensity), after
each of 6 steps of the orbit at 64x48 on 3- and 8-shard CPU meshes, with
compaction and crowd rules every 4th frame and splat prediction on odd
frames (``raycast_period=2``).  The steps cover every branch of the step:
HRBF and splat prediction, compaction (time 4) and tombstones, the
pixel-space remap between them.  Every part of the sharded step but the
tracking Gram sums is exact, so any difference is a halo, offset or
ordering fault.  ``slam.step_many_replay`` on a sharded frame batch
ends at the same state."""

import numpy as np
import pytest
import torch

from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.parallel import sharding
from hrbffusion3d_tpu_torch.pipeline import slam

torch.set_num_threads(1)

INTR = CameraIntrinsics(fx=52.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
CFG = small_test_config(map_capacity=1 << 12, new_surfels_capacity=1 << 10,
                        pyramid_iterations=(2, 2, 2), so3_iterations=2,
                        predict_conf_threshold=0.2, clean_compact_period=4,
                        clean_crowd_period=4, raycast_period=2)
N_STEPS = 6


def _assert_same(ref: slam.SLAMState, got: slam.SLAMState, label: str):
    got = sharding.gather_state(got)
    for name in slam.SLAMState._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if name == "map":
            assert torch.equal(a.count, b.count), (label, int(a.count), int(b.count))
            assert torch.equal(a.data, b.data), (label, "rows")
        elif isinstance(a, torch.Tensor) and name != "dense_frac":
            assert a.dtype == b.dtype and torch.equal(a, b), (label, name)
        elif not isinstance(a, torch.Tensor):
            assert a == b, (label, name)
    np.testing.assert_allclose(float(got.dense_frac), float(ref.dense_frac), rtol=1e-6)


@pytest.fixture(scope="module")
def replay():
    poses = synth.orbit_trajectory(N_STEPS + 1, angle_per_frame=0.01)
    room = synth.default_room("cpu")
    frames = [slam.FrameInput(*synth.render_frame(room, p, INTR)) for p in poses]
    boot = slam.bootstrap(frames[0], INTR, CFG, init_pose=poses[0])
    states = [boot]
    for f, p in zip(frames[1:], poses[1:]):
        states.append(slam.step(states[-1], f, INTR, CFG, fixed_pose=p))
    return poses, frames, states


@pytest.mark.parametrize("n", [3, 8])
def test_replay_bit_for_bit(replay, n):
    poses, frames, states = replay
    mesh = sharding.make_mesh(n, devices=["cpu"])
    st = sharding.shard_state(states[0], mesh, CFG)
    for i in range(1, N_STEPS + 1):
        st = slam.step(st, sharding.shard_frame(frames[i], mesh, CFG), INTR, CFG, fixed_pose=poses[i])
        assert len(st.map.data.parts) == n
        _assert_same(states[i], st, f"{n} shards, time {st.time}")
    # the counts moved, a compaction ran, and both predictions did
    assert states[4].time == 5 and int(states[3].map.count) != int(states[2].map.count)


def test_replay_batch_entry_point(replay):
    poses, frames, states = replay
    mesh = sharding.make_mesh(8, devices=["cpu"])
    batch = sharding.shard_frame_batch(
        slam.FrameInput(torch.stack([f.depth for f in frames[1:]]),
                        torch.stack([f.rgb for f in frames[1:]])), mesh, CFG)
    st, ts = slam.step_many_replay(sharding.shard_state(states[0], mesh, CFG), batch, poses[1:],
                                   INTR, CFG)
    _assert_same(states[-1], st, "step_many_replay")
    assert ts.shape == (N_STEPS, 3)
