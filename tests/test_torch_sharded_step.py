"""The row-sharded dense step tracked: ``tests/test_aa_sharded_step.py``'s two
cases on its own config (64x48, 2/2/2 iterations, 2 SO(3) iterations) on an
8-shard CPU mesh, held to the port's unsharded step and to JAX's
single-device step under that test's tolerances:

- fixed iterations (``tracking_converge_eps=0``): pose within 1e-4, equal
  map counts, map rows within 1e-3 in the same order, ``pred_vertex``
  within 1e-3;
- with the early exit (1e-7): pose within 1e-4, counts within 32.

Only the Gram sums' order differs from the unsharded port, and both sum
in float64 and round once, so the poses agree far inside the bound (at
this size bit for bit); the unsharded step replayed at the sharded step's
tracked pose equals it bit for bit (all but the two tracking scalars).
Against JAX the principal-direction channels of the map rows (14:17 and
18:21) are left out of the 1e-3 check: there the port's unsharded step
itself differs from JAX's by up to 0.87 on a few rows (the directions of
near-umbilic or near-flat surfels follow the curvature sums' float32
rounding, which differs between the two packages); the sharded step is held
to the port on every channel.

JAX runs once per case (a module fixture, ``unoptimized_jax``): its
preprocess op by op, ``track`` jitted, then ``step_impl`` at the tracked
pose (``torch_parity_utils.jax_tracked_step``'s arrangement, the same
computation as ``slam.step``).  The early-exit case reuses the first case's
``step_impl`` compilation: ``tracking_converge_eps`` is read by ``track``
alone.  JAX's 8-device GSPMD compile is not rerun."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import (INTR, boot_both, jax_track, n, port_cfg, port_frames,
                                port_intr, t, unoptimized_jax)  # noqa: F401

from hrbffusion3d_tpu.config import small_test_config
from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu.pipeline import slam as jslam
from hrbffusion3d_tpu.tracking import odometry as jodo
from hrbffusion3d_tpu_torch.core import lie
from hrbffusion3d_tpu_torch.parallel import sharding
from hrbffusion3d_tpu_torch.pipeline import slam

CFG = small_test_config(map_capacity=1 << 12, new_surfels_capacity=1 << 10,
                        pyramid_iterations=(2, 2, 2), so3_iterations=2,
                        predict_conf_threshold=0.2, tracking_converge_eps=0.0)
EXIT_CFG = dataclasses.replace(CFG, tracking_converge_eps=1e-7)
DIRECTIONS = list(range(14, 17)) + list(range(18, 21))


def _jax_step(js, frame, cfg):
    """JAX's step on one frame: ``track`` under ``cfg``, the rest of
    ``step_impl`` (which does not read ``tracking_converge_eps``) under
    ``CFG`` at the tracked pose."""
    frame = jslam.FrameInput(*(jnp.asarray(a) for a in frame))
    pre = jslam._preprocess(frame, INTR, CFG)
    depth_f, p, _, intensity = pre
    inp = jax.jit(jodo.build_inputs, static_argnames=("cfg",))(
        next_depth=depth_f, next_intensity=intensity, next_vmap=p.vertex_filtered,
        next_nmap=p.normal, pred_vmap=js.pred_vertex, pred_nmap=js.pred_normal,
        pred_intensity=js.pred_intensity, icp_weight=js.pred_icp_weight, prev_R=js.R,
        prev_t=js.t, prev_intensity=js.prev_intensity, cfg=CFG)
    tr = jax_track()(js.R, js.t, inp, INTR, cfg, rgb_only=False)
    return jax.jit(jslam.step_impl, static_argnames=("intr", "cfg"))(
        js, frame, INTR, CFG, fixed_pose=jlie.rt_to_mat(tr.R, tr.t), pre_done=pre)


@pytest.fixture(scope="module")
def runs():
    """Per case: (JAX's step, the port's unsharded step, the sharded step
    gathered, the first pose, the unsharded step at the sharded step's
    pose), all from the port's bootstrap of frame 0, on frame 1."""
    poses, frames = port_frames(2)
    out = {}
    for name, cfg in (("fixed", CFG), ("early_exit", EXIT_CFG)):
        ts, js = boot_both(cfg, frames[0], poses[0])
        pc, pi = port_cfg(cfg), port_intr(INTR)
        f1 = slam.FrameInput(t(frames[1][0]), t(frames[1][1]))
        ref = slam.step(ts, f1, pi, pc)
        mesh = sharding.make_mesh(8, devices=["cpu"])
        got = slam.step(sharding.shard_state(ts, mesh, pc), f1, pi, pc)
        assert len(got.map.data.parts) == 8 and len(got.pred_vertex.parts) == 8
        got = sharding.gather_state(got)
        at_pose = slam.step(ts, f1, pi, pc, fixed_pose=lie.rt_to_mat(got.R, got.t))
        out[name] = (_jax_step(js, frames[1], cfg), ref, got, poses[0], at_pose)
    return out


def _pose(a, b, t0):
    assert np.linalg.norm(n(b.t) - t0[:3, 3]) > 1e-4        # tracking moved the pose
    np.testing.assert_allclose(n(a.t), n(b.t), atol=1e-4)
    np.testing.assert_allclose(n(a.R), n(b.R), atol=1e-4)


def test_sharded_step_matches_single_device(runs):
    js, ref, got, p0, at_pose = runs["fixed"]
    for other in (ref, js):
        _pose(got, other, p0)
        assert int(got.map.count) == int(other.map.count)
        np.testing.assert_allclose(n(got.pred_vertex), n(other.pred_vertex), atol=1e-3)
    c = int(got.map.count)
    a = n(got.map.data[:c])
    np.testing.assert_allclose(a, n(ref.map.data[:c]), atol=1e-3)
    keep = [i for i in range(a.shape[1]) if i not in DIRECTIONS]
    np.testing.assert_allclose(a[:, keep], np.asarray(js.map.data[:c])[:, keep], atol=1e-3)
    for name in slam.SLAMState._fields:
        x, y = getattr(at_pose, name), getattr(got, name)
        if name == "map":
            assert (x.data == y.data).all() and int(x.count) == int(y.count)
        elif name not in ("last_icp_error", "last_icp_count", "dense_frac", "time",
                          "submap_idx"):
            assert (x == y).all(), name


def test_sharded_step_early_exit_trajectory(runs):
    js, ref, got, p0, _ = runs["early_exit"]
    for other in (ref, js):
        _pose(got, other, p0)
        assert abs(int(got.map.count) - int(other.map.count)) < 32
