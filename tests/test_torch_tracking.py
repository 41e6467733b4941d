"""Parity of the port's frame-to-model tracking with the JAX package: the
same pyramids (``build_inputs``) and one ``odometry.track`` from identical
``TrackingInputs`` at 64x48 with pyramid_iterations=(2,2,2).

Inputs: frame 0 stands in for the model prediction and frame 1 is the live
frame (the port's preprocess makes both, as numpy, for the two sides).
Tolerances: pyramids atol 1e-4 (float32 window sums in another order);
the pose R within 1e-4 rad and t within 1e-4 m of JAX (the Gauss-Newton
solve amplifies float32 rounding in the Gram sums; the differences seen
are ~1e-7)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import CFG, INTR, PINTR, n, port_cfg, port_frames, rot_angle, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.tracking import odometry as jodo
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.tracking import odometry as todo

JCFG = dataclasses.replace(CFG, pyramid_iterations=(2, 2, 2))
TCFG = port_cfg(JCFG)
POSES, FRAMES = port_frames(2, angle_per_frame=0.01)


@pytest.fixture(scope="module")
def inputs():
    """build_inputs arguments as numpy: model = frame 0, live = frame 1."""
    outs = []
    for d, c in FRAMES:
        depth_f, pre, curv, inten = tslam._preprocess(tslam.FrameInput(t(d), t(c)), PINTR, TCFG)
        outs.append((depth_f, pre, inten))
    (_, pre0, int0), (df1, pre1, int1) = outs
    args = dict(
        next_depth=df1, next_intensity=int1, next_vmap=pre1.vertex_filtered,
        next_nmap=pre1.normal, pred_vmap=pre0.vertex_filtered, pred_nmap=pre0.normal,
        pred_intensity=int0, icp_weight=(pre0.vertex_filtered[..., 2] > 0).float() * 0.3,
        prev_R=t(POSES[0][:3, :3]), prev_t=t(POSES[0][:3, 3]), prev_intensity=int0)
    return {k: n(v) for k, v in args.items()}


@pytest.fixture(scope="module")
def pyramids(inputs):
    ij = jax.jit(jodo.build_inputs, static_argnames=("cfg",))(
        **{k: jnp.asarray(v) for k, v in inputs.items()}, cfg=JCFG)
    it = todo.build_inputs(**{k: t(v) for k, v in inputs.items()}, cfg=TCFG)
    return ij, it


def test_build_inputs(pyramids):
    ij, it = pyramids
    for field in todo.TrackingInputs._fields:
        for lvl, (a, b) in enumerate(zip(getattr(it, field), getattr(ij, field))):
            np.testing.assert_allclose(n(a), n(b), atol=1e-4, err_msg=f"{field}[{lvl}]")


def test_track(pyramids, inputs):
    ij, _ = pyramids
    # both sides track from the JAX pyramids, so only track() differs
    it = todo.TrackingInputs(*(tuple(t(np.asarray(x)) for x in getattr(ij, f))
                               for f in todo.TrackingInputs._fields))
    R0, t0 = inputs["prev_R"], inputs["prev_t"]
    track_j = jax.jit(jodo.track, static_argnames=("intr", "cfg"))
    rj = track_j(jnp.asarray(R0), jnp.asarray(t0), ij, INTR, JCFG)
    rt = todo.track(t(R0), t(t0), it, PINTR, TCFG)
    # the solve moved the pose (frames are 0.01 orbit steps apart)
    assert np.linalg.norm(np.asarray(rj.t) - t0) > 1e-3
    assert rot_angle(n(rt.R), np.asarray(rj.R)) < 1e-4
    np.testing.assert_allclose(n(rt.t), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.icp_count), float(rj.icp_count), rtol=1e-3)
    np.testing.assert_allclose(float(rt.rgb_count), float(rj.rgb_count), rtol=1e-3)

