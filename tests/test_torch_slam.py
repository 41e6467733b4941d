"""The slice as a whole: the port's bootstrap + step against the JAX
package at 64x48 (``__graft_entry__`` intrinsics and config).

JAX bootstraps; the state crosses over with ``state_from_numpy``; then both
run 3 steps on the same frames:
  (a) replay mode (``fixed_pose``), which isolates fuse, clean and predict:
      map count within 0.5 %, predicted vertex within 1e-3 m on >= 99 % of
      the pixels valid in both;
  (b) tracked mode: per-frame t within 1e-3 m and R within 1e-3 rad;
  (c) splat: tracked with ``raycast_period = 2`` (the HRBF ray cast on
      even frames, surfel-splat prediction between): the pose as (b), the
      map count and the prediction as (a).
The JAX side runs use_pallas_raycast=False (no compiled Pallas on the CPU);
the ``found`` tolerances of the raycast parity cover the XLA-vs-kernel form.

The JAX side is arranged for compile time, which dominates at this size:
the bootstrap and the preprocess dispatch op by op (jitting the curvature
stencil compiles for longer than it runs), and the rest of the step is
jitted once.  ``step_impl`` with ``fixed_pose`` set to the tracked pose
(and ``pre_done``) is exactly the tracked step's fuse/clean/predict.  Both
sides take the frames of the port's renderer (test_torch_core.py holds it
against JAX's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import (CFG, INTR, PCFG, PINTR, n, port_cfg, port_frames, rot_angle,
                                t)
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu.pipeline import slam as jslam
from hrbffusion3d_tpu.tracking import odometry as jodo
from hrbffusion3d_tpu_torch.ops import raycast as tray
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

POSES, FRAMES = port_frames(4, angle_per_frame=0.004)
_static = ("intr", "cfg")
_step = jax.jit(jslam.step_impl, static_argnames=_static)
_track = jax.jit(jodo.track, static_argnames=_static)
_build_inputs = jax.jit(jodo.build_inputs, static_argnames=("cfg",))


def _jax_numpy_state(state) -> dict:
    d = {k: np.asarray(v) for k, v in state._asdict().items() if k != "map"}
    d["map.data"] = np.asarray(state.map.data)
    d["map.count"] = np.asarray(state.map.count)
    return d


def _jax_frame(i):
    return jslam.FrameInput(*(jnp.asarray(a) for a in FRAMES[i]))


def _jax_step(state, i, tracked, cfg=CFG):
    frame = _jax_frame(i)
    pre_done = jslam._preprocess(frame, INTR, cfg)
    pose = jnp.asarray(POSES[i])
    if tracked:
        depth_f, pre, _, intensity = pre_done
        inp = _build_inputs(
            next_depth=depth_f, next_intensity=intensity,
            next_vmap=pre.vertex_filtered, next_nmap=pre.normal,
            pred_vmap=state.pred_vertex, pred_nmap=state.pred_normal,
            pred_intensity=state.pred_intensity, icp_weight=state.pred_icp_weight,
            prev_R=state.R, prev_t=state.t, prev_intensity=state.prev_intensity, cfg=CFG)
        tr = _track(state.R, state.t, inp, INTR, CFG)
        pose = jlie.rt_to_mat(tr.R, tr.t)
    return _step(state, frame, INTR, cfg, fixed_pose=pose, pre_done=pre_done)


@pytest.fixture(scope="module")
def boot():
    # the function under jslam.bootstrap's jit, dispatched op by op
    js = jslam._bootstrap_jit.__wrapped__(_jax_frame(0), jnp.asarray(POSES[0]), INTR, CFG)
    return js, _jax_numpy_state(js)


def test_state_round_trip(boot):
    _, fields = boot
    back = state_to_numpy(state_from_numpy(fields, "cpu"))
    assert back.keys() == fields.keys()
    for k, v in fields.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bootstrap(boot):
    js, fields = boot
    ts = tslam.bootstrap(tslam.FrameInput(t(FRAMES[0][0]), t(FRAMES[0][1])), PINTR, PCFG,
                         init_pose=POSES[0])
    assert int(ts.map.count) == int(fields["map.count"])
    # every channel to 1e-5 but the curvature: k1/k2 to 1e-3 (near-zero on
    # the walls, float32 Hessian sums), and the principal directions not at
    # all — they are undefined at umbilic points (planes, spheres) and flip
    # under 1e-4 perturbations there; nothing on the step's path reads them
    a, b = n(ts.map.data), fields["map.data"]
    curv = [14, 15, 16, 17, 18, 19, 20, 21]
    rest = [c for c in range(a.shape[1]) if c not in curv]
    np.testing.assert_allclose(a[:, rest], b[:, rest], atol=1e-5)
    np.testing.assert_allclose(a[:, [17, 21]], b[:, [17, 21]], atol=1e-3)
    _check_prediction(ts, fields)


def _check_prediction(ts, fields):
    vt, vj = n(ts.pred_vertex), fields["pred_vertex"]
    both = (vt[..., 2] > 0) & (vj[..., 2] > 0)
    assert both.mean() > 0.5
    assert (np.abs(vt - vj)[both].max(-1) < 1e-3).mean() >= 0.99


@pytest.mark.parametrize("mode", ["replay", "tracked", "splat"])
def test_three_steps(boot, mode, monkeypatch):
    js, fields = boot
    ts = state_from_numpy(fields, "cpu")
    tracked = mode != "replay"
    cfg = dataclasses.replace(CFG, raycast_period=2) if mode == "splat" else CFG
    pcfg = port_cfg(cfg)
    calls = []
    for name in ("predict_hrbf", "predict_splat"):
        fn = getattr(tray, name)
        monkeypatch.setattr(tray, name, lambda *a, _fn=fn, _name=name, **k:
                            calls.append(_name) or _fn(*a, **k))
    for i in (1, 2, 3):
        js = _jax_step(js, i, tracked, cfg)
        frame = tslam.FrameInput(t(FRAMES[i][0]), t(FRAMES[i][1]))
        ts = tslam.step(ts, frame, PINTR, pcfg, fixed_pose=None if tracked else POSES[i])
        assert ts.time == int(js.time) == i + 1
        if tracked:
            assert np.abs(n(ts.t) - np.asarray(js.t)).max() < 1e-3, i
            assert rot_angle(n(ts.R), np.asarray(js.R)) < 1e-3, i
        if mode != "tracked":
            cj = int(js.map.count)
            assert abs(int(ts.map.count) - cj) <= 0.005 * cj, i
            _check_prediction(ts, _jax_numpy_state(js))
    assert torch.isfinite(ts.pred_vertex).all()
    # frames 2, 3, 4: the ray cast on even frames only under raycast_period 2
    assert calls == (["predict_hrbf", "predict_splat", "predict_hrbf"] if mode == "splat"
                     else ["predict_hrbf"] * 3)
