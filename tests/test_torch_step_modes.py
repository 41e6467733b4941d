"""The slice as a whole with the reference's correspondence search
(icp_use_correspondence_search=True, radius 2, the curvature term on):
one port ``slam.step`` against JAX's ``step_impl`` (64x48,
__graft_entry__'s config at two pyramid levels of two iterations), both from the port's bootstrap.  The step
hands the live and predicted curvature maps to ``build_inputs``.

Two checks of one run:
  - ``odometry.track`` from the JAX step's own ``TrackingInputs`` (its
    curvature pyramids included): R within 1e-4 rad, t within 1e-4 m,
    counts within rtol 1e-3 (test_torch_tracking.py::test_track's);
  - the step: test_torch_slam.py's tolerances (t within 1e-3 m, R within
    1e-3 rad, map count within 0.5 %, the predicted vertex within 1e-3 m
    on >= 99 % of the pixels valid in both).
Central-difference normals are in test_torch_step_normals.py."""

import dataclasses

import numpy as np
from torch_parity_utils import (PINTR, TRACK_CFG, boot_both, check_step, jax_tracked_step, n,
                                port_cfg, port_frames, rot_angle, t)
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.tracking import odometry as todo

POSES, FRAMES = port_frames(2, angle_per_frame=0.004)


def test_step_corr_search():
    cfg = dataclasses.replace(TRACK_CFG, icp_use_correspondence_search=True)
    ts, js0 = boot_both(cfg, FRAMES[0], POSES[0])
    js, tr, inp = jax_tracked_step(js0, FRAMES[1], cfg)
    assert len(inp.next_k1) == cfg.num_pyramid_levels
    it = todo.TrackingInputs(*(tuple(t(np.asarray(x)) for x in getattr(inp, f))
                               for f in todo.TrackingInputs._fields))
    rt = todo.track(ts.R, ts.t, it, PINTR, port_cfg(cfg))
    assert rot_angle(n(rt.R), np.asarray(tr.R)) < 1e-4
    np.testing.assert_allclose(n(rt.t), np.asarray(tr.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.icp_count), float(tr.icp_count), rtol=1e-3)
    np.testing.assert_allclose(float(rt.rgb_count), float(tr.rgb_count), rtol=1e-3)
    ts = tslam.step(ts, tslam.FrameInput(t(FRAMES[1][0]), t(FRAMES[1][1])), PINTR,
                    port_cfg(cfg))
    check_step(ts, js, POSES[0][:3, 3])
