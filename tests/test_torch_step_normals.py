"""The slice as a whole with central-difference normals
(normal_pca=False, the reference's preprocessingNormalEstimationPCA off):
one port ``slam.step`` against JAX's ``step_impl`` (64x48,
__graft_entry__'s config at two pyramid levels of two iterations), both from the port's bootstrap under that
config, with test_torch_slam.py's tolerances (t within 1e-3 m, R within
1e-3 rad, map count within 0.5 %, the predicted vertex within 1e-3 m on
>= 99 % of the pixels valid in both).  ``normal_central_diff`` alone:
atol 1e-6 on a frame with holes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
from torch_parity_utils import (CFG, INTR, PINTR, TRACK_CFG, boot_both, check_step, jax_tracked_step, n,
                                port_cfg, port_frames, t)
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.core import camera as jcam
from hrbffusion3d_tpu.ops import preprocess as jpre
from hrbffusion3d_tpu_torch.ops import preprocess as tpre
from hrbffusion3d_tpu_torch.pipeline import slam as tslam

POSES, FRAMES = port_frames(2, angle_per_frame=0.004)


def test_step_central_diff_normals():
    cfg = dataclasses.replace(TRACK_CFG, normal_pca=False)
    ts, js = boot_both(cfg, FRAMES[0], POSES[0])
    js, _, _ = jax_tracked_step(js, FRAMES[1], cfg)
    ts = tslam.step(ts, tslam.FrameInput(t(FRAMES[1][0]), t(FRAMES[1][1])), PINTR,
                    port_cfg(cfg))
    check_step(ts, js, POSES[0][:3, 3])


def test_normal_central_diff():
    depth = np.array(FRAMES[0][0])
    depth[10:14, 20:30] = 0.0
    depth[::9, ::7] = 0.0
    v = np.asarray(jcam.unproject(jnp.asarray(depth), INTR))
    nj = np.asarray(jpre.normal_central_diff(jnp.asarray(v), jnp.asarray(depth), CFG))
    nt = n(tpre.normal_central_diff(t(v), t(depth), port_cfg(CFG)))
    assert (np.abs(nj).sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(nt, nj, atol=1e-6)
