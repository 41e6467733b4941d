"""The port's full system with a mesh (``FullSLAM(mesh=)``):
``tests/test_ab_sharded_full_system.py``'s protocol (13 frames of the orbit
at 128x96, a keyframe every 4 frames, ``process_batch``) on an 8-shard CPU
mesh, on the JAX test's own frames (JAX's renderer).  The dense state
really is sharded (the JAX test's assertion): the surfel map's rows and
the prediction images' rows lie on the 8 shards, and every dense step ran
the row-sharded step.  Every local BA that has a problem runs the
landmark-sharded solver, and the first one gives the unsharded solver's
cameras and landmarks (``ba.optimize`` on the same problem) within 1e-4;
at least three keyframes; finite poses; ATE under 2 cm, JAX's bound, kept
as a sanity check only (see below).

The protocol is chaotic at this size: with 4/3/2 tracking iterations a
change in the last bits of a frame moves the first tracked pose by ~20 mm
(the port's renderer, equal to JAX's within float32 rounding, gives 24.7
mm there, JAX's 3.9 mm, in both packages' steps), and JAX's own runs with
and without the mesh end up to 46 mm apart on one frame.  On these frames
the port gives ATE 19.0 mm without the mesh and 19.6 mm with it (JAX:
16.3 and 17.8 mm), so a last-bit change elsewhere can move it across the
bound.  The solve check is not chaotic: it holds the two solvers to each
other on one problem, whatever the frames made of it (4.5e-07 apart
here)."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_utils import port_cfg, port_intr, t

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu.eval import synth as jsynth
from hrbffusion3d_tpu_torch.backend import ba
from hrbffusion3d_tpu_torch.eval import ate, synth
from hrbffusion3d_tpu_torch.parallel import dist_ba, sharded_step, sharding
from hrbffusion3d_tpu_torch.pipeline import slam
from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

JINTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
INTR = port_intr(JINTR)
CFG = port_cfg(small_test_config(map_capacity=1 << 14, pyramid_iterations=(4, 3, 2),
                                 so3_iterations=4, predict_conf_threshold=0.2,
                                 keyframe_period=4))


def test_full_system_sharded_end_to_end():
    n = 13
    gt = synth.orbit_trajectory(n, angle_per_frame=0.004)
    scene = jsynth.default_room()
    frames = [tuple(t(a) for a in jsynth.render_frame_jit(scene, jnp.asarray(p), JINTR))
              for p in gt]

    solves, outputs = [], []
    make_optimizer = dist_ba.make_optimizer

    def counted(mesh, **kw):
        run = make_optimizer(mesh, **kw)

        def recorded_run(sb):
            solves.append(len(sb.shards))
            outputs.append(run(sb))
            return outputs[-1]
        return recorded_run

    dist_ba.make_optimizer = counted
    sharded_steps = []
    step = sharded_step.step

    def counted_step(*args, **kw):
        sharded_steps.append(1)
        return step(*args, **kw)

    sharded_step.step = counted_step
    try:
        sys_ = FullSLAM(INTR, CFG, init_pose=gt[0], mesh=sharding.make_mesh(8, devices=["cpu"]),
                        backend_kwargs=dict(fast_threshold=8.0), device="cpu")
        problems = []
        local_problem = sys_.backend.local_problem

        def recorded():
            built = local_problem()
            problems.append(built)
            return built

        sys_.backend.local_problem = recorded
        batch = slam.FrameInput(torch.stack([d for d, _ in frames]),
                                torch.stack([c for _, c in frames]))
        sys_.process_batch(batch)
    finally:
        dist_ba.make_optimizer = make_optimizer
        sharded_step.step = step

    # the dense state really is sharded over the mesh
    mesh = sys_.mesh
    assert isinstance(sys_.state.map.data, sharding.ShardedRows)
    assert len(sys_.state.map.data.parts) == 8 == mesh.size
    assert sys_.state.map.data.bounds == tuple(sharding.row_bounds(CFG.map_capacity, 8))
    assert [p.device for p in sys_.state.map.data.parts] == list(mesh.devices)
    assert len(sys_.state.pred_vertex.parts) == 8
    assert len(sharded_steps) == 12
    assert len(sys_.backend.keyframes) >= 3
    # every local BA with a problem went through the sharded solver
    built = [b for b in problems if b is not None]
    assert len(built) >= 1 and solves == [8] * len(built)
    # the first sharded local BA solves what the unsharded solver does
    prob, cam_ids, lm_ids = built[0]
    single, _ = ba.optimize(ba.pad_problem(prob))
    cams, points, _ = outputs[0]
    assert (cams[:len(cam_ids)] - single.cams[:len(cam_ids)]).abs().max() < 1e-4
    np.testing.assert_allclose(dist_ba.gather_points(points, len(lm_ids)),
                               single.points[:len(lm_ids)].numpy(), atol=1e-4)
    poses = sys_.poses()
    assert np.isfinite(poses).all()
    err = ate.ate_rmse(poses, gt[: poses.shape[0]], align=False)
    assert err < 0.02, f"sharded full-system ATE {err * 1000:.1f} mm"
