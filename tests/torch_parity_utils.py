"""Shared fixtures of the ``test_torch_*.py`` parity tests: the same numpy
inputs go through a JAX function and its counterpart in the PyTorch port.

Sizes follow ``__graft_entry__`` (64x48 intrinsics, the small test config).
``CFG`` / ``INTR`` are the JAX package's objects, for its calls; every port
call takes the port's own ``SLAMConfig`` / ``CameraIntrinsics`` (``PCFG``,
``PINTR``, ``port_cfg``), made from the same fields.  Tier-1 runs several
xdist workers, so torch is pinned to one thread.

``unoptimized_jax``, imported into a parity file, compiles that file's JAX
side without most of XLA's optimisation passes (see its docstring).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _CFG, _INTR

from hrbffusion3d_tpu_torch.utils.convert import config_from_fields, intrinsics_from_fields

torch.set_num_threads(1)

INTR = _INTR
# The JAX side has no compiled Pallas on the CPU: it runs the XLA raycast
# (use_pallas_raycast=False); the port always runs its kernel's semantics.
CFG = dataclasses.replace(_CFG, use_pallas_raycast=False)


@pytest.fixture(scope="module", autouse=True)
def unoptimized_jax():
    """Autouse in the parity files that import it: their JAX side compiles
    with ``jax_disable_most_optimizations`` (XLA's optimisation passes
    off).  At these sizes compiling, not running, is most of the JAX side's
    time.  The values move by float32 rounding only: every tolerance of the
    importing files holds (not ``test_torch_icp_modes.py``'s 1e-6 on the
    lambda update, which therefore keeps the default).  The setting is not
    part of JAX's jit cache keys, so the caches are cleared when it is
    turned on and again when it is restored: the file compiles all of its
    JAX side without the passes, and no program compiled without them
    reaches the tests that run after it in the same worker."""
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", saved)


def port_cfg(cfg):
    """The port's SLAMConfig with the fields of a JAX one."""
    return config_from_fields(dataclasses.asdict(cfg))


def port_intr(intr):
    """The port's CameraIntrinsics with the fields of JAX ones."""
    return intrinsics_from_fields(dataclasses.asdict(intr))


PCFG = port_cfg(CFG)
PINTR = port_intr(INTR)


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True))


def n(x) -> np.ndarray:
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_frames(n_frames: int, angle_per_frame: float = 0.004, intr=INTR):
    """(poses (N,4,4), [(depth, rgb)] numpy) of the JAX synthetic orbit."""
    from hrbffusion3d_tpu.eval import synth

    poses = synth.orbit_trajectory(n_frames, angle_per_frame=angle_per_frame)
    scene = synth.default_room()
    with jax.disable_jit():
        frames = [tuple(np.asarray(a) for a in synth.render_frame(scene, jnp.asarray(p), intr))
                  for p in poses]
    return poses, frames


def port_frames(n_frames: int, angle_per_frame: float = 0.004, intr=PINTR):
    """The same orbit rendered by the port's synth (as numpy): the shared
    input of both sides wherever the renderer itself is not under test.
    JAX's eager renderer compiles for seconds; this one takes milliseconds
    (test_torch_core.py::test_synth_matches_jax holds the two together)."""
    from hrbffusion3d_tpu_torch.eval import synth

    poses = synth.orbit_trajectory(n_frames, angle_per_frame=angle_per_frame)
    scene = synth.default_room("cpu")
    frames = [tuple(n(a) for a in synth.render_frame(scene, p, intr)) for p in poses]
    return poses, frames


def port_measurement(depth: np.ndarray, rgb: np.ndarray, cfg=PCFG, intr=PINTR):
    """The ``FrameMeasurement`` of one frame from the port's preprocess, as
    numpy: the shared input of the map and raycast parity tests
    (test_torch_preprocess.py holds the preprocess itself against JAX)."""
    from hrbffusion3d_tpu_torch.map import surfel_map
    from hrbffusion3d_tpu_torch.ops import preprocess
    from hrbffusion3d_tpu_torch.pipeline import slam

    _, pre, curv, _ = slam._preprocess(slam.FrameInput(t(depth), t(rgb)), intr, cfg)
    conf = preprocess.confidence_map(pre, curv, intr, cfg)
    meas = surfel_map.measurement_from_preprocess(pre, curv, t(rgb), conf)
    return surfel_map.FrameMeasurement(*map(n, meas))


def rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Geodesic angle (rad) between two rotations, from the chord
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) in float64: the arccos of the
    trace cannot resolve angles below ~5e-4 rad from float32 matrices."""
    chord = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))



# the tracking-mode parity tests' base: two pyramid levels of two
# iterations (JAX's compile time, which dominates at this size, grows with
# the levels)
TRACK_CFG = dataclasses.replace(CFG, num_pyramid_levels=2, pyramid_iterations=(2, 2))


def tracking_pair(saliency: bool = False, angle_per_frame: float = 0.01):
    """A two-frame orbit as (JAX ``TrackingInputs``, the same as the port's,
    prev_R, prev_t).  The port's preprocess makes both frames: frame 0
    stands in for the model prediction, frame 1 is the live frame; JAX's
    ``build_inputs`` builds the pyramids and the curvature pyramids of both
    frames (the correspondence search's), and with ``saliency`` the live
    curvature again as the saliency maps (top-k's), which every mode may
    carry and only theirs read."""
    from hrbffusion3d_tpu.tracking import odometry as jodo
    from hrbffusion3d_tpu_torch.pipeline import slam
    from hrbffusion3d_tpu_torch.tracking import odometry as todo

    cfg = dataclasses.replace(TRACK_CFG, icp_use_correspondence_search=True)
    poses, frames = port_frames(2, angle_per_frame=angle_per_frame)
    outs = [slam._preprocess(slam.FrameInput(t(d), t(c)), PINTR, port_cfg(cfg))
            for d, c in frames]
    (_, pre0, curv0, int0), (df1, pre1, curv1, int1) = outs
    args = dict(
        next_depth=df1, next_intensity=int1, next_vmap=pre1.vertex_filtered,
        next_nmap=pre1.normal, pred_vmap=pre0.vertex_filtered, pred_nmap=pre0.normal,
        pred_intensity=int0, icp_weight=(pre0.vertex_filtered[..., 2] > 0).float() * 0.3,
        prev_R=t(poses[0][:3, :3]), prev_t=t(poses[0][:3, 3]), prev_intensity=int0,
        next_k1=curv1.k1, next_k2=curv1.k2, pred_k1=curv0.k1, pred_k2=curv0.k2,
        **({"sal_k1": curv1.k1, "sal_k2": curv1.k2} if saliency else {}))
    ij = jax.jit(jodo.build_inputs, static_argnames=("cfg",))(
        **{k: jnp.asarray(n(v)) for k, v in args.items()}, cfg=cfg)
    it = todo.TrackingInputs(*(tuple(t(np.asarray(x)) for x in getattr(ij, f))
                               for f in todo.TrackingInputs._fields))
    return ij, it, n(args["prev_R"]), n(args["prev_t"])


@functools.cache
def jax_track():
    """JAX's ``track`` jitted once per process, so that a file's cases share
    its compilations."""
    from hrbffusion3d_tpu.tracking import odometry as jodo

    return jax.jit(jodo.track, static_argnames=("intr", "cfg", "rgb_only"))


def check_track(pair, cfg, rgb_only=False):
    """One ``track`` of JAX (jitted) and of the port from the same inputs:
    the pose moved; R within 1e-4 rad and t within 1e-4 m of JAX; the ICP
    and photometric counts within rtol 1e-3.  Returns (JAX's, port's)."""
    from hrbffusion3d_tpu_torch.tracking import odometry as todo

    ij, it, R0, t0 = pair
    rj = jax_track()(jnp.asarray(R0), jnp.asarray(t0), ij, INTR, cfg, rgb_only=rgb_only)
    rt = todo.track(t(R0), t(t0), it, PINTR, port_cfg(cfg), rgb_only=rgb_only)
    assert np.linalg.norm(np.asarray(rj.t) - t0) > 1e-3
    assert rot_angle(n(rt.R), np.asarray(rj.R)) < 1e-4
    np.testing.assert_allclose(n(rt.t), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.icp_count), float(rj.icp_count), rtol=1e-3)
    np.testing.assert_allclose(float(rt.rgb_count), float(rj.rgb_count), rtol=1e-3)
    return rj, rt


def boot_both(cfg, frame, pose):
    """The port's bootstrap under ``cfg`` as (the port's state on the CPU,
    the same as JAX's ``SLAMState``): both sides of a step parity test
    start from it (test_torch_slam.py::test_bootstrap holds the port's
    bootstrap to JAX's)."""
    from hrbffusion3d_tpu.map import surfel_map as jsm
    from hrbffusion3d_tpu.pipeline import slam as jslam
    from hrbffusion3d_tpu_torch.pipeline import slam
    from hrbffusion3d_tpu_torch.utils.convert import state_to_numpy

    ts = slam.bootstrap(slam.FrameInput(t(frame[0]), t(frame[1])), PINTR, port_cfg(cfg),
                        init_pose=pose)
    f = state_to_numpy(ts)
    js = jslam.SLAMState(
        map=jsm.SurfelMap(jnp.asarray(f.pop("map.data")), jnp.asarray(f.pop("map.count"))),
        **{k: jnp.asarray(v) for k, v in f.items()})
    return ts, js


def jax_tracked_step(js, frame, cfg):
    """JAX's ``step_impl`` on one frame, arranged for compile time: the
    preprocess op by op, step_impl's own tracking call (pipeline/slam.py:
    144-162: ``build_inputs`` with the curvature maps as the config asks,
    ``track``) jitted apart, then the rest of step_impl jitted with
    ``fixed_pose`` at the tracked pose and ``pre_done``, which is the same
    computation (test_torch_slam.py).  Returns (state, the tracking
    result, the tracking inputs)."""
    from hrbffusion3d_tpu.core import lie as jlie
    from hrbffusion3d_tpu.pipeline import slam as jslam
    from hrbffusion3d_tpu.tracking import odometry as jodo

    frame = jslam.FrameInput(*(jnp.asarray(a) for a in frame))
    pre = jslam._preprocess(frame, INTR, cfg)
    depth_f, p, curv, intensity = pre
    inp = jax.jit(jodo.build_inputs, static_argnames=("cfg",))(
        next_depth=depth_f, next_intensity=intensity, next_vmap=p.vertex_filtered,
        next_nmap=p.normal, pred_vmap=js.pred_vertex, pred_nmap=js.pred_normal,
        pred_intensity=js.pred_intensity, icp_weight=js.pred_icp_weight, prev_R=js.R,
        prev_t=js.t, prev_intensity=js.prev_intensity, cfg=cfg,
        **({"next_k1": curv.k1, "next_k2": curv.k2, "pred_k1": js.pred_k1,
            "pred_k2": js.pred_k2} if cfg.icp_use_correspondence_search else {}),
        **({"sal_k1": curv.k1, "sal_k2": curv.k2} if cfg.tracking_topk > 0 else {}))
    tr = jax_track()(js.R, js.t, inp, INTR, cfg, rgb_only=False)
    js = jax.jit(jslam.step_impl, static_argnames=("intr", "cfg"))(
        js, frame, INTR, cfg, fixed_pose=jlie.rt_to_mat(tr.R, tr.t), pre_done=pre)
    return js, tr, inp


def check_step(ts, js, t_prev):
    """test_torch_slam.py's tolerances on one tracked step: the pose moved;
    t within 1e-3 m and R within 1e-3 rad of JAX; the map count within
    0.5 %; the predicted vertex within 1e-3 m on >= 99 % of the pixels
    valid in both."""
    assert np.linalg.norm(np.asarray(js.t) - t_prev) > 1e-4
    assert np.abs(n(ts.t) - np.asarray(js.t)).max() < 1e-3
    assert rot_angle(n(ts.R), np.asarray(js.R)) < 1e-3
    cj = int(js.map.count)
    assert abs(int(ts.map.count) - cj) <= 0.005 * cj
    vt, vj = n(ts.pred_vertex), np.asarray(js.pred_vertex)
    both = (vt[..., 2] > 0) & (vj[..., 2] > 0)
    assert both.mean() > 0.5
    assert (np.abs(vt - vj)[both].max(-1) < 1e-3).mean() >= 0.99
