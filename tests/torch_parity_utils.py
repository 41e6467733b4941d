"""Shared fixtures of the ``test_torch_*.py`` parity tests: the same numpy
inputs go through a JAX function and its counterpart in the PyTorch port.

Sizes follow ``__graft_entry__`` (64x48 intrinsics, the small test config).
``CFG`` / ``INTR`` are the JAX package's objects, for its calls; every port
call takes the port's own ``SLAMConfig`` / ``CameraIntrinsics`` (``PCFG``,
``PINTR``, ``port_cfg``), made from the same fields.  Tier-1 runs several
xdist workers, so torch is pinned to one thread.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _CFG, _INTR

from hrbffusion3d_tpu_torch.utils.convert import config_from_fields, intrinsics_from_fields

torch.set_num_threads(1)

INTR = _INTR
# The JAX side has no compiled Pallas on the CPU: it runs the XLA raycast
# (use_pallas_raycast=False); the port always runs its kernel's semantics.
CFG = dataclasses.replace(_CFG, use_pallas_raycast=False)


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
