"""The port's ``ops/pyramid.rgb_to_intensity`` against the JAX package's,
jitted with XLA's CPU optimisations on (it contracts the weighted sum to a
product and two fused multiply-adds): bit for bit on 200,000 seeded pixels
and on a 128x96 synthetic frame."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hrbffusion3d_tpu.ops import pyramid as jpyramid
from hrbffusion3d_tpu_torch.config import CameraIntrinsics
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid


def _jax_intensity(rgb: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(jpyramid.rgb_to_intensity)(jnp.asarray(rgb)))


def test_rgb_to_intensity_bit_for_bit_with_xla():
    rgb = np.random.default_rng(18).random((200_000, 3), dtype=np.float32)
    out = pyramid.rgb_to_intensity(torch.from_numpy(rgb))
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), _jax_intensity(rgb))


def test_rgb_to_intensity_of_a_frame():
    pose = np.eye(4, dtype=np.float32)
    intr = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
    _, rgb = synth.render_frame(synth.default_room("cpu"), pose, intr)
    out = pyramid.rgb_to_intensity(rgb)
    assert out.shape == (96, 128)
    assert np.array_equal(out.numpy(), _jax_intensity(rgb.numpy()))
