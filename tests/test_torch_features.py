"""Parity of the port's feature front end (``backend/features.py``) with the
JAX package's, on the same 128x96 frames of the synthetic orbit
(``tests/test_features.py``'s intrinsics).

The JAX detector runs at one pyramid level here (its jit compile grows
with the levels, ~5 s each); the four-level detection is held to JAX's
through the keyframes of test_torch_keyframes.py.

Tolerances: ``fast_score``, ``_nms3`` and ``_gauss_blur`` within 1e-5,
relative where the values are large (the same float32 formulas summed in
another order; FAST scores reach ~1e3, where one float32 ulp is 6e-5); on
the frames here the
port keeps every valid keypoint at the same flat index with every
descriptor bit equal (the looser card rule, >= 99 % and >= 99.5 %, is
``chip_smoke.py``'s); ``hamming_matrix`` and ``match`` exact on the same
descriptors (integers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_intr, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.backend import features as jf
from hrbffusion3d_tpu.config import CameraIntrinsics
from hrbffusion3d_tpu_torch.backend import features as tf
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
THRESHOLD = 8.0
LEVELS = 1


@pytest.fixture(scope="module")
def images():
    """Intensity (H,W) numpy of orbit frames 1 and 11 (the port's renderer;
    test_torch_core.py holds it to the JAX one)."""
    scene = synth.default_room("cpu")
    poses = synth.orbit_trajectory(30)
    return [n(pyramid.rgb_to_intensity(synth.render_frame(scene, poses[i], port_intr(INTR))[1]))
            for i in (0, 10)]


@pytest.fixture(scope="module")
def jax_kps(images):
    """One jitted JAX detection per frame (its compile dominates this file)."""
    return [jax.tree.map(np.asarray, jf.detect_and_describe_jit(
        jnp.asarray(im), n_levels=LEVELS, threshold=THRESHOLD)) for im in images]


def _pixels(xy, level) -> np.ndarray:
    """(x, y) pixel of each keypoint on its own pyramid level: its flat
    index there, as the detector's top-k chose it."""
    return np.round(np.asarray(xy) / 1.5 ** np.asarray(level)[:, None])


def _port_kp(kp) -> tf.Keypoints:
    """JAX Keypoints (numpy) -> port Keypoints on the CPU."""
    return tf.Keypoints(*(t(np.asarray(x, np.int64) if x.dtype == np.uint32 else x) for x in kp))


@pytest.mark.parametrize("fn", ["fast_score", "_nms3", "_gauss_blur"])
def test_stencils(images, fn):
    img = images[0]
    if fn == "_nms3":
        img = np.asarray(jax.jit(jf.fast_score, static_argnums=1)(jnp.asarray(img), THRESHOLD))
    args = (THRESHOLD,) if fn == "fast_score" else ()
    ref = jax.jit(getattr(jf, fn), static_argnums=tuple(range(1, 1 + len(args))))(
        jnp.asarray(img), *args)
    out = getattr(tf, fn)(t(img), *args)
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-5, atol=1e-5)


def test_detect_and_describe(images, jax_kps):
    for img, kj in zip(images, jax_kps):
        kt = tf.detect_and_describe(t(img), n_levels=LEVELS, threshold=THRESHOLD)
        v = kj.valid
        assert v.sum() > 50
        np.testing.assert_array_equal(n(kt.valid), v)
        np.testing.assert_array_equal(n(kt.level), kj.level)
        np.testing.assert_array_equal(_pixels(n(kt.xy), kj.level)[v], _pixels(kj.xy, kj.level)[v])
        np.testing.assert_allclose(n(kt.xy)[v], kj.xy[v], atol=1e-4)
        np.testing.assert_allclose(n(kt.angle)[v], kj.angle[v], atol=1e-4)
        np.testing.assert_allclose(n(kt.score), kj.score, rtol=1e-5)
        dt = tf.desc_to_numpy(kt.desc)
        bits_t = np.unpackbits(dt.view(np.uint8), axis=-1)
        bits_j = np.unpackbits(kj.desc.view(np.uint8), axis=-1)
        np.testing.assert_array_equal(bits_t[v], bits_j[v])


def test_grid_topk(images):
    sc = np.asarray(jax.jit(jf.fast_score, static_argnums=1)(jnp.asarray(images[0]), THRESHOLD))
    vj, ij = jax.jit(jf._grid_topk, static_argnums=(1, 2))(jnp.asarray(sc), 64, 4)
    vt, it = tf._grid_topk(t(sc), 64, 4)
    np.testing.assert_array_equal(n(vt), n(vj))
    np.testing.assert_array_equal(n(it), n(ij))


def test_hamming_and_match(jax_kps):
    k1, k2 = jax_kps
    ref = np.asarray(jax.jit(jf.hamming_matrix)(jnp.asarray(k1.desc), jnp.asarray(k2.desc)))
    np.testing.assert_array_equal(n(tf.hamming_matrix(_port_kp(k1).desc, _port_kp(k2).desc)), ref)
    mj = jf.match_jit(jf.Keypoints(*map(jnp.asarray, k1)), jf.Keypoints(*map(jnp.asarray, k2)))
    mt = tf.match(_port_kp(k1), _port_kp(k2))
    assert int(np.asarray(mj.valid).sum()) > 20
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(n(a), n(b))


def test_descriptor_words_round_trip(jax_kps):
    d = jax_kps[0].desc
    np.testing.assert_array_equal(tf.desc_to_numpy(tf.desc_from_numpy(d, "cpu")), d)
    assert tf.desc_from_numpy(d, "cpu").max() >= 2 ** 31   # bit 31 is carried


def test_brief_pattern_both_forms():
    for learned in (True, False):
        np.testing.assert_array_equal(tf._brief_pattern(learned=learned),
                                      jf._brief_pattern(learned=learned))


@pytest.mark.cuda
def test_detect_on_card_matches_cpu(images):
    """On the card: detection against the port on the CPU (the rule
    chip_smoke.py applies at 640x480)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    kc = tf.detect_and_describe(t(images[0]), threshold=THRESHOLD)
    kg = tf.detect_and_describe(t(images[0]).cuda(), threshold=THRESHOLD)
    v = n(kc.valid)
    lvl = n(kc.level)
    assert (_pixels(n(kg.xy), lvl) == _pixels(n(kc.xy), lvl)).all(-1)[v].mean() >= 0.99
    bits_c = np.unpackbits(tf.desc_to_numpy(kc.desc).view(np.uint8), axis=-1)
    bits_g = np.unpackbits(tf.desc_to_numpy(kg.desc).view(np.uint8), axis=-1)
    assert (bits_c == bits_g)[v].mean() >= 0.995
