"""Parity of the port's place-recognition modules (``backend/vocab.py`` and
``backend/bow.py``) with the JAX package's, on the same descriptors: the
port's detector on three 128x96 views of the synthetic room
(``tests/test_vocab.py``'s views; the detector itself is held to JAX's in
test_torch_features.py).

Tolerances: the host training (numpy in both) and ``quantize`` (integers)
exact; bow vectors and scores within 1e-6 (float32 histograms scaled in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import n, port_intr, t

from hrbffusion3d_tpu.backend import bow as jbow
from hrbffusion3d_tpu.backend import vocab as jvocab
from hrbffusion3d_tpu.config import CameraIntrinsics
from hrbffusion3d_tpu_torch.backend import bow as tbow
from hrbffusion3d_tpu_torch.backend import features as tf
from hrbffusion3d_tpu_torch.backend import vocab as tvocab
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid

INTR = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)


@pytest.fixture(scope="module")
def views():
    """[(desc (N,8) uint32, valid (N,) bool)] of views at x = 0, 0.4, 0.9 m."""
    scene = synth.default_room("cpu")
    out = []
    for x in (0.0, 0.4, 0.9):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = x
        _, rgb = synth.render_frame(scene, T, port_intr(INTR))
        kp = tf.detect_and_describe(pyramid.rgb_to_intensity(rgb), threshold=8.0)
        out.append((tf.desc_to_numpy(kp.desc), n(kp.valid)))
    return out


@pytest.fixture(scope="module")
def trees(views):
    train = np.concatenate([d[v] for d, v in views])
    return (jvocab.VocabularyTree.train(train, k=6, depth=2),
            tvocab.VocabularyTree.train(train, k=6, depth=2, device="cpu"), train)


def test_host_training_copies(trees):
    tj, tt, train = trees
    for a, b in zip(tt.centroids, tj.centroids):
        np.testing.assert_array_equal(n(a).astype(np.uint32), n(b))
    np.testing.assert_array_equal(n(tt.idf), n(tj.idf))
    np.testing.assert_array_equal(tvocab._popcount_np(train), jvocab._popcount_np(train))
    np.testing.assert_array_equal(tvocab._kmajority(train, 5, 3), jvocab._kmajority(train, 5, 3))
    np.testing.assert_array_equal(tvocab._kmajority(train[:3], 5, 3),
                                  jvocab._kmajority(train[:3], 5, 3))


def test_quantize_and_tree_bow_vector(trees, views):
    tj, tt, _ = trees
    for d, v in views:
        wj = np.asarray(jax.jit(tj.quantize)(jnp.asarray(d)))
        wt = n(tt.quantize(tf.desc_from_numpy(d, "cpu")))
        np.testing.assert_array_equal(wt, wj)
        vj = np.asarray(jax.jit(tj.bow_vector)(jnp.asarray(d), jnp.asarray(v)))
        vt = n(tt.bow_vector(tf.desc_from_numpy(d, "cpu"), t(v)))
        np.testing.assert_allclose(vt, vj, atol=1e-6)
        assert abs(vt.sum() - 1.0) < 1e-5


def test_flat_vocabulary_bow_and_score(views):
    np.testing.assert_array_equal(tbow.vocabulary(64), jbow.vocabulary(64))
    bow_j = jax.jit(jbow.bow_vector, static_argnums=2)
    vj = [np.asarray(bow_j(jnp.asarray(d), jnp.asarray(v), 512)) for d, v in views]
    vt = [n(tbow.bow_vector(tf.desc_from_numpy(d, "cpu"), t(v))) for d, v in views]
    np.testing.assert_allclose(np.stack(vt), np.stack(vj), atol=1e-6)
    sj = np.asarray(jbow.l1_score(jnp.asarray(vj[0]), jnp.asarray(np.stack(vj[1:]))))
    st = n(tbow.l1_score(t(vt[0]), t(np.stack(vt[1:]))))
    np.testing.assert_allclose(st, sj, atol=1e-6)


@pytest.mark.parametrize("with_tree", [False, True])
def test_bow_database(trees, views, with_tree):
    tj, tt, _ = trees
    dbj = jbow.BowDatabase(tree=tj if with_tree else None)
    dbt = tbow.BowDatabase(tree=tt if with_tree else None)
    for d, v in views + views[:1]:
        dbj.add(jnp.asarray(d), jnp.asarray(v))
        dbt.add(tf.desc_from_numpy(d, "cpu"), t(v))
    for idx in range(len(views) + 1):
        np.testing.assert_allclose(dbt.query(idx, exclude=(1,)), dbj.query(idx, exclude=(1,)),
                                   atol=1e-6)
    # the repeated first view scores highest against its original
    assert int(np.argmax(dbt.query(len(views)))) == 0


@pytest.mark.cuda
def test_quantize_on_card_matches_cpu(trees, views):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    _, tt, train = trees
    tg = tvocab.VocabularyTree.train(train, k=6, depth=2)
    for d, _ in views:
        np.testing.assert_array_equal(n(tg.quantize(tf.desc_from_numpy(d, "cuda"))),
                                      n(tt.quantize(tf.desc_from_numpy(d, "cpu"))))
