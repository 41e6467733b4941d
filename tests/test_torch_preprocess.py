"""Parity of the port's preprocessing and pyramid ops with the JAX package
(XLA formulations), on a synthetic 64x48 frame.

Tolerances follow the JAX suite's own pairs: bilateral atol 1e-5 (same
formula, summation order), the PCA-normal and curvature rules of
tests/test_pallas_kernels.py, atol 1e-5 for the elementwise maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import CFG, INTR, PCFG, PINTR, n, port_frames, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.ops import preprocess as jpre
from hrbffusion3d_tpu.ops import pyramid as jpyr
from hrbffusion3d_tpu_torch.ops import preprocess as tpre
from hrbffusion3d_tpu_torch.ops import pyramid as tpyr

_, _FRAMES = port_frames(1)
DEPTH, RGB = _FRAMES[0]


@pytest.fixture(scope="module")
def pre_pair():
    """(JAX, port) vertex_normal_radius + curvature on the same depth.  The
    JAX side dispatches op by op: jitting the curvature stencil compiles
    for longer than it runs."""
    dj = jpre.bilateral_filter(jnp.asarray(DEPTH), CFG)
    prej = jpre.vertex_normal_radius(jnp.asarray(DEPTH), dj, INTR, CFG)
    curvj = jpre.curvature_gradient(prej, INTR, CFG)
    dt = tpre.bilateral_filter(t(DEPTH), PCFG)
    pret = tpre.vertex_normal_radius(t(DEPTH), dt, PINTR, PCFG)
    curvt = tpre.curvature_gradient(pret, PINTR, PCFG)
    return (dj, prej, curvj), (dt, pret, curvt)


def test_bilateral_filter(pre_pair):
    (dj, _, _), (dt, _, _) = pre_pair
    np.testing.assert_allclose(n(dt), n(dj), atol=1e-5)


def test_normal_pca():
    """tests/test_pallas_kernels.py::test_pca_normals_match_xla rule, on its
    fixture view (identity pose)."""
    from hrbffusion3d_tpu.core import camera as jcam
    from hrbffusion3d_tpu_torch.eval import synth

    depth, _ = synth.render_frame(synth.default_room("cpu"), np.eye(4), PINTR)
    v = np.asarray(jcam.unproject(jnp.asarray(n(depth)), INTR))
    r = n(jpre.normal_pca(jnp.asarray(v), CFG))
    o = n(tpre.normal_pca(t(v), PCFG))
    both = (np.linalg.norm(r, axis=-1) > 0.5) & (np.linalg.norm(o, axis=-1) > 0.5)
    assert both.mean() > 0.9
    assert (np.sum(r[both] * o[both], axis=-1) > 0.999).mean() > 0.99


def test_vertex_normal_radius(pre_pair):
    (_, prej, _), (_, pret, _) = pre_pair
    assert (n(pret.valid) == n(prej.valid)).mean() > 0.999
    both = n(pret.valid) & n(prej.valid)
    for f in ("vertex_raw", "vertex_filtered", "normal", "radius"):
        np.testing.assert_allclose(n(getattr(pret, f))[both], n(getattr(prej, f))[both],
                                   atol=1e-5, err_msg=f)


def test_curvature_gradient(pre_pair):
    """tests/test_pallas_kernels.py::test_curvature_matches_xla rules."""
    (_, _, ref), (_, _, out) = pre_pair
    rv, ov = n(ref.valid), n(out.valid)
    assert (rv == ov).mean() > 0.999
    both = rv & ov
    assert both.sum() > 100
    np.testing.assert_allclose(n(out.k1)[both], n(ref.k1)[both], atol=5e-2, rtol=1e-3)
    np.testing.assert_allclose(n(out.k2)[both], n(ref.k2)[both], atol=5e-2, rtol=1e-3)
    dots = np.sum(n(out.normal_opt)[both] * n(ref.normal_opt)[both], axis=-1)
    assert (dots > 0.9999).mean() > 0.99
    np.testing.assert_allclose(n(out.gradient_mag)[both], n(ref.gradient_mag)[both],
                               rtol=1e-3, atol=1e-3)


def test_update_normal_and_confidence(pre_pair):
    (_, prej, curvj), (_, pret, curvt) = pre_pair
    upj = jpre.update_normal_rad(prej, curvj, CFG)
    upt = tpre.update_normal_rad(pret, curvt, PCFG)
    agree = np.all(np.abs(n(upt.normal) - n(upj.normal)) < 1e-4, axis=-1)
    assert agree.mean() > 0.99
    for weighting in (1.0, 0.6):
        cj = jpre.confidence_map(prej, curvj, INTR, CFG, weighting=weighting)
        ct = tpre.confidence_map(pret, curvt, PINTR, PCFG, weighting=weighting)
        np.testing.assert_allclose(n(ct), n(cj), atol=1e-6)


def test_pyramid_mc_path():
    rng = np.random.default_rng(1)
    deps = np.stack([DEPTH, DEPTH * (rng.uniform(size=DEPTH.shape) > 0.1)], -1).astype(np.float32)
    ints = (rng.uniform(0, 255, DEPTH.shape + (3,))).astype(np.float32)
    np.testing.assert_allclose(n(tpyr.pyr_down_depth_mc(t(deps))),
                               n(jax.jit(jpyr.pyr_down_depth_mc)(deps)), atol=1e-5)
    np.testing.assert_allclose(n(tpyr.pyr_down_intensity_mc(t(ints))),
                               n(jax.jit(jpyr.pyr_down_intensity_mc)(ints)), atol=1e-3)
    from hrbffusion3d_tpu.core import camera as jcam

    vm = np.asarray(jcam.unproject(jnp.asarray(deps[..., 1]), INTR))
    nm = rng.standard_normal(vm.shape).astype(np.float32) * (vm[..., 2:3] > 0)
    sc = rng.uniform(size=DEPTH.shape).astype(np.float32)
    outs_j = jax.jit(jpyr.resize_maps_fused)([vm], [nm], [sc])
    outs_t = tpyr.resize_maps_fused([t(vm)], [t(nm)], [t(sc)])
    for gj, gt in zip(outs_j, outs_t):
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6)


def test_sobel_and_intensity():
    img = np.asarray(jpyr.rgb_to_intensity(jnp.asarray(RGB)))
    np.testing.assert_allclose(n(tpyr.rgb_to_intensity(t(RGB))), img, atol=1e-4)
    for a, b in zip(tpyr.sobel_derivatives(t(img)), jpyr.sobel_derivatives(jnp.asarray(img))):
        np.testing.assert_allclose(n(a), n(b), atol=1e-3)
