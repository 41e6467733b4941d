"""Parity of the port's core math (lie, camera, patches, hrbf), of its own
copies of the configuration and the trajectory metrics, and of its
synthetic-frame renderer with the JAX package, on the same seeded numpy
inputs.

Tolerance: atol 1e-6 (both sides are float32 with the same formulas; the
gap is operation order), 1e-5 where the JAX suite already allows it for the
HRBF derivatives (tests/test_hrbf.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import INTR, PINTR, jax_frames, n, port_cfg, port_frames, port_intr, t

from hrbffusion3d_tpu import config as jconfig
from hrbffusion3d_tpu.core import camera as jcam
from hrbffusion3d_tpu.eval import ate as jate
from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu.ops import hrbf as jhrbf
from hrbffusion3d_tpu.ops import patches as jpatches
from hrbffusion3d_tpu_torch.core import camera as tcam
from hrbffusion3d_tpu_torch import config as tconfig
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import ate as tate
from hrbffusion3d_tpu_torch.eval import synth as tsynth
from hrbffusion3d_tpu_torch.ops import hrbf as thrbf
from hrbffusion3d_tpu_torch.ops import patches as tpatches

RNG = np.random.default_rng(0)
W = (0.3 * RNG.standard_normal((16, 3))).astype(np.float32)
W[0] = 0.0            # the theta -> 0 series branch
W[1] = 1e-5


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "so3_log"])
def test_lie_so3(fn):
    if fn == "so3_log":
        R = np.asarray(jlie.so3_exp(jnp.asarray(W)))
        ref, out = jlie.so3_log(jnp.asarray(R)), tlie.so3_log(t(R))
    else:
        ref, out = getattr(jlie, fn)(jnp.asarray(W)), getattr(tlie, fn)(t(W))
    np.testing.assert_allclose(n(out), n(ref), atol=1e-6)


def test_lie_se3_and_orthonormalise():
    R = np.asarray(jlie.so3_exp(jnp.asarray(W)))
    tr = RNG.standard_normal((16, 3)).astype(np.float32)
    T = np.asarray(jlie.rt_to_mat(jnp.asarray(R), jnp.asarray(tr)))
    np.testing.assert_array_equal(n(tlie.rt_to_mat(t(R), t(tr))), T)
    np.testing.assert_allclose(n(tlie.se3_inverse(t(T))), n(jlie.se3_inverse(jnp.asarray(T))),
                               atol=1e-6)
    # near-rotations, as tracking produces them (det > 0)
    Rn = (R + 1e-3 * RNG.standard_normal(R.shape)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.orthonormalise(t(Rn))),
                               n(jlie.orthonormalise(jnp.asarray(Rn))), atol=1e-6)


def test_camera():
    depth = RNG.uniform(0.0, 3.0, (INTR.height, INTR.width)).astype(np.float32)
    depth[::7, ::5] = 0.0
    np.testing.assert_allclose(n(tcam.unproject(t(depth), PINTR)),
                               n(jcam.unproject(jnp.asarray(depth), INTR)), atol=1e-6)
    pts = RNG.uniform([-1, -1, 0.2], [1, 1, 3], (500, 3)).astype(np.float32)
    for a, b in zip(tcam.project(t(pts), PINTR), jcam.project(jnp.asarray(pts), INTR)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6, atol=1e-6)
    u, v, _ = jcam.project(jnp.asarray(pts), INTR)
    for a, b in zip(tcam.in_bounds(t(u), t(v), PINTR), jcam.in_bounds(u, v, INTR)):
        np.testing.assert_array_equal(n(a), n(b))
    for a, b in zip(tcam.pixel_grid(5, 7, "cpu"), jcam.pixel_grid(5, 7)):
        np.testing.assert_array_equal(n(a), n(b))
    assert tcam.mean_focal(PINTR) == jcam.mean_focal(INTR)
    assert tcam.max_radial_dist(PINTR) == jcam.max_radial_dist(INTR)


@pytest.mark.parametrize("shape,radius,fill", [((6, 9), 2, 0.0), ((6, 9, 3), 1, -1.0)])
def test_patches(shape, radius, fill):
    x = RNG.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(n(tpatches.extract_patches(t(x), radius, fill)),
                                  n(jpatches.extract_patches(jnp.asarray(x), radius, fill)))
    np.testing.assert_array_equal(n(tpatches.window_offsets(radius, "cpu")),
                                  n(jpatches.window_offsets(radius)))


def _neighbours(k=12, q=20):
    """Query points with k neighbours each, some exactly at the query
    (d2 == 0 limit) and some outside the support."""
    x = RNG.uniform(-0.05, 0.05, (q, 3)).astype(np.float32)
    pos = (x[:, None, :] + RNG.uniform(-0.06, 0.06, (q, k, 3))).astype(np.float32)
    pos[:, 0] = x
    nrm = RNG.standard_normal((q, k, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sup = RNG.uniform(0.02, 0.1, (q, k)).astype(np.float32)
    mask = RNG.uniform(size=(q, k)) > 0.2
    return x, pos, nrm, sup, mask


def test_hrbf_phi_and_field():
    x, pos, nrm, sup, mask = _neighbours()
    v = x[:, None, :] - pos
    d2 = np.sum(v * v, axis=-1)
    np.testing.assert_allclose(n(thrbf.phi(t(d2), t(sup))), n(jhrbf.phi(d2, sup)), atol=1e-6)
    np.testing.assert_allclose(n(thrbf.grad_phi(t(v), t(d2), t(sup))),
                               n(jhrbf.grad_phi(v, d2, sup)), rtol=1e-5, atol=1e-5)
    args = (x, pos, nrm, sup, mask)
    fj, cj = jhrbf.hrbf_value(*(jnp.asarray(a) for a in args))
    ft, ct = thrbf.hrbf_value(*(t(a) for a in args))
    np.testing.assert_allclose(n(ft), n(fj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(ct), n(cj))
    np.testing.assert_allclose(n(thrbf.hrbf_gradient(*(t(a) for a in args))),
                               n(jhrbf.hrbf_gradient(*(jnp.asarray(a) for a in args))),
                               rtol=1e-5, atol=1e-5)


def test_hrbf_grad_hess_direct():
    x, pos, nrm, sup, mask = _neighbours()
    v = x[:, None, :] - pos
    d2 = np.sum(v * v, axis=-1)
    gj, hj = jhrbf.grad_hess_direct(*(jnp.asarray(a) for a in (v, d2, nrm, sup, mask)))
    gt, ht = thrbf.grad_hess_direct(*(t(a) for a in (v, d2, nrm, sup, mask)))
    # relative: the per-tap coefficients reach ~1e6 near the support centre
    np.testing.assert_allclose(n(gt), n(gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(ht), n(hj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(thrbf.hess_from_h6(t(n(hj)))), n(jhrbf.hess_from_h6(hj)))


def _sphere_patch(radius=0.5, grid=9, extent=0.25):
    """Camera-facing sphere cap, map normals (n_z > 0) — tests/test_hrbf.py."""
    us, vs = np.meshgrid(np.linspace(-extent, extent, grid), np.linspace(-extent, extent, grid))
    x, y = us.ravel(), vs.ravel()
    r2 = radius * radius - x * x - y * y
    z = 2.0 - np.sqrt(np.maximum(r2, 1e-9))
    pos = np.stack([x, y, z], axis=-1).astype(np.float32)
    nrm = (-(pos - np.array([0.0, 0.0, 2.0])) / radius).astype(np.float32)
    return pos, nrm, np.full((grid * grid,), 0.35, np.float32), r2 > 0


def _plane_patch():
    xs, ys = np.meshgrid(np.linspace(-0.4, 0.4, 9), np.linspace(-0.4, 0.4, 9))
    pos = np.stack([xs.ravel(), ys.ravel(), np.ones(81)], axis=-1).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (81, 1))
    return pos, nrm, np.full((81,), 0.4, np.float32), np.ones((81,), bool)


@pytest.mark.parametrize("case", ["sphere", "plane", "random"])
def test_principal_curvatures(case):
    if case == "random":
        g = RNG.standard_normal((64, 3)).astype(np.float32)
        g[:, 2] = np.abs(g[:, 2]) + 0.2
        H = RNG.standard_normal((64, 3, 3)).astype(np.float32)
        H = 0.5 * (H + np.swapaxes(H, -1, -2))
        outs_t = thrbf.principal_curvatures(t(g), t(H))
        outs_j = jhrbf.principal_curvatures(jnp.asarray(g), jnp.asarray(H))
        for a, b in zip(outs_t, outs_j):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-5)
        return
    pos, nrm, sup, mask = _sphere_patch() if case == "sphere" else _plane_patch()
    x = np.array([0.0, 0.0, 1.5 if case == "sphere" else 1.0], np.float32)
    # the port builds the Hessian from the direct per-neighbour terms
    v = x[None] - pos
    d2 = np.sum(v * v, axis=-1)
    gt, ht = thrbf.grad_hess_direct(t(v), t(d2), t(nrm), t(sup), t(mask))
    g_t, H_t = gt.sum(0), thrbf.hess_from_h6(ht.sum(0))
    args = tuple(jnp.asarray(a) for a in (x, pos, nrm, sup, mask))
    g_j, H_j = jhrbf.hrbf_gradient(*args), jhrbf.hrbf_hessian(*args)
    # the sums cancel (tangential gradient, plane Hessian ~ 0): float32
    # summation order leaves residues of ~1e-6 of the summed magnitudes
    np.testing.assert_allclose(n(g_t), n(g_j), atol=1e-6 * float(np.abs(n(gt)).sum(0).max()))
    np.testing.assert_allclose(n(H_t), n(H_j), atol=1e-6 * float(np.abs(n(ht)).sum(0).max()))
    k1t, k2t, _, _, vt = thrbf.principal_curvatures(g_t, H_t)
    k1j, k2j, _, _, vj = jhrbf.principal_curvatures(g_j, H_j)
    # sphere and plane are umbilic (k1 == k2): the principal directions are
    # undefined there, so only the curvatures are compared
    assert bool(vt) and bool(vj)
    np.testing.assert_allclose([float(k1t), float(k2t)], [float(k1j), float(k2j)], atol=1e-3)
    expect = 2.0 if case == "sphere" else 0.0
    assert abs(float(k1t) - expect) < 0.3 and abs(float(k2t) - expect) < 0.3


def test_synth_matches_jax():
    """The port's renderer, which feeds the other parity files, against the
    JAX package's on the same orbit; then the full-system protocol's parts:
    ``complex_room`` and its quads, ``panorama_trajectory``,
    ``loopy_trajectory`` and the Kinect model on the same noise draws."""
    poses, frames = jax_frames(2, angle_per_frame=0.004)
    poses_t, frames_t = port_frames(2, angle_per_frame=0.004)
    np.testing.assert_array_equal(poses_t, poses)
    np.testing.assert_array_equal(tsynth.orbit_trajectory(2, angle_per_frame=0.004), poses)
    for (dj, cj), (dt, ct) in zip(frames, frames_t):
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
        # the cell-hash texture multiplies sin() rounding (1 ulp ~ 6e-8) by
        # 0.35 * 43758: ~1e-3 on the hashed cells
        np.testing.assert_allclose(ct, cj, atol=3e-3)

    # the full-system protocol's scene, trajectories and sensor model
    import jax

    from hrbffusion3d_tpu.eval import synth as jsynth

    for name, args in (("panorama_trajectory", (9,)), ("loopy_trajectory", (9,))):
        np.testing.assert_array_equal(getattr(tsynth, name)(*args), getattr(jsynth, name)(*args))
    pano = jsynth.panorama_trajectory(9, n_turns=1.8 * 8 / 360.0)
    np.testing.assert_array_equal(tsynth.panorama_trajectory(9, n_turns=1.8 * 8 / 360.0), pano)
    scene_j, scene_t = jsynth.complex_room(), tsynth.complex_room("cpu")
    for a, b in zip(scene_t, scene_j):
        np.testing.assert_array_equal(n(a), n(b))
    # quads in view: the desk slab and the box faces.  JAX eagerly, as
    # jax_frames renders: jitted, its fused float32 rounding moves floor
    # hits (y = 1.5, a cell edge of the texture hash) across cells
    with jax.disable_jit():
        dj, cj, nj = (np.asarray(a) for a in jsynth.render_frame_full(
            scene_j, jnp.asarray(pano[0]), INTR))
    dt, ct, nt = (n(a) for a in tsynth.render_frame_full(scene_t, pano[0], PINTR))
    no_quads = n(tsynth.render_frame_full(scene_t._replace(quads=None), pano[0], PINTR)[0])
    assert (np.abs(no_quads - dj) > 1e-3).mean() > 0.05
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct, cj, atol=3e-3)
    np.testing.assert_allclose(nt, nj, atol=1e-5)
    # Kinect noise on shared draws, split from the key as kinect_depth does
    key = jax.random.PRNGKey(1000)
    k1, k2 = jax.random.split(key)
    draws = (np.asarray(jax.random.normal(k1, dj.shape, jnp.float32)),
             np.asarray(jax.random.uniform(k2, dj.shape)))
    with jax.disable_jit():
        kj, _ = jsynth.render_frame_kinect(scene_j, jnp.asarray(pano[0]), INTR, key, 1.0)
    kt, _ = tsynth.render_frame_kinect(scene_t, pano[0], PINTR, noise=tuple(map(t, draws)))
    kj, kt = np.asarray(kj), n(kt)
    assert 0.05 < (kj == 0).mean() < 0.9 and (kj != dj).mean() > 0.5
    # equal but for a flip of the millimetre rounding or of a dropout gate
    # by float32 rounding
    assert (kt == kj).mean() > 0.999
    both = (kt > 0) & (kj > 0)
    np.testing.assert_allclose(kt[both], kj[both], atol=1.001e-3)
    gen = torch.Generator().manual_seed(1000)
    assert tsynth.render_frame_kinect(scene_t, pano[0], PINTR, gen)[0].shape == dj.shape


@pytest.mark.parametrize("name", ["default", "small_test", "TUM1", "TUM2", "TUM3", "ICL_NUIM"])
def test_config_copy_matches_jax(name):
    """The port's own config.py: every field and default of the JAX
    package's, the camera presets, and the converters of
    tests/torch_parity_utils.py give the port's classes."""
    if name.startswith(("TUM", "ICL")):
        jax_obj, port_obj = getattr(jconfig, name), getattr(tconfig, name)
        assert port_intr(jax_obj) == port_obj
        assert port_obj.level(2) == port_intr(jax_obj.level(2))
    else:
        make = "SLAMConfig" if name == "default" else "small_test_config"
        jax_obj, port_obj = getattr(jconfig, make)(), getattr(tconfig, make)()
        assert port_cfg(jax_obj) == port_obj
        assert [f.name for f in dataclasses.fields(port_obj)] == \
            [f.name for f in dataclasses.fields(jax_obj)]
    assert type(port_obj).__module__ == "hrbffusion3d_tpu_torch.config"
    assert dataclasses.asdict(port_obj) == dataclasses.asdict(jax_obj)


def test_ate_copy_matches_jax():
    """The port's own eval/ate.py against the JAX package's on a seeded
    noisy trajectory (the same numpy code: equal to float64 rounding)."""
    rng = np.random.default_rng(5)
    gt = tsynth.orbit_trajectory(12, angle_per_frame=0.02).astype(np.float64)
    est = gt.copy()
    est[:, :3, 3] += 0.01 * rng.standard_normal((12, 3))
    est[:, :3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(
        0.01 * rng.standard_normal((12, 3)), jnp.float32))) @ est[:, :3, :3]
    for align in (True, False):
        assert tate.ate_rmse(est, gt, align=align) == pytest.approx(
            jate.ate_rmse(est, gt, align=align), rel=1e-12)
    for delta in (1, 3):
        np.testing.assert_allclose(tate.rpe_rmse(est, gt, delta), jate.rpe_rmse(est, gt, delta),
                                   rtol=1e-12)
    for a, b in zip(tate.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale=True),
                    jate.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale=True)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_default_device_is_the_card():
    """Functions that make tensors without an input to take the device from
    default to the CUDA card: without one they raise, and the CPU is taken
    only when asked for."""
    if torch.cuda.is_available():
        assert tsynth.default_room().planes.device.type == "cuda"
    else:
        for make in (tsynth.default_room, lambda: tcam.pixel_grid(2, 3),
                     lambda: tpatches.window_offsets(1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    scene = tsynth.default_room("cpu")
    assert scene.planes.device.type == scene.spheres.device.type == "cpu"
    depth, _ = tsynth.render_frame(scene, np.eye(4, dtype=np.float32), PINTR)
    assert depth.device.type == "cpu" and (depth > 0).all()


def test_lie_points_and_update():
    """mat_to_rt, transform_points, rotate_vectors (batched and broadcast)
    and compute_update_se3 against JAX's (tests/test_lie.py)."""
    xi = (0.2 * RNG.standard_normal((5, 6))).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pts = RNG.standard_normal((5, 3)).astype(np.float32)
    for fn in ("transform_points", "rotate_vectors"):
        for Tm, p in ((T, pts), (T[0], pts), (T[:, None], pts[None].repeat(5, 0))):
            np.testing.assert_allclose(n(getattr(tlie, fn)(t(Tm), t(p))),
                                       n(getattr(jlie, fn)(jnp.asarray(Tm), jnp.asarray(p))),
                                       atol=1e-6)
    R, tr = tlie.mat_to_rt(t(T))
    np.testing.assert_array_equal(n(tlie.rt_to_mat(R, tr)), T)
    x = (0.05 * RNG.standard_normal(6)).astype(np.float32)
    np.testing.assert_allclose(n(tlie.compute_update_se3(t(T[1]), t(x))),
                               n(jlie.compute_update_se3(jnp.asarray(T[1]), jnp.asarray(x))),
                               atol=1e-6)


def test_third_phi_matches_jax_and_autodiff():
    """third_phi against JAX's and against torch.func's derivative of
    hess_phi (tests/test_hrbf.py::test_third_phi_matches_autodiff)."""
    sup = torch.tensor(0.4)
    for seed in range(5):
        v = np.random.default_rng(20 + seed).uniform(-0.15, 0.15, 3).astype(np.float32)
        d2 = np.float32(np.sum(v * v))
        got = thrbf.third_phi(t(v), torch.tensor(d2), sup)
        np.testing.assert_allclose(n(got), n(jhrbf.third_phi(v, d2, np.float32(0.4))),
                                   rtol=1e-5, atol=1e-3)
        want = torch.func.jacfwd(lambda u: thrbf.hess_phi(u, torch.sum(u * u), sup))(t(v))
        np.testing.assert_allclose(n(got), n(want), atol=2e-2, rtol=1e-3)
    assert not thrbf.third_phi(torch.zeros(3), torch.tensor(0.0), sup).any()


def test_hrbf_hessian_value_grad_projection():
    """hrbf_hessian, hrbf_value_grad and hrbf_projection against JAX's; the
    Hessian also against torch.func's derivative of hrbf_gradient and
    symmetric (tests/test_hrbf.py)."""
    x, pos, nrm, sup, mask = _neighbours()
    args_t = tuple(t(a) for a in (x, pos, nrm, sup, mask))
    args_j = tuple(jnp.asarray(a) for a in (x, pos, nrm, sup, mask))
    H = thrbf.hrbf_hessian(*args_t)
    Hj = n(jhrbf.hrbf_hessian(*args_j))
    np.testing.assert_allclose(n(H), Hj, rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(n(H), n(H.transpose(-1, -2)), atol=1e-3)
    want = torch.func.vmap(torch.func.jacfwd(
        lambda q, *nb: thrbf.hrbf_gradient(q, *nb)))(*args_t)
    np.testing.assert_allclose(n(H), n(want), atol=5e-1, rtol=1e-3)
    f, g, cnt = thrbf.hrbf_value_grad(*args_t)
    fj, gj, cj = jhrbf.hrbf_value_grad(*args_j)
    np.testing.assert_allclose(n(f), n(fj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(g), n(gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(cnt), n(cj))
    np.testing.assert_array_equal(n(f), n(thrbf.hrbf_value(*args_t)[0]))
    np.testing.assert_array_equal(n(g), n(thrbf.hrbf_gradient(*args_t)))
    # projection onto the plane z = 1 (tests/test_io.py::test_hrbf_projection_onto_plane)
    p_pos, p_nrm, p_sup, p_mask = _plane_patch()
    q = np.array([0.02, -0.01, 1.04], np.float32)
    proj = thrbf.hrbf_projection(t(q), t(p_pos), t(p_nrm), t(p_sup), t(p_mask))
    projj = jhrbf.hrbf_projection(*(jnp.asarray(a) for a in (q, p_pos, p_nrm, p_sup, p_mask)))
    np.testing.assert_allclose(n(proj), n(projj), atol=1e-5)
    assert abs(float(proj[2]) - 1.0) < 5e-3
    np.testing.assert_allclose(n(thrbf.hrbf_projection(*args_t)),
                               n(jhrbf.hrbf_projection(*args_j)), atol=1e-4)
