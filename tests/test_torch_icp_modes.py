"""Unit parity of the port's tracking residual functions with the JAX
package (``ops/icp.py``) on the finest level of a two-frame 64x48 orbit
(``torch_parity_utils.tracking_pair``), at a pose 0.01 rad and 5 mm off
the previous one.  Every input reaches both sides as the same numpy
array; the JAX side is one jitted function for the whole file.

Tolerances:
  - ``lp_shrink``: atol 1e-6 with rtol 4e-6 (XLA's and torch's float32
    ``pow`` differ in the last bits, and the fixed-point iteration
    amplifies that near the shrink threshold);
    ``sparse_icp_lambda_update``: atol 1e-6 with rtol 1e-6 (its values
    reach ~50 here, mu = 10 times metres, where a float32 ulp is 4e-6);
  - the packed tables (``pack_model``, ``pack_last``, ``pack_joint``,
    ``build_patch_table``), ``pack_sub_pixels``, the patch anchor and
    ``saliency_ids``' integer ids: equal;
  - a ``StepResult`` (A, b, residual2, count) within rtol 1e-4, with an
    atol of 1e-4 of the largest |entry| of each for the entries that sum
    to near zero; masks equal; per-pixel warps atol 1e-4 px, depths and
    association rows atol 1e-5, intensities 2e-3 grey levels (of 255: a
    bilinear lookup turns the warp's rounding into ~1e-3 where the image
    is steep);
  - ``icp_step`` at R=0 and R=1, with and without the curvature term,
    and with a lambda map (sparse ICP, its extras too);
  - ``rgb_residual`` nearest and bilinear; ``joint_step`` with the
    bilinear 36-channel table, with a carried association (no gather),
    and with the subsampled pixel set; ``joint_step_patch``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity_utils import INTR, PINTR, TRACK_CFG, n, port_cfg, t, tracking_pair

from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu.ops import icp as jicp
from hrbffusion3d_tpu.ops import pyramid as jpyr
from hrbffusion3d_tpu_torch.ops import icp as ticp

CFG = TRACK_CFG
SEARCH1 = dataclasses.replace(CFG, icp_use_correspondence_search=True, icp_search_radius=1)
BILINEAR = dataclasses.replace(CFG, tracking_rgb_nearest=False)
# mu 1000 puts the shrink threshold at 15 mm, inside this fixture's
# residuals (at the default mu 10 it is 323 mm and z is all zero)
SPARSE = dataclasses.replace(CFG, sparse_icp_mu=1000.0)
K_TOP = 768
MU, P_NORM, SHRINK_ITERS = 10.0, 0.5, 3


def _close_step(a, b):
    for x, y in zip(a, b):
        y = np.asarray(y)
        np.testing.assert_allclose(n(x), y, rtol=1e-4, atol=1e-4 * max(np.abs(y).max(), 1e-30))


def _inputs():
    """Level-0 numpy inputs: the maps, the Sobel images and photometric gate
    (JAX's, fed to both sides), the poses, a lambda map and random
    vectors."""
    ij, _, R0, t0 = tracking_pair()
    lv = {f: np.asarray(getattr(ij, f)[0]) for f in ij._fields if getattr(ij, f)}
    d_idx, d_idy = (np.asarray(x) for x in jpyr.sobel_derivatives(jnp.asarray(lv["next_intensity"])))
    min_scale = (CFG.min_gradient_magnitudes[0] ** 2) / (CFG.sobel_scale ** 2)
    sv = np.asarray(jicp.rgb_static_valid(*(jnp.asarray(x) for x in (
        lv["next_intensity"], d_idx, d_idy, lv["next_depth"])), min_scale))
    rng = np.random.default_rng(0)
    P = INTR.height * INTR.width
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.01, 0.0], jnp.float32)))
    # |h| spans the shrink threshold (0.323 at mu 10, p 0.5)
    h = rng.normal(size=(P, 3)).astype(np.float32)
    h *= (rng.uniform(0.0, 0.7, size=(P, 1)) / np.linalg.norm(h, axis=1, keepdims=True))
    Rc = (R0 @ dR).astype(np.float32)
    tc = (t0 + [0.005, -0.002, 0.003]).astype(np.float32)
    # (K R K^-1, K t) of the inverse warp, as the tracker forms them:
    # cur = prevT rt^-1, so rt^-1 = prevT^-1 cur
    rt_inv = (np.linalg.inv(np.block([[R0, t0[:, None]], [0, 0, 0, 1]]))
              @ np.block([[Rc, tc[:, None]], [0, 0, 0, 1]])).astype(np.float32)
    K = np.array([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    return dict(lv, d_idx=d_idx, d_idy=d_idy, static_valid=sv, R0=R0, t0=t0, Rc=Rc, tc=tc,
                krkinv=(K @ rt_inv[:3, :3] @ Kinv).astype(np.float32),
                kt=(K @ rt_inv[:3, 3]).astype(np.float32),
                lam=(0.01 * rng.normal(size=(P, 3))).astype(np.float32), h=h,
                found=rng.uniform(size=P) > 0.3,
                d_cp=rng.normal(size=(P, 3)).astype(np.float32),
                z=(0.01 * rng.normal(size=(P, 3))).astype(np.float32))


def _outputs(lib, x, ops, cfgs, intr):
    """Every function under test on one side: ``lib`` makes an array from
    numpy (or passes a traced one), ``ops`` is the side's icp module."""
    a = {k: lib(v) for k, v in x.items()}
    cfg, search1, bilinear, sparse = cfgs
    R0i = a["R0"].T
    pose = (a["Rc"], a["tc"], R0i, a["t0"])
    out = {}
    out["lp_shrink"] = ops.lp_shrink(a["h"], MU, P_NORM, SHRINK_ITERS)
    out["lambda"] = ops.sparse_icp_lambda_update(
        a["lam"], ops.SparseICPExtras(found=a["found"], d_cp=a["d_cp"], z=a["z"]),
        a["Rc"], a["tc"], R0i, a["t0"], a["next_vmap"], MU)
    model = ops.pack_model(a["last_vmap_g"], a["last_nmap_g"], a["icp_weight"])
    last = ops.pack_last(a["last_depth"], a["last_intensity"])
    joint = ops.pack_joint(a["last_vmap_g"], a["last_nmap_g"], a["icp_weight"],
                           a["last_depth"], a["last_intensity"])
    out.update(pack_model=model, pack_last=last, pack_joint=joint)
    live = (a["next_vmap"], a["next_nmap"])
    out["icp_r0"] = ops.icp_step(*pose, *live, model, intr, cfg)
    out["icp_r1"] = ops.icp_step(*pose, *live, model, intr, search1)
    out["icp_r1_curv"] = ops.icp_step(*pose, *live, model, intr, search1,
                                      k1_curr=a["next_k1"], k2_curr=a["next_k2"],
                                      k1_prev=a["last_k1"], k2_prev=a["last_k2"])
    out["icp_sparse"] = ops.icp_step(*pose, *live, model, intr, sparse, sparse_lambda=a["lam"])
    krkinv, kt = a["krkinv"], a["kt"]
    sv = a["static_valid"].reshape(-1)
    for name, c in (("rgb_nearest", cfg), ("rgb_bilinear", bilinear)):
        out[name] = ops.rgb_residual(krkinv, kt, a["next_depth"], a["next_intensity"], last,
                                     sv, c)
    step_args = pose + (a["next_vmap"], a["next_nmap"], a["next_depth"], joint,
                        a["next_intensity"], sv, intr, bilinear)
    out["joint_bilinear"] = ops.joint_step(*step_args)
    # a carried association: gathered at the previous pose, reused here
    assoc = ops.joint_step(a["R0"], a["t0"], R0i, a["t0"], *step_args[4:])[2]
    out["joint_assoc"] = ops.joint_step(*step_args, assoc_prev=assoc, do_gather=False)
    sub = ops.pack_sub_pixels(2, a["next_vmap"], a["next_nmap"], a["next_depth"],
                              a["next_intensity"], sv, a["d_idx"], a["d_idy"], intr)
    out["sub"] = sub
    out["joint_sub"] = ops.joint_step(*step_args, sub=sub)
    sal = (a["next_vmap"], a["next_nmap"], a["next_intensity"], sv, a["d_idx"], a["d_idy"], intr)
    out["saliency"] = ops.saliency_ids(K_TOP, *sal)
    out["saliency_curv"] = ops.saliency_ids(K_TOP, *sal, k1=a["next_k1"], k2=a["next_k2"])
    nmap_c = (a["last_nmap_g"].reshape(-1, 3) @ a["R0"]).reshape(a["last_nmap_g"].shape)
    table = ops.build_patch_table(ops.pack_patch_base(
        a["last_depth"], nmap_c, a["icp_weight"], a["last_intensity"]), 1)
    out["patch_table"] = table
    vcurr, ncurr, valid = ops.joint_cur_pack(a["next_vmap"], a["next_nmap"], a["next_depth"],
                                             intr)
    patch = ops.patch_anchor(a["R0"], a["t0"], R0i, a["t0"], vcurr, table, intr)
    out["patch_anchor"] = patch
    out["joint_patch"] = ops.joint_step_patch(*pose, patch, 1, vcurr, ncurr, valid,
                                              a["next_intensity"].reshape(-1), sv, intr, cfg)
    return out


@pytest.fixture(scope="module")
def outs():
    x = _inputs()
    jfn = jax.jit(lambda arrs: _outputs(jnp.asarray, arrs, jicp, (CFG, SEARCH1, BILINEAR, SPARSE), INTR))
    oj = jax.tree_util.tree_map(np.asarray, jfn(x))
    ot = _outputs(t, x, ticp, tuple(port_cfg(c) for c in (CFG, SEARCH1, BILINEAR, SPARSE)), PINTR)
    return oj, ot


def test_lp_shrink_and_lambda_update(outs):
    oj, ot = outs
    shrunk = np.asarray(oj["lp_shrink"])
    assert (shrunk == 0).all(axis=1).mean() > 0.1 and (shrunk != 0).any(axis=1).mean() > 0.1
    np.testing.assert_allclose(n(ot["lp_shrink"]), shrunk, atol=1e-6, rtol=4e-6)
    np.testing.assert_allclose(n(ot["lambda"]), oj["lambda"], atol=1e-6, rtol=1e-6)


def test_packed_tables(outs):
    oj, ot = outs
    for k in ("pack_model", "pack_last", "pack_joint"):
        np.testing.assert_array_equal(n(ot[k]), oj[k], err_msg=k)
    # the patch table's normals are rotated back to the camera frame by a
    # matrix product: float32 rounding
    np.testing.assert_allclose(n(ot["patch_table"]), oj["patch_table"], atol=1e-6)


@pytest.mark.parametrize("case", ["icp_r0", "icp_r1", "icp_r1_curv"])
def test_icp_step(outs, case):
    oj, ot = outs
    assert float(oj[case].count) > 500
    _close_step(ot[case], oj[case])


def test_icp_step_sparse(outs):
    oj, ot = outs
    (rj, ej), (rt, et) = oj["icp_sparse"], ot["icp_sparse"]
    _close_step(rt, rj)
    np.testing.assert_array_equal(n(et.found), ej.found)
    np.testing.assert_allclose(n(et.d_cp), ej.d_cp, atol=1e-5)
    np.testing.assert_allclose(n(et.z), ej.z, atol=1e-5)
    assert np.abs(ej.z).max() > 0


def _close_corres(ct, cj):
    np.testing.assert_array_equal(n(ct.valid), cj.valid)
    assert cj.valid.sum() > 100
    # warps in pixels, depth in metres, intensity differences in grey
    # levels (0-255: a bilinear lookup turns the warp's rounding into
    # ~1e-3 of a level where the image is steep)
    for f, tol in (("u0f", 1e-4), ("v0f", 1e-4), ("d0", 1e-5), ("diff", 2e-3)):
        np.testing.assert_allclose(n(getattr(ct, f)), getattr(cj, f), atol=tol, err_msg=f)
    np.testing.assert_allclose(float(ct.sigma_sum), float(cj.sigma_sum), rtol=1e-4)
    np.testing.assert_allclose(float(ct.count), float(cj.count), rtol=1e-4)


@pytest.mark.parametrize("case", ["rgb_nearest", "rgb_bilinear"])
def test_rgb_residual(outs, case):
    oj, ot = outs
    _close_corres(ot[case], oj[case])


@pytest.mark.parametrize("case", ["joint_bilinear", "joint_assoc", "joint_sub"])
def test_joint_step(outs, case):
    oj, ot = outs
    (it, ct, at), (ij, cj, aj) = ot[case], oj[case]
    _close_step(it, ij)
    _close_corres(ct, cj)
    # the association [v n w d | i]: the bilinear intensity as diff above
    np.testing.assert_allclose(n(at)[:, :8], aj[:, :8], atol=1e-5)
    np.testing.assert_allclose(n(at)[:, 8], aj[:, 8], atol=2e-3)


def test_pack_sub_pixels(outs):
    oj, ot = outs
    for f in ticp.SubPixels._fields:
        np.testing.assert_array_equal(n(getattr(ot["sub"], f)), getattr(oj["sub"], f), err_msg=f)


@pytest.mark.parametrize("case", ["saliency", "saliency_curv"])
def test_saliency_ids(outs, case):
    oj, ot = outs
    ids = np.asarray(oj[case])
    assert ids.shape == ((K_TOP // INTR.height) * INTR.height,)
    np.testing.assert_array_equal(n(ot[case]), ids)


def test_patch_anchor_and_step(outs):
    oj, ot = outs
    pt, pj = ot["patch_anchor"], oj["patch_anchor"]
    for f in ("au", "av", "ok"):
        np.testing.assert_array_equal(n(getattr(pt, f)), getattr(pj, f), err_msg=f)
    np.testing.assert_allclose(n(pt.rows), pj.rows, atol=1e-6)
    (it, ct), (ij, cj) = ot["joint_patch"], oj["joint_patch"]
    _close_step(it, ij)
    _close_corres(ct, cj)
