"""Parity of the port's landmark-sharded bundle adjustment
(``parallel/dist_ba.py``) with the JAX package's, on an 8-shard CPU mesh
(``make_mesh(8, devices=["cpu"])``) against JAX's ``make_optimizer`` on
conftest's 8 virtual devices, with the problem shapes of
``tests/test_dist_ba.py`` (``tests/test_ba._make_problem``'s construction,
from a numpy seed: ``torch_dist_child.make_problem``); JAX's solver runs
once, in a module fixture, on the port's problem.

Tolerances: the partition's arrays equal JAX's; cameras within 1e-4 (norm
of ``se3_log`` of the difference), landmarks within 1e-4 m, chi2 within
1e-4 relative (``tests/test_torch_ba.py``'s solver bounds: both sides are
float32 with the same formulas, and sum in different orders); JAX's
quality bounds of ``test_distributed_matches_single_device`` and
``exact_recovery`` on the port; two port runs equal bit for bit.  The
sharded local BA of ``SparseBackend`` is held to the port's unsharded one
(port backends only) within ``test_backend_local_ba_distributed_matches``'s
2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_child import make_problem
from torch_parity_utils import n, port_cfg, port_intr
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.backend import ba as jba
from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu.parallel import dist_ba as jdist
from hrbffusion3d_tpu.parallel import sharding as jsharding
from hrbffusion3d_tpu_torch.backend import ba as tba
from hrbffusion3d_tpu_torch.backend.keyframes import SparseBackend
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import pyramid
from hrbffusion3d_tpu_torch.parallel import dist_ba, sharding


def _problem(seed, **kw):
    """(JAX problem, port problem, gt cams, gt points) from one draw."""
    tp, gt_cams, gt_points = make_problem(seed, **kw)
    prob = jba.BAProblem(*(jnp.asarray(n(x)) for x in tp))
    return prob, tp, n(gt_cams), n(gt_points)


def _cam_err(cams, gt) -> float:
    """Largest norm of se3_log(gt_i^-1 cams_i) (tests/test_ba.py::_cam_err)."""
    d = torch.from_numpy(np.linalg.inv(np.asarray(gt, np.float64)) @ np.asarray(cams, np.float64))
    return float(torch.linalg.norm(tlie.se3_log(d), dim=-1).max())


def _solve(tp, n_shards=8):
    mesh = sharding.make_mesh(n_shards, devices=["cpu"])
    return dist_ba.make_optimizer(mesh)(dist_ba.partition_problem(tp, n_shards))


@pytest.fixture(scope="module")
def problem():
    return _problem(1, n_cams=5, n_lms=64, noise=0.003)


@pytest.fixture(scope="module")
def jax_run(problem):
    prob = problem[0]
    sb = jdist.partition_problem(prob, 8)
    cams, points, chi = jdist.make_optimizer(jsharding.make_mesh(8))(sb)
    return sb, np.asarray(cams), np.asarray(points), float(chi)


@pytest.fixture(scope="module")
def port_run(problem):
    return _solve(problem[1])


def test_partition_matches_jax(problem, jax_run):
    prob, tp = problem[:2]
    sb_j = jax_run[0]
    sb_t = dist_ba.partition_problem(tp, 8)
    assert len(sb_t.shards) == 8
    for field in ("points", "obs", "cam_idx", "lm_idx", "info", "edge_valid"):
        got = torch.cat([getattr(s, field) for s in sb_t.shards])
        np.testing.assert_array_equal(n(got), np.asarray(getattr(sb_j, field)), err_msg=field)
    np.testing.assert_array_equal(n(sb_t.cams), np.asarray(sb_j.cams))
    np.testing.assert_array_equal(n(sb_t.fixed), np.asarray(sb_j.fixed))
    # every original edge appears exactly once (tests/test_dist_ba.py)
    valid = torch.cat([s.edge_valid for s in sb_t.shards])
    obs = torch.cat([s.obs for s in sb_t.shards])[valid > 0]
    assert float(valid.sum()) == float(tp.edge_valid.sum())
    np.testing.assert_array_equal(np.sort(n(obs[:, 2])), np.sort(n(tp.obs[:, 2])))


def test_optimizer_matches_jax(jax_run, port_run):
    _, cams_j, points_j, chi_j = jax_run
    cams, points, chi = port_run
    assert _cam_err(n(cams), cams_j) < 1e-4
    np.testing.assert_allclose(n(torch.cat(points)), points_j, atol=1e-4)
    np.testing.assert_allclose(float(chi), chi_j, rtol=1e-4)


def test_distributed_matches_single_device(problem, port_run):
    _, tp, gt_cams, gt_points = problem
    single, _ = tba.optimize(tp)
    cams, points, _ = port_run
    err_single = _cam_err(n(single.cams), gt_cams)
    err_dist = _cam_err(n(cams), gt_cams)
    assert err_dist < 0.01, err_dist
    assert err_dist < 2.0 * err_single + 1e-3, (err_single, err_dist)
    pts = dist_ba.gather_points(points, 64)
    assert np.abs(pts - gt_points).max() < 0.02


def test_distributed_exact_recovery():
    _, tp, gt_cams, _ = _problem(2, n_cams=6, n_lms=48, noise=0.0)
    cams, _, chi = _solve(tp)
    assert _cam_err(n(cams), gt_cams) < 1e-3
    assert float(chi) < 1e-4


@pytest.mark.parametrize("n_shards", [8, 3])
def test_distributed_is_bit_stable(problem, port_run, n_shards):
    """Two runs of one sharded problem agree bit for bit; a 3-shard mesh
    (uneven shards) agrees with the 8-shard one to the parity bounds."""
    cams_a, pts_a, chi_a = port_run
    cams_b, pts_b, chi_b = _solve(problem[1], n_shards)
    if n_shards == 8:
        assert torch.equal(cams_a, cams_b)
        assert all(torch.equal(a, b) for a, b in zip(pts_a, pts_b))
        assert float(chi_a) == float(chi_b)
    else:
        assert _cam_err(n(cams_b), n(cams_a)) < 1e-4
        np.testing.assert_allclose(dist_ba.gather_points(pts_b, 64),
                                   dist_ba.gather_points(pts_a, 64), atol=1e-4)
        np.testing.assert_allclose(float(chi_b), float(chi_a), rtol=1e-4)


def test_backend_local_ba_distributed_matches():
    """SparseBackend.local_ba with a mesh (the sharded Schur solver) agrees
    with the unsharded path (tests/test_dist_ba.py's protocol on port
    backends: four keyframes of the orbit at 128x96, the last drifted)."""
    intr = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0,
                                      width=128, height=96))
    cfg = port_cfg(small_test_config())
    scene = synth.default_room("cpu")
    poses = synth.orbit_trajectory(40)
    drift = tlie.se3_exp(torch.tensor([0.06, -0.05, 0.04, 0.01, -0.015, 0.012])).numpy()
    frames = {}
    for tm in (1, 11, 21, 31):
        d, rgb = synth.render_frame(scene, poses[tm - 1], intr)
        frames[tm] = (pyramid.rgb_to_intensity(rgb), d)

    results, solved = {}, []
    make_optimizer = dist_ba.make_optimizer

    def counted(mesh, **kw):
        run = make_optimizer(mesh, **kw)
        return lambda sb: solved.append(mesh.size) or run(sb)

    dist_ba.make_optimizer = counted
    try:
        for name, mesh in [("single", None), ("dist", sharding.make_mesh(8, devices=["cpu"]))]:
            be = SparseBackend(intr, cfg, fast_threshold=8.0, local_window=4, mesh=mesh,
                               device="cpu")
            for k, tm in enumerate((1, 11, 21, 31)):
                g = poses[tm - 1].astype(np.float32)
                est = g if k < 3 else (drift @ g).astype(np.float32)
                be.insert_keyframe(*frames[tm], est, time=tm)
            assert be.local_ba() is not None
            results[name] = np.stack([kf.pose for kf in be.keyframes])
    finally:
        dist_ba.make_optimizer = make_optimizer
    assert solved == [8]
    np.testing.assert_allclose(results["single"], results["dist"], atol=2e-2)
