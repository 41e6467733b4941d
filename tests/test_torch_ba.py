"""Parity of the port's solvers with the JAX package's: ``core/lie``'s SE(3)
maps, ``backend/reduce_plan.py``, ``backend/ba.py`` and
``backend/posegraph.py``, on the small problems of ``tests/test_ba.py``
(``_make_problem``: 6 cameras, 60 landmarks, every camera sees every
landmark, the first two fixed) and ``tests/test_posegraph.py``
(``_chain_problem``: a drifted ring of 12 or 16 poses), made here from a
numpy seed.  Each JAX solver runs jitted, once per file.

Tolerances: plan tables equal; ``apply_plan`` within 1e-6 relative; one GN
iteration's reduced camera system and rhs within 1e-4 relative;
``ba.optimize`` (dense and cg) cameras within 1e-4 (norm of ``se3_log`` of
the difference) and points within 1e-4 m; ``posegraph.optimize`` poses
within 1e-4.  Both sides are float32 with the same formulas: the gaps are
summation order (planned sums here, colliding scatters in places there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import n, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.backend import ba as jba
from hrbffusion3d_tpu.backend import posegraph as jpg
from hrbffusion3d_tpu.backend import reduce_plan as jrp
from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu_torch.backend import ba as tba
from hrbffusion3d_tpu_torch.backend import posegraph as tpg
from hrbffusion3d_tpu_torch.backend import reduce_plan as trp
from hrbffusion3d_tpu_torch.core import lie as tlie

RNG = np.random.default_rng(0)


def _pose_err(a, b) -> float:
    """Largest norm of se3_log(a_i^-1 b_i) over a batch of poses (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = torch.from_numpy(np.linalg.inv(a) @ b)
    return float(torch.linalg.norm(tlie.se3_log(d), dim=-1).max())


def _make_problem(seed, n_cams=6, n_lms=60, noise=0.002, perturb=0.05):
    """tests/test_ba.py::_make_problem from a numpy seed: (JAX, port) problems."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0], xi[:, 1], xi[:, 4] = 0.1, 0.02, 0.05
    gt_cams = tlie.se3_exp(t(xi * np.arange(n_cams, dtype=np.float32)[:, None]))
    gt_points = t(rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 3.5], (n_lms, 3)).astype(np.float32))
    cam_idx = torch.arange(n_cams).repeat_interleave(n_lms)
    lm_idx = torch.arange(n_lms).repeat(n_cams)
    T = gt_cams[cam_idx]
    obs = torch.einsum("eij,ej->ei", T[:, :3, :3], gt_points[lm_idx]) + T[:, :3, 3]
    obs = obs + noise * t(rng.standard_normal(obs.shape).astype(np.float32))
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[:2] = True
    dx = t((perturb * rng.standard_normal((n_cams, 6))).astype(np.float32))
    dx[fixed] = 0.0
    tp = tba.BAProblem(
        cams=tlie.se3_exp(dx) @ gt_cams,
        points=gt_points + t((perturb * rng.standard_normal((n_lms, 3))).astype(np.float32)),
        obs=obs, cam_idx=cam_idx, lm_idx=lm_idx,
        info=tba.depth_information(obs, 500.0, 500.0),
        edge_valid=torch.ones(obs.shape[0]), fixed=fixed)
    prob = jba.BAProblem(*(jnp.asarray(n(x)) for x in tp))
    return prob._replace(cam_idx=prob.cam_idx.astype(jnp.int32),
                         lm_idx=prob.lm_idx.astype(jnp.int32)), tp


def _chain_problem(seed, n_kf=12, drift=0.02, loop=True):
    """tests/test_posegraph.py::_chain_problem from a numpy seed: poses
    around a circle, exact odometry edges and one exact loop edge, the
    initial estimate integrating drifty odometry.  (JAX, port) graphs."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_kf) / n_kf
    xi = np.stack([0.5 * np.cos(ang), 0.5 * np.sin(ang), 0 * ang, 0 * ang, 0 * ang, ang], -1)
    gt = n(tlie.se3_exp(t(xi.astype(np.float32))))
    ei, ej = list(range(n_kf - 1)), list(range(1, n_kf))
    if loop:
        ei.append(n_kf - 1)
        ej.append(0)
    meas = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(ei, ej)]).astype(np.float32)
    noise = n(tlie.se3_exp(t((drift * rng.standard_normal((n_kf, 6))).astype(np.float32))))
    est = [gt[0]]
    for i in range(n_kf - 1):
        est.append(est[-1] @ meas[i] @ noise[i])
    E = len(ei)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    fields = dict(poses=np.stack(est).astype(np.float32), edge_i=np.asarray(ei),
                  edge_j=np.asarray(ej), meas=meas,
                  info=np.tile(np.eye(6, dtype=np.float32), (E, 1, 1)),
                  edge_valid=np.ones(E, np.float32), fixed=fixed)
    g = jpg.PoseGraph(**{k: jnp.asarray(v.astype(np.int32) if k in ("edge_i", "edge_j") else v)
                         for k, v in fields.items()})
    return g, tpg.PoseGraph(**{k: t(v) for k, v in fields.items()})


@pytest.fixture(scope="module")
def problem():
    return _make_problem(5)


@pytest.fixture(scope="module")
def jax_optimized(problem):
    """JAX's optimize, dense and cg, once each (shared by two tests)."""
    prob, _ = problem
    return {s: jax.tree.map(np.asarray, jba.optimize(prob, solver=s, cg_iters=300))
            for s in ("dense", "cg")}


def test_se3_exp_log():
    xi = (0.3 * RNG.standard_normal((16, 6))).astype(np.float32)
    xi[0, 3:] = 0.0          # the theta -> 0 series branch
    xi[1, 3:] = 1e-5
    T = tlie.se3_exp(t(xi))
    np.testing.assert_allclose(n(T), n(jax.jit(jlie.se3_exp)(jnp.asarray(xi))), atol=1e-6)
    np.testing.assert_allclose(n(tlie.se3_log(T)), n(jax.jit(jlie.se3_log)(jnp.asarray(n(T)))),
                               atol=1e-6)
    np.testing.assert_allclose(n(tlie.se3_log(T)), xi, atol=1e-5)


def test_reduce_plan_tables_and_apply():
    ids = RNG.integers(0, 50, 700)
    ids[:40] = 7            # one target over the first rungs
    pj, pt = jrp.build_reduce_plan(ids, 50, 800), trp.build_reduce_plan(ids, 50, 800, "cpu")
    assert len(pj.tables) == len(pt.tables) > 2
    for (ij, rj), (it, rt) in zip(pj.tables, pt.tables):
        np.testing.assert_array_equal(n(it), n(ij))
        np.testing.assert_array_equal(n(rt), n(rj))
    data = RNG.standard_normal((800, 6, 3)).astype(np.float32)
    ref = n(jax.jit(jrp.apply_plan, static_argnums=2)(pj, jnp.asarray(data), 50))
    out = n(trp.apply_plan(pt, t(data), 50))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    direct = np.zeros((50, 6, 3))
    np.add.at(direct, ids, data[:700].astype(np.float64))
    np.testing.assert_allclose(out, direct, rtol=1e-5, atol=1e-5)


def test_cell_and_schur_plans(problem):
    prob, tp = problem
    pe, pf = jrp.build_pairs_np(n(prob.lm_idx))
    qe, qf = trp.build_pairs_np(n(tp.lm_idx))
    np.testing.assert_array_equal(qe, pe)
    np.testing.assert_array_equal(qf, pf)
    pj = jba.build_plans(prob, "dense")
    pt = tba.build_plans(tp, "dense")
    for kind in ("cam", "lm", "cell"):
        tj, tt = getattr(pj, kind).tables, getattr(pt, kind).tables
        assert len(tj) == len(tt)
        for a, b in zip(tj, tt):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(n(y), n(x))


def test_gn_iteration_reduced_system(problem):
    prob, tp = problem
    pj, pt = jba.build_plans(prob, "dense"), tba.build_plans(tp, "dense")

    @jax.jit
    def reduced(prob, pj):
        with jax.default_matmul_precision("float32"):
            W, Y, Hcc, _, _, rhs, chi = jba._edge_blocks(prob, True, 1e-6, plans=pj)
            S = jrp.apply_cell_plan(pj.cell, Y, W, prob.cams.shape[0])
            return S, Hcc, rhs, chi, jba._gn_iteration(prob, robust=True, plans=pj)[0]

    S, Hcc, rhs, chi, new_j = reduced(prob, pj)
    Wt, Yt, Hcct, _, _, rhst, chit = tba._edge_blocks(tp, True, 1e-6, pt)
    St = trp.apply_cell_plan(pt.cell, Yt, Wt, tp.cams.shape[0])
    new_t, _ = tba._gn_iteration(tp, robust=True, plans=pt)
    for a, b in ((St, S), (Hcct, Hcc), (rhst, rhs), (chit, chi)):
        b = n(b)
        np.testing.assert_allclose(n(a), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    assert _pose_err(n(new_t.cams), n(new_j.cams)) < 1e-4
    np.testing.assert_allclose(n(new_t.points), n(new_j.points), atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize(problem, jax_optimized, solver):
    _, tp = problem
    oj, cj = jax_optimized[solver]
    ot, ct = tba.optimize(tp, solver=solver, cg_iters=300)
    assert _pose_err(n(ot.cams), n(oj.cams)) < 1e-4
    np.testing.assert_allclose(n(ot.points), n(oj.points), atol=1e-4)
    np.testing.assert_array_equal(n(ot.edge_valid), n(oj.edge_valid))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


def test_padded_problem_and_pairs(problem, jax_optimized):
    """pad_problem and the pair lists equal JAX's; the pair-list path
    (through a cell plan here) gives the result of JAX's plans path."""
    prob, tp = problem
    E = prob.obs.shape[0]
    padj, padt = jba.pad_problem(prob), tba.pad_problem(tp)
    for a, b in zip(padt, padj):
        np.testing.assert_array_equal(n(a), n(b))
    pairs_j = jba.pad_pairs(jba.build_pairs(padj.cam_idx, padj.lm_idx), invalid_edge=E)
    pairs_t = tba.pad_pairs(tba.build_pairs(padt.cam_idx, padt.lm_idx), invalid_edge=E)
    for a, b in zip(pairs_t, pairs_j):
        np.testing.assert_array_equal(n(a), n(b))
    oj, _ = jax_optimized["dense"]
    ot, _ = tba.optimize(padt, solver="dense", pairs=pairs_t)
    C, L = prob.cams.shape[0], prob.points.shape[0]
    assert _pose_err(n(ot.cams)[:C], oj.cams) < 1e-4
    np.testing.assert_allclose(n(ot.points)[:L], oj.points, atol=1e-4)


def test_depth_information():
    obs = RNG.uniform([-1, -1, 0.4], [1, 1, 4], (64, 3)).astype(np.float32)
    ref = n(jax.jit(jba.depth_information, static_argnums=(1, 2))(jnp.asarray(obs), 500.0, 500.0))
    np.testing.assert_allclose(n(tba.depth_information(t(obs), 500.0, 500.0)), ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())


def test_posegraph_adjoint():
    T = n(tlie.se3_exp(t(RNG.standard_normal((8, 6)).astype(np.float32))))
    np.testing.assert_allclose(n(tpg.adjoint(t(T))), n(jax.jit(jpg.adjoint)(jnp.asarray(T))),
                               atol=1e-6)


def test_posegraph_optimize():
    g, tg = _chain_problem(0)
    gj, cj = jpg.optimize_jit(g, iterations=25)
    gt_, ct = tpg.optimize(tg, iterations=25)
    assert _pose_err(n(gt_.poses), n(gj.poses)) < 1e-4
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3, atol=1e-8)


def test_posegraph_pcg_and_dense_solves():
    g, tg = _chain_problem(3, n_kf=16)

    @jax.jit
    def solves(g):
        with jax.default_matmul_precision("float32"):
            lin = jpg._linearize(g)
            return lin, jpg._solve_dense(g, *lin, 1e-6), jpg._solve_pcg(g, *lin, 1e-6, 200)

    lin, dj, cj = solves(g)
    lin_t = tpg._linearize(tg)
    plans = tpg.build_graph_plans(tg)
    for a, b in zip(lin_t, lin):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5)
    dt = tpg._solve_dense(tg, *lin_t, 1e-6, plans)
    ct = tpg._solve_pcg(tg, *lin_t, 1e-6, 200, plans)
    free = ~n(g.fixed)
    np.testing.assert_allclose(n(dt)[free], n(dj)[free], atol=1e-4)
    np.testing.assert_allclose(n(ct)[free], n(cj)[free], atol=1e-4)


class _CardOperand:
    """Stands in for a float32 CUDA tensor in ``tensors._exact_needed``."""
    is_cuda = True
    dtype = torch.float32


def test_full_float32_restores_the_callers_setting():
    """Inside the block a float32 CUDA contraction takes the exact path
    (``tensors._exact_needed``, the switch ``einsum`` / ``matmul`` use),
    whatever the process-global TF32 flag says, and the flag stays what
    the caller set, during the block and after it; outside the block, and
    for a CPU operand, the normal path."""
    from hrbffusion3d_tpu_torch.utils import tensors

    card, cpu = _CardOperand(), torch.zeros(2)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            assert not tensors._exact_needed(card)
            with tensors.full_float32():
                with tensors.full_float32():
                    assert tensors._exact_needed(card)
                assert tensors._exact_needed(card) and not tensors._exact_needed(cpu)
                assert torch.backends.cuda.matmul.allow_tf32 == flag
            assert not tensors._exact_needed(card)
            assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_full_float32_is_per_thread():
    """A solve on a worker thread takes the exact path inside
    ``full_float32`` while the main thread, outside it, holds the global
    TF32 flag on and turns it off mid-solve: the main thread's contractions
    keep the normal path and its flag is never written (FullSLAM's async
    worker)."""
    import threading

    from hrbffusion3d_tpu_torch.utils import tensors

    card = _CardOperand()
    saved = torch.backends.cuda.matmul.allow_tf32
    inside, flipped, seen = threading.Event(), threading.Event(), {}

    def worker():
        with tensors.full_float32():
            seen["worker_before_flip"] = tensors._exact_needed(card)
            inside.set()
            flipped.wait(30)
            seen["worker_after_flip"] = tensors._exact_needed(card)
        seen["worker_after"] = tensors._exact_needed(card)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        th = threading.Thread(target=worker)
        th.start()
        assert inside.wait(30)
        seen["main"] = tensors._exact_needed(card)
        seen["flag"] = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        flipped.set()
        th.join(30)
        assert seen == {"worker_before_flip": True, "worker_after_flip": True, "main": False,
                        "flag": True, "worker_after": False}
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_exact_contraction_path(problem, monkeypatch):
    """The card's path inside ``full_float32`` (broadcast products and
    sums, no matmul), forced here on the CPU by taking float32 CPU operands
    for card ones: every einsum of the solvers equals ``torch.einsum``, the
    solvers reach the exact path only inside their ``full_float32``, and
    ``ba.optimize`` / ``posegraph.optimize`` through it give the normal
    path's result within float32 rounding (poses 1e-5)."""
    import re

    from hrbffusion3d_tpu_torch.utils import tensors

    g = torch.Generator().manual_seed(0)
    size = dict(a=3, b=3, c=5, e=7, i=6, j=6, k=3, l=4)
    src = open(tba.__file__).read() + open(tpg.__file__).read()
    for eq in sorted(set(re.findall(r'einsum\("([^"]+)"', src))):
        ops = [torch.randn([size[c] for c in sub], generator=g)
               for sub in eq.split("->")[0].split(",")]
        np.testing.assert_allclose(n(tensors.exact_einsum(eq, *ops)), n(torch.einsum(eq, *ops)),
                                   rtol=1e-5, atol=1e-5, err_msg=eq)
    _, tp = problem
    ref, _ = tba.optimize(tp, solver="dense")
    gref, _ = tpg.optimize(_chain_problem(0)[1], iterations=25)
    monkeypatch.setattr(tensors, "_float32_on_card", lambda x: x.dtype == torch.float32)
    exact_calls = [0]
    exact_einsum = tensors.exact_einsum

    def counted(*args):
        exact_calls[0] += 1
        return exact_einsum(*args)

    monkeypatch.setattr(tensors, "exact_einsum", counted)
    tensors.einsum("ij,j->i", torch.ones(2, 2), torch.ones(2))
    assert exact_calls[0] == 0
    out, _ = tba.optimize(tp, solver="dense")
    gout, _ = tpg.optimize(_chain_problem(0)[1], iterations=25)
    assert exact_calls[0] > 0
    assert _pose_err(n(out.cams), n(ref.cams)) < 1e-5
    np.testing.assert_allclose(n(out.points), n(ref.points), atol=1e-5)
    assert _pose_err(n(gout.poses), n(gref.poses)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_ba_on_card_is_bit_stable_and_matches_cpu(problem, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    _, tp = problem
    oc, _ = tba.optimize(tp, solver=solver)
    gp = tba.BAProblem(*(x.cuda() for x in tp))
    o1, c1 = tba.optimize(gp, solver=solver)
    o2, c2 = tba.optimize(gp, solver=solver)
    assert torch.equal(o1.cams, o2.cams) and torch.equal(o1.points, o2.points)
    assert torch.equal(c1, c2)
    assert _pose_err(n(o1.cams), n(oc.cams)) < 1e-4
