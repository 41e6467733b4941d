"""Pose-graph / essential-graph optimisation over SE(3) (port of
``hrbffusion3d_tpu/backend/posegraph.py``).

``Optimizer::OptimizeEssentialGraph`` (Optimizer.cc:1352-1619, Sim3 with
scale fixed to 1 for RGB-D) as batched Gauss-Newton over relative-pose
edges

    e_ij = log( Z_ij^-1 T_i^-1 T_j )            (6-vector, [v|w])

with right-perturbation Jacobians (``T' = T exp(xi)``): de/dxi_j ~ I,
de/dxi_i = -Ad(T_j^-1 T_i).  The dense (K,6,K,6) system solves in one
shot up to ``CG_KEYFRAME_THRESHOLD`` keyframes, matrix-free block-Jacobi
PCG above.  Poses are world<-keyframe (Twc).

Every sum over edges (the Hessian blocks, the gradient, the
preconditioner and the PCG matvec) is a planned segment sum
(``reduce_plan``) over ``edge_i`` / ``edge_j``, built once per
``optimize`` call on the host: no colliding scatter-add, so two runs on
the card give the same bits.  Contractions run in full float32
(``full_float32``) on whichever thread calls ``optimize``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..utils.tensors import einsum, full_float32, host, matmul, sqrt
from . import reduce_plan as rp

# above this keyframe count the dense (6K,6K) assembly+solve switches to
# matrix-free block-Jacobi PCG
CG_KEYFRAME_THRESHOLD = 384


class PoseGraph(NamedTuple):
    poses: torch.Tensor     # (K,4,4) Twc
    edge_i: torch.Tensor    # (E,) int64
    edge_j: torch.Tensor    # (E,)
    meas: torch.Tensor      # (E,4,4) Z_ij = measured T_i^-1 T_j
    info: torch.Tensor      # (E,6,6) information (often w * I)
    edge_valid: torch.Tensor  # (E,)
    fixed: torch.Tensor     # (K,) bool


class GraphPlans(NamedTuple):
    """``node``: sum over the 2E rows [edge_i; edge_j] into K keyframes;
    ``cell``: sum over the 4E rows [ii; jj; ij; ji] into K*K blocks."""

    node: rp.ReducePlan
    cell: rp.ReducePlan


def build_graph_plans(g: PoseGraph) -> GraphPlans:
    K = g.poses.shape[0]
    i, j = host(g.edge_i).astype(np.int64), host(g.edge_j).astype(np.int64)
    dev = g.poses.device
    node = rp.build_reduce_plan(np.concatenate([i, j]), K, 2 * i.shape[0], dev)
    cells = np.concatenate([i * K + i, j * K + j, i * K + j, j * K + i])
    return GraphPlans(node, rp.build_reduce_plan(cells, K * K, 4 * i.shape[0], dev))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for the [v|w] tangent ordering: (...,6,6)."""
    R = T[..., :3, :3]
    top = torch.cat([R, matmul(lie.hat(T[..., :3, 3]), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A).inverse


def _linearize(g: PoseGraph):
    """Per-edge residuals and Jacobians: e (E,6), Ji/Jj (E,6,6), Iw (E,6,6)."""
    rel = matmul(_inv(g.poses[g.edge_i]), g.poses[g.edge_j])
    e = lie.se3_log(matmul(_inv(g.meas), rel))                      # (E,6)
    Jj = torch.eye(6, dtype=e.dtype, device=e.device).expand(e.shape[0], 6, 6)  # ~ Jr^-1(e)
    Ji = -adjoint(_inv(rel))                                         # de/dxi_i
    Iw = g.info * g.edge_valid[:, None, None]
    return e, Ji, Jj, Iw


def _node_sum(plans: GraphPlans, a_i: torch.Tensor, a_j: torch.Tensor, K: int):
    """sum over edges of a_i into node edge_i plus a_j into node edge_j."""
    return rp.apply_plan(plans.node, torch.cat([a_i, a_j]), K)


def _solve_dense(g: PoseGraph, e, Ji, Jj, Iw, damping: float, plans: GraphPlans):
    K = g.poses.shape[0]
    Hii = einsum("eai,eab,ebj->eij", Ji, Iw, Ji)
    Hjj = einsum("eai,eab,ebj->eij", Jj, Iw, Jj)
    Hij = einsum("eai,eab,ebj->eij", Ji, Iw, Jj)
    bi = -einsum("eai,eab,eb->ei", Ji, Iw, e)
    bj = -einsum("eai,eab,eb->ei", Jj, Iw, e)

    H = rp.apply_plan(plans.cell, torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]),
                      K * K).reshape(K, K, 6, 6)
    b = _node_sum(plans, bi, bj, K)
    gauge = torch.where(g.fixed, 1e12, 0.0).to(H.dtype)
    ar = torch.arange(K, device=H.device)
    H[ar, ar] = H[ar, ar] + (damping + gauge)[:, None, None] * torch.eye(
        6, dtype=H.dtype, device=H.device)

    Hm = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    bv = b.reshape(6 * K)
    d = sqrt(torch.abs(torch.diagonal(Hm)) + 1e-10)
    x = torch.linalg.solve_ex(Hm / d[:, None] / d[None, :], bv / d).result / d
    return x.reshape(K, 6)


def _solve_pcg(g: PoseGraph, e, Ji, Jj, Iw, damping: float, cg_iters: int,
               plans: GraphPlans):
    """Matrix-free block-Jacobi PCG: never materialises the (6K,6K)
    Hessian; each matvec is two edge gathers and one planned segment sum."""
    K = g.poses.shape[0]
    eye6 = torch.eye(6, dtype=e.dtype, device=e.device)
    gauge = damping + torch.where(g.fixed, 1e12, 0.0).to(e.dtype)   # (K,)

    b = _node_sum(plans, -einsum("eai,eab,eb->ei", Ji, Iw, e),
                  -einsum("eai,eab,eb->ei", Jj, Iw, e), K)
    Dk = _node_sum(plans, einsum("eai,eab,ebj->eij", Ji, Iw, Ji),
                   einsum("eai,eab,ebj->eij", Jj, Iw, Jj), K)
    Minv = _inv(Dk + gauge[:, None, None] * eye6 + 1e-8 * eye6)     # (K,6,6)

    def matvec(x):                                                   # x (K,6)
        u = (einsum("eij,ej->ei", Ji, x[g.edge_i])
             + einsum("eij,ej->ei", Jj, x[g.edge_j]))
        v = einsum("eij,ej->ei", Iw, u)
        y = _node_sum(plans, einsum("eji,ej->ei", Ji, v),
                      einsum("eji,ej->ei", Jj, v), K)
        return y + gauge[:, None] * x

    x = torch.zeros((K, 6), dtype=e.dtype, device=e.device)
    r = b
    z = einsum("kij,kj->ki", Minv, r)
    p = z
    for _ in range(cg_iters):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r2 = r - alpha * Ap
        z2 = einsum("kij,kj->ki", Minv, r2)
        beta = torch.sum(r2 * z2) / torch.clamp(rz, min=1e-30)
        r, z, p = r2, z2, z2 + beta * p
    return x


def _iteration(g: PoseGraph, damping: float, use_cg: bool, cg_iters: int,
               plans: GraphPlans):
    e, Ji, Jj, Iw = _linearize(g)
    if use_cg:
        dx = _solve_pcg(g, e, Ji, Jj, Iw, damping, cg_iters, plans)
    else:
        dx = _solve_dense(g, e, Ji, Jj, Iw, damping, plans)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    dx = torch.where(g.fixed[:, None], 0.0, dx)
    chi2 = torch.sum(einsum("ei,eij,ej->e", e, Iw, e))
    return g._replace(poses=matmul(g.poses, lie.se3_exp(dx))), chi2


def optimize(g: PoseGraph, iterations: int = 20, damping: float = 1e-6,
             cg_iters: int = 150, plans: GraphPlans | None = None):
    """GN iterations (the reference runs g2o LM for 20 iterations,
    Optimizer.cc:1613).  Dense solve up to CG_KEYFRAME_THRESHOLD keyframes,
    matrix-free PCG beyond.  Returns (graph with the new poses, the chi2 of
    the last linearisation)."""
    use_cg = g.poses.shape[0] > CG_KEYFRAME_THRESHOLD
    if plans is None:
        plans = build_graph_plans(g)
    with full_float32():
        chi = torch.zeros((), dtype=g.poses.dtype, device=g.poses.device)
        for _ in range(iterations):
            g, chi = _iteration(g, damping, use_cg, cg_iters, plans)
    return g, chi
