"""Bundle adjustment: batched Gauss-Newton with an explicit Schur complement
(port of ``hrbffusion3d_tpu/backend/ba.py``).

The semantics of ``Optimizer::LocalBundleAdjustment3D`` /
``BundleAdjustment3D`` (Optimizer.cc:1069-1351, 301-525): 3-D
point-to-point edges ``e = obs - Tcw(X)``, camera-space information
matrices, Huber robustification (delta^2 = 7.815) and the 5 + 10 iteration
outlier-demotion protocol.  Landmark blocks are batched 3x3 inverses; the
reduced camera system is built exactly and solved densely up to
``DENSE_SOLVER_MAX_CAMS`` cameras, by matrix-free block-Jacobi PCG above.

Differences from the JAX module, none of which changes the result beyond
float32 rounding:
  - every segment sum goes through the host-built reduction plans
    (``reduce_plan``): the indices are always concrete here, so plans are
    always built, and no colliding scatter-add runs, so two runs on the
    card give the same bits;
  - the small inverses and the dense solve use ``inv_ex`` / ``solve_ex``
    (no error-check sync); a singular block gives non-finite values that
    are masked afterwards, as in JAX;
  - PCG runs ``cg_iters`` iterations; one that the JAX stop rule would not
    have run leaves its iterates unchanged (a mask on the device), so the
    iterates are JAX's with no sync per iteration;
  - ``optimize`` runs its contractions in full float32 whatever the caller
    set, on whichever thread it runs (``full_float32``: never through the
    TF32 path, and without touching the process-global flag), as the JAX
    module pins its matmul precision.

Problem encoding (static shapes):
  cams:      (C,4,4) Tcw (world->camera, ORB-SLAM convention)
  points:    (L,3)   world landmarks
  obs:       (E,3)   observed camera-frame 3D points
  cam_idx:   (E,)    camera of each edge (int64)
  lm_idx:    (E,)    landmark of each edge (int64)
  info:      (E,3,3) information matrices
  edge_valid:(E,)    mask (padding / culled edges)
  fixed:     (C,)    bool — gauge-fixed cameras (pose held)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import lie
from ..utils.tensors import device_or_card, einsum, full_float32, host, matmul, sqrt
from . import reduce_plan as rp

HUBER_DELTA2 = 7.815  # Optimizer.cc: thHuberRGBD^2 (chi2 95%, 3 DoF)

# above this camera count the dense (C,C,6,6) build + O((6C)^3) solve is
# replaced by matrix-free PCG
DENSE_SOLVER_MAX_CAMS = 96


class BAProblem(NamedTuple):
    cams: torch.Tensor
    points: torch.Tensor
    obs: torch.Tensor
    cam_idx: torch.Tensor
    lm_idx: torch.Tensor
    info: torch.Tensor
    edge_valid: torch.Tensor
    fixed: torch.Tensor


class BAPairs(NamedTuple):
    """Edge pairs of the exact dense-S build: for every landmark l and every
    ordered pair of edges (e, f) observing l, S[cam_e, cam_f] receives
    -Y_e W_f^T.  ``optimize`` reduces them through a cell plan."""

    e: torch.Tensor  # (P,)
    f: torch.Tensor  # (P,)


def build_pairs(cam_idx, lm_idx, device=None) -> BAPairs:
    """Host-side pair lists (``reduce_plan.build_pairs_np``) on ``device``
    (that of ``lm_idx`` when it is a tensor, else the card)."""
    if device is None and isinstance(lm_idx, torch.Tensor):
        device = lm_idx.device
    device = device_or_card(device)
    e, f = rp.build_pairs_np(host(lm_idx))
    return BAPairs(torch.from_numpy(e).to(device), torch.from_numpy(f).to(device))


def depth_information(obs_cam: torch.Tensor, fx: float, fy: float,
                      sigma_px: float = 1.0) -> torch.Tensor:
    """Information matrix for a camera-frame 3D observation
    (Optimizer.cc:1216-1237): image-space covariance diag(s_px^2, s_px^2,
    s_z^2) with s_z = 0.00273 z^2 + 0.00074 z - 0.00058, pushed through the
    unprojection Jacobian J = [[z/fx,0,x/z],[0,z/fy,y/z],[0,0,1]]."""
    x, y, z = obs_cam[..., 0], obs_cam[..., 1], obs_cam[..., 2]
    sz = torch.clamp(0.00273 * z * z + 0.00074 * z - 0.00058, min=1e-5)
    zero = torch.zeros_like(z)
    zs = torch.clamp(z, min=1e-6)
    J = torch.stack([
        torch.stack([z / fx, zero, x / zs], -1),
        torch.stack([zero, z / fy, y / zs], -1),
        torch.stack([zero, zero, torch.ones_like(z)], -1),
    ], -2)
    var = torch.stack([torch.full_like(z, sigma_px ** 2), torch.full_like(z, sigma_px ** 2),
                       sz * sz], -1)
    # J diag(var) J^T elementwise: no matmul, so no TF32 whatever the caller set
    cov_cam = (J[..., :, None, :] * var[..., None, None, :] * J[..., None, :, :]).sum(-1)
    eye = torch.eye(3, dtype=cov_cam.dtype, device=cov_cam.device)
    return torch.linalg.inv_ex(cov_cam + 1e-10 * eye).inverse


def _residuals(prob: BAProblem):
    """e = obs - Tcw X  (Optimizer.h:51-57), J_cam wrt left-multiplied
    increment exp([v,w]) Tcw: de/dv = -I, de/dw = hat(p); J_lm = -Rcw."""
    T = prob.cams[prob.cam_idx]
    X = prob.points[prob.lm_idx]
    p = einsum("eij,ej->ei", T[:, :3, :3], X) + T[:, :3, 3]
    e = prob.obs - p
    eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(e.shape[0], 3, 3)
    J_cam = torch.cat([-eye, lie.hat(p)], dim=-1)    # (E,3,6)
    J_lm = -T[:, :3, :3]                             # (E,3,3)
    return e, J_cam, J_lm, p


def _robust_weight(e: torch.Tensor, info: torch.Tensor, robust: bool):
    chi2 = einsum("ei,eij,ej->e", e, info, e)
    if not robust:
        return torch.ones_like(chi2), chi2
    # Huber: w = 1 for chi2 <= d2 else delta/sqrt(chi2)
    d = HUBER_DELTA2 ** 0.5
    w = torch.where(chi2 <= HUBER_DELTA2, 1.0, d / sqrt(torch.clamp(chi2, min=1e-12)))
    return w, chi2


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _edge_blocks(prob: BAProblem, robust: bool, damping: float, plans: rp.SchurPlans):
    """Per-edge Schur ingredients shared by both solvers; every segment sum
    is a planned (deterministic) reduction."""
    C = prob.cams.shape[0]
    L = prob.points.shape[0]
    e, J_cam, J_lm, p = _residuals(prob)
    w, chi2 = _robust_weight(e, prob.info, robust)
    w = w * prob.edge_valid
    Iw = prob.info * w[:, None, None]

    Hcc_e = einsum("eai,eab,ebj->eij", J_cam, Iw, J_cam)   # (E,6,6)
    Hll_e = einsum("eai,eab,ebj->eij", J_lm, Iw, J_lm)     # (E,3,3)
    W_e = einsum("eai,eab,ebj->eij", J_cam, Iw, J_lm)      # (E,6,3)
    bc_e = -einsum("eai,eab,eb->ei", J_cam, Iw, e)         # (E,6) gradient
    bl_e = -einsum("eai,eab,eb->ei", J_lm, Iw, e)          # (E,3)

    Hcc = rp.apply_plan(plans.cam, Hcc_e, C)
    bc = rp.apply_plan(plans.cam, bc_e, C)
    Hll = rp.apply_plan(plans.lm, Hll_e, L)
    bl = rp.apply_plan(plans.lm, bl_e, L)

    # landmark block inverses (batched 3x3)
    eye3 = _eye(3, Hll)
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3 + 1e-12 * eye3).inverse
    Y_e = einsum("eij,ejk->eik", W_e, Hll_inv[prob.lm_idx])  # (E,6,3)

    # reduced gradient: rhs_a = bc_a - sum_{e: cam=a} Y_e bl[lm_e]
    ybl = einsum("eik,ek->ei", Y_e, bl[prob.lm_idx])
    rhs = bc - rp.apply_plan(plans.cam, ybl, C)
    total_chi2 = torch.sum(chi2 * prob.edge_valid)
    return W_e, Y_e, Hcc, Hll_inv, bl, rhs, total_chi2


def _solve_dense(prob: BAProblem, W_e, Y_e, Hcc, rhs, damping, plans: rp.SchurPlans):
    """Exact reduced camera system S[a,b] = Hcc δ_ab - Σ_{(e,f)} Y_e W_f^T,
    per-cell batched matmuls over the bucketed pair tables."""
    C = prob.cams.shape[0]
    S = -rp.apply_cell_plan(plans.cell, Y_e, W_e, C)
    ar = torch.arange(C, device=S.device)
    # gauge fixing: huge diagonal on fixed cameras
    gauge = torch.where(prob.fixed, 1e12, 0.0).to(S.dtype)
    S[ar, ar] = (S[ar, ar] + Hcc) + (damping + gauge)[:, None, None] * _eye(6, S)

    Sm = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    rv = rhs.reshape(6 * C)
    # diagonal preconditioning for f32
    dpre = sqrt(torch.abs(torch.diagonal(Sm)) + 1e-10)
    x = torch.linalg.solve_ex(Sm / dpre[:, None] / dpre[None, :], rv / dpre).result / dpre
    return x.reshape(C, 6)


def _solve_cg(prob: BAProblem, W_e, Y_e, Hcc, rhs, damping, cg_iters, cg_tol=1e-8,
              plans: rp.SchurPlans = None):
    """Matrix-free block-Jacobi PCG on the reduced camera system.  A matvec
    is S x = Hcc x - Y (segsum_lm W^T x[cam]) gathered back: two edge
    gathers and two planned segment sums.  Fixed (gauge) cameras are
    projected out of the Krylov space."""
    C = prob.cams.shape[0]
    L = prob.points.shape[0]
    free = (~prob.fixed.to(torch.bool))[:, None]  # (C,1)
    eye6 = _eye(6, Hcc)

    # block-Jacobi preconditioner: the diagonal blocks of S (exact when each
    # camera observes a landmark at most once)
    D = Hcc + rp.apply_plan(plans.cam, -einsum("eik,ejk->eij", Y_e, W_e), C)
    D = D + damping * eye6
    D = torch.where(free[:, :, None], D, eye6)
    Dinv = torch.linalg.inv_ex(D + 1e-10 * eye6).inverse

    def matvec(x):  # x (C,6)
        xm = torch.where(free, x, 0.0)
        t = einsum("eki,ek->ei", W_e, xm[prob.cam_idx])   # W^T x, (E,3)
        s = rp.apply_plan(plans.lm, t, L)
        v = rp.apply_plan(plans.cam, einsum("eik,ek->ei", Y_e, s[prob.lm_idx]), C)
        out = einsum("cij,cj->ci", Hcc, xm) - v + damping * xm
        return torch.where(free, out, 0.0)

    b = torch.where(free, rhs, 0.0)
    x = torch.zeros_like(b)
    r = b  # x0 = 0
    z = einsum("cij,cj->ci", Dinv, r)
    p = z
    rz = torch.sum(r * z)
    stop2 = cg_tol * cg_tol * torch.sum(b * b)
    running = torch.ones((), dtype=torch.bool, device=b.device)
    for _ in range(cg_iters):
        # the JAX while_loop's condition; once false, nothing moves again
        running = running & (torch.sum(r * r) > stop2)
        Ap = matvec(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = einsum("cij,cj->ci", Dinv, r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z_n + beta * p
        x = torch.where(running, x_n, x)
        r = torch.where(running, r_n, r)
        p = torch.where(running, p_n, p)
        rz = torch.where(running, rz_n, rz)
    return x


def _gn_iteration(prob: BAProblem, robust: bool, damping: float = 1e-6,
                  solver: str = "dense", cg_iters: int = 100,
                  plans: rp.SchurPlans = None):
    W_e, Y_e, Hcc, Hll_inv, bl, rhs, total_chi2 = _edge_blocks(prob, robust, damping, plans)
    if solver == "dense":
        dx_cam = _solve_dense(prob, W_e, Y_e, Hcc, rhs, damping, plans)
    else:
        dx_cam = _solve_cg(prob, W_e, Y_e, Hcc, rhs, damping, cg_iters, plans=plans)
    dx_cam = torch.where(torch.isfinite(dx_cam), dx_cam, 0.0)
    dx_cam = torch.where(prob.fixed[:, None], 0.0, dx_cam)

    # landmark back-substitution: dX_j = Hll_j^-1 (bl_j - W^T dxc)
    L = prob.points.shape[0]
    wtdx_e = einsum("eki,ek->ei", W_e, dx_cam[prob.cam_idx])
    WtDx = rp.apply_plan(plans.lm, wtdx_e, L)
    dx_lm = einsum("lij,lj->li", Hll_inv, bl - WtDx)
    dx_lm = torch.where(torch.isfinite(dx_lm), dx_lm, 0.0)

    new_cams = matmul(lie.se3_exp(dx_cam), prob.cams)
    return prob._replace(cams=new_cams, points=prob.points + dx_lm), total_chi2


def _next_bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def pad_problem(prob: BAProblem, lo: int = 64, collapse_pad_lms: bool = False,
                min_edges: int = 0, min_lms: int = 0, min_cams: int = 0) -> BAProblem:
    """Pad edge/landmark/camera counts to power-of-two buckets.  Padding
    edges are invalid (zero weight) and each points at its own padding
    landmark (``collapse_pad_lms``: all at one), padding cameras are
    gauge-fixed identities; ``min_*`` pre-size the buckets."""
    E, L, C = prob.obs.shape[0], prob.points.shape[0], prob.cams.shape[0]
    # E+1: at least one invalid edge exists (pad_pairs aliases padding pairs to it)
    Eb = _next_bucket(max(E + 1, min_edges), lo)
    Cb = _next_bucket(max(C, min_cams), 8)
    Lb = _next_bucket(max(L + (1 if collapse_pad_lms else Eb - E), min_lms), lo)
    dev = prob.obs.device
    if collapse_pad_lms:
        pad_lms = torch.full((Eb - E,), L, dtype=prob.lm_idx.dtype, device=dev)
    else:
        pad_lms = L + torch.arange(Eb - E, dtype=prob.lm_idx.dtype, device=dev)
    eye4 = torch.eye(4, dtype=prob.cams.dtype, device=dev).expand(Cb - C, 4, 4)
    return BAProblem(
        cams=torch.cat([prob.cams, eye4]),
        points=F.pad(prob.points, (0, 0, 0, Lb - L)),
        obs=F.pad(prob.obs, (0, 0, 0, Eb - E), value=1.0),  # z=1: demotion's p_z>0 untouched
        cam_idx=F.pad(prob.cam_idx, (0, Eb - E)),
        lm_idx=torch.cat([prob.lm_idx, pad_lms]),
        info=F.pad(prob.info, (0, 0, 0, 0, 0, Eb - E)),
        edge_valid=F.pad(prob.edge_valid, (0, Eb - E)),
        fixed=F.pad(prob.fixed, (0, Cb - C), value=True),
    )


def pad_pairs(pairs: BAPairs, invalid_edge: int, lo: int = 256) -> BAPairs:
    """Pad a pair list to a power-of-two bucket; padding pairs alias an
    INVALID edge (zero robust weight -> zero Schur contribution)."""
    P = pairs.e.shape[0]
    fill = torch.full((_next_bucket(P, lo) - P,), invalid_edge, dtype=pairs.e.dtype,
                      device=pairs.e.device)
    return BAPairs(torch.cat([pairs.e, fill]), torch.cat([pairs.f, fill]))


def build_plans(prob: BAProblem, solver: str = "dense", n_real: int | None = None,
                pairs: BAPairs | None = None, device=None) -> rp.SchurPlans:
    """Host-side reduction plans for a concrete problem, on ``device`` (that
    of ``prob`` by default).  Pass the PADDED problem and ``n_real``, the
    edge count before padding, so zero-weight padding edges never enter a
    table.  ``pairs`` (dense solver): build the cell plan from these edge
    pairs instead of from the landmark structure.  The indices come from
    the host when ``prob`` is on the host: build the plans before moving a
    problem to the card and no copy back is needed."""
    device = prob.cams.device if device is None else device
    C, L = prob.cams.shape[0], prob.points.shape[0]
    cam, lm = host(prob.cam_idx), host(prob.lm_idx)
    dense = solver == "dense"
    plans = rp.build_schur_plans(cam, lm, C, L, with_cell=dense and pairs is None,
                                 n_real=n_real, device=device)
    if dense and pairs is not None:
        plans = plans._replace(cell=rp.cell_plan_from_pairs(
            host(pairs.e), host(pairs.f), cam, C, cam.shape[0], device))
    return plans


def optimize(prob: BAProblem, iters_robust: int = 5, iters_final: int = 10,
             chi2_outlier: float = HUBER_DELTA2, solver: str = "auto",
             pairs: BAPairs | None = None, cg_iters: int = 200,
             plans: rp.SchurPlans | None = None):
    """The reference's two-phase protocol (Optimizer.cc:1258-1291):
    ``iters_robust`` Huber iterations, demote edges with chi2 > 7.815 or
    negative depth, then ``iters_final`` plain iterations.  Returns
    (problem with the new cams / points / edge_valid, the last chi2).

    ``solver="auto"`` picks the exact dense Schur solve up to
    ``DENSE_SOLVER_MAX_CAMS`` cameras and block-Jacobi PCG above.
    ``plans`` (``build_plans``): built here from the problem (or from
    ``pairs``) when not given."""
    if solver == "auto":
        solver = "dense" if prob.cams.shape[0] <= DENSE_SOLVER_MAX_CAMS else "cg"
    if plans is None:
        plans = build_plans(prob, solver, pairs=pairs)
    with full_float32():
        chi = torch.zeros((), dtype=prob.obs.dtype, device=prob.obs.device)
        for _ in range(iters_robust):
            prob, chi = _gn_iteration(prob, robust=True, solver=solver, cg_iters=cg_iters,
                                      plans=plans)
        # outlier demotion
        e, _, _, p = _residuals(prob)
        chi2 = einsum("ei,eij,ej->e", e, prob.info, e)
        good = (chi2 <= chi2_outlier) & (p[:, 2] > 0)
        prob = prob._replace(edge_valid=prob.edge_valid * good)
        for _ in range(iters_final):
            prob, chi = _gn_iteration(prob, robust=False, solver=solver, cg_iters=cg_iters,
                                      plans=plans)
    return prob, chi
