"""Hermite-RBF implicit field evaluation on torch tensors (port of
``hrbffusion3d_tpu/ops/hrbf.py``).

Wendland kernel phi(r) = (1-r)^4 (4r+1) with per-neighbour support T, and
the Hermite field f(x) = -sum_k grad_phi_k(x) . (10 n_k).  With T = support,
r = |v|/T, s = 1 - r, b = s^2 / r:
    grad phi = -(20/T^2) s^3 v
    hess phi = -(20/T^2) s^3 I + (60/T^4) b v v^T     (-(20/T^2) I at r = 0)
All functions take a query per row and a fixed-size neighbour set (K) per
row with a validity mask.
"""

from __future__ import annotations

import torch

from ..utils.tensors import norm, sqrt

_EPS = 1e-12
# Hermite coefficient scale applied to normals (hrbfbase.glsl:132 "10.0 *")
HERMITE_SCALE = 10.0


def phi(d2: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    T2 = support * support
    r = sqrt(torch.clamp(d2, min=0.0) / torch.clamp(T2, min=_EPS))
    s = torch.clamp(1.0 - r, min=0.0)
    return torch.where(d2 <= T2, (s ** 4) * (4.0 * r + 1.0), 0.0)


def grad_phi(v: torch.Tensor, d2: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """grad phi: (...,3) = t v with t = -20 s^3 / T^2 inside the support."""
    T2 = support * support
    safe_T2 = torch.clamp(T2, min=_EPS)
    r = sqrt(torch.clamp(d2, min=0.0) / safe_T2)
    s = torch.clamp(1.0 - r, min=0.0)
    t = -20.0 * (s ** 3) / safe_T2
    inside = (d2 <= T2) & (d2 > 0.0)
    return torch.where(inside[..., None], t[..., None] * v, 0.0)


def hess_phi(v: torch.Tensor, d2: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Hessian of phi: (...,3,3); -(20/T^2) I at d2 == 0."""
    T2 = support * support
    safe_T2 = torch.clamp(T2, min=_EPS)
    r = sqrt(torch.clamp(d2, min=0.0) / safe_T2)
    safe_r = torch.clamp(r, min=1e-20)
    s = torch.clamp(1.0 - r, min=0.0)
    b = s * s / safe_r
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    diag_term = (-20.0 * (s ** 3) / safe_T2)[..., None, None] * eye
    outer = v[..., :, None] * v[..., None, :]
    vv_term = (60.0 * b / (safe_T2 * safe_T2))[..., None, None] * outer
    inside = (d2 <= T2) & (d2 > 0.0)
    at_zero = d2 == 0.0
    H = torch.where(inside[..., None, None], diag_term + vv_term, 0.0)
    H_zero = (-20.0 / safe_T2)[..., None, None] * eye
    return torch.where((at_zero & (T2 > 0.0))[..., None, None], H_zero, H)


def third_phi(v: torch.Tensor, d2: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Third derivative of phi: (...,3,3,3), index order [i,j,c] =
    d^3 phi / dv_i dv_j dv_c (hrbfbase.glsl:72-124, getWeightT); zero at
    d2 == 0 and outside the support."""
    T2 = support * support
    safe_T2 = torch.clamp(T2, min=_EPS)
    r = sqrt(torch.clamp(d2, min=0.0) / safe_T2)
    safe_r = torch.clamp(r, min=1e-20)
    s = torch.clamp(1.0 - r, min=0.0)
    b = s * s / safe_r
    c60 = 60.0 / (safe_T2 * safe_T2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    # sym = d_ic v_j + d_jc v_i + d_ij v_c
    sym = (eye[..., :, None, :] * v[..., None, :, None]
           + eye[..., None, :, :] * v[..., :, None, None]
           + eye[..., :, :, None] * v[..., None, None, :])
    vvv = v[..., :, None, None] * v[..., None, :, None] * v[..., None, None, :]
    coef = (2.0 * s + b) / (safe_T2 * safe_r * safe_r)
    t = c60[..., None, None, None] * (b[..., None, None, None] * sym
                                      - coef[..., None, None, None] * vvv)
    inside = (d2 <= T2) & (d2 > 0.0)
    return torch.where(inside[..., None, None, None], t, 0.0)


def _diffs(x: torch.Tensor, nb_pos: torch.Tensor):
    v = x[..., None, :] - nb_pos
    return v, torch.sum(v * v, dim=-1)


def hrbf_value(x, nb_pos, nb_normal, nb_support, nb_mask):
    """f(x) and the per-query supporting-neighbour count.
    x: (...,3); nb_*: (...,K,*); mask: (...,K) bool."""
    v, d2 = _diffs(x, nb_pos)
    g = grad_phi(v, d2, nb_support)
    contrib = -torch.sum(g * (HERMITE_SCALE * nb_normal), dim=-1)
    m = nb_mask & (d2 < nb_support * nb_support)
    f = torch.sum(torch.where(m, contrib, 0.0), dim=-1)
    return f, torch.sum(m.to(torch.int32), dim=-1)


def hrbf_gradient(x, nb_pos, nb_normal, nb_support, nb_mask) -> torch.Tensor:
    """grad f(x): (...,3)."""
    v, d2 = _diffs(x, nb_pos)
    H = hess_phi(v, d2, nb_support)
    sol = HERMITE_SCALE * nb_normal
    g = -torch.einsum("...kij,...kj->...ki", H, sol)
    return torch.sum(torch.where(nb_mask[..., None], g, 0.0), dim=-2)


def hrbf_hessian(x, nb_pos, nb_normal, nb_support, nb_mask) -> torch.Tensor:
    """hess f(x): (...,3,3) (hrbfbase.glsl:168-195)."""
    v, d2 = _diffs(x, nb_pos)
    T3 = third_phi(v, d2, nb_support)
    sol = HERMITE_SCALE * nb_normal
    h = -torch.einsum("...kijc,...kc->...kij", T3, sol)
    return torch.sum(torch.where(nb_mask[..., None, None], h, 0.0), dim=-3)


def hrbf_value_grad(x, nb_pos, nb_normal, nb_support, nb_mask):
    """Fused (f, grad f, n_support), sharing the distance computation."""
    v, d2 = _diffs(x, nb_pos)
    sol = HERMITE_SCALE * nb_normal
    g = grad_phi(v, d2, nb_support)
    m = nb_mask & (d2 < nb_support * nb_support)
    f = torch.sum(torch.where(m, -torch.sum(g * sol, dim=-1), 0.0), dim=-1)
    H = hess_phi(v, d2, nb_support)
    gr = -torch.einsum("...kij,...kj->...ki", H, sol)
    grad = torch.sum(torch.where(nb_mask[..., None], gr, 0.0), dim=-2)
    return f, grad, torch.sum(m.to(torch.int32), dim=-1)


def hrbf_projection(x, nb_pos, nb_normal, nb_support, nb_mask,
                    iterations: int = 3) -> torch.Tensor:
    """MLS-style projection of x onto the implicit surface
    (hrbfbase.glsl:197-242, debug/utility in the reference): iterate
    x <- x - <n, x - weighted_mean> n with n the normalised HRBF gradient
    and a narrow Gaussian (sigma^2 = 1e-4) neighbourhood mean."""
    p = x
    for _ in range(iterations):
        v = p[..., None, :] - nb_pos
        d2 = torch.sum(v * v, dim=-1)
        w = torch.where(nb_mask, torch.exp(-d2 / 1e-4), 0.0)
        wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-20)
        mean = torch.sum(w[..., None] * nb_pos, dim=-2) / wsum
        g = hrbf_gradient(p, nb_pos, nb_normal, nb_support, nb_mask)
        gn = g / torch.clamp(norm(g, dim=-1, keepdim=True), min=1e-12)
        s = torch.sum(gn * (p - mean), dim=-1, keepdim=True)
        p = p - s * gn
    return p


def grad_hess_direct(v, d2, nb_normal, nb_support, nb_mask):
    """Per-neighbour contributions to (grad f, hess f) with the Hermite
    coefficient contracted analytically.  v = x - p: (...,3); d2: (...);
    returns (g (...,3), h6 (...,6) = [h00, h01, h02, h11, h12, h22])."""
    T2 = nb_support * nb_support
    safe_T2 = torch.clamp(T2, min=_EPS)
    r = sqrt(torch.clamp(d2, min=0.0) / safe_T2)
    safe_r = torch.clamp(r, min=1e-20)
    s = torch.clamp(1.0 - r, min=0.0)
    b = s * s / safe_r
    inside = nb_mask & (d2 <= T2) & (d2 > 0.0)
    at_zero = nb_mask & (d2 == 0.0) & (T2 > 0.0)

    c = HERMITE_SCALE * nb_normal
    vc = torch.sum(v * c, dim=-1)
    a = -20.0 * (s ** 3) / safe_T2
    b2 = 60.0 * b / (safe_T2 * safe_T2)
    # masks SELECT: degenerate taps give inf/nan coefficients, 0 * nan = nan
    g = (torch.where(inside[..., None], -a[..., None] * c - (b2 * vc)[..., None] * v, 0.0)
         + torch.where(at_zero[..., None], (20.0 / safe_T2)[..., None] * c, 0.0))

    c60 = 60.0 / (safe_T2 * safe_T2)
    k = (2.0 * s + b) / (safe_T2 * safe_r * safe_r)
    cb = torch.where(inside, c60 * b, 0.0)
    ck = torch.where(inside, c60 * k * vc, 0.0)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
    cbvc = cb * vc
    h00 = -(cb * 2.0 * c0 * v0 + cbvc - ck * v0 * v0)
    h11 = -(cb * 2.0 * c1 * v1 + cbvc - ck * v1 * v1)
    h22 = -(cb * 2.0 * c2 * v2 + cbvc - ck * v2 * v2)
    h01 = -(cb * (c0 * v1 + c1 * v0) - ck * v0 * v1)
    h02 = -(cb * (c0 * v2 + c2 * v0) - ck * v0 * v2)
    h12 = -(cb * (c1 * v2 + c2 * v1) - ck * v1 * v2)
    return g, torch.stack([h00, h01, h02, h11, h12, h22], dim=-1)


def hess_from_h6(h6: torch.Tensor) -> torch.Tensor:
    """[h00,h01,h02,h11,h12,h22] (..., 6) -> symmetric (..., 3, 3)."""
    h00, h01, h02, h11, h12, h22 = (h6[..., i] for i in range(6))
    return torch.stack([torch.stack([h00, h01, h02], dim=-1),
                        torch.stack([h01, h11, h12], dim=-1),
                        torch.stack([h02, h12, h22], dim=-1)], dim=-2)


def principal_curvatures(gradient: torch.Tensor, hessian: torch.Tensor):
    """Principal curvatures + directions of the implicit's Monge patch
    (depth_curvature_gradient.frag:95-137).  Returns (k1, k2, dir1, dir2,
    valid); invalid entries get k = 1000."""
    gx, gy, gz = gradient[..., 0], gradient[..., 1], gradient[..., 2]
    safe_gz = torch.where(torch.abs(gz) > 1e-9, gz, 1e-9)
    g = hessian
    h_x = -gx / safe_gz
    h_y = -gy / safe_gz
    gz3 = safe_gz ** 3
    h_xx = (2 * gx * gz * g[..., 0, 2] - gx * gx * g[..., 2, 2]
            - gz * gz * g[..., 0, 0]) / gz3
    h_xy = (gx * gz * g[..., 1, 2] + gy * gz * g[..., 0, 2]
            - gx * gy * g[..., 2, 2] - gz * gz * g[..., 0, 1]) / gz3
    h_yy = (2 * gy * gz * g[..., 1, 2] - gy * gy * g[..., 2, 2]
            - gz * gz * g[..., 1, 1]) / gz3

    E = 1.0 + h_x * h_x
    F = h_x * h_y
    G = 1.0 + h_y * h_y
    ln = sqrt(h_x * h_x + h_y * h_y + 1.0)
    L = h_xx / ln
    M = h_xy / ln
    N = h_yy / ln

    denom = E * G - F * F
    safe_denom = torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    k_gauss = (L * N - M * M) / safe_denom
    k_mean = (E * N + G * L - 2.0 * F * M) / (2.0 * safe_denom)
    sq = sqrt(torch.clamp(k_mean * k_mean - k_gauss, min=0.0))
    k1 = k_mean + sq
    k2 = k_mean - sq

    d1_den = N - k1 * G
    d2_den = N - k2 * G
    lam1 = -(M - k1 * F) / torch.where(torch.abs(d1_den) > 1e-9, d1_den, 1e-9)
    lam2 = -(M - k2 * F) / torch.where(torch.abs(d2_den) > 1e-9, d2_den, 1e-9)
    one, zero = torch.ones_like(h_x), torch.zeros_like(h_x)
    r_u = torch.stack([one, zero, h_x], dim=-1)
    r_v = torch.stack([zero, one, h_y], dim=-1)

    def _norm(v):
        return v / torch.clamp(norm(v, dim=-1, keepdim=True), min=1e-12)

    dir1 = _norm(r_u + lam1[..., None] * r_v)
    dir2 = _norm(r_u + lam2[..., None] * r_v)

    valid = torch.isfinite(k1) & torch.isfinite(k2)
    k1 = torch.where(valid, k1, 1000.0)
    k2 = torch.where(valid, k2, 1000.0)
    return k1, k2, dir1, dir2, valid
