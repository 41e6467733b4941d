"""SO(3)/SE(3) helpers on torch tensors (port of ``hrbffusion3d_tpu/core/lie.py``).

Poses are (R, t) pairs or 4x4 homogeneous matrices; a pose maps camera-frame
points to the world frame, ``x_w = R @ x_c + t``.  Products go through
``utils.tensors.matmul``, so that they are full float32 inside the solvers'
``full_float32`` blocks.
"""

from __future__ import annotations

import torch

from ..utils.tensors import matmul, sqrt

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (...,3) -> (...,3,3), with series fallbacks at
    theta -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    W2 = matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of Rodrigues: (...,3,3) -> (...,3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_t = torch.sin(theta)
    scale = torch.where(torch.abs(sin_t) < 1e-6,
                        0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_t + _EPS))
    return v * scale[..., None]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: xi = (...,6) as [v | w] (translation first) ->
    (...,4,4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    W = hat(w)
    W2 = matmul(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return rt_to_mat(R, matmul(V, v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) as [v | w]."""
    w = so3_log(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    theta = sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    # V^-1 = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - (theta * torch.cos(half)) / (2.0 * torch.sin(half) + _EPS)) / (theta2 + _EPS))
    W = hat(w)
    W2 = matmul(W, W)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    return torch.cat([matmul(Vinv, T[..., :3, 3, None])[..., 0], w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3),(...,3) -> (...,4,4)."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    # fill_, not item assignment: assigning a Python float to a 0-d CUDA
    # view copies it from the host and waits for the stream
    bottom[..., 0, 3].fill_(1.0)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,3) (broadcasting over leading dims)."""
    return rotate_vectors(T, pts) + T[..., :3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return matmul(T[..., :3, :3], vecs[..., None])[..., 0]


def compute_update_se3(result_rt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GN update of the accumulated odometry transform
    (``OdometryProvider::computeUpdateSE3``): x = [v|w] from the 6x6 solve;
    the incremental transform exp(x) composes on the left of the running
    estimate, ``resultRt = exp(x) * resultRt``."""
    return matmul(se3_exp(x), result_rt)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -matmul(Rt, t[..., None])[..., 0])


def orthonormalise(R: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Project a near-rotation onto SO(3): the orthogonal polar factor.

    The JAX package takes U V^T from an SVD.  For det(R) > 0 (every pose)
    that is the orthogonal polar factor, which the Newton iteration
    X <- (X + X^-T) / 2 reaches quadratically; X^-T is the cofactor matrix
    over the determinant, so the whole projection stays on the device with
    no solver call (a batched SVD on CUDA reads convergence flags back to
    the host)."""
    X = R
    for _ in range(iters):
        r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
        cof = torch.stack([torch.linalg.cross(r1, r2, dim=-1),
                           torch.linalg.cross(r2, r0, dim=-1),
                           torch.linalg.cross(r0, r1, dim=-1)], dim=-2)
        det = torch.sum(r0 * cof[..., 0, :], dim=-1)
        X = 0.5 * (X + cof / det[..., None, None])
    return X
