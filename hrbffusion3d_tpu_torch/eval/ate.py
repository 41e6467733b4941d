"""Trajectory evaluation: ATE (absolute trajectory error) with Umeyama/Horn
alignment and RPE (relative pose error), in numpy on the host.

The port's own copy of ``hrbffusion3d_tpu/eval/ate.py``; the parity tests
hold the two equal.  It replaces the external TUM evaluation scripts the
reference relies on (trajectories exported by ``TrajectoryManager.cpp`` are
compared offline).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment est -> gt.

    est, gt: (N, 3) positions.  Returns (s, R, t) with gt ≈ s R est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """ATE RMSE between (N,4,4) trajectories (camera-to-world)."""
    p_e = est_poses[:, :3, 3]
    p_g = gt_poses[:, :3, 3]
    if align:
        s, R, t = align_umeyama(p_e, p_g)
        p_e = (s * (R @ p_e.T)).T + t
    err = p_e - p_g
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """RPE (translational, rotational-deg) RMSE at frame spacing ``delta``."""
    n = est_poses.shape[0] - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )
