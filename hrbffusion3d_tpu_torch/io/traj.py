"""Trajectory save/load in the formats the reference supports (the port's
own copy of ``hrbffusion3d_tpu/io/traj.py``, numpy only).

Replaces ``TrajectoryManager`` (``GUI/src/Tools/TrajectoryManager.cpp``):
TUM/freiburg 'ts tx ty tz qx qy qz qw' (load l.230-283, save l.313-345) and
zhou 'frame pair lines + 4x4 matrix rows' (l.61-129, save l.346-373)."""

from __future__ import annotations

import numpy as np


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) -> (3,3)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def from_tum_line(line: str):
    vals = [float(v) for v in line.split()]
    ts = vals[0]
    t = np.asarray(vals[1:4])
    q = np.asarray(vals[4:8])
    T = np.eye(4)
    T[:3, :3] = quat_to_mat(q)
    T[:3, 3] = t
    return ts, T


def save_tum(path: str, timestamps, poses: np.ndarray):
    """Save as TUM/freiburg format (TrajectoryManager::saveTrajectory
    'TUM' branch, l.313-345)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses):
            q = mat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def load_tum(path: str):
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, T = from_tum_line(line)
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.stack(poses)


def save_zhou(path: str, poses: np.ndarray):
    """zhou format: 'i i+1 n' header line + 4 rows of the 4x4 matrix per
    frame (TrajectoryManager.cpp:346-373)."""
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            f.write(f"{i} {i + 1} {len(poses)}\n")
            for r in range(4):
                f.write(" ".join(f"{T[r, c]:.8f}" for c in range(4)) + "\n")


def load_zhou(path: str) -> np.ndarray:
    poses = []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 4 < len(lines) or (i + 4 == len(lines)):
        rows = [
            [float(v) for v in lines[i + 1 + r].split()] for r in range(4)
        ]
        poses.append(np.asarray(rows))
        i += 5
        if i >= len(lines):
            break
    return np.stack(poses)


def load_icl_nuim_rt(path: str) -> np.ndarray:
    """ICL_NUIM 'RT' format (TrajectoryManager.cpp:96-126): 3 lines of 4
    floats per frame (3x4 matrix rows), basis-changed by
    diag(-1,1,1) * T * diag(1,-1,1)."""
    vals = np.array(open(path).read().split(), np.float64)
    n = vals.size // 12
    poses = []
    t1 = np.diag([-1.0, 1.0, 1.0, 1.0])
    tr = np.diag([1.0, -1.0, 1.0, 1.0])
    for i in range(n):
        rows = vals[i * 12:(i + 1) * 12].reshape(3, 4)
        T = np.eye(4)
        T[:3, :4] = rows
        poses.append(t1 @ T @ tr)
    return np.stack(poses)


def load_lefloch(path: str) -> np.ndarray:
    """lefloch (TPAMI'17) format (TrajectoryManager.cpp:127-153): per line
    'index' + 16 floats in COLUMN-major order, right-multiplied by the
    dataset's calibration pose_init."""
    pose_init = np.array([
        [1.000000, -0.000228, 0.000007, 0.023992],
        [-0.000228, -0.999970, 0.007753, 0.003886],
        [0.000005, -0.007753, -0.999970, -0.001633],
        [0.0, 0.0, 0.0, 1.0],
    ])
    poses = []
    for line in open(path):
        parts = line.split()
        if len(parts) < 17:
            continue
        v = np.array([float(x) for x in parts[1:17]])
        T = v.reshape(4, 4, order="F")  # file stores column-major
        poses.append(T @ pose_init)
    return np.stack(poses)
