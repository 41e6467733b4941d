"""Headless map viewer — the GUI's draw path without a GUI (port of
``hrbffusion3d_tpu/viz/viewer.py``).

The reference renders the global model through Pangolin with per-surfel
splats and live panel toggles (GUI/src/HRBF_fusion.cpp, GUI/src/Tools/GUI.h).
Headless, the equivalent is an offline render: project the surfel map into
a virtual camera (the same ``render_index`` z-buffer used by prediction) on
the map's device and shade it; the image comes back as uint8 numpy and is
written as PNG by the port's own ``io/png``.

Modes
-----
- ``color``  : surfel RGB with headlight Lambertian shading
- ``normal`` : world-frame normals mapped to [0,1]^3
- ``phong``  : grey Phong (the GUI's "draw normals off" look)
- ``conf``   : confidence heat (dark = unstable)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..core import lie
from ..io import png
from ..map import surfel_map as sm
from ..utils.tensors import const, host, norm


def render_view(m: sm.SurfelMap, cam_pose, intr: CameraIntrinsics,
                mode: str = "color", background: float = 0.12,
                active=None) -> np.ndarray:
    """Render the map from a virtual camera.

    ``cam_pose`` is camera-to-world (4,4); returns (H,W,3) uint8.
    One z-buffer render + one row gather."""
    dev = m.data.device
    cam_pose = const(cam_pose, dev)
    t = cam_pose[:3, 3]
    idx = sm.render_index(m, lie.se3_inverse(cam_pose), intr, active=active)
    hit = idx >= 0
    rows = m.data[torch.clamp(idx, 0, m.data.shape[0] - 1).long()]    # (H,W,24)

    pos_w = rows[..., sm.POS]
    nrm_w = rows[..., sm.NORMAL]
    col = rows[..., sm.COLOR]
    conf = rows[..., sm.CONF]

    # headlight at the camera origin
    view = t - pos_w
    view = view / torch.clamp(norm(view, dim=-1, keepdim=True), min=1e-9)
    lam = torch.abs(torch.sum(nrm_w * view, dim=-1))           # (H,W)

    if mode == "color":
        img = col * (0.25 + 0.75 * lam)[..., None]
    elif mode == "normal":
        img = 0.5 * (nrm_w + 1.0)
    elif mode == "phong":
        spec = lam ** 32
        img = (0.15 + 0.7 * lam + 0.35 * spec)[..., None].expand(*lam.shape, 3)
    elif mode == "conf":
        h = torch.clamp(conf / 10.0, 0.0, 1.0)
        img = torch.stack([h, 0.2 + 0.6 * h, 1.0 - h], dim=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    img = torch.where(hit[..., None], img, background)
    return host(torch.clamp(img * 255.0, 0, 255).to(torch.uint8))


def save_png(path: str, img: np.ndarray) -> None:
    png.write(path, img)


def turntable(m: sm.SurfelMap, intr: CameraIntrinsics, out_dir: str,
              n_views: int = 8, radius: float = 2.0, height: float = 0.0,
              look_at=(0.0, 0.0, 1.5), mode: str = "color") -> list:
    """Dump an n-view orbit around ``look_at`` (the GUI's free camera)."""
    os.makedirs(out_dir, exist_ok=True)
    look_at = np.asarray(look_at, np.float32)
    paths = []
    for k in range(n_views):
        a = 2 * np.pi * k / n_views
        eye = look_at + np.array(
            [radius * np.sin(a), height, -radius * np.cos(a)], np.float32)
        fwd = look_at - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up2, fwd, eye
        p = os.path.join(out_dir, f"view_{k:03d}.png")
        save_png(p, render_view(m, pose, intr, mode=mode))
        paths.append(p)
    return paths
