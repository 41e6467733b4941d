"""Synthetic RGB-D scene renderer on torch tensors (port of the parts of
``hrbffusion3d_tpu/eval/synth.py`` the dense step needs): analytic spheres
and planes forming a room, exact z-depth and a procedural texture, rendered
at a camera-to-world pose on the scene's device (the card unless the caller
names another).  Frames are exact, so no random generator is involved.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..utils.tensors import const, device_or_card


class Scene(NamedTuple):
    """spheres (M,4) = [cx,cy,cz,r]; planes (K,4) = [nx,ny,nz,d] with
    n.x = d and n pointing into the room."""

    spheres: torch.Tensor
    planes: torch.Tensor


def default_room(device=None, dtype=torch.float32) -> Scene:
    """A 6x6x6 m room centred at the origin with three spheres in front of
    the default camera start (camera looks down +z), on ``device`` (default
    the CUDA card; raises without one unless ``device="cpu"``)."""
    device = device_or_card(device)
    planes = const([
        [0.0, -1.0, 0.0, -1.5],   # floor y = +1.5 (camera y points down)
        [0.0, 1.0, 0.0, -2.0],    # ceiling y = -2
        [0.0, 0.0, -1.0, -3.2],   # back wall z = 3.2
        [0.0, 0.0, 1.0, -2.0],    # front wall z = -2
        [1.0, 0.0, 0.0, -2.2],    # left x = -2.2
        [-1.0, 0.0, 0.0, -2.2],   # right x = 2.2
    ], device, dtype)
    spheres = const([
        [0.0, 0.9, 2.2, 0.6],
        [-0.9, 1.1, 1.7, 0.4],
        [0.8, 1.2, 1.9, 0.3],
    ], device, dtype)
    return Scene(spheres=spheres, planes=planes)


def _texture(p: torch.Tensor) -> torch.Tensor:
    """Procedural 3-D texture -> rgb in [0,1]: band-limited sinusoids plus
    a cell-hash block pattern."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = (0.5 + 0.25 * torch.sin(7.0 * x) * torch.cos(5.0 * z) + 0.12 * torch.sin(3.0 * y)
         + 0.18 * torch.sin(9.5 * x + 1.7 * z))
    g = (0.5 + 0.25 * torch.sin(6.0 * y + 1.3) * torch.cos(4.0 * x) + 0.1 * torch.cos(9.0 * z)
         + 0.18 * torch.cos(8.5 * y + 2.0 * x))
    b = (0.5 + 0.25 * torch.cos(8.0 * z + 0.7) * torch.sin(5.0 * y)
         + 0.18 * torch.sin(9.0 * (x + y)))
    smooth = torch.stack([r, g, b], dim=-1)
    cell = torch.floor(p / 0.3)
    h1 = torch.sin(cell[..., 0] * 12.9898 + cell[..., 1] * 78.233 + cell[..., 2] * 37.719)
    blocks = torch.remainder(h1 * 43758.5453, 1.0)
    return torch.clamp(0.65 * smooth + 0.35 * blocks[..., None], 0.0, 1.0)


def render_frame_full(scene: Scene, pose_wc: torch.Tensor, intr: CameraIntrinsics):
    """Render (depth (H,W), rgb (H,W,3), normal_world (H,W,3)) at a
    camera-to-world pose (4,4), on the scene's device."""
    h, w = intr.height, intr.width
    dev = scene.planes.device
    pose_wc = const(pose_wc, dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    dir_c = torch.stack([((xs - intr.cx) / intr.fx).expand(h, w),
                         ((ys - intr.cy) / intr.fy).expand(h, w),
                         torch.ones((h, w), dtype=torch.float32, device=dev)], dim=-1)
    R = pose_wc[:3, :3]
    o = pose_wc[:3, 3]
    d = torch.einsum("ij,hwj->hwi", R, dir_c)

    big = 1e9
    t_best = torch.full((h, w), big, dtype=torch.float32, device=dev)
    n_best = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

    def take(t, n, t_best, n_best):
        closer = t < t_best
        return torch.where(closer, t, t_best), torch.where(closer[..., None], n, n_best)

    for i in range(scene.planes.shape[0]):
        n = scene.planes[i, :3]
        dist = scene.planes[i, 3]
        denom = torch.einsum("hwi,i->hw", d, n)
        t = (dist - torch.dot(n, o)) / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
        t = torch.where((t > 0.05) & (torch.abs(denom) > 1e-6), t, big)
        t_best, n_best = take(t, n.expand(h, w, 3), t_best, n_best)

    for i in range(scene.spheres.shape[0]):
        c = scene.spheres[i, :3]
        r = scene.spheres[i, 3]
        oc = o - c
        A = torch.sum(d * d, dim=-1)
        B = 2.0 * torch.einsum("hwi,i->hw", d, oc)
        C = torch.dot(oc, oc) - r * r
        disc = B * B - 4.0 * A * C
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-B - sq) / (2.0 * A)
        t1 = (-B + sq) / (2.0 * A)
        t = torch.where(t0 > 0.05, t0, torch.where(t1 > 0.05, t1, big))
        t = torch.where(disc > 0, t, big)
        hit = o + t[..., None] * d
        t_best, n_best = take(t, (hit - c) / r, t_best, n_best)

    hit_any = t_best < big
    depth = torch.where(hit_any, t_best, 0.0)
    hit = o + t_best[..., None] * d
    rgb = torch.where(hit_any[..., None], _texture(hit), 0.0)
    flip = torch.sign(-torch.sum(n_best * d, dim=-1, keepdim=True) + 1e-12)
    return depth, rgb, n_best * flip


def render_frame(scene: Scene, pose_wc: torch.Tensor, intr: CameraIntrinsics):
    """Render (depth, rgb) — see render_frame_full."""
    depth, rgb, _ = render_frame_full(scene, pose_wc, intr)
    return depth, rgb


def orbit_trajectory(n_frames: int, radius: float = 0.35,
                     angle_per_frame: float = 0.004,
                     look_at=(0.0, 0.8, 2.0)) -> np.ndarray:
    """Small smooth orbit + push-in trajectory, (N,4,4) camera-to-world
    float32 numpy array."""
    poses = []
    target = np.asarray(look_at, np.float64)
    for i in range(n_frames):
        ang = angle_per_frame * i * 2 * np.pi
        eye = np.array([radius * np.sin(ang), 0.35 * np.sin(ang * 0.7),
                        -0.3 + 0.1 * np.sin(ang * 0.5)], np.float64)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        T = np.eye(4)
        T[:3, :3] = np.stack([right, up2, fwd], axis=1)
        T[:3, 3] = eye
        poses.append(T)
    return np.asarray(poses, np.float32)
