"""Synthetic RGB-D scene renderer on torch tensors (port of
``hrbffusion3d_tpu/eval/synth.py``): analytic spheres, planes and bounded
quads forming a room, exact z-depth and a procedural texture, rendered at a
camera-to-world pose on the scene's device (the card unless the caller
names another); the Kinect sensor model that degrades that depth; and the
trajectories of the tests and of the full-system protocol.

The Kinect model is split in two: ``kinect_depth`` takes its two noise
arrays (a standard normal and a uniform draw per pixel) and is a plain
function of them, and ``kinect_noise`` draws them from a seeded
``torch.Generator``.  The JAX package draws them with ``jax.random``, whose
bits torch cannot reproduce, so a parity test feeds both sides the same
arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..utils.tensors import const, device_or_card


class Scene(NamedTuple):
    """spheres (M,4) = [cx,cy,cz,r]; planes (K,4) = [nx,ny,nz,d] with
    n.x = d and n pointing into the room; optional quads (Q,9) =
    [cx,cy,cz, e1x,e1y,e1z, e2x,e2y,e2z], bounded rectangles spanned by
    the half-edge vectors e1, e2."""

    spheres: torch.Tensor
    planes: torch.Tensor
    quads: torch.Tensor | None = None


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


def complex_room(device=None, dtype=torch.float32) -> Scene:
    """default_room with more clutter (9 spheres of varied radius) and
    bounded quads forming a desk slab, a tilted board and a tall box:
    occlusion edges, thin structures and a wide range of surface
    orientations for the grazing-angle dropout to bite on."""
    base = default_room(device, dtype)
    dev = base.planes.device
    spheres = const([
        [0.0, 0.9, 2.2, 0.6],
        [-0.9, 1.1, 1.7, 0.4],
        [0.8, 1.2, 1.9, 0.3],
        [1.4, 0.6, 2.6, 0.35],
        [-1.5, 0.4, 2.4, 0.45],
        [0.3, -0.4, 2.8, 0.5],
        [-0.4, 1.3, 2.6, 0.2],
        [1.0, -0.8, 2.2, 0.3],
        [-1.1, -0.9, 2.0, 0.25],
    ], dev, dtype)
    quads = const([
        [0.0, 0.7, 2.0, 0.9, 0.0, 0.0, 0.0, 0.0, 0.5],         # desk slab at y = 0.7
        [-1.2, 0.2, 2.9, 0.5, 0.0, -0.15, 0.0, 0.9, 0.35],     # board on the back wall
        [1.7, 0.75, 2.3, 0.25, 0.0, 0.0, 0.0, 0.75, 0.0],      # tall box, right side
        [1.7, 0.75, 2.05, 0.0, 0.0, 0.25, 0.0, 0.75, 0.0],
    ], dev, dtype)
    return Scene(spheres=spheres, planes=base.planes, quads=quads)


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
    R = pose_wc[:3, :3]
    o = pose_wc[:3, 3]
    d = torch.einsum("ij,hwj->hwi", R, _ray_dirs(intr, dev))

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

    if scene.quads is not None:
        for i in range(scene.quads.shape[0]):
            c, e1, e2 = scene.quads[i, 0:3], scene.quads[i, 3:6], scene.quads[i, 6:9]
            n = torch.linalg.cross(e1, e2)
            n = n / torch.linalg.vector_norm(n)
            denom = torch.einsum("hwi,i->hw", d, n)
            t = torch.dot(n, c - o) / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
            rel = o + t[..., None] * d - c
            u = torch.einsum("hwi,i->hw", rel, e1) / torch.dot(e1, e1)
            v = torch.einsum("hwi,i->hw", rel, e2) / torch.dot(e2, e2)
            inside = (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0)
            t = torch.where((t > 0.05) & (torch.abs(denom) > 1e-6) & inside, t, big)
            t_best, n_best = take(t, n.expand(h, w, 3), t_best, n_best)

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


def _ray_dirs(intr: CameraIntrinsics, device) -> torch.Tensor:
    """(H,W,3) z-normalised camera-frame ray directions."""
    h, w = intr.height, intr.width
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return torch.stack([((xs - intr.cx) / intr.fx).expand(h, w),
                        ((ys - intr.cy) / intr.fy).expand(h, w),
                        torch.ones((h, w), dtype=torch.float32, device=device)], dim=-1)


# Kinect sensor model: the quadratic axial-noise law sigma_z = c1 z^2 + c2 z
# + c3 of the BA information matrices (Optimizer.cc:1216-1237), u16
# millimetre quantisation and grazing-incidence dropout
KINECT_C1, KINECT_C2, KINECT_C3 = 0.00273, 0.00074, -0.00058


def kinect_noise(shape, generator: torch.Generator, device=None):
    """The Kinect model's two noise arrays, (standard normal, uniform
    [0, 1)), drawn from ``generator`` on ``device`` (the generator's)."""
    device = generator.device if device is None else device_or_card(device)
    return (torch.randn(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def kinect_depth(depth: torch.Tensor, normal_world: torch.Tensor,
                 dirs_world: torch.Tensor, noise, quantize_mm: bool = True,
                 dropout_cos: float = 0.25, edge_dropout: float = 0.5,
                 noise_scale: float = 1.0) -> torch.Tensor:
    """Degrade exact z-depth with the Kinect model: Gaussian noise
    sigma_z(z) * ``noise_scale`` (``noise[0]`` is the standard normal
    draw), u16 millimetre quantisation, and grazing-angle dropout:
    |cos(incidence)| below ``dropout_cos`` drops, and up to twice that
    drops where ``noise[1]`` (the uniform draw) falls under a probability
    ramping down from ``edge_dropout``."""
    normal_draw, uniform_draw = noise
    z = depth
    valid = z > 0
    sigma = torch.clamp(KINECT_C1 * z * z + KINECT_C2 * z + KINECT_C3, min=1e-5) * noise_scale
    z = z + sigma * normal_draw
    if quantize_mm:
        z = torch.round(z * 1000.0) / 1000.0
    cosi = torch.abs(torch.sum(normal_world * dirs_world, dim=-1)
                     / (torch.linalg.vector_norm(dirs_world, dim=-1) + 1e-12))
    ramp = torch.clamp((2.0 * dropout_cos - cosi) / max(dropout_cos, 1e-6), 0.0, 1.0)
    drop = (cosi < dropout_cos) | (uniform_draw < edge_dropout * ramp)
    return torch.where(valid & ~drop, z, 0.0)


def render_frame_kinect(scene: Scene, pose_wc, intr: CameraIntrinsics,
                        generator: torch.Generator | None = None,
                        noise_scale: float = 1.0, noise=None):
    """Render (noisy_depth, rgb) through the Kinect sensor model; the noise
    arrays are ``noise`` when given, else drawn from ``generator``."""
    if noise is None and generator is None:
        raise ValueError("render_frame_kinect draws from an explicit torch.Generator "
                         "or takes the noise arrays")
    depth, rgb, normal = render_frame_full(scene, pose_wc, intr)
    dev = depth.device
    dirs_world = torch.einsum("ij,hwj->hwi", const(pose_wc, dev)[:3, :3], _ray_dirs(intr, dev))
    if noise is None:
        noise = kinect_noise(depth.shape, generator, dev)
    return kinect_depth(depth, normal, dirs_world, noise, noise_scale=noise_scale), rgb


def render_sequence(scene: Scene, poses_wc: np.ndarray, intr: CameraIntrinsics):
    """Render a whole sequence: (depths (N,H,W), rgbs (N,H,W,3))."""
    frames = [render_frame(scene, p, intr) for p in poses_wc]
    return torch.stack([d for d, _ in frames]), torch.stack([c for _, c in frames])


def _look_rotation(fwd: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation looking along ``fwd`` with y down."""
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd], axis=1)


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
        T = np.eye(4)
        T[:3, :3] = _look_rotation(fwd)
        T[:3, 3] = eye
        poses.append(T)
    return np.asarray(poses, np.float32)


def loopy_trajectory(n_frames: int, n_loops: int = 2, radius: float = 0.7,
                     look_at=(0.0, 0.6, 2.1)) -> np.ndarray:
    """A long handheld-like trajectory completing ``n_loops`` laps of a
    lateral ellipse (back at its start region each lap), with slow
    vertical bob, push-in/out and a swaying look-at target."""
    poses = []
    target = np.asarray(look_at, np.float64)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        ang = 2 * np.pi * n_loops * s
        eye = np.array([radius * np.sin(ang), 0.25 * np.sin(2.1 * ang + 0.4),
                        -0.35 + 0.18 * np.sin(0.9 * ang)], np.float64)
        tgt = target + np.array([0.25 * np.sin(ang * 0.5), 0.1 * np.cos(ang * 0.8), 0.0])
        fwd = tgt - eye
        fwd /= np.linalg.norm(fwd)
        T = np.eye(4)
        T[:3, :3] = _look_rotation(fwd)
        T[:3, 3] = eye
        poses.append(T)
    return np.asarray(poses, np.float32)


def panorama_trajectory(n_frames: int, n_turns: float = 2, radius: float = 0.25,
                        center=(0.0, 0.55, 0.9)) -> np.ndarray:
    """Full-revolution panning: the camera walks a small circle while its
    heading sweeps 360 deg per turn, so keyframes looking backward share no
    landmarks with those looking forward and closing the revolution is a
    true loop-closure event (LoopClosing.cc:407-599)."""
    poses = []
    c = np.asarray(center, np.float64)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        ang = 2 * np.pi * n_turns * s
        eye = c + np.array([radius * np.sin(ang), 0.06 * np.sin(3.1 * ang),
                            radius * np.cos(ang)], np.float64)
        fwd = np.array([np.sin(ang + 0.35 * np.sin(0.7 * ang)), 0.12 * np.sin(1.3 * ang),
                        np.cos(ang + 0.35 * np.sin(0.7 * ang))], np.float64)
        fwd /= np.linalg.norm(fwd)
        T = np.eye(4)
        T[:3, :3] = _look_rotation(fwd)
        T[:3, 3] = eye
        poses.append(T)
    return np.asarray(poses, np.float32)
