"""Camera projection utilities on torch tensors (port of
``hrbffusion3d_tpu/core/camera.py``)."""

from __future__ import annotations

import math

import torch

from ..config import CameraIntrinsics
from ..utils.tensors import const, device_or_card


def pixel_grid(h: int, w: int, device=None, dtype=torch.float32, row0: int = 0):
    """Integer pixel coordinates as float (y, x) maps, each (H, W), on
    ``device`` (default the CUDA card); ``row0``: the image row of the
    first row (a row slab of a taller image)."""
    device = device_or_card(device)
    ys = torch.arange(row0, row0 + h, dtype=dtype, device=device)[:, None]
    xs = torch.arange(w, dtype=dtype, device=device)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def unproject(depth: torch.Tensor, intr: CameraIntrinsics, row0: int = 0) -> torch.Tensor:
    """Depth (H, W) in metres -> camera-frame vertex map (H, W, 3); invalid
    (<= 0) depths give zero vertices.  ``row0``: the image row of the
    first row of a row slab."""
    h, w = depth.shape
    yy, xx = pixel_grid(h, w, depth.device, depth.dtype, row0)
    z = torch.where(depth > 0, depth, 0.0)
    x = (xx - intr.cx) * z * (1.0 / intr.fx)
    y = (yy - intr.cy) * z * (1.0 / intr.fy)
    return torch.stack([x, y, z], dim=-1)


def project(points: torch.Tensor, intr: CameraIntrinsics):
    """Camera-frame points (..., 3) -> (u, v, z)."""
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    u = points[..., 0] * intr.fx / safe_z + intr.cx
    v = points[..., 1] * intr.fy / safe_z + intr.cy
    return u, v, z


def in_bounds(u: torch.Tensor, v: torch.Tensor, intr: CameraIntrinsics):
    """Round-to-nearest integer pixel and its in-image mask."""
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(v).to(torch.int32)
    ok = (ui >= 0) & (vi >= 0) & (ui < intr.width) & (vi < intr.height)
    return ui, vi, ok


def intrinsic_matrix(intr: CameraIntrinsics, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 3x3 pinhole matrix K on ``device`` (default the CUDA card)."""
    return const([[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]],
                 device_or_card(device), dtype)


def mean_focal(intr: CameraIntrinsics) -> float:
    return (abs(intr.fx) + abs(intr.fy)) / 2.0


def max_radial_dist(intr: CameraIntrinsics) -> float:
    return math.sqrt((intr.width / 2.0) ** 2 + (intr.height / 2.0) ** 2)
