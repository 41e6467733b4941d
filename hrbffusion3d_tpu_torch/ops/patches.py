"""Window-gather helper (port of ``hrbffusion3d_tpu/ops/patches.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.tensors import device_or_card


def extract_patches(x: torch.Tensor, radius: int, fill: float = 0.0) -> torch.Tensor:
    """x: (H, W) or (H, W, C) -> (H, W, D*D[, C]) with D = 2*radius+1.

    Out-of-bounds neighbours are ``fill``; neighbour order is row-major over
    the window, d = (dy+R)*D + (dx+R)."""
    d = 2 * radius + 1
    h, w = x.shape[:2]
    pad = [0, 0] * (x.ndim - 2) + [radius, radius, radius, radius]
    xp = F.pad(x, pad, value=fill)
    slabs = [xp[dy:dy + h, dx:dx + w] for dy in range(d) for dx in range(d)]
    return torch.stack(slabs, dim=2)


def window_offsets(radius: int, device=None) -> torch.Tensor:
    """(D*D, 2) int32 (dy, dx) offsets in extract_patches order, on
    ``device`` (default the CUDA card)."""
    d = 2 * radius + 1
    offs = [(dy - radius, dx - radius) for dy in range(d) for dx in range(d)]
    return torch.tensor(offs, dtype=torch.int32).to(device_or_card(device))
