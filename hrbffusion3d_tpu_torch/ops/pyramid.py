"""Pyramid construction on torch tensors (port of
``hrbffusion3d_tpu/ops/pyramid.py``, the fused multi-channel path that
``odometry.build_inputs`` takes): depth/intensity downsampling, one pooled
pass for all map resizes, Sobel derivatives.
"""

from __future__ import annotations

import torch

from ..utils.tensors import const, norm
from .patches import extract_patches


def _decimate2(x: torch.Tensor) -> torch.Tensor:
    """Even-row/col 2x decimation."""
    h, w = x.shape[:2]
    return x[0:2 * (h // 2):2, 0:2 * (w // 2):2]


def _pool2_sum(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 window sum (VALID: a trailing odd row/col is dropped),
    summed in window order."""
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    x = x[:2 * h2, :2 * w2]
    return x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]


def _binomial5(wts_1d, like: torch.Tensor) -> torch.Tensor:
    w1 = const(wts_1d, like.device, like.dtype)
    return (w1[:, None] * w1[None, :]).reshape(25)


def pyr_down_depth_mc(src: torch.Tensor, sigma_color: float = 0.03) -> torch.Tensor:
    """(H, W, C) stacked depth maps -> (H/2, W/2, C): 5x5 binomial weights,
    neighbours deviating > 3 sigma_color from the centre rejected
    (cudafuncs.cu:57-94)."""
    patches = extract_patches(src, 2)          # (H, W, 25, C)
    wts = _binomial5([0.0625, 0.25, 0.375, 0.25, 0.0625], src)[None, None, :, None]
    center = src[:, :, None, :]
    ok = (torch.abs(patches - center) < 3.0 * sigma_color) & (patches > 0)
    wv = torch.where(ok, wts, 0.0)
    num = torch.sum(patches * wv, dim=2)
    den = torch.sum(wv, dim=2)
    out = torch.where((den > 0) & (src > 0), num / torch.clamp(den, min=1e-12), 0.0)
    return _decimate2(out)


def pyr_down_intensity_mc(src: torch.Tensor) -> torch.Tensor:
    """(H, W, C) stacked intensity maps -> (H/2, W/2, C) with the
    [1,4,6,4,1]^2 Gaussian (cudafuncs.cu:818-866)."""
    h, w = src.shape[:2]
    patches = extract_patches(src, 2)
    wts = _binomial5([1.0, 4.0, 6.0, 4.0, 1.0], src)
    inb = extract_patches(torch.ones((h, w), dtype=src.dtype, device=src.device), 2)
    wv = (wts * inb)[..., None]
    out = torch.sum(patches * wv, dim=2) / torch.clamp(torch.sum(wv, dim=2), min=1e-12)
    return _decimate2(out)


def resize_maps_fused(vmaps: list[torch.Tensor], nmaps: list[torch.Tensor],
                      scalars: list[torch.Tensor]):
    """One 2x2 pooling pass for all per-level map resizes: vertex maps
    (z-validity gate), normal maps (length gate + renormalise) and scalar
    maps (plain average).  Returns (vmaps_down, nmaps_down, scalars_down)."""
    chans = []
    for v in vmaps:
        chans += [v, (v[..., 2] > 0).to(v.dtype)[..., None]]
    for nm in nmaps:
        ok = torch.sum(nm[..., :3] * nm[..., :3], dim=-1) > 1e-12
        chans += [nm, ok.to(nm.dtype)[..., None]]
    for s in scalars:
        chans.append(s[..., None])
    pooled = _pool2_sum(torch.cat(chans, dim=-1))
    out_v, out_n, out_s = [], [], []
    c = 0
    for _ in vmaps:
        avg = pooled[..., c:c + 3] * 0.25
        ok = pooled[..., c + 3] > 3.5
        out_v.append(torch.where(ok[..., None], avg, 0.0))
        c += 4
    for _ in nmaps:
        avg = pooled[..., c:c + 3] * 0.25
        ok = pooled[..., c + 3] > 3.5
        avg = avg / torch.clamp(norm(avg, dim=-1, keepdim=True), min=1e-12)
        out_n.append(torch.where(ok[..., None], avg, 0.0))
        c += 4
    for _ in scalars:
        out_s.append(pooled[..., c] * 0.25)
        c += 1
    return out_v, out_n, out_s


def sobel_derivatives(img: torch.Tensor):
    """3x3 Sobel as in computeDerivativeImages (cudafuncs.cu:956-993),
    including its negated x kernel [[1,0,-1],[2,0,-2],[1,0,-1]]."""
    p = extract_patches(img, 1)    # tap (dy + 1) * 3 + (dx + 1)
    # the taps' weighted sums written out in a fixed order (one op per
    # IEEE operation), so that the card and the CPU round them alike
    gx = ((p[..., 0] - p[..., 2]) + (p[..., 3] - p[..., 5]) * 2.0) + (p[..., 6] - p[..., 8])
    gy = ((p[..., 0] + p[..., 1] * 2.0) + p[..., 2]) - ((p[..., 6] + p[..., 7] * 2.0) + p[..., 8])
    return gx, gy


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] -> grey [0,255]."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) * 255.0
