"""Sparse feature front end: FAST-9 corners and oriented BRIEF descriptors
(port of ``hrbffusion3d_tpu/backend/features.py``).

FAST-9 detection over an image pyramid, 3x3 non-max suppression, a fixed
top-k per level, intensity-centroid orientation, rotation-steered 256-bit
binary descriptors and mutual-nearest Hamming matching, with the JAX
module's semantics and static shapes.

How the port keeps those semantics on torch:
  - a descriptor is eight 32-bit words carried in ``int64`` (values in
    [0, 2^32)), so every shift is logical; ``Keyframe.desc`` stores them as
    numpy ``uint32`` (``desc_to_numpy`` / ``desc_from_numpy``);
  - Hamming distances count bits with a SWAR popcount on those words;
  - the per-level top-k is a stable descending sort, so among equal scores
    the lower flat index comes first, as ``lax.top_k`` gives;
  - ``torch.argmin`` returns the first index of the minimum, as
    ``jnp.argmin`` does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.tensors import const

# FAST circle of radius 3 (16 pixels, Bresenham order), (dy, dx)
_FAST_OFFSETS = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
                 (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
_BLUR_TAPS = (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125)
_BORDER = 20            # descriptor patch margin of the detector


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = img[y - dy, x - dx]``, zero where that falls outside."""
    h, w = img.shape
    out = torch.zeros_like(img)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        img[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def _inner_mask(h: int, w: int, margin: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)


def fast_score(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9 corner response: (H,W) score, 0 where not a corner."""
    ring = torch.stack([_shift2d(img, -dy, -dx) for dy, dx in _FAST_OFFSETS], dim=-1)
    center = img[..., None]
    brighter = ring > (center + threshold)
    darker = ring < (center - threshold)

    def contiguous9(mask):
        # any window of 9 consecutive (cyclic) ring pixels all set
        m = torch.cat([mask, mask[..., :8]], dim=-1)
        acc = m[..., 0:16]
        for k in range(1, 9):
            acc = acc & m[..., k:k + 16]
        return acc.any(dim=-1)

    is_corner = contiguous9(brighter) | contiguous9(darker)
    diff = torch.abs(ring - center)
    score = torch.where(brighter | darker, diff, 0.0).sum(dim=-1)
    # the 3-px border would sample the zero fill
    inb = _inner_mask(*img.shape, 3, img.device)
    return torch.where(is_corner & inb, score, 0.0)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression."""
    neigh = torch.stack([_shift2d(score, dy, dx)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=-1)
    return torch.where(score >= neigh.amax(dim=-1), score, 0.0)


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (N,2) float (x, y) at level-0 scale
    score: torch.Tensor   # (N,)
    angle: torch.Tensor   # (N,) radians
    level: torch.Tensor   # (N,) int32
    desc: torch.Tensor    # (N,8) int64 words of 32 bits: packed 256-bit descriptors
    valid: torch.Tensor   # (N,) bool


@functools.lru_cache()
def _disc_offsets(radius: int) -> tuple[np.ndarray, np.ndarray]:
    """(dy, dx) of the pixels within ``radius``, in the JAX loop's order."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
            if dx * dx + dy * dy <= radius * radius]
    a = np.asarray(offs, np.int64)
    return a[:, 0], a[:, 1]


def _orientation(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                 radius: int = 7) -> torch.Tensor:
    """Intensity-centroid angle (ORBextractor IC_Angle)."""
    h, w = img.shape
    dy_np, dx_np = _disc_offsets(radius)
    dy, dx = const(dy_np, img.device, torch.int64), const(dx_np, img.device, torch.int64)
    vy = torch.clamp(ys[:, None] + dy[None], 0, h - 1)
    vx = torch.clamp(xs[:, None] + dx[None], 0, w - 1)
    val = img.reshape(-1)[vy * w + vx]
    m01 = (val * dy.to(val.dtype)).sum(dim=-1)
    m10 = (val * dx.to(val.dtype)).sum(dim=-1)
    return torch.atan2(m01, m10)


@functools.lru_cache()
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 7,
                   learned: bool = True) -> np.ndarray:
    """BRIEF test pattern (256,4) = (x1,y1,x2,y2), host numpy float32.

    ``learned=True``: the greedy-decorrelated pattern of ``brief_pattern``;
    ``learned=False``: seeded gaussian BRIEF."""
    if learned:
        from .brief_pattern import LEARNED_PATTERN

        return np.asarray(LEARNED_PATTERN, np.float32)
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    pts = np.clip(rng.normal(0, sigma, (n_bits, 4)), -(patch // 2), patch // 2)
    return pts.astype(np.float32)


def _descriptors(img: torch.Tensor, ys, xs, angle, learned: bool = True) -> torch.Tensor:
    """Rotation-steered 256-bit BRIEF, packed into (N,8) 32-bit words (int64)."""
    pat = const(_brief_pattern(learned=learned), img.device)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    xs = xs[:, None]
    ys = ys[:, None]
    x1 = pat[None, :, 0] * ca - pat[None, :, 1] * sa + xs
    y1 = pat[None, :, 0] * sa + pat[None, :, 1] * ca + ys
    x2 = pat[None, :, 2] * ca - pat[None, :, 3] * sa + xs
    y2 = pat[None, :, 2] * sa + pat[None, :, 3] * ca + ys
    h, w = img.shape
    flat = img.reshape(-1)

    def sample(yf, xf):
        # torch.round is half-to-even, as jnp.round
        yi = torch.clamp(torch.round(yf).long(), 0, h - 1)
        xi = torch.clamp(torch.round(xf).long(), 0, w - 1)
        return flat[yi * w + xi]

    bits = (sample(y1, x1) < sample(y2, x2)).long()                  # (N,256)
    shifts = torch.arange(32, device=img.device)
    return (bits.reshape(bits.shape[0], 8, 32) << shifts).sum(dim=-1)


def _gauss_blur(img: torch.Tensor) -> torch.Tensor:
    """7x7 separable Gaussian with wrap-around (ORB blurs before describing)."""
    out = img
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        for i, kv in enumerate(_BLUR_TAPS):
            acc = acc + kv * torch.roll(out, i - 3, dims=axis)
        out = acc
    return out


def _stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among equal values."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _grid_topk(sc: torch.Tensor, n_total: int, cells: int):
    """Spatially distributed selection (ORBextractor::DistributeOctTree's
    static-shape analogue): the top n_total/cells^2 responses of each cell
    of a cells x cells grid.  Returns (val, flat_idx) of length <= n_total."""
    h, w = sc.shape
    if cells * cells > n_total:
        raise ValueError(f"grid_cells^2 ({cells * cells}) exceeds the "
                         f"keypoint budget ({n_total})")
    m = max(1, n_total // (cells * cells))
    gh, gw = -(-h // cells), -(-w // cells)      # ceil
    pad = torch.zeros((gh * cells, gw * cells), dtype=sc.dtype, device=sc.device)
    pad[:h, :w] = sc
    cellv = pad.reshape(cells, gh, cells, gw).permute(0, 2, 1, 3).reshape(cells, cells, gh * gw)
    val, ci = _stable_topk(cellv, m)             # (cells, cells, m)
    ar = torch.arange(cells, device=sc.device)
    yy = ar[:, None, None] * gh + ci // gw
    xx = ar[None, :, None] * gw + ci % gw
    # out-of-image padded pixels carry score 0 => masked by val > 0
    flat = (torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)).reshape(-1)
    inb = ((yy < h) & (xx < w)).reshape(-1)
    return torch.where(inb, val.reshape(-1), 0.0), flat


def detect_and_describe(intensity: torch.Tensor, n_per_level: int = 256,
                        n_levels: int = 4, scale_factor: float = 1.5,
                        threshold: float = 20.0, grid_cells: int = 0,
                        learned_pattern: bool = True) -> Keypoints:
    """ORBextractor::operator(): pyramid FAST + NMS + top-k per level,
    orientation, steered BRIEF.  A fixed-size masked set of
    n_per_level * n_levels keypoints with level-0 coordinates, on the
    device of ``intensity``.

    ``grid_cells > 0`` spreads each level's budget over a grid_cells^2
    grid (``_grid_topk``)."""
    img = intensity.to(torch.float32)
    dev = img.device
    out = []
    scale = 1.0
    for lvl in range(n_levels):
        h, w = img.shape
        raw = fast_score(img, threshold)
        sc = torch.where(_inner_mask(h, w, _BORDER, dev), _nms3(raw), 0.0)
        if grid_cells > 0:
            val, idx = _grid_topk(sc, n_per_level, grid_cells)
        else:
            val, idx = _stable_topk(sc.reshape(-1), min(n_per_level, h * w))
        k = val.shape[0]
        ys = idx // w
        xs = idx % w
        blur = _gauss_blur(img)
        ang = _orientation(blur, ys, xs)
        desc = _descriptors(blur, ys, xs, ang, learned=learned_pattern)
        # sub-pixel refinement: parabola fit on the raw FAST response
        rflat = raw.reshape(-1)

        def _sub(stride):
            sm = rflat[torch.clamp(idx - stride, 0, h * w - 1)]
            sp = rflat[torch.clamp(idx + stride, 0, h * w - 1)]
            s0 = rflat[idx]
            denom = sm - 2.0 * s0 + sp
            off = 0.5 * (sm - sp) / torch.where(torch.abs(denom) > 1e-6, denom, 1e-6)
            return torch.clamp(off, -0.5, 0.5)

        xy0 = torch.stack([xs.to(torch.float32) + _sub(1),
                           ys.to(torch.float32) + _sub(w)], dim=-1) * scale
        out.append((xy0, val, ang, torch.full((k,), lvl, dtype=torch.int32, device=dev),
                    desc, val > 0))
        if lvl + 1 < n_levels:
            nh = int(round(h / scale_factor))
            nw = int(round(w / scale_factor))
            yi = torch.clamp(torch.round(torch.arange(nh, device=dev) * scale_factor).long(),
                             0, h - 1)
            xi = torch.clamp(torch.round(torch.arange(nw, device=dev) * scale_factor).long(),
                             0, w - 1)
            img = blur[yi][:, xi]
            scale *= scale_factor
    return Keypoints(*(torch.cat(parts) for parts in zip(*out)))


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances of broadcast (..., 8) packed descriptors -> (...)
    int64.  A SWAR popcount on the 32-bit words held in non-negative int64
    (so every shift is logical), in place on the (..., 8) temporaries; the
    byte counts of the 8 words are summed before the bytes are folded:
    each byte then holds at most 64, so nothing carries."""
    x = torch.bitwise_xor(a, b)
    t = x >> 1
    x -= t.bitwise_and_(0x55555555)
    t = x >> 2
    x.bitwise_and_(0x33333333).add_(t.bitwise_and_(0x33333333))
    x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    x = x.sum(dim=-1)
    x = (x & 0x00FF00FF) + ((x >> 8) & 0x00FF00FF)
    return (x & 0xFFFF) + (x >> 16)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1,8) x (N2,8) packed descriptors -> (N1,N2) int32 Hamming distances."""
    return hamming(d1[:, None, :], d2[None, :, :]).to(torch.int32)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """(N,8) int64 words -> numpy uint32 (the stored form)."""
    return desc.cpu().numpy().astype(np.uint32)


def desc_from_numpy(desc: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 (N,8) -> int64 words on ``device``."""
    return const(np.asarray(desc, np.uint32).astype(np.int64), device, torch.int64)


class Matches(NamedTuple):
    idx2: torch.Tensor    # (N1,) best match in set 2
    dist: torch.Tensor    # (N1,)
    valid: torch.Tensor   # (N1,) mutual + ratio + threshold checks


def match(k1: Keypoints, k2: Keypoints, max_dist: int = 50, ratio: float = 0.8) -> Matches:
    """Mutual-nearest descriptor matching with Lowe ratio (the semantics of
    ORBmatcher::SearchByBoW / TH_LOW=50 and mfNNratio)."""
    big = 10_000
    D = hamming_matrix(k1.desc, k2.desc)
    D = torch.where(k1.valid[:, None] & k2.valid[None, :], D, big)
    dmin = D.amin(dim=1)
    best = torch.argmin(D, dim=1)               # first index among ties
    d2nd = D.scatter(1, best[:, None], big).amin(dim=1)
    mutual = torch.argmin(D, dim=0)[best] == torch.arange(D.shape[0], device=D.device)
    valid = (k1.valid & (dmin <= max_dist) & mutual
             & (dmin.to(torch.float32) < ratio * d2nd.to(torch.float32)))
    return Matches(idx2=best, dist=dmin, valid=valid)
