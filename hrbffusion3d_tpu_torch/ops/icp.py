"""Tracking residuals and normal equations on torch tensors (port of
``hrbffusion3d_tpu/ops/icp.py``):
  ICPReduction::search/getProducts (reduce.cu:253-573) -> :func:`icp_step`
  RGBResidual (reduce.cu:942-1154)                     -> :func:`rgb_residual`
  RGBReduction (reduce.cu:697-896)                     -> :func:`rgb_step`
  SO3Reduction (reduce.cu:1156-1359)                   -> :func:`so3_step`
and the fused single-gather pass :func:`joint_step` with its
fixed-correspondence, subsampled, top-k and patch-anchored variants.

Every pixel contributes a row [J | r]; the 6x6 system is one weighted Gram
product, accumulated in float64 (``_sums``): the tracker rounds each
system to float32 once, after summing it, so its value does not depend on
the order the pixels are summed in (the row-sharded step sums the shards'
systems; its float32 systems are the whole image's).  The model
prediction is packed into rows so that one row gather
per Gauss-Newton iteration fetches a pixel's correspondence: 9 channels
[v n w d i] at the rounded pixel (``pack_joint_nearest``, the reference's
nearest-pixel photometric lookup), 36 channels for the 2x2 bilinear
footprint (``pack_joint``), or the separate pair ``pack_model`` /
``pack_last`` of the ICP and photometric terms.  Everything here is plain
PyTorch.  The per-pixel arithmetic (the 3x3 rotations of points and
normals, 3-vector dot and cross products and norms) is written out
elementwise, one tensor op per IEEE operation (``mat3_apply``, ``_dot``,
``_cross``, ``_norm``): no matrix product, ``einsum`` or reduction over a
3-vector, so each op is rounded alone, with no fused multiply-add and no
blocked summation order, and the card and the CPU compute the same
values; a division by a constant is a multiplication by its reciprocal
(on the card PyTorch turns ``x / c`` into ``x * (1 / c)``, on the CPU it
divides).  ``sparse_icp_lambda_update`` rotates its points in float64
and rounds once: XLA's CPU dot rounds that product once per component (a
chain of fused multiply-adds), where a float32 sum of rounded products
parts from it by an ulp that the lambda values (matched to 1e-6) show.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics, SLAMConfig
from ..core import camera
from ..utils.tensors import sqrt
from .patches import extract_patches


def _flat(vi: torch.Tensor, ui: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flat row index of the clamped integer pixel (vi, ui)."""
    return (torch.clamp(vi.to(torch.int32), 0, h - 1) * w
            + torch.clamp(ui.to(torch.int32), 0, w - 1)).long()


def _sums(rows: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """(w rows)^T rows of rows (N,k) and weights (N,) (default 1), in
    float64: each product of the float32 weighted row and the row is exact
    there."""
    wr = rows if weight is None else rows * weight[:, None]
    return wr.double().T @ rows.double()


def _gram(rows: torch.Tensor, weight: torch.Tensor):
    """rows (N,7), weight (N,) -> (A (6,6), b (6,), r2_sum) in float64
    (``_sums``)."""
    S = _sums(rows, weight)
    return S[:6, :6], S[:6, 6], S[6, 6]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) . (..., 3) as (a0 b0 + a1 b1) + a2 b2."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b of (..., 3) vectors, each component a product difference."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return sqrt(_dot(x, x))


def mat3_apply(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``v @ M.T`` for (..., 3) vectors and a 3x3 ``M``: component i is
    (M[i,0] v0 + M[i,1] v1) + M[i,2] v2."""
    p = v[..., None, :] * M
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def mat3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` of 3x3 matrices, written out as ``mat3_apply``."""
    return mat3_apply(B.T, A).T


def _project(vcurr_cp: torch.Tensor, intr: CameraIntrinsics):
    """(z, u0f, v0f) of previous-camera-frame points."""
    z = vcurr_cp[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    return (z, vcurr_cp[:, 0] * intr.fx / safe_z + intr.cx,
            vcurr_cp[:, 1] * intr.fy / safe_z + intr.cy)


def _icp_rows(found, s_cp, d_cp, n_cp, wp, cfg: SLAMConfig):
    """Point-to-plane rows [n | s x n | n.(s - d)] in the previous camera
    frame (reduce.cu:474-507) -> StepResult."""
    r = _dot(n_cp, s_cp - d_cp)
    rows = torch.cat([n_cp, _cross(s_cp, n_cp), r[:, None]], dim=-1)
    rows = torch.where(found[:, None], rows, 0.0)
    if cfg.icp_use_weighted:
        weight = torch.where(found & torch.isfinite(wp), wp, 0.0)
    else:
        weight = found.to(rows.dtype)
    A, b, r2 = _gram(rows, weight)
    return StepResult(A=A, b=b, residual2=r2, count=found.sum(dtype=torch.float32))


class StepResult(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    residual2: torch.Tensor
    count: torch.Tensor


class SparseICPExtras(NamedTuple):
    """Per-pixel data the sparse-ICP ADMM lambda update needs after the
    pose solve (updateLambdaMapKernel, cudafuncs.cu:1030-1075)."""

    found: torch.Tensor   # (N,) bool correspondence mask
    d_cp: torch.Tensor    # (N,3) unmodified target point, previous camera frame
    z: torch.Tensor       # (N,3) shrinkage variable of this iteration


class RGBCorres(NamedTuple):
    u0f: torch.Tensor     # (N,) float warp target in the last image
    v0f: torch.Tensor
    d0: torch.Tensor      # (N,) last depth at the nearest target
    diff: torch.Tensor    # (N,) intensity difference next - last
    valid: torch.Tensor   # (N,) bool
    sigma_sum: torch.Tensor
    count: torch.Tensor


def _rgb_corres(u0f, v0f, d0, i_last, td1, i_next, static_valid, in_last, cfg) -> RGBCorres:
    """The photometric gate and residual at a warp (reduce.cu:1030-1040)."""
    depth_ok = (d0 > 0) & (torch.abs(td1 - d0) <= cfg.max_depth_delta_rgb) & (i_last != 0)
    valid = static_valid & in_last & depth_ok
    diff = torch.where(valid, i_next - i_last, 0.0)
    return RGBCorres(u0f=u0f, v0f=v0f, d0=d0, diff=diff, valid=valid,
                     sigma_sum=torch.sum(diff * diff), count=valid.sum(dtype=torch.float32))


def lp_shrink(h: torch.Tensor, mu: float, p: float, iters: int) -> torch.Tensor:
    """The L_p proximal ("thrink") operator (reduce.cu:301-315): zero inside
    the threshold, otherwise a fixed-point iteration on the shrink factor.
    h: (..., 3)."""
    alpha_a = ((2.0 / mu) * (1.0 - p)) ** (1.0 / (2.0 - p))
    h_tilde = alpha_a + (p / mu) * alpha_a ** (p - 1.0)
    h_norm = _norm(h)
    safe = torch.clamp(h_norm, min=1e-12)
    beta = (alpha_a / safe + 1.0) / 2.0
    for _ in range(iters):
        beta = 1.0 - (p / mu) * safe ** (p - 2.0) * beta ** (p - 1.0)
    return torch.where((h_norm <= h_tilde)[..., None], 0.0, beta[..., None] * h)


def sparse_icp_lambda_update(lam: torch.Tensor, extras: SparseICPExtras,
                             R_curr_new: torch.Tensor, t_curr_new: torch.Tensor,
                             R_prev_inv: torch.Tensor, t_prev: torch.Tensor,
                             vmap_curr: torch.Tensor, mu: float) -> torch.Tensor:
    """ADMM dual update after the pose solve (updateLambdaMapKernel):
    lambda += mu * (s_cp(new pose) - d_cp - z) at found correspondences."""
    vcurr = vmap_curr.reshape(lam.shape[0], 3)
    rot = mat3_apply(vcurr.to(torch.float64), R_curr_new.to(torch.float64)).to(torch.float32)
    s_cp = mat3_apply((rot + t_curr_new) - t_prev, R_prev_inv)
    delta = s_cp - extras.d_cp - extras.z
    return torch.where(extras.found[:, None], lam + mu * delta, lam)


# ---------------------------------------------------------------------- #
# packed per-level model data
# ---------------------------------------------------------------------- #

def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = x[y + dy, x + dx], zero past the bottom / right edge."""
    h, w = x.shape[:2]
    pad = [0, 0] * (x.ndim - 2) + [0, dx, 0, dy]
    return F.pad(x, pad)[dy:dy + h, dx:dx + w]


def pack_model(vmap_g: torch.Tensor, nmap_g: torch.Tensor,
               icp_weight: torch.Tensor) -> torch.Tensor:
    """(H,W,3)+(H,W,3)+(H,W) -> (H*W, 8) packed model rows [v n w 0] for
    icp_step."""
    P = icp_weight.numel()
    return torch.cat([vmap_g.reshape(P, 3), nmap_g.reshape(P, 3), icp_weight.reshape(P, 1),
                      icp_weight.new_zeros(P, 1)], dim=-1)


def pack_last(last_depth: torch.Tensor, last_intensity: torch.Tensor) -> torch.Tensor:
    """(H,W)x2 -> (H*W, 8) rows of the 2x2 bilinear footprint
    [d00,i00,d01,i01,d10,i10,d11,i11] (shifted copies, zero past the far
    edges), so one row gather at the floor pixel fetches all four corners."""
    P = last_depth.numel()
    cols = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cols += [_shift(last_depth, dy, dx).reshape(P), _shift(last_intensity, dy, dx).reshape(P)]
    return torch.stack(cols, dim=-1)


def pack_joint_nearest(vmap_g: torch.Tensor, nmap_g: torch.Tensor,
                       icp_weight: torch.Tensor, last_depth: torch.Tensor,
                       last_intensity: torch.Tensor) -> torch.Tensor:
    """(H*W, 9) rows [v(3) n(3) w d i] of the model prediction."""
    P = icp_weight.numel()
    return torch.cat([vmap_g.reshape(P, 3), nmap_g.reshape(P, 3),
                      icp_weight.reshape(P, 1), last_depth.reshape(P, 1),
                      last_intensity.reshape(P, 1)], dim=-1)


def pack_joint(vmap_g: torch.Tensor, nmap_g: torch.Tensor, icp_weight: torch.Tensor,
               last_depth: torch.Tensor, last_intensity: torch.Tensor) -> torch.Tensor:
    """(H*W, 36) rows of [v(3) n(3) w d i] for the 2x2 footprint (corners
    00, 01, 10, 11 as shifted copies, zero past the far edges): the ICP
    target (rounded pixel) and the bilinear photometric footprint (floor
    pixel) lie in one 2x2 window, so one row gather serves both terms."""
    h, w = icp_weight.shape
    return joint_footprint(pack_joint_nearest(vmap_g, nmap_g, icp_weight, last_depth,
                                              last_intensity).reshape(h, w, 9))


def joint_footprint(base: torch.Tensor) -> torch.Tensor:
    """(H,W,9) ``pack_joint_nearest`` rows of a whole image -> the (H*W,
    36) ``pack_joint`` table."""
    h, w = base.shape[:2]
    return torch.cat([_shift(base, dy, dx).reshape(h * w, 9)
                      for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))], dim=-1)


# ---------------------------------------------------------------------- #
# patch-anchored association (cfg.tracking_patch_assoc)
# ---------------------------------------------------------------------- #

class PatchAssoc(NamedTuple):
    """The (2R+1)^2-tap patch of model rows gathered once around the
    level-entry warp pixel; each iteration then selects its tap by offset
    with no gather.  Pixels whose rounded warp leaves the window lose their
    correspondence for that iteration.  Tap payload [d, n_cp(3), w, i] in
    the previous camera frame (the model vertex is derived from the tap
    pixel and its depth)."""

    rows: torch.Tensor   # (M, T*6) anchored patch rows, T = (2R+1)^2
    au: torch.Tensor     # (M,) anchor pixel u (int32, unclamped)
    av: torch.Tensor     # (M,) anchor pixel v
    ok: torch.Tensor     # (M,) bool anchor in the image


def pack_patch_base(last_depth: torch.Tensor, nmap_c: torch.Tensor,
                    icp_weight: torch.Tensor, last_intensity: torch.Tensor) -> torch.Tensor:
    """(H,W)x3 + (H,W,3) -> (H,W,6) base image [d, n_cp(3), w, i]; the
    normal is in the previous CAMERA frame."""
    return torch.cat([last_depth[..., None], nmap_c, icp_weight[..., None],
                      last_intensity[..., None]], dim=-1)


def build_patch_table(base6: torch.Tensor, radius: int) -> torch.Tensor:
    """(H,W,6) -> (H*W, T*6) patch table of shifted copies (out-of-image
    taps are zero, so d = 0 marks them invalid).  Tap order
    d = (dy+R)*(2R+1) + (dx+R)."""
    h, w = base6.shape[:2]
    return extract_patches(base6, radius).reshape(h * w, (2 * radius + 1) ** 2 * 6)


def _warp_cp(R_curr, t_curr, R_prev_inv, t_prev, vcurr):
    """Current-frame points -> (world, previous camera frame)."""
    vcurr_g = mat3_apply(vcurr, R_curr) + t_curr
    return vcurr_g, mat3_apply(vcurr_g - t_prev, R_prev_inv)


def patch_anchor(R_curr: torch.Tensor, t_curr: torch.Tensor,
                 R_prev_inv: torch.Tensor, t_prev: torch.Tensor,
                 vcurr: torch.Tensor, table: torch.Tensor,
                 intr: CameraIntrinsics) -> PatchAssoc:
    """Anchor the patch association at the current warp: one wide row
    gather of the (2R+1)^2-tap patch per tracked pixel."""
    h, w = intr.height, intr.width
    _, vcurr_cp = _warp_cp(R_curr, t_curr, R_prev_inv, t_prev, vcurr)
    z, u0f, v0f = _project(vcurr_cp, intr)
    ui = torch.round(u0f).to(torch.int32)
    vi = torch.round(v0f).to(torch.int32)
    ok = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h) & (z > 0)
    return PatchAssoc(rows=table[_flat(vi, ui, h, w)], au=ui, av=vi, ok=ok)


def joint_step_patch(R_curr: torch.Tensor, t_curr: torch.Tensor,
                     R_prev_inv: torch.Tensor, t_prev: torch.Tensor,
                     patch: PatchAssoc, radius: int,
                     vcurr: torch.Tensor, ncurr: torch.Tensor, valid_curr: torch.Tensor,
                     i_next: torch.Tensor, static_valid: torch.Tensor,
                     intr: CameraIntrinsics, cfg: SLAMConfig):
    """One gather-free joint GN pass against the anchored patch: where the
    rounded warp stays inside the anchor window the association equals
    joint_step's nearest-pixel one; out-of-window pixels drop their
    correspondence.  The system is assembled in the previous camera frame.
    Returns (icp StepResult, RGBCorres)."""
    h, w = intr.height, intr.width
    D = 2 * radius + 1
    _, vcurr_cp = _warp_cp(R_curr, t_curr, R_prev_inv, t_prev, vcurr)
    # normals straight into the previous camera frame (|cross| is rotation
    # invariant, so the angle gate is unchanged)
    ncurr_cp = mat3_apply(ncurr, mat3_mul(R_prev_inv, R_curr))
    z, u0f, v0f = _project(vcurr_cp, intr)
    ui = torch.round(u0f).to(torch.int32)
    vi = torch.round(v0f).to(torch.int32)
    du = ui - patch.au
    dv = vi - patch.av
    inwin = (torch.abs(du) <= radius) & (torch.abs(dv) <= radius) & patch.ok
    tap = torch.clamp((dv + radius) * D + (du + radius), 0, D * D - 1).long()
    r = torch.gather(patch.rows.reshape(-1, D * D, 6), 1,
                     tap[:, None, None].expand(-1, 1, 6))[:, 0]
    d0, n_cp, wp, i_last = r[:, 0], r[:, 1:4], r[:, 4], r[:, 5]
    # model vertex from the tap pixel and its depth (the prediction is on-ray)
    d_cp = torch.stack([(ui.to(torch.float32) - intr.cx) * d0 * (1.0 / intr.fx),
                        (vi.to(torch.float32) - intr.cy) * d0 * (1.0 / intr.fy), d0], dim=-1)
    in_img = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h) & (z > 0)
    ok = in_img & inwin & valid_curr & (d0 > 0) & (_dot(n_cp, n_cp) > 1e-6)
    dist = _norm(d_cp - vcurr_cp)
    sine = _norm(_cross(ncurr_cp, n_cp))
    found = ok & (sine <= cfg.angle_threshold) & (dist <= cfg.dist_threshold)
    icp_res = _icp_rows(found, vcurr_cp, d_cp, n_cp, wp, cfg)

    in_last = (u0f >= 0) & (v0f >= 0) & (u0f <= w - 1) & (v0f <= h - 1) & (z > 0)
    corres = _rgb_corres(u0f, v0f, d0, i_last, z, i_next, static_valid & inwin, in_last, cfg)
    return icp_res, corres


# ---------------------------------------------------------------------- #
# subsampled and top-k pixel sets (cfg.tracking_subsample, tracking_topk)
# ---------------------------------------------------------------------- #

class SubPixels(NamedTuple):
    """Pose-invariant current-frame inputs of the subsampled GN iterations:
    the per-pixel arrays joint_step / rgb_step read, gathered at a pixel
    subset."""

    vcurr: torch.Tensor         # (M,3) unprojected current depth
    ncurr: torch.Tensor         # (M,3)
    valid: torch.Tensor         # (M,) bool ICP validity gate
    i_next: torch.Tensor        # (M,) current intensity
    static_valid: torch.Tensor  # (M,) bool photometric static gate
    gx: torch.Tensor            # (M,) Sobel dI/dx
    gy: torch.Tensor            # (M,) Sobel dI/dy


def _valid_curr(vmap_curr: torch.Tensor, ncurr: torch.Tensor) -> torch.Tensor:
    """The live frame's ICP gate: depth and a unit-ish normal."""
    return (vmap_curr.reshape(-1, 3)[:, 2] > 0) & (_dot(ncurr, ncurr) > 0.25)


def select_pixels(pix: SubPixels, ids: torch.Tensor) -> SubPixels:
    """The SubPixels bundle at (local) flat ids of another one."""
    ids = ids.long()
    return SubPixels(*(f[ids] for f in pix))


def subsample_ids(stride: int, row0: int, rows: int, w: int, device) -> torch.Tensor:
    """Flat ids, within image rows [row0, row0 + rows), of the stride grid
    on the image's own rows and columns (rows that are multiples of
    ``stride``)."""
    first = -(-row0 // stride) * stride
    yy = torch.arange(first - row0, rows, stride, dtype=torch.int64, device=device)
    xx = torch.arange(0, w, stride, dtype=torch.int64, device=device)
    return (yy[:, None] * w + xx[None, :]).reshape(-1)


def pack_sub_pixels(stride: int, vmap_curr, nmap_curr, next_depth, next_image,
                    static_valid, d_idx, d_idy, intr: CameraIntrinsics) -> SubPixels:
    """The SubPixels bundle at the stride-decimated pixel grid."""
    P = intr.height * intr.width
    full = SubPixels(*joint_cur_pack(vmap_curr, nmap_curr, next_depth, intr),
                     i_next=next_image.reshape(P), static_valid=static_valid.reshape(P),
                     gx=d_idx.reshape(P), gy=d_idy.reshape(P))
    return select_pixels(full, subsample_ids(stride, 0, intr.height, intr.width,
                                             next_depth.device))


def saliency_sums(pix: SubPixels, k1=None, k2=None) -> list:
    """The partial sums of ``saliency_ids``' two image-wide normalisers
    over a set of pixels, in float64: [sum |grad I|^2 over the static-
    valid pixels, their count] and, with the curvature maps, [sum clipped
    |k1| + |k2| over the valid pixels, their count]."""
    sv = pix.static_valid
    g2 = torch.where(sv, pix.gx * pix.gx + pix.gy * pix.gy, 0.0)
    out = [torch.sum(g2.double()), sv.sum(dtype=torch.float64)]
    if k1 is not None:
        c = _clipped_curv(pix.valid, k1, k2)
        out += [torch.sum(c.double()), pix.valid.sum(dtype=torch.float64)]
    return out


def _clipped_curv(valid, k1, k2):
    return torch.where(valid, torch.clamp(torch.abs(k1.reshape(-1)) + torch.abs(k2.reshape(-1)),
                                          max=50.0), 0.0)


def _mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """A float64 sum over a float64 count, rounded to float32 once."""
    return (total / torch.clamp(count, min=1.0)).to(torch.float32)


def saliency_select(k: int, sums: list, pix: SubPixels, row0: int, height: int, w: int,
                    k1=None, k2=None) -> torch.Tensor:
    """``saliency_ids``' row-stratified choice within a block of whole
    image rows from image row ``row0`` (``pix`` its pixels in row-major
    order), given the image-wide ``saliency_sums``.  Returns the block's
    flat ids of the chosen pixels, ascending."""
    sv, valid = pix.static_valid, pix.valid
    n = sv.shape[0]
    g2 = torch.where(sv, pix.gx * pix.gx + pix.gy * pix.gy, 0.0)
    score = torch.clamp(g2 / torch.clamp(_mean(sums[0], sums[1]), min=1e-12), max=8.0)
    if k1 is not None:
        c = _clipped_curv(valid, k1, k2)
        score = score + torch.clamp(c / torch.clamp(_mean(sums[2], sums[3]), min=1e-12),
                                    max=8.0)
    # uniform dither in [0, 1): a Weyl sequence on the image's pixel id,
    # the uint32 product modulo 2^32 taken in int64
    ids_all = row0 * w + torch.arange(n, dtype=torch.int64, device=sv.device)
    dither = (((ids_all * 2654435761) & 0xFFFFFFFF) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    score = torch.where(valid | sv, score + dither, -1.0)
    rows = n // w
    k_row = max(1, k // height)
    # a stable descending sort puts equal scores in column order: the
    # first k_row are lax.top_k's choice
    ci = torch.sort(score.reshape(rows, w), dim=1, descending=True, stable=True).indices[:, :k_row]
    ci = torch.sort(ci, dim=1).values
    return (torch.arange(rows, dtype=torch.int64, device=sv.device)[:, None] * w + ci).reshape(-1)


def saliency_count(k: int, height: int, w: int) -> int:
    """Pixels ``saliency_ids`` chooses in an image of ``height`` x ``w``."""
    return height * min(max(1, k // height), w)


def saliency_ids(k: int, vmap_curr, nmap_curr, next_image, static_valid, d_idx, d_idy,
                 intr: CameraIntrinsics, k1=None, k2=None) -> torch.Tensor:
    """The k most informative tracked pixels: score = normalised |grad I|^2
    + normalised clipped (|k1| + |k2|) + a pixel-hash dither that fills the
    remaining slots uniformly over the valid set; invalid pixels score -1.
    The normalisers are image-wide means, each summed in float64 and
    rounded once.  Row-stratified: the k // h best of every scanline
    (effective k is (k // h) * h), ties to the lower column as
    ``jax.lax.top_k`` breaks them.  Returns (k_eff,) int64 flat ids,
    ascending."""
    h, w = intr.height, intr.width
    P = h * w
    ncurr = nmap_curr.reshape(P, 3)
    pix = SubPixels(vcurr=None, ncurr=ncurr, valid=_valid_curr(vmap_curr, ncurr),
                    i_next=next_image.reshape(P), static_valid=static_valid.reshape(P),
                    gx=d_idx.reshape(P), gy=d_idy.reshape(P))
    return saliency_select(k, saliency_sums(pix, k1, k2), pix, 0, h, w, k1, k2)


def joint_cur_pack(vmap_curr, nmap_curr, next_depth, intr: CameraIntrinsics, row0: int = 0):
    """Pose-invariant per-pixel inputs of joint_step: (vcurr, ncurr,
    valid_curr), computed once per pyramid level (of a row slab from
    image row ``row0`` on, when given one)."""
    n_pix = vmap_curr.shape[0] * vmap_curr.shape[1]
    vcurr = camera.unproject(next_depth, intr, row0).reshape(n_pix, 3)
    ncurr = nmap_curr.reshape(n_pix, 3)
    return vcurr, ncurr, _valid_curr(vmap_curr, ncurr)


def joint_step(R_curr: torch.Tensor, t_curr: torch.Tensor,
               R_prev_inv: torch.Tensor, t_prev: torch.Tensor,
               vmap_curr: torch.Tensor, nmap_curr: torch.Tensor,
               next_depth: torch.Tensor,
               joint_rows: torch.Tensor, next_image: torch.Tensor,
               static_valid: torch.Tensor,
               intr: CameraIntrinsics, cfg: SLAMConfig,
               assoc_prev: torch.Tensor | None = None,
               do_gather: bool | None = None,
               nearest: bool = False,
               cur_pack=None,
               sub: SubPixels | None = None):
    """Fused ICP + photometric correspondence pass sharing ONE row gather.

    ``nearest``: ``joint_rows`` is the 9-channel ``pack_joint_nearest``
    table, fetched at the rounded warp; else the 36-channel ``pack_joint``
    table, fetched at the floor pixel: the ICP target is the nearest of
    the four corners and the photometric intensity is bilinear.
    ``assoc_prev`` / ``do_gather``: fixed-correspondence iterations: when
    ``do_gather`` is False the carried association rows [v(3) n(3) w d i]
    are reused and the gather is skipped; residuals, gates and Jacobians
    are still recomputed under the current pose.  ``cur_pack``: the
    hoisted ``joint_cur_pack``; ``sub``: a subsampled current-frame pixel
    set (the model table stays full size).
    Returns (icp StepResult, RGBCorres, assoc (N, 9))."""
    h, w = intr.height, intr.width
    if sub is not None:
        vcurr, ncurr, valid_curr = sub.vcurr, sub.ncurr, sub.valid
        i_next = sub.i_next
        static_valid = sub.static_valid
    else:
        vcurr, ncurr, valid_curr = (cur_pack if cur_pack is not None else
                                    joint_cur_pack(vmap_curr, nmap_curr, next_depth, intr))
        i_next = next_image.reshape(-1)

    vcurr_g, vcurr_cp = _warp_cp(R_curr, t_curr, R_prev_inv, t_prev, vcurr)
    ncurr_g = mat3_apply(ncurr, R_curr)
    z, u0f, v0f = _project(vcurr_cp, intr)
    ui = torch.round(u0f).to(torch.int32)
    vi = torch.round(v0f).to(torch.int32)

    def gather_assoc():
        if nearest:
            return joint_rows[_flat(vi, ui, h, w)]
        # floor pixel clamped before the fraction, so that boundary pixels
        # select corner 00 at the clamped pixel
        u0 = torch.clamp(torch.floor(u0f).to(torch.int32), 0, w - 1)
        v0 = torch.clamp(torch.floor(v0f).to(torch.int32), 0, h - 1)
        au = u0f - u0.to(torch.float32)
        av = v0f - v0.to(torch.float32)
        c = joint_rows[(v0 * w + u0).long()]                       # (N, 36)
        near_u = (au > 0.5)[:, None]
        sel = torch.where((av > 0.5)[:, None],
                          torch.where(near_u, c[:, 27:36], c[:, 18:27]),
                          torch.where(near_u, c[:, 9:18], c[:, 0:9]))
        i00, i01, i10, i11 = c[:, 8], c[:, 17], c[:, 26], c[:, 35]
        i_last = (i00 * (1 - au) * (1 - av) + i01 * au * (1 - av)
                  + i10 * (1 - au) * av + i11 * au * av)
        return torch.cat([sel[:, 0:8], i_last[:, None]], dim=-1)

    assoc = gather_assoc() if assoc_prev is None or do_gather else assoc_prev
    vp, np_, wp, d0, i_last = assoc[:, 0:3], assoc[:, 3:6], assoc[:, 6], assoc[:, 7], assoc[:, 8]

    in_img = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h) & (z > 0)
    ok = in_img & valid_curr & (vp[:, 2] != 0) & (_dot(np_, np_) > 1e-6)
    dist = _norm(vp - vcurr_g)
    sine = _norm(_cross(ncurr_g, np_))
    found = ok & (sine <= cfg.angle_threshold) & (dist <= cfg.dist_threshold)
    icp_res = _icp_rows(found, vcurr_cp, mat3_apply(vp - t_prev, R_prev_inv),
                        mat3_apply(np_, R_prev_inv), wp, cfg)

    in_last = (u0f >= 0) & (v0f >= 0) & (u0f <= w - 1) & (v0f <= h - 1) & (z > 0)
    corres = _rgb_corres(u0f, v0f, d0, i_last, z, i_next, static_valid, in_last, cfg)
    return icp_res, corres, assoc


def rgb_static_valid(next_image: torch.Tensor, d_idx: torch.Tensor,
                     d_idy: torch.Tensor, next_depth: torch.Tensor,
                     min_scale: float, row0: int = 0,
                     height: int | None = None) -> torch.Tensor:
    """Pose-independent photometric gate (reduce.cu:998-1029): in range,
    non-isolated (4x4 window of nextImage > 0), strong gradient, has depth.
    On a row slab, ``row0`` is its first image row and ``height`` the
    image's (the slab's first two and last rows are then wrong unless
    they are the image's border)."""
    h, w = next_image.shape
    P = h * w
    pix = torch.arange(P, device=next_image.device)
    yy, xx = pix // w + row0, pix % w
    in_range = (xx < w - 5) & (yy < (h if height is None else height) - 1)
    # 4x4 window [i-2..i+1] x [j-2..j+1]: the radius-2 patch minus its
    # last row and column
    pat = extract_patches(next_image, 2).reshape(P, 5, 5)[:, :4, :4]
    not_isolated = torch.all(pat.reshape(P, 16) > 0, dim=-1)
    gx = d_idx.reshape(P)
    gy = d_idy.reshape(P)
    strong = (gx * gx + gy * gy) >= min_scale
    return in_range & not_isolated & strong & (next_depth.reshape(P) > 0)


# ---------------------------------------------------------------------- #
# ICP
# ---------------------------------------------------------------------- #

def icp_step(R_curr: torch.Tensor, t_curr: torch.Tensor,
             R_prev_inv: torch.Tensor, t_prev: torch.Tensor,
             vmap_curr: torch.Tensor, nmap_curr: torch.Tensor,
             model_rows: torch.Tensor, intr: CameraIntrinsics, cfg: SLAMConfig,
             k1_curr: torch.Tensor | None = None, k2_curr: torch.Tensor | None = None,
             k1_prev: torch.Tensor | None = None, k2_prev: torch.Tensor | None = None,
             sparse_lambda: torch.Tensor | None = None):
    """Projective-association point-to-plane ICP normal equations
    (reduce.cu:253-573).  The live maps are in their camera frame;
    ``model_rows`` (``pack_model``) hold the prediction in the WORLD frame;
    the system is assembled in the previous camera frame.

    With ``cfg.icp_use_correspondence_search`` the (2R+1)^2 window around
    the projected pixel is scored by p = (D_p + D_n + D_c)/3
    (reduce.cu:349-430; D_p alone without the curvature maps) and the
    lowest-scoring valid tap wins (the first in window order on a tie);
    else the nearest projective tap.  With ``sparse_lambda`` (sparse ICP,
    reduce.cu:479-492) the target moves to d' = d + z - lambda/mu and the
    result is (StepResult, SparseICPExtras).  The live maps may be a block
    of the image's rows (its pixels are then the ones tracked; ``intr`` is
    the whole image's, as ``model_rows`` and the previous curvature maps
    are)."""
    h, w = intr.height, intr.width
    vcurr = vmap_curr.reshape(-1, 3)
    ncurr = nmap_curr.reshape(-1, 3)
    n_pix = vcurr.shape[0]
    valid_curr = (vcurr[:, 2] > 0) & (_dot(ncurr, ncurr) > 0.25)
    vcurr_g, s_cp = _warp_cp(R_curr, t_curr, R_prev_inv, t_prev, vcurr)
    ncurr_g = mat3_apply(ncurr, R_curr)
    z, uf, vf = _project(s_cp, intr)
    u = torch.round(uf).to(torch.int32)
    v = torch.round(vf).to(torch.int32)
    in_img = (u >= 0) & (v >= 0) & (u < w) & (v < h) & (z > 0)

    search = cfg.icp_use_correspondence_search
    radius = cfg.icp_search_radius if search else 0
    dev = vmap_curr.device
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32, device=dev)
    # every tap of the window at once: (T, N), T in row-major window order
    vi = (v[None, :] + offs.repeat_interleave(2 * radius + 1)[:, None])
    ui = (u[None, :] + offs.repeat(2 * radius + 1)[:, None])
    flat = _flat(vi, ui, h, w)
    rows = model_rows[flat]                                       # (T, N, 8)
    vp, np_, wp = rows[..., 0:3], rows[..., 3:6], rows[..., 6]
    ok = (in_img & (vi >= 0) & (vi < h) & (ui >= 0) & (ui < w)
          & (vp[..., 2] != 0) & (_dot(np_, np_) > 1e-6))
    dist = _norm(vp - vcurr_g)
    sine = _norm(_cross(ncurr_g.expand_as(np_), np_))
    ok = ok & (sine <= cfg.angle_threshold) & (dist <= cfg.dist_threshold)

    if search:
        d_p_r = torch.amax(torch.where(ok, dist, -1e8), dim=0)
        p = dist / torch.clamp(d_p_r, min=1e-12)
        if k1_curr is not None and k1_prev is not None:
            k1c = k1_curr.reshape(n_pix)
            k2c = k2_curr.reshape(n_pix)
            k1p = k1_prev.reshape(h * w)[flat]
            k2p = k2_prev.reshape(h * w)[flat]
            ckmax = torch.clamp(torch.maximum(torch.abs(k1p), torch.abs(k2p)), min=1e-6)
            d_n = 1.0 - _dot(np_, ncurr_g)
            d_c = 1.0 - (torch.exp(-torch.abs(k1p - k1c) / ckmax)
                         * torch.exp(-torch.abs(k2p - k2c) / ckmax))
            p = (p + d_n + d_c) * (1.0 / 3.0)
        # the reference's running best with a strict '<' from 1e8: the
        # first tap of least score among the valid ones
        cand = ok & (p < 1e8)
        best = torch.argmin(torch.where(cand, p, float("inf")), dim=0)
        sel = torch.gather(rows, 0, best.view(1, -1, 1).expand(1, -1, rows.shape[-1]))[0]
        sel = torch.where(cand.any(dim=0)[:, None], sel, 0.0)
        best_v, best_n, best_w = sel[:, 0:3], sel[:, 3:6], sel[:, 6]
        found = ok.any(dim=0)
    else:
        best_v, best_n, best_w, found = vp[0], np_[0], wp[0], ok[0]
    found = found & valid_curr

    d_cp = mat3_apply(best_v - t_prev, R_prev_inv)
    n_cp = mat3_apply(best_n, R_prev_inv)
    if sparse_lambda is None:
        return _icp_rows(found, s_cp, d_cp, n_cp, best_w, cfg)
    # sparse ICP: shift the target by the shrinkage variable z and the
    # scaled dual, d' = d + z - lambda/mu
    mu = cfg.sparse_icp_mu
    inv_mu = 1.0 / mu
    zs = lp_shrink(s_cp - d_cp + sparse_lambda * inv_mu, mu, cfg.sparse_icp_p,
                   cfg.sparse_icp_shrink_iters)
    zs = torch.where(found[:, None], zs, 0.0)
    res = _icp_rows(found, s_cp, d_cp + zs - sparse_lambda * inv_mu, n_cp, best_w, cfg)
    return res, SparseICPExtras(found=found, d_cp=d_cp, z=zs)


# ---------------------------------------------------------------------- #
# RGB
# ---------------------------------------------------------------------- #

def rgb_residual(krkinv: torch.Tensor, kt: torch.Tensor,
                 next_depth: torch.Tensor, next_image: torch.Tensor,
                 last_rows: torch.Tensor, static_valid: torch.Tensor,
                 cfg: SLAMConfig, row0: int = 0, height: int | None = None) -> RGBCorres:
    """Photometric correspondences and residual statistics
    (reduce.cu:942-1154): NEXT pixels warped into the LAST image through
    (K R K^-1, K t); the last [depth | intensity] comes from one row gather
    of the ``pack_last`` table: at the rounded pixel with
    ``cfg.tracking_rgb_nearest`` (the reference), else over the 2x2
    footprint (intensity bilinear, depth of the nearest corner).  The
    next maps may be a block of image rows from ``row0`` on (``height``
    the image's; the last table is always the whole image's)."""
    rows, w = next_image.shape
    h = rows if height is None else height
    n_pix = rows * w
    pix = torch.arange(n_pix, device=next_image.device)
    xf = (pix % w).to(torch.float32)
    yf = (pix // w + row0).to(torch.float32)
    d1 = next_depth.reshape(n_pix)
    td1 = d1 * (krkinv[2, 0] * xf + krkinv[2, 1] * yf + krkinv[2, 2]) + kt[2]
    safe_td1 = torch.where(torch.abs(td1) > 1e-12, td1, 1e-12)
    u0f = (d1 * (krkinv[0, 0] * xf + krkinv[0, 1] * yf + krkinv[0, 2]) + kt[0]) / safe_td1
    v0f = (d1 * (krkinv[1, 0] * xf + krkinv[1, 1] * yf + krkinv[1, 2]) + kt[1]) / safe_td1
    in_last = (u0f >= 0) & (v0f >= 0) & (u0f <= w - 1) & (v0f <= h - 1)

    if cfg.tracking_rgb_nearest:
        c = last_rows[_flat(torch.round(v0f), torch.round(u0f), h, w)]
        d0, i_last = c[:, 0], c[:, 1]
    else:
        u0 = torch.floor(u0f).to(torch.int32)
        v0 = torch.floor(v0f).to(torch.int32)
        au = u0f - u0.to(torch.float32)
        av = v0f - v0.to(torch.float32)
        c = last_rows[_flat(v0, u0, h, w)]
        d00, i00, d01, i01, d10, i10, d11, i11 = c.unbind(-1)
        i_last = (i00 * (1 - au) * (1 - av) + i01 * au * (1 - av)
                  + i10 * (1 - au) * av + i11 * au * av)
        # nearest-corner depth (the reference rounds, reduce.cu:1032)
        near_u = au > 0.5
        d0 = torch.where(av > 0.5, torch.where(near_u, d11, d10), torch.where(near_u, d01, d00))
    return _rgb_corres(u0f, v0f, d0, i_last, td1, next_image.reshape(n_pix), static_valid,
                       in_last, cfg)


def rgb_step(corres: RGBCorres, sigma_val: torch.Tensor, d_idx: torch.Tensor,
             d_idy: torch.Tensor, intr: CameraIntrinsics, cfg: SLAMConfig) -> StepResult:
    """Photometric 6-DoF normal equations (reduce.cu:697-896); the 3-D point
    at the matched last pixel comes from the gathered depth."""
    valid = corres.valid
    wgt = sigma_val + torch.abs(corres.diff)
    wgt = torch.where(wgt > 1.19209290e-07, 1.0 / wgt, 1.0)
    wgt = torch.where(sigma_val == -1.0, 1.0, wgt)
    d0 = corres.d0
    cx = (torch.round(corres.u0f) - intr.cx) * d0 * (1.0 / intr.fx)
    cy = (torch.round(corres.v0f) - intr.cy) * d0 * (1.0 / intr.fy)
    cz = d0
    invz = 1.0 / torch.clamp(cz, min=1e-12)
    dix = wgt * cfg.sobel_scale * d_idx.reshape(-1)
    diy = wgt * cfg.sobel_scale * d_idy.reshape(-1)
    v0 = dix * intr.fx * invz
    v1 = diy * intr.fy * invz
    v2 = -(v0 * cx + v1 * cy) * invz
    r3 = -cz * v1 + cy * v2
    r4 = cz * v0 - cx * v2
    r5 = -cy * v0 + cx * v1
    r6 = wgt * corres.diff
    rows = torch.stack([v0, v1, v2, r3, r4, r5, r6], dim=-1)
    rows = torch.where(valid[:, None], rows, 0.0)
    if cfg.rgb_use_gradient_weight:
        gmag = sqrt(dix * dix + diy * diy)
        weight = torch.where(valid, torch.exp(
            -0.5 * (10.0 / torch.clamp(gmag, min=1e-12)) ** 2), 0.0)
    else:
        weight = valid.to(rows.dtype)
    A, b, r2 = _gram(rows, weight)
    return StepResult(A=A, b=b, residual2=r2, count=corres.count)


def so3_step(last_image: torch.Tensor, next_image: torch.Tensor,
             next_grad_rows: torch.Tensor, last_gx: torch.Tensor,
             last_gy: torch.Tensor, image_basis: torch.Tensor,
             kinv: torch.Tensor, krlr: torch.Tensor, row0: int = 0):
    """3-DoF rotation pre-alignment normal equations (reduce.cu:1156-1359).
    Returns (A (3,3), b (3,), r2, count), the sums in float64 (``_sums``).
    The sums run over the pixels of
    ``last_image`` / ``last_gx`` / ``last_gy``: the whole image, or a row
    slab of it from image row ``row0`` on; ``next_image`` and
    ``next_grad_rows`` are always the whole image."""
    h, w = next_image.shape
    n_pix = last_image.numel()
    pix = torch.arange(n_pix, device=next_image.device)
    yy, xx = pix // w + row0, pix % w
    xf = xx.to(torch.float32)
    yf = yy.to(torch.float32)
    ib = image_basis
    wx = ib[0, 0] * xf + ib[0, 1] * yf + ib[0, 2]
    wy = ib[1, 0] * xf + ib[1, 1] * yf + ib[1, 2]
    wz = ib[2, 0] * xf + ib[2, 1] * yf + ib[2, 2]
    u = torch.round(wx / wz).to(torch.int32)
    v = torch.round(wy / wz).to(torch.int32)
    valid = ((u >= 1) & (u < w - 1) & (v >= 1) & (v < h - 1)
             & (xx >= 1) & (xx < w - 1) & (yy >= 1) & (yy < h - 1))
    nrows = next_grad_rows[(torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)).long()]
    i_next = nrows[:, 0]
    gx = (nrows[:, 1] + last_gx.reshape(n_pix)) * 0.5
    gy = (nrows[:, 2] + last_gy.reshape(n_pix)) * 0.5

    px = kinv[0, 0] * xf + kinv[0, 1] * yf + kinv[0, 2]
    py = kinv[1, 0] * xf + kinv[1, 1] * yf + kinv[1, 2]
    pz = kinv[2, 0] * xf + kinv[2, 1] * yf + kinv[2, 2]
    z2 = pz * pz
    a_, b_, c_ = krlr[0, 0], krlr[0, 1], krlr[0, 2]
    d_, e_, f_ = krlr[1, 0], krlr[1, 1], krlr[1, 2]
    g_, h_, i_ = krlr[2, 0], krlr[2, 1], krlr[2, 2]
    lp0 = ((pz * (d_ * gy + a_ * gx)) - (gy * g_ * yf) - (gx * g_ * xf)) / z2
    lp1 = ((pz * (e_ * gy + b_ * gx)) - (gy * h_ * yf) - (gx * h_ * xf)) / z2
    lp2 = ((pz * (f_ * gy + c_ * gx)) - (gy * i_ * yf) - (gx * i_ * xf)) / z2
    lp = torch.stack([lp0, lp1, lp2], dim=-1)
    pt = torch.stack([px, py, pz], dim=-1)
    jac = _cross(lp, pt)
    res = -(i_next - last_image.reshape(n_pix))
    rows = torch.where(valid[:, None], torch.cat([jac, res[:, None]], dim=-1), 0.0)
    S = _sums(rows)
    return S[:3, :3], S[:3, 3], S[3, 3], valid.sum(dtype=torch.float32)


def central_gradients(img: torch.Tensor, row0: int = 0, height: int | None = None):
    """(back - fore)/2 gradients with zero borders (reduce.cu:1172-1188).
    On a row slab, ``row0`` is its first image row and ``height`` the
    image's (the slab's first and last rows are then wrong unless they
    are the image's border)."""
    gx = (torch.roll(img, 1, 1) - torch.roll(img, -1, 1)) * 0.5
    gy = (torch.roll(img, 1, 0) - torch.roll(img, -1, 0)) * 0.5
    h, w = img.shape
    yy = torch.arange(row0, row0 + h, device=img.device)[:, None]
    h = h if height is None else height
    xx = torch.arange(w, device=img.device)[None, :]
    inner = (yy >= 1) & (yy < h - 1) & (xx >= 1) & (xx < w - 1)
    return torch.where(inner, gx, 0.0), torch.where(inner, gy, 0.0)


def pack_so3(image: torch.Tensor) -> torch.Tensor:
    """(H,W) -> (H*W, 3) packed [image, gx, gy] rows."""
    gx, gy = central_gradients(image)
    P = image.numel()
    return torch.stack([image.reshape(P), gx.reshape(P), gy.reshape(P)], dim=-1)


def _ldlt_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled LDL^T solve for tiny SPD systems (n <= 8), no pivoting:
    the caller preconditions and damps, so A is SPD with unit diagonal."""
    n = A.shape[0]
    a = [[A[i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k] * D[k]
        D[j] = torch.clamp(s, min=1e-12)
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k] * D[k]
            L[i][j] = t / D[j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i] / D[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return torch.stack(x)


def solve_system(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonally preconditioned damped LDL^T solve; a non-finite solution
    becomes zero (on the device, no host read)."""
    n = A.shape[0]
    if n > 8:
        raise NotImplementedError("solve_system is ported for n <= 8")
    dinv = 1.0 / sqrt(torch.abs(torch.diagonal(A)) + 1e-12)
    As = A * dinv[:, None] * dinv[None, :]
    As = As + 1e-6 * torch.eye(n, dtype=A.dtype, device=A.device)
    x = _ldlt_solve_unrolled(As, b * dinv) * dinv
    return torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
