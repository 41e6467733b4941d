"""Per-frame preprocessing on torch tensors (port of
``hrbffusion3d_tpu/ops/preprocess.py``): bilateral depth filter,
vertex/normal/radius, HRBF curvature, confidence.

Three stencils are hand-written CUDA kernels (``csrc/preprocess.cu``, the
counterparts of the TPU kernels ``bilateral_filter``, ``normal_pca`` and
``curvature_gradient`` of ``hrbffusion3d_tpu/ops/pallas_kernels.py``; the
curvature kernel also runs the epilogue that the TPU wrapper left to XLA).  Each
wrapper here keeps the JAX package's name and launches its kernel for a CUDA
tensor; a CPU tensor runs the plain version beside it (``*_ref``), which is
the one place the semantics are written.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics, SLAMConfig
from ..core import camera
from ..utils.tensors import norm, sqrt
from . import hrbf, kernels
from .patches import extract_patches


def bilateral_filter(depth: torch.Tensor, cfg: SLAMConfig,
                     pallas_form: bool = False) -> torch.Tensor:
    """Bilateral filter on metric depth (H, W): the CUDA kernel for a CUDA
    tensor, ``bilateral_filter_ref`` for a CPU tensor.  ``pallas_form``
    picks the denominator (see the plain version)."""
    if not kernels.on_card("bilateral_filter", depth):
        return bilateral_filter_ref(depth, cfg, pallas_form)
    h, w = depth.shape
    kernels.check_input("bilateral_filter", depth, (h, w))
    out = torch.empty_like(depth)
    kernels.launch("bilateral_filter", depth, depth.data_ptr(), out.data_ptr(), h, w,
                   cfg.depth_min, cfg.depth_cutoff, int(pallas_form))
    return out


def bilateral_filter_ref(depth: torch.Tensor, cfg: SLAMConfig,
                         pallas_form: bool = False, stats: bool = False):
    """depth_bilateral.frag: R=6 window, sigma_space 4.5 px, sigma_color
    30 mm; depths outside (depth_min, depth_cutoff] are zeroed first.
    Out-of-image taps are absent.  Denominator: the shader form (default,
    the JAX package's XLA version) keeps invalid in-image neighbours in it;
    the Pallas form (``pallas_form=True``, the TPU kernel's) drops every
    neighbour of depth 0.  With ``stats``, returns (filtered depth, the
    (H, W) count of weighted taps, 0 where the output is 0)."""
    d = torch.where((depth > cfg.depth_min) & (depth <= cfg.depth_cutoff), depth, 0.0)
    R = 6
    sigma_space2_inv_half = 0.024691358  # 0.5 / 4.5^2
    sigma_color2_inv_half = 0.000555556 * 1e6
    patches = extract_patches(d, R)
    D = 2 * R + 1
    taps = torch.arange(D * D, device=d.device)
    dy = (taps // D - R).to(d.dtype)
    dx = (taps % D - R).to(d.dtype)
    space2 = dy * dy + dx * dx
    color2 = (d[..., None] - patches) ** 2
    w = torch.exp(-(space2 * sigma_space2_inv_half + color2 * sigma_color2_inv_half))
    in_image = extract_patches(torch.ones_like(d), R) > 0
    keep = patches > 0 if pallas_form else in_image
    w = torch.where(keep, w, 0.0)
    num = torch.sum(patches * w, dim=-1)
    den = torch.sum(w, dim=-1)
    out = torch.where(d > 0, num / torch.clamp(den, min=1e-12), 0.0)
    return (out, torch.where(d > 0, keep.sum(-1), 0)) if stats else out


def _smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (...,3,3) matrices
    (closed-form trigonometric roots + cross-product null space)."""
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]  # noqa: E702
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]  # noqa: E702
    c0 = (a00 * a11 * a22 + 2 * a01 * a02 * a12
          - a00 * a12 * a12 - a11 * a02 * a02 - a22 * a01 * a01)
    c1 = (a00 * a11 - a01 * a01 + a00 * a22 - a02 * a02 + a11 * a22 - a12 * a12)
    c2 = a00 + a11 + a22
    inv3 = 1.0 / 3.0
    c2o3 = c2 * inv3
    ao3 = torch.clamp((c1 - c2 * c2o3) * inv3, max=0.0)
    half_b = 0.5 * (c0 + c2o3 * (2.0 * c2o3 * c2o3 - c1))
    q = torch.clamp(half_b * half_b + ao3 * ao3 * ao3, max=0.0)
    rho = sqrt(-ao3)
    theta = torch.atan2(sqrt(-q), half_b) * inv3
    sqrt3 = math.sqrt(3.0)
    lam_min = c2o3 - rho * (torch.cos(theta) + sqrt3 * torch.sin(theta))
    lam_min = torch.minimum(lam_min, c2o3 - rho * (torch.cos(theta) - sqrt3 * torch.sin(theta)))
    lam_min = torch.minimum(lam_min, c2o3 + 2.0 * rho * torch.cos(theta))
    B = A - lam_min[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    v1 = torch.linalg.cross(r0, r1, dim=-1)
    v2 = torch.linalg.cross(r0, r2, dim=-1)
    v3 = torch.linalg.cross(r1, r2, dim=-1)
    l1 = torch.sum(v1 * v1, -1); l2 = torch.sum(v2 * v2, -1); l3 = torch.sum(v3 * v3, -1)  # noqa: E702
    v = torch.where((l1 >= l2)[..., None] & (l1 >= l3)[..., None], v1,
                    torch.where((l2 >= l3)[..., None], v2, v3))
    return v / torch.clamp(norm(v, dim=-1, keepdim=True), min=1e-20)


def _radius_scale(intr: CameraIntrinsics) -> float:
    """sqrt2 / meanFocal: a surfel's radius per metre of depth."""
    return 1.41421356237 / camera.mean_focal(intr)


def surfel_radius(z: torch.Tensor, n_z: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """surfels.glsl:19-34: sqrt2 * z / meanFocal, slanted by 1/|n_z|,
    clamped at 2x."""
    base = z * _radius_scale(intr)
    slant = base / torch.clamp(torch.abs(n_z), min=1e-6)
    return torch.minimum(2.0 * base, slant)


def _window_slices(x: torch.Tensor, radius: int):
    """Yield the (H, W[, C]) shifted views of zero-padded ``x``, row-major
    over the (2R+1)^2 window."""
    h, w = x.shape[:2]
    pad = [0, 0] * (x.ndim - 2) + [radius, radius, radius, radius]
    xp = F.pad(x, pad)
    d = 2 * radius + 1
    for dy in range(d):
        for dx in range(d):
            yield xp[dy:dy + h, dx:dx + w]


def normal_pca(vertex_f: torch.Tensor, cfg: SLAMConfig) -> torch.Tensor:
    """PCA normals (H, W, 3) of a filtered vertex map: the CUDA kernel for
    a CUDA tensor, ``normal_pca_ref`` for a CPU tensor."""
    if not kernels.on_card("normal_pca", vertex_f):
        return normal_pca_ref(vertex_f, cfg)
    h, w = vertex_f.shape[:2]
    kernels.check_input("normal_pca", vertex_f, (h, w, 3))
    out = torch.empty_like(vertex_f)
    kernels.launch("normal_pca", vertex_f, vertex_f.data_ptr(), out.data_ptr(), h, w,
                   cfg.depth_min)
    return out


def normal_pca_ref(vertex_f: torch.Tensor, cfg: SLAMConfig, stats: bool = False):
    """PCA normal over a 7x7 window: neighbours with z > depth_min and
    |dz| < 0.05, >= 8 of them, smallest covariance eigenvector flipped to
    n_z > 0, 0 where invalid.  Moments accumulate in centre-relative
    coordinates (raw coordinates lose ~6 digits in float32).  With
    ``stats``, returns (normals, the (H, W) count of accepted neighbours)."""
    R = 3
    h, w_ = vertex_f.shape[:2]
    z = vertex_f[..., 2]
    cnt = torch.zeros((h, w_), dtype=torch.int32, device=vertex_f.device)
    s1 = torch.zeros((h, w_, 3), dtype=vertex_f.dtype, device=vertex_f.device)
    s2 = torch.zeros((h, w_, 6), dtype=vertex_f.dtype, device=vertex_f.device)
    for nb in _window_slices(vertex_f, R):
        zn = nb[..., 2]
        valid = (zn > cfg.depth_min) & (torch.abs(zn - z) < 0.05)
        q = torch.where(valid[..., None], nb - vertex_f, 0.0)
        cnt += valid.to(torch.int32)
        s1 += q
        q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
        s2 += torch.stack([q0 * q0, q0 * q1, q0 * q2, q1 * q1, q1 * q2, q2 * q2], dim=-1)
    denom = torch.clamp(cnt, min=1).to(vertex_f.dtype)
    mean = s1 / denom[..., None]
    m0, m1, m2 = mean[..., 0], mean[..., 1], mean[..., 2]
    e2 = s2 / denom[..., None]
    cov6 = e2 - torch.stack([m0 * m0, m0 * m1, m0 * m2, m1 * m1, m1 * m2, m2 * m2], dim=-1)
    cov = hrbf.hess_from_h6(cov6)
    n = _smallest_eigvec_3x3(cov)
    n = n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)
    ok = (cnt >= 8) & (z > cfg.depth_min)
    normals = torch.where(ok[..., None], n, 0.0)
    return (normals, cnt) if stats else normals


def normal_central_diff(vertex_f: torch.Tensor, depth_raw: torch.Tensor,
                        cfg: SLAMConfig, row0: int = 0,
                        height: int | None = None) -> torch.Tensor:
    """Central-difference normal (geometry.glsl:35-47) with the 4-neighbour
    validity gate of utils.glsl checkNeighbours, flipped to n_z > 0 as the
    PCA normal is; the image border is invalid.  On a row slab, ``row0``
    is its first image row and ``height`` the image's (its first and last
    rows are then wrong unless they are the image's border)."""
    del_x = (torch.roll(vertex_f, 1, dims=1) - torch.roll(vertex_f, -1, dims=1)) * 0.5
    del_y = (torch.roll(vertex_f, 1, dims=0) - torch.roll(vertex_f, -1, dims=0)) * 0.5
    n = torch.linalg.cross(del_x, del_y, dim=-1)
    n = n / torch.clamp(norm(n, dim=-1, keepdim=True), min=1e-20)
    n = n * torch.where(n[..., 2:3] < 0, -1.0, 1.0)
    dz = depth_raw
    ok = ((torch.roll(dz, 1, 1) > 0) & (torch.roll(dz, -1, 1) > 0)
          & (torch.roll(dz, 1, 0) > 0) & (torch.roll(dz, -1, 0) > 0) & (dz > 0))
    h, w = dz.shape
    yy, xx = camera.pixel_grid(h, w, dz.device, row0=row0)
    h = h if height is None else height
    ok = ok & (xx >= 1) & (xx < w - 1) & (yy >= 1) & (yy < h - 1)
    return torch.where(ok[..., None], n, 0.0)


class VertexNormalRadius(NamedTuple):
    vertex_raw: torch.Tensor       # (H, W, 3)
    vertex_filtered: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor           # (H, W, 3), zero if invalid
    radius: torch.Tensor           # (H, W), includes cfg.radius_multiplier
    valid: torch.Tensor            # (H, W) bool


def vertex_normal_radius(depth_raw: torch.Tensor, depth_filtered: torch.Tensor,
                         intr: CameraIntrinsics, cfg: SLAMConfig,
                         row0: int = 0) -> VertexNormalRadius:
    """depth_vertex_normal_radius.frag: unproject raw + filtered depth, the
    normal (PCA, or central differences when ``cfg.normal_pca`` is off),
    initial radius = multiplier * surfel radius.  ``row0``: the first
    image row of a row slab (the window's rows near the slab's ends are
    then wrong unless they are the image's)."""
    v_raw = camera.unproject(depth_raw, intr, row0)
    v_f = camera.unproject(depth_filtered, intr, row0)
    n = (normal_pca(v_f, cfg) if cfg.normal_pca
         else normal_central_diff(v_f, depth_raw, cfg, row0, intr.height))
    rad = cfg.radius_multiplier * surfel_radius(v_f[..., 2], n[..., 2], intr)
    valid = ((norm(n, dim=-1) >= 0.3)
             & (v_raw[..., 2] >= cfg.depth_min) & (v_f[..., 2] >= cfg.depth_min))
    vm = valid[..., None]
    return VertexNormalRadius(
        vertex_raw=torch.where(vm, v_raw, 0.0),
        vertex_filtered=torch.where(vm, v_f, 0.0),
        normal=torch.where(vm, n, 0.0),
        radius=torch.where(valid, rad, 0.0),
        valid=valid,
    )


class CurvatureResult(NamedTuple):
    k1: torch.Tensor            # (H, W) max principal curvature (1000 = invalid)
    k2: torch.Tensor            # (H, W)
    dir1: torch.Tensor          # (H, W, 3)
    dir2: torch.Tensor          # (H, W, 3)
    gradient_mag: torch.Tensor  # (H, W) |<grad f, n>|
    normal_opt: torch.Tensor    # (H, W, 3) HRBF-optimised normal (0 if invalid)
    radius_opt: torch.Tensor    # (H, W)
    valid: torch.Tensor         # (H, W) bool


def curvature_gradient(pre: VertexNormalRadius, intr: CameraIntrinsics,
                       cfg: SLAMConfig) -> CurvatureResult:
    """HRBF curvature/gradient pass (depth_curvature_gradient.frag:28-142):
    for CUDA tensors one launch of the fused CUDA kernel (window sums and
    epilogue), for CPU tensors ``curvature_gradient_ref``."""
    if not kernels.on_card("curvature_gradient", pre.vertex_filtered):
        return curvature_gradient_ref(pre, intr, cfg)
    return _curvature_launch(pre.vertex_filtered, pre.normal, pre.radius, cfg,
                             _radius_scale(intr))[0]


def curvature_gradient_ref(pre: VertexNormalRadius, intr: CameraIntrinsics,
                           cfg: SLAMConfig) -> CurvatureResult:
    """Plain version of ``curvature_gradient``: the plain window sums and
    the same epilogue, on any device."""
    sums = curvature_sums_ref(pre.vertex_filtered, pre.normal, pre.radius, cfg)
    return _curvature_epilogue(sums, pre, intr, cfg)


def curvature_sums(v: torch.Tensor, n: torch.Tensor, rad: torch.Tensor,
                   cfg: SLAMConfig) -> torch.Tensor:
    """The (H, W, 10) window sums of ``curvature_sums_ref``: for a CUDA
    tensor the fused curvature kernel, asked to write its sums too (one
    launch; its other fields are dropped), for a CPU tensor the plain
    version."""
    if not kernels.on_card("curvature_gradient", v):
        return curvature_sums_ref(v, n, rad, cfg)
    return _curvature_launch(v, n, rad, cfg, 0.0, with_sums=True)[1]


def _curvature_launch(v: torch.Tensor, n: torch.Tensor, rad: torch.Tensor,
                      cfg: SLAMConfig, rad_scale: float, with_sums: bool = False):
    """One launch of the fused curvature kernel on CUDA tensors: returns
    (``CurvatureResult``, the (H, W, 10) sums or None).  ``rad_scale`` is
    sqrt2 / mean focal length (``surfel_radius``).  The float fields are
    views of one buffer, each contiguous."""
    h, w = v.shape[:2]
    for x, shape in ((v, (h, w, 3)), (n, (h, w, 3)), (rad, (h, w))):
        kernels.check_input("curvature_gradient", x, shape)
    if not 0 <= cfg.curv_window <= 7:
        raise ValueError("curvature_gradient: the kernel takes curv_window <= 7")
    P = h * w
    fields = torch.empty(13 * P, dtype=torch.float32, device=v.device)
    valid = torch.empty((h, w), dtype=torch.bool, device=v.device)
    sums = (torch.empty((h, w, 10), dtype=torch.float32, device=v.device)
            if with_sums else None)
    kernels.launch("curvature_gradient", v, v.data_ptr(), n.data_ptr(), rad.data_ptr(),
                   fields.data_ptr(), valid.data_ptr(),
                   sums.data_ptr() if with_sums else None, h, w, cfg.curv_window,
                   cfg.depth_min, rad_scale, cfg.radius_multiplier)
    k1, k2, d1, d2, gmag, nopt, rad_opt = torch.split(fields, [P, P, 3 * P, 3 * P, P, 3 * P, P])
    out = CurvatureResult(k1=k1.view(h, w), k2=k2.view(h, w), dir1=d1.view(h, w, 3),
                          dir2=d2.view(h, w, 3), gradient_mag=gmag.view(h, w),
                          normal_opt=nopt.view(h, w, 3), radius_opt=rad_opt.view(h, w),
                          valid=valid)
    return out, sums


def curvature_sums_ref(v: torch.Tensor, n: torch.Tensor, radius: torch.Tensor,
                       cfg: SLAMConfig, stats: bool = False):
    """(H, W, 10) = [grad f (3) | hess f as h6 (6) | count] at each centre
    vertex: per window offset ((2 curv_window + 1)^2, row-major), add the
    neighbour's direct (grad f, hess f) contribution where it passes the
    mask (|dz| < 0.10, z > depth_min, |n|^2 > 0.64).  Every masked
    neighbour counts, inside its support or not.

    With ``stats``, returns (sums, scale, inside): ``scale`` (H, W, 10) is
    the sum over taps of each contribution's magnitude (the 1-norm of its
    gradient part in channels 0-2, of its h6 part in 3-8, 0 for the
    count), the yardstick of the sums' float rounding; ``inside`` (H, W) is
    the number of masked taps whose support holds the centre."""
    R = cfg.curv_window
    h, w = v.shape[:2]
    z_c = v[..., 2]
    grad = torch.zeros((h, w, 3), dtype=v.dtype, device=v.device)
    h6 = torch.zeros((h, w, 6), dtype=v.dtype, device=v.device)
    cnt = torch.zeros((h, w), dtype=torch.int32, device=v.device)
    scale = torch.zeros((h, w, 2), dtype=v.dtype, device=v.device)
    inside = torch.zeros((h, w), dtype=torch.int32, device=v.device)
    for nb_v, nb_n, nb_r in zip(_window_slices(v, R), _window_slices(n, R),
                                _window_slices(radius, R)):
        mask = ((torch.abs(nb_v[..., 2] - z_c) < 0.10)
                & (nb_v[..., 2] > cfg.depth_min)
                & (torch.sum(nb_n * nb_n, dim=-1) > 0.64))
        dv = v - nb_v
        d2 = torch.sum(dv * dv, dim=-1)
        g_c, h_c = hrbf.grad_hess_direct(dv, d2, nb_n, nb_r, mask)
        grad += g_c
        h6 += h_c
        cnt += mask.to(torch.int32)
        if stats:
            scale += torch.stack([g_c.abs().sum(-1), h_c.abs().sum(-1)], dim=-1)
            inside += (mask & (d2 <= nb_r * nb_r) & (d2 > 0.0)).to(torch.int32)
    sums = torch.cat([grad, h6, cnt.to(v.dtype)[..., None]], dim=-1)
    if not stats:
        return sums
    scale = torch.cat([scale[..., 0:1].expand(h, w, 3), scale[..., 1:2].expand(h, w, 6),
                       torch.zeros_like(scale[..., 0:1])], dim=-1)
    return sums, scale, inside


def _curvature_epilogue(acc: torch.Tensor, pre: VertexNormalRadius,
                        intr: CameraIntrinsics, cfg: SLAMConfig) -> CurvatureResult:
    """Principal curvatures, gradient magnitude, optimised normal and
    radius from the window sums; > 15 supports required."""
    h, w = acc.shape[:2]
    vc = pre.vertex_filtered.reshape(h * w, 3)
    nc = pre.normal.reshape(h * w, 3)
    acc = acc.reshape(h * w, 10)
    grad = acc[:, 0:3]
    cnt = acc[:, 9]
    H = hrbf.hess_from_h6(acc[:, 3:9])
    k1, k2, d1, d2, kvalid = hrbf.principal_curvatures(grad, H)
    gmag = torch.abs(torch.sum(grad * nc, dim=-1))
    gn = grad / torch.clamp(norm(grad, dim=-1, keepdim=True), min=1e-20)
    center_ok = (vc[..., 2] > cfg.depth_min) & (norm(nc, dim=-1) > 0.5)
    ok = (cnt > 15) & kvalid & center_ok
    ok3 = ok[..., None]
    gn = torch.where(ok3, gn, 0.0)
    rad_opt = torch.where(
        ok, surfel_radius(vc[..., 2], gn[..., 2], intr) * cfg.radius_multiplier, 0.0)
    return CurvatureResult(
        k1=torch.where(ok, k1, 1000.0).reshape(h, w),
        k2=torch.where(ok, k2, 1000.0).reshape(h, w),
        dir1=torch.where(ok3, d1, 0.0).reshape(h, w, 3),
        dir2=torch.where(ok3, d2, 0.0).reshape(h, w, 3),
        gradient_mag=torch.where(ok, gmag, 0.0).reshape(h, w),
        normal_opt=gn.reshape(h, w, 3),
        radius_opt=rad_opt.reshape(h, w),
        valid=ok.reshape(h, w),
    )


def update_normal_rad(pre: VertexNormalRadius, curv: CurvatureResult,
                      cfg: SLAMConfig) -> VertexNormalRadius:
    """depth_update_normalrad.frag: take the HRBF-gradient normal where the
    curvature pass succeeded; the radius keeps its original estimate."""
    use = curv.valid & (norm(curv.normal_opt, dim=-1) > 0.5)
    return pre._replace(normal=torch.where(use[..., None], curv.normal_opt, pre.normal))


def confidence_map(pre: VertexNormalRadius, curv: CurvatureResult,
                   intr: CameraIntrinsics, cfg: SLAMConfig,
                   weighting: torch.Tensor | float = 1.0, row0: int = 0) -> torch.Tensor:
    """conf = exp(-radial^2 / 0.72) * weighting, optionally times
    exp(-epsilon / sqrt(gradient_mag)).  ``row0``: the first image row of
    a row slab."""
    h, w = pre.radius.shape
    yy, xx = camera.pixel_grid(h, w, pre.radius.device, row0=row0)
    dx = xx - intr.cx
    dy = yy - intr.cy
    radial = sqrt(dx * dx + dy * dy) / camera.max_radial_dist(intr)
    conf = torch.exp(-(radial * radial) / 0.72) * weighting
    if cfg.use_conf_eval:
        conf = conf * torch.exp(
            -cfg.conf_eval_epsilon / sqrt(torch.clamp(curv.gradient_mag, min=1e-12)))
    return conf
