"""HRBF surface prediction on torch tensors (port of
``hrbffusion3d_tpu/ops/raycast.py``): the kernel branch of ``predict_hrbf``,
its attribute epilogue, the FillIn composite, and the surfel-splat
prediction (``predict_splat``, the step's off-frames when
``raycast_period > 1``) with its depth-only twin ``render_depth``.

Per pixel the fused ray cast (``kernels.raycast_core``) keeps <= K stable
surfels of the ring-ordered window, brackets the zero crossing of the HRBF
implicit along the viewing ray and refines it; the epilogue fetches the
nearest surfel's attributes and the per-pixel ICP weight
w = 1/z^2 (conf/256 + exp(-lambda^2 / 2 cmax^2)).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..map import surfel_map as smod
from ..map.surfel_map import SurfelMap
from ..utils.tensors import const
from . import kernels

_GEOMETRIC_LADDER = (1, 2, 3, 5, 8, 13, 18, 25)


def ladder_offsets(cfg: SLAMConfig) -> tuple[list[int], int]:
    """Ladder tap offsets (units of ``raycast_coarse_step``) and the
    bisection iteration count: every step with the reference's bisections,
    or the geometric ladder with 3 more bisections."""
    steps = cfg.raycast_coarse_steps
    if not cfg.raycast_geometric_ladder:
        return list(range(1, steps + 1)), cfg.raycast_bisection_iters
    g = [s for s in _GEOMETRIC_LADDER if s < steps] + [steps]
    return g, cfg.raycast_bisection_iters + 3


def bisection_plan(cfg: SLAMConfig) -> tuple[int, int]:
    """(points_per_pass, n_passes) of the root refinement."""
    _, iters = ladder_offsets(cfg)
    B = cfg.raycast_bisection_batch
    if B <= 1:
        return 1, iters
    return B, math.ceil(iters / math.log2(B + 1))


def _ring_offsets(radius: int):
    """Window offsets sorted by ring (Chebyshev distance)."""
    return kernels.ring_taps(radius)


class Prediction(NamedTuple):
    vertex: torch.Tensor      # (H,W,3) predicted surface point, camera frame
    conf: torch.Tensor        # (H,W)
    normal: torch.Tensor      # (H,W,3) unit, camera frame
    radius: torch.Tensor      # (H,W)
    color: torch.Tensor       # (H,W,3)
    k1: torch.Tensor          # (H,W)
    k2: torch.Tensor          # (H,W)
    curv_dir1: torch.Tensor   # (H,W,3)
    curv_dir2: torch.Tensor   # (H,W,3)
    time: torch.Tensor        # (H,W) int32 init time of nearest surfel
    icp_weight: torch.Tensor  # (H,W)
    found: torch.Tensor       # (H,W) bool


def predict_hrbf(m: SurfelMap, pose_inv: torch.Tensor, index_map: torch.Tensor,
                 intr: CameraIntrinsics, cfg: SLAMConfig,
                 attr_ext: torch.Tensor | None = None) -> Prediction:
    """Ray-cast the HRBF implicit through the rendered index map with the
    fused kernel (``kernels.raycast_core``).  ``attr_ext``: optional
    precomputed extended attr image for this index map."""
    P = intr.height * intr.width
    if attr_ext is None:
        attr_ext = smod.render_attr_image(m, index_map, pose_inv, extended=True)
    # [pos | nrm | conf | radius | valid] (A_CONF, A_RADIUS follow A_NRM)
    attr9 = torch.cat([attr_ext[..., 0:smod.A_RADIUS + 1],
                       attr_ext[..., smod.A_VALID:smod.A_VALID + 1]], dim=-1)
    p_surf, grad, nearest, found = kernels.raycast_core(attr9, intr, cfg)
    grad = grad.reshape(P, 3)
    nrm = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-12)
    return _assemble_prediction(attr_ext, pose_inv, p_surf.reshape(P, 3), nrm,
                                nearest.reshape(P), found.reshape(P), intr, cfg)


def _assemble_prediction(attr_ext: torch.Tensor, pose_inv: torch.Tensor,
                         p_surf: torch.Tensor, nrm: torch.Tensor,
                         nearest: torch.Tensor, found: torch.Tensor,
                         intr: CameraIntrinsics, cfg: SLAMConfig,
                         row0: int = 0, attr_row0: int = 0) -> Prediction:
    """Raycast epilogue: the nearest surfel's attributes, fetched from the
    extended attr image at the tap's pixel, and the per-pixel ICP weight.
    On a row slab: the ray cast's outputs are the image rows from ``row0``
    on, and ``attr_ext`` the rows from ``attr_row0`` on, every row within
    the window's radius of them that the image has."""
    w = intr.width
    P = p_surf.shape[0]
    h = P // w
    dev = p_surf.device
    offs = const(_ring_offsets(cfg.predict_window_multiplier), dev,
                 torch.int64)                                   # (n_off, 2) dy, dx
    d_yx = offs[nearest.long()]
    pid = torch.arange(P, device=dev)
    py = torch.clamp(row0 + pid // w + d_yx[:, 0], 0, intr.height - 1) - attr_row0
    px = torch.clamp(pid % w + d_yx[:, 1], 0, w - 1)
    # [conf, radius, init | color(3), k1, k2, d1(3), d2(3)]
    flat = attr_ext.reshape(-1, smod.ATTR_EXT_CHANNELS)
    near = torch.cat([flat[:, smod.A_CONF:smod.A_INIT + 1], flat[:, 12:23]], dim=-1)[py * w + px]
    Rr = pose_inv[:3, :3]
    f1 = found[:, None]

    conf = torch.where(found, near[:, 0], 0.0)
    radius = torch.where(found, near[:, 1], 0.0)
    color = torch.where(f1, near[:, 3:6], 0.0)
    k1 = torch.where(found, near[:, 6], 1000.0)
    k2 = torch.where(found, near[:, 7], 1000.0)
    d1 = torch.where(f1, near[:, 8:11] @ Rr.T, 0.0)
    d2 = torch.where(f1, near[:, 11:14] @ Rr.T, 0.0)
    itime = torch.where(found, near[:, 2].to(torch.int32), 0)

    lam = cfg.icp_curv_weight_lambda
    cmax = torch.maximum(torch.abs(k1), torch.abs(k2))
    zz = torch.clamp(p_surf[:, 2], min=1e-6)
    icp_w = torch.where(
        found,
        (1.0 / (zz * zz)) * (conf / 256.0 + torch.exp(
            -0.5 * lam * lam / torch.clamp(cmax * cmax, min=1e-12))),
        0.0)
    return Prediction(
        vertex=torch.where(f1, p_surf, 0.0).reshape(h, w, 3),
        conf=conf.reshape(h, w),
        normal=torch.where(f1, nrm, 0.0).reshape(h, w, 3),
        radius=radius.reshape(h, w), color=color.reshape(h, w, 3),
        k1=k1.reshape(h, w), k2=k2.reshape(h, w),
        curv_dir1=d1.reshape(h, w, 3), curv_dir2=d2.reshape(h, w, 3),
        time=itime.reshape(h, w), icp_weight=icp_w.reshape(h, w),
        found=found.reshape(h, w),
    )


class FilledPrediction(NamedTuple):
    vertex: torch.Tensor      # (H,W,3)
    conf: torch.Tensor
    normal: torch.Tensor
    radius: torch.Tensor
    color: torch.Tensor       # (H,W,3) rgb [0,1]
    k1: torch.Tensor
    k2: torch.Tensor
    icp_weight: torch.Tensor
    from_model: torch.Tensor  # (H,W) bool density indicator


def fill_in(pred: Prediction, live_vertex: torch.Tensor, live_normal: torch.Tensor,
            live_radius: torch.Tensor, live_color: torch.Tensor,
            live_conf: torch.Tensor, live_k1: torch.Tensor, live_k2: torch.Tensor,
            cfg: SLAMConfig) -> FilledPrediction:
    """FillIn composite: holes in the model prediction take the live frame's
    data, with the ICP weight recomputed from the live curvature."""
    have = pred.found & (pred.vertex[..., 2] > 0)
    t = cfg.curv_valid_threshold
    live_curv_ok = (live_k1 > -t) & (live_k1 < t) & (live_k2 > -t) & (live_k2 < t)
    lam = cfg.icp_curv_weight_lambda
    cmax = torch.maximum(torch.abs(live_k1), torch.abs(live_k2))
    lz = torch.clamp(live_vertex[..., 2], min=1e-6)
    live_w = torch.where(
        live_curv_ok & (live_vertex[..., 2] > 0),
        (1.0 / (lz * lz)) * (live_conf / 256.0 + torch.exp(
            -0.5 * lam * lam / torch.clamp(cmax * cmax, min=1e-12))),
        0.0)
    pick = have[..., None]
    ok3 = live_curv_ok[..., None]
    return FilledPrediction(
        vertex=torch.where(pick, pred.vertex, torch.where(ok3, live_vertex, 0.0)),
        conf=torch.where(have, pred.conf, torch.where(live_curv_ok, live_conf, 0.0)),
        normal=torch.where(pick, pred.normal, torch.where(ok3, live_normal, 0.0)),
        radius=torch.where(have, pred.radius, live_radius),
        color=torch.where(pick, pred.color, live_color),
        k1=torch.where(have, pred.k1, live_k1),
        k2=torch.where(have, pred.k2, live_k2),
        icp_weight=torch.where(have, pred.icp_weight, live_w),
        from_model=have,
    )


def predict_splat(m: SurfelMap, pose_inv: torch.Tensor, index_map: torch.Tensor,
                  intr: CameraIntrinsics, cfg: SLAMConfig) -> Prediction:
    """Classic surfel-splat prediction — the reference's ``combinedPredict``
    alternative path (IndexMap.cpp:359-412, combo_splat.frag:19-63): each
    pixel takes the nearest rendered surfel of the index map (no
    implicit-surface ray cast).  One row gather, no host read."""
    flat = index_map.reshape(-1)
    rows = m.data[torch.clamp(flat, 0, m.data.shape[0] - 1).long()]
    return splat_from_rows(rows, flat >= 0, pose_inv, cfg, index_map.shape)


def splat_from_rows(rows: torch.Tensor, found: torch.Tensor, pose_inv: torch.Tensor,
                    cfg: SLAMConfig, shape) -> Prediction:
    """``predict_splat`` from the (P, 24) map rows of the pixels' surfels
    (``found``: the pixel has one) of an image of ``shape`` (H, W)."""
    h, w = shape
    Rr = pose_inv[:3, :3]
    tt = pose_inv[:3, 3]
    pos = rows[:, smod.POS] @ Rr.T + tt
    nrm = rows[:, smod.NORMAL] @ Rr.T
    conf = rows[:, smod.CONF]
    k1 = rows[:, smod.K1]
    k2 = rows[:, smod.K2]
    lam = cfg.icp_curv_weight_lambda
    cmax = torch.maximum(torch.abs(k1), torch.abs(k2))
    zz = torch.clamp(pos[:, 2], min=1e-6)
    icp_w = torch.where(
        found,
        (1.0 / (zz * zz)) * (conf / 256.0 + torch.exp(
            -0.5 * lam * lam / torch.clamp(cmax * cmax, min=1e-12))),
        0.0)
    z3 = found[:, None]
    return Prediction(
        vertex=torch.where(z3, pos, 0.0).reshape(h, w, 3),
        conf=torch.where(found, conf, 0.0).reshape(h, w),
        normal=torch.where(z3, nrm, 0.0).reshape(h, w, 3),
        radius=torch.where(found, rows[:, smod.RADIUS], 0.0).reshape(h, w),
        color=torch.where(z3, rows[:, smod.COLOR], 0.0).reshape(h, w, 3),
        k1=torch.where(found, k1, 1000.0).reshape(h, w),
        k2=torch.where(found, k2, 1000.0).reshape(h, w),
        curv_dir1=torch.where(z3, rows[:, smod.CURV_DIR1] @ Rr.T, 0.0).reshape(h, w, 3),
        curv_dir2=torch.where(z3, rows[:, smod.CURV_DIR2] @ Rr.T, 0.0).reshape(h, w, 3),
        time=torch.where(found, rows[:, smod.INIT_TIME].to(torch.int32), 0).reshape(h, w),
        icp_weight=icp_w.reshape(h, w),
        found=found.reshape(h, w),
    )


def render_depth(m: SurfelMap, pose_inv: torch.Tensor, index_map: torch.Tensor,
                 intr: CameraIntrinsics) -> torch.Tensor:
    """Depth-only render for display/debug (IndexMap::renderDepth,
    IndexMap.cpp:269-301)."""
    h, w = intr.height, intr.width
    flat = index_map.reshape(h * w)
    rows = m.data[torch.clamp(flat, 0, m.data.shape[0] - 1).long()]
    pos = rows[:, smod.POS] @ pose_inv[:3, :3].T + pose_inv[:3, 3]
    return torch.where(flat >= 0, pos[:, 2], 0.0).reshape(h, w)
