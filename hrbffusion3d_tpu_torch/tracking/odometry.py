"""Frame-to-model tracking on torch tensors (port of
``hrbffusion3d_tpu/tracking/odometry.py``): SO(3) image-warp pre-alignment
at the coarsest level, then coarse-to-fine ICP + photometric Gauss-Newton
solving (A_rgb + w^2 A_icp) x = (b_rgb + w b_icp), w = ``cfg.icp_weight``,
under every tracking setting of ``SLAMConfig``: the fused single-gather
pass (nearest or bilinear), the separate ICP and photometric terms
(correspondence search, sparse ICP, ICP only, RGB only), fixed-correspondence
iterations, early exit, and the finest level's subsampled, top-k and
patch-anchored iterations.

One Gauss-Newton body serves every setting, whole or row-sharded
(``track_levels``): each shard of a ``parallel.mesh.Mesh`` evaluates its
own pixels against model tables all-gathered per level, and the systems,
counts and image-wide sums are reduced with ``Mesh.psum``; ``track`` of
whole-image ``TrackingInputs`` is its case of one shard.

The iteration budgets are Python loops.  The divergence and keep-best
logic, and the early exit (``cfg.tracking_converge_eps``), stay on the
device as ``torch.where`` over the carry: once an iteration's increment is
small enough, the later ones of that loop leave the carry unchanged, which
is the result of the JAX package's early-exiting loop without its saving.
Nothing is read back to the host.

The Gauss-Newton systems are summed in float64 (``ops/icp._sums``) and the
pose arithmetic between iterations (the increment, the current pose, the
SO(3) image bases, the photometric warp) runs in float64 too; each is
rounded to float32 once.  A float32 sum can differ in its last bit with
the order it is taken in, and a float32 product of small matrices or a
float32 sine from one device to another; one bit of pose moves a pixel's
nearest-pixel association now and then, which the later iterations
amplify.  Summed in float64, a system is the same over row shards
(``parallel/sharded_step``), and with the pose arithmetic in float64 too
the card's tracks stay closer to the CPU's (``scripts/torch_track_sums.py``
measures both).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..core import lie
from ..ops import icp as icp_ops
from ..ops import pyramid as pyr_ops
from ..parallel.mesh import Mesh, On
from ..utils.tensors import const, norm, sqrt


class TrackingInputs(NamedTuple):
    """Per-level (tuple indexed by pyramid level) tracking inputs.  next_* =
    live frame (camera frame); last_* = model prediction (vertex/normal in
    the WORLD frame, depth/intensity in the previous camera);
    prev_intensity = previous live frame (for the SO(3) pre-alignment)."""

    next_depth: tuple
    next_intensity: tuple
    next_vmap: tuple
    next_nmap: tuple
    last_depth: tuple
    last_intensity: tuple
    last_vmap_g: tuple
    last_nmap_g: tuple
    icp_weight: tuple
    prev_intensity: tuple
    # curvature pyramids of the correspondence search's score
    # (reduce.cu:415-422), built only with cfg.icp_use_correspondence_search
    next_k1: tuple = ()
    next_k2: tuple = ()
    last_k1: tuple = ()
    last_k2: tuple = ()
    # the live curvature of the finest level alone (1-tuples), for the
    # saliency score of cfg.tracking_topk
    sal_k1: tuple = ()
    sal_k2: tuple = ()


def build_inputs(next_depth, next_intensity, next_vmap, next_nmap,
                 pred_vmap, pred_nmap, pred_intensity, icp_weight,
                 prev_R, prev_t, prev_intensity, cfg: SLAMConfig,
                 next_k1=None, next_k2=None, pred_k1=None, pred_k2=None,
                 sal_k1=None, sal_k2=None) -> TrackingInputs:
    """Build all pyramids with the fused per-level passes; the model
    prediction moves to the world frame with the previous pose.  The
    curvature maps ride along with the ICP weight in the pooled scalars."""
    L = cfg.num_pyramid_levels
    pred_valid = pred_vmap[..., 2] > 0
    vmap_g = torch.where(pred_valid[..., None], icp_ops.mat3_apply(pred_vmap, prev_R) + prev_t,
                         0.0)
    nmap_g = torch.where(pred_valid[..., None], icp_ops.mat3_apply(pred_nmap, prev_R), 0.0)
    pred_depth = torch.where(pred_valid, pred_vmap[..., 2], 0.0)
    use_curv = cfg.icp_use_correspondence_search and next_k1 is not None

    levels = [{
        "deps": (next_depth, pred_depth),
        "ints": (next_intensity, pred_intensity, prev_intensity),
        "vmaps": (next_vmap, vmap_g),
        "nmaps": (next_nmap, nmap_g),
        "scalars": (icp_weight,) + ((next_k1, next_k2, pred_k1, pred_k2) if use_curv else ()),
    }]
    for _ in range(L - 1):
        p = levels[-1]
        deps = pyr_ops.pyr_down_depth_mc(torch.stack(p["deps"], dim=-1))
        ints = pyr_ops.pyr_down_intensity_mc(torch.stack(p["ints"], dim=-1))
        vms, nms, scs = pyr_ops.resize_maps_fused(
            list(p["vmaps"]), list(p["nmaps"]), list(p["scalars"]))
        levels.append({
            "deps": tuple(deps[..., i] for i in range(len(p["deps"]))),
            "ints": tuple(ints[..., i] for i in range(len(p["ints"]))),
            "vmaps": tuple(vms), "nmaps": tuple(nms), "scalars": tuple(scs),
        })

    def pyr(group, i):
        return tuple(lvl[group][i] for lvl in levels)

    curv = ({"next_k1": pyr("scalars", 1), "next_k2": pyr("scalars", 2),
             "last_k1": pyr("scalars", 3), "last_k2": pyr("scalars", 4)} if use_curv else {})
    sal = {"sal_k1": (sal_k1,), "sal_k2": (sal_k2,)} if sal_k1 is not None else {}
    return TrackingInputs(
        next_depth=pyr("deps", 0), next_intensity=pyr("ints", 0),
        next_vmap=pyr("vmaps", 0), next_nmap=pyr("nmaps", 0),
        last_depth=pyr("deps", 1), last_intensity=pyr("ints", 1),
        last_vmap_g=pyr("vmaps", 1), last_nmap_g=pyr("nmaps", 1),
        icp_weight=pyr("scalars", 0), prev_intensity=pyr("ints", 2), **curv, **sal)


class TrackResult(NamedTuple):
    R: torch.Tensor           # (3,3) new pose rotation (world <- cam)
    t: torch.Tensor           # (3,)
    icp_error: torch.Tensor   # sqrt(residual2)/count at the finest level
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    A: torch.Tensor           # (6,6) final joint system
    b: torch.Tensor
    # (L,) int32 Gauss-Newton iterations that changed the carry, per level
    # (the budget unless cfg.tracking_converge_eps stopped a loop early)
    live_iters: torch.Tensor | None = None


def _k_matrix(intr: CameraIntrinsics, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, K^-1) as float32 tensors; the inverse is taken on the host."""
    K = np.array([[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]],
                 np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    return const(K, device), const(Kinv, device)


def current_pose(prev_T: torch.Tensor, result_rt: torch.Tensor) -> torch.Tensor:
    """currentT = prevT * resultRt^-1, in float64, rounded once."""
    return (prev_T.double() @ lie.se3_inverse(result_rt.double())).to(torch.float32)


def apply_increment(result_rt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """computeUpdateSE3: [rodrigues(x[3:]) | x[:3]] composed on the left of
    ``result_rt``, in float64, rounded once."""
    x = x.double()
    inc = torch.eye(4, dtype=torch.float64, device=x.device)
    inc[:3, :3] = lie.so3_exp(x[3:])
    inc[:3, 3] = x[:3]
    return (inc @ result_rt.double()).to(torch.float32)


def so3_bases(K: torch.Tensor, R_lr: torch.Tensor, Kinv: torch.Tensor):
    """(K R K^-1, K R) of the SO(3) pre-alignment, in float64, rounded
    once."""
    KR = K.double() @ R_lr.double()
    return (KR @ Kinv.double()).to(torch.float32), KR.to(torch.float32)


def so3_update(w: torch.Tensor, R_lr: torch.Tensor) -> torch.Tensor:
    """rodrigues(w) R_lr, in float64, rounded once."""
    return (lie.so3_exp(w.double()) @ R_lr.double()).to(torch.float32)


def rgb_warp(K: torch.Tensor, Kinv: torch.Tensor, result_rt: torch.Tensor):
    """(K R K^-1, K t) of resultRt^-1, the photometric warp, in float64,
    rounded once."""
    rt_inv = lie.se3_inverse(result_rt.double())
    K64 = K.double()
    return ((K64 @ rt_inv[:3, :3] @ Kinv.double()).to(torch.float32),
            (K64 @ rt_inv[:3, 3]).to(torch.float32))


def robust_sigma(count: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The photometric robustifier's scale: sigmaVal = sqrt(count) (the
    reference's quirk, RGBDOdometry.cpp:1017) times ``scale``."""
    return sqrt(torch.clamp(count, min=1.0)) * scale


def joint_system(icp_res: icp_ops.StepResult, rgb_res: icp_ops.StepResult,
                 rgb_sigma_sum: torch.Tensor, rgb_count: torch.Tensor, w: float):
    """One Gauss-Newton iteration's joint system from its float64 ICP and
    photometric sums, the ICP term weighted by ``w``: (A, b) rounded to
    float32 once, and the iteration's stats."""
    A = (rgb_res.A + (w * w) * icp_res.A).to(torch.float32)
    b = (rgb_res.b + w * icp_res.b).to(torch.float32)
    st = {"rgb_e": sqrt(rgb_sigma_sum) / torch.clamp(rgb_count, min=1.0),
          "rgb_c": rgb_count,
          "icp_e": sqrt(icp_res.residual2.to(torch.float32))
          / torch.clamp(icp_res.count, min=1.0),
          "icp_c": icp_res.count}
    return A, b, st


def so3_loop(sums, K: torch.Tensor, Kinv: torch.Tensor, n_iters: int) -> torch.Tensor:
    """The SO(3) pre-alignment's iterations with the reference's keep-best /
    divergence rule as a masked carry; ``sums(basis, krlr)`` gives an
    iteration's (A, b, r2, count), A, b and r2 float64 sums, at the image
    bases (K R K^-1, K R)."""
    eye = torch.eye(3, dtype=torch.float32, device=K.device)
    R_lr, best_R = eye, eye
    last_err = torch.full((), 3.4e37, dtype=torch.float32, device=K.device)
    done = torch.zeros((), dtype=torch.bool, device=K.device)
    for _ in range(n_iters):
        A, b, r2, cnt = sums(*so3_bases(K, R_lr, Kinv))
        A, b, r2 = (x.to(torch.float32) for x in (A, b, r2))
        err = sqrt(r2) / torch.clamp(cnt, min=1.0)
        diverged = err > last_err + 0.001
        upd = so3_update(icp_ops.solve_system(A, b), R_lr)
        new_done = done | diverged
        best_R = torch.where(diverged & ~done, best_R, R_lr)
        R_lr = torch.where(new_done, R_lr, upd)
        last_err = torch.where(new_done, last_err, err)
        done = new_done
    return torch.where(done, best_R, R_lr)


class Level(NamedTuple):
    """One pyramid level of the tracker's inputs over a mesh: ``shards``
    holds each local shard's rows of the level's images (a dict: next_*
    the live frame, last_* the model prediction with its vertices and
    normals in the world frame, prev_int the previous live intensity,
    icp_weight; with the correspondence search next_k1 / next_k2 /
    last_k1 / last_k2; at the finest level with top-k sal_k1 / sal_k2),
    ``bounds`` every shard's rows at this level in the global order, and
    ``height`` the level's image height."""

    shards: list
    bounds: list
    height: int


_FIELDS = {"next_depth": "next_depth", "next_int": "next_intensity", "next_vmap": "next_vmap",
           "next_nmap": "next_nmap", "last_depth": "last_depth", "last_int": "last_intensity",
           "last_vmap": "last_vmap_g", "last_nmap": "last_nmap_g", "icp_weight": "icp_weight",
           "prev_int": "prev_intensity", "next_k1": "next_k1", "next_k2": "next_k2",
           "last_k1": "last_k1", "last_k2": "last_k2", "sal_k1": "sal_k1", "sal_k2": "sal_k2"}


def whole_levels(inp: TrackingInputs) -> list:
    """``TrackingInputs`` as the levels of a one-shard mesh."""
    out = []
    for lvl, depth in enumerate(inp.next_depth):
        shard = {k: getattr(inp, f)[lvl] for k, f in _FIELDS.items()
                 if len(getattr(inp, f)) > lvl}
        out.append(Level([shard], [(0, depth.shape[0])], depth.shape[0]))
    return out


def _so3_prealign(levels: list, mesh: Mesh, intr: CameraIntrinsics, cfg: SLAMConfig):
    """Rotation pre-alignment at the coarsest level (RGBDOdometry.cpp:
    827-914): each shard's sums over its own rows, reduced by ``psum``;
    the live image's packed gradient rows all-gathered (they are read at
    warped pixels anywhere); the solve once."""
    lvl = cfg.num_pyramid_levels - 1
    lv = levels[lvl]
    li = intr.level(lvl)
    K, Kinv = _k_matrix(li, mesh.home)
    mine = mesh.local(lv.bounds)
    nxt = mesh.slabs([s["next_int"] for s in lv.shards], lv.bounds, lv.height, 1, 1)
    prev = mesh.slabs([s["prev_int"] for s in lv.shards], lv.bounds, lv.height, 1, 1)
    grad_rows, last, last_g = [], [], []
    for (a, b), (img, s0), (pimg, p0) in zip(mine, nxt, prev):
        gx, gy = icp_ops.central_gradients(img, s0, lv.height)
        i0, i1 = a - s0, b - s0
        grad_rows.append(torch.stack([img[i0:i1].reshape(-1), gx[i0:i1].reshape(-1),
                                      gy[i0:i1].reshape(-1)], dim=-1))
        lgx, lgy = icp_ops.central_gradients(pimg, p0, lv.height)
        last.append(pimg[a - p0:b - p0])
        last_g.append((lgx[a - p0:b - p0], lgy[a - p0:b - p0]))
    table = mesh.all_gather(grad_rows)
    next_whole = [t[:, 0].reshape(lv.height, li.width) for t in table]
    kinv = On(Kinv)

    def sums(basis, krlr):
        basis, krlr = On(basis), On(krlr)
        return mesh.psum([list(icp_ops.so3_step(
            last[k], next_whole[k], table[k], *last_g[k], basis(dev), kinv(dev), krlr(dev),
            row0=a)) for k, ((a, _), dev) in enumerate(zip(mine, mesh.devices))])[0]

    return so3_loop(sums, K, Kinv, cfg.so3_iterations)


def _where_carry(keep: torch.Tensor, old, new):
    """``old`` where the () bool ``keep`` holds, else ``new``, over a carry
    of tensors, tuples, dicts and None."""
    if old is None:
        return None
    if isinstance(old, dict):
        return {k: _where_carry(keep, old[k], new[k]) for k in old}
    if isinstance(old, tuple):
        return tuple(_where_carry(keep, a, b) for a, b in zip(old, new))
    return torch.where(keep, old, new)


def _gn_loop(body, n_iters: int, carry, eps: float):
    """Run ``body`` (i, carry -> (carry, |dx|)) ``n_iters`` times.  With
    ``eps > 0`` the loop ends, in effect, after the first iteration whose
    SE(3) increment norm is <= eps: every later one still runs but leaves
    the carry unchanged (a device-side flag, no host read).  Returns
    (carry, the iterations that changed it: an int, or a () int32 tensor
    with ``eps > 0``)."""
    if eps <= 0.0:
        for i in range(n_iters):
            carry, _ = body(i, carry)
        return carry, n_iters
    dev = carry[0].device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    live = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n_iters):
        new, dx = body(i, carry)
        live = live + (~done).to(torch.int32)
        carry = _where_carry(done, carry, new)
        done = done | ~(dx > eps)
    return carry, live


def _per_device(tables, build):
    """``build`` of each local shard's all-gathered table, once per device."""
    done = {}
    return [done.setdefault(t.device, build(t)) for t in tables]


def track(prev_R: torch.Tensor, prev_t: torch.Tensor, inp: TrackingInputs,
          intr: CameraIntrinsics, cfg: SLAMConfig, rgb_only: bool = False) -> TrackResult:
    """Incremental-transform estimate (RGBDOdometry.cpp:796-1249) from
    whole-image inputs: ``track_levels`` on a mesh of one shard."""
    return track_levels(prev_R, prev_t, whole_levels(inp), Mesh([prev_R.device]), intr, cfg,
                        rgb_only)


def track_levels(prev_R: torch.Tensor, prev_t: torch.Tensor, levels: list, mesh: Mesh,
                 intr: CameraIntrinsics, cfg: SLAMConfig, rgb_only: bool = False) -> TrackResult:
    """Incremental-transform estimate (RGBDOdometry.cpp:796-1249) with the
    inputs' rows split over ``mesh`` (``levels``: one ``Level`` per
    pyramid level).

    ``cfg.icp_weight`` >= 100 tracks with ICP alone, 0 (or ``rgb_only``)
    with the photometric term alone.  The fused single-gather pass runs
    when both terms do, with neither sparse ICP nor the correspondence
    search, and with nearest-pixel photometric lookups or
    ``cfg.tracking_joint_gather``; the separate ``icp_step`` +
    ``rgb_residual`` formulation otherwise.  The finest level's top-k,
    patch and subsample iterations and the fixed-correspondence ones ride
    on the fused pass.

    Each shard evaluates the residuals of its own pixels (their gradients
    and photometric gate from a 2-row halo) against model tables
    all-gathered per level (they are read at projected pixels anywhere);
    every Gauss-Newton system, count and image-wide sum is reduced with
    ``psum`` (the systems float64, rounded once), and the solves run once,
    on the mesh's first device.  Per-pixel state (sparse ICP's lambda map,
    the fixed correspondences) stays with its shard.  On a mesh of one
    shard this is the whole-image tracker."""
    use_icp = (not rgb_only) and cfg.icp_weight > 0
    use_rgb = rgb_only or cfg.icp_weight < 100
    home, devs = mesh.home, mesh.devices
    result_rt = torch.eye(4, dtype=torch.float32, device=home)
    if cfg.so3_prealign and use_rgb:
        result_rt[:3, :3] = _so3_prealign(levels, mesh, intr, cfg)

    prev_R_inv, prev_t_on = On(prev_R.T), On(prev_t)
    prev_T = lie.rt_to_mat(prev_R, prev_t)
    zero = torch.zeros((), dtype=torch.float32, device=home)
    stats = {"icp_e": zero, "icp_c": zero, "rgb_e": zero, "rgb_c": zero}
    carry = (result_rt, torch.zeros((6, 6), dtype=torch.float32, device=home),
             torch.zeros((6,), dtype=torch.float32, device=home), stats, None)
    iters = cfg.pyramid_iterations
    eps = cfg.tracking_converge_eps
    live = {}

    for lvl in range(cfg.num_pyramid_levels - 1, -1, -1):
        lv = levels[lvl]
        li = intr.level(lvl)
        w = li.width
        mine = mesh.local(lv.bounds)
        K, Kinv = _k_matrix(li, home)
        min_scale = (cfg.min_gradient_magnitudes[lvl] ** 2) / (cfg.sobel_scale ** 2)
        use_sparse = cfg.icp_use_sparse and use_icp
        # the fused pass: ICP + photometric share one row gather
        use_joint = ((cfg.tracking_joint_gather or cfg.tracking_rgb_nearest)
                     and use_rgb and use_icp and not use_sparse
                     and not cfg.icp_use_correspondence_search)
        has_curv = "next_k1" in lv.shards[0]

        # per shard, pose-invariant: the Sobel gradients and the
        # photometric gate of its pixels, from a 2-row halo
        ints = mesh.slabs([s["next_int"] for s in lv.shards], lv.bounds, lv.height, 2, 2)
        deps = mesh.slabs([s["next_depth"] for s in lv.shards], lv.bounds, lv.height, 2, 2)
        full = []
        for (a, b), s, (img, s0), (dep, _) in zip(mine, lv.shards, ints, deps):
            gx, gy = pyr_ops.sobel_derivatives(img)
            sv = icp_ops.rgb_static_valid(img, gx, gy, dep, min_scale, s0, lv.height)
            i0, i1 = a - s0, b - s0
            n = (b - a) * w
            own = dict(i_next=s["next_int"].reshape(n),
                       static_valid=sv.reshape(-1, w)[i0:i1].reshape(n),
                       gx=gx[i0:i1].reshape(n), gy=gy[i0:i1].reshape(n))
            if use_joint:
                vc, nc, vl = icp_ops.joint_cur_pack(s["next_vmap"], s["next_nmap"],
                                                    s["next_depth"], li, row0=a)
                full.append(icp_ops.SubPixels(vcurr=vc, ncurr=nc, valid=vl, **own))
            else:
                full.append(icp_ops.SubPixels(vcurr=None, ncurr=None, valid=None, **own))

        # model tables, all-gathered per level
        if use_joint:
            tables = mesh.all_gather([icp_ops.pack_joint_nearest(
                s["last_vmap"], s["last_nmap"], s["icp_weight"], s["last_depth"], s["last_int"])
                for s in lv.shards])
            if not cfg.tracking_rgb_nearest:
                tables = _per_device(tables, lambda t: icp_ops.joint_footprint(
                    t.reshape(lv.height, w, 9)))
        else:
            models = mesh.all_gather([icp_ops.pack_model(s["last_vmap"], s["last_nmap"],
                                                         s["icp_weight"]) for s in lv.shards])
            lasts = _per_device(mesh.all_gather([
                torch.stack([s["last_depth"], s["last_int"]], dim=-1).reshape(-1, 2)
                for s in lv.shards]), lambda t: icp_ops.pack_last(
                    t[:, 0].reshape(lv.height, w), t[:, 1].reshape(lv.height, w)))
            curv_prev = (mesh.all_gather([torch.stack([s["last_k1"], s["last_k2"]],
                                                      dim=-1).reshape(-1, 2)
                                          for s in lv.shards]) if has_curv else None)
        # fixed-correspondence iterations: carry the association rows and
        # re-gather every reassoc-th iteration only
        reassoc = (cfg.tracking_reassoc_period
                   if use_joint and cfg.tracking_reassoc_period > 1 else 1)

        def body(it, carry, sub=None, patch=None, sv_scale=None):
            result_rt, _, _, st, extra = carry
            cur = current_pose(prev_T, result_rt)
            R_c, t_c = On(cur[:3, :3]), On(cur[:3, 3])
            pix = full if sub is None else sub
            if use_joint:
                passes = []
                for k, (dev, p) in enumerate(zip(devs, pix)):
                    if patch is not None:
                        icp_res, corres = icp_ops.joint_step_patch(
                            R_c(dev), t_c(dev), prev_R_inv(dev), prev_t_on(dev), patch[k],
                            cfg.tracking_patch_radius, p.vcurr, p.ncurr, p.valid, p.i_next,
                            p.static_valid, li, cfg)
                        assoc = None
                    else:
                        icp_res, corres, assoc = icp_ops.joint_step(
                            R_c(dev), t_c(dev), prev_R_inv(dev), prev_t_on(dev), None, None,
                            None, tables[k], None, None, li, cfg,
                            assoc_prev=extra[k] if reassoc > 1 else None,
                            do_gather=it % reassoc == 0 if reassoc > 1 else None,
                            nearest=cfg.tracking_rgb_nearest, sub=p)
                    passes.append((icp_res, corres, assoc))
                n_rgb, ssum = mesh.psum([[c.count, c.sigma_sum] for _, c, _ in passes])[0]
                # subsampled iterations keep the full set's robustifier
                # scale times the stride
                if sv_scale is None:
                    sv_scale = float(cfg.tracking_subsample) if sub is not None else 1.0
                sigma = On(robust_sigma(n_rgb, sv_scale))
                sums = mesh.psum([
                    [*icp_res, *icp_ops.rgb_step(corres, sigma(dev), p.gx, p.gy, li, cfg)[:2]]
                    for dev, p, (icp_res, corres, _) in zip(devs, pix, passes)])[0]
                A, b, st = joint_system(icp_ops.StepResult(*sums[:4]),
                                        icp_ops.StepResult(sums[4], sums[5], None, None),
                                        ssum, n_rgb, cfg.icp_weight)
                if reassoc > 1:
                    extra = tuple(assoc for _, _, assoc in passes)
            else:
                A = b = None
                if use_rgb:
                    krkinv, kt = (On(x) for x in rgb_warp(K, Kinv, result_rt))
                    cors = [icp_ops.rgb_residual(krkinv(dev), kt(dev), s["next_depth"],
                                                 s["next_int"], lasts[k], p.static_valid, cfg,
                                                 row0=a, height=lv.height)
                            for k, (dev, s, p, (a, _)) in enumerate(zip(devs, lv.shards, pix,
                                                                         mine))]
                    n_rgb, ssum = mesh.psum([[c.count, c.sigma_sum] for c in cors])[0]
                    sigma = On(torch.full((), -1.0, device=home) if rgb_only
                               else robust_sigma(n_rgb))
                    A, b = mesh.psum([list(icp_ops.rgb_step(c, sigma(dev), p.gx, p.gy, li,
                                                            cfg)[:2])
                                      for dev, c, p in zip(devs, cors, pix)])[0]
                    st = {**st, "rgb_e": sqrt(ssum) / torch.clamp(n_rgb, min=1.0),
                          "rgb_c": n_rgb}
                if use_icp:
                    outs = [icp_ops.icp_step(
                        R_c(dev), t_c(dev), prev_R_inv(dev), prev_t_on(dev), s["next_vmap"],
                        s["next_nmap"], models[k], li, cfg,
                        k1_curr=s["next_k1"] if has_curv else None,
                        k2_curr=s["next_k2"] if has_curv else None,
                        k1_prev=curv_prev[k][:, 0] if has_curv else None,
                        k2_prev=curv_prev[k][:, 1] if has_curv else None,
                        sparse_lambda=extra[k] if use_sparse else None)
                        for k, (dev, s) in enumerate(zip(devs, lv.shards))]
                    icp_res = icp_ops.StepResult(*mesh.psum(
                        [list(o[0] if use_sparse else o) for o in outs])[0])
                    wt = cfg.icp_weight if use_rgb else 1.0
                    A = (wt * wt) * icp_res.A if A is None else A + (wt * wt) * icp_res.A
                    b = wt * icp_res.b if b is None else b + wt * icp_res.b
                    st = {**st, "icp_e": sqrt(icp_res.residual2.to(torch.float32))
                          / torch.clamp(icp_res.count, min=1.0), "icp_c": icp_res.count}
                # the float64 sums rounded once
                A, b = A.to(torch.float32), b.to(torch.float32)

            x = icp_ops.solve_system(A, b)
            result_rt = apply_increment(result_rt, x)
            if use_sparse:
                # ADMM dual update with the post-solve pose
                # (RGBDOdometry.cpp:1209-1224 -> updateLambdaMapKernel)
                cur2 = current_pose(prev_T, result_rt)
                R2, t2 = On(cur2[:3, :3]), On(cur2[:3, 3])
                extra = tuple(icp_ops.sparse_icp_lambda_update(
                    extra[k], outs[k][1], R2(dev), t2(dev), prev_R_inv(dev), prev_t_on(dev),
                    s["next_vmap"], cfg.sparse_icp_mu)
                    for k, (dev, s) in enumerate(zip(devs, lv.shards)))
            return (result_rt, A, b, st, extra), norm(x)

        # sparse ICP's lambda map is zeroed at each level (RGBDOdometry.cpp:965-978)
        chans = 3 if use_sparse else 9 if reassoc > 1 else 0
        extra0 = (tuple(torch.zeros(((b - a) * w, chans), dtype=torch.float32, device=dev)
                        for (a, b), dev in zip(mine, devs)) if chans else None)
        carry = carry[:4] + (extra0,)
        live[lvl] = 0
        # the finest level's fast iterations: the top-k most salient pixels and/or
        # the patch-anchored association; then full-resolution polish
        # iterations.  Neither runs with fixed correspondences or the
        # subsampled pixel set
        fast = lvl == 0 and use_joint and reassoc == 1 and cfg.tracking_subsample == 1
        drive_patch = fast and cfg.tracking_rgb_nearest and cfg.tracking_patch_assoc
        drive_topk = fast and cfg.tracking_topk > 0
        if drive_patch or drive_topk:
            ptables = None
            if drive_patch:
                # camera-frame model normals: the world-frame pyramid rotated
                # back (nmap_g = nmap_c @ prev_R.T); the table of each
                # pixel's (2R+1)^2 window built from the whole base image
                prev_RT = On(prev_R.T)
                ptables = _per_device(mesh.all_gather([icp_ops.pack_patch_base(
                    s["last_depth"], icp_ops.mat3_apply(s["last_nmap"], prev_RT(dev)),
                    s["icp_weight"], s["last_int"]).reshape(-1, 6)
                    for dev, s in zip(devs, lv.shards)]), lambda t: icp_ops.build_patch_table(
                        t.reshape(lv.height, w, 6), cfg.tracking_patch_radius))

            def anchor(rt, pix):
                cur = current_pose(prev_T, rt)
                R_c, t_c = On(cur[:3, :3]), On(cur[:3, 3])
                return [icp_ops.patch_anchor(R_c(dev), t_c(dev), prev_R_inv(dev), prev_t_on(dev),
                                             p.vcurr, ptables[k], li)
                        for k, (dev, p) in enumerate(zip(devs, pix))]

            sub_sel, scale, n_full, n_sel = None, 1.0, 0, iters[0]
            if drive_topk:
                sal = [(s["sal_k1"], s["sal_k2"]) if "sal_k1" in s else (None, None)
                       for s in lv.shards]
                sums = mesh.psum([icp_ops.saliency_sums(p, *c) for p, c in zip(full, sal)])[0]
                sums = On(torch.stack(sums))
                sub_sel = [icp_ops.select_pixels(p, icp_ops.saliency_select(
                    cfg.tracking_topk, list(sums(dev)), p, a, lv.height, w, *c))
                    for dev, p, c, (a, _) in zip(devs, full, sal, mine)]
                scale = (lv.height * w
                         / icp_ops.saliency_count(cfg.tracking_topk, lv.height, w)) ** 0.5
                n_full = min(cfg.tracking_topk_full_iters, iters[0])
                n_sel = iters[0] - n_full
            if n_sel:
                patch1 = anchor(carry[0], sub_sel or full) if drive_patch else None
                carry, k = _gn_loop(functools.partial(body, sub=sub_sel, patch=patch1,
                                                      sv_scale=scale), n_sel, carry, eps)
                live[lvl] += k
            if n_full:
                # polish at full resolution, the patch re-anchored at the
                # current estimate
                patch2 = anchor(carry[0], full) if drive_patch else None
                carry, k = _gn_loop(functools.partial(body, patch=patch2), n_full, carry, eps)
                live[lvl] += k
            continue

        # finest-level pixel subsampling: the first iterations on a
        # stride-decimated live pixel set (the image's own grid), the last
        # tracking_subsample_full_iters at full resolution
        n_sub = 0
        if lvl == 0 and use_joint and reassoc == 1 and cfg.tracking_subsample > 1:
            n_sub = max(0, iters[0] - min(cfg.tracking_subsample_full_iters, iters[0]))
        if n_sub:
            sub = [icp_ops.select_pixels(p, icp_ops.subsample_ids(
                cfg.tracking_subsample, a, b - a, w, dev)) for dev, p, (a, b) in zip(devs, full,
                                                                                    mine)]
            carry, k = _gn_loop(functools.partial(body, sub=sub), n_sub, carry, eps)
            live[lvl] += k
        carry, k = _gn_loop(body, iters[lvl] - n_sub, carry, eps)
        live[lvl] += k

    return track_result(carry, prev_R, prev_t, live, cfg)


def track_result(carry, prev_R: torch.Tensor, prev_t: torch.Tensor, live: dict,
                 cfg: SLAMConfig) -> TrackResult:
    """The tracked pose from the Gauss-Newton carry (result_rt, A, b,
    stats, _), behind the divergence guard; ``live`` the iterations that
    changed it per level."""
    dev = prev_R.device
    result_rt, lastA, lastb, stats, _ = carry
    cur = current_pose(lie.rt_to_mat(prev_R, prev_t), result_rt)
    R_new = lie.orthonormalise(cur[:3, :3])
    t_new = cur[:3, 3]
    # divergence guard (RGBDOdometry.cpp:1232-1236)
    too_far = norm(t_new - prev_t) > cfg.tracking_divergence_limit
    live_iters = torch.stack([
        live[lvl] if isinstance(live[lvl], torch.Tensor)
        else torch.full((), live[lvl], dtype=torch.int32, device=dev)
        for lvl in range(cfg.num_pyramid_levels)])
    return TrackResult(
        R=torch.where(too_far, prev_R, R_new), t=torch.where(too_far, prev_t, t_new),
        icp_error=stats["icp_e"], icp_count=stats["icp_c"],
        rgb_error=stats["rgb_e"], rgb_count=stats["rgb_c"], A=lastA, b=lastb,
        live_iters=live_iters)
