"""Global surfel map on torch tensors (port of
``hrbffusion3d_tpu/map/surfel_map.py``): the per-frame half (init, render,
fuse, clean) and the keyframe-boundary half (the active-window <-> archive
exchange, the per-submap corrections, the activity-channel refresh).

Packed (N, 24) f32 surfel rows, same channel map as the JAX package:
  0:3   pos (world)      3     conf
  4:7   color            7     submap (float-encoded int)
  8     init_time        9     stamp
  10:13 normal           13    radius
  14:17 curv_dir1        17    k1
  18:21 curv_dir2        21    k2
  22    valid (0/1)      23    act (0/1 submap-activity flag)

Determinism: the many-to-one writes (the index-map z-buffer and fuse's
winner table) are scatter-mins (``scatter_reduce_(..., "amin")``), which
give the same answer in any order.  Every other write goes to unique
indices.  Functions return new tensors and never modify their inputs.

The live ``count`` stays on the device as a 0-d int32 tensor; appends write
at device-computed row indices, so no per-frame host read is needed.  The
frame counter ``time`` is a host int, so the periodic clean variants are
Python branches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..core import camera, lie
from ..ops.patches import extract_patches
from ..ops.preprocess import CurvatureResult, VertexNormalRadius
from ..utils.tensors import const, norm, sqrt

CURV_SENTINEL = 1000.0
N_CHANNELS = 24
_INT_MAX = torch.iinfo(torch.int32).max

POS = slice(0, 3)
CONF = 3
COLOR = slice(4, 7)
SUBMAP = 7
INIT_TIME = 8
STAMP = 9
NORMAL = slice(10, 13)
RADIUS = 13
CURV_DIR1 = slice(14, 17)
K1 = 17
CURV_DIR2 = slice(18, 21)
K2 = 21
VALID = 22
ACT = 23


class SurfelMap(NamedTuple):
    data: torch.Tensor    # (N, 24) packed surfels
    count: torch.Tensor   # () int32 number of live surfels (prefix)

    @property
    def pos(self):
        return self.data[:, POS]

    @property
    def conf(self):
        return self.data[:, CONF]

    @property
    def normal(self):
        return self.data[:, NORMAL]

    @property
    def radius(self):
        return self.data[:, RADIUS]

    @property
    def valid(self):
        return self.data[:, VALID] > 0.5

    @property
    def active(self):
        """valid & submap-active (the cached activity flag)."""
        return (self.data[:, VALID] > 0.5) & (self.data[:, ACT] > 0.5)


def _empty_rows(n: int, device) -> torch.Tensor:
    rows = torch.zeros((n, N_CHANNELS), dtype=torch.float32, device=device)
    rows[:, K1] = CURV_SENTINEL
    rows[:, K2] = CURV_SENTINEL
    return rows


def empty_map(capacity: int, device) -> SurfelMap:
    return SurfelMap(data=_empty_rows(capacity, device),
                     count=torch.zeros((), dtype=torch.int32, device=device))


class FrameMeasurement(NamedTuple):
    """Per-pixel camera-frame measurement set, all (H, W, ...)."""

    vertex: torch.Tensor     # (H,W,3) raw-depth vertex
    vertex_f: torch.Tensor   # (H,W,3) filtered vertex
    normal: torch.Tensor     # (H,W,3)
    radius: torch.Tensor     # (H,W)
    color: torch.Tensor      # (H,W,3)
    conf: torch.Tensor       # (H,W)
    k1: torch.Tensor         # (H,W)
    k2: torch.Tensor         # (H,W)
    curv_dir1: torch.Tensor  # (H,W,3)
    curv_dir2: torch.Tensor  # (H,W,3)


def measurement_from_preprocess(pre: VertexNormalRadius, curv: CurvatureResult,
                                color: torch.Tensor, conf: torch.Tensor) -> FrameMeasurement:
    return FrameMeasurement(
        vertex=pre.vertex_raw, vertex_f=pre.vertex_filtered, normal=pre.normal,
        radius=pre.radius, color=color, conf=conf,
        k1=curv.k1, k2=curv.k2, curv_dir1=curv.dir1, curv_dir2=curv.dir2,
    )


def _measurement_valid(m: FrameMeasurement, cfg: SLAMConfig) -> torch.Tensor:
    """Validity gate shared by initialise and fuse (data.vert:113-119)."""
    t = cfg.curv_valid_threshold
    return ((norm(m.normal, dim=-1) > 0.8)
            & (m.vertex[..., 2] > cfg.depth_min)
            & (m.vertex[..., 2] <= cfg.depth_cutoff)
            & (m.k1 > -t) & (m.k1 < t) & (m.k2 > -t) & (m.k2 < t))


def _pack_frame(m: FrameMeasurement, pose: torch.Tensor, submap_idx: int, time: int,
                act=1.0) -> torch.Tensor:
    """Flatten a measurement into packed (P, 24) world-frame surfel rows."""
    P = m.radius.numel()
    R = pose[:3, :3]
    t = pose[:3, 3]
    rows = torch.zeros((P, N_CHANNELS), dtype=torch.float32, device=pose.device)
    rows[:, POS] = m.vertex.reshape(P, 3) @ R.T + t
    rows[:, CONF] = m.conf.reshape(P)
    rows[:, COLOR] = m.color.reshape(P, 3)
    rows[:, SUBMAP] = float(submap_idx)
    rows[:, INIT_TIME] = float(time)
    rows[:, STAMP] = float(time)
    rows[:, NORMAL] = m.normal.reshape(P, 3) @ R.T
    rows[:, RADIUS] = m.radius.reshape(P)
    rows[:, CURV_DIR1] = m.curv_dir1.reshape(P, 3) @ R.T
    rows[:, K1] = m.k1.reshape(P)
    rows[:, CURV_DIR2] = m.curv_dir2.reshape(P, 3) @ R.T
    rows[:, K2] = m.k2.reshape(P)
    rows[:, VALID] = 1.0
    rows[:, ACT] = act
    return rows


def _append(m: SurfelMap, rows: torch.Tensor, new_mask: torch.Tensor,
            block_size: int | None = None) -> SurfelMap:
    """Append up to sum(new_mask) rows after m.count: the selected rows are
    compacted to a prefix by a stable argsort and written as one block of
    ``block_size`` rows at start = clip(count, 0, capacity - block)."""
    capacity = m.data.shape[0]
    P = rows.shape[0]
    S = min(block_size or P, P, capacity)
    dev = m.data.device
    perm = torch.argsort((~new_mask).to(torch.uint8), stable=True)
    sorted_rows = rows[perm[:S]]
    n_new = torch.clamp(new_mask.sum(dtype=torch.int32), max=S)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    block = torch.where((slot < n_new)[:, None], sorted_rows, _empty_rows(1, dev))
    start = torch.clamp(m.count, 0, capacity - S)
    data = m.data.index_copy(0, (start + slot).long(), block)
    return SurfelMap(data=data, count=torch.clamp(start + n_new, max=capacity))


def grow(m: SurfelMap, new_capacity: int) -> SurfelMap:
    """The same map backed by a larger array (pristine rows appended)."""
    n = m.data.shape[0]
    if new_capacity <= n:
        return m
    pad = _empty_rows(new_capacity - n, m.data.device)
    return SurfelMap(data=torch.cat([m.data, pad], dim=0), count=m.count)


def initialise(capacity: int, m: FrameMeasurement, pose: torch.Tensor,
               cfg: SLAMConfig, time: int = 1, submap_idx: int = 0) -> SurfelMap:
    """First-frame map init: every valid pixel becomes a surfel."""
    sm = empty_map(capacity, pose.device)
    ok = _measurement_valid(m, cfg).reshape(-1)
    return _append(sm, _pack_frame(m, pose, submap_idx, time), ok)


def _to_camera(pos_w: torch.Tensor, pose_inv: torch.Tensor) -> torch.Tensor:
    return pos_w @ pose_inv[:3, :3].T + pose_inv[:3, 3]


def render_index(m: SurfelMap, pose_inv: torch.Tensor, intr: CameraIntrinsics,
                 active: torch.Tensor | None = None,
                 conf_threshold: float | None = None) -> torch.Tensor:
    """Z-buffered point render into an (H, W) int32 surfel-index grid
    (-1 = empty).  Up to 2**20 rows: one scatter-min of the packed key
    (11-bit quantised z in the high bits, 20-bit surfel id in the low
    bits).  Above: the exact float z-buffer, a scatter-min of z, then one
    of the ids of the rows at their pixel's minimum."""
    n = m.data.shape[0]
    z, ok, pix = render_targets(m.data, pose_inv, intr, active, conf_threshold)
    ids = torch.arange(n, dtype=torch.int32, device=m.data.device)
    if n <= KEY_ROWS:
        return decode_index(render_keys(z, ok, pix, ids, intr), intr, keyed=True)
    zbuf = render_zbuf(z, ok, pix, intr)
    return decode_index(render_winners(z, ok, pix, ids, zbuf, intr), intr, keyed=False)


# maps up to this many rows render with one packed-key scatter-min
KEY_ROWS = 1 << 20
_ZBIG = 1e30


def render_targets(data: torch.Tensor, pose_inv: torch.Tensor, intr: CameraIntrinsics,
                   active: torch.Tensor | None = None, conf_threshold: float | None = None):
    """(camera z, rendered, flat target pixel: H*W for none) of map rows."""
    h, w = intr.height, intr.width
    local = _to_camera(data[:, POS], pose_inv)
    z = local[:, 2]
    zs = torch.where(z != 0, z, 1e12)
    u = torch.round(local[:, 0] * intr.fx / zs + intr.cx).to(torch.int32)
    v = torch.round(local[:, 1] * intr.fy / zs + intr.cy).to(torch.int32)
    ok = (data[:, VALID] > 0.5) & (z > 0) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    if active is not None:
        ok &= active
    if conf_threshold is not None:
        ok &= data[:, CONF] >= conf_threshold
    pix = torch.where(ok, v * w + u, h * w).long()   # overflow bucket
    return z, ok, pix


def render_keys(z, ok, pix, ids, intr: CameraIntrinsics) -> torch.Tensor:
    """(H*W+1,) scatter-min of the packed key (11-bit quantised z high, the
    20-bit surfel id ``ids`` low) per target pixel."""
    zq = torch.clamp(z * (2047.0 / 3.5), 0, 2047).to(torch.int32)
    key = torch.where(ok, (zq << 20) | ids, _INT_MAX)
    buf = torch.full((intr.height * intr.width + 1,), _INT_MAX, dtype=torch.int32,
                     device=z.device)
    return buf.scatter_reduce_(0, pix, key, "amin", include_self=True)


def render_zbuf(z, ok, pix, intr: CameraIntrinsics) -> torch.Tensor:
    """(H*W+1,) float z-buffer: the scatter-min of z per target pixel."""
    zbuf = torch.full((intr.height * intr.width + 1,), _ZBIG, dtype=torch.float32,
                      device=z.device)
    return zbuf.scatter_reduce_(0, pix, torch.where(ok, z, _ZBIG), "amin", include_self=True)


def render_winners(z, ok, pix, ids, zbuf, intr: CameraIntrinsics) -> torch.Tensor:
    """(H*W+1,) scatter-min of the ids of the rows at their pixel's
    z-buffer minimum."""
    is_winner = ok & (z <= zbuf[pix])
    idxbuf = torch.full((intr.height * intr.width + 1,), _INT_MAX, dtype=torch.int32,
                        device=z.device)
    return idxbuf.scatter_reduce_(0, pix, torch.where(is_winner, ids, _INT_MAX), "amin",
                                  include_self=True)


def decode_index(buf: torch.Tensor, intr: CameraIntrinsics, keyed: bool) -> torch.Tensor:
    """The (H, W) int32 index map (-1 = empty) from a scatter-min buffer."""
    h, w = intr.height, intr.width
    out = buf[:h * w]
    ids = out & ((1 << 20) - 1) if keyed else out
    return torch.where(out == _INT_MAX, -1, ids).reshape(h, w)


# rendered attribute image channels (render_attr_image)
A_POS = slice(0, 3)      # camera-frame position
A_NRM = slice(3, 6)      # camera-frame normal
A_CONF = 6
A_RADIUS = 7
A_INIT = 8
A_STAMP = 9
A_ACTIVE = 10
A_VALID = 11
ATTR_CHANNELS = 12
# extended channels: raw map attributes the prediction epilogue reads
A_EXT_COLOR = slice(12, 15)
A_EXT_K1 = 15
A_EXT_K2 = 16
A_EXT_D1 = slice(17, 20)  # world-frame principal directions (raw)
A_EXT_D2 = slice(20, 23)
ATTR_EXT_CHANNELS = 23


def render_attr_image(m: SurfelMap, index_map: torch.Tensor, pose_inv: torch.Tensor,
                      extended: bool = False) -> torch.Tensor:
    """(H, W, 12|23) camera-frame attributes of the rendered surfel per
    pixel, from one row gather of the map."""
    flat = index_map.reshape(-1)
    rows = m.data[torch.clamp(flat, 0, m.data.shape[0] - 1).long()]
    return attr_from_rows(rows, flat >= 0, pose_inv, index_map.shape, extended)


def attr_from_rows(rows: torch.Tensor, has: torch.Tensor, pose_inv: torch.Tensor,
                   shape, extended: bool = False) -> torch.Tensor:
    """``render_attr_image`` from the (P, 24) map rows of the pixels'
    surfels (``has``: the pixel has one) of an image of ``shape``."""
    h, w = shape
    chans = [
        _to_camera(rows[:, POS], pose_inv), rows[:, NORMAL] @ pose_inv[:3, :3].T,
        rows[:, CONF, None], rows[:, RADIUS, None],
        rows[:, INIT_TIME, None], rows[:, STAMP, None],
        rows[:, ACT, None], has[:, None].to(torch.float32),
    ]
    if extended:
        chans += [rows[:, COLOR], rows[:, K1, None], rows[:, K2, None],
                  rows[:, CURV_DIR1], rows[:, CURV_DIR2]]
    img = torch.where(has[:, None], torch.cat(chans, dim=-1), 0.0)
    return img.reshape(h, w, ATTR_EXT_CHANNELS if extended else ATTR_CHANNELS)


def fuse(m: SurfelMap, meas: FrameMeasurement, pose: torch.Tensor,
         index_map: torch.Tensor, intr: CameraIntrinsics, cfg: SLAMConfig,
         time: int, submap_idx: int, act=1.0):
    """ElasticFusion-style fusion (data.vert + update.vert).

    (a) each pixel of the time-staggered checkerboard quarter searches the
        3x3 window of the index map for a surfel with ray-depth and normal
        agreement, best by point-to-ray distance;
    (b) the surfel's winning pixel (min pixel id) merges by confidence-
        weighted running average guarded by newRadius < 1.5x old;
    (c) unmatched valid pixels append as new surfels, and the index map is
        updated in place at their pixels.
    Returns (map, updated index map)."""
    h, w = intr.height, intr.width
    hq, wq = h // 2, w // 2
    P = hq * wq
    n_cap = m.data.shape[0]
    dev = m.data.device
    par = int(time) % 2

    attr = render_attr_image(m, index_map, lie.se3_inverse(pose))

    def quarter(img):
        return img[par:par + 2 * hq:2, par:par + 2 * wq:2]

    meas_q = FrameMeasurement(*(quarter(x) for x in meas))
    patch = quarter(extract_patches(fuse_attr7(attr), 1)).reshape(P, 9, 7)
    cand = quarter(extract_patches(index_map, 1, fill=-1)).reshape(P, 9)
    yyq, xxq = camera.pixel_grid(hq, wq, dev)
    ok_pix, best_id, new_rows = fuse_pixels(meas_q, patch, cand, 2.0 * xxq + par,
                                            2.0 * yyq + par, pose, intr, cfg, time,
                                            submap_idx, act)
    matched = ok_pix & (best_id >= 0)

    # one winning pixel per surfel: min pixel id (integer scatter-min)
    pixel_ids = torch.arange(P, dtype=torch.int32, device=dev)
    wtbl = winner_table(torch.where(matched, best_id, n_cap), matched, pixel_ids, n_cap)
    # merge, surfel-side: each surfel with a winner gathers its row
    has_winner = wtbl != _INT_MAX
    meas_rows = new_rows[torch.clamp(wtbl, 0, P - 1).long()]
    m = SurfelMap(data=merge_rows(m.data, meas_rows, has_winner), count=m.count)

    # new surfels: block append + in-place index-map update at their pixels
    new_mask = ok_pix & (best_id < 0)
    S = min(cfg.new_surfels_capacity, P, n_cap)
    start = torch.clamp(m.count, 0, n_cap - S)
    rank = torch.cumsum(new_mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    new_id = start + rank
    appended = new_mask & (rank < S)
    m = _append(m, new_rows, new_mask, block_size=S)

    upd = fuse_index_update(appended, new_id, cand, meas_q, patch).reshape(hq, wq)
    idx_updated = index_map.clone()
    idx_updated[par:par + 2 * hq:2, par:par + 2 * wq:2] = upd
    return m, idx_updated


def fuse_attr7(attr: torch.Tensor) -> torch.Tensor:
    """The (H, W, 7) [pos | nrm | valid] channels of an attr image that
    fuse's association window reads."""
    return torch.cat([attr[..., 0:6], attr[..., A_VALID:A_VALID + 1]], dim=-1)


def fuse_pixels(meas_q: FrameMeasurement, patch: torch.Tensor, cand: torch.Tensor,
                gx: torch.Tensor, gy: torch.Tensor, pose: torch.Tensor,
                intr: CameraIntrinsics, cfg: SLAMConfig, time: int, submap_idx: int,
                act=1.0):
    """fuse's per-pixel half, over P checkerboard pixels: ``meas_q`` their
    measurements, ``patch`` (P, 9, 7) / ``cand`` (P, 9) the 3x3 window of
    the attr image and the index map, (``gx``, ``gy``) their image
    coordinates.  Returns (valid measurement, the best candidate surfel
    or -1, the (P, 24) rows of the measurements as new surfels)."""
    P = cand.shape[0]
    ok_pix = _measurement_valid(meas_q, cfg).reshape(P)
    v_local = meas_q.vertex.reshape(P, 3)
    n_local = meas_q.normal.reshape(P, 3)
    new_rows = _pack_frame(meas_q, pose, submap_idx, time, act)     # (P, 24)

    xl = (gx.reshape(P) - intr.cx) / intr.fx
    yl = (gy.reshape(P) - intr.cy) / intr.fy
    lam = sqrt(xl * xl + yl * yl + 1.0)
    ray = torch.stack([xl, yl, torch.ones_like(xl)], dim=-1)
    ray_len = norm(ray, dim=-1)

    has = (cand >= 0) & (patch[..., 6] > 0.5)
    cpos = patch[..., 0:3]
    cnrm = patch[..., 3:6]
    depth_ok = torch.abs(cpos[..., 2] * lam[:, None]
                         - (v_local[:, 2] * lam)[:, None]) < cfg.depth_consistency
    dist = norm(
        torch.linalg.cross(ray[:, None, :].expand(cpos.shape), cpos, dim=-1),
        dim=-1) / ray_len[:, None]
    cosang = torch.sum(cnrm * n_local[:, None, :], dim=-1)
    ang_ok = (torch.abs(cnrm[..., 2]) < 0.75) | (
        torch.abs(torch.arccos(torch.clamp(cosang, -1.0, 1.0))) < cfg.fuse_angle_limit)
    good = has & depth_ok & ang_ok
    dist = torch.where(good, dist, 1e3)
    best_tap = torch.argmin(dist, dim=1, keepdim=True)
    best_ok = torch.gather(good, 1, best_tap)[:, 0]
    best_id = torch.where(best_ok, torch.gather(cand, 1, best_tap)[:, 0], -1)
    return ok_pix, best_id, new_rows


def winner_table(target: torch.Tensor, matched: torch.Tensor, pixel_ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """(n,) least matched pixel id per surfel row (``target``: its row, n
    for none); INT_MAX where no pixel matched."""
    winner = torch.full((n + 1,), _INT_MAX, dtype=torch.int32, device=target.device)
    winner.scatter_reduce_(0, target.long(), torch.where(matched, pixel_ids, _INT_MAX),
                           "amin", include_self=True)
    return winner[:n]


def merge_rows(old: torch.Tensor, meas_rows: torch.Tensor,
               has_winner: torch.Tensor) -> torch.Tensor:
    """fuse's merge: each row with a winning pixel takes the confidence-
    weighted running average with its measurement row, guarded by
    newRadius < 1.5x old."""
    c_k = old[:, CONF]
    a = meas_rows[:, CONF]
    denom = torch.clamp(c_k + a, min=1e-12)
    r_ok = meas_rows[:, RADIUS] < 1.5 * old[:, RADIUS]
    blended = (c_k[:, None] * old + a[:, None] * meas_rows) / denom[:, None]
    nrm = blended[:, NORMAL]
    blended[:, NORMAL] = nrm / torch.clamp(
        norm(nrm, dim=-1, keepdim=True), min=1e-12)
    merged = torch.where(r_ok[:, None], blended, old)
    merged[:, CONF] = c_k + a
    merged[:, SUBMAP] = old[:, SUBMAP]
    merged[:, INIT_TIME] = old[:, INIT_TIME]
    merged[:, STAMP] = meas_rows[:, STAMP]
    merged[:, VALID] = 1.0
    merged[:, ACT] = old[:, ACT]
    return torch.where(has_winner[:, None], merged, old)


def fuse_index_update(appended, new_id, cand, meas_q: FrameMeasurement, patch):
    """The index map's new value at the checkerboard pixels: an appended
    surfel wins its pixel's z-test against the existing render (the
    centre tap is this pixel)."""
    idx_q = cand[:, 4]
    v_z = meas_q.vertex.reshape(-1, 3)[:, 2]
    wins = appended & ((idx_q < 0) | (v_z < patch[:, 4, 2]))
    return torch.where(wins, new_id, idx_q)


def clean_mask(m: SurfelMap, pose: torch.Tensor, index_map: torch.Tensor,
               intr: CameraIntrinsics, cfg: SLAMConfig, time: int,
               attr: torch.Tensor | None = None) -> torch.Tensor:
    """Survival mask of the cleaning pass (copy_unstable.vert:62-166):
    curvature-invalid, crowded (> 8 older stable overlapping surfels just
    behind) or free-space-violating (> 4), and unstable-timeout surfels die.
    The crowd/free-space rules run only every ``clean_crowd_period``-th
    frame."""
    crowd = int(time) % max(cfg.clean_crowd_period, 1) == 0
    if crowd and attr is None:
        attr = render_attr_image(m, index_map, lie.se3_inverse(pose))
    patches = crowd_patches(attr) if crowd else None
    return clean_mask_rows(m.data, pose, patches, intr, cfg, time)


def crowd_patches(attr: torch.Tensor) -> torch.Tensor:
    """(H*W, 72): the 3x3 window of [pos | conf | init, stamp, active,
    valid] of an attr image per pixel, which the crowd rules read."""
    h, w = attr.shape[:2]
    # A_INIT..A_VALID are adjacent
    attr8 = torch.cat([attr[..., 0:3], attr[..., A_CONF:A_CONF + 1],
                       attr[..., A_INIT:A_VALID + 1]], dim=-1)
    return extract_patches(attr8, 1).reshape(h * w, 9 * 8)


def clean_mask_rows(data: torch.Tensor, pose: torch.Tensor, patches: torch.Tensor | None,
                    intr: CameraIntrinsics, cfg: SLAMConfig, time: int) -> torch.Tensor:
    """``clean_mask`` of map rows; ``patches``: the whole image's
    ``crowd_patches`` on a crowd-rule frame, else None."""
    n = data.shape[0]
    h, w = intr.height, intr.width
    pose_inv = lie.se3_inverse(pose)
    local = _to_camera(data[:, POS], pose_inv)
    lz = local[:, 2]
    safe_z = torch.where(lz != 0, lz, 1e12)
    x = local[:, 0] * intr.fx / safe_z + intr.cx
    y = local[:, 1] * intr.fy / safe_z + intr.cy
    in_view = (lz > 0) & (lz < cfg.depth_cutoff) & (x > 0) & (y > 0) & (x < w) & (y < h)
    local_nz = (data[:, NORMAL] @ pose_inv[:3, :3].T)[:, 2]
    xi = torch.clamp(torch.round(x).to(torch.int32), 0, w - 1)
    yi = torch.clamp(torch.round(y).to(torch.int32), 0, h - 1)
    radius = data[:, RADIUS]

    if patches is not None:
        rows9 = patches[(yi * w + xi).long()].reshape(n, 9, 8)
        wgt = const([1, 2, 1, 2, 4, 2, 1, 2, 1], data.device, torch.int32)
        has = in_view[:, None] & (rows9[..., 7] > 0.5)
        cpos_z = rows9[..., 2]
        stable = rows9[..., 3] > cfg.confidence_threshold
        behind = cpos_z > lz[:, None]
        overlap = norm(rows9[..., 0:2] - local[:, None, :2], dim=-1) < \
            (radius * 1.4)[:, None]
        red = (has & (rows9[..., 4] < data[:, INIT_TIME][:, None]) & stable
               & behind & (cpos_z - lz[:, None] < 0.01) & overlap)
        count = torch.sum(torch.where(red, wgt, 0), dim=1)
        fs = (has & (rows9[..., 5] == float(time)) & stable & behind
              & (cpos_z - lz[:, None] > 0.01)
              & (torch.abs(local_nz) > 0.85)[:, None] & (rows9[..., 6] > 0.5))
        zcount = torch.sum(torch.where(fs, wgt, 0), dim=1)
        crowd_kill = (count > cfg.clean_overlap_limit) | (zcount > cfg.clean_freespace_limit)
    else:
        crowd_kill = torch.zeros((n,), dtype=torch.bool, device=data.device)

    t = cfg.curv_valid_threshold
    k1 = data[:, K1]
    k2 = data[:, K2]
    curv_bad = (k1 < -t) | (k1 > t) | (k2 < -t) | (k2 > t)
    unstable_kill = (((time - data[:, STAMP]) > cfg.unstable_time_limit)
                     & (data[:, CONF] < cfg.confidence_threshold))
    return (data[:, VALID] > 0.5) & ~curv_bad & ~crowd_kill & ~unstable_kill


def compact(m: SurfelMap, keep: torch.Tensor) -> SurfelMap:
    """Stream-compact survivors to a prefix (stable argsort + row gather)."""
    n = m.data.shape[0]
    new_count = keep.sum(dtype=torch.int32)
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)
    data = m.data[perm]
    data[:, VALID] = (torch.arange(n, device=data.device) < new_count).to(torch.float32)
    return SurfelMap(data=data, count=new_count)


def clean(m: SurfelMap, pose: torch.Tensor, index_map: torch.Tensor,
          intr: CameraIntrinsics, cfg: SLAMConfig, time: int) -> SurfelMap:
    """The cleaning pass and stream compaction (clean_mask, compact)."""
    return compact(m, clean_mask(m, pose, index_map, intr, cfg, time))


def clean_with_remap(m: SurfelMap, pose: torch.Tensor, index_map: torch.Tensor,
                     intr: CameraIntrinsics, cfg: SLAMConfig, time: int,
                     attr: torch.Tensor | None = None):
    """clean + the (old index -> new index, -1 if killed) remap.  With
    ``clean_compact_period > 1`` killed surfels are tombstoned in place and
    the compaction runs only every N-th frame."""
    keep = clean_mask(m, pose, index_map, intr, cfg, time, attr=attr)
    n = m.data.shape[0]
    period = max(cfg.clean_compact_period, 1)
    if int(time) % period == 0:
        rank = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32) - 1
        return compact(m, keep), torch.where(keep, rank, -1)
    data = m.data.clone()
    data[:, VALID] = torch.where(keep, m.data[:, VALID], 0.0)
    remap = torch.where(keep, torch.arange(n, dtype=torch.int32, device=data.device), -1)
    return SurfelMap(data=data, count=m.count), remap


def remap_index_map(index_map: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Translate a pre-compaction index map through a clean remap."""
    safe = torch.clamp(index_map, 0, remap.shape[0] - 1).long()
    return torch.where(index_map >= 0, remap[safe], -1)


def pixel_keep_mask(attr_ext: torch.Tensor, cfg: SLAMConfig, time: int) -> torch.Tensor:
    """(H, W) clean keep flag in pixel space from the extended attr image:
    on tombstone frames only the curvature and unstable-timeout rules run,
    and both read only the pixel's own surfel attributes."""
    t = cfg.curv_valid_threshold
    k1 = attr_ext[..., A_EXT_K1]
    k2 = attr_ext[..., A_EXT_K2]
    curv_bad = (k1 < -t) | (k1 > t) | (k2 < -t) | (k2 > t)
    unstable = (((float(time) - attr_ext[..., A_STAMP]) > cfg.unstable_time_limit)
                & (attr_ext[..., A_CONF] < cfg.confidence_threshold))
    return (attr_ext[..., A_VALID] > 0.5) & ~curv_bad & ~unstable


# --------------------------------------------------------------------------- #
# keyframe boundary: active window <-> archive, corrections, activity channel
# --------------------------------------------------------------------------- #

def _submap_of(data: torch.Tensor, n_submaps: int) -> torch.Tensor:
    """Each row's submap index, clipped into the mask's range."""
    return torch.clamp(data[:, SUBMAP].to(torch.int64), 0, n_submaps - 1)


def _stable_prefix(mask: torch.Tensor) -> torch.Tensor:
    """Permutation moving the rows where ``mask`` holds to the front, each
    side in its original order (a stable argsort of ~mask)."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def _place(buf: torch.Tensor, start: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``block`` written at the device-side row ``start``."""
    rows = start.to(torch.int64) + torch.arange(block.shape[0], device=buf.device)
    return buf.index_copy(0, rows, block)


def exchange_active(act: SurfelMap, arch: SurfelMap, submap_active: torch.Tensor,
                    time: int, cfg: SLAMConfig):
    """Active-window <-> archive surfel exchange at a keyframe boundary.

    Rows of the active map whose submap left the covisible set move to the
    archive, archived rows whose submap re-entered it move back; the
    curvature and timeout kill rules (copy_unstable.vert:143-164) apply to
    both at exchange time.  Both maps are rebuilt by stable argsort +
    gather compactions: new active = [stay | enter], new archive =
    [keep | leave].  Enter rows that do not fit the active map and rows
    past the archive's capacity are dropped and counted, as in the JAX
    package.

    Returns (active', archive', stats) with stats = int32 [n_active,
    n_archive, n_dropped] on the device, read once by the host."""
    Ca, nch = act.data.shape
    Cr = arch.data.shape[0]
    ns = submap_active.shape[0]
    dev = act.data.device
    t = cfg.curv_valid_threshold

    def junk(rows):
        k1, k2 = rows[:, K1], rows[:, K2]
        curv_bad = (k1 < -t) | (k1 > t) | (k2 < -t) | (k2 > t)
        unstable = (((float(time) - rows[:, STAMP]) > cfg.unstable_time_limit)
                    & (rows[:, CONF] < cfg.confidence_threshold))
        return curv_bad | unstable

    va = act.data[:, VALID] > 0
    on_a = va & submap_active[_submap_of(act.data, ns)]
    leave = va & ~on_a & ~junk(act.data)
    vr = arch.data[:, VALID] > 0
    enter = vr & submap_active[_submap_of(arch.data, ns)] & ~junk(arch.data)
    keep_r = vr & ~enter

    # new active = [stay-compacted | enter-compacted]
    stay = act.data[_stable_prefix(on_a)]
    n_stay = on_a.sum(dtype=torch.int32)
    enter_blk = arch.data[_stable_prefix(enter)[:Ca]]
    n_enter_all = enter.sum(dtype=torch.int32)
    n_enter = torch.minimum(torch.clamp(n_enter_all, max=Ca), Ca - n_stay)
    buf = torch.zeros((2 * Ca, nch), dtype=act.data.dtype, device=dev)
    buf[:Ca] = stay
    act_data = _place(buf, n_stay, enter_blk)[:Ca]
    n_act = n_stay + n_enter
    act_valid = torch.arange(Ca, dtype=torch.int32, device=dev) < n_act
    act_data[:, VALID] = act_valid.to(torch.float32)
    act_data[:, ACT] = (submap_active[_submap_of(act_data, ns)] & act_valid).to(torch.float32)

    # new archive = [keep-compacted | leave-compacted]
    keep_blk = arch.data[_stable_prefix(keep_r)]
    n_keep = keep_r.sum(dtype=torch.int32)
    leave_blk = act.data[_stable_prefix(leave)[:Ca]]
    n_leave = leave.sum(dtype=torch.int32)
    buf2 = torch.zeros((Cr + Ca, nch), dtype=arch.data.dtype, device=dev)
    buf2[:Cr] = keep_blk
    arch_data = _place(buf2, n_keep, leave_blk)[:Cr]
    n_arch = torch.clamp(n_keep + n_leave, max=Cr)
    arch_data[:, VALID] = (torch.arange(Cr, dtype=torch.int32, device=dev)
                           < n_arch).to(torch.float32)

    dropped = (n_enter_all - n_enter) + (n_keep + n_leave - n_arch)
    stats = torch.stack([n_act, n_arch, dropped]).to(torch.int32)
    return (SurfelMap(data=act_data, count=n_act.to(torch.int32)),
            SurfelMap(data=arch_data, count=n_arch.to(torch.int32)), stats)


def _apply_deltas_rows(rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """(B,24) map rows x (S,12) row-major [R|t] table -> corrected rows
    (valid rows only; the rotation as column arithmetic)."""
    d = flat[_submap_of(rows, flat.shape[0])]                 # (B, 12)
    keep = (rows[:, VALID] > 0.5)[:, None]

    def rot(v, with_t):
        out = []
        for i in range(3):
            r = d[:, 4 * i] * v[:, 0] + d[:, 4 * i + 1] * v[:, 1] + d[:, 4 * i + 2] * v[:, 2]
            out.append(r + d[:, 4 * i + 3] if with_t else r)
        return torch.stack(out, dim=-1)

    out = rows.clone()
    out[:, POS] = torch.where(keep, rot(rows[:, POS], True), rows[:, POS])
    for ch in (NORMAL, CURV_DIR1, CURV_DIR2):
        out[:, ch] = torch.where(keep, rot(rows[:, ch], False), rows[:, ch])
    return out


def apply_submap_deltas(m: SurfelMap, deltas: torch.Tensor) -> SurfelMap:
    """Post-BA dense map correction (update_delta_trans.vert:43-88): each
    valid surfel takes the rigid transform of its submap, ``deltas``
    (S, 4, 4) = pose_new @ pose_old^-1 per keyframe."""
    flat = deltas[:, :3, :].reshape(-1, 12)
    return SurfelMap(data=_apply_deltas_rows(m.data, flat), count=m.count)


def active_from_submaps(m: SurfelMap, submap_active: torch.Tensor) -> torch.Tensor:
    """Per-surfel activity mask from the active-keyframe set
    (KeyFrameIDMap, GlobalModel.cpp:586-598)."""
    return m.valid & submap_active[_submap_of(m.data, submap_active.shape[0])]


def refresh_active_channel(m: SurfelMap, submap_active: torch.Tensor) -> SurfelMap:
    """Rewrite the cached per-surfel activity flag (ACT channel) from the
    active-keyframe set; called when the covisible set changes."""
    data = m.data.clone()
    data[:, ACT] = submap_active[_submap_of(m.data, submap_active.shape[0])].to(torch.float32)
    return SurfelMap(data=data, count=m.count)
