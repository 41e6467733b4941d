"""The row-sharded dense step: ``bootstrap`` and ``step`` on a state whose
surfel map rows and image rows are split over a ``Mesh`` (the port of
what ``jax.jit(slam.step, in_shardings=state_sharding(mesh), ...)`` does
in ``tests/test_aa_sharded_step.py``, where GSPMD places the
collectives; here the decomposition is written out).

Each shard's part runs in turn, on its own device, and shards exchange
data only through the mesh's collectives (``psum``, ``pmin``,
``all_gather``, ``exclusive_scan``) and through merges by owner (a row
read by global id takes the value of the one shard that owns it):
  - preprocess: each image-row shard filters its rows plus a halo of
    ``preprocess_halo(cfg)`` rows (bilateral 6 + PCA 3 + curvature
    ``curv_window``; every row of the halo within the image, taken from
    as many neighbours as it spans), then keeps its own rows; pixel
    coordinates are the image's (``row0``);
  - tracking (the default joint nearest-pixel path: ``row_sharded_tracking``):
    each shard builds its rows of every pyramid level (a 2-row halo at
    each level for the 5x5 filters; rows split in units of
    2^(levels-1)); the model's packed rows are all-gathered per level
    (they are read at projected pixels anywhere); every Gauss-Newton
    iteration sums each shard's Gram of its own pixels with ``psum``
    (first the photometric count, which sets the robust weight, then the
    systems), and the 6x6 solve, the SO(3) pre-alignment's 3x3 solve and
    the early-exit flag run once, on the first device, from the reduced
    system; every other tracking setting all-gathers its inputs and runs
    ``odometry.track`` whole on the first device (the same kernels and
    functions, so JAX's result);
  - ``render_index``: each map shard scatter-mins its own rows by global
    id into a whole-image buffer, and ``pmin`` merges each pass (key; or
    z, then id);
  - ``fuse``: each image shard associates its checkerboard pixels (the
    candidate rows gathered by owner); the winner scatter-min and the
    merge run on the map shard that owns the target row; new surfels
    take ``count + rank`` with the rank of the pixel-order cumsum over the
    frame (``exclusive_scan`` of the per-shard counts), each map shard
    writing those that land in its rows;
  - clean: the keep mask per map row (the crowd rules read the
    all-gathered attr patches); a compaction moves every row to the map
    shard that owns its new position (``exclusive_scan`` of the kept and
    killed counts), in ``compact``'s order; the remap is a merged gather;
  - prediction: the ray cast (and its epilogue, ``fill_in``, splat
    prediction) per image shard on its rows plus a halo of
    ``predict_window_multiplier`` rows, launched with the slab's first
    image row, so the ray arithmetic is the whole image's.
Everything but the Gram sums is exact (minima, owner merges, integer
scans, per-pixel kernels on slabs with image rows), so a replay
(``fixed_pose``) equals the unsharded step bit for bit; the Gram sums are
float64, rounded to float32 once (``ops/icp._sums``), so a tracked step
does too, but for a float64 sum within its own error of a float32
rounding boundary.  A step reads nothing back to the host.  The mesh must be of one process (a mesh over a
process group raises).

The keyframe-boundary ops (``exchange_active``, ``grow``) gather the map,
run whole, and split it again; ``refresh_active_channel`` and
``apply_submap_deltas`` run per shard.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..core import camera, lie
from ..map import surfel_map as sm
from ..ops import icp as icp_ops
from ..ops import kernels, preprocess, pyramid, raycast
from ..ops.patches import extract_patches
from ..pipeline import slam
from ..tracking import odometry
from ..utils.tensors import const
from .sharding import (Mesh, ShardedRows, gather, gather_frame, is_sharded, row_unit,
                       shard_state)

_INT_MAX = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def preprocess_halo(cfg: SLAMConfig) -> int:
    """Rows of halo the preprocess chain needs: the bilateral window (6),
    the normal's (PCA 3, central differences 1), the curvature window."""
    return ((6 if cfg.use_bilateral_filter else 0) + (3 if cfg.normal_pca else 1)
            + cfg.curv_window)


def _mesh(state: slam.SLAMState) -> Mesh:
    mesh = state.map.data.mesh
    if mesh.group is not None:
        raise NotImplementedError("the sharded dense step runs on a mesh of one process; "
                                  "this mesh spans a process group")
    return mesh


class _On:
    """A replicated value's copy on each device (made once)."""

    def __init__(self, x):
        self.x = x
        self.copies = {x.device: x}

    def __call__(self, dev):
        if dev not in self.copies:
            self.copies[dev] = self.x.to(dev)
        return self.copies[dev]


def _slab(x: ShardedRows, dev, lo: int, hi: int):
    """(rows [lo, hi) of the image ``x`` clipped to it, on ``dev``; the
    first row's image row), taken from every shard they span."""
    lo, hi = max(lo, 0), min(hi, x.total)
    pieces = [p[max(lo, a) - a:min(hi, b) - a].to(dev)
              for p, (a, b) in zip(x.parts, x.bounds) if a < hi and b > lo]
    return (pieces[0] if len(pieces) == 1 else torch.cat(pieces)), lo


def _rows(t, i0: int, i1: int):
    """Rows [i0, i1) of every field of a NamedTuple of images."""
    return type(t)(*(x[i0:i1] for x in t))


def _gather_rows(table: ShardedRows, ids: torch.Tensor) -> torch.Tensor:
    """``whole_table[clamp(ids, 0, N - 1)]`` on ``ids``' device, each row
    taken from the shard that owns it (an id owned by none takes the first
    shard's row 0, as the clamp does)."""
    dev = ids.device
    out = None
    for part, (lo, hi) in zip(table.parts, table.bounds):
        local = ids.to(part.device)
        got = part[torch.clamp(local - lo, 0, hi - lo - 1).long()].to(dev)
        if out is None:
            out = got
        else:
            own = ((ids >= lo) & (ids < hi)).reshape(ids.shape + (1,) * (got.dim() - ids.dim()))
            out = torch.where(own, got, out)
    return out


def _check_bounds(bounds, intr: CameraIntrinsics, cfg: SLAMConfig) -> None:
    unit = row_unit(cfg.num_pyramid_levels)
    if bounds[-1][1] != intr.height or any(a % unit for a, _ in bounds):
        raise ValueError(f"image rows {bounds} are not split in units of {unit} rows over a "
                         f"{intr.height}-row image (shard the state and frames with this "
                         f"config)")


def split_like(x: torch.Tensor, like: ShardedRows) -> ShardedRows:
    """``x``'s rows split as ``like``'s."""
    return like.like([x[a:b].to(p.device, copy=True).contiguous()
                      for p, (a, b) in zip(like.parts, like.bounds)])


# --------------------------------------------------------------------------- #
# bootstrap, step
# --------------------------------------------------------------------------- #

def bootstrap(frame: slam.FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig,
              init_pose=None) -> slam.SLAMState:
    """The unsharded bootstrap of a sharded frame, gathered onto its mesh's
    first device, then the state split over the mesh."""
    state = slam._bootstrap(gather_frame(frame), intr, cfg, init_pose)
    return shard_state(state, frame.depth.mesh, cfg)


def step(state: slam.SLAMState, frame: slam.FrameInput, intr: CameraIntrinsics,
         cfg: SLAMConfig, fixed_pose: torch.Tensor | None = None) -> slam.SLAMState:
    """``slam.step`` on a sharded state (branch for branch); ``frame``
    sharded as the state's images, or whole (it is then split)."""
    mesh = _mesh(state)
    img = state.pred_vertex
    _check_bounds(img.bounds, intr, cfg)
    if is_sharded(frame):
        if frame.depth.bounds != img.bounds:
            raise ValueError(f"the frame's rows {frame.depth.bounds} are not split as the "
                             f"state's {img.bounds}")
    else:
        frame = slam.FrameInput(*(split_like(x, img) for x in frame))
    time = state.time + 1
    pres = _preprocess(frame, intr, cfg)
    home = mesh.home

    if fixed_pose is None:
        tr = track(state, pres, intr, cfg)
        new_R, new_t = tr.R, tr.t
        icp_error, icp_count = tr.icp_error, tr.icp_count
    else:
        fixed_pose = const(fixed_pose, home)
        new_R, new_t = fixed_pose[:3, :3], fixed_pose[:3, 3]
        icp_error = icp_count = torch.zeros((), dtype=torch.float32, device=home)
    pose = lie.rt_to_mat(new_R, new_t)
    pose_inv = lie.se3_inverse(pose)

    dt = torch.linalg.vector_norm(new_t - state.t)
    w_rot = torch.linalg.vector_norm(lie.so3_log(state.R.T @ new_R))
    weighting = _On(torch.clamp(1.0 - (dt * 5.0 + w_rot * 2.0), 0.25, 1.0))
    pose_on, pose_inv_on = _On(pose), _On(pose_inv)
    meas = []
    for k, ((a, _), (_, pre, curv, _)) in enumerate(zip(img.bounds, pres)):
        dev = img.parts[k].device
        conf = preprocess.confidence_map(pre, curv, intr, cfg, weighting=weighting(dev), row0=a)
        meas.append(sm.measurement_from_preprocess(pre, curv, frame.rgb.parts[k], conf))

    n_sub = state.active_submaps.shape[0]
    act_cur = state.active_submaps[min(max(state.submap_idx, 0), n_sub - 1)].to(torch.float32)
    data, count = state.map.data, state.map.count
    idx = render_index(data, pose_inv_on, intr,
                       active=[(p[:, sm.VALID] > 0.5) & (p[:, sm.ACT] > 0.5) for p in data.parts])
    data, count, idx2 = fuse(data, count, meas, pose_on, idx, img, intr, cfg, time,
                             state.submap_idx, _On(act_cur))

    # one extended attr render after fuse (each image shard's rows and the
    # halo the ray cast reads), shared by clean and prediction
    halo = max(cfg.predict_window_multiplier, 1)
    attr_ext = []
    for k, (a, b) in enumerate(img.bounds):
        ids, s0 = _slab(idx2, img.parts[k].device, a - halo, b + halo)
        rows = _gather_rows(data, ids.reshape(-1))
        attr_ext.append((sm.attr_from_rows(rows, ids.reshape(-1) >= 0,
                                           pose_inv_on(ids.device), ids.shape, extended=True),
                         ids, s0))
    data, count, remap = clean_with_remap(data, count, pose_on, attr_ext, img, intr, cfg, time)

    cp = max(cfg.clean_compact_period, 1)
    cw = max(cfg.clean_crowd_period, 1)
    pixel_remap = (cfg.clean_pixel_remap and cp > 1 and cw > 1 and time % cp != 0
                   and time % cw != 0)
    splat = cfg.raycast_period > 1 and time % cfg.raycast_period != 0
    filled_parts = []
    for k, ((a, b), (ae, ids, s0)) in enumerate(zip(img.bounds, attr_ext)):
        dev = ids.device
        if pixel_remap:
            keep_pix = sm.pixel_keep_mask(ae, cfg, time)
            idx3 = torch.where((ids >= 0) & keep_pix, ids, -1)
        else:
            idx3 = torch.where(ids >= 0, _gather_rows(remap, ids), -1)
        own = slice(a - s0, b - s0)
        if splat:
            own_ids = idx3[own].reshape(-1)
            pred = raycast.splat_from_rows(_gather_rows(data, own_ids), own_ids >= 0,
                                           pose_inv_on(dev), cfg, (b - a, intr.width))
        else:
            pred_attr = torch.where((idx3 >= 0)[..., None], ae, 0.0)
            pred = _predict_hrbf_slab(pred_attr, s0, a, b, pose_inv_on(dev), intr, cfg)
        _, pre, curv, _ = pres[k]
        filled_parts.append(raycast.fill_in(pred, pre.vertex_filtered, pre.normal, pre.radius,
                                            frame.rgb.parts[k], meas[k].conf, curv.k1, curv.k2,
                                            cfg))
    return _state(data, count, new_R, new_t, time, state.submap_idx, pres, filled_parts,
                  state.active_submaps, icp_error, icp_count, img, intr, mesh)


def _state(data, count, R, t, time, submap_idx, pres, filled, active_submaps,
           icp_error, icp_count, img, intr, mesh) -> slam.SLAMState:
    def rows(field):
        return img.like([getattr(f, field) for f in filled])

    n_model = mesh.psum([[f.from_model.to(torch.float32).sum()] for f in filled])[0][0]
    return slam.SLAMState(
        map=sm.SurfelMap(data, count), R=R, t=t, time=time, submap_idx=submap_idx,
        prev_intensity=img.like([p[3] for p in pres]),
        pred_vertex=rows("vertex"), pred_normal=rows("normal"),
        pred_intensity=img.like([pyramid.rgb_to_intensity(f.color) for f in filled]),
        pred_icp_weight=rows("icp_weight"), pred_k1=rows("k1"), pred_k2=rows("k2"),
        active_submaps=active_submaps, last_icp_error=icp_error, last_icp_count=icp_count,
        dense_frac=n_model / float(intr.height * intr.width))


def _preprocess(frame: slam.FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig):
    """Per image shard: (filtered depth, VertexNormalRadius,
    CurvatureResult, intensity) of its rows, from its rows plus the
    chain's halo."""
    halo = preprocess_halo(cfg)
    out = []
    for k, (a, b) in enumerate(frame.depth.bounds):
        dev = frame.depth.parts[k].device
        depth, s0 = _slab(frame.depth, dev, a - halo, b + halo)
        depth_f = (preprocess.bilateral_filter(depth, cfg, pallas_form=cfg.use_pallas)
                   if cfg.use_bilateral_filter else depth)
        pre = preprocess.vertex_normal_radius(depth, depth_f, intr, cfg, row0=s0)
        curv = preprocess.curvature_gradient(pre, intr, cfg)
        pre = preprocess.update_normal_rad(pre, curv, cfg)
        i0, i1 = a - s0, b - s0
        out.append((depth_f[i0:i1], _rows(pre, i0, i1), _rows(curv, i0, i1),
                    pyramid.rgb_to_intensity(frame.rgb.parts[k])))
    return out


def _predict_hrbf_slab(attr_ext: torch.Tensor, s0: int, a: int, b: int,
                       pose_inv: torch.Tensor, intr: CameraIntrinsics,
                       cfg: SLAMConfig) -> raycast.Prediction:
    """``raycast.predict_hrbf`` of the image rows [a, b) from the extended
    attr slab of the rows from ``s0`` on (every row within the window's
    radius of them that the image has)."""
    attr9 = torch.cat([attr_ext[..., 0:sm.A_RADIUS + 1],
                       attr_ext[..., sm.A_VALID:sm.A_VALID + 1]], dim=-1)
    p_surf, grad, nearest, found = kernels.raycast_core(attr9, intr, cfg, top=a - s0,
                                                        height=b - a, row0=a)
    P = (b - a) * intr.width
    grad = grad.reshape(P, 3)
    nrm = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-12)
    return raycast._assemble_prediction(attr_ext, pose_inv, p_surf.reshape(P, 3), nrm,
                                        nearest.reshape(P), found.reshape(P), intr, cfg,
                                        row0=a, attr_row0=s0)


# --------------------------------------------------------------------------- #
# the map
# --------------------------------------------------------------------------- #

def render_index(data: ShardedRows, pose_inv: _On, intr: CameraIntrinsics,
                 active=None, conf_threshold: float | None = None) -> list:
    """``surfel_map.render_index`` of a sharded map: the whole (H, W)
    index map on each local shard's device (one tensor per device)."""
    mesh = data.mesh
    tg, ids = [], []
    for k, (part, (lo, hi)) in enumerate(zip(data.parts, data.bounds)):
        dev = part.device
        tg.append(sm.render_targets(part, pose_inv(dev), intr,
                                    None if active is None else active[k], conf_threshold))
        ids.append(torch.arange(lo, hi, dtype=torch.int32, device=dev))
    if data.total <= sm.KEY_ROWS:
        bufs = mesh.pmin([[sm.render_keys(*t, i, intr)] for t, i in zip(tg, ids)])
        keyed = True
    else:
        zbuf = mesh.pmin([[sm.render_zbuf(*t, intr)] for t in tg])
        bufs = mesh.pmin([[sm.render_winners(*t, i, z[0], intr)]
                          for t, i, z in zip(tg, ids, zbuf)])
        keyed = False
    decoded = {}
    for (buf,) in bufs:
        if buf.device not in decoded:
            decoded[buf.device] = sm.decode_index(buf, intr, keyed)
    return [decoded[b[0].device] for b in bufs]


def fuse(data: ShardedRows, count: torch.Tensor, meas: list, pose: _On, idx: list,
         img: ShardedRows, intr: CameraIntrinsics, cfg: SLAMConfig, time: int,
         submap_idx: int, act: _On):
    """``surfel_map.fuse`` over a sharded map: ``meas`` each image shard's
    ``FrameMeasurement`` of its rows, ``idx`` the whole index map on each
    shard's device.  Returns (map rows, count, updated index map split as
    ``img``)."""
    mesh = data.mesh
    h, w = intr.height, intr.width
    hq, wq = h // 2, w // 2
    P = hq * wq
    n_cap = data.total
    par = int(time) % 2
    pose_inv = _On(lie.se3_inverse(pose.x))

    px = []   # per image shard: its checkerboard pixels' association
    for k, (a, b) in enumerate(img.bounds):
        dev = img.parts[k].device
        yq0 = max((a - par + 1) // 2, 0)
        yq1 = min(hq, (b - par + 1) // 2)
        nq = max(yq1 - yq0, 0)
        y_first = 2 * yq0 + par
        ys0, ys1 = max(y_first - 1, 0), min(y_first + 2 * nq, h)
        ids = idx[k][ys0:ys1]
        rows = _gather_rows(data, ids.reshape(-1))
        attr = sm.attr_from_rows(rows, ids.reshape(-1) >= 0, pose_inv(dev), ids.shape)
        r0 = y_first - ys0

        def quarter(x, r0=r0, nq=nq):
            return x[r0:r0 + 2 * nq:2, par:par + 2 * wq:2]

        n_pix = nq * wq
        patch = quarter(extract_patches(sm.fuse_attr7(attr), 1)).reshape(n_pix, 9, 7)
        cand = quarter(extract_patches(ids, 1, fill=-1)).reshape(n_pix, 9)
        m0 = y_first - a
        meas_q = sm.FrameMeasurement(*(x[m0:m0 + 2 * nq:2, par:par + 2 * wq:2]
                                       for x in meas[k]))
        yyq, xxq = camera.pixel_grid(nq, wq, dev, row0=yq0)
        ok_pix, best_id, new_rows = sm.fuse_pixels(meas_q, patch, cand, 2.0 * xxq + par,
                                                   2.0 * yyq + par, pose(dev), intr, cfg,
                                                   time, submap_idx, act(dev))
        px.append(dict(dev=dev, p0=yq0 * wq, n=n_pix, nq=nq, m0=m0, ok=ok_pix, best=best_id,
                       new_rows=new_rows, patch=patch, cand=cand, meas_q=meas_q))

    # the winner scatter-min and the merge, on the shard that owns the row
    merged = []
    for part, (lo, hi) in zip(data.parts, data.bounds):
        dev = part.device
        n = hi - lo
        wtbl = None
        for q in px:
            best = q["best"].to(dev)
            mine = (q["ok"].to(dev) & (best >= lo) & (best < hi))
            pix = torch.arange(q["p0"], q["p0"] + q["n"], dtype=torch.int32, device=dev)
            got = sm.winner_table(torch.where(mine, best - lo, n), mine, pix, n)
            wtbl = got if wtbl is None else torch.minimum(wtbl, got)
        has_winner = wtbl != _INT_MAX
        meas_rows = None
        for q in px:
            if q["n"] == 0:
                continue
            local = torch.clamp(wtbl - q["p0"], 0, q["n"] - 1).long()
            got = q["new_rows"][local.to(q["dev"])].to(dev)
            own = (wtbl >= q["p0"]) & (wtbl < q["p0"] + q["n"])
            meas_rows = got if meas_rows is None else torch.where(own[:, None], got, meas_rows)
        merged.append(sm.merge_rows(part, meas_rows, has_winner))

    # new surfels: count + rank over the whole frame in pixel order
    S = min(cfg.new_surfels_capacity, P, n_cap)
    start = _On(torch.clamp(count, 0, n_cap - S))
    new_mask = [q["ok"] & (q["best"] < 0) for q in px]
    offs, total = mesh.exclusive_scan([m.sum(dtype=torch.int32) for m in new_mask])
    n_new = _On(torch.clamp(total[0], max=S))
    for q, m, off in zip(px, new_mask, offs):
        rank = off + torch.cumsum(m.to(torch.int32), dim=0, dtype=torch.int32) - 1
        q["new_id"] = start(q["dev"]) + rank
        q["appended"] = m & (rank < S)
    out = []
    for part, (lo, hi) in zip(merged, data.bounds):
        dev = part.device
        n = hi - lo
        slot = torch.arange(lo, hi, dtype=torch.int32, device=dev) - start(dev)
        stale = (slot >= n_new(dev)) & (slot < S)
        buf = torch.cat([torch.where(stale[:, None], sm._empty_rows(1, dev), part),
                         part.new_zeros((1, sm.N_CHANNELS))])
        for q in px:
            new_id = q["new_id"].to(dev)
            mine = q["appended"].to(dev) & (new_id >= lo) & (new_id < hi)
            buf.index_copy_(0, torch.where(mine, new_id - lo, n).long(), q["new_rows"].to(dev))
        out.append(buf[:n])
    count = torch.clamp(start.x + n_new.x, max=n_cap).to(torch.int32)

    idx2 = []
    for k, ((a, b), q) in enumerate(zip(img.bounds, px)):
        upd = sm.fuse_index_update(q["appended"], q["new_id"], q["cand"], q["meas_q"],
                                   q["patch"]).reshape(q["nq"], wq)
        own = idx[k][a:b].clone()
        own[q["m0"]:q["m0"] + 2 * q["nq"]:2, par:par + 2 * wq:2] = upd
        idx2.append(own)
    return data.like(out), count, img.like(idx2)


def clean_with_remap(data: ShardedRows, count: torch.Tensor, pose: _On, attr_ext: list,
                     img: ShardedRows, intr: CameraIntrinsics, cfg: SLAMConfig, time: int):
    """``surfel_map.clean_with_remap`` over a sharded map; ``attr_ext``
    each image shard's (extended attr slab, index slab, first row), with
    at least one row of halo.  Returns (map rows, count, remap rows)."""
    mesh = data.mesh
    patches = None
    if int(time) % max(cfg.clean_crowd_period, 1) == 0:
        own = []
        for (a, b), (ae, _, s0) in zip(img.bounds, attr_ext):
            p = sm.crowd_patches(ae[..., :sm.ATTR_CHANNELS])
            own.append(p[(a - s0) * intr.width:(b - s0) * intr.width])
        patches = mesh.all_gather(own)
    keep = [sm.clean_mask_rows(part, pose(part.device),
                               None if patches is None else patches[k], intr, cfg, time)
            for k, part in enumerate(data.parts)]
    if int(time) % max(cfg.clean_compact_period, 1) == 0:
        new_data, new_count, rank = compact(data, keep)
        return new_data, new_count, data.like([torch.where(k, r, -1)
                                               for k, r in zip(keep, rank)])
    parts, remap = [], []
    for part, k, (lo, hi) in zip(data.parts, keep, data.bounds):
        part = part.clone()
        part[:, sm.VALID] = torch.where(k, part[:, sm.VALID], 0.0)
        parts.append(part)
        remap.append(torch.where(k, torch.arange(lo, hi, dtype=torch.int32,
                                                 device=part.device), -1))
    return data.like(parts), count, data.like(remap)


def compact(data: ShardedRows, keep: list):
    """``surfel_map.compact`` across shards: every row moves to the shard
    that owns its new position (kept rows first, then the killed ones,
    each in the old order).  Returns (rows, count, each kept row's new
    position per shard)."""
    mesh = data.mesh
    kept = [k.sum(dtype=torch.int32) for k in keep]
    off_keep, n_keep = mesh.exclusive_scan(kept)
    off_kill, _ = mesh.exclusive_scan([k.shape[0] - c for k, c in zip(keep, kept)])
    pos, rank = [], []
    for k, ok, ol, nk in zip(keep, off_keep, off_kill, n_keep):
        r_keep = ok + torch.cumsum(k.to(torch.int32), dim=0, dtype=torch.int32) - 1
        r_kill = ol + torch.cumsum((~k).to(torch.int32), dim=0, dtype=torch.int32) - 1
        rank.append(r_keep)
        pos.append(torch.where(k, r_keep, nk + r_kill))
    out = []
    for part, (lo, hi) in zip(data.parts, data.bounds):
        dev = part.device
        n = hi - lo
        buf = part.new_empty((n + 1, sm.N_CHANNELS))
        for src, p in zip(data.parts, pos):
            p = p.to(dev)
            mine = (p >= lo) & (p < hi)
            buf.index_copy_(0, torch.where(mine, p - lo, n).long(), src.to(dev))
        rows = buf[:n]
        rows[:, sm.VALID] = (torch.arange(lo, hi, device=dev)
                             < n_keep[0].to(dev)).to(torch.float32)
        out.append(rows)
    return data.like(out), n_keep[0], rank


def per_shard(m: sm.SurfelMap, fn) -> sm.SurfelMap:
    """A row-local map op (``SurfelMap -> SurfelMap``) on each shard of a
    sharded map, or on a whole map."""
    if not isinstance(m.data, ShardedRows):
        return fn(m)
    parts = [fn(sm.SurfelMap(p, m.count.to(p.device))).data for p in m.data.parts]
    return sm.SurfelMap(m.data.like(parts), m.count)


def refresh_active_channel(m: sm.SurfelMap, submap_active: torch.Tensor) -> sm.SurfelMap:
    on = _On(submap_active)
    return per_shard(m, lambda x: sm.refresh_active_channel(x, on(x.data.device)))


def apply_submap_deltas(m: sm.SurfelMap, deltas: torch.Tensor) -> sm.SurfelMap:
    on = _On(deltas)
    return per_shard(m, lambda x: sm.apply_submap_deltas(x, on(x.data.device)))


def whole_map(m: sm.SurfelMap) -> sm.SurfelMap:
    """A sharded map gathered onto its mesh's first device."""
    return sm.SurfelMap(gather(m.data), m.count)


def split_map(m: sm.SurfelMap, mesh: Mesh) -> sm.SurfelMap:
    return sm.SurfelMap(ShardedRows.split(m.data, mesh), m.count.to(mesh.home))


def grow(m: sm.SurfelMap, new_capacity: int) -> sm.SurfelMap:
    """``surfel_map.grow`` of a sharded map: gathered, grown, split again
    (evenly over the new capacity)."""
    return split_map(sm.grow(whole_map(m), new_capacity), m.data.mesh)


def exchange_active(act: sm.SurfelMap, arch: sm.SurfelMap, submap_active: torch.Tensor,
                    time: int, cfg: SLAMConfig):
    """``surfel_map.exchange_active`` with a sharded active map: gathered,
    exchanged with the (whole) archive, split again."""
    a2, r2, stats = sm.exchange_active(whole_map(act), arch, submap_active, time, cfg)
    return split_map(a2, act.data.mesh), r2, stats


# --------------------------------------------------------------------------- #
# tracking
# --------------------------------------------------------------------------- #

def row_sharded_tracking(cfg: SLAMConfig) -> bool:
    """Whether ``track`` sums row-sharded Grams (the joint nearest-pixel
    pass with both terms: the default and bench configurations) or
    gathers the inputs and tracks whole on the first device."""
    return (0 < cfg.icp_weight < 100 and not cfg.icp_use_sparse
            and not cfg.icp_use_correspondence_search and cfg.tracking_rgb_nearest
            and cfg.tracking_reassoc_period <= 1 and cfg.tracking_subsample <= 1
            and cfg.tracking_topk <= 0 and not cfg.tracking_patch_assoc)


def track(state: slam.SLAMState, pres: list, intr: CameraIntrinsics,
          cfg: SLAMConfig) -> odometry.TrackResult:
    """``slam.step``'s tracking on a sharded state; ``pres`` the
    per-shard preprocess outputs."""
    img = state.pred_vertex
    if not row_sharded_tracking(cfg):
        def whole(i):
            return gather(img.like([p[i] for p in pres]))

        depth_f, intensity = whole(0), whole(3)
        pre = preprocess.VertexNormalRadius(
            *(gather(img.like([p[1][f] for p in pres])) for f in range(5)))
        curv = preprocess.CurvatureResult(
            *(gather(img.like([p[2][f] for p in pres])) for f in range(8)))
        st = state._replace(**{f: gather(getattr(state, f)) for f in (
            "prev_intensity", "pred_vertex", "pred_normal", "pred_intensity",
            "pred_icp_weight", "pred_k1", "pred_k2")})
        return slam.track_frame(st, depth_f, pre, curv, intensity, intr, cfg)
    levels = _pyramids(state, pres, cfg)
    return _track_rows(state.R, state.t, levels, img.mesh, intr, cfg)


def _pyramids(state: slam.SLAMState, pres: list, cfg: SLAMConfig) -> list:
    """Per pyramid level, per shard: its rows of every tracking input
    (``odometry.build_inputs``' fused passes), with the level's row
    bounds."""
    img = state.pred_vertex
    R, t = _On(state.R), _On(state.t)
    lvl0 = []
    for k, (depth_f, pre, _, intensity) in enumerate(pres):
        dev = img.parts[k].device
        pv, pn = state.pred_vertex.parts[k], state.pred_normal.parts[k]
        valid = pv[..., 2] > 0
        lvl0.append({
            "deps": torch.stack([depth_f, torch.where(valid, pv[..., 2], 0.0)], dim=-1),
            "ints": torch.stack([intensity, state.pred_intensity.parts[k],
                                 state.prev_intensity.parts[k]], dim=-1),
            "vmaps": [pre.vertex_filtered, torch.where(valid[..., None],
                                                        pv @ R(dev).T + t(dev), 0.0)],
            "nmaps": [pre.normal, torch.where(valid[..., None], pn @ R(dev).T, 0.0)],
            "scalars": [state.pred_icp_weight.parts[k]],
        })
    levels = [(lvl0, list(img.bounds), img.total)]
    for _ in range(cfg.num_pyramid_levels - 1):
        shards, bounds, height = levels[-1]
        h2 = height // 2
        nb = [(a // 2, b // 2) for a, b in bounds]
        nb[-1] = (nb[-1][0], h2)
        nxt = []
        deps = ShardedRows([s["deps"] for s in shards], bounds, height, img.mesh)
        ints = ShardedRows([s["ints"] for s in shards], bounds, height, img.mesh)
        for k, (s, (a, b)) in enumerate(zip(shards, bounds)):
            dev = img.parts[k].device
            d, s0 = _slab(deps, dev, a - 2, b + 2)
            i, _ = _slab(ints, dev, a - 2, b + 2)
            r0, n = (a - s0) // 2, nb[k][1] - nb[k][0]
            vms, nms, scs = pyramid.resize_maps_fused(s["vmaps"], s["nmaps"], s["scalars"])
            nxt.append({"deps": pyramid.pyr_down_depth_mc(d)[r0:r0 + n],
                        "ints": pyramid.pyr_down_intensity_mc(i)[r0:r0 + n],
                        "vmaps": vms, "nmaps": nms, "scalars": scs})
        levels.append((nxt, nb, h2))
    return levels


def _level_slab(shards, bounds, height, mesh, key, chan, k, halo):
    """(slab of channel ``chan`` of input ``key`` around shard k's rows,
    its first row)."""
    x = ShardedRows([s[key][..., chan] for s in shards], bounds, height, mesh)
    return _slab(x, mesh.devices[k], bounds[k][0] - halo, bounds[k][1] + halo)


def _so3_prealign(levels, mesh: Mesh, intr: CameraIntrinsics, cfg: SLAMConfig):
    """``odometry._so3_prealign`` with each shard's sums over its own rows
    of the coarsest level, reduced by ``psum``; the solve once."""
    lvl = cfg.num_pyramid_levels - 1
    shards, bounds, height = levels[lvl]
    li = intr.level(lvl)
    home = mesh.home
    K, Kinv = odometry._k_matrix(li, home)
    grad_rows, last, last_g = [], [], []
    for k, (a, b) in enumerate(bounds):
        nxt, s0 = _level_slab(shards, bounds, height, mesh, "ints", 0, k, 1)
        gx, gy = icp_ops.central_gradients(nxt, s0, height)
        i0, i1 = a - s0, b - s0
        grad_rows.append(torch.stack([nxt[i0:i1].reshape(-1), gx[i0:i1].reshape(-1),
                                      gy[i0:i1].reshape(-1)], dim=-1))
        prev, s0 = _level_slab(shards, bounds, height, mesh, "ints", 2, k, 1)
        lgx, lgy = icp_ops.central_gradients(prev, s0, height)
        i0, i1 = a - s0, b - s0
        last.append(prev[i0:i1])
        last_g.append((lgx[i0:i1], lgy[i0:i1]))
    table = mesh.all_gather(grad_rows)
    next_whole = [t[:, 0].reshape(height, li.width) for t in table]
    kinv = _On(Kinv)

    def sums(basis, krlr):
        basis, krlr = _On(basis), _On(krlr)
        return mesh.psum([list(icp_ops.so3_step(
            last[k], next_whole[k], table[k], *last_g[k], basis(dev), kinv(dev), krlr(dev),
            row0=a)) for k, ((a, _), dev) in enumerate(zip(bounds, mesh.devices))])[0]

    return odometry.so3_loop(sums, K, Kinv, cfg.so3_iterations)


def _track_rows(prev_R: torch.Tensor, prev_t: torch.Tensor, levels, mesh: Mesh,
                intr: CameraIntrinsics, cfg: SLAMConfig) -> odometry.TrackResult:
    """``odometry.track``'s joint nearest-pixel path with each
    Gauss-Newton system summed over the shards' own pixels."""
    home = mesh.home
    result_rt = torch.eye(4, dtype=torch.float32, device=home)
    if cfg.so3_prealign:
        result_rt[:3, :3] = _so3_prealign(levels, mesh, intr, cfg)
    prev_R_inv = _On(prev_R.T)
    prev_t_on = _On(prev_t)
    prev_T = lie.rt_to_mat(prev_R, prev_t)
    zero = torch.zeros((), dtype=torch.float32, device=home)
    stats = {"icp_e": zero, "icp_c": zero, "rgb_e": zero, "rgb_c": zero}
    carry = (result_rt, torch.zeros((6, 6), dtype=torch.float32, device=home),
             torch.zeros((6,), dtype=torch.float32, device=home), stats, None)
    eps = cfg.tracking_converge_eps
    live = {}

    for lvl in range(cfg.num_pyramid_levels - 1, -1, -1):
        shards, bounds, height = levels[lvl]
        li = intr.level(lvl)
        min_scale = (cfg.min_gradient_magnitudes[lvl] ** 2) / (cfg.sobel_scale ** 2)
        subs, model = [], []
        for k, (s, (a, b)) in enumerate(zip(shards, bounds)):
            ints, s0 = _level_slab(shards, bounds, height, mesh, "ints", 0, k, 2)
            deps, _ = _level_slab(shards, bounds, height, mesh, "deps", 0, k, 2)
            gx, gy = pyramid.sobel_derivatives(ints)
            sv = icp_ops.rgb_static_valid(ints, gx, gy, deps, min_scale, s0, height)
            i0, i1 = a - s0, b - s0
            n_pix = (b - a) * li.width
            vcurr, ncurr, valid = icp_ops.joint_cur_pack(s["vmaps"][0], s["nmaps"][0],
                                                         s["deps"][..., 0], li, row0=a)
            subs.append(icp_ops.SubPixels(
                vcurr=vcurr, ncurr=ncurr, valid=valid, i_next=ints[i0:i1].reshape(n_pix),
                static_valid=sv.reshape(-1, li.width)[i0:i1].reshape(n_pix),
                gx=gx[i0:i1].reshape(n_pix), gy=gy[i0:i1].reshape(n_pix)))
            model.append(icp_ops.pack_joint_nearest(
                s["vmaps"][1], s["nmaps"][1], s["scalars"][0], s["deps"][..., 1],
                s["ints"][..., 1]))
        table = mesh.all_gather(model)

        def body(it, carry, subs=subs, table=table, li=li):
            result_rt = carry[0]
            cur = odometry.current_pose(prev_T, result_rt)
            R_curr, t_curr = _On(cur[:3, :3]), _On(cur[:3, 3])
            passes = []
            for k, sub in enumerate(subs):
                dev = mesh.devices[k]
                icp_res, corres, _ = icp_ops.joint_step(
                    R_curr(dev), t_curr(dev), prev_R_inv(dev), prev_t_on(dev), None, None,
                    None, table[k], None, None, li, cfg, nearest=True, sub=sub)
                passes.append((icp_res, corres))
            n_rgb, ssum = mesh.psum([[c.count, c.sigma_sum] for _, c in passes])[0]
            sigma_val = _On(odometry.robust_sigma(n_rgb))
            parts = []
            for k, ((icp_res, corres), sub) in enumerate(zip(passes, subs)):
                rgb_res = icp_ops.rgb_step(corres, sigma_val(mesh.devices[k]), sub.gx, sub.gy,
                                           li, cfg)
                parts.append([*icp_res, rgb_res.A, rgb_res.b])
            iA, ib, ir2, ic, rA, rb = mesh.psum(parts)[0]
            A, b, st = odometry.joint_system(icp_ops.StepResult(iA, ib, ir2, ic),
                                             icp_ops.StepResult(rA, rb, None, None), ssum, n_rgb,
                                             cfg.icp_weight)
            x = icp_ops.solve_system(A, b)
            return ((odometry.apply_increment(result_rt, x), A, b, st, None),
                    torch.linalg.vector_norm(x))

        carry, live[lvl] = odometry._gn_loop(body, cfg.pyramid_iterations[lvl], carry, eps)

    return odometry.track_result(carry, prev_R, prev_t, live, cfg)
