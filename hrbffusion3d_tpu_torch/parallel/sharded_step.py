"""The row-sharded dense step: ``bootstrap`` and ``step`` on a state whose
surfel map rows and image rows are split over a ``Mesh`` (the port of
what ``jax.jit(slam.step, in_shardings=state_sharding(mesh), ...)`` does
in ``tests/test_aa_sharded_step.py``, where GSPMD places the
collectives; here the decomposition is written out).

Each shard's part runs in turn, on its own device; the mesh may span a
process group (``multihost.global_mesh``), each process running its own
shards.  Shards exchange data only through the mesh: its collectives
(``psum``, ``pmin``, ``all_gather``, ``exclusive_scan``), its halo
exchange (``Mesh.slabs``: within a process a direct read of the
neighbouring shards' rows, across processes the edge rows others need),
its merge by owner (``Mesh.gather_rows``: a row read by global id takes
the value of the one shard that owns it) and its row move
(``Mesh.move_rows``: a row sent to a new global position reaches only the
shard, and the process, that owns it), so nothing here branches on
whether a group exists:
  - preprocess: each image-row shard filters its rows plus a halo of
    ``preprocess_halo(cfg)`` rows (bilateral 6 + PCA 3 + curvature
    ``curv_window``; every row of the halo within the image), then keeps
    its own rows; pixel coordinates are the image's (``row0``);
  - tracking (``odometry.track_levels``, every tracking setting): each
    shard builds its rows of every pyramid level (a 2-row halo at each
    level for the 5x5 filters; rows split in units of 2^(levels-1)),
    evaluates its own pixels against the model tables all-gathered per
    level, and every Gauss-Newton system is summed with ``psum``; the
    solves run once, on the first device;
  - ``render_index``: each map shard scatter-mins its own rows by global
    id into a whole-image buffer, and ``pmin`` merges each pass (key; or
    z, then id);
  - ``fuse``: each image shard associates its checkerboard pixels (the
    candidate rows gathered by owner); each pixel's winner over the map
    rows is a scatter-min merged by ``pmin``, each winning measurement
    moves to the map shard that owns its row, which merges it; new surfels
    take ``count + rank`` with the rank of the pixel-order cumsum over the
    frame (``exclusive_scan`` of the per-shard counts) and move to the map
    shard that owns that row;
  - clean: the keep mask per map row (the crowd rules read the
    all-gathered attr patches); a compaction moves every row to its new
    position (``exclusive_scan`` of the kept and killed counts), in
    ``compact``'s order; the remap is a merged gather;
  - prediction: the ray cast (and its epilogue, ``fill_in``, splat
    prediction) per image shard on its rows plus a halo of
    ``predict_window_multiplier`` rows, launched with the slab's first
    image row, so the ray arithmetic is the whole image's.
Everything but the Gram sums is exact (minima, owner selects, integer
scans, per-pixel arithmetic on slabs with image rows), so a replay
(``fixed_pose``) equals the unsharded step bit for bit; the Gram sums are
float64, rounded to float32 once (``ops/icp._sums``), so a tracked step
does too, but for a float64 sum within its own error of a float32
rounding boundary.  Within a process a step reads nothing back to the
host; across processes the collectives stage through host memory with
``gloo``.

``bootstrap`` runs the step's per-shard pieces on an empty map; ``grow``
moves rows to their new owners as the compaction does; ``exchange_active``
decides the rows that leave and enter per shard, places them with
``exclusive_scan`` and all-gathers only the rows that leave for the
archive (the archive is whole on every process, its rows past its count
pristine: the unsharded exchange copies dead active rows there, which
would take every active row onto every process);
``refresh_active_channel`` and ``apply_submap_deltas`` run per shard.
No path but ``whole_map`` gathers the whole map onto one process.
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
from .mesh import Mesh, On
from .sharding import ShardedRows, gather, is_sharded, row_bounds, row_unit

_INT_MAX = torch.iinfo(torch.int32).max


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def preprocess_halo(cfg: SLAMConfig) -> int:
    """Rows of halo the preprocess chain needs: the bilateral window (6),
    the normal's (PCA 3, central differences 1), the curvature window."""
    return ((6 if cfg.use_bilateral_filter else 0) + (3 if cfg.normal_pca else 1)
            + cfg.curv_window)


def _rows(t, i0: int, i1: int):
    """Rows [i0, i1) of every field of a NamedTuple of images."""
    return type(t)(*(x[i0:i1] for x in t))


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


def _ids(bounds, devices):
    """Each local shard's global row ids (int32) on its device."""
    return [torch.arange(lo, hi, dtype=torch.int32, device=d) for (lo, hi), d in
            zip(bounds, devices)]


def _order(mesh: Mesh, keep: list):
    """``compact``'s order across shards: (per local shard its rows' new
    positions, kept rows first then the killed ones, each in the old
    order; per local shard its kept rows' ranks; the kept count)."""
    kept = [k.sum(dtype=torch.int32) for k in keep]
    off_keep, n_keep = mesh.exclusive_scan(kept)
    off_kill, _ = mesh.exclusive_scan([k.shape[0] - c for k, c in zip(keep, kept)])
    pos, rank = [], []
    for k, ok, ol, nk in zip(keep, off_keep, off_kill, n_keep):
        r_keep = ok + torch.cumsum(k.to(torch.int32), dim=0, dtype=torch.int32) - 1
        r_kill = ol + torch.cumsum((~k).to(torch.int32), dim=0, dtype=torch.int32) - 1
        rank.append(r_keep)
        pos.append(torch.where(k, r_keep, nk + r_kill))
    return pos, rank, n_keep[0]


def _append(parts: list, data: ShardedRows, count: torch.Tensor, rows: ShardedRows,
            new_mask: list, S: int):
    """``surfel_map._append`` over shards: the rows of ``rows`` (split as
    the image shards' pixels) where ``new_mask`` holds, in global order,
    written as a block of S rows at clamp(count, 0, capacity - S) over the
    map rows ``parts`` (split as ``data``), its unused tail emptied.
    Returns (map rows, count, per image shard: whether each pixel was
    appended, its new row id).  Each appended row moves to the map shard
    that owns its new id."""
    mesh = data.mesh
    n_cap = data.total
    start = On(torch.clamp(count, 0, n_cap - S))
    offs, total = mesh.exclusive_scan([m.sum(dtype=torch.int32) for m in new_mask])
    n_new = On(torch.clamp(total[0], max=S))
    appended, new_id, pos = [], [], []
    for m, off in zip(new_mask, offs):
        rank = off + torch.cumsum(m.to(torch.int32), dim=0, dtype=torch.int32) - 1
        app = m & (rank < S)
        appended.append(app)
        new_id.append(start(m.device) + rank)
        pos.append(torch.where(app, new_id[-1], -1))
    out = []
    for (lo, hi), g in zip(data.bounds, rows.move_rows(pos, data.like(parts)).parts):
        dev = g.device
        slot = torch.arange(lo, hi, dtype=torch.int32, device=dev) - start(dev)
        stale = (slot >= n_new(dev)) & (slot < S)
        out.append(torch.where(stale[:, None], sm._empty_rows(1, dev), g))
    count = torch.clamp(start.x + n_new.x, max=n_cap).to(torch.int32)
    return out, count, appended, new_id


def _map_layout(mesh: Mesh, capacity: int):
    """(every shard's map rows, this process's) for ``capacity`` rows."""
    every = row_bounds(capacity, mesh.size)
    return every, mesh.local(every)


# --------------------------------------------------------------------------- #
# bootstrap, step
# --------------------------------------------------------------------------- #

def bootstrap(frame: slam.FrameInput, intr: CameraIntrinsics, cfg: SLAMConfig,
              init_pose=None) -> slam.SLAMState:
    """``slam.bootstrap`` of a sharded frame: the step's per-shard pieces
    on an empty map (preprocess, the frame's valid pixels appended in
    pixel order, the index render, the prediction)."""
    img = frame.depth
    mesh = img.mesh
    _check_bounds(img.all_bounds, intr, cfg)
    home = mesh.home
    pose = (torch.eye(4, dtype=torch.float32, device=home) if init_pose is None
            else const(init_pose, home))
    pose_on, pose_inv_on = On(pose), On(lie.se3_inverse(pose))
    pres = _preprocess(frame, intr, cfg)
    meas, packed, ok = [], [], []
    for (a, _), (_, pre, curv, _), rgb in zip(img.bounds, pres, frame.rgb.parts):
        conf = preprocess.confidence_map(pre, curv, intr, cfg, weighting=1.0, row0=a)
        m = sm.measurement_from_preprocess(pre, curv, rgb, conf)
        meas.append(m)
        packed.append(sm._pack_frame(m, pose_on(rgb.device), 0, 1))
        ok.append(sm._measurement_valid(m, cfg).reshape(-1))
    every, mine = _map_layout(mesh, cfg.map_capacity)
    empty = [sm._empty_rows(hi - lo, d) for (lo, hi), d in zip(mine, mesh.devices)]
    data = ShardedRows(empty, mine, cfg.map_capacity, mesh, all_bounds=every)
    w = intr.width
    pix = ShardedRows(packed, [(a * w, b * w) for a, b in img.bounds], intr.height * w, mesh,
                      all_bounds=[(a * w, b * w) for a, b in img.all_bounds])
    S = min(intr.height * w, cfg.map_capacity)
    zero = torch.zeros((), dtype=torch.int32, device=home)
    parts, count, _, _ = _append(empty, data, zero, pix, ok, S)
    data = data.like(parts)
    idx = render_index(data, pose_inv_on, intr)
    attr_ext = _attr_slabs(data, img.like([i[a:b] for i, (a, b) in zip(idx, img.bounds)]),
                           pose_inv_on, cfg)
    filled = []
    for (a, b), (ae, _, s0), (_, pre, curv, _), m, rgb in zip(img.bounds, attr_ext, pres, meas,
                                                              frame.rgb.parts):
        pred = _predict_hrbf_slab(ae, s0, a, b, pose_inv_on(rgb.device), intr, cfg)
        filled.append(raycast.fill_in(pred, pre.vertex_filtered, pre.normal, pre.radius, rgb,
                                      m.conf, curv.k1, curv.k2, cfg))
    zero_f = torch.zeros((), dtype=torch.float32, device=home)
    return _state(data, count, pose[:3, :3], pose[:3, 3], 1, 0, pres, filled,
                  torch.ones((cfg.max_submaps,), dtype=torch.bool, device=home), zero_f, zero_f,
                  img, intr, mesh)


def _attr_slabs(data: ShardedRows, idx: ShardedRows, pose_inv: On, cfg: SLAMConfig) -> list:
    """Per image shard: (the extended attr image of its rows and the halo
    the ray cast reads, that slab's index map, its first row)."""
    halo = max(cfg.predict_window_multiplier, 1)
    slabs = idx.slabs(halo, halo)
    rows = data.gather_rows([ids.reshape(-1) for ids, _ in slabs])
    return [(sm.attr_from_rows(r, ids.reshape(-1) >= 0, pose_inv(ids.device), ids.shape,
                               extended=True), ids, s0) for r, (ids, s0) in zip(rows, slabs)]


def step(state: slam.SLAMState, frame: slam.FrameInput, intr: CameraIntrinsics,
         cfg: SLAMConfig, fixed_pose: torch.Tensor | None = None) -> slam.SLAMState:
    """``slam.step`` on a sharded state (branch for branch); ``frame``
    sharded as the state's images, or whole (it is then split)."""
    mesh = state.map.data.mesh
    img = state.pred_vertex
    _check_bounds(img.all_bounds, intr, cfg)
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
    weighting = On(torch.clamp(1.0 - (dt * 5.0 + w_rot * 2.0), 0.25, 1.0))
    pose_on, pose_inv_on = On(pose), On(pose_inv)
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
                             state.submap_idx, On(act_cur))

    # one extended attr render after fuse (each image shard's rows and the
    # halo the ray cast reads), shared by clean and prediction
    attr_ext = _attr_slabs(data, idx2, pose_inv_on, cfg)
    data, count, remap = clean_with_remap(data, count, pose_on, attr_ext, img, intr, cfg, time)

    cp = max(cfg.clean_compact_period, 1)
    cw = max(cfg.clean_crowd_period, 1)
    pixel_remap = (cfg.clean_pixel_remap and cp > 1 and cw > 1 and time % cp != 0
                   and time % cw != 0)
    splat = cfg.raycast_period > 1 and time % cfg.raycast_period != 0
    if pixel_remap:
        idx3 = [torch.where((ids >= 0) & sm.pixel_keep_mask(ae, cfg, time), ids, -1)
                for ae, ids, _ in attr_ext]
    else:
        idx3 = [torch.where(ids >= 0, r, -1) for (_, ids, _), r in
                zip(attr_ext, remap.gather_rows([ids for _, ids, _ in attr_ext]))]
    own = [x[a - s0:b - s0] for x, (a, b), (_, _, s0) in zip(idx3, img.bounds, attr_ext)]
    if splat:
        own_rows = data.gather_rows([x.reshape(-1) for x in own])
    filled_parts = []
    for k, ((a, b), (ae, ids, s0)) in enumerate(zip(img.bounds, attr_ext)):
        dev = ids.device
        if splat:
            own_ids = own[k].reshape(-1)
            pred = raycast.splat_from_rows(own_rows[k], own_ids >= 0, pose_inv_on(dev), cfg,
                                           (b - a, intr.width))
        else:
            pred_attr = torch.where((idx3[k] >= 0)[..., None], ae, 0.0)
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
    for (a, b), (depth, s0), rgb in zip(frame.depth.bounds, frame.depth.slabs(halo, halo),
                                        frame.rgb.parts):
        depth_f = (preprocess.bilateral_filter(depth, cfg, pallas_form=cfg.use_pallas)
                   if cfg.use_bilateral_filter else depth)
        pre = preprocess.vertex_normal_radius(depth, depth_f, intr, cfg, row0=s0)
        curv = preprocess.curvature_gradient(pre, intr, cfg)
        pre = preprocess.update_normal_rad(pre, curv, cfg)
        i0, i1 = a - s0, b - s0
        out.append((depth_f[i0:i1], _rows(pre, i0, i1), _rows(curv, i0, i1),
                    pyramid.rgb_to_intensity(rgb)))
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

def render_index(data: ShardedRows, pose_inv: On, intr: CameraIntrinsics,
                 active=None, conf_threshold: float | None = None) -> list:
    """``surfel_map.render_index`` of a sharded map: the whole (H, W)
    index map on each local shard's device (one tensor per device)."""
    mesh = data.mesh
    tg = [sm.render_targets(part, pose_inv(part.device), intr,
                            None if active is None else active[k], conf_threshold)
          for k, part in enumerate(data.parts)]
    ids = _ids(data.bounds, mesh.devices)
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


def fuse(data: ShardedRows, count: torch.Tensor, meas: list, pose: On, idx: list,
         img: ShardedRows, intr: CameraIntrinsics, cfg: SLAMConfig, time: int,
         submap_idx: int, act: On):
    """``surfel_map.fuse`` over a sharded map: ``meas`` each image shard's
    ``FrameMeasurement`` of its rows, ``idx`` the whole index map on each
    shard's device.  Returns (map rows, count, updated index map split as
    ``img``)."""
    mesh = data.mesh
    h, w = intr.height, intr.width
    hq, wq = h // 2, w // 2
    n_cap = data.total
    par = int(time) % 2
    pose_inv = On(lie.se3_inverse(pose.x))

    def quarter_rows(a, b):
        """(first, end) checkerboard row of image rows [a, b)."""
        return max((a - par + 1) // 2, 0), min(hq, (b - par + 1) // 2)

    # per image shard: its checkerboard pixels and their candidates' rows
    win = []
    for k, (a, b) in enumerate(img.bounds):
        yq0, yq1 = quarter_rows(a, b)
        nq = max(yq1 - yq0, 0)
        y_first = 2 * yq0 + par
        ys0, ys1 = max(y_first - 1, 0), min(y_first + 2 * nq, h)
        win.append((yq0, nq, y_first, idx[k][ys0:ys1], ys0))
    cand_rows = data.gather_rows([ids.reshape(-1) for *_, ids, _ in win])
    px = []
    for k, ((a, b), (yq0, nq, y_first, ids, ys0), rows) in enumerate(zip(img.bounds, win,
                                                                        cand_rows)):
        dev = img.parts[k].device
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
        px.append(dict(p0=yq0 * wq, n=n_pix, nq=nq, m0=m0, ok=ok_pix, best=best_id,
                       new_rows=new_rows, patch=patch, cand=cand, meas_q=meas_q))
    qb = [quarter_rows(a, b) for a, b in img.all_bounds]
    new_rows = ShardedRows([q["new_rows"] for q in px], [(q["p0"], q["p0"] + q["n"]) for q in px],
                           hq * wq, mesh, all_bounds=[(y0 * wq, max(y1, y0) * wq)
                                                      for y0, y1 in qb])

    # each map row's winning pixel (a scatter-min over the map rows, merged
    # by pmin); the winner's measurement moves to the shard that owns the
    # row, which merges it
    matched = [q["ok"] & (q["best"] >= 0) for q in px]
    pix = [torch.arange(q["p0"], q["p0"] + q["n"], dtype=torch.int32, device=m.device)
           for q, m in zip(px, matched)]
    wt = mesh.pmin([[sm.winner_table(torch.where(m, q["best"], n_cap), m, p, n_cap)]
                    for q, m, p in zip(px, matched, pix)])
    won = [torch.where(m & (t[0][torch.where(m, q["best"], 0).long()] == p), q["best"], -1)
           for q, m, p, t in zip(px, matched, pix, wt)]
    wtbl = [t[0][lo:hi] for t, (lo, hi) in zip(wt, data.bounds)]
    merged = [sm.merge_rows(part, r, wb != _INT_MAX)
              for part, r, wb in zip(data.parts, new_rows.move_rows(won, data).parts, wtbl)]

    # new surfels: count + rank over the whole frame in pixel order
    S = min(cfg.new_surfels_capacity, hq * wq, n_cap)
    out, count, appended, new_id = _append(merged, data, count, new_rows,
                                           [q["ok"] & (q["best"] < 0) for q in px], S)
    idx2 = []
    for k, ((a, b), q) in enumerate(zip(img.bounds, px)):
        upd = sm.fuse_index_update(appended[k], new_id[k], q["cand"], q["meas_q"],
                                   q["patch"]).reshape(q["nq"], wq)
        own = idx[k][a:b].clone()
        own[q["m0"]:q["m0"] + 2 * q["nq"]:2, par:par + 2 * wq:2] = upd
        idx2.append(own)
    return data.like(out), count, img.like(idx2)


def clean_with_remap(data: ShardedRows, count: torch.Tensor, pose: On, attr_ext: list,
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
    for part, k, ids in zip(data.parts, keep, _ids(data.bounds, mesh.devices)):
        part = part.clone()
        part[:, sm.VALID] = torch.where(k, part[:, sm.VALID], 0.0)
        parts.append(part)
        remap.append(torch.where(k, ids, -1))
    return data.like(parts), count, data.like(remap)


def compact(data: ShardedRows, keep: list):
    """``surfel_map.compact`` across shards: every row moves to the shard
    that owns its new position (kept rows first, then the killed ones,
    each in the old order).  Returns (rows, count, each kept row's new
    position per shard)."""
    pos, rank, n_keep = _order(data.mesh, keep)
    out = []
    for rows, (lo, hi) in zip(data.move_rows(pos, data).parts, data.bounds):
        rows[:, sm.VALID] = (torch.arange(lo, hi, device=rows.device)
                             < n_keep.to(rows.device)).to(torch.float32)
        out.append(rows)
    return data.like(out), n_keep, rank


def per_shard(m: sm.SurfelMap, fn) -> sm.SurfelMap:
    """A row-local map op (``SurfelMap -> SurfelMap``) on each shard of a
    sharded map, or on a whole map."""
    if not isinstance(m.data, ShardedRows):
        return fn(m)
    parts = [fn(sm.SurfelMap(p, m.count.to(p.device))).data for p in m.data.parts]
    return sm.SurfelMap(m.data.like(parts), m.count)


def refresh_active_channel(m: sm.SurfelMap, submap_active: torch.Tensor) -> sm.SurfelMap:
    on = On(submap_active)
    return per_shard(m, lambda x: sm.refresh_active_channel(x, on(x.data.device)))


def apply_submap_deltas(m: sm.SurfelMap, deltas: torch.Tensor) -> sm.SurfelMap:
    on = On(deltas)
    return per_shard(m, lambda x: sm.apply_submap_deltas(x, on(x.data.device)))


def whole_map(m: sm.SurfelMap) -> sm.SurfelMap:
    """A sharded map gathered onto its mesh's first device (exports)."""
    return sm.SurfelMap(gather(m.data), m.count)


def grow(m: sm.SurfelMap, new_capacity: int) -> sm.SurfelMap:
    """``surfel_map.grow`` of a sharded map, split evenly over the new
    capacity: every row moves to the shard that owns its id in the new
    layout (pristine rows past the old capacity)."""
    data = m.data
    if new_capacity <= data.total:
        return m
    mesh = data.mesh
    every, mine = _map_layout(mesh, new_capacity)
    pristine = ShardedRows([sm._empty_rows(hi - lo, d) for (lo, hi), d in zip(mine, mesh.devices)],
                           mine, new_capacity, mesh, all_bounds=every)
    return sm.SurfelMap(data.move_rows(_ids(data.bounds, mesh.devices), pristine), m.count)


def exchange_active(act: sm.SurfelMap, arch: sm.SurfelMap, submap_active: torch.Tensor,
                    time: int, cfg: SLAMConfig):
    """``surfel_map.exchange_active`` with a sharded active map and the
    archive whole on every process: the leave / stay / enter decisions
    per row; the active map's stay rows moved as a compaction moves them
    and its enter rows read from the (local) archive; the leave rows
    all-gathered and written after the archive's kept rows.  Returns
    (active', archive', stats) as the unsharded exchange does; past its
    count the archive's rows are pristine (the unsharded exchange copies
    dead active rows there)."""
    data = act.data
    mesh = data.mesh
    Ca = data.total
    arows = arch.data
    Cr = arows.shape[0]
    ns = submap_active.shape[0]
    t = cfg.curv_valid_threshold
    on = On(submap_active)

    def junk(rows):
        k1, k2 = rows[:, sm.K1], rows[:, sm.K2]
        curv_bad = (k1 < -t) | (k1 > t) | (k2 < -t) | (k2 > t)
        unstable = (((float(time) - rows[:, sm.STAMP]) > cfg.unstable_time_limit)
                    & (rows[:, sm.CONF] < cfg.confidence_threshold))
        return curv_bad | unstable

    on_a, leave = [], []
    for part in data.parts:
        va = part[:, sm.VALID] > 0
        stays = va & on(part.device)[sm._submap_of(part, ns)]
        on_a.append(stays)
        leave.append(va & ~stays & ~junk(part))
    vr = arows[:, sm.VALID] > 0
    enter = vr & submap_active[sm._submap_of(arows, ns)] & ~junk(arows)
    keep_r = vr & ~enter

    # new active = [stay-compacted | enter-compacted]
    pos, _, n_stay = _order(mesh, on_a)
    enter_ids = sm._stable_prefix(enter)[:Ca]
    n_enter_all = enter.sum(dtype=torch.int32)
    n_enter = torch.minimum(torch.clamp(n_enter_all, max=Ca), Ca - n_stay)
    n_act = n_stay + n_enter
    L = enter_ids.shape[0]
    parts = []
    for rows, g in zip(data.move_rows(pos, data).parts, _ids(data.bounds, mesh.devices)):
        dev = rows.device
        at = g - n_stay.to(dev)
        from_arch = (at >= 0) & (at < L)
        entered = arows[enter_ids[torch.clamp(at, 0, L - 1).to(arows.device).long()]].to(dev)
        rows = torch.where(from_arch[:, None], entered, rows)
        valid = g < n_act.to(dev)
        rows[:, sm.VALID] = valid.to(torch.float32)
        rows[:, sm.ACT] = (on(dev)[sm._submap_of(rows, ns)] & valid).to(torch.float32)
        parts.append(rows)

    # new archive = [keep-compacted | leave-compacted]
    keep_blk = arows[sm._stable_prefix(keep_r)]
    n_keep = keep_r.sum(dtype=torch.int32)
    leave_blk = mesh.all_gather([p[sm._stable_prefix(lv)[:int(lv.sum())]]
                                 for p, lv in zip(data.parts, leave)])[0].to(arows.device)
    n_leave = leave_blk.shape[0]
    arch_data = sm._place(torch.cat([keep_blk, keep_blk.new_zeros((n_leave, keep_blk.shape[1]))]),
                          n_keep, leave_blk)[:Cr]
    n_arch = torch.clamp(n_keep + n_leave, max=Cr)
    live = torch.arange(Cr, dtype=torch.int32, device=arows.device) < n_arch
    arch_data = torch.where(live[:, None], arch_data, sm._empty_rows(1, arows.device))
    arch_data[:, sm.VALID] = live.to(torch.float32)

    dropped = (n_enter_all - n_enter.to(arows.device)) + (n_keep + n_leave - n_arch)
    stats = torch.stack([n_act.to(arows.device), n_arch, dropped]).to(torch.int32)
    return (sm.SurfelMap(data.like(parts), n_act.to(torch.int32)),
            sm.SurfelMap(arch_data, n_arch.to(torch.int32)), stats)


# --------------------------------------------------------------------------- #
# tracking
# --------------------------------------------------------------------------- #

def track(state: slam.SLAMState, pres: list, intr: CameraIntrinsics,
          cfg: SLAMConfig) -> odometry.TrackResult:
    """``slam.step``'s tracking on a sharded state (every tracking
    setting); ``pres`` the per-shard preprocess outputs."""
    return odometry.track_levels(state.R, state.t, _pyramids(state, pres, cfg),
                                 state.map.data.mesh, intr, cfg)


def _pyramids(state: slam.SLAMState, pres: list, cfg: SLAMConfig) -> list:
    """``odometry.build_inputs``' pyramids per shard: one
    ``odometry.Level`` per pyramid level, each shard's rows of every
    tracking input (a 2-row halo at each level for the 5x5 filters)."""
    img = state.pred_vertex
    mesh = img.mesh
    R, t = On(state.R), On(state.t)
    curv = cfg.icp_use_correspondence_search
    lvl0 = []
    for k, (depth_f, pre, cv, intensity) in enumerate(pres):
        dev = img.parts[k].device
        pv, pn = state.pred_vertex.parts[k], state.pred_normal.parts[k]
        valid = pv[..., 2] > 0
        lvl0.append({
            "deps": torch.stack([depth_f, torch.where(valid, pv[..., 2], 0.0)], dim=-1),
            "ints": torch.stack([intensity, state.pred_intensity.parts[k],
                                 state.prev_intensity.parts[k]], dim=-1),
            "vmaps": [pre.vertex_filtered, torch.where(
                valid[..., None], icp_ops.mat3_apply(pv, R(dev)) + t(dev), 0.0)],
            "nmaps": [pre.normal, torch.where(valid[..., None], icp_ops.mat3_apply(pn, R(dev)),
                                              0.0)],
            "scalars": [state.pred_icp_weight.parts[k]] + (
                [cv.k1, cv.k2, state.pred_k1.parts[k], state.pred_k2.parts[k]] if curv else []),
        })
    levels = [(lvl0, list(img.all_bounds), img.total)]
    for _ in range(cfg.num_pyramid_levels - 1):
        shards, bounds, height = levels[-1]
        h2 = height // 2
        nb = [(a // 2, b // 2) for a, b in bounds]
        nb[-1] = (nb[-1][0], h2)

        def rows(key):
            return ShardedRows([s[key] for s in shards], mesh.local(bounds), height, mesh,
                               all_bounds=bounds).slabs(2, 2)

        nxt = []
        for (a, b), (n0, n1), s, (d, s0), (i, _) in zip(
                mesh.local(bounds), mesh.local(nb), shards, rows("deps"), rows("ints")):
            r0 = (a - s0) // 2
            vms, nms, scs = pyramid.resize_maps_fused(s["vmaps"], s["nmaps"], s["scalars"])
            nxt.append({"deps": pyramid.pyr_down_depth_mc(d)[r0:r0 + n1 - n0],
                        "ints": pyramid.pyr_down_intensity_mc(i)[r0:r0 + n1 - n0],
                        "vmaps": vms, "nmaps": nms, "scalars": scs})
        levels.append((nxt, nb, h2))
    out = []
    for lvl, (shards, bounds, height) in enumerate(levels):
        named = []
        for k, s in enumerate(shards):
            d = {"next_depth": s["deps"][..., 0], "last_depth": s["deps"][..., 1],
                 "next_int": s["ints"][..., 0], "last_int": s["ints"][..., 1],
                 "prev_int": s["ints"][..., 2], "next_vmap": s["vmaps"][0],
                 "last_vmap": s["vmaps"][1], "next_nmap": s["nmaps"][0],
                 "last_nmap": s["nmaps"][1], "icp_weight": s["scalars"][0]}
            if curv:
                d.update(zip(("next_k1", "next_k2", "last_k1", "last_k2"), s["scalars"][1:5]))
            if lvl == 0 and cfg.tracking_topk > 0:
                d["sal_k1"], d["sal_k2"] = pres[k][2].k1, pres[k][2].k2
            named.append(d)
        out.append(odometry.Level(named, bounds, height))
    return out
