"""The row-sharded dense state and its pieces (``parallel/sharding.py``,
``parallel/sharded_step.py``), on CPU meshes of 1, 3 and 8 shards at 64x48:

- the mesh's collectives: ``psum`` in shard order, ``pmin`` and the
  exclusive scan exact, ``all_gather`` in shard order;
- shard -> gather round trips of the state, a frame and a frame batch
  (indexed along its time axis), the placements, and the refusal of a
  mesh with no ``"map"`` axis;
- every piece of the sharded step against its unsharded counterpart, bit
  for bit: the preprocess chain on row slabs with their halo; each
  kernel's plain version on a slab with a row offset against the whole
  image; ``render_index`` (both passes: packed key, and z then id);
  ``render_attr_image`` merged by owner; ``fuse``; clean with the
  cross-shard compaction, on a keep mask that moves rows across shard
  boundaries.

No JAX here: the unsharded port is the reference (its own parity files
hold it to JAX)."""

import dataclasses

import numpy as np
import pytest
import torch

from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.core import lie
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.map import surfel_map as sm
from hrbffusion3d_tpu_torch.ops import kernels, preprocess
from hrbffusion3d_tpu_torch.parallel import mesh as mesh_mod, multihost, sharded_step as ss
from hrbffusion3d_tpu_torch.parallel import sharding as sh
from hrbffusion3d_tpu_torch.pipeline import slam

torch.set_num_threads(1)

INTR = CameraIntrinsics(fx=52.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
CFG = small_test_config(map_capacity=1 << 12, new_surfels_capacity=1 << 10,
                        pyramid_iterations=(2, 2, 2), so3_iterations=2,
                        predict_conf_threshold=0.2)


def _equal(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert torch.equal(a, b), (what, (a.double() - b.double()).abs().max().item())


@pytest.fixture(scope="module")
def scene():
    """Three frames of the orbit, the bootstrap state of the first and the
    unsharded step to the second (its index map and post-fuse map)."""
    poses = synth.orbit_trajectory(3, angle_per_frame=0.01)
    room = synth.default_room("cpu")
    frames = [slam.FrameInput(*synth.render_frame(room, p, INTR)) for p in poses]
    state = slam.bootstrap(frames[0], INTR, CFG, init_pose=poses[0])
    return poses, frames, state


@pytest.mark.parametrize("n", [1, 3, 8])
def test_collectives(n):
    mesh = sh.make_mesh(n, devices=["cpu"])
    rng = np.random.default_rng(n)
    f = [torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32)) for _ in range(n)]
    i = [torch.from_numpy(rng.integers(-50, 50, (7,)).astype(np.int32)) for _ in range(n)]
    want = f[0]
    for x in f[1:]:
        want = want + x
    for got in mesh.psum([[x] for x in f]):
        assert torch.equal(got[0], want)
    for got in mesh.pmin([[x, y] for x, y in zip(f, i)]):
        assert torch.equal(got[0], torch.stack(f).amin(0))
        assert torch.equal(got[1], torch.stack(i).amin(0))
    for got in mesh.all_gather(f):
        assert torch.equal(got, torch.cat(f))
    counts = [torch.tensor(int(rng.integers(0, 100)), dtype=torch.int32) for _ in range(n)]
    offs, total = mesh.exclusive_scan(counts)
    run = 0
    for c, o, t in zip(counts, offs, total):
        assert o.dtype == torch.int32 and int(o) == run
        run += int(c)
        assert int(t) == sum(int(x) for x in counts)
    with pytest.raises(ValueError, match="pmin got"):
        mesh.pmin([[f[0]]] * (n + 1))
    # move_rows: a permutation of 20 rows; the same rows into a 40-row
    # layout at 20 + their index, every third one nowhere, over ones
    rows = torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(20).astype(np.int32))
    bounds, wide = sh.row_bounds(20, n), sh.row_bounds(40, n)
    parts = [rows[a:b] for a, b in bounds]
    want = torch.empty_like(rows)
    want[perm.long()] = rows
    got = mesh.move_rows(parts, [perm[a:b] for a, b in bounds], bounds,
                         [torch.zeros(b - a, 3) for a, b in bounds])
    assert [g.shape[0] for g in got] == [b - a for a, b in bounds]
    assert torch.equal(torch.cat(got), want)
    ids = torch.arange(20, dtype=torch.int32)
    to = torch.where(ids % 3 == 0, -1, ids + 20)
    want = torch.ones(40, 3)
    want[20:][ids % 3 != 0] = rows[ids % 3 != 0]
    got = mesh.move_rows(parts, [to[a:b] for a, b in bounds], wide,
                         [torch.ones(b - a, 3) for a, b in wide])
    assert torch.equal(torch.cat(got), want) and mesh.received_rows == 0


def test_row_bounds_and_mesh_axes():
    assert sh.row_bounds(48, 8, 4) == [(0, 8), (8, 16), (16, 24), (24, 32), (32, 36),
                                       (36, 40), (40, 44), (44, 48)]
    assert sh.row_bounds(50, 3, 4) == [(0, 16), (16, 32), (32, 50)]
    assert sh.row_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    with pytest.raises(ValueError, match="cannot be split"):
        sh.row_bounds(8, 3, 4)
    mesh = sh.make_mesh(4, devices=["cpu"])
    assert mesh.axis_names == ("map",) and mesh.shape == {"map": 4}
    two = multihost.global_mesh(local_shards=4, device="cpu", two_level=True)
    assert two.axis_names == ("host", "chip") and two.shape == {"host": 1, "chip": 4}
    with pytest.raises(ValueError, match="axis named 'map'"):
        sh.state_sharding(two)


@pytest.mark.parametrize("n", [3, 8])
def test_round_trips(scene, n):
    poses, frames, state = scene
    mesh = sh.make_mesh(n, devices=["cpu"])
    st = sh.shard_state(state, mesh, CFG)
    assert sh.is_sharded(st) and not sh.is_sharded(state)
    spec = sh.state_sharding(mesh)
    for name, how in zip(slam.SLAMState._fields, spec):
        x = getattr(st, name)
        if name == "map":
            assert isinstance(x.data, sh.ShardedRows) and len(x.data.parts) == n
            assert x.data.bounds == tuple(sh.row_bounds(CFG.map_capacity, n))
        elif how == sh.ROWS:
            assert isinstance(x, sh.ShardedRows) and x.bounds == tuple(sh.row_bounds(48, n, 4))
            assert all(p.device == torch.device("cpu") for p in x.parts)
        else:
            assert not isinstance(x, sh.ShardedRows)
    back = sh.gather_state(st)
    for name in slam.SLAMState._fields:
        a, b = getattr(state, name), getattr(back, name)
        if name == "map":
            _equal(a.data, b.data), _equal(a.count, b.count)
        elif isinstance(a, torch.Tensor):
            _equal(a, b, name)
        else:
            assert a == b
    fr = sh.shard_frame(frames[1], mesh, CFG)
    for a, b in zip(frames[1], sh.gather_frame(fr)):
        _equal(a, b)
    batch = slam.FrameInput(torch.stack([f.depth for f in frames]),
                            torch.stack([f.rgb for f in frames]))
    sb = sh.shard_frame_batch(batch, mesh, CFG)
    assert sb.depth.shape == (3, 48, 64) and sb.rgb.shape == (3, 48, 64, 3)
    _equal(sb.depth.gather(), batch.depth)
    _equal(sb.rgb[1].gather(), batch.rgb[1])
    _equal(sb.depth[1:3].gather(), batch.depth[1:3])
    assert [f.depth.bounds for f in slam._frames_of(sb)] == [fr.depth.bounds] * 3
    with pytest.raises(ValueError, match="sharded already"):
        sh.shard_state(st, mesh, CFG)


@pytest.mark.parametrize("n", [3, 8])
def test_preprocess_on_slabs(scene, n):
    """Each shard's rows of the chain, from its rows and the halo, equal the
    whole image's (also with central-difference normals)."""
    _, frames, _ = scene
    for cfg in (CFG, dataclasses.replace(CFG, normal_pca=False)):
        whole = slam._preprocess(frames[1], INTR, cfg)
        fr = sh.shard_frame(frames[1], sh.make_mesh(n, devices=["cpu"]), cfg)
        for (a, b), part in zip(fr.depth.bounds, ss._preprocess(fr, INTR, cfg)):
            for w, p in zip(whole, part):
                if isinstance(w, torch.Tensor):
                    _equal(w[a:b], p, "depth/intensity")
                else:
                    for x, y in zip(w, p):
                        _equal(x[a:b], y, type(w).__name__)
            pre, curv = part[1], part[2]
            conf = preprocess.confidence_map(pre, curv, INTR, cfg, weighting=0.7, row0=a)
            _equal(preprocess.confidence_map(whole[1], whole[2], INTR, cfg, weighting=0.7)[a:b],
                   conf, "confidence")


def test_plain_kernels_on_slabs(scene):
    """Each kernel's plain version on a row slab with its halo: the rows it
    owns equal the whole image's (the ray cast's with the slab's output
    rows and first image row)."""
    poses, frames, state = scene
    cfg = dataclasses.replace(CFG, raycast_false_position=3)
    depth = frames[1].depth
    full_f = preprocess.bilateral_filter_ref(depth, cfg)
    pre = preprocess.vertex_normal_radius(depth, full_f, INTR, cfg)
    full_pca = preprocess.normal_pca_ref(pre.vertex_filtered, cfg)
    full_curv = preprocess.curvature_gradient_ref(pre, INTR, cfg)
    pose_inv = lie.se3_inverse(torch.as_tensor(poses[0], dtype=torch.float32))
    idx = sm.render_index(state.map, pose_inv, INTR)
    attr = sm.render_attr_image(state.map, idx, pose_inv)
    attr9 = torch.cat([attr[..., 0:sm.A_RADIUS + 1], attr[..., sm.A_VALID:sm.A_VALID + 1]],
                      dim=-1)
    full_ray = kernels.raycast_core_ref(attr9, INTR, cfg)
    R = cfg.predict_window_multiplier
    for a, b in ((0, 8), (13, 29), (40, 48), (5, 6)):
        lo, hi = max(a - 6, 0), min(b + 6, 48)
        _equal(preprocess.bilateral_filter_ref(depth[lo:hi], cfg)[a - lo:b - lo], full_f[a:b])
        lo, hi = max(a - 3, 0), min(b + 3, 48)
        _equal(preprocess.normal_pca_ref(pre.vertex_filtered[lo:hi], cfg)[a - lo:b - lo],
               full_pca[a:b])
        lo, hi = max(a - cfg.curv_window, 0), min(b + cfg.curv_window, 48)
        part = preprocess.curvature_gradient_ref(ss._rows(pre, lo, hi), INTR, cfg)
        for x, y in zip(part, full_curv):
            _equal(x[a - lo:b - lo], y[a:b], "curvature")
        lo, hi = max(a - R, 0), min(b + R, 48)
        got = kernels.raycast_core_ref(attr9[lo:hi], INTR, cfg, top=a - lo, height=b - a, row0=a)
        for x, y in zip(got, full_ray):
            _equal(x, y[a:b], "raycast")
    assert full_ray[3].float().mean() > 0.5
    with pytest.raises(ValueError, match="do not fit"):
        kernels.raycast_core_ref(attr9[:10], INTR, cfg, top=2, height=9, row0=0)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("keyed", [True, False])
def test_render_index_and_attr(scene, n, keyed, monkeypatch):
    """``render_index`` (the packed-key pass, or the z pass then the id
    pass, forced by lowering the key path's row limit) and the attr image
    merged by owner."""
    poses, _, state = scene
    if not keyed:
        monkeypatch.setattr(sm, "KEY_ROWS", 16)
    mesh = sh.make_mesh(n, devices=["cpu"])
    st = sh.shard_state(state, mesh, CFG)
    pose_inv = lie.se3_inverse(torch.as_tensor(poses[1], dtype=torch.float32))
    want = sm.render_index(state.map, pose_inv, INTR, active=state.map.active)
    got = ss.render_index(st.map.data, mesh_mod.On(pose_inv), INTR,
                          active=[(p[:, sm.VALID] > 0.5) & (p[:, sm.ACT] > 0.5)
                                  for p in st.map.data.parts])
    assert len(got) == n and (want >= 0).float().mean() > 0.5
    for g in got:
        _equal(g, want, "index map")
    ids = want.reshape(-1)
    rows, *others = st.map.data.gather_rows([ids] * n)
    assert all(torch.equal(o, rows) for o in others)
    _equal(sm.attr_from_rows(rows, ids >= 0, pose_inv, want.shape, extended=True),
           sm.render_attr_image(state.map, want, pose_inv, extended=True), "attr")


def _fuse_inputs(scene, n):
    poses, frames, state = scene
    mesh = sh.make_mesh(n, devices=["cpu"])
    st = sh.shard_state(state, mesh, CFG)
    pose = torch.as_tensor(poses[1], dtype=torch.float32)
    pose_inv = lie.se3_inverse(pose)
    depth_f, pre, curv, _ = slam._preprocess(frames[1], INTR, CFG)
    conf = preprocess.confidence_map(pre, curv, INTR, CFG, weighting=0.9)
    meas = sm.measurement_from_preprocess(pre, curv, frames[1].rgb, conf)
    idx = sm.render_index(state.map, pose_inv, INTR, active=state.map.active)
    img = st.pred_vertex
    meas_parts = [sm.FrameMeasurement(*(x[a:b] for x in meas)) for a, b in img.bounds]
    return st, pose, pose_inv, meas, meas_parts, idx, img


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("time", [2, 3])
def test_fuse(scene, n, time):
    """Association, the winner scatter-min and merge on the owning shard,
    the new surfels' cross-shard ranks and the index-map update, on both
    checkerboard parities."""
    _, _, state = scene
    st, pose, _, meas, meas_parts, idx, img = _fuse_inputs(scene, n)
    act = torch.tensor(1.0)
    m, idx2 = sm.fuse(state.map, meas, pose, idx, INTR, CFG, time=time, submap_idx=0, act=act)
    data, count, sidx2 = ss.fuse(st.map.data, st.map.count, meas_parts, mesh_mod.On(pose),
                                 [idx] * n, img, INTR, CFG, time, 0, mesh_mod.On(act))
    assert not torch.equal(m.data, state.map.data)
    _equal(count, m.count, "count")
    _equal(data.gather(), m.data, "map rows")
    _equal(sidx2.gather(), idx2, "index map")


def test_fuse_block_overwrite_at_capacity(scene):
    """The append block at ``clamp(count, 0, capacity - S)`` (here below
    ``count``: the block overwrites live rows, as in the JAX package) and
    its empty tail, across shards."""
    _, _, state = scene
    cfg = dataclasses.replace(CFG, map_capacity=2048, new_surfels_capacity=512)
    small = sm.SurfelMap(state.map.data[:2048].clone(), torch.tensor(1900, dtype=torch.int32))
    st = sh.shard_state(state._replace(map=small), sh.make_mesh(5, devices=["cpu"]), cfg)
    _, pose, _, meas, meas_parts, idx, img = _fuse_inputs(scene, 5)
    act = torch.tensor(1.0)
    m, idx2 = sm.fuse(small, meas, pose, idx, INTR, cfg, time=2, submap_idx=1, act=act)
    data, count, sidx2 = ss.fuse(st.map.data, st.map.count, meas_parts, mesh_mod.On(pose),
                                 [idx] * 5, img, INTR, cfg, 2, 1, mesh_mod.On(act))
    _equal(count, m.count), _equal(data.gather(), m.data), _equal(sidx2.gather(), idx2)


@pytest.mark.parametrize("n", [3, 8])
def test_compaction_across_shards(scene, n):
    """The cross-shard compaction on a keep mask that kills rows in every
    shard (so survivors move to earlier shards), and clean with its remap
    on compaction, tombstone and crowd-rule frames."""
    poses, _, state = scene
    mesh = sh.make_mesh(n, devices=["cpu"])
    st = sh.shard_state(state, mesh, CFG)
    rng = np.random.default_rng(n)
    keep = torch.from_numpy(rng.random(CFG.map_capacity) < 0.6) & state.map.valid
    want = sm.compact(state.map, keep)
    parts = [keep[a:b] for a, b in st.map.data.bounds]
    data, count, rank = ss.compact(st.map.data, parts)
    # the live rows span shards, and the second shard's survivors move into
    # the first
    first = st.map.data.bounds[0][1]
    assert int(state.map.count) > first and int(rank[1][parts[1]].min()) < first
    _equal(count, want.count, "count")
    _equal(data.gather(), want.data, "rows")
    full_rank = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    _equal(torch.cat(rank), full_rank, "ranks")

    pose = torch.as_tensor(poses[1], dtype=torch.float32)
    pose_inv = lie.se3_inverse(pose)
    idx = sm.render_index(state.map, pose_inv, INTR)
    attr = sm.render_attr_image(state.map, idx, pose_inv, extended=True)
    img = st.pred_vertex
    attr_ext = []
    for a, b in img.bounds:
        lo, hi = max(a - 1, 0), min(b + 1, 48)
        attr_ext.append((attr[lo:hi], idx[lo:hi], lo))
    for time, cfg in ((4, dataclasses.replace(CFG, clean_compact_period=4, clean_crowd_period=4,
                                              confidence_threshold=0.5)),
                      (5, dataclasses.replace(CFG, clean_compact_period=4)),
                      (6, dataclasses.replace(CFG, clean_compact_period=3, clean_crowd_period=2,
                                              unstable_time_limit=0))):
        m, remap = sm.clean_with_remap(state.map, pose, idx, INTR, cfg, time,
                                       attr=attr[..., :sm.ATTR_CHANNELS])
        d2, c2, r2 = ss.clean_with_remap(st.map.data, st.map.count, mesh_mod.On(pose), attr_ext,
                                         img, INTR, cfg, time)
        _equal(c2, m.count, f"count at {time}")
        _equal(d2.gather(), m.data, f"rows at {time}")
        _equal(r2.gather(), remap, f"remap at {time}")
    assert int(m.count) < int(state.map.count)
