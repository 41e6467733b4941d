"""The child side of the port's multi-process tests, kept free of JAX so
that each spawned process starts in about two seconds (``conftest.py``,
which imports JAX, is not loaded in a child).

``make_problem`` is ``tests/test_ba.py::_make_problem``'s construction from
a numpy seed (cameras on a small arc, every camera sees every landmark,
the first two fixed); ``solve_rank`` is one process of a multi-process
solve of it.  ``collectives_rank`` runs the mesh's collectives,
``dense_rank`` the row-sharded dense step, and ``full_sync_rank``,
``full_async_rank``, ``full_resume_rank`` and ``full_mismatch_rank``
``FullSLAM`` over a group (``tests/test_torch_full_slam_group.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from hrbffusion3d_tpu_torch.backend import ba
from hrbffusion3d_tpu_torch.core import lie
from hrbffusion3d_tpu_torch.parallel import dist_ba, multihost, sharding
from hrbffusion3d_tpu_torch.utils import checkpoint


def make_problem(seed=4, n_cams=5, n_lms=64, noise=0.003, perturb=0.05):
    """(problem, ground-truth cameras, ground-truth landmarks)."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0], xi[:, 1], xi[:, 4] = 0.1, 0.02, 0.05
    gt_cams = lie.se3_exp(torch.from_numpy(xi * np.arange(n_cams, dtype=np.float32)[:, None]))
    gt_points = torch.from_numpy(
        rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 3.5], (n_lms, 3)).astype(np.float32))
    cam_idx = torch.arange(n_cams).repeat_interleave(n_lms)
    lm_idx = torch.arange(n_lms).repeat(n_cams)
    T = gt_cams[cam_idx]
    obs = torch.einsum("eij,ej->ei", T[:, :3, :3], gt_points[lm_idx]) + T[:, :3, 3]
    obs = obs + torch.from_numpy((noise * rng.standard_normal(obs.shape)).astype(np.float32))
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[:2] = True
    dx = torch.from_numpy((perturb * rng.standard_normal((n_cams, 6))).astype(np.float32))
    dx[fixed] = 0.0
    prob = ba.BAProblem(
        cams=lie.se3_exp(dx) @ gt_cams,
        points=gt_points + torch.from_numpy(
            (perturb * rng.standard_normal((n_lms, 3))).astype(np.float32)),
        obs=obs, cam_idx=cam_idx, lm_idx=lm_idx,
        info=ba.depth_information(obs, 500.0, 500.0),
        edge_valid=torch.ones(obs.shape[0]), fixed=fixed)
    return prob, gt_cams, gt_points


def solve_rank(addr, n_processes, rank, local_shards, out_path):
    """One process of a ``gloo`` solve of ``make_problem()`` on the CPU,
    ``local_shards`` shards per process; process 0 writes the cameras, all
    landmarks and chi2 to ``out_path`` (.npz)."""
    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        prob = make_problem()[0]
        sb = multihost.globalize_sharded_ba(dist_ba.partition_problem(prob, mesh.size), mesh)
        cams, points, chi = dist_ba.make_optimizer(mesh)(sb)
        pts = dist_ba.gather_points(points, prob.points.shape[0], mesh)
        if multihost.is_coordinator():
            np.savez(out_path, cams=cams.numpy(), points=pts, chi=chi.numpy())
    finally:
        torch.distributed.destroy_process_group()


def shard_values(k: int):
    """Global shard k's inputs to the collectives test: a float block of
    k + 1 rows, an int vector and an int count, all from a seed."""
    rng = np.random.default_rng(100 + k)
    return (torch.from_numpy(rng.standard_normal((k + 1, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(-50, 50, (6,)).astype(np.int32)),
            torch.tensor(int(rng.integers(0, 20)), dtype=torch.int32))


# per global shard: float32 values whose sum depends on its grouping: in
# the global shard order 1e8 + 1 + 1 - 1e8 + 1 + 1 = 2 (each + 1 on 1e8
# rounds away), each process's three added first 1e8 + (-1e8) = 0
CANCELLING = (1e8, 1.0, 1.0, -1e8, 1.0, 1.0)


def move_positions(n_shards: int):
    """(the global rows of ``shard_values``' float blocks of ``n_shards``
    shards, each block's rows' new positions: a permutation from a seed)."""
    n = sum(k + 1 for k in range(n_shards))
    perm = torch.from_numpy(np.random.default_rng(7).permutation(n).astype(np.int32))
    starts = np.cumsum([0] + [k + 1 for k in range(n_shards)])
    return n, [perm[starts[k]:starts[k + 1]] for k in range(n_shards)]


def collectives_rank(addr, n_processes, rank, local_shards, out_path):
    """One process of a ``gloo`` run of the mesh's collectives on the CPU,
    ``local_shards`` shards per process; process 0 writes what its first
    shard got (and its shards' rows after ``move_rows``, with the rows it
    received from the other process) to ``out_path`` (.npz), and every
    process checks that its shards got the same."""
    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        vals = [shard_values(mesh.first_shard + i) for i in range(local_shards)]
        psum = mesh.psum([[v[1].to(torch.float32)] for v in vals])
        exact = mesh.psum([[torch.tensor([CANCELLING[mesh.first_shard + i]])]
                           for i in range(local_shards)])
        pmin = mesh.pmin([[v[1]] for v in vals])
        gathered = mesh.all_gather([v[0] for v in vals])
        offs, total = mesh.exclusive_scan([v[2] for v in vals])
        n_rows, pos = move_positions(mesh.size)
        new_bounds = sharding.row_bounds(n_rows, mesh.size)
        moved = mesh.move_rows([v[0] for v in vals], mesh.local(pos), new_bounds,
                               [torch.zeros(b - a, 3) for a, b in mesh.local(new_bounds)])
        for i in range(local_shards):
            assert torch.equal(psum[i][0], psum[0][0]) and torch.equal(pmin[i][0], pmin[0][0])
            assert torch.equal(exact[i][0], exact[0][0])
            assert torch.equal(gathered[i], gathered[0]) and torch.equal(total[i], total[0])
        if multihost.is_coordinator():
            np.savez(out_path, psum=psum[0][0].numpy(), exact=exact[0][0].numpy(),
                     pmin=pmin[0][0].numpy(),
                     gathered=gathered[0].numpy(), total=total[0].numpy(),
                     offsets=torch.stack(offs).numpy(), moved=torch.cat(moved).numpy(),
                     received_rows=mesh.received_rows)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------- #
# the row-sharded dense step over a process group
# --------------------------------------------------------------------------- #

DENSE_MODES = {"default": {}, "topk": {"tracking_topk": 768, "tracking_topk_full_iters": 1}}


def dense_setup(mode):
    """(intrinsics, config, poses, frames, archive) of the group runs: a
    64x48 orbit, compaction and crowd rules every second frame, and an
    archive whose valid rows belong to submap 1 (``dense_run`` exchanges
    with submap 0 inactive, so the active rows leave and these enter)."""
    import dataclasses

    from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
    from hrbffusion3d_tpu_torch.eval import synth
    from hrbffusion3d_tpu_torch.map import surfel_map as sm
    from hrbffusion3d_tpu_torch.pipeline import slam

    intr = CameraIntrinsics(fx=52.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
    cfg = small_test_config(map_capacity=1 << 12, new_surfels_capacity=1 << 10,
                            pyramid_iterations=(2, 1, 1), so3_iterations=1,
                            predict_conf_threshold=0.2, clean_compact_period=2,
                            clean_crowd_period=2, curv_window=2, max_submaps=4)
    cfg = dataclasses.replace(cfg, **DENSE_MODES[mode])
    poses = synth.orbit_trajectory(4, angle_per_frame=0.01)
    room = synth.default_room("cpu")
    frames = [slam.FrameInput(*synth.render_frame(room, p, intr)) for p in poses]
    boot = slam.bootstrap(frames[1], intr, cfg, init_pose=poses[1])
    arch = torch.cat([boot.map.data[:1500], sm._empty_rows((1 << 13) - 1500, "cpu")])
    arch[:, sm.SUBMAP] = 1.0
    archive = sm.SurfelMap(arch, torch.tensor(1500, dtype=torch.int32))
    return intr, cfg, poses, frames, archive


def dense_run(mesh, mode):
    """bootstrap and three steps on ``mesh``: a tracked step on a
    compaction and crowd frame, ``grow`` to twice the capacity, a tracked
    step, ``exchange_active`` against the archive, a replayed step on a
    compaction and crowd frame.  Returns (state, archive, stats)."""
    import dataclasses

    from hrbffusion3d_tpu_torch.parallel import sharded_step, sharding
    from hrbffusion3d_tpu_torch.pipeline import slam

    intr, cfg, poses, frames, archive = dense_setup(mode)
    st = slam.bootstrap(sharding.shard_frame(frames[0], mesh, cfg), intr, cfg,
                        init_pose=poses[0])
    st = slam.step(st, frames[1], intr, cfg)
    cfg = dataclasses.replace(cfg, map_capacity=2 * cfg.map_capacity)
    st = st._replace(map=sharded_step.grow(st.map, cfg.map_capacity))
    st = slam.step(st, frames[2], intr, cfg)
    active = torch.tensor([False, True, True, True])
    act, arch, stats = sharded_step.exchange_active(st.map, archive, active, st.time, cfg)
    st = slam.step(st._replace(map=act), frames[3], intr, cfg, fixed_pose=poses[3])
    return st, arch, stats


def dense_rows(state, archive, stats) -> dict:
    """This process's rows of a sharded state (each field's local parts in
    shard order), with the replicated fields, the archive and the stats."""
    from hrbffusion3d_tpu_torch.pipeline import slam

    out = {"map": torch.cat(state.map.data.parts).numpy(),
           "count": state.map.count.numpy(), "archive": archive.data.numpy(),
           "archive_count": archive.count.numpy(), "stats": stats.numpy(),
           "devices": np.array([str(p.device) for p in state.map.data.parts])}
    for name in slam.SLAMState._fields:
        x = getattr(state, name)
        if hasattr(x, "parts"):
            out[name] = torch.cat(x.parts).numpy()
        elif isinstance(x, torch.Tensor):
            out[name] = x.numpy()
    return out


def _log_moves(mesh) -> list:
    """Wraps ``mesh.move_rows`` so that each call appends [the rows it
    brought from other processes, the rows of this process that left for
    another one, the rows this process holds in the new layout] to the
    list returned."""
    log, move = [], mesh.move_rows
    n = len(mesh.devices)

    def logged(parts, pos, bounds, into):
        before = mesh.received_rows
        mine = mesh.local(bounds)
        lo, hi = mine[0][0], mine[-1][1]
        p = torch.cat(list(pos))
        left = int(((p >= 0) & ((p < lo) | (p >= hi))).sum())
        out = move(parts, pos, bounds, into)
        log.append([mesh.received_rows - before, left, hi - lo])
        assert len(bounds) == n * mesh.n_ranks
        return out

    mesh.move_rows = logged
    return log


def dense_rank(addr, n_processes, rank, layouts, modes, out_dir):
    """One process of a ``gloo`` group running ``dense_run`` for each mode
    on ``global_mesh(local_shards, two_level)`` on the CPU for each
    ``(local_shards, two_level)`` of ``layouts``; it writes its rows to
    ``out_dir/<local_shards>_<mode>_<rank>.npz`` with its log of the row
    moves (``_log_moves``), then, outside the group, the whole rows of the
    in-process mesh of the same shard count for its share of the (layout,
    mode) pairs to ``out_dir/<local_shards>_<mode>_ref.npz``."""
    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        for local_shards, two_level in layouts:
            mesh = multihost.global_mesh(local_shards=local_shards, device="cpu",
                                         two_level=two_level)
            for mode in modes:
                log = _log_moves(mesh)
                rows = dense_rows(*dense_run(mesh, mode))
                np.savez(f"{out_dir}/{local_shards}_{mode}_{rank}.npz", moves=np.array(log),
                         **rows)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    pairs = [(k, mode) for k, _ in layouts for mode in modes]
    for local_shards, mode in pairs[rank::n_processes]:
        local = sharding.make_mesh(n_processes * local_shards, devices=["cpu"])
        np.savez(f"{out_dir}/{local_shards}_{mode}_ref.npz",
                 **dense_rows(*dense_run(local, mode)))


# --------------------------------------------------------------------------- #
# FullSLAM over a process group
# --------------------------------------------------------------------------- #

# a keyframe every 4 frames; 32 features, so that keyframes share fewer than
# 15 landmarks and the older submaps leave the active window (rows move to
# the archive at the exchanges)
FULL_FRAMES, FULL_SPLIT = 13, 8
FULL_BACKEND = dict(fast_threshold=8.0, n_features=32)


def full_setup():
    """(intrinsics, config, ground-truth poses, frames) of the group runs:
    ``tests/test_torch_full_slam_mesh.py``'s protocol (13 frames of the
    orbit at 128x96, a keyframe every 4 frames) rendered by the port's
    ``eval/synth``, with the active-window / archive split."""
    from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
    from hrbffusion3d_tpu_torch.eval import synth

    intr = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
    cfg = small_test_config(map_capacity=1 << 14, pyramid_iterations=(4, 3, 2),
                            so3_iterations=4, predict_conf_threshold=0.2, keyframe_period=4,
                            active_capacity=1 << 14, archive_capacity=1 << 15)
    gt = synth.orbit_trajectory(FULL_FRAMES, angle_per_frame=0.004)
    room = synth.default_room("cpu")
    return intr, cfg, gt, [synth.render_frame(room, p, intr) for p in gt]


def full_system(mesh, async_ba=False):
    from hrbffusion3d_tpu_torch.pipeline.full_slam import FullSLAM

    intr, cfg, gt, _ = full_setup()
    return FullSLAM(intr, cfg, init_pose=gt[0], mesh=mesh, async_ba=async_ba,
                    backend_kwargs=FULL_BACKEND, device="cpu")


def full_batch(frames, lo, hi):
    from hrbffusion3d_tpu_torch.pipeline import slam

    return slam.FrameInput(torch.stack([d for d, _ in frames[lo:hi]]),
                           torch.stack([c for _, c in frames[lo:hi]]))


def full_rows(sys_) -> dict:
    """This process's rows of a FullSLAM run: every pose, every keyframe
    pose, its shards' map rows (local parts in shard order) and the map's
    count, the archive, ``archive_dropped``, the loops and the async
    corrections applied (the state's time at each, the keyframe)."""
    m = sys_.state.map
    return dict(poses=sys_.poses(), kf_poses=np.stack([kf.pose for kf in sys_.backend.keyframes]),
                map=torch.cat(m.data.parts).numpy(), count=m.count.numpy(),
                archive=sys_.archive.data.numpy(), archive_count=sys_.archive.count.numpy(),
                archive_dropped=sys_.archive_dropped, loops=np.array(sys_.loop_closures),
                applied=np.array(sys_.async_applied, dtype=np.int64).reshape(-1, 2),
                async_corrections=sys_.async_corrections)


def full_sync_run(mesh) -> dict:
    """The sync protocol through ``process_batch`` in two calls (frames
    0-7, 8-12): the rows of ``full_rows``."""
    frames = full_setup()[3]
    sys_ = full_system(mesh)
    sys_.process_batch(full_batch(frames, 0, FULL_SPLIT))
    sys_.process_batch(full_batch(frames, FULL_SPLIT, FULL_FRAMES))
    return full_rows(sys_)


def full_sync_rank(addr, n_processes, rank, local_shards, out_dir):
    """One process of (a), the sync group run of ``FullSLAM(mesh=
    global_mesh(local_shards))`` on the CPU, checkpointed after frame 8 to
    ``group.ckpt`` (``group.ckpt.done`` written once it is whole); its rows
    go to ``sync_<rank>.npz``."""
    torch.set_num_threads(1)
    ckpt = f"{out_dir}/group.ckpt"
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        frames = full_setup()[3]
        sys_ = full_system(mesh)
        sys_.process_batch(full_batch(frames, 0, FULL_SPLIT))
        checkpoint.save(ckpt, sys_)
        if multihost.is_coordinator():
            open(ckpt + ".done", "w").close()
        sys_.process_batch(full_batch(frames, FULL_SPLIT, FULL_FRAMES))
        np.savez(f"{out_dir}/sync_{rank}.npz", **full_rows(sys_))
    finally:
        torch.distributed.destroy_process_group()


def full_async_rank(addr, n_processes, rank, local_shards, out_dir):
    """One process of (b), the async group run through ``process`` on
    ``local_shards`` shards per process (``async_<rank>.npz``)."""
    from hrbffusion3d_tpu_torch.pipeline import slam

    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        sys_ = full_system(mesh, async_ba=True)
        for i, (d, c) in enumerate(full_setup()[3]):
            sys_.process(slam.FrameInput(d, c), timestamp=float(i))
        sys_.close()
        np.savez(f"{out_dir}/async_{rank}.npz", **full_rows(sys_))
    finally:
        torch.distributed.destroy_process_group()


def full_resume_rank(addr, n_processes, rank, local_shards, out_dir):
    """One process of (c): a new group waits for (a)'s checkpoint, resumes
    it on ``local_shards`` shards per process and runs frames 8-12
    (``resume_<rank>.npz``)."""
    import os
    import time

    torch.set_num_threads(1)
    ckpt = f"{out_dir}/group.ckpt"
    deadline = time.monotonic() + 120.0
    while not os.path.exists(ckpt + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {ckpt}")
        time.sleep(0.05)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        sys_ = checkpoint.load(ckpt, full_system(mesh))
        sys_.process_batch(full_batch(full_setup()[3], FULL_SPLIT, FULL_FRAMES))
        np.savez(f"{out_dir}/resume_{rank}.npz", **full_rows(sys_))
    finally:
        torch.distributed.destroy_process_group()


def full_mismatch_rank(addr, n_processes, rank, local_shards, out_dir):
    """One process of (d): a sync group run over frames 0-4 in which
    process 1's local BA returns deltas moved by 1e-6; each process writes
    the error it raised to ``mismatch_<rank>.txt`` and raises it again, so
    the launch fails."""
    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        sys_ = full_system(mesh)
        if rank == 1:
            local_ba = sys_.backend.local_ba

            def moved():
                deltas = local_ba()
                return None if deltas is None else deltas + np.float32(1e-6)

            sys_.backend.local_ba = moved
        try:
            # the first local BA is at the keyframe of frame 4
            sys_.process_batch(full_batch(full_setup()[3], 0, 5))
        except RuntimeError as e:
            with open(f"{out_dir}/mismatch_{rank}.txt", "w") as f:
                f.write(str(e))
            raise
    finally:
        torch.distributed.destroy_process_group()
