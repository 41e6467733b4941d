"""The child side of the port's multi-process BA tests, kept free of JAX so
that each spawned process starts in about two seconds (``conftest.py``,
which imports JAX, is not loaded in a child).

``make_problem`` is ``tests/test_ba.py::_make_problem``'s construction from
a numpy seed (cameras on a small arc, every camera sees every landmark,
the first two fixed); ``solve_rank`` is one process of a multi-process
solve of it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from hrbffusion3d_tpu_torch.backend import ba
from hrbffusion3d_tpu_torch.core import lie
from hrbffusion3d_tpu_torch.parallel import dist_ba, multihost


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


def collectives_rank(addr, n_processes, rank, local_shards, out_path):
    """One process of a ``gloo`` run of the mesh's collectives on the CPU,
    ``local_shards`` shards per process; process 0 writes what its first
    shard got to ``out_path`` (.npz), and every process checks that its
    shards got the same."""
    torch.set_num_threads(1)
    multihost.initialize(addr, n_processes, rank, backend="gloo")
    try:
        mesh = multihost.global_mesh(local_shards=local_shards, device="cpu")
        vals = [shard_values(mesh.first_shard + i) for i in range(local_shards)]
        psum = mesh.psum([[v[1].to(torch.float32)] for v in vals])
        pmin = mesh.pmin([[v[1]] for v in vals])
        gathered = mesh.all_gather([v[0] for v in vals])
        offs, total = mesh.exclusive_scan([v[2] for v in vals])
        for i in range(local_shards):
            assert torch.equal(psum[i][0], psum[0][0]) and torch.equal(pmin[i][0], pmin[0][0])
            assert torch.equal(gathered[i], gathered[0]) and torch.equal(total[i], total[0])
        if multihost.is_coordinator():
            np.savez(out_path, psum=psum[0][0].numpy(), pmin=pmin[0][0].numpy(),
                     gathered=gathered[0].numpy(), total=total[0].numpy(),
                     offsets=torch.stack(offs).numpy())
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
