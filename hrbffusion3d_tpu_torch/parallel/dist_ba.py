"""Distributed bundle adjustment: a landmark-sharded Schur complement whose
reduced camera systems are summed over the mesh (port of
``hrbffusion3d_tpu/parallel/dist_ba.py``).

Each Gauss-Newton iteration:
  1. each shard owns a block of landmarks and every edge that observes
     them, eliminates its landmark blocks (batched 3x3 inverses) and
     builds its partial reduced camera system S_d, gradient rhs_d and
     chi2_d;
  2. ``Mesh.psum`` sums them in the global shard order (the one
     collective: 36 C^2 + 6 C + 1 floats per shard and iteration,
     all-gathered when the mesh spans processes, so a group of processes
     sums as one process with the same shards does);
  3. every device solves the replicated 6C x 6C system (Jacobi-scaled and
     dense, whatever the camera count), and each shard back-substitutes
     its own landmarks.

Cameras are replicated.  Every segment sum inside a shard goes through the
shard's host-built gather-sum plans (``backend/reduce_plan``), so the only
order left to choose is that of the psum, which the mesh fixes: a run
repeats bit for bit.  The arithmetic is the JAX module's, which differs
from ``backend/ba.py`` in two places: the landmark blocks are inverted as
``inv(Hll + (damping + 1e-12) I)``, and the camera diagonal gets Hcc before
the psum and the damping and gauge after it.

Differences from the JAX module: shards are a tuple of per-shard tensors
(no SPMD shape constraint; ``partition_problem`` still pads every shard to
the largest shard's edge count, so the flattened arrays equal JAX's), the
edge routing is a stable sort by owner rather than a loop over the edges,
and the plans are not re-padded to shared shapes (that only kept jit
cache keys stable).  Shards that share a device run one after another.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import ba, reduce_plan as rp
from ..core import lie
from ..utils.tensors import const, einsum, full_float32, host, matmul
from .sharding import Mesh


class Shard(NamedTuple):
    """One shard's landmarks and edges: ``lm_idx`` is the landmark's index
    within the shard; ``plans`` are the shard's reduction plans."""

    points: torch.Tensor      # (Ls,3)
    obs: torch.Tensor         # (Es,3)
    cam_idx: torch.Tensor     # (Es,)
    lm_idx: torch.Tensor      # (Es,) local
    info: torch.Tensor        # (Es,3,3)
    edge_valid: torch.Tensor  # (Es,)
    plans: rp.SchurPlans


class ShardedBA(NamedTuple):
    """A landmark-sharded BA problem: the replicated cameras and gauge, and
    one ``Shard`` per shard (all of the mesh's after ``partition_problem``,
    this process's after ``multihost.globalize_sharded_ba``)."""

    cams: torch.Tensor        # (C,4,4)
    fixed: torch.Tensor       # (C,) bool
    shards: tuple


def partition_problem(prob: ba.BAProblem, n_shards: int) -> ShardedBA:
    """Host side: landmark l goes to shard l // Ls (Ls = ceil(L / n_shards))
    as local landmark l % Ls, and each edge to its landmark's shard, in the
    original edge order; every shard is padded to the largest shard's
    edge count Es with zero-weight edges.  Every edge of ``prob`` counts
    as real in the plans (``pad_problem``'s padding edges too, as in JAX).
    The result lies on the CPU."""
    L = prob.points.shape[0]
    Ls = -(-L // n_shards)
    lm = host(prob.lm_idx).astype(np.int64)
    owner, local = lm // Ls, lm % Ls
    E = lm.shape[0]
    counts = np.bincount(owner, minlength=n_shards)
    Es = int(counts.max()) if E else 1
    order = np.argsort(owner, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = owner[order] * Es + (np.arange(E) - starts[owner[order]])

    def padded(arr):
        out = np.zeros((n_shards * Es,) + arr.shape[1:], arr.dtype)
        out[slot] = arr[order]
        return out.reshape((n_shards, Es) + arr.shape[1:])

    pts = np.zeros((n_shards * Ls, 3), np.float32)
    pts[:L] = host(prob.points)
    pts = pts.reshape(n_shards, Ls, 3)
    cam_local = padded(host(prob.cam_idx).astype(np.int64))
    lm_local = padded(local)
    obs = padded(host(prob.obs).astype(np.float32))
    info = padded(host(prob.info).astype(np.float32))
    valid = padded(host(prob.edge_valid).astype(np.float32))
    C = prob.cams.shape[0]
    shards = tuple(Shard(
        points=torch.from_numpy(pts[d]), obs=torch.from_numpy(obs[d]),
        cam_idx=torch.from_numpy(cam_local[d]), lm_idx=torch.from_numpy(lm_local[d]),
        info=torch.from_numpy(info[d]), edge_valid=torch.from_numpy(valid[d]),
        plans=rp.build_schur_plans(cam_local[d], lm_local[d], C, Ls, with_cell=True,
                                   n_real=int(counts[d]), device="cpu"))
        for d in range(n_shards))
    return ShardedBA(cams=prob.cams.cpu(), fixed=prob.fixed.cpu(), shards=shards)


def _to(tree, device):
    """Every tensor of a (nested) tuple on ``device``, copied without a
    host wait."""
    if isinstance(tree, torch.Tensor):
        return const(tree, device, tree.dtype)
    items = [_to(x, device) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def place(sb: ShardedBA, mesh: Mesh) -> ShardedBA:
    """``sb``'s shards on the mesh's local shard devices (``sb`` holds
    exactly this process's shards), the cameras and gauge on the first."""
    home = mesh.devices[0]
    return ShardedBA(cams=_to(sb.cams, home), fixed=_to(sb.fixed, home),
                     shards=tuple(_to(s, d) for s, d in zip(sb.shards, mesh.devices)))


def _local_system(cams, sh: Shard, robust: bool, damping: float):
    """One shard's partial reduced camera system (S_d, rhs_d, chi2_d) and
    what its back-substitution needs (W_e, Hll^-1, bl)."""
    C = cams.shape[0]
    Ls = sh.points.shape[0]
    T = cams[sh.cam_idx]
    X = sh.points[sh.lm_idx]
    p = einsum("eij,ej->ei", T[:, :3, :3], X) + T[:, :3, 3]
    e = sh.obs - p
    eye3 = torch.eye(3, dtype=e.dtype, device=e.device)
    J_cam = torch.cat([-eye3.expand(e.shape[0], 3, 3), lie.hat(p)], dim=-1)
    J_lm = -T[:, :3, :3]

    chi2 = einsum("ei,eij,ej->e", e, sh.info, e)
    if robust:
        d = ba.HUBER_DELTA2 ** 0.5
        w = torch.where(chi2 <= ba.HUBER_DELTA2, 1.0, d / torch.sqrt(torch.clamp(chi2, min=1e-12)))
    else:
        w = torch.ones_like(chi2)
    w = w * sh.edge_valid
    Iw = sh.info * w[:, None, None]

    Hcc_e = einsum("eai,eab,ebj->eij", J_cam, Iw, J_cam)
    Hll_e = einsum("eai,eab,ebj->eij", J_lm, Iw, J_lm)
    W_e = einsum("eai,eab,ebj->eij", J_cam, Iw, J_lm)
    bc_e = -einsum("eai,eab,eb->ei", J_cam, Iw, e)
    bl_e = -einsum("eai,eab,eb->ei", J_lm, Iw, e)

    Hcc = rp.apply_plan(sh.plans.cam, Hcc_e, C)
    bc = rp.apply_plan(sh.plans.cam, bc_e, C)
    Hll = rp.apply_plan(sh.plans.lm, Hll_e, Ls)
    bl = rp.apply_plan(sh.plans.lm, bl_e, Ls)
    Hll_inv = torch.linalg.inv_ex(Hll + (damping + 1e-12) * eye3).inverse

    # camera-pair Schur cells as batched matmuls over the cell plan
    Y_e = einsum("eij,ejk->eik", W_e, Hll_inv[sh.lm_idx])  # (Es,6,3)
    S_local = -rp.apply_cell_plan(sh.plans.cell, Y_e, W_e, C)
    ar = torch.arange(C, device=S_local.device)
    S_local[ar, ar] = S_local[ar, ar] + Hcc
    rhs_local = bc - rp.apply_plan(sh.plans.cam, einsum("eik,ek->ei", Y_e, bl[sh.lm_idx]), C)
    return (S_local, rhs_local, torch.sum(chi2 * sh.edge_valid)), (W_e, Hll_inv, bl)


def _solve(S, rhs, fixed, damping: float):
    """The replicated reduced system, gauge-fixed and Jacobi-scaled, solved
    densely: the camera step (C,6), zero where not finite or fixed."""
    C = S.shape[0]
    ar = torch.arange(C, device=S.device)
    gauge = torch.where(fixed[:, None], 1e12, 0.0).to(S.dtype)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    S = S.clone()
    S[ar, ar] = S[ar, ar] + (damping + gauge)[..., None] * eye6
    Sm = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    rv = rhs.reshape(6 * C)
    dpre = torch.sqrt(torch.abs(torch.diagonal(Sm)) + 1e-10)
    x = torch.linalg.solve_ex(Sm / dpre[:, None] / dpre[None, :], rv / dpre).result / dpre
    dx_cam = x.reshape(C, 6)
    dx_cam = torch.where(torch.isfinite(dx_cam), dx_cam, 0.0)
    return torch.where(fixed[:, None], 0.0, dx_cam)


def _iteration(mesh: Mesh, cams: dict, fixed: dict, shards, robust: bool,
               damping: float = 1e-6):
    """One GN iteration over this process's shards.  ``cams`` / ``fixed``:
    the replicated cameras and gauge on each shard device.  Returns (new
    cams per device, new points per shard, the mesh's total chi2 at the
    linearisation point)."""
    parts, keep = [], []
    for sh, dev in zip(shards, mesh.devices):
        part, aux = _local_system(cams[dev], sh, robust, damping)
        parts.append(part)
        keep.append(aux)
    sums = mesh.psum(parts)
    dx_cam, new_cams = {}, {}
    for dev, (S, rhs, _) in zip(mesh.devices, sums):
        if dev not in dx_cam:
            dx_cam[dev] = _solve(S, rhs, fixed[dev], damping)
            new_cams[dev] = matmul(lie.se3_exp(dx_cam[dev]), cams[dev])
    points = []
    for sh, dev, (W_e, Hll_inv, bl) in zip(shards, mesh.devices, keep):
        # local landmark back-substitution (deterministic lm-plan reduction)
        WtDx = rp.apply_plan(sh.plans.lm, einsum("eki,ek->ei", W_e, dx_cam[dev][sh.cam_idx]),
                             sh.points.shape[0])
        dx_lm = einsum("lij,lj->li", Hll_inv, bl - WtDx)
        points.append(sh.points + torch.where(torch.isfinite(dx_lm), dx_lm, 0.0))
    return new_cams, points, sums[0][2]


def make_optimizer(mesh: Mesh, iters_robust: int = 5, iters_final: int = 10):
    """The sharded solver for ``mesh``: ``run(sb)`` takes this process's
    shards on their devices (``multihost.globalize_sharded_ba`` of a
    ``partition_problem`` for ``mesh.size``) and returns (cams (C,4,4) on
    the mesh's first device, the points of each local shard, the last
    iteration's chi2 at its linearisation point): ``iters_robust`` Huber
    iterations, outlier demotion on each shard's edges, then
    ``iters_final`` plain ones, all in full float32 and with no host
    wait."""

    def run(sb: ShardedBA):
        if len(sb.shards) != len(mesh.devices):
            raise ValueError(f"{len(sb.shards)} shards for a mesh that runs "
                             f"{len(mesh.devices)} here: partition for mesh.size and take "
                             "this process's shards (multihost.globalize_sharded_ba)")
        devs = dict.fromkeys(mesh.devices)
        with full_float32():
            cams = {d: sb.cams.to(d) for d in devs}
            fixed = {d: sb.fixed.to(d) for d in devs}
            shards = list(sb.shards)
            chi = torch.zeros((), dtype=sb.cams.dtype, device=mesh.devices[0])
            for _ in range(iters_robust):
                cams, points, chi = _iteration(mesh, cams, fixed, shards, robust=True)
                shards = [s._replace(points=p) for s, p in zip(shards, points)]
            # outlier demotion (local)
            for k, (s, dev) in enumerate(zip(shards, mesh.devices)):
                T = cams[dev][s.cam_idx]
                p = einsum("eij,ej->ei", T[:, :3, :3], s.points[s.lm_idx]) + T[:, :3, 3]
                e = s.obs - p
                chi2 = einsum("ei,eij,ej->e", e, s.info, e)
                shards[k] = s._replace(
                    edge_valid=s.edge_valid * ((chi2 <= ba.HUBER_DELTA2) & (p[:, 2] > 0)))
            for _ in range(iters_final):
                cams, points, chi = _iteration(mesh, cams, fixed, shards, robust=False)
                shards = [s._replace(points=p) for s, p in zip(shards, points)]
        return cams[mesh.devices[0]], tuple(s.points for s in shards), chi

    return run


def gather_points(points_sharded, n_landmarks: int, mesh: Mesh | None = None) -> np.ndarray:
    """The first ``n_landmarks`` landmarks of the mesh's shards in global
    order, as numpy.  On a multi-process mesh (``mesh.group``) the
    processes' shards are all-gathered first (on the host for a ``gloo``
    group)."""
    local = torch.cat([p.to(points_sharded[0].device) for p in points_sharded])
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "gloo":
            local = local.cpu()
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(mesh.group))]
        mesh.sent_bytes += local.numel() * local.element_size()
        dist.all_gather(parts, local, group=mesh.group)
        local = torch.cat(parts)
    return host(local).reshape(-1, 3)[:n_landmarks]
