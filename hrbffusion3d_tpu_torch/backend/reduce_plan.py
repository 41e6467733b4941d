"""Deterministic gather-sum reduction plans for bundle adjustment and the
pose graph (port of ``hrbffusion3d_tpu/backend/reduce_plan.py``).

A reduction from E sources to T targets is planned on the host: targets
are bucketed by in-degree on a power-of-two ladder, and each bucket is a
dense (Tb, D) table of source indices, padded with a sentinel that points
at an appended all-zero row.  On the device the reduction is gather ->
sum over the table's axis -> a write to unique target rows.  No two
threads add into one address, so the result does not depend on the order
in which threads run: on CUDA, where ``index_add_`` adds with atomics and
two runs can differ in the last bits, a planned reduction gives the same
bits every run.

The plan build is host numpy (a copy of the JAX module's); the tables are
then moved to the device where the reduction runs (``device``; None is the
CUDA card).  The JAX module's sticky padding (``pad_plan_sticky``,
``pad_cell_plan_sticky``) exists to keep jit cache keys stable across
calls and has no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.tensors import const, device_or_card, matmul

# in-degree ladder: bucket D values (power-of-2 keeps gather padding < 2x)
LADDER = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
          32768, 65536, 131072, 262144, 524288, 1048576)


def _pow2(n: int) -> int:
    return max(1, 1 << (int(n - 1).bit_length())) if n > 0 else 1


class ReducePlan(NamedTuple):
    """``tables``: tuple of (idx (Tb,D) int64 into sources [E = zero row],
    rows (Tb,) int64 into targets [T = dropped])."""

    tables: tuple


def _host_tables(ids: np.ndarray, n_targets: int, n_sources: int) -> list:
    """The plan's (idx, rows) tables as numpy int64 (see build_reduce_plan)."""
    ids = np.asarray(ids).astype(np.int64)
    order = np.argsort(ids, kind="stable").astype(np.int64)
    counts = np.bincount(ids, minlength=n_targets)
    if counts.shape[0] > n_targets:
        raise ValueError("ids exceed n_targets")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cmax = int(counts.max()) if counts.size else 0
    tables = []
    prev = 0
    for D in LADDER:
        sel = np.flatnonzero((counts > prev) & (counts <= D))
        prev = D
        Tb = _pow2(sel.size)
        ar = np.arange(D)
        idx_p = np.full((Tb, D), n_sources, np.int64)
        if sel.size:
            gpos = starts[sel][:, None] + np.minimum(ar[None, :], (counts[sel] - 1)[:, None])
            idx_p[: sel.size] = np.where(ar[None, :] < counts[sel][:, None], order[gpos],
                                         n_sources)
        rows = np.full((Tb,), n_targets, np.int64)
        rows[: sel.size] = sel
        tables.append((idx_p, rows))
        if D >= cmax:
            break
    return tables


def _to_device(arrays, device) -> tuple:
    device = device_or_card(device)
    return tuple(const(a, device, torch.int64) for a in arrays)


def build_reduce_plan(ids, n_targets: int, n_sources: int, device=None) -> ReducePlan:
    """Host-side plan build (vectorized numpy, O(E log E)), tables on ``device``.

    ``ids``: (R,) target id per *live* source row with R <= n_sources —
    callers pass only the real (non-padding) rows so zero-weight padding
    never widens a bucket; table entries index the full padded source
    array.  Sources with the same id are gathered in stable sorted order:
    the reduction order is a pure function of the problem's structure."""
    return ReducePlan(tables=tuple(_to_device(t, device)
                                   for t in _host_tables(ids, n_targets, n_sources)))


def apply_plan(plan: ReducePlan, data: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Deterministic segment sum: (E, *block) -> (n_targets, *block).

    Each target's sources are summed in a fixed order (gather + axis sum);
    each table writes unique target rows, and its padding rows write one
    spare row that is cut off."""
    block = data.shape[1:]
    flat = data.reshape(data.shape[0], -1)
    z = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    out = flat.new_zeros((n_targets + 1, flat.shape[1]))
    for idx, rows in plan.tables:
        out[rows] = z[idx].sum(dim=1)
    return out[:n_targets].reshape((n_targets,) + block)


class CellPlan(NamedTuple):
    """Schur camera-pair reduction plan: for every camera-pair cell (a,b)
    the (e,f) edge pairs contributing Y_e W_f^T, as bucketed gather tables
    over edge indices (the (P,6,6) products are never materialised).

    ``tables``: tuple of (pe (Tb,D), pf (Tb,D), rows (Tb,) cell ids)."""

    tables: tuple


def cell_plan_from_pairs(pe, pf, cam_idx, n_cams: int, n_edges: int,
                         device=None) -> CellPlan:
    """The cell plan of given edge pairs (e, f): cell id cam[e] * C + cam[f]."""
    pe = np.asarray(pe).astype(np.int64)
    pf = np.asarray(pf).astype(np.int64)
    cam = np.asarray(cam_idx).astype(np.int64)
    pe_ext = np.concatenate([pe, [n_edges]])
    pf_ext = np.concatenate([pf, [n_edges]])
    tables = _host_tables(cam[pe] * n_cams + cam[pf], n_cams * n_cams, pe.shape[0])
    return CellPlan(tables=tuple(_to_device((pe_ext[idx], pf_ext[idx], rows), device)
                                 for idx, rows in tables))


def build_cell_plan(cam_idx, lm_idx, n_cams: int, n_edges: int,
                    n_real: int | None = None, device=None) -> CellPlan:
    """Pairs (e,f) share a landmark; cell id = cam[e] * C + cam[f].  Only
    the first ``n_real`` edges generate pairs (padding edges carry zero
    weight and would otherwise bloat cell (0,0))."""
    cam_idx = np.asarray(cam_idx)[:n_real]
    pe, pf = build_pairs_np(np.asarray(lm_idx)[:n_real])
    return cell_plan_from_pairs(pe, pf, cam_idx, n_cams, n_edges, device)


def apply_cell_plan(cell: CellPlan, Y_e: torch.Tensor, W_e: torch.Tensor,
                    n_cams: int) -> torch.Tensor:
    """S_off[a,b] = sum_{(e,f) in cell} Y_e W_f^T as batched matmuls,
    (Tb, 6, 3D) @ (Tb, 3D, 6) per bucket, in a fixed order."""
    Yz = torch.cat([Y_e.reshape(-1, 18), Y_e.new_zeros((1, 18))])
    Wz = torch.cat([W_e.reshape(-1, 18), W_e.new_zeros((1, 18))])
    S = Y_e.new_zeros((n_cams * n_cams + 1, 6, 6))
    for pe, pf, rows in cell.tables:
        Yg = Yz[pe].reshape(pe.shape[0], -1, 6, 3).permute(0, 2, 1, 3)   # (Tb,6,D,3)
        Wg = Wz[pf].reshape(pf.shape[0], -1, 6, 3).permute(0, 2, 1, 3)
        S[rows] = matmul(Yg.reshape(pe.shape[0], 6, -1),
                         Wg.reshape(pf.shape[0], 6, -1).transpose(1, 2))
    return S[:n_cams * n_cams].reshape(n_cams, n_cams, 6, 6)


def build_pairs_np(lm_idx) -> tuple[np.ndarray, np.ndarray]:
    """All ordered edge pairs sharing a landmark (vectorized numpy)."""
    lm = np.asarray(lm_idx).astype(np.int64)
    E = lm.shape[0]
    if E == 0:
        return (np.zeros((0,), np.int64),) * 2
    order = np.argsort(lm, kind="stable")
    lm_sorted = lm[order]
    is_start = np.r_[True, lm_sorted[1:] != lm_sorted[:-1]]
    starts = np.flatnonzero(is_start)
    d = np.diff(np.r_[starts, E])                       # group sizes
    reps = d * d
    P = int(reps.sum())
    g = np.repeat(np.arange(d.shape[0]), reps)          # group of each pair
    base = np.repeat(np.cumsum(reps) - reps, reps)
    p_local = np.arange(P) - base
    dg = d[g]
    sg = starts[g]
    e = order[sg + p_local // dg]
    f = order[sg + p_local % dg]
    return e, f


class SchurPlans(NamedTuple):
    """Everything ``ba.optimize`` needs for scatter-free GN: per-camera and
    per-landmark reduction plans, plus the camera-pair cell plan (dense
    solver only; ``cell.tables`` is empty for the CG path)."""

    cam: ReducePlan
    lm: ReducePlan
    cell: CellPlan


def build_schur_plans(cam_idx, lm_idx, n_cams: int, n_lms: int,
                      with_cell: bool = True, n_real: int | None = None,
                      device=None) -> SchurPlans:
    """``n_real``: number of live (non-padding) edges — padding rows are
    excluded from every gather table (their contributions are zero)."""
    cam_np = np.asarray(cam_idx)
    lm_np = np.asarray(lm_idx)
    E = cam_np.shape[0]
    R = E if n_real is None else n_real
    cell = (build_cell_plan(cam_np, lm_np, n_cams, E, n_real=R, device=device)
            if with_cell else CellPlan(tables=()))
    return SchurPlans(
        cam=build_reduce_plan(cam_np[:R], n_cams, E, device),
        lm=build_reduce_plan(lm_np[:R], n_lms, E, device),
        cell=cell,
    )
