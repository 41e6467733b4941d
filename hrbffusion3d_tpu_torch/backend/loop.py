"""Loop closing: detection, geometric verification, correction (port of
``hrbffusion3d_tpu/backend/loop.py``).

``LoopClosing::Run`` (``Core/src/ORB_SLAM2_m/src/LoopClosing.cc``): BoW
candidate scoring (DetectLoop, l.107-234), 3D-3D robust alignment instead
of Sim3 RANSAC (ComputeSim3, l.236-405: for RGB-D the scale is fixed, so
the problem is plain SE(3) Horn alignment + inlier iteration), and
CorrectLoop (l.407-599): add the loop edge, optimise the essential graph,
then run global BA.

The graph logic is host numpy, as in the JAX module.  Descriptor matching,
the pose graph and the global BA run on the backend's ``device`` through
the port's ``features.match``, ``posegraph.optimize`` and ``ba.optimize``
(deterministic planned sums, full float32).  The global BA has no plan-shape
cache (it keeps jit cache keys stable in the JAX package).

Over a process group (a backend whose mesh spans one, as ``FullSLAM``
builds it) the closer runs whole and replicated on every process:
detection, ``correct``, the pose graph and global BA are unsharded, and
after each ``correct`` every process checks that it found the same
candidate pair and deltas as the others (``multihost.check_replicas`` over
the backend mesh's group), raising on every process if not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel import multihost
from ..utils.tensors import const, host
from . import ba, bow, features, posegraph
from .keyframes import Keyframe, SparseBackend

# a keyframe is determined by global BA from three observations (3-D points
# in its camera, three residuals each for its six parameters); one with
# fewer is held at its pose-graph pose and its edges are left out
MIN_BA_OBS = 3


class LoopCandidate(NamedTuple):
    query_kf: int
    match_kf: int
    score: float
    rel_pose: np.ndarray     # T_match_query: query camera -> match camera
    n_inliers: int


def horn_se3(p: np.ndarray, q: np.ndarray):
    """Closed-form rigid alignment q ~ R p + t (Horn/Umeyama, scale 1)."""
    mp = p.mean(0)
    mq = q.mean(0)
    H = (q - mq).T @ (p - mp)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mq - R @ mp
    return R, t


def robust_se3_3d3d(p: np.ndarray, q: np.ndarray, iters: int = 4,
                    inlier_thresh: float = 0.08):
    """Iterative Horn with inlier re-selection (the RGB-D stand-in for the
    Sim3 RANSAC; correspondences come pre-matched by descriptors)."""
    if p.shape[0] < 6:
        return None
    mask = np.ones(p.shape[0], bool)
    R, t = np.eye(3), np.zeros(3)
    for _ in range(iters):
        if mask.sum() < 6:
            return None
        R, t = horn_se3(p[mask], q[mask])
        res = np.linalg.norm(q - (p @ R.T + t), axis=1)
        mask = res < inlier_thresh
    if mask.sum() < 12:
        return None
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, int(mask.sum())


def _keypoints(kf: Keyframe, device) -> features.Keypoints:
    """A stored keyframe's keypoints as the matcher's input on ``device``."""
    n = kf.kp_xy.shape[0]
    zeros = torch.zeros(n, device=device)
    return features.Keypoints(
        xy=const(kf.kp_xy, device), score=zeros, angle=zeros,
        level=torch.zeros(n, dtype=torch.int32, device=device),
        desc=features.desc_from_numpy(kf.desc, device),
        valid=const(kf.kp_valid, device, torch.bool))


class LoopCloser:
    """Host-side loop closing over a SparseBackend keyframe graph;
    its solves run on the backend's ``device``."""

    def __init__(self, backend: SparseBackend, n_words: int = 512,
                 min_score: float = 0.05, min_inliers: int = 20,
                 consistency: int = 3, covis_min_shared: int = 15,
                 vocab_tree=None):
        self.backend = backend
        self.db = bow.BowDatabase(n_words, tree=vocab_tree)
        # absolute floor under the covisible-relative threshold (the lowest
        # BoW score of the query against its covisible neighbours,
        # LoopClosing.cc:120-133)
        self.min_score = min_score
        self.min_inliers = min_inliers
        # a candidate's covisibility group must be re-detected over
        # ``consistency`` consecutive keyframes (LoopClosing.cc:169-234);
        # 1 disables the wait
        self.consistency = consistency
        self.covis_min_shared = covis_min_shared
        # (covisibility group, consecutive detections)
        self._consistent_groups: list[tuple[frozenset, int]] = []
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []

    @property
    def device(self) -> torch.device:
        return self.backend.device

    # ------------------------------------------------------------------ #
    def _covis_group(self, kf_id: int) -> frozenset:
        return frozenset(
            [kf_id] + self.backend.covisible_keyframes(kf_id, min_shared=self.covis_min_shared))

    def add_keyframe(self, kf_id: int) -> Optional[LoopCandidate]:
        """DetectLoop for the given (already inserted) keyframe
        (LoopClosing.cc:107-234): threshold = min covisible-neighbour score,
        candidates outside the covisible set, covisibility-consistency
        grouping over consecutive keyframes, then geometric verification."""
        kf = self.backend.keyframes[kf_id]
        row = self.db.add(features.desc_from_numpy(kf.desc, self.device),
                          const(kf.kp_valid, self.device, torch.bool))
        assert row == kf_id, (row, kf_id)
        covis = self._covis_group(kf_id)
        scores = self.db.query(kf_id, exclude=covis)
        if scores.size == 0:
            return None

        all_scores = self.db.query(kf_id)  # unexcluded, for neighbour scores
        neigh = [k for k in covis if 0 <= k < kf_id]
        if neigh:
            thresh = max(self.min_score, min(all_scores[k] for k in neigh))
        else:
            thresh = self.min_score

        cand_ids = [int(k) for k in np.argsort(scores)[::-1] if scores[k] >= thresh]
        if not cand_ids:
            self._consistent_groups = []
            return None

        # covisibility-consistency groups: a candidate is "enough
        # consistent" once its group chains through shared members over
        # ``consistency`` consecutive detections
        new_groups: list[tuple[frozenset, int]] = []
        enough: list[int] = []
        prev_extended = [False] * len(self._consistent_groups)
        for c in cand_ids:
            group = self._covis_group(c)
            count = 1
            matched_prev = False
            for gi, (pg, pc) in enumerate(self._consistent_groups):
                if not prev_extended[gi] and group & pg:
                    count = pc + 1
                    prev_extended[gi] = True
                    matched_prev = True
                    break
            new_groups.append((group, count))
            if count >= self.consistency and (matched_prev or self.consistency <= 1):
                enough.append(c)
        self._consistent_groups = new_groups
        if not enough:
            return None

        # geometric verification, best-scoring candidate first
        for best in enough:
            out = self._verify(kf, kf_id, best, float(scores[best]))
            if out is not None:
                self._consistent_groups = []
                return out
        return None

    def _verify(self, kf: Keyframe, kf_id: int, best: int,
                score: float) -> Optional[LoopCandidate]:
        cand = self.backend.keyframes[best]
        m = features.match(_keypoints(kf, self.device), _keypoints(cand, self.device))
        idx2 = host(m.idx2)
        sel = host(m.valid) & kf.kp_valid & cand.kp_valid[idx2]
        if sel.sum() < 12:
            return None
        fit = robust_se3_3d3d(kf.kp_cam[sel], cand.kp_cam[idx2[sel]], inlier_thresh=0.08)
        if fit is None:
            return None
        T_cq, n_in = fit           # query-camera point -> candidate-camera
        if n_in < self.min_inliers:
            return None
        return LoopCandidate(query_kf=kf_id, match_kf=best, score=score,
                             rel_pose=T_cq, n_inliers=n_in)

    # ------------------------------------------------------------------ #
    # essential graph (Optimizer::OptimizeEssentialGraph, Optimizer.cc:1352+):
    # covisibility edges above this weight join the spanning tree and loop
    # edges
    ESSENTIAL_MIN_FEAT = 100

    def _covis_counts(self) -> np.ndarray:
        """(K,K) shared-landmark counts between keyframe pairs: the Gram
        matrix of the keyframe-landmark incidence, in landmark chunks."""
        be = self.backend
        K = len(be.keyframes)
        pairs = [(k, li) for li, obs in enumerate(be.lm_obs.values())
                 for k in {kk for kk, _ in obs}]
        if not pairs or K == 0:
            return np.zeros((K, K), np.int32)
        kf_ids = np.fromiter((p[0] for p in pairs), np.int64)
        lm_ids = np.fromiter((p[1] for p in pairs), np.int64)
        L = int(lm_ids.max()) + 1
        W = np.zeros((K, K), np.int64)
        chunk = max(1, (1 << 24) // max(K, 1))
        for lo in range(0, L, chunk):
            sel = (lm_ids >= lo) & (lm_ids < lo + chunk)
            if not sel.any():
                continue
            M = np.zeros((K, min(chunk, L - lo)), np.float32)
            M[kf_ids[sel], lm_ids[sel] - lo] = 1.0
            W += (M @ M.T).astype(np.int64)
        np.fill_diagonal(W, 0)
        return W.astype(np.int32)

    def _essential_edges(self, cand: LoopCandidate, old_poses: np.ndarray) -> dict:
        """Spanning tree + strong covisibility edges + all prior loop edges
        + the new loop edge (Optimizer.cc:1395-1520; identity
        informations), keyed (i, j) with i < j, first occurrence winning."""
        K = len(self.backend.keyframes)
        W = self._covis_counts()
        inv_poses = np.linalg.inv(old_poses)

        groups = []  # in priority order
        # spanning tree: parent = strongest-covisibility earlier keyframe,
        # falling back to the previous one
        if K > 1:
            Wl = np.tril(W, -1)[1:]
            parents = np.where(Wl.max(axis=1) > 0, np.argmax(Wl, axis=1), np.arange(K - 1))
            kids = np.arange(1, K)
            groups.append((parents, kids, inv_poses[parents] @ old_poses[kids]))
        ci, cj = np.nonzero(np.triu(W, 1) >= self.ESSENTIAL_MIN_FEAT)
        if ci.size:
            groups.append((ci, cj, inv_poses[ci] @ old_poses[cj]))
        for mi, qi, rel in self.loop_edges:
            groups.append((np.array([mi]), np.array([qi]), np.asarray(rel, np.float64)[None]))
        # the new loop edge: Z_match,query = pose_match^-1 pose_query = rel
        groups.append((np.array([cand.match_kf]), np.array([cand.query_kf]),
                       np.asarray(cand.rel_pose, np.float64)[None]))

        ii = np.concatenate([g[0] for g in groups]).astype(np.int64)
        jj = np.concatenate([g[1] for g in groups]).astype(np.int64)
        ZZ = np.concatenate([np.asarray(g[2], np.float64) for g in groups])
        keep = ii != jj
        ii, jj, ZZ = ii[keep], jj[keep], ZZ[keep]
        flip = ii > jj
        ii, jj = np.where(flip, jj, ii), np.where(flip, ii, jj)
        if flip.any():
            ZZ[flip] = np.linalg.inv(ZZ[flip])
        _, first = np.unique(ii * K + jj, return_index=True)
        return {(int(ii[f]), int(jj[f])): ZZ[f].astype(np.float32) for f in np.sort(first)}

    def correct(self, cand: LoopCandidate, run_global_ba: bool = True) -> np.ndarray:
        """CorrectLoop (LoopClosing.cc:407-599): pre-correct the query-side
        covisible group by the measured loop constraint, optimise the
        essential graph, fuse loop-side landmark duplicates into the
        corrected side (SearchAndFuse, l.550), then global BA; returns
        per-keyframe delta transforms for the dense map (the contract of
        SparseBackend.local_ba)."""
        be = self.backend
        K = len(be.keyframes)
        dev = self.device
        old_poses = np.stack([kf.pose for kf in be.keyframes])

        edges = self._essential_edges(cand, old_poses)
        E = len(edges)
        # initial estimates: the loop correction propagated to the query's
        # covisible group (CorrectLoop l.450-525)
        init = old_poses.copy()
        d_corr = (old_poses[cand.match_kf] @ cand.rel_pose) @ np.linalg.inv(
            old_poses[cand.query_kf])
        for k in self._covis_group(cand.query_kf):
            init[k] = d_corr @ old_poses[k]
        # gauge: the map origin and the loop keyframe are held (Optimizer.cc:1379)
        fixed = np.zeros((K,), bool)
        fixed[0] = True
        fixed[cand.match_kf] = True

        g = posegraph.PoseGraph(
            poses=const(init.astype(np.float32), dev),
            edge_i=const([i for i, _ in edges], dev, torch.int64),
            edge_j=const([j for _, j in edges], dev, torch.int64),
            meas=const(np.stack(list(edges.values())), dev),
            info=torch.eye(6, device=dev).expand(E, 6, 6).contiguous(),
            edge_valid=torch.ones((E,), device=dev),
            fixed=const(fixed, dev, torch.bool))
        g_opt, _ = posegraph.optimize(g, iterations=25)
        new_poses = host(g_opt.poses)

        # landmarks ride their reference (first-observing) keyframe
        for lid, obs in be.lm_obs.items():
            ref = obs[0][0]
            d = new_poses[ref] @ np.linalg.inv(old_poses[ref])
            X = be.landmarks[lid]
            be.landmarks[lid] = (d[:3, :3] @ X + d[:3, 3]).astype(np.float32)
        for k, kf in enumerate(be.keyframes):
            kf.pose = new_poses[k].astype(np.float32)

        self.loop_edges.append((cand.match_kf, cand.query_kf, cand.rel_pose))

        # SearchAndFuse: project the loop-side landmarks into the corrected
        # query-side keyframes and merge duplicates
        loop_lms = sorted({int(l) for k in self._covis_group(cand.match_kf)
                           for l in be.keyframes[k].landmark_ids if l >= 0})
        for k in self._covis_group(cand.query_kf):
            be._fuse_into(k, loop_lms, th=4.0)

        deltas = self._global_ba(old_poses) if run_global_ba else None
        if deltas is None:
            deltas = np.einsum("kij,kjl->kil", new_poses, np.linalg.inv(old_poses)
                               ).astype(np.float32)
        mesh = be.mesh
        if mesh is not None and mesh.group is not None:
            multihost.check_replicas(f"loop correction {cand.match_kf}-{cand.query_kf} (pair, "
                                     "deltas)", [cand.match_kf, cand.query_kf, deltas],
                                     mesh.group)
        return deltas

    # ------------------------------------------------------------------ #
    def _global_ba(self, original_poses: np.ndarray) -> Optional[np.ndarray]:
        """RunGlobalBundleAdjustment (LoopClosing.cc:659-769): BA over all
        keyframes and landmarks seen twice; deltas are against the poses
        before the pose-graph correction (the dense map still sits at
        those).  Built and planned on the host, solved on ``device``.

        A keyframe with fewer than MIN_BA_OBS observations is held: fixed,
        its edges invalid, its pose-graph pose kept bit for bit.  The JAX
        package leaves it free, where only the solver's damping holds it
        and its pose follows float rounding; the others see the same
        problem in both, since a free keyframe with three residuals
        absorbs its own."""
        be = self.backend
        lm_sel = [lid for lid, obs in be.lm_obs.items() if len(obs) >= 2]
        if len(lm_sel) < 16:
            return None
        lm_index = {lid: k for k, lid in enumerate(lm_sel)}
        K = len(be.keyframes)

        edges_c, edges_l, obs, infos = [], [], [], []
        for lid in lm_sel:
            for kf_id, kp_i in be.lm_obs[lid]:
                edges_c.append(kf_id)
                edges_l.append(lm_index[lid])
                obs.append(be.keyframes[kf_id].kp_cam[kp_i])
                infos.append(be.edge_info(be.keyframes[kf_id], kp_i))
        obs = np.asarray(obs, np.float32)
        cams_tcw = np.stack([np.linalg.inv(kf.pose) for kf in be.keyframes]).astype(np.float32)
        points = np.stack([be.landmarks[lid] for lid in lm_sel]).astype(np.float32)
        held = np.bincount(edges_c, minlength=K) < MIN_BA_OBS
        fixed = held.copy()
        fixed[0] = True
        edge_valid = ~held[edges_c]

        prob = ba.BAProblem(
            cams=torch.from_numpy(cams_tcw), points=torch.from_numpy(points),
            obs=torch.from_numpy(obs),
            cam_idx=torch.as_tensor(edges_c, dtype=torch.int64),
            lm_idx=torch.as_tensor(edges_l, dtype=torch.int64),
            info=torch.from_numpy(np.stack(infos).astype(np.float32)),
            edge_valid=torch.from_numpy(edge_valid.astype(np.float32)),
            fixed=torch.from_numpy(fixed))
        solver = "dense" if K <= ba.DENSE_SOLVER_MAX_CAMS else "cg"
        n_edges = obs.shape[0]
        prob = ba.pad_problem(prob, collapse_pad_lms=True)
        plans = ba.build_plans(prob, solver, n_real=n_edges, device=be.device)
        prob = ba.BAProblem(*(const(x, be.device, x.dtype) for x in prob))
        out, _ = ba.optimize(prob, solver=solver, plans=plans)
        new_tcw = host(out.cams)[:K]
        new_points = host(out.points)[:len(lm_sel)]

        deltas = np.zeros((K, 4, 4), np.float32)
        for k in range(K):
            if not held[k]:
                be.keyframes[k].pose = np.linalg.inv(new_tcw[k])
            deltas[k] = (be.keyframes[k].pose @ np.linalg.inv(original_poses[k])
                         ).astype(np.float32)
        for lid, k in lm_index.items():
            be.landmarks[lid] = new_points[k]
        return deltas
