"""Keyframe backend: sparse map and local BA (port of
``hrbffusion3d_tpu/backend/keyframes.py``).

The reference's ORB_SLAM2_m LocalMapping thread and HRBFFusion's submap
machinery (SURVEY §2.9):
  - ``NeedNewSubMap`` (HRBFFusion.cpp:289-335): a keyframe every
    ``keyframe_period`` frames;
  - ``ConstructSubmaps`` (l.337-446): match the new keyframe against the
    last keyframes, create landmarks from depth;
  - ``LocalMapping::Run`` + ``Optimizer::LocalBundleAdjustment3D``: local BA
    over a window of recent keyframes with 3-D edges (``backend/ba.py``),
    returning the per-submap delta transforms of ``UpdateDenseGlobalModel``
    (l.448-506).

The backend is a host object called synchronously between track and fuse.
Detection, matching and BA run on torch tensors on its ``device`` (the CUDA
card unless the caller names another); the landmark bookkeeping is numpy,
as in the JAX module.  With a ``mesh`` (``parallel.sharding.Mesh``) local
BA runs the landmark-sharded solver (``parallel/dist_ba``) on the mesh's
devices.  Not ported: the plan-shape cache (it keeps jit cache keys
stable).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..parallel import dist_ba, multihost
from ..parallel.sharding import Mesh
from ..utils.tensors import const, device_or_card, host
from . import ba, features


@dataclasses.dataclass
class Keyframe:
    kf_id: int
    frame_time: int
    pose: np.ndarray                 # (4,4) Twc (world <- camera)
    kp_xy: np.ndarray                # (N,2)
    kp_cam: np.ndarray               # (N,3) camera-frame 3D (depth unproject)
    desc: np.ndarray                 # (N,8) uint32
    kp_valid: np.ndarray             # (N,) bool (has descriptor + depth)
    landmark_ids: np.ndarray         # (N,) int64, -1 = none
    kp_level: Optional[np.ndarray] = None   # (N,) int32 pyramid octave
    kp_info: Optional[np.ndarray] = None    # (N,3,3) per-keypoint information


def patch_information(depth: np.ndarray, xy: np.ndarray,
                      intr: CameraIntrinsics, radius: int = 6,
                      z_min: float = 0.3, sigma_px: float = 1.0) -> np.ndarray:
    """Per-keypoint empirical 3x3 information from the (2*radius+1)^2
    depth-patch covariance, the reference's PreProcessFrame estimator
    (HRBFFusion.cpp:596-677): unproject every valid depth in the window,
    take the per-axis variance, info = diag(1/var), in meters.  Axes whose
    empirical variance is degenerate are floored by the parametric Kinect
    model's variance; keypoints with an empty patch get zero information."""
    N = xy.shape[0]
    h, w = depth.shape
    ox, oy = np.meshgrid(np.arange(-radius, radius + 1),
                         np.arange(-radius, radius + 1), indexing="ij")
    off = np.stack([ox.ravel(), oy.ravel()], -1)                 # (D*D, 2)
    cx = np.floor(xy[:, 0]).astype(int)[:, None] + off[None, :, 0]
    cy = np.floor(xy[:, 1]).astype(int)[:, None] + off[None, :, 1]
    inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    z = depth[np.clip(cy, 0, h - 1), np.clip(cx, 0, w - 1)]
    ok = inb & (z > z_min)                                        # (N, D*D)
    x = (cx - intr.cx) * z / intr.fx
    y = (cy - intr.cy) * z / intr.fy
    pts = np.stack([x, y, z], -1)                                 # (N, D*D, 3)
    cnt = ok.sum(-1)
    cnt_safe = np.maximum(cnt, 1)[:, None]
    mean = (pts * ok[..., None]).sum(1) / cnt_safe
    var = (((pts - mean[:, None]) ** 2) * ok[..., None]).sum(1) / cnt_safe

    # parametric floor: diag of J diag(s_px^2,s_px^2,s_z^2) J^T at the
    # keypoint's own unprojection (ba.depth_information's model)
    kz = depth[np.clip(np.floor(xy[:, 1]).astype(int), 0, h - 1),
               np.clip(np.floor(xy[:, 0]).astype(int), 0, w - 1)]
    kz = np.maximum(kz, z_min)
    kx = (xy[:, 0] - intr.cx) * kz / intr.fx
    ky = (xy[:, 1] - intr.cy) * kz / intr.fy
    sz = np.maximum(0.00273 * kz * kz + 0.00074 * kz - 0.00058, 1e-5)
    floor = np.stack([
        (kz / intr.fx * sigma_px) ** 2 + (kx / kz * sz) ** 2,
        (kz / intr.fy * sigma_px) ** 2 + (ky / kz * sz) ** 2,
        sz * sz,
    ], -1)
    var = np.maximum(var, floor)

    info = np.zeros((N, 3, 3), np.float32)
    ii = np.arange(N)
    for a in range(3):
        info[ii, a, a] = np.where(cnt > 0, 1.0 / var[:, a], 0.0)
    return info


# byte-popcount table for NumPy < 2.0 (np.bitwise_count is 2.0+)
_POPCNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M,8)u32 x (N,8)u32 -> (M,N) Hamming distances (DescriptorDistance,
    ORBmatcher.cc:1182-1197), on the host."""
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if hasattr(np, "bitwise_count"):
        a64 = a.view(np.uint64).reshape(a.shape[0], -1)
        b64 = b.view(np.uint64).reshape(b.shape[0], -1)
        return np.bitwise_count(a64[:, None, :] ^ b64[None, :, :]).sum(-1, dtype=np.int32)
    a8 = a.view(np.uint8).reshape(a.shape[0], -1)
    b8 = b.view(np.uint8).reshape(b.shape[0], -1)
    return _POPCNT8[a8[:, None, :] ^ b8[None, :, :]].sum(-1, dtype=np.int32)


class SparseBackend:
    """Keyframe graph, landmark store and local BA.

    ``device``: where detection, matching and BA run (None: the CUDA card,
    which raises when there is none).  ``mesh``: local BA runs the
    landmark-sharded solver on the mesh's shards instead (``ba_pad_min``
    then has no effect, as in JAX)."""

    def __init__(self, intr: CameraIntrinsics, cfg: SLAMConfig,
                 n_features: int = 1024, local_window: int = 5,
                 fast_threshold: float = 12.0, sigma_px: float = 1.0,
                 mesh=None, proj_gate_px: float = 4.0,
                 use_patch_covariance: bool = True,
                 ba_pad_min: tuple = (0, 0, 0), device=None):
        self.intr = intr
        self.cfg = cfg
        self.n_features = n_features
        self.local_window = local_window
        self.fast_threshold = fast_threshold
        # SearchByProjection window radius (ORBmatcher th) used when
        # associating new-keyframe keypoints to existing landmarks
        self.proj_gate_px = proj_gate_px
        # per-keypoint 13x13 depth-patch covariance information matrices
        # (PreProcessFrame); False = parametric Kinect model only
        self.use_patch_covariance = use_patch_covariance
        # keypoint localisation noise fed to the information matrices
        self.sigma_px = sigma_px
        # (min_edges, min_lms, min_cams) pre-sizing of the BA padding buckets
        self.ba_pad_min = ba_pad_min
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.sharding.Mesh, not {type(mesh).__name__}")
        self.device = device_or_card(device)
        self.mesh = mesh
        self.keyframes: list[Keyframe] = []
        self.landmarks: dict[int, np.ndarray] = {}      # id -> world (3,)
        self.lm_obs: dict[int, list[tuple[int, int]]] = {}  # id -> [(kf, kp)]
        self._next_lm = 0

    # ------------------------------------------------------------------ #
    def need_new_keyframe(self, time: int) -> bool:
        """NeedNewSubMap: every cfg.keyframe_period frames."""
        if not self.keyframes:
            return True
        return (time - self.keyframes[-1].frame_time) >= self.cfg.keyframe_period

    # ------------------------------------------------------------------ #
    def _extract(self, intensity, depth):
        img = const(intensity, self.device)
        kp = features.detect_and_describe(img, n_per_level=self.n_features // 4,
                                          threshold=self.fast_threshold)
        xy = host(kp.xy)
        valid = host(kp.valid)
        d = host(depth)
        # bilinear depth at the sub-pixel keypoint (reference re-reads depths
        # from the filtered depth map, HRBFFusion.cpp:578-594)
        x0 = np.clip(np.floor(xy[:, 0]).astype(int), 0, self.intr.width - 2)
        y0 = np.clip(np.floor(xy[:, 1]).astype(int), 0, self.intr.height - 2)
        ax = np.clip(xy[:, 0] - x0, 0, 1)
        ay = np.clip(xy[:, 1] - y0, 0, 1)
        d00, d01 = d[y0, x0], d[y0, x0 + 1]
        d10, d11 = d[y0 + 1, x0], d[y0 + 1, x0 + 1]
        z = (d00 * (1 - ax) * (1 - ay) + d01 * ax * (1 - ay)
             + d10 * (1 - ax) * ay + d11 * ax * ay)
        all_pos = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
        z = np.where(all_pos, z, d[np.round(xy[:, 1]).astype(int).clip(0, self.intr.height - 1),
                                   np.round(xy[:, 0]).astype(int).clip(0, self.intr.width - 1)])
        has_depth = (z > self.cfg.depth_min) & (z <= self.cfg.depth_cutoff)
        cam = np.stack([
            (xy[:, 0] - self.intr.cx) * z / self.intr.fx,
            (xy[:, 1] - self.intr.cy) * z / self.intr.fy,
            z,
        ], axis=-1)
        if self.use_patch_covariance:
            kp_info = patch_information(d, xy, self.intr, sigma_px=self.sigma_px)
        else:
            kp_info = self._depth_information(cam)
        return kp, xy, cam, valid & has_depth, kp_info

    def _depth_information(self, cam: np.ndarray) -> np.ndarray:
        return host(ba.depth_information(const(cam, self.device),
                                         self.intr.fx, self.intr.fy, sigma_px=self.sigma_px))

    # ------------------------------------------------------------------ #
    def insert_keyframe(self, intensity, depth, pose: np.ndarray, time: int) -> int:
        """ConstructSubmaps: extract, associate to the previous keyframes'
        landmarks, create new landmarks from depth (HRBFFusion.cpp:383-438).
        ``intensity`` / ``depth``: (H,W) tensors or arrays.  Returns the new
        keyframe id (== submap index)."""
        kp, xy, cam, valid, kp_info = self._extract(intensity, depth)
        kf_id = len(self.keyframes)
        lm_ids = np.full((xy.shape[0],), -1, np.int64)

        # match against the last few keyframes (SearchInNeighbors,
        # LocalMapping.cc:78), projection-gated like SearchByProjection
        # (ORBmatcher.cc:1247+): the landmark, projected into the new
        # keyframe under its pose estimate, must land within a search
        # radius of the keypoint
        Tcw_new = np.linalg.inv(pose)
        for prev in self.keyframes[-3:][::-1]:
            n_prev = prev.kp_xy.shape[0]
            other = features.Keypoints(
                xy=const(prev.kp_xy, self.device),
                score=torch.zeros(n_prev, device=self.device),
                angle=torch.zeros(n_prev, device=self.device),
                level=torch.zeros(n_prev, dtype=torch.int32, device=self.device),
                desc=features.desc_from_numpy(prev.desc, self.device),
                valid=const(prev.kp_valid, self.device, torch.bool),
            )
            m = features.match(kp, other)
            midx = host(m.idx2)
            mval = host(m.valid) & valid & (lm_ids < 0)
            for i in np.nonzero(mval)[0]:
                j = midx[i]
                lid = prev.landmark_ids[j]
                if lid >= 0:
                    X = self.landmarks[lid]
                    pc = Tcw_new[:3, :3] @ X + Tcw_new[:3, 3]
                    if pc[2] <= 0:
                        continue
                    u = self.intr.fx * pc[0] / pc[2] + self.intr.cx
                    v = self.intr.fy * pc[1] / pc[2] + self.intr.cy
                    if (u - xy[i, 0]) ** 2 + (v - xy[i, 1]) ** 2 > self.proj_gate_px ** 2:
                        continue
                    lm_ids[i] = lid
                    self.lm_obs[lid].append((kf_id, int(i)))

        # new landmarks from depth for unmatched valid keypoints
        R, t = pose[:3, :3], pose[:3, 3]
        for i in np.nonzero(valid & (lm_ids < 0))[0]:
            lid = self._next_lm
            self._next_lm += 1
            self.landmarks[lid] = R @ cam[i] + t
            self.lm_obs[lid] = [(kf_id, int(i))]
            lm_ids[i] = lid

        self.keyframes.append(Keyframe(
            kf_id=kf_id, frame_time=time, pose=pose.copy(),
            kp_xy=xy, kp_cam=cam, desc=features.desc_to_numpy(kp.desc),
            kp_valid=valid, landmark_ids=lm_ids,
            kp_level=host(kp.level), kp_info=kp_info,
        ))
        # projection-guided duplicate fusion over the covisibility
        # neighbourhood, before local BA (LocalMapping.cc:78)
        self.search_and_fuse(kf_id)
        return kf_id

    # ------------------------------------------------------------------ #
    # SearchInNeighbors / ORBmatcher::Fuse
    # ------------------------------------------------------------------ #
    SCALE_FACTOR = 1.5          # features.detect_and_describe defaults
    N_LEVELS = 4
    TH_LOW = 50                 # ORBmatcher.h:TH_LOW
    FUSE_CHI2 = 5.99            # mono reprojection gate (ORBmatcher.cc:948)

    def _lm_stats(self, lids: list[int]):
        """Per-landmark world position, reference descriptor, observation
        count, mean unit viewing direction, and scale-invariance distance
        bounds — MapPoint::UpdateNormalAndDepth (MapPoint.cc:333-375) with
        the first observation as the reference keyframe."""
        M = len(lids)
        pos = np.stack([self.landmarks[l] for l in lids]).astype(np.float64)
        sf = self.SCALE_FACTOR
        centers = np.stack([kf.pose[:3, 3] for kf in self.keyframes])

        # flatten all observations: (lm_row, kf_id, kp_i) triplets
        obs_lists = [self.lm_obs[l] for l in lids]
        nobs = np.array([len(o) for o in obs_lists], np.int32)
        lm_row = np.repeat(np.arange(M), nobs)
        flat = np.array([t for o in obs_lists for t in o], np.int64)
        obs_kf = flat[:, 0]

        # reference observation = first (oldest) one
        first = np.concatenate([[0], np.cumsum(nobs)[:-1]])
        ref_kf = obs_kf[first]
        ref_kp = flat[first, 1]
        desc = np.zeros((M, 8), np.uint32)
        lvl = np.zeros((M,), np.int64)
        for k in np.unique(ref_kf):
            kf = self.keyframes[int(k)]
            sel = ref_kf == k
            desc[sel] = kf.desc[ref_kp[sel]]
            if kf.kp_level is not None:
                lvl[sel] = kf.kp_level[ref_kp[sel]]
        dist = np.linalg.norm(pos - centers[ref_kf], axis=-1) + 1e-12
        maxd = dist * sf ** lvl

        v = pos[lm_row] - centers[obs_kf]
        v /= (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
        normal = np.zeros((M, 3))
        np.add.at(normal, lm_row, v)
        normal /= nobs[:, None]     # mean of unit vectors, NOT re-normalised
        mind = maxd / sf ** (self.N_LEVELS - 1)
        return pos, desc, nobs, normal, maxd, mind

    def _replace_landmark(self, loser: int, winner: int) -> None:
        """MapPoint::Replace (MapPoint.cc:206-245): transfer the loser's
        observations to the winner; where the winner already observes that
        keyframe, the loser's measurement is simply erased."""
        winner_kfs = {kf for kf, _ in self.lm_obs[winner]}
        for kf_id, kp_i in self.lm_obs.pop(loser):
            kf = self.keyframes[kf_id]
            if kf_id in winner_kfs:
                kf.landmark_ids[kp_i] = -1
            else:
                kf.landmark_ids[kp_i] = winner
                self.lm_obs[winner].append((kf_id, kp_i))
                winner_kfs.add(kf_id)
        del self.landmarks[loser]

    def _fuse_into(self, kf_id: int, lids: list[int], th: float = 3.0) -> int:
        """ORBmatcher::Fuse(pKF, vpMapPoints) (ORBmatcher.cc:834-983):
        project each landmark into the keyframe, gate on depth / image
        bounds / scale-invariance distance / viewing angle, search keypoints
        in a scale-dependent radius, chi2- and Hamming-gate, then merge
        duplicate landmarks (higher observation count wins) or add a new
        observation."""
        lids = [l for l in lids if l in self.landmarks]
        if not lids:
            return 0
        kf = self.keyframes[kf_id]
        sf = self.SCALE_FACTOR
        pos, desc, nobs, normal, maxd, mind = self._lm_stats(lids)

        Tcw = np.linalg.inv(kf.pose)
        pc = pos @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        ok = z > 0.0
        zs = np.where(ok, z, 1.0)
        u = self.intr.fx * pc[:, 0] / zs + self.intr.cx
        v = self.intr.fy * pc[:, 1] / zs + self.intr.cy
        ok &= (u >= 0) & (u < self.intr.width) & (v >= 0) & (v < self.intr.height)
        po = pos - kf.pose[:3, 3]
        dist = np.linalg.norm(po, axis=-1) + 1e-12
        ok &= (dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
        ok &= (po * normal).sum(-1) >= 0.5 * dist        # <60 deg viewing angle
        # PredictScale (MapPoint.cc:389-404)
        pred = np.clip(np.ceil(np.log(np.maximum(maxd / dist, 1e-9)) / np.log(sf)),
                       0, self.N_LEVELS - 1).astype(np.int32)
        if not ok.any():
            return 0

        # pairwise work only on the projection-gated rows
        sel = np.flatnonzero(ok)
        kp_lvl = (kf.kp_level if kf.kp_level is not None
                  else np.zeros(kf.kp_xy.shape[0], np.int32)).astype(np.int32)
        d2 = ((u[sel, None] - kf.kp_xy[None, :, 0]) ** 2
              + (v[sel, None] - kf.kp_xy[None, :, 1]) ** 2)
        radius = th * sf ** pred[sel]
        inv_sigma2 = sf ** (-2.0 * kp_lvl)
        cand = (kf.kp_valid[None, :]
                & (d2 <= radius[:, None] ** 2)
                & (kp_lvl[None, :] >= pred[sel, None] - 1)
                & (kp_lvl[None, :] <= pred[sel, None])
                & (d2 * inv_sigma2[None, :] <= self.FUSE_CHI2))
        if not cand.any():
            return 0
        # Hamming only for landmark rows with >= 1 gated candidate
        rows_s = np.flatnonzero(cand.any(1))
        rows = sel[rows_s]
        ham_r = np.where(cand[rows_s], _hamming(desc[rows], kf.desc), 999)
        best_j_r = ham_r.argmin(1)
        best_d_r = ham_r[np.arange(rows.shape[0]), best_j_r]
        best_j = np.zeros((len(lids),), np.int64)
        best_d = np.full((len(lids),), 999, np.int64)
        best_j[rows] = best_j_r
        best_d[rows] = best_d_r

        n_fused = 0
        for i in np.nonzero(best_d <= self.TH_LOW)[0]:
            lid = lids[i]
            if lid not in self.landmarks:        # merged away earlier this pass
                continue
            if any(k == kf_id for k, _ in self.lm_obs[lid]):   # IsInKeyFrame
                continue
            j = int(best_j[i])
            other = int(kf.landmark_ids[j])
            if other >= 0:
                if other == lid or other not in self.landmarks:
                    continue
                if len(self.lm_obs[other]) > len(self.lm_obs[lid]):
                    self._replace_landmark(lid, other)
                else:
                    self._replace_landmark(other, lid)
            else:
                kf.landmark_ids[j] = lid
                self.lm_obs[lid].append((kf_id, j))
            n_fused += 1
        return n_fused

    def search_and_fuse(self, kf_id: int, th: float = 3.0) -> int:
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:476-547):
        fuse the current keyframe's landmarks into the best-10 covisible
        keyframes plus their 5 second-ring neighbours, then fuse those
        targets' landmarks back into the current keyframe."""
        cov = self.covisible_keyframes(kf_id, min_shared=1)
        counts = {k: 0 for k in cov}
        kf = self.keyframes[kf_id]
        for lid in kf.landmark_ids:
            if lid >= 0:
                for other, _ in self.lm_obs[lid]:
                    if other in counts:
                        counts[other] += 1
        first_ring = sorted(counts, key=lambda k: -counts[k])[:10]
        targets: list[int] = []
        for k in first_ring:
            if k not in targets:
                targets.append(k)
            for k2 in self.covisible_keyframes(k, min_shared=1)[:5]:
                if k2 != kf_id and k2 not in targets:
                    targets.append(k2)

        n = 0
        for tk in targets:
            n += self._fuse_into(tk, [int(l) for l in kf.landmark_ids if l >= 0], th)
        back: list[int] = []
        seen: set[int] = set()
        for tk in targets:
            for lid in self.keyframes[tk].landmark_ids:
                if lid >= 0 and lid not in seen:
                    seen.add(int(lid))
                    back.append(int(lid))
        n += self._fuse_into(kf_id, back, th)
        return n

    # ------------------------------------------------------------------ #
    def edge_info(self, kf: Keyframe, kp_i: int) -> np.ndarray:
        """(3,3) information for an observation edge: the keyframe's stored
        per-keypoint depth-patch estimate when present, otherwise the
        parametric Kinect model."""
        if kf.kp_info is not None:
            return kf.kp_info[kp_i]
        return self._depth_information(kf.kp_cam[kp_i][None])[0]

    # ------------------------------------------------------------------ #
    def local_problem(self):
        """The local BA problem over the last ``local_window`` keyframes
        (earlier ones fixed), unpadded on the host, with its keyframe ids
        and landmark ids in problem order: (problem, cam_ids, lm_ids), or
        None if there is not enough data."""
        if len(self.keyframes) < 2:
            return None
        win = self.keyframes[-self.local_window:]
        win_ids = {kf.kf_id for kf in win}

        # collect landmarks observed by the window with >= 2 observations
        lm_sel = []
        for kf in win:
            for lid in kf.landmark_ids:
                if lid >= 0 and len(self.lm_obs[lid]) >= 2:
                    lm_sel.append(lid)
        lm_sel = sorted(set(lm_sel))
        if len(lm_sel) < 8:
            return None
        lm_index = {lid: k for k, lid in enumerate(lm_sel)}

        # cameras: window + any fixed keyframe observing a selected landmark
        cam_ids = set(win_ids)
        for lid in lm_sel:
            for kf_id, _ in self.lm_obs[lid]:
                cam_ids.add(kf_id)
        cam_ids = sorted(cam_ids)
        cam_index = {c: k for k, c in enumerate(cam_ids)}
        # gauge: fix everything outside the window, and the oldest window KF
        fixed = np.array([(c not in win_ids) or (c == min(win_ids)) for c in cam_ids])
        if fixed.all():
            return None

        edges_c, edges_l, obs, infos = [], [], [], []
        for lid in lm_sel:
            for kf_id, kp_i in self.lm_obs[lid]:
                kf = self.keyframes[kf_id]
                edges_c.append(cam_index[kf_id])
                edges_l.append(lm_index[lid])
                obs.append(kf.kp_cam[kp_i])
                infos.append(self.edge_info(kf, kp_i))
        obs = np.asarray(obs, np.float32)

        # Tcw for the solver (ORB-SLAM convention)
        cams_tcw = np.stack([np.linalg.inv(self.keyframes[c].pose)
                             for c in cam_ids]).astype(np.float32)
        points = np.stack([self.landmarks[lid] for lid in lm_sel]).astype(np.float32)

        prob = ba.BAProblem(
            cams=torch.from_numpy(cams_tcw),
            points=torch.from_numpy(points),
            obs=torch.from_numpy(obs),
            cam_idx=torch.as_tensor(edges_c, dtype=torch.int64),
            lm_idx=torch.as_tensor(edges_l, dtype=torch.int64),
            info=torch.from_numpy(np.stack(infos).astype(np.float32)),
            edge_valid=torch.ones((obs.shape[0],), dtype=torch.float32),
            fixed=torch.from_numpy(fixed),
        )
        return prob, cam_ids, lm_sel

    def local_ba(self) -> Optional[np.ndarray]:
        """Local bundle adjustment over the last ``local_window`` keyframes
        (earlier ones fixed), returning per-submap delta transforms
        delta_k = pose_new_k @ pose_old_k^-1 (UpdateDenseGlobalModel
        semantics, HRBFFusion.cpp:457-499) or None if not enough data.

        The problem is built and padded on the host and its reduction plans
        are built there; the padded problem then moves to ``device`` (with
        a mesh: its shards to the mesh's devices) and is solved there."""
        built = self.local_problem()
        if built is None:
            return None
        prob, cam_ids, lm_ids = built
        n_cams, n_lms, n_edges = len(cam_ids), len(lm_ids), prob.obs.shape[0]
        if self.mesh is None:
            solver = "dense" if n_cams <= ba.DENSE_SOLVER_MAX_CAMS else "cg"
            me, ml, mc = self.ba_pad_min
            prob = ba.pad_problem(prob, collapse_pad_lms=True, min_edges=me, min_lms=ml,
                                  min_cams=mc)
            plans = ba.build_plans(prob, solver, n_real=n_edges, device=self.device)
            prob = ba.BAProblem(*(const(x, self.device, x.dtype) for x in prob))
            out, _ = ba.optimize(prob, solver=solver, plans=plans)
            new_tcw = host(out.cams)[:n_cams]
            new_points = host(out.points)[:n_lms]
        else:
            sb = dist_ba.partition_problem(ba.pad_problem(prob), self.mesh.size)
            cams_d, points_d, _ = dist_ba.make_optimizer(self.mesh)(
                multihost.globalize_sharded_ba(sb, self.mesh))
            new_tcw = host(cams_d)[:n_cams]
            new_points = dist_ba.gather_points(points_d, n_lms, self.mesh)

        # write back + build dense-map deltas
        deltas = np.tile(np.eye(4, dtype=np.float32), (len(self.keyframes), 1, 1))
        for k, c in enumerate(cam_ids):
            old_pose = self.keyframes[c].pose
            new_pose = np.linalg.inv(new_tcw[k])
            deltas[c] = (new_pose @ np.linalg.inv(old_pose)).astype(np.float32)
            self.keyframes[c].pose = new_pose
        for k, lid in enumerate(lm_ids):
            self.landmarks[lid] = new_points[k]
        return deltas

    # ------------------------------------------------------------------ #
    def covisible_keyframes(self, kf_id: int, min_shared: int = 15) -> list[int]:
        """Covisibility neighbours (KeyFrame::GetVectorCovisibleKeyFrames):
        keyframes sharing >= min_shared landmarks."""
        counts: dict[int, int] = {}
        kf = self.keyframes[kf_id]
        for lid in kf.landmark_ids:
            if lid < 0:
                continue
            for other, _ in self.lm_obs[lid]:
                if other != kf_id:
                    counts[other] = counts.get(other, 0) + 1
        return [k for k, c in sorted(counts.items()) if c >= min_shared]

    def active_submap_mask(self, kf_id: int, max_submaps: int) -> np.ndarray:
        """Covisible-submap mask for the dense pipeline.  In fully new
        territory (no keyframe shares >= 15 landmarks) the single
        best-sharing keyframe stays active (ORB-SLAM2 UpdateConnections'
        floor), and so does the previous keyframe."""
        active = np.zeros((max_submaps,), bool)
        active[kf_id] = True
        cov = self.covisible_keyframes(kf_id)
        if not cov:
            counts: dict[int, int] = {}
            kf = self.keyframes[kf_id]
            for lid in kf.landmark_ids:
                if lid >= 0:
                    for other, _ in self.lm_obs[lid]:
                        if other != kf_id:
                            counts[other] = counts.get(other, 0) + 1
            if counts:
                cov = [max(counts, key=counts.get)]
            if kf_id > 0:
                cov = list({*cov, kf_id - 1})
        for k in cov:
            active[k] = True
        return active

    def keyframe_trajectory(self):
        """(times, poses) for SaveKeyFrameTrajectoryTUM parity."""
        return (
            [kf.frame_time for kf in self.keyframes],
            np.stack([kf.pose for kf in self.keyframes])
            if self.keyframes else np.zeros((0, 4, 4)),
        )
