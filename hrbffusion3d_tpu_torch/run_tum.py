"""Run the full SLAM system on a TUM RGB-D sequence directory (the port's
twin of ``scripts/run_tum.py``), on the CUDA card; ``run`` takes a
``device`` for other callers (the CPU tests).

Usage:
  python -m hrbffusion3d_tpu_torch.run_tum /path/to/rgbd_dataset_freiburg1_desk \\
      [--camera TUM1] [--start 0] [--end 200] [--out out_dir] [--no-ba] \\
      [--capacity N] [--load-trajectory TUMFILE] [--stats] [--views N]

Writes the reference's standard artefacts (TrajectoryManager.cpp:313-345,
HRBFFusion.cpp:1737+, 2052+) to ``--out``: ``hrbf_trajectory.freiburg``
(TUM format), ``KeyFrameTrajectory.txt``, ``hrbf_globalModel.ply``; with
``--stats`` also ``stats.jsonl``, ``sequence_processing_time.txt``,
``mean_error_pose.txt`` and ``inliers_num.txt``; with ``--views N`` an
N-view turntable render of the final map in ``views/``.  If the sequence
has ``groundtruth.txt``, prints the ATE.  The last line of the standard
output is a JSON object ``{"run_tum": {...}}`` with the run's numbers,
the launches of each CUDA kernel over the frames among them.

The PNG frames are decoded by the port's own ``io/png`` (no imaging
library).  ``FullSLAM`` runs with its keyframe backend on a worker thread
(``async_ba``), the production mode; ``close()`` applies what is queued and
stops the worker before the artefacts are written.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import config as cfgm
from .eval import ate
from .io import traj as trajio
from .io import tum
from .ops import kernels
from .pipeline import slam
from .pipeline.full_slam import FullSLAM
from .utils import timing
from .viz import viewer
from .viz.stats import StatsLogger

CAMERAS = {"TUM1": cfgm.TUM1, "TUM2": cfgm.TUM2, "TUM3": cfgm.TUM3,
           "ICL_NUIM": cfgm.ICL_NUIM}


def run(root: str, intr: cfgm.CameraIntrinsics, cfg: cfgm.SLAMConfig, out: str = ".",
        start: int = 0, end: int | None = None, replay_poses: np.ndarray | None = None,
        stats: bool = False, views: int = 0, device=None,
        backend_kwargs: dict | None = None) -> dict:
    """Process the sequence at ``root`` and write the artefacts to ``out``;
    returns the run's numbers.  ``replay_poses``: (N,4,4) camera-to-world
    poses taken as given per frame (globalInputLoadTrajectory,
    HRBFFusion.cpp:1105): tracking is skipped."""
    os.makedirs(out, exist_ok=True)
    logger = StatsLogger(os.path.join(out, "stats.jsonl")) if stats else None
    sw = timing.Stopwatch() if stats else None
    sys_ = FullSLAM(intr, cfg, backend_kwargs=backend_kwargs, async_ba=True, device=device)
    launches = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    first_frame_s = None
    n = 0
    try:
        for fr in tum.frames_prefetched(root, start=start, end=end):
            if first_frame_s is None:    # the decoder pool's start and first frame
                first_frame_s = time.perf_counter() - t0
            fixed = None
            if replay_poses is not None:
                fixed = replay_poses[min(n, len(replay_poses) - 1)]
            if sw is not None:
                sw.tick("processFrame")
            sys_.process(slam.FrameInput(torch.from_numpy(fr.depth), torch.from_numpy(fr.rgb)),
                         timestamp=fr.timestamp, fixed_pose=fixed)
            if sw is not None:
                sw.tock("processFrame")
                sw.broadcast()  # Stopviz-style UDP telemetry (Stopwatch.h:136)
            if logger is not None:
                logger.log_state(n, sys_.state)
            n += 1
            if n % 50 == 0:
                print(f"frame {n}  {n / (time.perf_counter() - t0):.2f} fps", flush=True)
    finally:
        sys_.close()
    seconds = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] - v for k, v in launches.items()}

    if logger is not None:
        logger.close()
        logger.dump_reference_artifacts(out)
    if sw is not None:
        sw.dump(os.path.join(out, "sequence_processing_time.txt"))
    sys_.save_trajectory_tum(os.path.join(out, "hrbf_trajectory.freiburg"))
    n_pts = sys_.save_map_ply(os.path.join(out, "hrbf_globalModel.ply"))
    kts, kposes = sys_.backend.keyframe_trajectory()
    if len(kts):
        trajio.save_tum(os.path.join(out, "KeyFrameTrajectory.txt"), kts, kposes)
    res = dict(frames=n, seconds=seconds, fps=n / seconds if seconds > 0 else 0.0,
               first_frame_s=first_frame_s,
               surfels=n_pts, keyframes=len(sys_.backend.keyframes),
               loops=[list(p) for p in sys_.loop_closures],
               archive_dropped=sys_.archive_dropped, device=str(sys_.device),
               launches=launches)
    print(f"{n} frames, map {n_pts} surfels, {res['keyframes']} keyframes, "
          f"{len(sys_.loop_closures)} loop closures, {res['fps']:.2f} fps")

    if views:
        paths = viewer.turntable(sys_.state.map, intr, os.path.join(out, "views"),
                                 n_views=views)
        print(f"wrote {len(paths)} turntable views to {out}/views/")
        res["views"] = len(paths)

    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt_ts, gt_poses = tum.load_groundtruth(gt_path)
        matched, valid = tum.associate_gt(np.asarray(sys_.timestamps), gt_ts, gt_poses)
        res["ate_m"] = ate.ate_rmse(sys_.poses()[valid], matched[valid])
        res["ate_matched"] = int(valid.sum())
        print(f"ATE RMSE: {res['ate_m']:.4f} m ({res['ate_matched']} matched frames)")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--camera", default="TUM1", choices=list(CAMERAS))
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--capacity", type=int, default=1 << 19)
    ap.add_argument("--load-trajectory", default=None, metavar="TUMFILE",
                    help="replay mode: skip tracking, take per-frame poses "
                         "from a TUM-format trajectory "
                         "(globalInputLoadTrajectory, HRBFFusion.cpp:1105)")
    ap.add_argument("--stats", action="store_true",
                    help="write per-frame stats.jsonl + "
                         "sequence_processing_time.txt to --out")
    ap.add_argument("--views", type=int, default=0, metavar="N",
                    help="dump an N-view turntable render of the final map "
                         "(headless GUI analogue) to --out/views/")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(cfgm.SLAMConfig(), map_capacity=args.capacity,
                              use_local_ba=not args.no_ba, use_global_ba=not args.no_ba)
    replay_poses = None
    if args.load_trajectory:
        _, replay_poses = trajio.load_tum(args.load_trajectory)
        cfg = dataclasses.replace(cfg, use_local_ba=False, use_global_ba=False)
    res = run(args.root, CAMERAS[args.camera], cfg, out=args.out, start=args.start,
              end=args.end, replay_poses=replay_poses, stats=args.stats, views=args.views)
    print(json.dumps({"run_tum": res}))
    return res


if __name__ == "__main__":
    main()
