"""Per-frame run statistics — the GUI live-plot / stdout-trace analogue
(port of ``hrbffusion3d_tpu/viz/stats.py``).

The reference plots ICP residual + inlier count live (GUI/src/
HRBF_fusion.cpp:284-296) and dumps per-frame timing maps to
``sequence_processing_time.txt`` (HRBFFusion.cpp:172-187).  Headless
equivalent: a JSONL stream of per-frame scalars that any plotting tool
can tail, plus the Stopwatch dump (utils/timing.py).  ``log_state`` reads
five scalars of the port's ``SLAMState`` back to the host, so it waits for
the card.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.tensors import host


class StatsLogger:
    """Append one JSON line of scalars per frame."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.rows: list[dict] = []
        self._f = open(path, "w") if path else None

    def log_state(self, frame: int, state, extra: dict | None = None):
        row = {
            "frame": int(frame),
            "icp_error": float(host(state.last_icp_error)),
            "icp_count": int(host(state.last_icp_count)),
            "dense_frac": float(host(state.dense_frac)),
            "surfels": int(host(state.map.count)),
            "t": [float(x) for x in host(state.t)],
        }
        if extra:
            row.update(extra)
        self.rows.append(row)
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        return row

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def dump_reference_artifacts(self, out_dir: str):
        """The reference's per-frame debug dumps (HRBFFusion.cpp:152-187):
        ``mean_error_pose.txt`` (per-frame mean ICP error) and
        ``inliers_num.txt`` (per-frame inlier counts), one value per line."""
        with open(os.path.join(out_dir, "mean_error_pose.txt"), "w") as f:
            for r in self.rows:
                f.write(f"{r['frame']} {r['icp_error']:.6f}\n")
        with open(os.path.join(out_dir, "inliers_num.txt"), "w") as f:
            for r in self.rows:
                f.write(f"{r['frame']} {r['icp_count']}\n")


def dump_prediction_textures(state, out_dir: str, frame: int | None = None):
    """IndexMap::downloadTexture analogue (IndexMap.cpp:590-729): write the
    predicted vertex/normal/intensity/weight/curvature maps as .npy files
    for offline inspection."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{frame:05d}" if frame is not None else ""
    for name in ("pred_vertex", "pred_normal", "pred_intensity",
                 "pred_icp_weight", "pred_k1", "pred_k2"):
        np.save(os.path.join(out_dir, f"{name}{tag}.npy"), host(getattr(state, name)))
