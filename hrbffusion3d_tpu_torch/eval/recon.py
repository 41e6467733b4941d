"""Surface-reconstruction accuracy evaluation (port of
``hrbffusion3d_tpu/eval/recon.py``).

The ICL-NUIM protocol the reference targets (SURVEY §6: 'surface
reconstruction accuracy vs GT mesh') measures per-surfel distance to the
ground-truth surface.  For the analytic test scenes (eval/synth.py) the
exact point-to-surface distance is available in closed form; it is computed
on the map's device, and the statistics on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..map.surfel_map import SurfelMap
from ..utils.tensors import host, norm
from .synth import Scene


def point_to_scene_distance(points: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Exact unsigned distance of (N,3) points to the analytic scene surface
    (min over all planes and spheres), on the points' device."""
    planes = scene.planes.to(points.device, points.dtype)
    spheres = scene.spheres.to(points.device, points.dtype)
    d = torch.full((points.shape[0],), 1e9, dtype=points.dtype, device=points.device)
    for i in range(planes.shape[0]):
        d = torch.minimum(d, torch.abs(points @ planes[i, :3] - planes[i, 3]))
    for i in range(spheres.shape[0]):
        d = torch.minimum(d, torch.abs(
            norm(points - spheres[i, :3], dim=-1) - spheres[i, 3]))
    return d


def map_accuracy(m: SurfelMap, scene: Scene, conf_threshold: float = 0.0):
    """Reconstruction accuracy stats of a surfel map vs the GT scene:
    (mean, median, rmse, p95) point-to-surface distance in meters."""
    n = int(m.count)
    pos = m.pos[:n]
    keep = host(m.conf[:n]) >= conf_threshold
    d = host(point_to_scene_distance(pos, scene))[keep]
    if d.size == 0:
        return dict(mean=np.inf, median=np.inf, rmse=np.inf, p95=np.inf, n=0)
    return dict(
        mean=float(d.mean()),
        median=float(np.median(d)),
        rmse=float(np.sqrt((d ** 2).mean())),
        p95=float(np.percentile(d, 95)),
        n=int(d.size),
    )
