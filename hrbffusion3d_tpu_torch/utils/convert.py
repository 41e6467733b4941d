"""Carry SLAM state and configuration across between the JAX package and
the port, without importing the JAX package.

The surfel map is the system's "weights": with ``state_from_numpy`` /
``state_to_numpy`` a JAX ``SLAMState`` (its fields turned into numpy
arrays, the map flattened to ``map.data`` / ``map.count``) becomes a port
``SLAMState`` on a device, and back, exactly.  ``config_from_fields`` and
``intrinsics_from_fields`` take ``dataclasses.asdict`` of a JAX
``SLAMConfig`` / ``CameraIntrinsics`` and give the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraIntrinsics, SLAMConfig
from ..map.surfel_map import SurfelMap
from ..pipeline.slam import SLAMState

_HOST_INTS = ("time", "submap_idx")


def config_from_fields(fields: dict) -> SLAMConfig:
    """``dataclasses.asdict`` of a JAX ``SLAMConfig`` -> the port's; a field
    the port's copy lacks raises ``TypeError``."""
    return SLAMConfig(**fields)


def intrinsics_from_fields(fields: dict) -> CameraIntrinsics:
    """``dataclasses.asdict`` of a JAX ``CameraIntrinsics`` -> the port's."""
    return CameraIntrinsics(**fields)


def state_from_numpy(fields: dict[str, np.ndarray], device) -> SLAMState:
    """``{field: array}`` (``map`` as ``map.data`` and ``map.count``) ->
    SLAMState on ``device``; ``time`` and ``submap_idx`` become host ints."""
    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    kw = {}
    for name in SLAMState._fields:
        if name == "map":
            kw[name] = SurfelMap(data=t(fields["map.data"]), count=t(fields["map.count"]))
        elif name in _HOST_INTS:
            kw[name] = int(fields[name])
        else:
            kw[name] = t(fields[name])
    return SLAMState(**kw)


def state_to_numpy(state: SLAMState) -> dict[str, np.ndarray]:
    """The reverse of ``state_from_numpy`` (host ints become 0-d int32)."""
    out = {"map.data": state.map.data.cpu().numpy(),
           "map.count": state.map.count.cpu().numpy()}
    for name in SLAMState._fields:
        if name == "map":
            continue
        val = getattr(state, name)
        out[name] = (np.asarray(val, np.int32) if name in _HOST_INTS
                     else val.cpu().numpy())
    return out
