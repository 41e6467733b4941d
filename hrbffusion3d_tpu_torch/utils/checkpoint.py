"""Checkpoint / resume for the full SLAM system (port of
``hrbffusion3d_tpu/utils/checkpoint.py``; the port's own file format).

The reference has no in-flight checkpointing (SURVEY §5: offline PLY +
trajectory artifacts only).  ``save`` writes everything a ``FullSLAM``
carries from one frame to the next, so that a fresh system (same
intrinsics and config) resumes mid-sequence bit for bit:
  - every ``SLAMState`` tensor (the surfel map with its full backing
    array, pose, prediction maps) and its host counters ``time`` and
    ``submap_idx``, and the map capacity the run has grown to;
  - the archive of the active-window split, with its host counters;
  - the sparse backend: keyframes (``kp_info`` included), landmarks,
    observations, the landmark counter;
  - the trajectory, its timestamps and keyframe tags, the keyframe
    cadence counters, the covisible-keyframe mask, the loop closures;
  - the loop closer's loop edges and consistency groups;
  - the CRC of the BRIEF test pattern (descriptors from another pattern
    are incompatible: loading warns).
The BoW database is rebuilt on load from the keyframes' descriptors (the
vocabulary is deterministic).  A state split over a mesh is saved whole
(``sharding.gather_state``) and split again on load when the system has a
mesh.  ``save`` first joins the async keyframe
worker, so nothing is in flight.  Over a process group every process
calls ``save`` (it joins its worker and gathers the state, both
collective) and process 0 alone writes the file, between barriers; every
process calls ``load`` on the same file and keeps its own shards' rows.

Layout: 8 bytes little-endian length, an ``np.savez`` archive of the
arrays (uncompressed: the map is most of the bytes and saving it is on the
run's clock), then a zlib-compressed pickle of the host objects.  Load only
files this module wrote: unpickling runs code.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import warnings
import zlib

import numpy as np
import torch

from ..backend import bow, features
from ..backend.keyframes import Keyframe
from ..map import surfel_map as sm
from ..parallel import multihost, sharding
from .convert import state_from_numpy, state_to_numpy
from .tensors import const, host


def _pattern_fingerprint() -> int:
    """Identity of the active BRIEF test pattern."""
    return int(zlib.crc32(np.ascontiguousarray(features._brief_pattern()).tobytes()))


def save(path: str, system) -> None:
    """Write ``system`` (a ``FullSLAM`` that has processed a frame; over a
    group every process calls this, and process 0 writes)."""
    if system.state is None:
        raise ValueError("nothing to save: the system has processed no frame")
    system.join_backend()
    state = sharding.gather_state(system.state)
    group = system.mesh.group if system.mesh is not None else None
    multihost.barrier(group)
    if multihost.is_coordinator(group):
        _write(path, system, state)
    multihost.barrier(group)


def _write(path: str, system, state) -> None:
    arrays = {f"state.{k}": v for k, v in state_to_numpy(state).items()}
    if system.archive is not None:
        arrays["archive.data"] = host(system.archive.data)
        arrays["archive.count"] = host(system.archive.count)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    lc = system.loop_closer
    blob = pickle.dumps({
        "map_capacity": system.cfg.map_capacity,
        "archive_count": system._archive_count,
        "active_count": system._active_count,
        "active_mask_host": system._active_mask_host,
        "archive_dropped": system.archive_dropped,
        "brief_pattern_crc": _pattern_fingerprint(),
        "keyframes": [dataclasses.asdict(k) for k in system.backend.keyframes],
        "landmarks": system.backend.landmarks,
        "lm_obs": system.backend.lm_obs,
        "next_lm": system.backend._next_lm,
        "trajectory": system.trajectory,
        "timestamps": system.timestamps,
        "kf_of_frame": system.kf_of_frame,
        "last_kf_time": system._last_kf_time,
        "next_kf_id": system._next_kf_id,
        "loop_closures": system.loop_closures,
        "async_corrections": system.async_corrections,
        "loop_edges": lc.loop_edges if lc is not None else [],
        "consistent_groups": lc._consistent_groups if lc is not None else [],
    })
    with open(path, "wb") as f:
        sb = buf.getvalue()
        f.write(len(sb).to_bytes(8, "little"))
        f.write(sb)
        f.write(zlib.compress(blob))


def load(path: str, system):
    """Restore into a freshly constructed ``FullSLAM`` with the same
    intrinsics and config (it need not have processed a frame); returns
    it."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        arrays = dict(np.load(io.BytesIO(f.read(n))))
        data = pickle.loads(zlib.decompress(f.read()))
    dev = system.device
    system.state = state_from_numpy(
        {k[len("state."):]: v for k, v in arrays.items() if k.startswith("state.")}, dev)
    if system.mesh is not None:
        system.state = sharding.shard_state(system.state, system.mesh, system.cfg)
    system.cfg = dataclasses.replace(system.cfg, map_capacity=data["map_capacity"])
    if "archive.data" in arrays:
        system.archive = sm.SurfelMap(data=torch.from_numpy(arrays["archive.data"]).to(dev),
                                      count=torch.from_numpy(arrays["archive.count"]).to(dev))
    else:
        system.archive = None
    system._archive_count = data["archive_count"]
    system._active_count = data["active_count"]
    system._active_mask_host = data["active_mask_host"]
    system.archive_dropped = data["archive_dropped"]
    if data["brief_pattern_crc"] != _pattern_fingerprint():
        warnings.warn(
            "checkpoint was written with a different BRIEF pattern — "
            "stored descriptors are incompatible with newly-extracted "
            "ones (Hamming/BoW matching across the resume point will be "
            "meaningless)", RuntimeWarning)
    be = system.backend
    be.keyframes = [Keyframe(**k) for k in data["keyframes"]]
    be.landmarks = data["landmarks"]
    be.lm_obs = data["lm_obs"]
    be._next_lm = data["next_lm"]
    system.trajectory = data["trajectory"]
    system.timestamps = data["timestamps"]
    system.kf_of_frame = data["kf_of_frame"]
    system._last_kf_time = data["last_kf_time"]
    system._next_kf_id = data["next_kf_id"]
    system.loop_closures = data["loop_closures"]
    system.async_corrections = data["async_corrections"]
    lc = system.loop_closer
    if lc is not None:
        lc.db = bow.BowDatabase(lc.db.n_words, tree=lc.db.tree)
        for kf in be.keyframes:
            lc.db.add(features.desc_from_numpy(kf.desc, dev),
                      const(kf.kp_valid, dev, torch.bool))
        lc.loop_edges = data["loop_edges"]
        lc._consistent_groups = data["consistent_groups"]
    return system
