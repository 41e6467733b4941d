"""PLY export/import of the surfel map (port of
``hrbffusion3d_tpu/io/ply.py``).

Replaces ``HRBFFusion::savePly`` (HRBFFusion.cpp:1737-1853): binary
little-endian PLY with position, color, normal, radius, principal
curvatures and submap index per surfel, filtered by a confidence
threshold.  The map's live rows are copied to the host once.
"""

from __future__ import annotations

import struct

import numpy as np

from ..map import surfel_map as sm
from ..utils.tensors import host

_PROPS = [
    ("x", "float"), ("y", "float"), ("z", "float"),
    ("red", "uchar"), ("green", "uchar"), ("blue", "uchar"),
    ("nx", "float"), ("ny", "float"), ("nz", "float"),
    ("radius", "float"),
    ("curvature_k1", "float"), ("curvature_k2", "float"),
    ("confidence", "float"),
    ("submap", "int"),
]
_RECORD = struct.Struct("<fff BBB fff f ff f i")


def save_ply(path: str, m: sm.SurfelMap, conf_threshold: float = 0.0) -> int:
    """Write the live surfels with confidence >= ``conf_threshold``; returns
    how many were written."""
    n = int(m.count)
    rows = host(m.data[:n])
    rows = rows[rows[:, sm.CONF] >= conf_threshold]
    col = (np.clip(rows[:, sm.COLOR], 0, 1) * 255).astype(np.uint8)
    sub = rows[:, sm.SUBMAP].astype(np.int32)

    count = rows.shape[0]
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {count}"]
        hdr += [f"property {t} {name}" for name, t in _PROPS]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode())
        for i in range(count):
            r = rows[i]
            f.write(_RECORD.pack(
                r[0], r[1], r[2], col[i, 0], col[i, 1], col[i, 2],
                r[sm.NORMAL][0], r[sm.NORMAL][1], r[sm.NORMAL][2],
                r[sm.RADIUS], r[sm.K1], r[sm.K2], r[sm.CONF], int(sub[i])))
    return count


def load_ply_positions(path: str) -> np.ndarray:
    """Minimal reader for round-tripping our own exports (positions only)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        count = next(int(l.split()[-1]) for l in lines if l.startswith("element vertex"))
        out = np.zeros((count, 3), np.float32)
        for i in range(count):
            out[i] = _RECORD.unpack(f.read(_RECORD.size))[:3]
    return out
