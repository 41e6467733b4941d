"""TUM RGB-D dataset IO (the port's own copy of
``hrbffusion3d_tpu/io/tum.py``, numpy only).

Replaces the reference's ``RawImageLogReader`` + the direct OpenCV reads in
``HRBFFusion::inputFrame`` (HRBFFusion.cpp:240-270): association-file
parsing, 16-bit PNG depth (1/5000 m units), 8-bit RGB.  The JAX package
opens every image with Pillow, which picks the format from the file's
bytes; so does the port, with no imaging library (``io/image``): a colour
file in JPEG (the port's own decoder, ``io/jpeg``), PNG (``io/png``, zlib
and numpy), BMP (``io/bmp``), netpbm (``io/pnm``), TIFF (``io/tiff``),
GIF (``io/gif``) or WebP (``io/webp``) is decoded to what Pillow's
``convert("RGB")`` gives in the JAX package; a depth file in any of them
is read as ``np.asarray(Image.open(...))`` reads it, if it has one band.
``write_sequence`` writes a sequence in the same layout (tests, synthetic
fixtures).
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

from . import image, jpeg, png

TUM_DEPTH_SCALE = 1.0 / 5000.0  # TUM PNG depth unit -> meters


class TUMFrame(NamedTuple):
    timestamp: float
    depth: np.ndarray   # (H,W) float32 meters, 0 = invalid
    rgb: np.ndarray     # (H,W,3) float32 in [0,1]


def read_associations(path: str):
    """Parse associations.txt: 'ts_rgb rgb_path ts_depth depth_path' (or the
    depth-first variant; detected by extension)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts0, p0, ts1, p1 = parts[:4]
            if "depth" in p0:
                depth_p, rgb_p, ts = p0, p1, float(ts0)
            else:
                rgb_p, depth_p, ts = p0, p1, float(ts0)
            out.append((ts, rgb_p, depth_p))
    return out


def load_frame(root: str, rgb_path: str, depth_path: str,
               timestamp: float, depth_scale: float = TUM_DEPTH_SCALE) -> TUMFrame:
    depth_img = image.read_depth(os.path.join(root, depth_path))
    depth = depth_img.astype(np.float32) * depth_scale
    rgb = image.read_colour(os.path.join(root, rgb_path)).astype(np.float32) / 255.0
    return TUMFrame(timestamp=timestamp, depth=depth, rgb=rgb)


def frames(root: str, associations: str = "associations.txt",
           start: int = 0, end: int | None = None,
           depth_scale: float = TUM_DEPTH_SCALE) -> Iterator[TUMFrame]:
    """Stream TUM frames in association order (LogReader::getNext)."""
    assoc = read_associations(os.path.join(root, associations))
    if end is not None:
        assoc = assoc[:end]
    for ts, rgb_p, depth_p in assoc[start:]:
        yield load_frame(root, rgb_p, depth_p, ts, depth_scale)


def frames_prefetched(root: str, associations: str = "associations.txt",
                      start: int = 0, end: int | None = None,
                      depth_scale: float = TUM_DEPTH_SCALE,
                      workers: int = 3, depth_ahead: int = 8) -> Iterator[TUMFrame]:
    """Like :func:`frames`, but decoding runs ahead of the consumer in a
    pool of ``workers`` processes (the runtime analogue of the native .klg
    prefetcher, native/dataloader.cpp).  The PNG decoder is numpy, which
    holds the interpreter lock between its many small array operations: in
    threads it would take the lock from the consumer's own Python (the
    dense step's launches), so the pool is of processes, started with
    ``spawn`` (safe beside CUDA and threads) and shut down when the
    iteration ends.  When any file needs the native library (a JPEG, a
    TIFF, a GIF, a WebP, a run-length BMP: ``image.needs_library``), the
    library that holds their decoders is built or loaded here first (``RuntimeError`` naming the
    build error if it cannot be), so that the workers only load it.
    Each worker imports the caller's main module, so a script that calls
    this keeps its own work under ``if __name__ == "__main__":``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    assoc = read_associations(os.path.join(root, associations))
    if end is not None:
        assoc = assoc[:end]
    assoc = assoc[start:]
    if any(image.needs_library(_head(os.path.join(root, p), 64))
           for _, rgb_p, depth_p in assoc for p in (rgb_p, depth_p)):
        jpeg.library()
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = []
        it = iter(assoc)
        for _ in range(depth_ahead):
            nxt = next(it, None)
            if nxt is None:
                break
            ts, rgb_p, depth_p = nxt
            pending.append(pool.submit(load_frame, root, rgb_p, depth_p,
                                       ts, depth_scale))
        while pending:
            fut = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                ts, rgb_p, depth_p = nxt
                pending.append(pool.submit(load_frame, root, rgb_p, depth_p,
                                           ts, depth_scale))
            yield fut.result()


def _head(path: str, n: int) -> bytes:
    """The file's first ``n`` bytes (none when it cannot be read: the worker
    that loads it raises)."""
    try:
        with open(path, "rb") as f:
            return f.read(n)
    except OSError:
        return b""


def load_groundtruth(path: str):
    """TUM groundtruth.txt -> (timestamps (N,), poses (N,4,4) world<-cam)
    (GroundTruthOdometry.cpp semantics)."""
    from .traj import from_tum_line

    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, T = from_tum_line(line)
            ts.append(t)
            poses.append(T)
    return np.asarray(ts), np.stack(poses)


def associate_gt(frame_ts: np.ndarray, gt_ts: np.ndarray, gt_poses: np.ndarray,
                 max_dt: float = 0.02):
    """Nearest-timestamp GT association; returns (poses, valid mask)."""
    idx = np.searchsorted(gt_ts, frame_ts)
    idx = np.clip(idx, 1, len(gt_ts) - 1)
    left = gt_ts[idx - 1]
    right = gt_ts[idx]
    pick = np.where(np.abs(frame_ts - left) < np.abs(frame_ts - right), idx - 1, idx)
    valid = np.abs(gt_ts[pick] - frame_ts) <= max_dt
    return gt_poses[pick], valid


def write_sequence(root: str, depths: np.ndarray, rgbs: np.ndarray, timestamps,
                   poses: np.ndarray | None = None, filters=None) -> None:
    """Write a TUM-layout sequence: ``rgb/<ts>.png`` (8-bit RGB),
    ``depth/<ts>.png`` (16-bit, 5000 per metre),
    ``associations.txt`` and, when ``poses`` (N,4,4 camera-to-world) are
    given, ``groundtruth.txt``.  ``filters``: the PNG row filters
    (``io.png.encode``)."""
    from .traj import save_tum

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    lines = []
    for ts, d, c in zip(timestamps, depths, rgbs):
        name = f"{ts:.6f}.png"
        d16 = np.clip(np.round(np.asarray(d) / TUM_DEPTH_SCALE), 0, 65535).astype(np.uint16)
        rgb8 = (np.clip(np.asarray(c), 0, 1) * 255).astype(np.uint8)
        png.write(os.path.join(root, "depth", name), d16, filters)
        png.write(os.path.join(root, "rgb", name), rgb8, filters)
        lines.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}\n")
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.writelines(lines)
    if poses is not None:
        save_tum(os.path.join(root, "groundtruth.txt"), timestamps, poses)
