""".klg compressed RGB-D log reader (the port's own copy of
``hrbffusion3d_tpu/io/klg.py``, numpy and zlib only).

Replaces ``RawLogReader`` (``GUI/src/Tools/RawLogReader.cpp``): the
ElasticFusion log format — header ``int32 numFrames``; per frame
``int64 timestamp, int32 depthSize, int32 imageSize`` followed by
zlib-compressed u16 depth and JPEG rgb (sizes equal to raw -> uncompressed).

The JAX package decodes a non-raw colour payload with Pillow, whatever
its format.  The port has no imaging library: the payload is decoded by
its content (``io/image.decode_colour``): a JPEG by the port's own JPEG
decoder (``io/jpeg``, compiled into the native loader's library), a PNG,
BMP, netpbm, TIFF, GIF or WebP image by ``io/png``, ``io/bmp``,
``io/pnm``, ``io/tiff``, ``io/gif`` or ``io/webp``, each to Pillow's
bytes.  A frame that fails to decode (a
corrupt zlib or image payload, a payload of another format, a payload cut
short, an image whose size is not ``width`` x ``height``, which the error
names with the form it found) raises ``RuntimeError`` naming the frame's
index.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, NamedTuple

import numpy as np

from . import image


class KLGFrame(NamedTuple):
    timestamp: int
    depth: np.ndarray   # (H,W) float32 meters
    rgb: np.ndarray     # (H,W,3) float32 [0,1]


def frames(path: str, width: int = 640, height: int = 480,
           depth_scale: float = 1.0 / 1000.0) -> Iterator[KLGFrame]:
    raw_depth_size = width * height * 2
    raw_rgb_size = width * height * 3
    with open(path, "rb") as f:
        (num_frames,) = struct.unpack("<i", f.read(4))
        for index in range(num_frames):
            hdr = f.read(8 + 4 + 4)
            if len(hdr) < 16:
                return
            ts, dsize, isize = struct.unpack("<qii", hdr)
            fail = lambda why: RuntimeError(f"{path}: frame {index}: {why}")  # noqa: E731
            if dsize < 0 or isize < 0:
                raise fail(f"negative payload size (depth {dsize}, colour {isize})")
            dbuf = f.read(dsize)
            if len(dbuf) != dsize:
                raise fail(f"depth payload truncated: {len(dbuf)} of {dsize} bytes")
            ibuf = f.read(isize)
            if len(ibuf) != isize:
                raise fail(f"colour payload truncated: {len(ibuf)} of {isize} bytes")
            if dsize == raw_depth_size:
                depth_u16 = np.frombuffer(dbuf, np.uint16)
            else:
                try:
                    raw = zlib.decompress(dbuf)
                except zlib.error as e:
                    raise fail(f"zlib decompression of the depth payload failed: {e}") from e
                if len(raw) != raw_depth_size:
                    raise fail(f"depth inflates to {len(raw)} bytes, {width}x{height} needs "
                               f"{raw_depth_size}")
                depth_u16 = np.frombuffer(raw, np.uint16)
            depth = depth_u16.reshape(height, width).astype(np.float32) * depth_scale
            if isize == raw_rgb_size:
                rgb = np.frombuffer(ibuf, np.uint8).reshape(height, width, 3)
            elif isize == 0:
                rgb = np.zeros((height, width, 3), np.uint8)
            else:
                form = image.form(ibuf) or "unknown-format"
                try:
                    rgb = image.decode_colour(ibuf)
                except (RuntimeError, ValueError) as e:
                    raise fail(f"colour payload: {e}") from e
                if rgb.shape != (height, width, 3):
                    raise fail(f"{form} colour payload is {rgb.shape[1]}x{rgb.shape[0]}, "
                               f"expected {width}x{height}")
            yield KLGFrame(ts, depth, rgb.astype(np.float32) / 255.0)


def write(path: str, depths: np.ndarray, rgbs: np.ndarray,
          timestamps=None, depth_scale: float = 1.0 / 1000.0):
    """Write a .klg (zlib depth + raw rgb) — used by tests and for
    converting synthetic sequences."""
    n, h, w = depths.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<i", n))
        for i in range(n):
            ts = i if timestamps is None else int(timestamps[i])
            d16 = np.round(depths[i] / depth_scale).astype(np.uint16)
            dbuf = zlib.compress(d16.tobytes())
            rgb8 = (np.clip(rgbs[i], 0, 1) * 255).astype(np.uint8)
            ibuf = rgb8.tobytes()
            f.write(struct.pack("<qii", ts, len(dbuf), len(ibuf)))
            f.write(dbuf)
            f.write(ibuf)
