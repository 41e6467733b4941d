"""JPEG decoding without an imaging library: a binding of the port's own
decoder (``csrc/jpeg_decode.cpp``).

The JAX package decodes JPEG colour with Pillow: the payloads of ``.klg``
logs (``hrbffusion3d_tpu/io/klg.py``) and the colour files of TUM-layout
sequences (``hrbffusion3d_tpu/io/tum.py``).  The port's decoder is
compiled into the native loader's library (``io/native_loader``, one build
for both) and gives the bytes that Pillow's
``Image.open(...).convert("RGB")`` gives: libjpeg-turbo's entropy
decoders, its ISLOW integer IDCT and block smoothing, its upsampling and
its fixed-point colour conversion.

It decodes 8-bit JPEG of 1, 3 or 4 components: Huffman- or
arithmetic-coded, sequential (SOF0 / SOF1 / SOF9) or progressive (SOF2 /
SOF10), and lossless (SOF3, predictors 1-7, point transforms, Huffman);
greyscale, RGB, YCbCr, CMYK and YCCK (what Pillow makes of four channels:
its inverted "CMYK;I", then its CMYK -> RGB); sampling factors 1-4 in
integer ratios (libjpeg-turbo's fancy filters for a ratio of 2,
replication for others and for lossless); restart intervals and
non-interleaved scans; a progressive image whose first AC coefficients
are not fully refined, smoothed as libjpeg-turbo smooths it.  Greyscale
comes back replicated to RGB (``decode``), or as Pillow's mode ``L`` for
depth (``decode_mode``).  A TIFF's strips and tiles (``io/tiff``) are
decoded after its JPEGTables, as libtiff hands libjpeg a tables-only
stream first, with their components as stored or as YCbCr converted to
RGB (``decode_form``).  It refuses, as Pillow does, hierarchical
and arithmetic-coded lossless streams, 12-bit and other precisions,
fractional sampling ratios and lossless YCbCr or YCCK, and it refuses
truncated or corrupt data (where libjpeg-turbo warns and goes on),
raising ``RuntimeError`` with the reason.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from . import native_loader

_ERR_LEN = 256


def library():
    """The loaded native library; ``RuntimeError`` naming the build error
    when it cannot be built or loaded."""
    return native_loader.library("JPEG decoder")


# ``form`` of the C entry: RGB as Pillow converts it; the components as
# stored; RGB from samples taken as YCbCr
RGB, COMPONENTS, YCBCR = 0, 1, 2
# Pillow's mode of a stream of 1, 3 or 4 components
MODES = {1: "L", 3: "RGB", 4: "CMYK"}


class Info(NamedTuple):
    width: int
    height: int
    components: int
    sampling: tuple  # (h, v) factors of each component


def _call(lib, payload: bytes, tables: bytes, form: int, info, out):
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_decode(tables, len(tables), payload, len(payload), form, info, out, err,
                       _ERR_LEN) != 0:
        raise RuntimeError(err.value.decode())


def info(payload: bytes, tables: bytes = b"") -> Info:
    """The frame header's size, component count and sampling factors (after
    the tables-only stream ``tables``, if given); ``RuntimeError`` on a
    stream the decoder refuses."""
    raw = (ctypes.c_int * 11)()
    _call(library(), bytes(payload), bytes(tables), RGB, raw, None)
    n = raw[2]
    return Info(raw[0], raw[1], n, tuple((raw[3 + 2 * c], raw[4 + 2 * c]) for c in range(n)))


def decode_form(payload: bytes, form: int = RGB, tables: bytes = b"") -> np.ndarray:
    """(H, W, 3) uint8 RGB (``form`` RGB or YCBCR), or (H, W, components) as
    stored (COMPONENTS), of a JPEG stream read after the tables-only stream
    ``tables`` (a TIFF's JPEGTables); ``RuntimeError`` on a stream the
    decoder refuses."""
    lib = library()
    payload, tables = bytes(payload), bytes(tables)
    raw = (ctypes.c_int * 11)()
    _call(lib, payload, tables, RGB, raw, None)
    out = np.empty((raw[1], raw[0], raw[2] if form == COMPONENTS else 3), np.uint8)
    _call(lib, payload, tables, form, raw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def decode(payload: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG stream, what Pillow's ``convert("RGB")``
    gives; ``RuntimeError`` on a stream the decoder refuses."""
    return decode_form(payload)


def decode_mode(payload: bytes) -> tuple[str, np.ndarray]:
    """(Pillow's mode, ``np.asarray(Image.open(...))``) of a greyscale JPEG
    stream: ("L", (H, W) uint8); a stream of 3 or 4 components raises
    ``ValueError`` naming its mode (``RGB``, ``CMYK``), as a depth image has
    one band."""
    n = info(payload).components
    if n != 1:
        raise ValueError(f"JPEG image of mode {MODES.get(n, n)}: a depth image has one band")
    return "L", decode_form(payload, COMPONENTS)[..., 0]
