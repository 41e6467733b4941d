"""JPEG decoding without an imaging library: a binding of the port's own
decoder (``csrc/jpeg_decode.cpp``).

The JAX package decodes JPEG colour with Pillow: the payloads of ``.klg``
logs (``hrbffusion3d_tpu/io/klg.py``) and the colour files of TUM-layout
sequences (``hrbffusion3d_tpu/io/tum.py``).  The port's decoder is
compiled into the native loader's library (``io/native_loader``, one build
for both) and gives the bytes that Pillow's
``Image.open(...).convert("RGB")`` gives: libjpeg-turbo's progressive
scans, its ISLOW integer IDCT, its "fancy" chroma upsampling and its
fixed-point YCbCr -> RGB.

It decodes Huffman-coded 8-bit JPEG, sequential (SOF0 / SOF1) or
progressive (SOF2), of 1 or 3 components with sampling factors up to 2x2
(4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals and non-interleaved scans;
greyscale comes back replicated to RGB.  It refuses arithmetic-coded,
lossless, hierarchical, 12-bit and 4-component streams, a progressive
stream whose first AC coefficients are not fully refined (libjpeg-turbo
smooths its blocks, which the decoder does not reproduce), and truncated
or corrupt data, raising ``RuntimeError`` with the reason.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_loader

_ERR_LEN = 256


def library():
    """The loaded native library; ``RuntimeError`` naming the build error
    when it cannot be built or loaded."""
    if not native_loader.available():
        raise RuntimeError("JPEG decoder unavailable: the native library did not build: "
                           f"{native_loader.status()['build_error']}")
    return native_loader._LIB


def decode(payload: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG stream; ``RuntimeError`` on a stream
    the decoder refuses."""
    lib = library()
    payload = bytes(payload)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_decode(payload, len(payload), ctypes.byref(w), ctypes.byref(h), None, err,
                       _ERR_LEN) != 0:
        raise RuntimeError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(payload, len(payload), ctypes.byref(w), ctypes.byref(h),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err, _ERR_LEN) != 0:
        raise RuntimeError(err.value.decode())
    return out
