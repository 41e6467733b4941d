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
comes back replicated to RGB.  It refuses, as Pillow does, hierarchical
and arithmetic-coded lossless streams, 12-bit and other precisions,
fractional sampling ratios and lossless YCbCr or YCCK, and it refuses
truncated or corrupt data (where libjpeg-turbo warns and goes on),
raising ``RuntimeError`` with the reason.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_loader

_ERR_LEN = 256


def library():
    """The loaded native library; ``RuntimeError`` naming the build error
    when it cannot be built or loaded."""
    return native_loader.library("JPEG decoder")


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
