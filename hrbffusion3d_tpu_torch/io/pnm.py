"""Netpbm decoding with numpy only: images that the JAX package opens with
Pillow (``np.asarray(Image.open(path))`` for TUM depth and
``Image.open(path).convert("RGB")`` for TUM colour, in
``hrbffusion3d_tpu/io/tum.py``).

It reads every form of Pillow 12's ``PpmImagePlugin``: bitmaps (``P1``
plain, ``P4`` binary; mode ``1``), grey (``P2``, ``P5``; mode ``L``, or
``I`` above maxval 255), colour (``P3``, ``P6``; mode ``RGB``) at any
maxval from 1 to 65535, float grey (``Pf``; mode ``F``), and Pillow's
binary extensions of its ``MODES``: ``P0CMYK`` and ``PyCMYK`` (``CMYK``),
``PyRGBA`` (``RGBA``) and ``PyP`` (``P``, with an empty palette: every
index converts to black); and gives what Pillow gives:

  - the header is read token by token as Pillow reads it: any whitespace
    between tokens, ``#`` comments up to the end of their line (a comment
    inside a token leaves the token's two halves joined), tokens of at
    most 10 bytes, the samples starting right after the one whitespace
    byte that ends the last token (maxval; the height of a bitmap; the
    scale of ``Pf``);
  - binary samples at maxval 255 or, in ``P5``, 65535 (big-endian) as
    they are; at any other maxval, and always in plain files, rescaled to
    the mode's range as Pillow rescales them:
    ``round(value / maxval * out_max)`` (Python's ``round``, half to even,
    on the float64 quotient), out_max 65535 for mode ``I`` and 255 else
    (so the colour forms at maxval 65535 keep about the high byte), clipped to
    out_max in binary files; a plain sample above maxval or negative is an
    error;
  - in plain data, a comment runs from ``#`` through the first CR or LF,
    which it takes with it (so ``12#c\\n34`` is the one token ``1234``);
    plain bitmap samples are single ``0`` / ``1`` bytes, whitespace
    optional;
  - bitmaps: 1 is black (``False``); ``P4`` rows padded to whole bytes;
  - ``Pf``: little-endian float32 when the scale is negative, big-endian
    when positive (zero, infinite or NaN is an error), rows stored bottom
    to top.

``decode`` gives ``np.asarray(Image.open(...))``, ``decode_mode`` Pillow's
mode beside it (``io/image`` converts colour through ``io/modes``).
``PF`` colour float, which Pillow does not open, and truncated files raise
``ValueError``.
"""

from __future__ import annotations

import math
import re

import numpy as np

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
# the magics ``image`` tells netpbm files by (Pillow accepts a "P" and any of
# "0123456fy" and then reads the whole magic)
MAGICS = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf")
# magic -> (mode, bands) of maxval <= 255 (PpmImagePlugin.MODES)
_MODES = {b"P1": ("1", 1), b"P4": ("1", 1), b"P2": ("L", 1), b"P5": ("L", 1),
          b"P3": ("RGB", 3), b"P6": ("RGB", 3), b"Pf": ("F", 1), b"P0CMYK": ("CMYK", 4),
          b"PyP": ("P", 1), b"PyRGBA": ("RGBA", 4), b"PyCMYK": ("CMYK", 4)}
_MAX_TOKEN = 10
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")


def _header(data: bytes):
    """(magic, width, height, maxval or the ``Pf`` scale (None for a
    bitmap), offset of the first sample)."""
    pos, magic = 0, b""
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise ValueError(f"not a netpbm file (magic {magic!r}; P1-P6, Pf, P0CMYK, PyP, "
                         "PyRGBA and PyCMYK are read)")

    def token() -> bytes:
        nonlocal pos
        tok = b""
        while len(tok) <= _MAX_TOKEN:
            c = data[pos:pos + 1]
            pos += 1
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok:
            raise ValueError("the header ends before its last token")
        if len(tok) > _MAX_TOKEN:
            raise ValueError(f"header token too long: {tok!r}")
        return tok

    def number(tok: bytes) -> int:
        try:
            return int(tok)
        except ValueError:
            raise ValueError(f"header token is not a number: {tok!r}") from None

    width, height = number(token()), number(token())
    if width < 0 or height < 0:
        raise ValueError(f"negative size {width}x{height}")
    if magic in (b"P1", b"P4"):
        return magic, width, height, None, pos
    if magic == b"Pf":
        tok = token()
        try:
            scale = float(tok)
        except ValueError:
            raise ValueError(f"Pf scale is not a number: {tok!r}") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"Pf scale {tok.decode(errors='replace')}: must be finite and "
                             "non-zero")
        return magic, width, height, scale, pos
    maxval = number(token())
    if not 0 < maxval < 65536:
        raise ValueError(f"maxval {maxval}: must be greater than 0 and less than 65536")
    return magic, width, height, maxval, pos


def _rescale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * out_max)``."""
    return np.round(values.astype(np.float64) / maxval * out_max)


def _plain(body: bytes, count: int, maxval: int) -> np.ndarray:
    """The first ``count`` samples of ``P2`` / ``P3`` data as int64."""
    tokens = _COMMENT.sub(b"", body).split()
    if len(tokens) < count:
        raise ValueError(f"{len(tokens)} samples of {count}")
    tokens = tokens[:count]
    long = [t for t in tokens if len(t) > _MAX_TOKEN]
    if long:
        raise ValueError(f"sample token too long: {long[0][:_MAX_TOKEN + 1]!r}")
    try:
        values = np.array([int(t) for t in tokens], np.int64)
    except ValueError as e:
        raise ValueError(f"sample is not a number: {e}") from None
    if count and values.min() < 0:
        raise ValueError(f"sample is negative: {values.min()}")
    if count and values.max() > maxval:
        raise ValueError(f"sample {values.max()} above maxval {maxval}")
    return values


def _plain_bits(body: bytes, count: int) -> np.ndarray:
    """The first ``count`` samples of ``P1`` data as bool (1 is black:
    False)."""
    digits = b"".join(_COMMENT.sub(b"", body).split())
    bad = digits.translate(None, b"01")
    if bad:
        raise ValueError(f"bitmap sample is neither 0 nor 1: {bad[:1]!r}")
    if len(digits) < count:
        raise ValueError(f"{len(digits)} samples of {count}")
    return np.frombuffer(digits, np.uint8, count) == ord("0")


def _binary(data: bytes, pos: int, count: int, dtype, what: str) -> np.ndarray:
    dtype = np.dtype(dtype)
    need = count * dtype.itemsize
    if len(data) - pos < need:
        raise ValueError(f"truncated: {max(len(data) - pos, 0)} bytes of samples, {what} "
                         f"needs {need}")
    return np.frombuffer(data, dtype, count, pos)


def decode_mode(data: bytes) -> tuple[str, np.ndarray]:
    """(Pillow's mode, the array ``np.asarray(Image.open(...))`` gives) of a
    netpbm file's bytes."""
    magic, width, height, maxval, pos = _header(data)
    mode, bands = _MODES[magic]
    count = width * height * bands
    shape = (height, width, bands) if bands > 1 else (height, width)
    what = f"{width}x{height} {magic.decode()}" + (f" at maxval {maxval}"
                                                    if mode not in ("1", "F") else "")
    if mode == "1":
        if magic == b"P1":
            return mode, _plain_bits(data[pos:], count).reshape(shape)
        row = (width + 7) // 8
        packed = _binary(data, pos, row * height, np.uint8, what).reshape(height, row)
        bits = np.unpackbits(packed, axis=1)[:, :width]
        return mode, bits == 0
    if mode == "F":
        order = "<" if maxval < 0 else ">"
        values = _binary(data, pos, count, order + "f4", what).reshape(shape)[::-1]
        return mode, values.astype(np.float32)
    wide = mode == "L" and maxval > 255
    if wide:
        mode = "I"
    out_max, dtype = (65535, np.int32) if wide else (255, np.uint8)
    if magic in (b"P2", b"P3"):
        values = _rescale(_plain(data[pos:], count, maxval), maxval, out_max)
    else:
        sample = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        values = _binary(data, pos, count, sample, what)
        if maxval != 255 and not (wide and maxval == 65535):
            values = np.minimum(_rescale(values, maxval, out_max), out_max)
    return mode, values.astype(dtype).reshape(shape)


def decode(data: bytes) -> np.ndarray:
    """The array ``np.asarray(Image.open(...))`` gives of a netpbm file's
    bytes: (H, W) bool (bitmaps), uint8 (maxval <= 255), int32 (above) or
    float32 (``Pf``), or (H, W, 3) uint8 (colour)."""
    return decode_mode(data)[1]
