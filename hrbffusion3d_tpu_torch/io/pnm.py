"""PGM (netpbm grey) decoding with numpy only: depth images that the JAX
package opens with Pillow (``np.asarray(Image.open(path))`` in
``hrbffusion3d_tpu/io/tum.py``).

It reads binary ``P5`` and plain (ASCII) ``P2`` files at any maxval from 1
to 65535 and gives what Pillow 12's ``PpmImagePlugin`` gives:

  - the header is read token by token as Pillow reads it: any whitespace
    between tokens, ``#`` comments up to the end of their line (a comment
    inside a token leaves the token's two halves joined), tokens of at
    most 10 bytes, the samples starting right after the one whitespace
    byte that ends maxval;
  - mode ``L`` (uint8) for maxval <= 255, mode ``I`` (int32) above;
  - samples at maxval 255 (``P5``) or 65535 (``P5``, big-endian) as they
    are; at any other maxval, and always for ``P2``, rescaled to the mode's
    range as Pillow rescales them: ``round(value / maxval * out_max)``
    (Python's ``round``, half to even, on the float64 quotient), with
    out_max 255 or 65535, clipped to out_max for ``P5``; a ``P2`` sample
    above maxval or negative is an error;
  - in ``P2`` data, a comment runs from ``#`` through the first CR or LF,
    which it takes with it (so ``12#c\\n34`` is the one token ``1234``).

Other netpbm forms (bitmaps, colour, ``Pf``) and truncated files raise
``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MAGICS = (b"P2", b"P5")
_MAX_TOKEN = 10
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")


def _header(data: bytes):
    """(magic, width, height, maxval, offset of the first sample)."""
    pos, magic = 0, b""
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in WHITESPACE:
            break
        magic += c
    if magic not in MAGICS:
        raise ValueError(f"not a binary or plain PGM file (magic {magic!r}; P2 and P5 "
                         "are read)")

    def token() -> int:
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
        try:
            return int(tok)
        except ValueError:
            raise ValueError(f"header token is not a number: {tok!r}") from None

    width, height, maxval = token(), token(), token()
    if not 0 < maxval < 65536:
        raise ValueError(f"maxval {maxval}: must be greater than 0 and less than 65536")
    if width < 0 or height < 0:
        raise ValueError(f"negative size {width}x{height}")
    return magic, width, height, maxval, pos


def _rescale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * out_max)``."""
    return np.round(values.astype(np.float64) / maxval * out_max)


def _plain(body: bytes, count: int, maxval: int) -> np.ndarray:
    """The first ``count`` samples of ``P2`` data as int64."""
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


def decode(data: bytes) -> np.ndarray:
    """(H, W) uint8 (maxval <= 255) or int32 (above) of a ``P2`` / ``P5``
    file's bytes, as ``np.asarray(Image.open(...))``."""
    magic, width, height, maxval, pos = _header(data)
    count = width * height
    wide = maxval > 255
    out_max, dtype = (65535, np.int32) if wide else (255, np.uint8)
    if magic == b"P2":
        values = _rescale(_plain(data[pos:], count, maxval), maxval, out_max)
    else:
        sample = np.dtype(">u2") if wide else np.dtype(np.uint8)
        need = count * sample.itemsize
        if len(data) - pos < need:
            raise ValueError(f"truncated: {max(len(data) - pos, 0)} bytes of samples, "
                             f"{width}x{height} at maxval {maxval} needs {need}")
        values = np.frombuffer(data, sample, count, pos)
        if maxval not in (255, 65535):
            values = np.minimum(_rescale(values, maxval, out_max), out_max)
    return values.astype(dtype).reshape(height, width)


def read(path: str) -> np.ndarray:
    """:func:`decode` of a file; an error names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
