"""Images decoded by their content, as Pillow's ``Image.open`` picks a
format from a file's first bytes (the JAX package opens TUM colour and
depth files and non-raw ``.klg`` colour payloads with Pillow).

Colour (``decode_colour``): a JPEG SOI marker goes to the port's JPEG
decoder (``io/jpeg``), the PNG signature to ``io/png.decode_rgb``; each
gives Pillow's ``convert("RGB")`` as (H, W, 3) uint8.  Depth
(``decode_depth``): PNG to ``io/png.decode``, ``P2`` / ``P5`` to
``io/pnm``, ``II*\\0`` / ``MM\\0*`` to ``io/tiff``; each gives
``np.asarray(Image.open(...))``.  Any other content raises ``ValueError``;
``read_colour`` / ``read_depth`` name the file in every error.
"""

from __future__ import annotations

import numpy as np

from . import jpeg, png, pnm, tiff

JPEG_SOI = b"\xff\xd8"


def decode_colour(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG stream."""
    if data[:2] == JPEG_SOI:
        return jpeg.decode(data)
    if data[:8] == png.SIGNATURE:
        return png.decode_rgb(data)
    raise ValueError(f"neither a JPEG nor a PNG image (it starts with {bytes(data[:8])!r})")


def decode_depth(data: bytes) -> np.ndarray:
    """(H, W) array of a PNG, PGM or TIFF depth image."""
    if data[:8] == png.SIGNATURE:
        return png.decode(data)
    if data[:2] in pnm.MAGICS:
        return pnm.decode(data)
    if data[:4] in tiff.MAGICS:
        return tiff.decode(data)
    raise ValueError(f"not a PNG, PGM or TIFF image (it starts with {bytes(data[:8])!r})")


def _read(path: str, decode) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except (RuntimeError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from e


def read_colour(path: str) -> np.ndarray:
    """:func:`decode_colour` of a file; an error names the file."""
    return _read(path, decode_colour)


def read_depth(path: str) -> np.ndarray:
    """:func:`decode_depth` of a file; an error names the file."""
    return _read(path, decode_depth)
