"""Images decoded by their content, as Pillow's ``Image.open`` picks a
format from a file's first bytes (the JAX package opens TUM colour and
depth files and non-raw ``.klg`` colour payloads with Pillow).

``form`` tells the format by the tests of Pillow's plugins, in the order
``Image.open`` tries them (the plugins it loads first, then TIFF): ``BM``
(BMP), a little-endian 32-bit info header size of 12, 40, 52, 56, 64, 108
or 124 (a headerless DIB), a JPEG SOI marker, ``P1``-``P6``, ``Pf`` and
Pillow's ``P0`` / ``Py`` magics (netpbm), the PNG signature, ``II*\\0`` / ``MM\\0*`` (TIFF; and the
prefixes Pillow takes for TIFF too: the two bytes after the byte order
swapped, and BigTIFF's ``II+\\0`` / ``MM\\0+``).  Each goes to
the port's own decoder: ``io/bmp``, ``io/jpeg``, ``io/pnm``, ``io/png``,
``io/tiff``.

Colour (``decode_colour``): any of them, as Pillow's ``convert("RGB")``
gives it, (H, W, 3) uint8 (``io/modes``).  Depth (``decode_depth``): any
single-band image, greyscale JPEG too (mode ``L``), as
``np.asarray(Image.open(...))`` gives it; a multi-band image raises naming
its mode (the JAX package reads it and fails later).  Any other content
raises ``ValueError``; ``read_colour`` / ``read_depth`` name the file in
every error.
"""

from __future__ import annotations

import numpy as np

from . import bmp, jpeg, modes, png, pnm, tiff

JPEG_SOI = b"\xff\xd8"
FORMS = ("BMP", "DIB", "JPEG", "netpbm", "PNG", "TIFF")


def form(data: bytes) -> str | None:
    """The format Pillow would take ``data`` for, of those the port reads
    (``FORMS``), or None."""
    if data[:2] == bmp.MAGIC:
        return "BMP"
    if bmp.is_dib(data):
        return "DIB"
    if data[:2] == JPEG_SOI:
        return "JPEG"
    if data[:2] in pnm.MAGICS or (data[:1] == b"P" and data[1:2] in (b"0", b"y")):
        return "netpbm"
    if data[:8] == png.SIGNATURE:
        return "PNG"
    if data[:4] in tiff.PREFIXES:
        return "TIFF"
    return None


def needs_library(head: bytes) -> bool:
    """Whether decoding a file that starts with ``head`` (its first 64 bytes)
    calls the native library: JPEG, TIFF, and BMP run-length data."""
    kind = form(head)
    if kind in ("JPEG", "TIFF"):
        return True
    if kind in ("BMP", "DIB"):
        at = 14 if kind == "BMP" else 0
        size = int.from_bytes(head[at:at + 4], "little")
        compression = int.from_bytes(head[at + 16:at + 20], "little") if size > 12 else 0
        return compression in (bmp.RLE8, bmp.RLE4)
    return False


def _decode_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    kind = form(data)
    if kind in ("BMP", "DIB"):
        return bmp.decode_mode(data)
    if kind == "netpbm":
        mode, img = pnm.decode_mode(data)
        # Pillow gives a netpbm P image an empty palette
        return mode, img, np.zeros((0, 3), np.uint8) if mode == "P" else None
    if kind == "TIFF":
        return tiff.decode_mode(data)
    raise ValueError(f"not a form the port reads ({', '.join(FORMS)}): it starts with "
                     f"{bytes(data[:8])!r}")


def decode_colour(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB, what Pillow's ``convert("RGB")`` gives."""
    kind = form(data)
    if kind == "JPEG":
        return jpeg.decode(data)
    if kind == "PNG":
        return png.decode_rgb(data)
    return modes.to_rgb(*_decode_mode(data))


def decode_depth(data: bytes) -> np.ndarray:
    """(H, W) array of a single-band image, as ``np.asarray(Image.open(...))``
    gives it (16-bit samples in native byte order)."""
    kind = form(data)
    if kind == "PNG":
        img = png.decode(data)
        mode = "PNG of several channels" if img.ndim == 3 else None
    elif kind == "JPEG":
        img, mode = jpeg.decode_mode(data)[1], None
    else:
        mode, img, _ = _decode_mode(data)
        mode = f"mode {mode}" if modes.BANDS[mode] != 1 else None
    if mode is not None:
        raise ValueError(f"{kind} image of {mode}: a depth image has one band")
    return img


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
