"""PNG read and write with ``zlib`` and numpy alone.

The JAX package reads the TUM RGB-D frames through Pillow
(``hrbffusion3d_tpu/io/tum.py``); the port decodes them itself, so that it
needs no imaging library: non-interlaced PNG of 8 or 16 bits per sample,
grey, grey + alpha, RGB or RGBA (TUM's 8-bit RGB colour and 16-bit
big-endian grey depth among them), every chunk's CRC checked.

Decoding undoes the five row filters of the PNG standard (None, Sub, Up,
Average, Paeth).  Sub, Up and None are whole-row numpy operations, so an
image that uses only them is decoded row by row.  Average and Paeth predict
each byte from its decoded left neighbour, which a row cannot vectorise;
an image that has such rows is decoded as one wavefront instead: pixel
(r, j) depends on (r, j-1), (r-1, j) and (r-1, j-1) only, so every pixel
with r + j = s is decoded in step s, all rows at once, in W + H - 1 numpy
steps over a skewed copy of the image.

The writer filters each row with the type the caller names (one for all
rows, or one per row) or, by default, with the type whose filtered bytes
have the least sum of absolute values as signed bytes (libpng's
heuristic).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# colour type -> samples per pixel (grey, RGB, grey + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + payload) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left ``a``, up ``b`` and upper-left ``c``
    (int16 arrays): the one nearest to a + b - c, ties to a, then b."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of None, Sub and Up filters only, decoded one row at a time."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f = ftype[r]
        if f == NONE:
            out[r] = raw[r]
        elif f == SUB:       # running sum along each byte lane, mod 256
            out[r] = np.cumsum(raw[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:                # UP
            out[r] = raw[r] + prev
        prev = out[r]
    return out


def _unfilter_wavefront(ftype: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters: anti-diagonal wavefront over pixels.

    ``T[s + 2, r + 1]`` holds the bytes of pixel (r, s - r); row 0 of ``T``
    and its first two steps stay zero, which is what the filters read
    before the first row and left of the first pixel."""
    h, stride = raw.shape
    w = stride // bpp
    pix = raw.reshape(h, w, bpp).astype(np.int16)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    skew_raw = np.zeros((w + h - 1, h, bpp), np.int16)
    skew_raw[rows + cols, rows] = pix
    T = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    ft = ftype.astype(np.intp)[:, None]
    for s in range(w + h - 1):
        r0, r1 = max(0, s - w + 1), min(h - 1, s) + 1
        a = T[s + 1, r0 + 1:r1 + 1]        # left: (r, j - 1)
        b = T[s + 1, r0:r1]                # up: (r - 1, j)
        c = T[s, r0:r1]                    # upper left: (r - 1, j - 1)
        pred = np.choose(ft[r0:r1], (np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)))
        T[s + 2, r0 + 1:r1 + 1] = (skew_raw[s, r0:r1] + pred) & 0xFF
    return T[rows + cols + 2, rows + 1].astype(np.uint8).reshape(h, stride)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) array, uint8 or uint16."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} (palette) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 or 16)")
    if compression != 0 or filter_method != 0 or interlace != 0:
        raise ValueError("interlaced or non-standard PNG is not supported")
    ch = _CHANNELS[colour]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {h * (w * bpp + 1)}")
    raw = raw.reshape(h, w * bpp + 1)
    ftype = raw[:, 0]
    if ftype.size and ftype.max() > PAETH:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not defined")
    hard = np.isin(ftype, (AVERAGE, PAETH)).any()
    out = (_unfilter_wavefront if hard else _unfilter_rows)(ftype, raw[:, 1:], bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape((h, w) if ch == 1 else (h, w, ch))


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _filtered(x: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, stride) uint8: every row under each of the five filters."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    return np.stack([(x - p) & 0xFF for p in preds]).astype(np.uint8)


def encode(img: np.ndarray, filters=None) -> bytes:
    """(H, W) or (H, W, C) uint8 / uint16 array -> PNG bytes.  ``filters``:
    one filter type for every row, a sequence of one per row, or None for
    the least-sum-of-absolute-values choice per row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16, got {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    colour = {v: k for k, v in _CHANNELS.items()}.get(ch)
    if colour is None:
        raise ValueError(f"PNG images have 1-4 channels, got {ch}")
    depth = 8 * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    x = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    cand = _filtered(x.reshape(h, w * bpp), bpp)
    if filters is None:
        ftype = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
    else:
        ftype = np.broadcast_to(np.asarray(filters, np.intp), (h,))
        if ftype.size and (ftype.min() < NONE or ftype.max() > PAETH):
            raise ValueError("PNG row filters are 0-4")
    rows = np.concatenate([ftype.astype(np.uint8)[:, None], cand[ftype, np.arange(h)]], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, filters=None) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, filters))
