"""PNG read and write with ``zlib`` and numpy alone.

The JAX package reads the TUM RGB-D frames through Pillow
(``hrbffusion3d_tpu/io/tum.py``); the port decodes them itself, so that it
needs no imaging library.  It reads every PNG that the standard defines:
grey at 1, 2, 4, 8 or 16 bits, palette at 1-8 bits (``tRNS`` skipped,
as Pillow's ``convert("RGB")`` ignores it), RGB, grey + alpha and
RGBA at 8 or 16 bits, each non-interlaced or Adam7-interlaced, every
chunk's CRC checked.  ``decode`` returns what
``np.asarray(Image.open(...))`` returns in Pillow, ``decode_rgb`` what
``Image.open(...).convert("RGB")`` gives (the two differ in Pillow's
modes: 16-bit colour keeps the high byte of each sample, 16-bit grey stays
16-bit in ``decode`` and clamps at 255 in ``decode_rgb``, 1-bit grey is
boolean in ``decode`` and 0 / 255 in ``decode_rgb``, 2- and 4-bit grey are
scaled to 0-255 in both, palette indices beyond ``PLTE`` are black).

Decoding undoes the five row filters of the PNG standard (None, Sub, Up,
Average, Paeth) on each of the image's passes (one, or Adam7's seven, each
with its own row width; a pass that is empty in either direction has no
bytes), over bytes with the filter's byte step ``bpp`` (1 below 8 bits);
samples below 8 bits are unpacked most significant bits first.  Sub, Up
and None are whole-row numpy operations, so a pass that uses only them is
decoded row by row.  Average and Paeth predict each byte from its decoded
left neighbour, which a row cannot vectorise; a pass that has such rows is
decoded as one wavefront instead: pixel (r, j) depends on (r, j-1),
(r-1, j) and (r-1, j-1) only, so every pixel with r + j = s is decoded in
step s, all rows at once, in W + H - 1 numpy steps over a skewed copy of
the pass.

The writer writes 8- or 16-bit grey, grey + alpha, RGB or RGBA,
non-interlaced, and filters each row with the type the caller names (one
for all rows, or one per row) or, by default, with the type whose filtered
bytes have the least sum of absolute values as signed bytes (libpng's
heuristic).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import modes

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
GREY, RGB, PALETTE, GREY_ALPHA, RGBA = 0, 2, 3, 4, 6
# colour type -> samples per pixel
_CHANNELS = {GREY: 1, RGB: 3, PALETTE: 1, GREY_ALPHA: 2, RGBA: 4}
# colour type -> the bit depths the PNG standard allows
_DEPTHS = {GREY: (1, 2, 4, 8, 16), RGB: (8, 16), PALETTE: (1, 2, 4, 8), GREY_ALPHA: (8, 16),
           RGBA: (8, 16)}
# Adam7's passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


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


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, n) samples, uint8 or uint16; below
    8 bits each byte holds 8 / depth samples, most significant bits first."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)
    if depth == 8:
        return rows
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(len(rows), -1)[:, :n]


def _passes(w: int, h: int, interlace: int):
    """(first row, first column, row step, column step, rows, columns) of
    each pass that holds pixels."""
    for r0, c0, dr, dc in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = (h - r0 + dr - 1) // dr, (w - c0 + dc - 1) // dc
        if ph > 0 and pw > 0:
            yield r0, c0, dr, dc, ph, pw


def _decode(data: bytes):
    """(the array ``np.asarray(Image.open(...))`` gives, the palette as
    (256, 3) uint8 or None)."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not defined")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG bit depth {depth} is not defined for colour type {colour} "
                         f"(allowed: {_DEPTHS[colour]})")
    if compression != 0 or filter_method != 0 or interlace not in (0, 1):
        raise ValueError(f"PNG compression {compression}, filter method {filter_method} or "
                         f"interlace method {interlace} is not defined")
    if colour == PALETTE:
        if palette is None or len(palette) % 3 or not 0 < len(palette) <= 768:
            raise ValueError("palette PNG without a valid PLTE chunk")
        entries = np.zeros((256, 3), np.uint8)     # indices beyond PLTE are black
        entries[:len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        palette = entries
    else:
        palette = None
    ch = _CHANNELS[colour]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = list(_passes(w, h, interlace))
    strides = [(pw * ch * depth + 7) // 8 for *_, pw in passes]
    need = sum(ph * (stride + 1) for (*_, ph, _), stride in zip(passes, strides))
    if raw.size != need:
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {need}")
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (r0, c0, dr, dc, ph, pw), stride in zip(passes, strides):
        part = raw[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1)
        pos += part.size
        ftype = part[:, 0]
        if ftype.max() > PAETH:
            raise ValueError(f"PNG row filter {int(ftype.max())} is not defined")
        hard = np.isin(ftype, (AVERAGE, PAETH)).any()
        rows = (_unfilter_wavefront if hard else _unfilter_rows)(ftype, part[:, 1:], bpp)
        out[r0::dr, c0::dc] = _samples(rows, pw * ch, depth).reshape(ph, pw, ch)
    # Pillow's mode for the file (PngImagePlugin's rawmodes)
    if colour in (GREY, PALETTE):
        out = out[..., 0]
        if colour == GREY and depth == 1:
            out = out.astype(bool)                          # "1"
        elif colour == GREY and depth < 8:
            out *= 255 // ((1 << depth) - 1)                # "L;2", "L;4"
    elif depth == 16:
        out = (out >> 8).astype(np.uint8)                   # the high byte
        if colour == GREY_ALPHA:
            out = out[..., [0, 0, 0, 1]]                    # "LA;16B" -> RGBA
    return out, palette


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> the array ``np.asarray(Image.open(...))`` gives in
    Pillow: (H, W) or (H, W, C), uint8, uint16 (16-bit grey) or bool (1-bit
    grey); a palette image's indices."""
    return _decode(data)[0]


def decode_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, what Pillow's
    ``Image.open(...).convert("RGB")`` gives (``io/modes.to_rgb`` of the
    file's mode): palette colours from PLTE, grey replicated (16-bit grey
    clamped at 255), alpha dropped."""
    img, palette = _decode(data)
    if palette is not None:
        mode = "P"
    elif img.ndim == 2:
        mode = {np.dtype(bool): "1", np.dtype(np.uint16): "I;16"}.get(img.dtype, "L")
    else:
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[img.shape[2]]
    return modes.to_rgb(mode, img, palette)


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
    colour = {1: GREY, 2: GREY_ALPHA, 3: RGB, 4: RGBA}.get(ch)
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
