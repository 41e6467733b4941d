"""A numpy BMP writer for the port's BMP decoder tests: what Pillow cannot
write (Pillow writes 40-byte headers, bottom-up rows and no compression).

``encode(img, bits, ...)`` writes one image as a Windows bitmap (``BM``)
or, with ``dib=True``, as a headerless DIB:

  - ``bits`` 1, 4 or 8: ``img`` (H, W) holds palette indices, written
    with ``palette`` ((N, 3) uint8 RGB; ``colors`` entries in the header,
    0 for "all");
  - 16: ``img`` (H, W, 3) uint8 RGB, written as 5-5-5 or, with
    ``masks=(0xF800, 0x7E0, 0x1F)``, 5-6-5 bitfields;
  - 24 and 32: (H, W, 3) or (H, W, 4) RGB(A); 32 bits as BGRX, or laid out
    by the bitfield ``masks`` (R, G, B[, A]);
  - ``header`` 12 (OS/2: 16-bit size, 3-byte palette entries), 40, 52, 56,
    64, 108 or 124; with bitfields and a 40-byte header the masks follow
    the header;
  - ``top_down`` stores the rows top to bottom (a negative height);
  - ``rle`` 8 or 4 (``bits`` 8 or 4): run-length data, each row as
    encoded runs (3 or more equal pixels) and absolute runs (3 or more
    pixels, padded to 16 bits), ended by end-of-line, the image by
    end-of-bitmap; ``delta_row`` puts a delta escape (right 1, up 1) at
    the start of that stored row, whose first pixel and the pixel above
    it are then left to index 0; ``drop_eol`` leaves out the end-of-line
    escapes.
"""

from __future__ import annotations

import struct

import numpy as np

_MASKS = {0xFF0000: 2, 0xFF00: 1, 0xFF: 0, 0xFF000000: 3}


def _runs(row: np.ndarray, rle: int) -> bytes:
    """One row's runs: encoded where 3 or more pixels repeat, absolute
    (3 or more pixels) or encoded singles elsewhere."""
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 254:
            j += 1
        if j - i >= 2 or n - i < 3:
            count = j - i + 1
            value = int(row[i]) if rle == 8 else (int(row[i]) << 4) | int(row[i])
            out += bytes([count, value])
            i = j + 1
            continue
        start = i
        while i < n and i - start < 255:
            if i + 2 < n and row[i] == row[i + 1] == row[i + 2]:
                break
            i += 1
        span = row[start:i]
        if len(span) < 3:
            for v in span:
                out += bytes([1, int(v) if rle == 8 else int(v) << 4])
            continue
        if rle == 8:
            body = bytes(int(v) for v in span)
        else:
            padded = np.concatenate([span, np.zeros(len(span) % 2, span.dtype)])
            body = bytes(int(a) << 4 | int(b) for a, b in zip(padded[0::2], padded[1::2]))
        out += bytes([0, len(span)]) + body + (b"\0" if len(body) % 2 else b"")
    return bytes(out)


def _rle(stored: np.ndarray, rle: int, delta_row: int | None, drop_eol: bool) -> bytes:
    out = bytearray()
    for r, row in enumerate(stored):
        if r == delta_row:
            out += bytes([0, 2, 1, 1])
            row = row[1:]
        out += _runs(row, rle)
        if not drop_eol:
            out += b"\0\0"
    return bytes(out + b"\0\1")


def encode(img: np.ndarray, bits: int, palette=None, header: int = 40, top_down: bool = False,
           masks=None, rle: int | None = None, colors: int = 0, dib: bool = False,
           delta_row: int | None = None, drop_eol: bool = False) -> bytes:
    img = np.asarray(img)
    h, w = img.shape[:2]
    stored = img if top_down else img[::-1]
    compression = 0
    if rle:
        compression = 1 if rle == 8 else 2
        pixels = _rle(stored, rle, delta_row, drop_eol)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits <= 8:
            rows = np.packbits(np.unpackbits(stored.astype(np.uint8)[..., None], axis=2)
                               [..., 8 - bits:].reshape(h, w * bits), axis=1)
        elif bits == 16:
            c = stored.astype(np.uint16)
            if masks == (0xF800, 0x7E0, 0x1F):
                v = (c[..., 0] >> 3 << 11) | (c[..., 1] >> 2 << 5) | (c[..., 2] >> 3)
            else:
                v = (c[..., 0] >> 3 << 10) | (c[..., 1] >> 3 << 5) | (c[..., 2] >> 3)
            rows = v.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        elif bits == 24:
            rows = stored[..., 2::-1].reshape(h, 3 * w)
        else:
            px = np.zeros((h, w, 4), np.uint8)
            order = masks or (0xFF0000, 0xFF00, 0xFF)
            for band, mask in enumerate(order):
                if mask:
                    px[..., _MASKS[mask]] = stored[..., band] if band < stored.shape[2] else 255
            rows = px.reshape(h, 4 * w)
        body = np.zeros((h, stride), np.uint8)
        body[:, :rows.shape[1]] = rows
        pixels = body.tobytes()
    if masks is not None:
        compression = 3
    pal = b""
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            entries = np.concatenate([entries, np.zeros((len(entries), 1), np.uint8)], 1)
        pal = entries.tobytes()
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        if masks is not None and header >= 52:
            info += struct.pack("<" + "I" * (4 if header >= 56 else 3),
                                *(tuple(masks) + (0,) * 4)[:4 if header >= 56 else 3])
        elif masks is not None:
            extra = struct.pack("<III", *masks[:3])
        info = info.ljust(header, b"\0")
    body = info + extra + pal + pixels
    if dib:
        return body
    offset = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, offset) + body
