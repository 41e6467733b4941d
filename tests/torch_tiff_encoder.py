"""A numpy TIFF writer for the port's TIFF decoder tests: what Pillow cannot
write (predictor 2 or 3, big-endian files, old-style LZW, strips of a few
rows, the forms the decoder refuses).

``encode(img, ...)`` writes one grey image (H, W) of dtype uint8, uint16,
int16, uint32, int32 or float32 as a baseline strip TIFF: byte order
``"II"`` or ``"MM"``, compression 1 (none), 5 (LZW, new-style or
``old_lzw``), 8 / 32946 (deflate) or 32773 (PackBits), predictor 1, 2
(horizontal differencing of the samples) or 3 (floating point: byte planes,
most significant first, then byte differencing), ``rows_per_strip`` rows a
strip.  ``extra`` adds or replaces tags ({tag: (type, values)}), which is
how the refused forms are made (tiles, three samples, JPEG compression)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SHORT, LONG = 3, 4
_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of 3+ equal bytes as repeats, the rest as
    literals of at most 128 bytes."""
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i + 1)) & 0xFF, row[i]])
            i = j + 1
            continue
        start = i
        while i < n and i - start < 128:
            if i + 2 < n and row[i] == row[i + 1] == row[i + 2]:
                break
            i += 1
        out += bytes([i - start - 1]) + row[start:i]
    return bytes(out)


def lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW: 9-12 bit codes, Clear 256 first and whenever the table is
    full, EOI 257 last.  New-style codes are packed most significant bit
    first and widen one code early (libtiff's encoder: once its next free
    code passes 511, 1023, 2047); old-style (``old_style``) least
    significant bit first and one code later."""
    codes, widths = [], []
    late = 1 if old_style else 0

    table = {bytes([b]): b for b in range(256)}
    nxt, nbits = 258, 9
    codes.append(256)
    widths.append(nbits)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        widths.append(nbits)
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << nbits) + late and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            codes.append(256)
            widths.append(nbits)
            table = {bytes([c]): c for c in range(256)}
            nxt, nbits = 258, 9
        w = bytes([b])
    if w:
        codes.append(table[w])
        widths.append(nbits)
        # the decoder adds an entry for this code too, and widens on it
        nxt += 1
        if nxt >= (1 << nbits) + late and nbits < 12:
            nbits += 1
    codes.append(257)
    widths.append(nbits)
    acc, nacc, out = 0, 0, bytearray()
    for c, wd in zip(codes, widths):
        if old_style:
            acc |= c << nacc
            nacc += wd
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << wd) | c
            nacc += wd
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if not old_style else acc & 0xFF)
    return bytes(out)


def _predict(rows: np.ndarray, predictor: int, order: str) -> bytes:
    """The strip's rows (r, W) after the predictor, as file bytes."""
    dt = rows.dtype.newbyteorder("<" if order == "II" else ">")
    if predictor == 1:
        return rows.astype(dt).tobytes()
    if predictor == 2:
        u = rows.view(np.dtype(f"u{rows.dtype.itemsize}"))
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        return d.astype(d.dtype.newbyteorder("<" if order == "II" else ">")).tobytes()
    if predictor == 3:
        b = rows.astype(rows.dtype.newbyteorder(">")).view(np.uint8)
        r, w = rows.shape
        k = rows.dtype.itemsize
        planes = b.reshape(r, w, k).transpose(0, 2, 1).reshape(r, w * k)
        d = planes.copy()
        d[:, 1:] = planes[:, 1:] - planes[:, :-1]
        return d.tobytes()
    raise ValueError(predictor)


def _compress(raw: bytes, compression: int, row_bytes: int, old_lzw: bool) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw(raw, old_lzw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return b"".join(packbits(raw[i:i + row_bytes]) for i in range(0, len(raw), row_bytes))
    raise ValueError(compression)


def encode(img: np.ndarray, order: str = "II", compression: int = 1, predictor: int = 1,
           rows_per_strip: int | None = None, old_lzw: bool = False, photometric: int = 1,
           extra: dict | None = None) -> bytes:
    img = np.asarray(img)
    h, w = img.shape
    rps = h if rows_per_strip is None else rows_per_strip
    e = "<" if order == "II" else ">"
    strips = []
    for y in range(0, h, rps):
        raw = _predict(img[y:y + rps], predictor, order)
        strips.append(_compress(raw, compression, w * img.dtype.itemsize, old_lzw))
    tags = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [8 * img.dtype.itemsize]),
            259: (SHORT, [compression]), 262: (SHORT, [photometric]), 277: (SHORT, [1]),
            278: (LONG, [rps]), 279: (LONG, [len(s) for s in strips]),
            284: (SHORT, [1]), 339: (SHORT, [_SAMPLE_FORMAT[img.dtype.kind]])}
    if predictor != 1:
        tags[317] = (SHORT, [predictor])
    tags.update(extra or {})
    head = (b"II*\x00" if order == "II" else b"MM\x00*")
    data = bytearray(head + b"\0\0\0\0")
    offsets = []
    for s in strips:
        offsets.append(len(data))
        data += s
        if len(data) % 2:
            data += b"\0"
    tags[273] = (LONG, offsets)
    # out-of-line values, then the IFD
    blobs = {}
    for tag, (typ, vals) in sorted(tags.items()):
        fmt = "H" if typ == SHORT else "I"
        if len(vals) * struct.calcsize(fmt) > 4:
            blobs[tag] = len(data)
            data += struct.pack(e + fmt * len(vals), *vals)
    ifd = len(data)
    data[4:8] = struct.pack(e + "I", ifd)
    data += struct.pack(e + "H", len(tags))
    for tag, (typ, vals) in sorted(tags.items()):
        fmt = "H" if typ == SHORT else "I"
        if tag in blobs:
            field = struct.pack(e + "I", blobs[tag])
        else:
            field = struct.pack(e + fmt * len(vals), *vals).ljust(4, b"\0")
        data += struct.pack(e + "HHI", tag, typ, len(vals)) + field
    data += b"\0\0\0\0"
    return bytes(data)
