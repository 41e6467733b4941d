"""GIF files that Pillow's writer cannot make, for the tests of the port's
GIF reader (``hrbffusion3d_tpu_torch/io/gif.py``): an LZW encoder of any
minimum code size (2-8) that can leave out the first clear code, keep
12-bit codes once the table is full (a deferred clear) instead of clearing
it, clear it anywhere, end early, or put the end code anywhere and go on;
and the container written by hand (global and local palettes, graphic
control, comment and application extensions, any frame rectangle,
interlace, a second frame).
"""

from __future__ import annotations

import struct

import numpy as np


def lzw_codes(indices, bits: int, clear_first: bool = True, clear_when_full: bool = True,
              stop_at: int | None = None, eoi_at: int | None = None,
              clear_at: tuple = ()) -> list[tuple[int, int]]:
    """(code, size) pairs of ``indices`` under GIF's LZW with minimum code
    size ``bits`` (every index below ``1 << bits``); ``stop_at``: the data
    ends before that pixel; ``eoi_at``: an end code once that pixel is
    reached, the codes going on after it unchanged; ``clear_at``: a clear
    code before those pixels."""
    clear, eoi = 1 << bits, (1 << bits) + 1

    def reset():
        return {(i,): i for i in range(clear)}, clear + 2, bits + 1

    table, nxt, size = reset()
    out = [(clear, size)] if clear_first else []

    def emit(code: int):
        # the decoder adds entry ``nxt`` on the next code and then grows
        # the code size when that entry is the size's last
        nonlocal size
        out.append((code, size))
        if nxt == (1 << size) and size < 12:
            size += 1

    w: tuple = ()
    eoi_done = False
    for n, k in enumerate(indices):
        if stop_at is not None and n == stop_at:
            break
        if n in clear_at and w:
            emit(table[w])
            out.append((clear, size))
            table, nxt, size = reset()
            w = (k,)
            continue
        wk = w + (k,)
        if wk in table:
            w = wk
            continue
        if eoi_at is not None and n >= eoi_at and not eoi_done:
            out.append((eoi, size))
            eoi_done = True
        emit(table[w])
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
        elif clear_when_full:
            out.append((clear, size))
            table, nxt, size = reset()
        w = (k,)
    if w:
        emit(table[w])
    out.append((eoi, size))
    return out


def pack(codes: list[tuple[int, int]]) -> bytes:
    """Codes packed least significant bit first, in sub-blocks of 255
    bytes, and the terminator."""
    acc = nb = 0
    data = bytearray()
    for code, size in codes:
        acc |= code << nb
        nb += size
        while nb >= 8:
            data.append(acc & 255)
            acc >>= 8
            nb -= 8
    if nb:
        data.append(acc & 255)
    blocks = bytearray()
    for i in range(0, len(data), 255):
        piece = data[i:i + 255]
        blocks += bytes([len(piece)]) + piece
    return bytes(blocks) + b"\0"


def palette_bytes(colours: bytes) -> tuple[int, bytes]:
    """(the size field, the table padded to a power of two entries)."""
    n = max(len(colours) // 3, 2)
    size = max((n - 1).bit_length(), 1)
    return size - 1, colours + bytes(3 * (1 << size) - len(colours))


def interlaced_rows(h: int) -> list[int]:
    return (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2)))


def frame(indices: np.ndarray, x: int = 0, y: int = 0, local: bytes | None = None,
          interlace: bool = False, bits: int = 8, gce: tuple | None = None,
          width: int | None = None, **lzw) -> bytes:
    """A graphic control extension (``gce`` = (flags, transparent index)),
    an image descriptor and its LZW data; ``width`` written in place of the
    indices' own."""
    h, w = indices.shape
    out = b""
    if gce is not None:
        out += b"!\xf9\x04" + bytes([gce[0]]) + struct.pack("<H", 10) + bytes([gce[1]]) + b"\0"
    flags = 0x40 if interlace else 0
    table = b""
    if local is not None:
        size, table = palette_bytes(local)
        flags |= 0x80 | size
    out += b"," + struct.pack("<HHHH", x, y, w if width is None else width, h) + bytes([flags]) \
        + table
    rows = interlaced_rows(h) if interlace else range(h)
    seq = [int(v) for r in rows for v in indices[r]]
    return out + bytes([bits]) + pack(lzw_codes(seq, bits, **lzw))


def gif(width: int, height: int, frames: list[bytes], palette: bytes | None = None,
        version: bytes = b"GIF89a", extensions: bytes = b"") -> bytes:
    """A GIF file: the screen, a global palette, ``extensions`` before the
    first frame, the frames and the trailer."""
    flags, table = 0, b""
    if palette is not None:
        size, table = palette_bytes(palette)
        flags = 0x80 | 0x70 | size
    return (version + struct.pack("<HH", width, height) + bytes([flags, 0, 0]) + table
            + extensions + b"".join(frames) + b";")


def comment(text: bytes) -> bytes:
    return b"!\xfe" + bytes([len(text)]) + text + b"\0"


def netscape_loop(loops: int = 0) -> bytes:
    return b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loops) + b"\0"
