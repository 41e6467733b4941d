"""GIF decoding without an imaging library: the first frame of the colour
(and depth) files that the JAX package opens with Pillow
(``Image.open(path).convert("RGB")`` and ``np.asarray(Image.open(path))``
in ``hrbffusion3d_tpu/io/tum.py`` and ``io/klg.py``), read as Pillow 12's
``GifImagePlugin`` reads it, quirks included:

  - ``GIF87a`` / ``GIF89a``; the logical screen's size and the global
    palette (``3 << bits`` bytes); a palette that is the grey ramp 0, 1,
    2, ... (``_is_palette_needed``) counts as no palette;
  - before frame 0's image descriptor: extensions (the graphic control
    extension's transparent index; comment, application and other
    extensions skipped sub-block by sub-block) and any other byte skipped;
  - the image descriptor's rectangle (the screen grows to hold it; a
    rectangle of zero width at x 0 is the whole screen), its interlace
    flag, its local palette, and the LZW minimum code size;
  - Pillow's mode: ``P`` when frame 0 has a palette (its local one, else
    the global one), ``L`` when it has none; a local grey-ramp palette
    gives mode ``L`` whose ``convert("RGB")`` still maps through the
    global palette, as Pillow's core image then holds it;
  - the pixels outside the rectangle: the transparent index when there is
    one, else 0; no index of frame 0 is skipped as transparent;
  - ``convert("RGB")``: the palette's colours, black past its entries;
    ``np.asarray``: the indices (``P``) or values (``L``).

The LZW data is expanded by ``csrc/gif_decode.cpp`` (Pillow's GifDecode.c
statement for statement), compiled into the native loader's library
(``io/native_loader``).  It refuses what Pillow refuses, naming the field:
a truncated header, palette or descriptor, a file with no image, a code
size above 12, a broken code.  Where Pillow's decoder meets an end code,
or the end of the file, before the frame is full, Pillow fails with
"image file is truncated" (or, with more than 64 KiB of data still to
read, decodes on past the end code): the port raises, naming the pixel.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import modes, native_loader

MAGICS = (b"GIF87a", b"GIF89a")
# Pillow's decompression bomb limit: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_ERR_LEN = 256


def accept(data: bytes) -> bool:
    return data[:6] in MAGICS


def _palette_needed(p: bytes) -> bool:
    """Pillow's ``_is_palette_needed``: False for the grey ramp 0, 1, 2, ...
    (IndexError on a palette cut inside an entry, as in Pillow)."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> bytes | None:
        """Pillow's ``data()``: the next sub-block, None at a terminator."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def decode_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(Pillow's mode, ``np.asarray(Image.open(...))``, the palette (N, 3)
    uint8 that ``convert("RGB")`` maps through, or None; a palette with mode
    ``L`` too) of frame 0 of a GIF file's bytes."""
    if not accept(data):
        raise ValueError(f"not a GIF file (it starts with {bytes(data[:6])!r})")
    r = _Reader(data)
    s = r.read(13)
    if len(s) < 13:
        raise ValueError("GIF logical screen descriptor truncated")
    width, height = struct.unpack_from("<HH", s, 6)
    flags = s[10]
    global_palette = None
    try:
        if flags & 128:
            p = r.read(3 << ((flags & 7) + 1))
            if _palette_needed(p):
                global_palette = p
        # frame 0: extensions, then the image descriptor
        transparency = None
        descriptor = None
        c = r.read(1)
        if not c or c == b";":
            raise ValueError("GIF file with no image")
        while True:
            if not c:
                c = r.read(1)
            if not c or c == b";":
                break
            if c == b"!":
                label = r.read(1)
                block = r.block()
                if label and label[0] == 249 and block is not None:
                    if block[0] & 1:
                        transparency = block[3]
                    struct.unpack_from("<H", block, 1)  # the delay, read as Pillow reads it
                elif label and label[0] == 254:
                    while block:
                        block = r.block()
                    c = b""
                    continue
                elif label and label[0] == 255 and block is not None:
                    if block.startswith(b"NETSCAPE2.0"):
                        r.block()  # the loop count's sub-block
                while r.block():
                    pass
            elif c == b",":
                s = r.read(9)
                x0, y0, w, h = struct.unpack_from("<HHHH", s)
                local_flags = s[8]
                local = None
                if local_flags & 128:
                    p = r.read(3 << ((local_flags & 7) + 1))
                    local = p if _palette_needed(p) else False
                bits = r.read(1)[0]
                descriptor = (x0, y0, w, h, bool(local_flags & 64), local, bits, r.pos)
                break
            c = b""
    except (IndexError, struct.error) as e:
        raise ValueError(f"GIF header, palette or descriptor truncated ({e})") from e
    if descriptor is None:
        raise ValueError("GIF file with no image (no image descriptor before its end)")
    x0, y0, w, h, interlace, local, bits, start = descriptor
    width, height = max(x0 + w, width), max(y0 + h, height)
    if width * height > MAX_PIXELS:
        raise ValueError(f"GIF of {width}x{height} pixels: above Pillow's decompression bomb "
                         f"limit of {MAX_PIXELS}")
    frame_palette = local if local is not None else global_palette
    mode = "P" if frame_palette else "L"
    # convert("RGB") maps through this palette (a grey-ramp local palette
    # leaves Pillow's core image in P with the global palette)
    palette = local if local else global_palette
    if x0 == 0 and w == 0:  # Pillow's setimage: x0 == x1 == 0 is the whole image
        x0, y0, w, h = 0, 0, width, height
    if w <= 0 or h <= 0:
        raise ValueError(f"GIF frame of {w}x{h} at ({x0}, {y0}): Pillow's \"tile cannot extend "
                         "outside image\"")
    rect = np.empty((h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = native_loader.library("GIF decoder")
    if lib.gif_lzw_decode(data, len(data), start, bits, int(interlace), w, h,
                          rect.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err,
                          _ERR_LEN) != 0:
        raise ValueError(f"GIF frame 0: {err.value.decode()}")
    img = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    img[y0:y0 + h, x0:x0 + w] = rect
    if palette is None:
        return mode, img, None
    return mode, img, np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8).reshape(-1, 3)


def decode_colour(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8, what Pillow's ``convert("RGB")`` gives of frame 0."""
    _, img, palette = decode_mode(data)
    return modes.to_rgb("L" if palette is None else "P", img, palette)
