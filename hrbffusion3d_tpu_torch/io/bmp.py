"""BMP decoding without an imaging library: colour (and grey) images that
the JAX package opens with Pillow (``Image.open(path).convert("RGB")`` in
``hrbffusion3d_tpu/io/tum.py`` and ``io/klg.py``).

It reads Windows bitmaps (``BM``) and headerless DIBs (a file that starts
with its info header) as Pillow 12's ``BmpImagePlugin`` reads them,
quirks included:

  - info headers of 12 (OS/2: 16-bit size, no compression, 3-byte palette
    entries) and 40, 52, 56, 64, 108 and 124 bytes; a height whose top
    byte is 0xFF means rows stored top to bottom, else bottom to top;
  - 1, 4 and 8 bits a pixel with a palette (as many entries as the header
    says, or 2 ** bits): mode ``1`` when the palette is exactly black and
    white, ``L`` when it is exactly the grey ramp 0, 1, 2, ..., ``P``
    otherwise (more than 256 entries refused); the mode's raw mode then
    reads the rows even where the bits a pixel differ (as Pillow does);
  - 16 bits as 5-5-5, 24 as BGR, 32 as BGRX; with bitfields (compression
    3) the masks of Pillow's ``SUPPORTED`` table only (5-6-5 and 5-5-5,
    BGR, and eight 32-bit layouts, some with alpha, which gives mode
    ``RGBA``); the masks follow a 40-byte header, or lie in a longer one;
  - RLE8 and RLE4 (compression 1 and 2) expanded by
    ``csrc/bmp_decode.cpp`` (Pillow's ``BmpRleDecoder`` statement for
    statement) into modes ``L`` and ``P``;
  - the pixel data at the file header's offset (after the palette when the
    offset points just past the info header), or right after the header,
    the masks and the palette in a DIB; rows padded to 4 bytes.

It refuses what Pillow refuses, naming the field: other header sizes,
other bit counts, other bitfield masks, JPEG or PNG inside a BMP
(compression 4 and 5) and other compressions, run-length data in a mode
with no palette, rows shorter than the raw mode reads, truncated files, a
run-length stream that ends before the image is full.  ``decode_mode``
gives Pillow's mode and ``np.asarray(Image.open(...))``, which
``io/image`` takes to a depth image or, through ``io/modes``, to
``convert("RGB")``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import modes, native_loader

MAGIC = b"BM"
# the info header sizes Pillow reads (and tells a DIB by)
HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode: Pillow's SUPPORTED / MASK_MODES
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# Pillow's decompression bomb limit: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_ERR_LEN = 256


def is_dib(data: bytes) -> bool:
    """Whether Pillow takes ``data`` for a headerless DIB."""
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] in HEADER_SIZES


def _rle(data: bytes, start: int, rle4: bool, width: int, height: int) -> np.ndarray:
    """(height, width) uint8 indices, rows as stored."""
    out = np.zeros(width * height, np.uint8)
    produced = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = native_loader.library("BMP run-length decoder")
    if lib.bmp_rle_decode(data, len(data), start, int(rle4), width, height,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          ctypes.byref(produced), err, _ERR_LEN) != 0:
        raise ValueError(f"RLE{4 if rle4 else 8}: {err.value.decode()}")
    if produced.value < width * height:
        raise ValueError(f"RLE{4 if rle4 else 8} data gives {produced.value} of the image's "
                         f"{width * height} pixels")
    return out.reshape(height, width)


def decode_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(Pillow's mode, ``np.asarray(Image.open(...))``, the palette as (N, 3)
    uint8 for mode ``P``) of a BMP or DIB file's bytes."""
    if data[:2] == MAGIC:
        if len(data) < 14:
            raise ValueError(f"BMP file header truncated: {len(data)} of 14 bytes")
        (offset,) = struct.unpack_from("<I", data, 10)
        pos = 14
    elif is_dib(data):
        offset, pos = 0, 0
    else:
        raise ValueError(f"neither a BMP nor a DIB file (it starts with {data[:4]!r})")
    if len(data) < pos + 4:
        raise ValueError("BMP info header truncated")
    (header_size,) = struct.unpack_from("<I", data, pos)
    if header_size not in HEADER_SIZES:
        raise ValueError(f"BMP info header size {header_size}: not read ({HEADER_SIZES} are)")
    head = data[pos + 4:pos + header_size]
    if len(head) < header_size - 4:
        raise ValueError(f"BMP info header truncated: {len(head) + 4} of {header_size} bytes")
    pos += header_size
    direction = -1
    masks = None
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", head)
        compression, colors, padding = RAW, 0, 3
    else:
        if head[7] == 0xFF:
            direction = 1
        width, height, _, bits, compression = struct.unpack_from("<IIHHI", head)
        if direction == 1:
            height = 2 ** 32 - height
        (colors,) = struct.unpack_from("<I", head, 28)
        padding = 4
        if compression == BITFIELDS:
            if len(head) >= 48:
                masks = struct.unpack_from("<III", head, 36) + (
                    struct.unpack_from("<I", head, 48) if len(head) >= 52 else (0,))
            else:
                if len(data) < pos + 12:
                    raise ValueError("BMP bitfield masks truncated")
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    if width * height > MAX_PIXELS:
        raise ValueError(f"BMP of {width}x{height} pixels: above Pillow's decompression bomb "
                         f"limit of {MAX_PIXELS}")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"BMP bit count {bits}: not read (1, 4, 8, 16, 24 and 32 are)")
    mode, rawmode = _BIT2MODE[bits]
    rle = False
    if compression == BITFIELDS:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError(f"BMP bitfields {[hex(m) for m in key[1]]} at {bits} bits: not a "
                             "layout Pillow reads")
        rawmode = _MASK_MODES[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression in (RLE8, RLE4):
        rle = True
    elif compression != RAW:
        raise ValueError(f"BMP compression {compression}: not read (0, 1 RLE8, 2 RLE4 and 3 "
                         "bitfields are; 4 JPEG and 5 PNG are refused as Pillow refuses them)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours: not read")
        raw = data[pos:pos + padding * colors]
        pos += len(raw)
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(raw[i * padding:i * padding + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(ramp))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            entries = len(raw) // (3 if padding == 3 else 4)
            if entries > 256:
                raise ValueError(f"BMP palette of {entries} colours: more than 256")
            table = np.frombuffer(raw[:entries * padding], np.uint8).reshape(entries, padding)
            palette = np.ascontiguousarray(table[:, 2::-1])
    start = offset or pos
    if rle:
        if mode not in ("L", "P"):
            raise ValueError(f"BMP run-length data (compression {compression}) in mode {mode}: "
                             "Pillow has no raw mode for it")
        img = _rle(data, start, compression == RLE4, width, height)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = (width * modes.rawmode_bits(mode, rawmode) + 7) // 8
        if stride < need:
            raise ValueError(f"BMP rows of {stride} bytes, raw mode {rawmode} of {width} pixels "
                             f"reads {need}: Pillow's codec configuration error")
        size = (height - 1) * stride + need if height else 0
        body = data[start:start + size]
        if len(body) < size:
            raise ValueError(f"BMP pixel data truncated: {len(body)} of {size} bytes")
        rows = np.frombuffer(body + bytes(height * stride - size), np.uint8)
        img = modes.new(mode, height, width)
        modes.unpack_into(img, mode, rawmode, rows.reshape(height, stride), 0, 0, width)
    if direction == -1:
        img = img[::-1]
    return mode, np.ascontiguousarray(img), palette
