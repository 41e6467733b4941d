"""Pillow's image modes and its ``convert("RGB")``, in numpy: one copy for
every colour decoder of the port (``io/png``, ``io/pnm``, ``io/bmp``,
``io/tiff``), each of which hands over the array Pillow holds for the
file (``np.asarray(Image.open(...))``) and the file's mode.

``to_rgb`` gives (H, W, 3) uint8, what ``Image.open(...).convert("RGB")``
gives (src/libImaging/Convert.c):

  - ``1`` (bool): 0 or 255, replicated;
  - ``L``, and ``LA`` with its alpha dropped: the grey value replicated;
  - ``P`` and ``PA`` (indices, alpha dropped): the palette's colours,
    black for an index beyond the palette's entries;
  - ``I;16`` / ``I;16B`` (uint16) and ``I`` (int32): clipped to 0-255;
  - ``F`` (float32): 0 at or below 0 (and NaN), 255 at or above 255,
    truncated between (Pillow converts ``F`` to ``L`` first);
  - ``RGB``, and ``RGBA`` with its alpha dropped;
  - ``CMYK``: Convert.c's ``cmyk2rgb``, ``255 - K - (C (255 - K)) / 255``
    per channel with Pillow's rounded division by 255 (the formula that
    ``csrc/jpeg_decode.cpp``'s ``pillow_cmyk`` applies to a CMYK JPEG).

``unpack_into`` is Pillow's raw decoding of one run of rows
(src/libImaging/Unpack.c): the bytes of a file's rows, laid out as the
raw mode names them, into the image's mode.  It takes the (mode, raw
mode) pairs that Pillow's BMP, netpbm and TIFF readers use, and refuses a
pair that Pillow has no unpacker for, as Pillow does:

  - bytes named by letters (``RGB``, ``RGBX``, ``BGRA``, ``XBGR``,
    ``CMYKX``, ``PA``, ...), each letter a band of the mode or ``X`` for a
    byte skipped; ``a`` is alpha that the colour is multiplied by
    (``unpremultiply``: ``min(255, c * 255 // a)``, all four 0 where
    alpha is 0); ``;16L`` / ``;16B`` / ``;16N`` give each letter 16 bits
    of which the high byte is kept; ``;R`` reverses the bits of each
    byte;
  - one letter alone (``R``, ``K``, ...) fills that band only, as Pillow
    reads a TIFF plane;
  - bits (``1``, ``P;1``, ``L;2``, ``P;4``, ...) most significant first,
    ``;I`` inverted, ``;R`` each byte's bits reversed first; grey of 2 and
    4 bits scaled by 85 and 17;
  - 16-bit colour: ``BGR;15`` (5-5-5) and ``BGR;16`` (5-6-5), red in the
    high bits, each channel ``v * 255 // 31`` (or 63);
  - integers and floats: ``I;16`` (and ``B``, ``N``, ``R``), ``I;12``
    (two 12-bit samples in three bytes, most significant first),
    ``I;16S`` / ``I;16BS``, ``I;32N``, ``I;32S`` / ``I;32BS``, ``I``, ``F``,
    ``F;32F`` / ``F;32BF``; ``N`` and a bare ``I`` / ``F`` are the host's
    (little-endian) order.
"""

from __future__ import annotations

import numpy as np

# every mode ``to_rgb`` takes -> its number of bands
BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2,
         "RGB": 3, "RGBA": 4, "CMYK": 4}


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pillow's MULDIV255: ``a * b / 255`` rounded, in integers."""
    tmp = a * b + 128
    return ((tmp >> 8) + tmp) >> 8


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB, Convert.c's ``cmyk2rgb``."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    return np.clip(nk - _muldiv255(c[..., :3], nk), 0, 255).astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 premultiplied RGBa -> RGBA, Unpack.c's ``unpackRGBa``:
    colour ``min(255, c * 255 // a)``, and all four 0 where alpha is 0."""
    a = rgba[..., 3:4].astype(np.int32)
    colour = np.minimum(rgba[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
    colour = np.where(a == 255, rgba[..., :3], colour)
    out = np.concatenate([colour, a], axis=-1).astype(np.uint8)
    out[(a == 0)[..., 0]] = 0
    return out


def to_rgb(mode: str, img: np.ndarray, palette: np.ndarray | None = None) -> np.ndarray:
    """(H, W, 3) uint8 of an image of Pillow mode ``mode`` (``img`` as
    ``np.asarray`` gives it; ``palette`` (N, 3) uint8 for ``P`` / ``PA``)."""
    if mode not in BANDS:
        raise ValueError(f"mode {mode} has no conversion to RGB here")
    if mode in ("P", "PA"):
        if palette is None:
            raise ValueError(f"mode {mode} without a palette")
        entries = np.zeros((256, 3), np.uint8)     # indices beyond the palette are black
        entries[:min(len(palette), 256)] = palette[:256]
        return entries[img if mode == "P" else img[..., 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(img)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(img[..., :3])
    if mode == "LA":
        img = img[..., 0]
    if mode == "1":
        grey = img.astype(np.uint8) * np.uint8(255)
    elif mode == "F":
        f = img.astype(np.float32)
        with np.errstate(invalid="ignore"):
            grey = np.where(f >= 255, 255, np.where(f > 0, f, 0)).astype(np.uint8)
    elif mode in ("I;16", "I;16B", "I"):
        grey = np.clip(img, 0, 255).astype(np.uint8)
    else:
        grey = img
    return np.repeat(grey[..., None], 3, axis=2)


# the arrays ``new`` makes: mode -> (dtype, bands)
_STORAGE = {"1": (bool, 1), "L": (np.uint8, 1), "P": (np.uint8, 1), "I;16": (np.uint16, 1),
            "I;16B": (np.uint16, 1), "I": (np.int32, 1), "F": (np.float32, 1),
            "LA": (np.uint8, 2), "PA": (np.uint8, 2), "RGB": (np.uint8, 3),
            "RGBA": (np.uint8, 4), "CMYK": (np.uint8, 4)}
# mode -> its bands' letters
_LETTERS = {"L": "L", "P": "P", "LA": "LA", "PA": "PA", "RGB": "RGB", "RGBA": "RGBA",
            "CMYK": "CMYK"}
# the byte-letter raw modes Pillow unpacks into each mode (each also with
# ";16L", ";16B" and ";16N" where listed in _WIDE)
_BYTES = {"L": {"L", "L;I", "L;R"}, "P": {"P", "PX", "P;R"}, "LA": {"LA"}, "PA": {"PA"},
          "RGB": {"RGB", "RGB;R", "RGBX", "RGBXX", "RGBXXX", "BGR", "BGRX", "XBGR", "BGXR",
                  "R", "G", "B"},
          "RGBA": {"RGBA", "RGBa", "RGBaX", "RGBaXX", "RGBAX", "RGBAXX", "ABGR", "BGRA",
                   "BGAR", "R", "G", "B", "A"},
          "CMYK": {"CMYK", "CMYKX", "CMYKXX", "C", "M", "Y", "K"}}
_WIDE = {"RGB": {"RGB", "RGBX", "R", "G", "B"}, "RGBA": {"RGBA", "RGBa", "R", "G", "B", "A"},
         "CMYK": {"CMYK"}}
# (mode, raw mode) -> (bits a pixel, numpy dtype of the samples) of whole
# samples read as numbers
_NUMBERS = {("I;16", "I;16"): (16, "<u2"), ("I;16", "I;16N"): (16, "<u2"),
            ("I;16B", "I;16B"): (16, ">u2"), ("I;16B", "I;16N"): (16, "<u2"),
            ("I", "I;16S"): (16, "<i2"), ("I", "I;16BS"): (16, ">i2"),
            ("I", "I;32N"): (32, "<i4"), ("I", "I;32S"): (32, "<i4"),
            ("I", "I;32BS"): (32, ">i4"), ("I", "I"): (32, "<i4"),
            ("F", "F;32F"): (32, "<f4"), ("F", "F;32BF"): (32, ">f4"), ("F", "F"): (32, "<f4")}
# (mode, raw mode) -> bits a sample of the bit-packed raw modes
_PACKED = {("1", "1"): 1, ("1", "1;I"): 1, ("1", "1;R"): 1, ("1", "1;IR"): 1,
           **{("L", f"L;{b}{v}"): b for b in (2, 4) for v in ("", "I", "R", "IR")},
           ("P", "P;1"): 1, ("P", "P;2"): 2, ("P", "P;4"): 4}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def new(mode: str, height: int, width: int) -> np.ndarray:
    """A zeroed image of ``mode`` as ``np.asarray`` lays it out."""
    if mode not in _STORAGE:
        raise ValueError(f"mode {mode} is not read")
    dtype, bands = _STORAGE[mode]
    return np.zeros((height, width) + ((bands,) if bands > 1 else ()), dtype)


def rawmode_bits(mode: str, rawmode: str) -> int:
    """The bits a pixel of ``rawmode`` takes (Pillow's unpacker bits);
    ``ValueError`` when Pillow has no unpacker of ``rawmode`` into
    ``mode``."""
    if (mode, rawmode) in _NUMBERS:
        return _NUMBERS[mode, rawmode][0]
    if (mode, rawmode) in _PACKED:
        return _PACKED[mode, rawmode]
    if (mode, rawmode) == ("I;16", "I;16R"):
        return 16
    if (mode, rawmode) == ("I;16", "I;12"):
        return 12
    if (mode, rawmode) in (("RGB", "BGR;15"), ("RGB", "BGR;16")):
        return 16
    base, _, wide = rawmode.partition(";")
    if rawmode in _BYTES.get(mode, ()):
        return 8 * len(base)
    if wide in ("16L", "16B", "16N") and base in _WIDE.get(mode, ()):
        return 16 * len(base)
    raise ValueError(f"raw mode {rawmode} of mode {mode}: Pillow has no unpacker for it")


def _bits(rows: np.ndarray, width: int, bits: int, reverse: bool) -> np.ndarray:
    """(n, width) uint16 of ``bits``-bit samples, most significant first."""
    if reverse:
        rows = _REVERSED[rows]
    b = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(len(rows), width, bits)
    return b.astype(np.uint16) @ (np.uint16(1) << np.arange(bits - 1, -1, -1, dtype=np.uint16))


def unpack_into(img: np.ndarray, mode: str, rawmode: str, rows: np.ndarray, y: int, x: int,
                width: int) -> None:
    """Unpack ``rows`` ((n, bytes) uint8, at least the raw mode's bytes of
    ``width`` pixels each) into ``img[y:y + n, x:x + width]``."""
    bits = rawmode_bits(mode, rawmode)
    n = len(rows)
    rows = rows[:, :(width * bits + 7) // 8]
    dst = img[y:y + n, x:x + width]
    if (mode, rawmode) in _NUMBERS:
        dt = np.dtype(_NUMBERS[mode, rawmode][1])
        dst[...] = np.ascontiguousarray(rows).view(dt).reshape(n, width)
        return
    if (mode, rawmode) in _PACKED:
        _, _, flags = rawmode.partition(";")
        v = _bits(rows, width, bits, "R" in flags).astype(np.uint8)
        if mode == "1":
            dst[...] = (v == 0) if "I" in flags else (v != 0)
        elif mode == "L":
            v = v * np.uint8(85 if bits == 2 else 17)
            dst[...] = 255 - v if "I" in flags else v
        else:
            dst[...] = v
        return
    if rawmode == "I;16R":
        dst[...] = np.ascontiguousarray(_REVERSED[rows]).view("<u2").reshape(n, width)
        return
    if rawmode == "I;12":
        dst[...] = _bits(rows, width, 12, False)
        return
    if rawmode in ("BGR;15", "BGR;16"):
        p = np.ascontiguousarray(rows).view("<u2").reshape(n, width).astype(np.int32)
        g_bits = 5 if rawmode == "BGR;15" else 6
        r = (p >> (5 + g_bits)) & 31
        g = (p >> 5) & ((1 << g_bits) - 1)
        dst[...] = np.stack([r * 255 // 31, g * 255 // ((1 << g_bits) - 1),
                             (p & 31) * 255 // 31], axis=-1).astype(np.uint8)
        return
    base, _, flags = rawmode.partition(";")
    size = 2 if flags.startswith("16") else 1
    if flags == "R":
        rows = _REVERSED[rows]
    elif flags == "I":
        rows = 255 - rows
    samples = rows.reshape(n, width, len(base), size)
    samples = samples[..., 0 if flags == "16B" else size - 1]
    letters = _LETTERS[mode]
    if len(base) == 1:                                   # one band
        if dst.ndim == 3:
            dst[..., letters.index(base)] = samples[..., 0]
        else:
            dst[...] = samples[..., 0]
        return
    out = np.zeros(dst.shape if dst.ndim == 3 else dst.shape + (1,), np.uint8)
    for i, c in enumerate(letters):
        out[..., i] = samples[..., base.index(c if c in base else "a")]
    if "a" in base:
        out = unpremultiply(out)
    dst[...] = out if dst.ndim == 3 else out[..., 0]
