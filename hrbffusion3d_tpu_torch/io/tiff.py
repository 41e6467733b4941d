"""TIFF decoding without an imaging library: depth and colour images that
the JAX package opens with Pillow (``np.asarray(Image.open(path))`` and
``Image.open(path).convert("RGB")`` in ``hrbffusion3d_tpu/io/tum.py`` and
``io/klg.py``; Pillow reads compressed TIFF through libtiff).

The container is read here with numpy; strips and tiles are inflated by
the port's C++ decompressors (``csrc/tiff_decode.cpp``, its Zstandard
decoder ``csrc/zstd_decode.cpp`` and its CCITT and ThunderScan decoders
``csrc/fax_decode.cpp``; LZMA strips by Python's ``lzma``) and JPEG strips
and tiles decoded by its JPEG decoder (``csrc/jpeg_decode.cpp``), all
compiled into the native loader's library by ``io/native_loader`` (a
library that does not build raises ``RuntimeError`` naming the build
error).  It reads the first image of a TIFF or a little-endian BigTIFF
(16-byte header, 8-byte counts and offsets, LONG8 / SLONG8 / IFD8
values) in either byte order (``II`` or ``MM``) in every form of Pillow
12's ``TiffImagePlugin.OPEN_INFO`` but LAB: grey of 1, 2, 4, 8, 12, 16
and 32 bits (unsigned, signed, float), grey with alpha, RGB and RGBA of 8
and 16 bits with the extra samples Pillow names (``X`` ignored, ``a``
associated alpha, ``A``), palettes of 1, 2, 4 and 8 bits (``P``, ``PX``,
``PA``; the 16-bit ColorMap reduced to its high bytes), CMYK of 8 and 16
bits and YCbCr; in strips or tiles (edge tiles cropped), with planar
configuration 1 or 2, fill order 1 or 2, compressed with none (1), CCITT
Modified Huffman (2), T.4 (3, 1D or 2D), T.6 (4), LZW (5), JPEG (7),
deflate (8, 32946), CCITT RLE/W (32771), PackBits (32773), ThunderScan
(32809), LZMA (34925) or Zstandard (50000): every compression Pillow 12.1
opens but old-style JPEG (6); with predictor 1, 2 (horizontal
differencing of each sample, modulo its width, the samples of a pixel as
its stride) or 3 (floating point); and the Orientation tag (274) applied
as Pillow applies it.

It gives what Pillow 12 gives, quirks included, by taking Pillow's
routes:

  - no compression: Pillow's own raw decoder, one tile a strip or tile,
    from the tile's offset to as far as its rows reach (the byte counts
    unread); with planar configuration 2 each plane is read with the raw
    mode's letter of that plane (``R``, ``G``, ... ; ``I;16`` gives ``I``,
    which Pillow has no unpacker for in mode ``I;16``, so it is refused);
    the predictor is ignored; fill order 2 uses the ``;R`` raw modes, so
    the forms Pillow has none of are refused; YCbCr is read as ``RGBX``
    (4 bytes a pixel, as Pillow reads it: a truncated file where the
    data is shorter);
  - the other compressions: libtiff, then Pillow's unpacker: the bits
    of each byte reversed before decompression for fill order 2 (the
    CCITT codecs read fill order 2 themselves, to the same effect); the
    samples of a big-endian file swapped to the host's order and the
    predictor applied there (only with LZW, deflate, LZMA and ZSTD, the
    codecs libtiff applies it in); the ``;16B`` / ``;16L`` raw modes read as
    ``;16N`` (so the other big-endian 16-bit signed, 32-bit and float
    modes come back byte-swapped, as Pillow swaps libtiff's native
    samples again); with planar configuration 2 and more than one band,
    each plane copied into its band, refused when the file has more
    samples than the mode has bands, and an RGB image of four samples
    with no ExtraSamples taken as associated alpha;
  - a strip's codec as libtiff's reads it: ZSTD the strip's first frame
    (a second frame, or a skippable one first, leaves it short; a frame
    naming a dictionary, a reserved bit or a bad checksum is refused as
    libzstd refuses it); LZMA one ``.xz`` stream, an error after the strip
    is full ignored; CCITT (1 bit a sample) through ``tif_fax3.c``'s
    steps, a row libtiff would pad (a bad code, a wrong length, data that
    ends early) refused; ThunderScan (4 bits a sample, strips only);
  - compressed YCbCr but JPEG: libtiff's RGBA interface
    (``_ycbcr``): YCbCrSubSampling's data units, its conversion tables;
  - JPEG (7): libtiff's JPEG codec, one stream a strip or tile
    (``_jpeg``).

``decode`` gives ``np.asarray(Image.open(...))`` of a single-band image
(16-bit unsigned in native byte order) and raises naming the mode of any
other; ``io/image`` takes ``decode_mode`` to ``convert("RGB")`` through
``io/modes``.  Anything else raises ``ValueError`` with the tag and its
value: old-style JPEG (6), LAB (8) and JPEG in separate planes or with
extra samples ("not read by the port yet"); SGILog (34676, 34677) and
WebP (50001), which Pillow 12.1 cannot open either; other compressions,
bit depths and sample layouts (float16 and float64 samples, which Pillow
does not open either); big-endian BigTIFF (which Pillow 12 fails to
open).
"""

from __future__ import annotations

import copy
import ctypes
import lzma
import struct

import numpy as np

from . import jpeg, modes, native_loader

# Pillow's TiffImagePlugin.PREFIXES: the magics, the two with the version's
# bytes swapped (read in the byte order named), and BigTIFF's
PREFIXES = (b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*", b"MM\x00+", b"II+\x00")
NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 7, 8, 32946, 32773
CCITT_1D, CCITT_G3, CCITT_G4, CCITT_RLEW, THUNDERSCAN = 2, 3, 4, 32771, 32809
LZMA, ZSTD = 34925, 50000
COMPRESSIONS = (NONE, CCITT_1D, CCITT_G3, CCITT_G4, LZW, JPEG, DEFLATE, CCITT_RLEW, PACKBITS,
                THUNDERSCAN, ADOBE_DEFLATE, LZMA, ZSTD)
# libtiff's codecs that take a predictor
_PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE, LZMA, ZSTD)
# libtiff's tif_fax3.c codecs (1 bit a sample)
FAX = (CCITT_1D, CCITT_G3, CCITT_G4, CCITT_RLEW)
# Pillow's TiffImagePlugin.OPEN_INFO but photometric 8 (LAB):
# (byte orders, photometric, sample format, fill order, bits a sample x
# samples, extra samples, mode, raw mode)
_OPEN_INFO_ROWS = (
    ("IM", 0, 1, 1, "1x1", "", "1", "1;I"), ("IM", 0, 1, 2, "1x1", "", "1", "1;IR"),
    ("IM", 1, 1, 1, "1x1", "", "1", "1"), ("IM", 1, 1, 2, "1x1", "", "1", "1;R"),
    ("IM", 0, 1, 1, "2x1", "", "L", "L;2I"), ("IM", 0, 1, 2, "2x1", "", "L", "L;2IR"),
    ("IM", 1, 1, 1, "2x1", "", "L", "L;2"), ("IM", 1, 1, 2, "2x1", "", "L", "L;2R"),
    ("IM", 0, 1, 1, "4x1", "", "L", "L;4I"), ("IM", 0, 1, 2, "4x1", "", "L", "L;4IR"),
    ("IM", 1, 1, 1, "4x1", "", "L", "L;4"), ("IM", 1, 1, 2, "4x1", "", "L", "L;4R"),
    ("IM", 0, 1, 1, "8x1", "", "L", "L;I"), ("IM", 0, 1, 2, "8x1", "", "L", "L;IR"),
    ("IM", 1, 1, 1, "8x1", "", "L", "L"), ("IM", 1, 2, 1, "8x1", "", "L", "L"),
    ("IM", 1, 1, 2, "8x1", "", "L", "L;R"),
    ("I", 1, 1, 1, "12x1", "", "I;16", "I;12"),
    ("I", 0, 1, 1, "16x1", "", "I;16", "I;16"), ("I", 1, 1, 1, "16x1", "", "I;16", "I;16"),
    ("M", 1, 1, 1, "16x1", "", "I;16B", "I;16B"), ("I", 1, 1, 2, "16x1", "", "I;16", "I;16R"),
    ("I", 1, 2, 1, "16x1", "", "I", "I;16S"), ("M", 1, 2, 1, "16x1", "", "I", "I;16BS"),
    ("I", 0, 3, 1, "32x1", "", "F", "F;32F"), ("M", 0, 3, 1, "32x1", "", "F", "F;32BF"),
    ("I", 1, 1, 1, "32x1", "", "I", "I;32N"), ("I", 1, 2, 1, "32x1", "", "I", "I;32S"),
    ("M", 1, 2, 1, "32x1", "", "I", "I;32BS"), ("I", 1, 3, 1, "32x1", "", "F", "F;32F"),
    ("M", 1, 3, 1, "32x1", "", "F", "F;32BF"),
    ("IM", 1, 1, 1, "8x2", "2", "LA", "LA"),
    ("IM", 2, 1, 1, "8x3", "", "RGB", "RGB"), ("IM", 2, 1, 2, "8x3", "", "RGB", "RGB;R"),
    ("IM", 2, 1, 1, "8x4", "", "RGBA", "RGBA"), ("IM", 2, 1, 1, "8x4", "0", "RGB", "RGBX"),
    ("IM", 2, 1, 1, "8x5", "00", "RGB", "RGBXX"), ("IM", 2, 1, 1, "8x6", "000", "RGB", "RGBXXX"),
    ("IM", 2, 1, 1, "8x4", "1", "RGBA", "RGBa"), ("IM", 2, 1, 1, "8x5", "10", "RGBA", "RGBaX"),
    ("IM", 2, 1, 1, "8x6", "100", "RGBA", "RGBaXX"), ("IM", 2, 1, 1, "8x4", "2", "RGBA", "RGBA"),
    ("IM", 2, 1, 1, "8x5", "20", "RGBA", "RGBAX"), ("IM", 2, 1, 1, "8x6", "200", "RGBA", "RGBAXX"),
    ("IM", 2, 1, 1, "8x4", "999", "RGBA", "RGBA"),
    ("I", 2, 1, 1, "16x3", "", "RGB", "RGB;16L"), ("M", 2, 1, 1, "16x3", "", "RGB", "RGB;16B"),
    ("I", 2, 1, 1, "16x4", "", "RGBA", "RGBA;16L"), ("M", 2, 1, 1, "16x4", "", "RGBA", "RGBA;16B"),
    ("I", 2, 1, 1, "16x4", "0", "RGB", "RGBX;16L"), ("M", 2, 1, 1, "16x4", "0", "RGB", "RGBX;16B"),
    ("I", 2, 1, 1, "16x4", "1", "RGBA", "RGBa;16L"),
    ("M", 2, 1, 1, "16x4", "1", "RGBA", "RGBa;16B"),
    ("I", 2, 1, 1, "16x4", "2", "RGBA", "RGBA;16L"),
    ("M", 2, 1, 1, "16x4", "2", "RGBA", "RGBA;16B"),
    ("IM", 3, 1, 1, "1x1", "", "P", "P;1"), ("IM", 3, 1, 2, "1x1", "", "P", "P;1R"),
    ("IM", 3, 1, 1, "2x1", "", "P", "P;2"), ("IM", 3, 1, 2, "2x1", "", "P", "P;2R"),
    ("IM", 3, 1, 1, "4x1", "", "P", "P;4"), ("IM", 3, 1, 2, "4x1", "", "P", "P;4R"),
    ("IM", 3, 1, 1, "8x1", "", "P", "P"), ("IM", 3, 1, 1, "8x2", "0", "P", "PX"),
    ("IM", 3, 1, 1, "8x2", "2", "PA", "PA"), ("IM", 3, 1, 2, "8x1", "", "P", "P;R"),
    ("IM", 5, 1, 1, "8x4", "", "CMYK", "CMYK"), ("IM", 5, 1, 1, "8x5", "0", "CMYK", "CMYKX"),
    ("IM", 5, 1, 1, "8x6", "00", "CMYK", "CMYKXX"),
    ("I", 5, 1, 1, "16x4", "", "CMYK", "CMYK;16L"), ("M", 5, 1, 1, "16x4", "", "CMYK", "CMYK;16B"),
    ("IM", 6, 1, 1, "8x1", "", "L", "L"), ("IM", 6, 1, 1, "8x3", "", "RGB", "RGBX"),
)
# (order "I" / "M", photometric, sample format, fill order, bits tuple,
# extra samples tuple) -> (mode, raw mode)
OPEN_INFO = {}
for _orders, _p, _sf, _fill, _bits, _extra, _mode, _raw in _OPEN_INFO_ROWS:
    _b, _n = _bits.split("x")
    _extras = (999,) if _extra == "999" else tuple(int(c) for c in _extra)
    for _o in _orders:
        OPEN_INFO[_o, _p, (_sf,), _fill, (int(_b),) * int(_n), _extras] = (_mode, _raw)
# the largest number of samples a pixel Pillow reads
MAX_SAMPLES = 6
# photometric -> the samples before the extra ones
_BASE_SAMPLES = {2: 3, 5: 4, 6: 3, 8: 3}
_TAG_NAMES = {258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
              266: "FillOrder", 274: "Orientation", 277: "SamplesPerPixel",
              278: "RowsPerStrip", 284: "PlanarConfiguration", 317: "Predictor",
              320: "ColorMap", 322: "TileWidth", 323: "TileLength", 338: "ExtraSamples",
              339: "SampleFormat", 347: "JPEGTables", 529: "YCbCrCoefficients",
              530: "YCbCrSubSampling", 532: "ReferenceBlackWhite"}
_REFUSED_PHOTOMETRIC = {8: "CIE L*a*b* (its conversion is littleCMS's)"}
_REFUSED_COMPRESSION = {6: "old-style JPEG"}
# compressions in Pillow's COMPRESSION_INFO that Pillow 12.1 cannot open:
# the port refuses them as Pillow fails
_UNOPENED_COMPRESSION = {
    34676: "SGILog (libtiff decodes it for photometric 32844 / 32845 only, which Pillow has no "
           "mode for)",
    34677: "SGILog24 (libtiff decodes it for photometric 32845 only, which Pillow has no mode "
           "for)",
    50001: "WebP (Pillow 12.1's libtiff is built without it)"}
# the sizes of the TIFF field types (BigTIFF's LONG8, SLONG8 and IFD8 too)
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
              16: 8, 17: 8, 18: 8}
_INT_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_FLOAT_TYPES = {11: "f", 12: "d"}
_RATIONAL_TYPES = {5: "I", 10: "i"}
# Pillow's decompression bomb limit: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * int(1024 * 1024 * 1024 // 4 // 3)
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
_ERR_LEN = 256


def library():
    """The loaded native library; ``RuntimeError`` naming the build error
    when it cannot be built or loaded."""
    return native_loader.library("TIFF decompressors")


def _ifd(data: bytes) -> tuple[str, dict]:
    """(byte order "<" / ">", {tag: tuple of values}) of the first image
    directory, of a classic TIFF or a BigTIFF (a 16-byte header, 8-byte
    entry counts and offsets, 20-byte entries).  Integers are ints,
    rationals and floats float32 values as libtiff reads them (a rational's
    numerator and denominator each rounded to float32, then divided;
    0 over 0 is 0), JPEGTables (347) its bytes; other types are skipped."""
    if data[:4] not in PREFIXES:
        raise ValueError(f"not a TIFF file (it starts with {data[:4]!r})")
    e = "<" if data[:2] == b"II" else ">"
    big = data[:4] in PREFIXES[4:]
    if data[:4] == b"MM\x00+":
        raise ValueError("big-endian BigTIFF (MM\\0+): Pillow 12 reads its header as a classic "
                         "TIFF's and fails")
    if big:
        if len(data) < 16:
            raise ValueError(f"BigTIFF header of {len(data)} bytes: 16 are read")
        size, zero, off = struct.unpack_from(e + "HHQ", data, 4)
        if (size, zero) != (8, 0):
            raise ValueError(f"BigTIFF with offsets of {size} bytes (and {zero}): 8 (and 0) "
                             "are read")
        count_fmt, offset_fmt, entry = "Q", "Q", 20
    else:
        (off,) = struct.unpack_from(e + "I", data, 4)
        count_fmt, offset_fmt, entry = "H", "I", 12
    inline = struct.calcsize(offset_fmt)
    start = off + struct.calcsize(count_fmt)
    if start > len(data):
        raise ValueError(f"image directory at {off} lies past the end ({len(data)} bytes)")
    (n,) = struct.unpack_from(e + count_fmt, data, off)
    if start + entry * n > len(data):
        raise ValueError(f"image directory of {n} entries runs past the end")
    tags = {}
    for i in range(n):
        at = start + entry * i
        tag, typ = struct.unpack_from(e + "HH", data, at)
        (count,) = struct.unpack_from(e + offset_fmt, data, at + 4)
        if typ not in _TYPE_SIZE or not (typ in _INT_TYPES or typ in _FLOAT_TYPES
                                         or typ in _RATIONAL_TYPES or tag == 347):
            continue
        size = _TYPE_SIZE[typ] * count
        at += 4 + inline
        if size > inline:
            (at,) = struct.unpack_from(e + offset_fmt, data, at)
        if at + size > len(data):
            raise ValueError(f"tag {tag}'s {count} values lie past the end of the file")
        if tag == 347:
            tags[tag] = bytes(data[at:at + size])
        elif typ in _RATIONAL_TYPES:
            pairs = np.frombuffer(data, e + _RATIONAL_TYPES[typ] * 1, 2 * count, at)
            num, den = pairs[0::2].astype(np.float32), pairs[1::2].astype(np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                tags[tag] = tuple(np.where(den == 0, np.float32(0), num / den).tolist())
        else:
            fmt = _INT_TYPES.get(typ) or _FLOAT_TYPES[typ]
            tags[tag] = struct.unpack_from(e + fmt * count, data, at)
    return e, tags


def _one(tags: dict, tag: int, default=None) -> int:
    vals = tags.get(tag)
    if vals is None:
        if default is None:
            raise ValueError(f"tag {tag} is missing")
        return default
    if len(set(vals)) != 1:
        raise ValueError(f"{_TAG_NAMES.get(tag, 'tag')} (tag {tag}) = {list(vals)}: "
                         "several values are not read")
    return vals[0]


def _refuse(tag: int, value, why: str):
    raise ValueError(f"{_TAG_NAMES.get(tag, 'tag')} (tag {tag}) = {value}: {why}")


class _Layout:
    """What Pillow's ``_setup`` makes of the tags: the mode, the raw mode,
    the samples and how they are stored."""

    def __init__(self, e: str, tags: dict):
        order = "I" if e == "<" else "M"
        self.compression = _one(tags, 259, 1)
        if self.compression in _REFUSED_COMPRESSION:
            _refuse(259, self.compression, f"{_REFUSED_COMPRESSION[self.compression]} is not "
                    "read by the port yet")
        if self.compression in _UNOPENED_COMPRESSION:
            _refuse(259, self.compression, f"{_UNOPENED_COMPRESSION[self.compression]}: not a "
                    "form Pillow opens")
        if self.compression not in COMPRESSIONS:
            _refuse(259, self.compression, "not read (none 1, CCITT 2 / 3 / 4 / 32771, LZW 5, "
                    "JPEG 7, deflate 8 / 32946, PackBits 32773, ThunderScan 32809, LZMA 34925 "
                    "and ZSTD 50000 are)")
        self.planar = _one(tags, 284, 1)
        photometric = _one(tags, 262, 0)
        if photometric in _REFUSED_PHOTOMETRIC:
            _refuse(262, photometric, f"{_REFUSED_PHOTOMETRIC[photometric]} is not read by the "
                    "port yet")
        self.jpeg = self.compression == JPEG
        if self.jpeg and photometric not in (1, 2, 6):
            _refuse(262, photometric, "with JPEG compression, not read by the port yet (1, 2 "
                    "and 6 are)")
        if self.jpeg and self.planar != 1:
            _refuse(284, self.planar, "JPEG in separate planes is not read by the port yet")
        fill = _one(tags, 266, 1)
        self.width, self.height = _one(tags, 256), _one(tags, 257)
        if self.width * self.height > MAX_PIXELS:
            raise ValueError(f"{self.width}x{self.height} pixels: above Pillow's decompression "
                             f"bomb limit of {MAX_PIXELS}")
        fmt = tags.get(339, (1,))
        if len(fmt) > 1 and set(fmt) == {1}:
            fmt = (1,)
        bits = tags.get(258, (1,))
        extra = tags.get(338, ())
        self.band_count = _BASE_SAMPLES.get(photometric, 1) + len(extra)
        spp = tags.get(277, (1,))[0]
        if spp > MAX_SAMPLES:
            _refuse(277, spp, f"more than the {MAX_SAMPLES} samples a pixel Pillow reads")
        if spp < len(bits):
            bits = bits[:spp]
        elif spp > len(bits) == 1:
            bits = bits * spp
        if len(bits) != spp:
            _refuse(258, list(bits), f"not one value a sample ({spp} samples a pixel)")
        key = (order, photometric, tuple(fmt), fill, tuple(bits), tuple(extra))
        if key not in OPEN_INFO:
            raise ValueError(f"BitsPerSample {list(bits)}, SampleFormat {list(fmt)}, "
                             f"PhotometricInterpretation {photometric}, FillOrder {fill}, "
                             f"ExtraSamples {list(extra)} in {order * 2} byte order: not a form "
                             "Pillow opens")
        self.mode, self.rawmode = OPEN_INFO[key]
        if self.compression in FAX and bits != (1,):
            _refuse(259, self.compression, f"CCITT of BitsPerSample {list(bits)}: libtiff's "
                    "codecs decode 1 bit a sample")
        if self.compression == THUNDERSCAN and bits != (4,):
            _refuse(259, self.compression, f"ThunderScan of BitsPerSample {list(bits)}: libtiff "
                    "decodes 4 bits a sample")
        if self.jpeg and spp != _BASE_SAMPLES.get(photometric, 1):
            _refuse(277, spp, f"JPEG of photometric {photometric} with extra samples is not read "
                    "by the port yet")
        self.libtiff = self.compression != NONE
        # compressed YCbCr: libtiff's RGBA interface (JPEG: libjpeg's RGB)
        self.ycbcr = photometric == 6 and self.libtiff and not self.jpeg
        if self.ycbcr and spp != 3:
            _refuse(277, spp, "YCbCr of one sample through libtiff: Pillow's decoder fails")
        if self.libtiff and fill == 2:
            # libtiff undoes the fill order: the raw mode of fill order 1
            self.mode, self.rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if self.libtiff and self.rawmode == "I;16":
            self.rawmode = "I;16N"
        elif self.libtiff and self.rawmode.endswith((";16B", ";16L")):
            self.rawmode = self.rawmode[:-1] + "N"
        self.fill, self.spp, self.bits, self.fmt = fill, spp, bits[0], fmt[0]
        self.photometric, self.extra = photometric, extra
        # libtiff reads tiles when the tile size is given; Pillow's raw
        # decoder reads strips when their offsets are given
        self.tiled = ((322 in tags or 323 in tags) if self.libtiff
                      else 273 not in tags and 324 in tags)
        if self.tiled and self.compression == THUNDERSCAN:
            _refuse(259, THUNDERSCAN, "ThunderScan in tiles: libtiff has no tile decoder for it")
        # Group3Options (T4Options): bit 0, 2D coding
        self.fax_options = _one(tags, 292, 0) if self.compression == CCITT_G3 else 0
        self.palette = None
        if self.mode in ("P", "PA"):
            if 320 not in tags:
                raise ValueError(f"ColorMap (tag 320) is missing in a palette image "
                                 f"(PhotometricInterpretation {photometric})")
            cmap = np.asarray(tags[320], np.int64) // 256
            n = len(cmap) // 3
            self.palette = cmap[:3 * n].reshape(3, n).T.astype(np.uint8)
            if n > 256:
                _refuse(320, f"{n} colours", "more than 256")


def _chunks(tags: dict, layout: _Layout):
    """(offsets, byte counts, chunk width, chunk rows) of the strips or
    tiles."""
    if layout.tiled:
        offsets, counts = tags.get(324, tags.get(273)), tags.get(325, tags.get(279))
        tw, tl = tags.get(322, (None,))[0], tags.get(323, (None,))[0]
        if offsets is None or tw is None or tl is None:
            raise ValueError("a tiled TIFF without TileOffsets (324), TileWidth (322) or "
                             "TileLength (323)")
        if tw < 1 or tl < 1:
            _refuse(322, (tw, tl), "a tile holds no pixel")
        return offsets, counts, tw, tl
    offsets, counts = tags.get(273), tags.get(279)
    if offsets is None:
        raise ValueError("StripOffsets (tag 273) is missing")
    rps = _one(tags, 278, 2 ** 32 - 1)
    if rps < 1:
        _refuse(278, rps, "a strip holds no row")
    return offsets, counts, layout.width, rps


def _raw(data: bytes, tags: dict, layout: _Layout) -> np.ndarray:
    """No compression: Pillow's raw decoder on its tile list."""
    offsets, _, w, h = _chunks(tags, layout)
    xsize, ysize = layout.width, layout.height
    img = modes.new(layout.mode, ysize, xsize)
    if not layout.tiled:
        h = tags.get(278, (ysize,))[0]
    if w == xsize and h == ysize and layout.planar != 2:
        offsets = offsets[-1:]
    total_bits = layout.bits * layout.spp
    x = y = layer = 0
    for offset in offsets:
        stride = w * total_bits / 8 if x + w > xsize else 0
        rawmode = layout.rawmode
        if layout.planar == 2:
            if layer >= len(rawmode):
                raise ValueError(f"{len(offsets)} strips or tiles for {len(rawmode)} planes")
            rawmode = rawmode[layer]
            stride /= layout.band_count
        stride = int(stride)
        tile_w, rows = min(x + w, xsize) - x, min(y + h, ysize) - y
        bits = modes.rawmode_bits(layout.mode, rawmode)
        need = (tile_w * bits + 7) // 8
        if stride and stride < need:
            raise ValueError(f"tile rows of {stride} bytes, raw mode {rawmode} reads {need}: "
                             "Pillow's codec configuration error")
        step = stride or need
        size = (rows - 1) * step + need if rows > 0 else 0
        body = data[offset:offset + size]
        if len(body) < size:
            raise ValueError(f"strip or tile at {offset} truncated: {len(body)} of {size} bytes")
        if rows > 0 and tile_w > 0:
            block = np.frombuffer(body + bytes(rows * step - size), np.uint8).reshape(rows, step)
            modes.unpack_into(img, layout.mode, rawmode, block, y, x, tile_w)
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y, layer = 0, layer + 1
    return img


def _unxz(src: bytes, want: int, what: str) -> np.ndarray:
    """libtiff's tif_lzma.c: one .xz stream (liblzma's stream decoder, no
    concatenated streams) until the strip is full, by Python's ``lzma``.
    libtiff ignores an error once the strip is full (a bad check, a cut
    index): after an error the stream is fed again a byte at a time to
    find how much came out before it."""
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, want)
    except lzma.LZMAError as e:
        dec, parts, got = lzma.LZMADecompressor(lzma.FORMAT_XZ), [], 0
        try:
            for i in range(len(src)):
                if got >= want or dec.eof:
                    break
                parts.append(dec.decompress(src[i:i + 1], want - got))
                got += len(parts[-1])
        except lzma.LZMAError:
            pass
        out = b"".join(parts)
        if len(out) < want:
            raise ValueError(f"{what}: LZMA: {e} after {len(out)} of the strip's {want} "
                             "bytes") from None
    if len(out) < want:
        raise ValueError(f"{what}: LZMA: the stream ends after {len(out)} of the strip's {want} "
                         "bytes")
    return np.frombuffer(out, np.uint8)


def _inflate(lib, src: bytes, compression: int, want: int, what: str, width: int = 0,
             options: int = 0, odd: bool = False) -> np.ndarray:
    """One strip or tile decompressed to ``want`` bytes; ``width``,
    ``options`` and ``odd`` (the strip's file offset is odd) are the CCITT
    and ThunderScan decoders' (``csrc/tiff_decode.cpp``)."""
    if compression == LZMA:
        return _unxz(src, want, what)
    out = np.empty(want, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.tiff_decompress(src, len(src), compression, width, options, int(odd),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), want, err,
                           _ERR_LEN) != 0:
        raise ValueError(f"{what}: {err.value.decode()}")
    return out


def _unpredict(rows: np.ndarray, layout: _Layout, predictor: int, samples: int) -> np.ndarray:
    """libtiff's predictor decoding of (n, row bytes) native-order rows of
    ``samples`` samples a pixel."""
    size = layout.bits // 8
    n = len(rows)
    if predictor == 2:
        u = rows.view(f"<u{size}").reshape(n, -1, samples)
        return np.cumsum(u, axis=1, dtype=u.dtype).reshape(n, -1).view(np.uint8)
    # 3: byte planes, the most significant first, differenced as bytes
    width = rows.shape[1] // size
    planes = np.cumsum(rows, axis=1, dtype=np.uint8).reshape(n, size, width)
    be = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(f">u{size}")[..., 0]
    return be.astype(f"<u{size}").view(np.uint8).reshape(n, -1)


def _libtiff(data: bytes, tags: dict, layout: _Layout, e: str) -> np.ndarray:
    """Compressed: libtiff's strips or tiles, then Pillow's unpacker."""
    offsets, counts, cw, ch = _chunks(tags, layout)
    if counts is None:
        raise ValueError(f"{'TileByteCounts (tag 325)' if layout.tiled else 'StripByteCounts '
                         '(tag 279)'} is missing")
    xsize, ysize = layout.width, layout.height
    bands = modes.BANDS[layout.mode]
    separate = layout.planar == 2 and bands > 1
    if layout.planar == 2 and layout.spp > bands and not (layout.tiled and separate):
        _refuse(284, 2, f"{layout.spp} planes for the {bands} bands of mode {layout.mode} in "
                f"{'tiles' if layout.tiled else 'strips'}: Pillow's libtiff decoder "
                f"{'reads bytes libtiff does not write' if layout.tiled else 'fails'}")
    rawmode = layout.rawmode
    if separate:
        # the planes of the mode's bands, the rest unread
        base, _, suffix = rawmode.partition(";")
        rawmode = base.replace("X", "") + (";" + suffix if suffix else "")
        if layout.photometric == 2 and layout.spp == 4 and not layout.extra:
            rawmode = "RGBa" + rawmode[4:]
    planes = min(layout.spp, bands) if separate else 1
    samples = 1 if layout.planar == 2 else layout.spp
    predictor = _one(tags, 317, 1) if layout.compression in _PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 3 and layout.fmt != 3):
        _refuse(317, predictor, f"not read with SampleFormat {layout.fmt}")
    if predictor == 2 and layout.bits not in (8, 16, 32):
        _refuse(317, predictor, f"libtiff has no horizontal differencing of {layout.bits}-bit "
                "samples")
    across = -(-xsize // cw)
    down = -(-ysize // ch)
    per_plane = down * (across if layout.tiled else 1)
    if len(offsets) < per_plane * planes or len(counts) < per_plane * planes:
        raise ValueError(f"{len(offsets)} offsets and {len(counts)} byte counts, "
                         f"{per_plane * planes} strips or tiles needed")
    row_bytes = (cw * samples * layout.bits + 7) // 8
    size = layout.bits // 8
    swap = e == ">" and size in (2, 4) and predictor != 3
    assembled = np.zeros((ysize, xsize, planes), np.uint8) if separate and size == 1 else None
    if separate and size == 2:
        assembled = np.zeros((ysize, xsize, planes, 2), np.uint8)
    img = modes.new(layout.mode, ysize, xsize)
    lib = library()
    for plane in range(planes):
        for k in range(per_plane):
            index = plane * per_plane + k
            ty, tx = divmod(k, across) if layout.tiled else (k, 0)
            y, x = ty * ch, tx * cw
            rows = ch if layout.tiled else min(ch, ysize - y)
            src = data[offsets[index]:offsets[index] + counts[index]]
            if layout.fill == 2:
                src = _REVERSED[np.frombuffer(src, np.uint8)].tobytes()
            what = f"{'tile' if layout.tiled else 'strip'} {index}"
            block = _inflate(lib, src, layout.compression, rows * row_bytes, what, cw,
                             layout.fax_options, offsets[index] & 1)
            block = block.reshape(rows, row_bytes)
            if swap:
                block = block.view(f">u{size}").astype(f"<u{size}").view(np.uint8)
            if predictor != 1:
                block = _unpredict(block, layout, predictor, samples)
            keep_w, keep_h = min(cw, xsize - x), min(rows, ysize - y)
            block = block[:keep_h]
            if separate:
                vals = block[:, :keep_w * size].reshape(keep_h, keep_w, size)
                assembled[y:y + keep_h, x:x + keep_w, plane] = vals[..., 0] if size == 1 else vals
            else:
                modes.unpack_into(img, layout.mode, rawmode, block, y, x, keep_w)
    if separate:
        modes.unpack_into(img, layout.mode, rawmode, assembled.reshape(ysize, -1), 0, 0, xsize)
    return img


# YCbCrSubSampling (530) values libtiff's RGBA interface converts
# (tif_getimage.c pickContigCase); TIFF 6.0's default is (2, 2)
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _ycbcr_tables(tags: dict) -> tuple:
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) of YCbCrCoefficients (529,
    default 0.299 / 0.587 / 0.114) and ReferenceBlackWhite (532, default
    0 255 128 255 128 255), in its float32 and fixed-point (16 bits)
    arithmetic: (Y, Cr -> R, Cb -> B, Cr -> G, Cb -> G) tables of 256."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in tags.get(532, (0, 255, 128, 255, 128, 255))]
    if len(luma) != 3 or any(v != v for v in luma) or luma[1] == 0:
        _refuse(529, [float(v) for v in luma], "libtiff's initYCbCrConversion rejects it")
    if len(rbw) != 6 or not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in rbw):
        _refuse(532, [float(v) for v in rbw], "libtiff's initYCbCrConversion rejects it")

    def fix(x):      # FIX: (int32_t)(x * 65536 + 0.5), the product in float32
        return int(np.float64(f32(x * f32(65536))) + 0.5)

    def clamp(f, lo, hi):
        return lo if not f >= lo else (hi if f > hi else f)

    def code2v(c, rb, rw, cr):
        span = f32(rw - rb)
        return f32(f32(f32(c - int(rb)) * f32(cr)) / (span if span != 0 else f32(1)))

    lr, lg, lb = luma
    f1 = f32(2 - f32(2 * lr))
    f3 = f32(2 - f32(2 * lb))
    d1, d3 = fix(clamp(f1, f32(0), f32(2))), fix(clamp(f3, f32(0), f32(2)))
    d2 = -fix(clamp(f32(f32(lr * f1) / lg), f32(0), f32(2)))
    d4 = -fix(clamp(f32(f32(lb * f3) / lg), f32(0), f32(2)))
    lim = (f32(-128 * 32), f32(128 * 32))
    cr = np.array([int(clamp(code2v(x, f32(rbw[4] - 128), f32(rbw[5] - 128), 127), *lim))
                   for x in range(-128, 128)], np.int64)
    cb = np.array([int(clamp(code2v(x, f32(rbw[2] - 128), f32(rbw[3] - 128), 127), *lim))
                   for x in range(-128, 128)], np.int64)
    y = np.array([int(clamp(code2v(i, rbw[0], rbw[1], 255), *lim)) for i in range(256)],
                 np.int64)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768)


def _ycbcr_to_rgb(ycc: np.ndarray, tables: tuple) -> np.ndarray:
    """libtiff's TIFFYCbCrtoRGB of (H, W, 3) uint8 Y, Cb, Cr."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    y, cb, cr = (ycc[..., i].astype(np.intp) for i in range(3))
    yv = y_tab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr(data: bytes, tags: dict, layout: _Layout, e: str) -> np.ndarray:
    """Compressed YCbCr, as Pillow reads it through libtiff's RGBA interface
    (TIFFRGBAImageGet): the samples of each strip or tile (YCbCrSubSampling
    (530) (h, v), default (2, 2): data units of h x v luma samples then Cb
    and Cr, each unit's chroma replicated over its pixels), converted by
    libtiff's tables.  Subsampled data takes no predictor; in separate
    planes only (1, 1) is converted."""
    sub = tuple(tags.get(530, (2, 2)))
    if sub not in _SUBSAMPLINGS:
        _refuse(530, list(sub), "libtiff's RGBA interface converts (1, 1), (1, 2), (2, 1), "
                "(2, 2), (4, 1), (4, 2) and (4, 4)")
    if layout.planar == 2 and sub != (1, 1):
        _refuse(530, list(sub), "in separate planes libtiff converts (1, 1) only")
    tables = _ycbcr_tables(tags)
    if sub == (1, 1):
        # one sample a pixel each: the samples as an RGB image's
        samples = copy.copy(layout)
        samples.mode = samples.rawmode = "RGB"
        return _ycbcr_to_rgb(_libtiff(data, tags, samples, e), tables)
    predictor = _one(tags, 317, 1) if layout.compression in _PREDICTED else 1
    if predictor != 1:
        _refuse(317, predictor, f"with YCbCr subsampled {sub}: not read by the port")
    offsets, counts, cw, ch = _chunks(tags, layout)
    if counts is None:
        raise ValueError(f"{'TileByteCounts (tag 325)' if layout.tiled else 'StripByteCounts '
                         '(tag 279)'} is missing")
    hs, vs = sub
    xsize, ysize = layout.width, layout.height
    across = -(-xsize // cw)
    n = -(-ysize // ch) * (across if layout.tiled else 1)
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"{len(offsets)} offsets and {len(counts)} byte counts, {n} strips or "
                         "tiles needed")
    units_x, unit = -(-cw // hs), hs * vs + 2
    ycc = np.zeros((ysize, xsize, 3), np.uint8)
    lib = library()
    for k in range(n):
        ty, tx = divmod(k, across) if layout.tiled else (k, 0)
        y, x = ty * ch, tx * cw
        rows = ch if layout.tiled else min(ch, ysize - y)
        units_y = -(-rows // vs)
        keep_w, keep_h = min(cw, xsize - x), min(rows, ysize - y)
        src = data[offsets[k]:offsets[k] + counts[k]]
        what = f"{'tile' if layout.tiled else 'strip'} {k}"
        size = units_y * units_x * unit
        # gtStripContig reads TIFFScanlineSize (a row of units over v,
        # rounded down) times the rows rounded up to v; the rest is zero
        read = size if layout.tiled else units_y * vs * (units_x * unit // vs)
        buf = np.zeros(size, np.uint8)
        buf[:read] = _inflate(lib, src, layout.compression, read, what)
        used, stride = -(-keep_w // hs), units_x * unit
        if sub == (4, 4) and keep_w < cw:
            # putcontig8bitYCbCr44tile skips a clipped tile's hidden units
            # at 10 bytes each (its fromskew), not 18
            stride = used * unit + (cw - keep_w) // 4 * 10
        block = buf[np.arange(units_y)[:, None, None] * stride
                    + np.arange(used)[None, :, None] * unit + np.arange(unit)]
        luma = block[..., :hs * vs].reshape(units_y, used, vs, hs).transpose(0, 2, 1, 3)
        full = np.empty((units_y * vs, used * hs, 3), np.uint8)
        full[..., 0] = luma.reshape(units_y * vs, used * hs)
        for c in (1, 2):
            full[..., c] = np.repeat(np.repeat(block[..., hs * vs + c - 1], vs, 0), hs, 1)
        ycc[y:y + keep_h, x:x + keep_w] = full[:keep_h, :keep_w]
    return _ycbcr_to_rgb(ycc, tables)


def _jpeg(data: bytes, tags: dict, layout: _Layout) -> np.ndarray:
    """Compression 7 through libtiff's JPEG codec: each strip or tile one
    JPEG stream, read after JPEGTables (347) when given, decoded by the
    port's JPEG decoder on its own (so upsampling stops at its edges), its
    size the strip's (the last strip's may be taller) or the tile's, the
    tile cropped at the image's edge.  Photometric 1 and 2: the components
    as stored (libtiff asks libjpeg for no colour conversion), every
    sampling factor 1; 6: RGB from the samples taken as YCbCr (Pillow sets
    JPEGCOLORMODE_RGB), the first component's sampling factors those of
    YCbCrSubSampling (530; when absent, libtiff reads them off the first
    stream), the others' 1."""
    tables = tags.get(347, b"")
    offsets, counts, cw, ch = _chunks(tags, layout)
    if counts is None:
        raise ValueError(f"{'TileByteCounts (tag 325)' if layout.tiled else 'StripByteCounts '
                         '(tag 279)'} is missing")
    xsize, ysize = layout.width, layout.height
    across = -(-xsize // cw)
    n = -(-ysize // ch) * (across if layout.tiled else 1)
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"{len(offsets)} offsets and {len(counts)} byte counts, {n} strips or "
                         "tiles needed")
    ycbcr = layout.photometric == 6
    sub = tuple(tags[530]) if ycbcr and 530 in tags else None
    img = modes.new(layout.mode, ysize, xsize)
    jpeg.library()
    for k in range(n):
        ty, tx = divmod(k, across) if layout.tiled else (k, 0)
        y, x = ty * ch, tx * cw
        rows = ch if layout.tiled else min(ch, ysize - y)
        src = data[offsets[k]:offsets[k] + counts[k]]
        what = f"Compression (tag 259) = 7, {'tile' if layout.tiled else 'strip'} {k}"
        try:
            info = jpeg.info(src, tables)
            if info.components != layout.spp:
                raise ValueError(f"a JPEG stream of {info.components} components for "
                                 f"{layout.spp} samples a pixel")
            if ycbcr and sub is None:
                sub = info.sampling[0]
            want = [sub if ycbcr and c == 0 else (1, 1) for c in range(info.components)]
            if list(info.sampling) != want:
                raise ValueError(f"JPEG sampling factors {list(info.sampling)}, libtiff "
                                 f"expects {want}" + (" (YCbCrSubSampling, tag 530)"
                                                       if ycbcr else ""))
            taller = not layout.tiled and k == n - 1 and info.height > rows
            if info.width != cw or (info.height != rows and not taller):
                raise ValueError(f"a JPEG stream of {info.width}x{info.height} for a "
                                 f"{cw}x{rows} {'tile' if layout.tiled else 'strip'}")
            block = jpeg.decode_form(src, jpeg.YCBCR if ycbcr else jpeg.COMPONENTS, tables)
        except (RuntimeError, ValueError) as e:
            raise ValueError(f"{what}: {e}") from None
        keep_w, keep_h = min(cw, xsize - x), min(rows, ysize - y)
        part = block[:keep_h, :keep_w]
        img[y:y + keep_h, x:x + keep_w] = part[..., 0] if img.ndim == 2 else part
    return img


# Orientation (tag 274) -> the transposition Pillow's exif_transpose applies
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}


def decode_mode(data: bytes) -> tuple[str, np.ndarray, np.ndarray | None]:
    """(Pillow's mode, ``np.asarray(Image.open(...))`` with 16-bit samples in
    native order, the palette as (N, 3) uint8 for ``P`` / ``PA``) of a TIFF
    file's bytes."""
    e, tags = _ifd(data)
    layout = _Layout(e, tags)
    if layout.jpeg:
        img = _jpeg(data, tags, layout)
    elif layout.ycbcr:
        img = _ycbcr(data, tags, layout, e)
    else:
        img = _libtiff(data, tags, layout, e) if layout.libtiff else _raw(data, tags, layout)
    orientation = tags.get(274, (1,))[0]
    if orientation in _ORIENT:
        img = np.ascontiguousarray(_ORIENT[orientation](img))
    return layout.mode, img, layout.palette


def decode(data: bytes) -> np.ndarray:
    """(H, W) array of a single-band TIFF, as ``np.asarray(Image.open(...))``
    (16-bit unsigned in native byte order)."""
    mode, img, _ = decode_mode(data)
    if modes.BANDS[mode] != 1:
        raise ValueError(f"mode {mode}: a depth image has one band")
    return img
