"""TIFF decoding without an imaging library: depth images that the JAX
package opens with Pillow (``np.asarray(Image.open(path))`` in
``hrbffusion3d_tpu/io/tum.py``; Pillow reads compressed TIFF through
libtiff).

The container is read here with numpy; the strips are inflated by the
port's C++ decompressors (``csrc/tiff_decode.cpp``, compiled into the
native loader's library by ``io/native_loader``; a library that does not
build raises ``RuntimeError`` naming the build error).  It reads the first
image of a baseline strip TIFF in either byte order (``II`` or ``MM``) of
one grey sample per pixel, 8-, 16- or 32-bit unsigned, 8-, 16- or 32-bit
signed, or 32-bit float; compressed with none (1), LZW (5), deflate (8,
32946) or PackBits (32773); with predictor 1, 2 (horizontal differencing
of the samples, modulo their width) or 3 (floating point: byte planes, the
most significant first, differenced as bytes).

It gives what Pillow 12 gives, quirks included:

  - the mode's dtype: 8-bit as uint8 (``L``; signed samples as their
    bytes; inverted, 255 - v, when black is 1, photometric 0), 16-bit
    unsigned as uint16 (``I;16`` / ``I;16B``, here in native byte order),
    16-bit signed and 32-bit integers as int32 (``I``; an unsigned 32-bit
    sample as the int32 of its bits), float as float32 (``F``);
  - the (byte order, photometric, sample format, bits) combinations
    Pillow opens, and no other: photometric 1 for all, photometric 0 also
    for 8-bit, for little-endian unsigned 16-bit and for float; unsigned
    32-bit only little-endian;
  - the predictor only with LZW and deflate, the codecs libtiff applies it
    in (with no compression or PackBits it is ignored);
  - a big-endian file's compressed 16-bit signed, 32-bit and float samples
    come back byte-swapped: libtiff hands Pillow native-order samples and
    Pillow swaps them again as big-endian.

Anything else raises ``ValueError`` with the tag and its value: tiles,
several samples per pixel, other compressions (JPEG, CCITT, ...), other
bit depths, bit fill order 2, BigTIFF.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from . import native_loader

MAGICS = (b"II*\x00", b"MM\x00*")
NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773
COMPRESSIONS = (NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS)
# libtiff's codecs that take a predictor
_PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE)
# (byte order, photometric, sample format, bits) -> the decoded dtype; the
# grey rows of Pillow's TiffImagePlugin.OPEN_INFO
_FORMS = {}
for _o in "IM":
    for _p in (0, 1):
        _FORMS[_o, _p, 1, 8] = np.uint8
        _FORMS[_o, _p, 3, 32] = np.float32
    _FORMS[_o, 1, 2, 8] = np.uint8
    _FORMS[_o, 1, 2, 16] = np.int32
    _FORMS[_o, 1, 2, 32] = np.int32
    _FORMS[_o, 1, 1, 16] = np.uint16
_FORMS["I", 0, 1, 16] = np.uint16
_FORMS["I", 1, 1, 32] = np.int32
_TAG_NAMES = {258: "BitsPerSample", 259: "Compression", 262: "PhotometricInterpretation",
              266: "FillOrder", 277: "SamplesPerPixel", 278: "RowsPerStrip", 317: "Predictor",
              339: "SampleFormat"}
# the sizes of the TIFF field types
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4}
_INT_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I"}
_ERR_LEN = 256


def library():
    """The loaded native library; ``RuntimeError`` naming the build error
    when it cannot be built or loaded."""
    if not native_loader.available():
        raise RuntimeError("TIFF decompressors unavailable: the native library did not build: "
                           f"{native_loader.status()['build_error']}")
    return native_loader._LIB


def _ifd(data: bytes) -> tuple[str, dict]:
    """(byte order "<" / ">", {tag: tuple of integer values}) of the first
    image directory."""
    if data[:4] not in MAGICS:
        if data[:2] in (b"II", b"MM") and data[2:4] in (b"+\x00", b"\x00+"):
            raise ValueError("BigTIFF is not read")
        raise ValueError(f"not a TIFF file (it starts with {data[:4]!r})")
    e = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack_from(e + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError(f"image directory at {off} lies past the end ({len(data)} bytes)")
    (n,) = struct.unpack_from(e + "H", data, off)
    if off + 2 + 12 * n > len(data):
        raise ValueError(f"image directory of {n} entries runs past the end")
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(e + "HHI", data, off + 2 + 12 * i)
        if typ not in _INT_TYPES:
            continue
        size = _TYPE_SIZE[typ] * count
        at = off + 2 + 12 * i + 8
        if size > 4:
            (at,) = struct.unpack_from(e + "I", data, at)
            if at + size > len(data):
                raise ValueError(f"tag {tag}'s {count} values lie past the end of the file")
        tags[tag] = struct.unpack_from(e + _INT_TYPES[typ] * count, data, at)
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


def _strips(data: bytes, tags: dict, compression: int, height: int, row_bytes: int) -> bytes:
    """The image's rows, decompressed, as one buffer."""
    offsets = tags.get(273)
    counts = tags.get(279)
    if offsets is None:
        raise ValueError("StripOffsets (tag 273) is missing")
    if counts is None:
        raise ValueError("StripByteCounts (tag 279) is missing")
    rps = _one(tags, 278, 2 ** 32 - 1)
    if rps < 1:
        _refuse(278, rps, "a strip holds no row")
    rps = min(rps, height)
    n = -(-height // rps) if height else 0
    if len(offsets) < n or len(counts) < n:
        raise ValueError(f"{len(offsets)} strip offsets and {len(counts)} byte counts, "
                         f"{height} rows of {rps} a strip need {n}")
    out = np.empty(height * row_bytes, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = library() if compression != NONE else None
    for k in range(n):
        rows = min(rps, height - k * rps)
        want = rows * row_bytes
        src = data[offsets[k]:offsets[k] + counts[k]]
        dst = out[k * rps * row_bytes:k * rps * row_bytes + want]
        if compression == NONE:
            if len(src) < want:
                raise ValueError(f"strip {k} holds {len(src)} bytes, its {rows} rows need "
                                 f"{want}")
            dst[:] = np.frombuffer(src, np.uint8, want)
        elif lib.tiff_decompress(src, len(src), compression,
                                 dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), want,
                                 err, _ERR_LEN) != 0:
            raise ValueError(f"strip {k}: {err.value.decode()}")
    return out


def decode(data: bytes) -> np.ndarray:
    """(H, W) array of a TIFF file's bytes, as ``np.asarray(Image.open(...))``
    (16-bit unsigned in native byte order)."""
    e, tags = _ifd(data)
    if 322 in tags or 324 in tags:
        raise ValueError("a tiled TIFF (TileWidth, tag 322) is not read: strips only")
    spp = _one(tags, 277, 1)
    if spp != 1:
        _refuse(277, spp, "one grey sample per pixel is read")
    compression = _one(tags, 259, 1)
    if compression not in COMPRESSIONS:
        _refuse(259, compression, "not read (none 1, LZW 5, deflate 8 / 32946 and "
                "PackBits 32773 are)")
    fill = _one(tags, 266, 1)
    if fill != 1:
        _refuse(266, fill, "reversed bit order is not read")
    bits = _one(tags, 258, 1)
    fmt = _one(tags, 339, 1)
    photometric = _one(tags, 262, 0)
    order = "I" if e == "<" else "M"
    out_dtype = _FORMS.get((order, photometric, fmt, bits))
    if out_dtype is None:
        raise ValueError(f"BitsPerSample {bits}, SampleFormat {fmt}, "
                         f"PhotometricInterpretation {photometric} in {order * 2} byte order: "
                         "not a grey form Pillow opens")
    predictor = _one(tags, 317, 1) if compression in _PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 3 and fmt != 3):
        _refuse(317, predictor, f"not read with SampleFormat {fmt}")
    width, height = _one(tags, 256), _one(tags, 257)
    size = bits // 8
    raw = _strips(data, tags, compression, height, width * size).reshape(height, width * size)

    unsigned = np.dtype(f"u{size}")
    if predictor == 3:
        # the planes' bytes of a sample, most significant first
        planes = np.cumsum(raw, axis=1, dtype=np.uint8).reshape(height, size, width)
        be = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(unsigned.newbyteorder(">"))
        samples = be[..., 0].astype(unsigned)
    else:
        samples = raw.view(unsigned.newbyteorder(e)).astype(unsigned)
        if predictor == 2:
            samples = np.cumsum(samples, axis=1, dtype=unsigned)
    if e == ">" and compression != NONE and bits > 8 and (fmt != 1 or bits == 32):
        samples = samples.byteswap()
    if bits == 8:
        return 255 - samples if photometric == 0 else samples
    if fmt == 1:
        return samples.view(out_dtype)
    return samples.view(np.dtype(f"{'i' if fmt == 2 else 'f'}{size}")).astype(out_dtype)


def read(path: str) -> np.ndarray:
    """:func:`decode` of a file; an error names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode(data)
    except (RuntimeError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from e
