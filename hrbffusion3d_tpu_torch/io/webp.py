"""WebP decoding without an imaging library: the colour files that the JAX
package opens with Pillow (``Image.open(path).convert("RGB")`` in
``hrbffusion3d_tpu/io/tum.py`` and ``io/klg.py``), read as Pillow 12's
``WebPImagePlugin`` reads them through libwebp's animation decoder.

The container is parsed here as libwebp's demuxer parses it: ``RIFF``,
its size (the file cut to it; a shorter file is refused), ``WEBP``, then

  - a simple file: one ``VP8 `` (lossy) or ``VP8L`` (lossless) chunk, the
    canvas its size;
  - an extended file: ``VP8X`` (flags, canvas size), ``ICCP`` / ``EXIF`` /
    ``XMP `` and unknown chunks skipped, then an image (``ALPH`` +
    ``VP8 ``, or ``VP8L``) of the canvas's size, or with the animation
    flag ``ANIM`` and ``ANMF`` frames, each placed at its offset inside
    the canvas.  Every frame's chunks are checked as the demuxer checks
    them (sizes, order, bounds, headers); frame 0 alone is decoded, into a
    canvas filled with transparent black, as libwebp's animation decoder
    fills it before a key frame (frame 0 always is one, so nothing is
    blended).

Frame 0's pixels: ``VP8 `` by ``csrc/vp8_decode.cpp`` (the planes of RFC
6386, then libwebp's fancy upsampling and fixed-point YUV -> RGB), its
``ALPH`` chunk and ``VP8L`` by ``csrc/vp8l_decode.cpp``, both compiled into
the native loader's library (``io/native_loader``).  The alpha plane is
decoded even where the colour drops it, so that a corrupt ``ALPH`` chunk
raises as it makes Pillow raise.

``decode_mode`` gives Pillow's mode (``RGBA`` when ``WebPGetFeatures``
says the file has alpha: the ``VP8X`` alpha flag, a ``VP8L`` header's
alpha bit, an ``ALPH`` chunk of a still image; else ``RGB``, Pillow's
``RGBX`` raw mode) and ``np.asarray(Image.open(...))``, non-premultiplied
as Pillow decodes it; ``io/image`` takes it to colour through ``io/modes``
and refuses it as depth.  A file Pillow's test does not take, or that the
demuxer or a decoder refuses, raises ``ValueError`` naming the chunk.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np

from . import native_loader

RIFF, WEBP = b"RIFF", b"WEBP"
IMAGE_TAGS = (b"VP8 ", b"VP8L", b"VP8X")  # Pillow's _VP8_MODES_BY_IDENTIFIER
ICCP_FLAG, ALPHA_FLAG, EXIF_FLAG, XMP_FLAG, ANIMATION_FLAG = 0x20, 0x10, 0x08, 0x04, 0x02
_VALID_FLAGS = ICCP_FLAG | ALPHA_FLAG | EXIF_FLAG | XMP_FLAG | ANIMATION_FLAG
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32
_ERR_LEN = 256


def accept(data: bytes) -> bool:
    """Pillow's test: ``RIFF``, a size, ``WEBP``, then ``VP8 ``, ``VP8L`` or
    ``VP8X``."""
    return data[:4] == RIFF and data[8:12] == WEBP and data[12:16] in IMAGE_TAGS


class Chunk(NamedTuple):
    start: int    # of its header
    size: int     # its payload's, as written
    end: int      # past its padded payload, within the data


class Frame(NamedTuple):
    x: int
    y: int
    width: int
    height: int
    alpha: Chunk | None
    image: Chunk
    lossless: bool


def library():
    return native_loader.library("WebP decoders")


def _le24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _vp8_size(payload: bytes, chunk_size: int) -> tuple[int, int]:
    """libwebp's VP8GetInfo: the key frame header's size, or ValueError."""
    if len(payload) < 10:
        raise ValueError(f"VP8 chunk of {len(payload)} bytes: its frame header needs 10")
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 chunk without the key frame start code 9d 01 2a")
    bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if bits & 1:
        raise ValueError("VP8 chunk is not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        raise ValueError("VP8 chunk: profile above 3, frame not shown or first partition past "
                         "the chunk")
    w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
    if not w or not h:
        raise ValueError("VP8 chunk of zero width or height")
    return w, h


def _vp8l_size(payload: bytes) -> tuple[int, int, bool]:
    """libwebp's VP8LGetInfo: (width, height, alpha bit), or ValueError."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise ValueError("VP8L chunk without its signature 0x2f and version 0")
    bits = struct.unpack_from("<I", payload, 1)[0]
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


class _Demux:
    """libwebp's WebPDemux on a whole file: the canvas, the flags and the
    frames, or ValueError."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            raise ValueError(f"WebP file of {len(data)} bytes: truncated before its first chunk")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > _MAX_PAYLOAD:
            raise ValueError(f"RIFF size {riff_size}: not a valid WebP file")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise ValueError(f"RIFF chunk of {self.end} bytes, the file has {len(data)}: "
                             "truncated")
        self.data = data[:self.end]
        self.pos = 12
        self.frames: list[Frame] = []
        self.flags = 0
        self.extended = False
        self.alph_chunk = False
        self.canvas = (0, 0)
        tag = self.data[12:16]
        if tag == b"VP8X":
            self._vp8x()
        else:
            self._single()
            self.canvas = (self.frames[0].width, self.frames[0].height)
        self._validate()

    def _header(self) -> tuple[bytes, int, int]:
        if self.end - self.pos < 8:
            raise ValueError(f"chunk header at byte {self.pos} truncated")
        tag = self.data[self.pos:self.pos + 4]
        size = struct.unpack_from("<I", self.data, self.pos + 4)[0]
        if size > _MAX_PAYLOAD:
            raise ValueError(f"{tag!r} chunk of {size} bytes: not a valid size")
        padded = size + (size & 1)
        if padded > self.end - self.pos - 8:
            raise ValueError(f"{tag.decode('latin-1')!r} chunk of {size} bytes runs past the "
                             f"RIFF chunk's end")
        return tag, size, padded

    def _store_frame(self) -> tuple[Chunk | None, Chunk | None, int, int, bool]:
        """StoreFrame: an optional ALPH then VP8 / VP8L chunk at ``pos``."""
        alpha = image = None
        width = height = 0
        has_alpha = False
        while True:
            start = self.pos
            tag, size, padded = self._header()
            if tag == b"ALPH":
                if alpha is not None:
                    break
                alpha = Chunk(start, size, start + 8 + padded)
                has_alpha = True
            elif tag in (b"VP8 ", b"VP8L"):
                if tag == b"VP8L" and alpha is not None:
                    raise ValueError("ALPH chunk before a VP8L chunk (VP8L has its own alpha)")
                if image is not None:
                    break
                payload = self.data[start + 8:start + 8 + padded]
                if tag == b"VP8 ":
                    width, height = _vp8_size(payload, size)
                else:
                    width, height, bit = _vp8l_size(payload)
                    has_alpha |= bit
                image = Chunk(start, size, start + 8 + padded)
            else:
                break
            self.pos = start + 8 + padded
            if self.pos == self.end:
                break
            if self.end - self.pos < 8:
                raise ValueError(f"{self.end - self.pos} bytes after the {tag.decode('latin-1')!r}"
                                 " chunk: truncated")
        return alpha, image, width, height, has_alpha

    def _single(self):
        if self.frames:
            raise ValueError("a second image chunk in a still WebP file")
        alpha, image, width, height, has_alpha = self._store_frame()
        if image is None:
            raise ValueError("ALPH chunk without its VP8 chunk")
        # WebPGetFeatures counts an ALPH chunk before the image; the demuxer
        # drops alpha the flags do not announce
        self.alph_chunk = alpha is not None and alpha.start < image.start
        if not (self.flags & ALPHA_FLAG):
            alpha = None
        if not self.extended and has_alpha:
            self.flags |= ALPHA_FLAG
        self.frames.append(Frame(0, 0, width, height, alpha, image,
                                 self.data[image.start:image.start + 4] == b"VP8L"))

    def _vp8x(self):
        self.extended = True
        _, size, padded = self._header()
        if size < 10:
            raise ValueError(f"VP8X chunk of {size} bytes (10 are read)")
        body = self.data[self.pos + 8:]
        self.flags = body[0]
        self.canvas = (1 + _le24(body, 4), 1 + _le24(body, 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_AREA:
            raise ValueError(f"VP8X canvas {self.canvas[0]}x{self.canvas[1]}: too large")
        self.pos += 8 + padded
        if self.end - self.pos < 8:
            raise ValueError("VP8X file with no chunk after VP8X")
        animated = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            start = self.pos
            tag, size, padded = self._header()
            if tag == b"VP8X":
                raise ValueError("a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animated:
                    raise ValueError(f"{tag.decode('latin-1')!r} chunk outside an ANMF frame of "
                                     "an animation")
                self._single()
            elif tag == b"ANIM":
                if padded < 6:
                    raise ValueError(f"ANIM chunk of {size} bytes (6 are read)")
                anim_chunks += 1
                self.pos = start + 8 + padded
            elif tag == b"ANMF":
                if not anim_chunks:
                    raise ValueError("ANMF chunk before the ANIM chunk")
                self._anmf(start, padded)
            else:  # ICCP, EXIF, XMP and unknown chunks
                self.pos = start + 8 + padded
            if self.pos == self.end:
                break
            if self.end - self.pos < 8:
                raise ValueError(f"{self.end - self.pos} bytes after the last chunk: truncated")

    def _anmf(self, start: int, padded: int):
        if padded < 16:
            raise ValueError(f"ANMF chunk of {padded} bytes (16 are read)")
        b = self.data[start + 8:start + 24]
        x, y = 2 * _le24(b, 0), 2 * _le24(b, 3)
        width, height = 1 + _le24(b, 6), 1 + _le24(b, 9)
        if width * height >= _MAX_AREA:
            raise ValueError(f"ANMF frame {width}x{height}: too large")
        self.pos = start + 24
        payload = padded - 16
        if self.end - self.pos < 8 or self.end - self.pos < payload:
            raise ValueError("ANMF frame's chunks truncated")
        alpha, image, width, height, _ = self._store_frame()
        if self.pos - (start + 24) > payload:
            raise ValueError("ANMF frame's chunks run past the ANMF chunk")
        if (alpha is None and image is None) or not self.flags & ANIMATION_FLAG:
            return
        if image is None:
            raise ValueError("ANMF frame with an ALPH chunk and no VP8 chunk")
        self.frames.append(Frame(x, y, width, height, alpha, image,
                                 self.data[image.start:image.start + 4] == b"VP8L"))

    def _validate(self):
        cw, ch = self.canvas
        if not self.frames:
            raise ValueError("WebP file without an image")
        if self.flags & ~_VALID_FLAGS:
            raise ValueError(f"VP8X flags 0x{self.flags:02x}: reserved bits set")
        animated = bool(self.flags & ANIMATION_FLAG)
        for i, f in enumerate(self.frames):
            if f.alpha is not None and f.alpha.start > f.image.start:
                raise ValueError(f"frame {i}: ALPH after its image chunk")
            if animated:
                if f.x + f.width > cw or f.y + f.height > ch:
                    raise ValueError(f"frame {i} of {f.width}x{f.height} at ({f.x}, {f.y}) "
                                     f"outside the {cw}x{ch} canvas")
            elif (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
                raise ValueError(f"image of {f.width}x{f.height}, the VP8X canvas is {cw}x{ch}")


def _has_alpha(dmx: _Demux) -> bool:
    """libwebp's WebPGetFeatures(...).has_alpha on the whole file, which
    gives Pillow's mode."""
    if not dmx.extended:
        f = dmx.frames[0]
        return f.lossless and _vp8l_size(dmx.data[f.image.start + 8:f.image.end])[2]
    if dmx.flags & ANIMATION_FLAG:
        return bool(dmx.flags & ALPHA_FLAG)
    f = dmx.frames[0]
    if f.lossless:
        return _vp8l_size(dmx.data[f.image.start + 8:f.image.end])[2]
    return bool(dmx.flags & ALPHA_FLAG) or dmx.alph_chunk


def _err():
    return ctypes.create_string_buffer(_ERR_LEN)


def decode_yuv(payload: bytes, width: int,
               height: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Y, U and V planes of a ``VP8 `` chunk's payload (RFC 6386)."""
    lib = library()
    y = np.empty((height, width), np.uint8)
    u = np.empty(((height + 1) // 2, (width + 1) // 2), np.uint8)
    v = np.empty_like(u)
    err = _err()
    p = ctypes.POINTER(ctypes.c_uint8)
    if lib.vp8_decode_yuv(payload, len(payload), width, height, y.ctypes.data_as(p),
                          u.ctypes.data_as(p), v.ctypes.data_as(p), err, _ERR_LEN) != 0:
        raise ValueError(f"VP8 chunk: {err.value.decode()}")
    return y, u, v


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampling and YUV -> RGB of decoded planes."""
    h, w = y.shape
    rgb = np.empty((h, w, 3), np.uint8)
    p = ctypes.POINTER(ctypes.c_uint8)
    library().vp8_yuv_to_rgb(np.ascontiguousarray(y).ctypes.data_as(p),
                             np.ascontiguousarray(u).ctypes.data_as(p),
                             np.ascontiguousarray(v).ctypes.data_as(p), w, h, rgb.ctypes.data_as(p))
    return rgb


def decode_vp8l(payload: bytes, stats: np.ndarray | None = None) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a ``VP8L`` chunk's payload; ``stats`` (5
    int32) gets the transforms present, the colour cache and meta prefix
    bits, the backward references and the cache hits."""
    width, height, _ = _vp8l_size(payload)
    rgba = np.empty((height, width, 4), np.uint8)
    err = _err()
    ip = ctypes.POINTER(ctypes.c_int)
    if library().vp8l_decode(payload, len(payload), width, height,
                             rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             stats.ctypes.data_as(ip) if stats is not None else None,
                             err, _ERR_LEN) != 0:
        raise ValueError(f"VP8L chunk: {err.value.decode()}")
    return rgba


def decode_alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """(H, W) uint8 of an ``ALPH`` chunk's payload for a frame of that
    size."""
    alpha = np.empty((height, width), np.uint8)
    err = _err()
    if library().webp_alpha_decode(payload, len(payload), width, height,
                                   alpha.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                   err, _ERR_LEN) != 0:
        raise ValueError(f"ALPH chunk: {err.value.decode()}")
    return alpha


def _frame(dmx: _Demux, f: Frame) -> tuple[np.ndarray, np.ndarray | None]:
    """Frame ``f``'s (RGB or RGBA, its alpha plane or None)."""
    data = dmx.data
    # the decoder reads from the image chunk's payload to the frame's end
    payload = data[f.image.start + 8:f.image.end]
    if f.lossless:
        return decode_vp8l(payload), None
    rgb = yuv_to_rgb(*decode_yuv(payload, f.width, f.height))
    if f.alpha is None:
        return rgb, None
    return rgb, decode_alpha(data[f.alpha.start + 8:f.alpha.start + 8 + f.alpha.size],
                             f.width, f.height)


def planes(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The Y, U and V planes of frame 0 of a lossy WebP file."""
    if not accept(data):
        raise ValueError(f"not a WebP file (it starts with {bytes(data[:16])!r})")
    dmx = _Demux(data)
    f = dmx.frames[0]
    if f.lossless:
        raise ValueError("frame 0 is lossless (VP8L): it has no Y, U and V planes")
    return decode_yuv(dmx.data[f.image.start + 8:f.image.end], f.width, f.height)


def decode_mode(data: bytes) -> tuple[str, np.ndarray, None]:
    """(Pillow's mode, ``np.asarray(Image.open(...))``, no palette) of a
    WebP file's bytes: frame 0 on its canvas."""
    if not accept(data):
        raise ValueError(f"not a WebP file Pillow takes (it starts with {bytes(data[:16])!r})")
    dmx = _Demux(data)
    f = dmx.frames[0]
    pixels, alpha = _frame(dmx, f)
    bands = 4 if _has_alpha(dmx) else 3
    cw, ch = dmx.canvas
    if (f.x, f.y, f.width, f.height) == (0, 0, cw, ch) and pixels.shape[2] == bands:
        if alpha is None:
            return ("RGBA" if bands == 4 else "RGB"), pixels, None
    # frame 0 on a canvas of transparent black; an opaque lossy frame's alpha 255
    canvas = np.zeros((ch, cw, bands), np.uint8)
    window = canvas[f.y:f.y + f.height, f.x:f.x + f.width]
    window[..., :3] = pixels[..., :3]
    if bands == 4:
        window[..., 3] = pixels[..., 3] if pixels.shape[2] == 4 else 255 if alpha is None else alpha
    return ("RGBA" if bands == 4 else "RGB"), canvas, None
