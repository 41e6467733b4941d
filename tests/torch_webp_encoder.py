"""WebP files that Pillow's writer cannot make, for the tests of the port's
WebP reader (``hrbffusion3d_tpu_torch/io/webp.py``) and for
``scripts/make_webp_gif_fixture.py``.

- ``encode_lossy``: a lossy ``VP8 `` file from the libwebp that Pillow
  bundles, through ``ctypes``, with any ``WebPConfig`` field set (the simple
  loop filter, no loop filter, 2-8 token partitions, one segment, any
  sharpness), which Pillow's ``save`` does not pass on; ``yuv_planes``:
  libwebp's own Y, U and V planes of a file (``WebPDecodeYUV``).
- ``chunk`` / ``riff`` / ``vp8x`` / ``anim`` / ``anmf`` / ``alph_raw``: the
  RIFF container written by hand, for extended files, animations, raw
  (uncompressed) alpha planes with any filter, and corrupt containers.

Needs Pillow (its wheel's ``pillow.libs``) and nothing else.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np
import PIL

_LIBS = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
_ABI = 0x0210  # WEBP_ENCODER_ABI_VERSION / WEBP_DECODER_ABI_VERSION: major 2


def _lib():
    for pre in ("libsharpyuv", "libwebp-"):
        path = next(_LIBS.glob(f"{pre}*.so*"))
        lib = ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
    return lib


class WebPConfig(ctypes.Structure):
    """libwebp 1.x ``struct WebPConfig`` (encode.h), field for field."""
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in ("lossless", "quality", "method", "image_hint", "target_size",
                             "target_PSNR", "segments", "sns_strength", "filter_strength",
                             "filter_sharpness", "filter_type", "autofilter",
                             "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
                             "show_compressed", "preprocessing", "partitions",
                             "partition_limit", "emulate_jpeg_size", "thread_level",
                             "low_memory", "near_lossless", "exact", "use_delta_palette",
                             "use_sharp_yuv", "qmin", "qmax")]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


class WebPPicture(ctypes.Structure):
    """libwebp 1.x ``struct WebPPicture`` (encode.h), field for field."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


def encode_lossy(rgb: np.ndarray, quality: float = 80.0, **fields) -> bytes:
    """A WebP file of ``rgb`` ((H, W, 3) uint8) from libwebp's
    ``WebPEncode``, its ``WebPConfig`` at the default preset with ``fields``
    set (checked by ``WebPValidateConfig``)."""
    lib = _lib()
    cfg = WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), _ABI):
        raise RuntimeError("WebPConfigInitInternal failed")
    for name, value in fields.items():
        if name not in dict(WebPConfig._fields_):
            raise KeyError(name)
        setattr(cfg, name, value)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"WebPValidateConfig refuses {fields}")
    pic = WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI):
        raise RuntimeError("WebPPictureInitInternal failed")
    h, w = rgb.shape[:2]
    pic.width, pic.height = w, h
    src = np.ascontiguousarray(rgb, np.uint8)
    if not lib.WebPPictureImportRGB(ctypes.byref(pic), src.ctypes.data_as(ctypes.c_void_p), 3 * w):
        raise RuntimeError("WebPPictureImport failed")
    writer = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
    try:
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def yuv_planes(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libwebp's Y, U and V planes of a lossy WebP file (``WebPDecodeYUV``)."""
    lib = _lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.WebPDecodeYUV.restype = u8p
    w, h, ys, uvs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    u, v = u8p(), u8p()
    y = lib.WebPDecodeYUV(data, ctypes.c_size_t(len(data)), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(u), ctypes.byref(v), ctypes.byref(ys), ctypes.byref(uvs))
    if not y:
        raise ValueError("WebPDecodeYUV failed")
    try:
        cw, ch = (w.value + 1) // 2, (h.value + 1) // 2

        def plane(ptr, rows, cols, stride):
            flat = np.ctypeslib.as_array(ptr, ((rows - 1) * stride + cols,))
            return np.lib.stride_tricks.as_strided(flat, (rows, cols), (stride, 1)).copy()

        return plane(y, h.value, w.value, ys.value), plane(u, ch, cw, uvs.value), \
            plane(v, ch, cw, uvs.value)
    finally:
        lib.WebPFree(ctypes.cast(y, ctypes.c_void_p))


def chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, its payload padded to an even length."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The top-level chunks of a WebP file: (tag, payload)."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


ICCP, ALPHA, EXIF, XMP, ANIMATION = 0x20, 0x10, 0x08, 0x04, 0x02


def vp8x(width: int, height: int, flags: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def anim(background: int = 0, loops: int = 0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", background, loops))


def anmf(x: int, y: int, width: int, height: int, frame: bytes, duration: int = 100,
         flags: int = 0) -> bytes:
    """An animation frame at (``x``, ``y``) (even offsets) holding the
    chunks ``frame`` (``ALPH`` + ``VP8 ``, or ``VP8L``)."""
    head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") \
        + (width - 1).to_bytes(3, "little") + (height - 1).to_bytes(3, "little") \
        + duration.to_bytes(3, "little") + bytes([flags])
    return chunk(b"ANMF", head + frame)


def alph_raw(alpha: np.ndarray, filt: int) -> bytes:
    """An uncompressed ``ALPH`` payload of ``alpha`` (H, W) uint8 under
    filter ``filt`` (0 none, 1 horizontal, 2 vertical, 3 gradient), filtered
    as libwebp's encoder filters (``dsp/filters.c``)."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if filt == 1:
        pred[:, 1:] = a[:, :-1]
        pred[1:, 0] = a[:-1, 0]
    elif filt == 2:
        pred[0, 1:] = a[0, :-1]
        pred[1:] = a[:-1]
    elif filt == 3:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return bytes([filt << 2]) + ((a - pred) & 255).astype(np.uint8).tobytes()
