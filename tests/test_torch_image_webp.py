"""WebP without Pillow: the port's ``io/webp`` (``csrc/vp8_decode.cpp``,
``csrc/vp8l_decode.cpp``) through ``io/image`` against Pillow 12.1
(``Image.open(...).convert("RGB")`` and ``np.asarray(Image.open(...))``,
what the JAX package's TUM and ``.klg`` readers call) and against the
libwebp it bundles (``WebPDecodeYUV``), bit for bit:

- the VP8 tables (by sha256) and the VP8L distance map (against RFC 9649's
  list);
- lossy files from Pillow's writer (qualities 0-100, methods 0-6) and from
  libwebp's ``WebPEncode`` (the simple and no loop filter, 1-8 token
  partitions, 1-4 segments, sharpness 0-7), odd widths and heights: the Y,
  U and V planes equal libwebp's, the RGB Pillow's;
- lossless files (methods 0-6, exact alpha, palettes of 1-256 colours),
  alpha (``ALPH`` compressed and raw, filters 0-3, pre-processing),
  extended files (ICC, EXIF, XMP, unknown chunks), animations (frame 0 at
  an offset, lossless, with alpha);
- ``image.form`` in Pillow's plugin order; refusals and corrupt or
  truncated files (Pillow fails too), each naming the file and the chunk;
  a WebP read as depth, refused naming its mode; the departure: an
  ``ALPH`` stream cut inside its last code, which libwebp reads;
- a ``.klg`` with WebP colour through ``io/klg.frames`` against the JAX
  reader, and the native loader naming the form;
- the committed fixture ``tests/data/webp_gif`` to its digests.

Encoders: Pillow's writer and ``tests/torch_webp_encoder.py`` (libwebp
through ``ctypes``, and the container by hand); every seeded case at
72x56 or smaller.
"""

import hashlib
import io
import json
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch_webp_encoder as enc
from PIL import Image

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu_torch.io import image, klg, native_loader, webp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "webp_gif")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _img(h: int, w: int, seed: int, noise: float = 12.0, channels: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed * 1000 + h * w)
    y, x = np.mgrid[0:h, 0:w]
    base = [40 + 150 * x / w, 30 + 180 * y / h, 128 + 90 * np.sin((x + 2 * y) / 6.0),
            200 - 120 * x * y / (w * h)][:channels]
    c = np.stack(base, -1) + rng.normal(0, noise, (h, w, channels))
    return np.clip(np.round(c), 0, 255).astype(np.uint8)


def _save(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _pillow(data: bytes):
    """(mode, np.asarray, convert("RGB")) of Pillow, or None when it fails."""
    try:
        im = Image.open(io.BytesIO(data))
        return im.mode, np.asarray(im), np.asarray(im.convert("RGB"))
    except Exception:                      # noqa: BLE001 - any refusal of Pillow's
        return None


def _same(data: bytes) -> np.ndarray:
    """The port equals Pillow: the mode, the array and the RGB."""
    ref = _pillow(data)
    assert ref is not None
    mode, arr, _ = image._decode_mode(data)
    rgb = image.decode_colour(data)
    assert mode == ref[0]
    assert arr.shape == ref[1].shape and arr.tobytes() == ref[1].tobytes()
    assert rgb.shape == ref[2].shape and rgb.tobytes() == ref[2].tobytes()
    return rgb


def _planes_equal(data: bytes):
    """Frame 0's Y, U and V planes equal libwebp's, and the RGB Pillow's."""
    vp8 = dict(enc.chunks(data))[b"VP8 "]
    ref = enc.yuv_planes(enc.riff(enc.chunk(b"VP8 ", vp8)))
    got = webp.planes(data)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    _same(data)


def _refused(tmp_path, name: str, data: bytes, depth: bool = False) -> str:
    """Pillow fails on the file, and the port raises naming it."""
    assert _pillow(data) is None
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        (image.read_depth if depth else image.read_colour)(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


# ------------------------------------------------------------------ tables

def _c_array(path: str, name: str) -> list[int]:
    with open(os.path.join(ROOT, "hrbffusion3d_tpu_torch", "csrc", path)) as f:
        text = f.read()
    body = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", text, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\d+", body)]


# sha256 of each table's entries as bytes (kAcTable as little-endian uint16)
TABLES = {
    "kCoeffsProba0": ("uint8", 1056,
                      "3234d2f1df76ac054b3882e1ab968e0bcfbce29ffcf349e37c843500ef80767e"),
    "kCoeffsUpdateProba": ("uint8", 1056,
                           "81d127cba3750eddd8b9dac7aecfc59683aa1d0f7b141c315930d8efbf20b48a"),
    "kBModesProba": ("uint8", 900,
                     "68785529cec883c961cea2654617f61c796675c1afa8a739a4f5a01ed8d842c0"),
    "kDcTable": ("uint8", 128, "3c3cc3738bfe0d808e905b1f6182e764fa6015dcadd69a49fac6069de1081217"),
    "kAcTable": ("<u2", 128, "b9385c98aac9ee9399e89efe12dbe83251821c2afb3ef5c7c93b4540c3943292"),
    "kZigzag": ("uint8", 16, "96e7d520fa7466b3721d23a8a150f9ebc6447a3e48a09a7ab28c44e5ee1a8ead"),
    "kBands": ("uint8", 17, "5f5ea769465a9826b839870cef6c72e85f99a5f33b9853489beadb24b0e242d1"),
}
# RFC 9649 section 4.2.2: the distance map's (dx, dy), in code order
RFC_DISTANCE_MAP = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2),
    (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2),
    (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1),
    (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6),
    (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5),
    (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5),
    (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7),
    (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7)]


@pytest.mark.parametrize("name", list(TABLES))
def test_vp8_tables(name):
    dtype, n, digest = TABLES[name]
    values = _c_array("vp8_tables.h", name)
    assert len(values) == n
    assert hashlib.sha256(np.array(values, dtype).tobytes()).hexdigest() == digest


def test_vp8l_distance_map():
    assert _c_array("vp8l_decode.cpp", "kCodeToPlane") == [
        (dy << 4) | (8 - dx) for dx, dy in RFC_DISTANCE_MAP]


# ------------------------------------------------------------------ lossy

@pytest.mark.parametrize("quality,method", [(0, 0), (5, 2), (50, 4), (80, 4), (95, 5), (100, 6)])
def test_lossy_pillow_writer(quality, method):
    for h, w in ((1, 1), (1, 17), (17, 1), (16, 16), (33, 47), (56, 72)):
        for noise in (2.0, 40.0):
            data = _save(_img(h, w, quality + method, noise), quality=quality, method=method)
            _planes_equal(data)


@pytest.mark.parametrize("fields", [
    dict(filter_type=0), dict(filter_type=0, filter_sharpness=4),
    dict(filter_strength=0, partitions=3, low_memory=1), dict(partitions=1, low_memory=1),
    dict(partitions=2, low_memory=1, filter_type=0), dict(segments=1, filter_sharpness=7),
    dict(segments=2, sns_strength=100), dict(segments=3, filter_strength=100),
    dict(filter_sharpness=5, filter_strength=30), dict(sns_strength=0, quality=30.0),
    dict(quality=0.0, filter_strength=100, filter_type=0), dict(quality=100.0, method=0)],
    ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()))
def test_lossy_encoder_settings(fields):
    fields = dict(fields)
    quality = fields.pop("quality", 75.0)
    for h, w in ((9, 13), (31, 50), (56, 72)):
        data = enc.encode_lossy(_img(h, w, len(fields)), quality, **fields)
        info = np.zeros(9, np.int32)
        vp8 = dict(enc.chunks(data))[b"VP8 "]
        assert webp.library().vp8_frame_info(vp8, len(vp8), info.ctypes.data_as(
            webp.ctypes.POINTER(webp.ctypes.c_int)), None, 0) == 0
        assert tuple(info[:2]) == (w, h)
        if fields.get("filter_strength") == 0:
            assert info[2] == 0
        elif "filter_type" in fields:
            assert info[2] == 1
        if "partitions" in fields:
            assert info[5] == 1 << fields["partitions"]
        if "filter_sharpness" in fields and info[2]:
            assert info[4] == fields["filter_sharpness"]
        _planes_equal(data)


def test_lossy_planes_and_rgb_stages():
    """The two stages apart: the planes of a known file, then libwebp's
    upsampler on planes made up here (every edge rule: first and last row
    and column at odd and even sizes)."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (1, 2), (2, 1), (2, 2), (3, 5), (4, 6), (7, 9)):
        data = _save(_img(h, w, 7, 30.0), quality=90)
        y, u, v = webp.planes(data)
        assert webp.yuv_to_rgb(y, u, v).tobytes() == _pillow(data)[2].tobytes()
        y2 = rng.integers(0, 256, y.shape, dtype=np.uint8)
        u2 = rng.integers(0, 256, u.shape, dtype=np.uint8)
        v2 = rng.integers(0, 256, v.shape, dtype=np.uint8)
        assert webp.yuv_to_rgb(y2, u2, v2).shape == (h, w, 3)


# ------------------------------------------------------------------ lossless, alpha

@pytest.mark.parametrize("method", range(7))
def test_lossless(method):
    rng = np.random.default_rng(method)
    for h, w in ((1, 1), (3, 70), (41, 29), (56, 72)):
        for kind in range(4):
            if kind == 0:
                img = _img(h, w, method, 3.0, channels=4)
            elif kind == 1:
                pal = rng.integers(0, 256, (int(rng.choice([1, 2, 3, 4, 5, 16, 17, 256])), 4),
                                   dtype=np.uint8)
                img = pal[rng.integers(0, len(pal), (h, w))]
            elif kind == 2:
                img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            else:
                img = np.repeat(np.repeat(_img((h + 3) // 4, (w + 3) // 4, kind, 20.0, 4), 4, 0),
                                4, 1)[:h, :w]
            for alpha in (True, False):
                im = img if alpha else np.ascontiguousarray(img[..., :3])
                _same(_save(im, lossless=True, method=method, exact=True,
                            quality=int(rng.choice([0, 50, 100]))))


def test_lossless_transforms_in_play():
    """The fixture's method-6 frame takes the predictor, cross-colour and
    subtract-green transforms, the colour cache and backward references;
    palettes of 2, 4 and 16 colours bundle 8, 4 and 2 pixels a byte."""
    stats = np.zeros(5, np.int32)
    with open(os.path.join(FIXTURE, "007_webp_lossless_m6.webp"), "rb") as f:
        data = f.read()
    webp.decode_vp8l(dict(enc.chunks(data))[b"VP8L"], stats)
    assert stats[0] & 7 == 7 and stats[1] > 0 and stats[3] > 0 and stats[4] > 0
    rng = np.random.default_rng(0)
    for n in (2, 4, 16):
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        data = _save(pal[rng.integers(0, n, (37, 61))], lossless=True)
        webp.decode_vp8l(dict(enc.chunks(data))[b"VP8L"], stats)
        assert stats[0] & 8
        _same(data)


@pytest.mark.parametrize("alpha_quality", [100, 60, 10])
def test_lossy_with_alpha(alpha_quality):
    for h, w in ((1, 1), (5, 3), (30, 41), (56, 72)):
        img = _img(h, w, alpha_quality, 10.0, channels=4)
        for method in (0, 4, 6):
            data = _save(img, quality=70, method=method, alpha_quality=alpha_quality)
            assert dict(enc.chunks(data)).get(b"ALPH") is not None
            _planes_equal(data)


@pytest.mark.parametrize("filt", range(4))
def test_raw_alpha_filters(filt):
    """An ``ALPH`` chunk of compression 0 under each filter, and with the
    pre-processing bit, as libwebp unfilters it."""
    for h, w in ((1, 1), (1, 9), (9, 1), (23, 37)):
        rgb = _img(h, w, filt)
        alpha = np.random.default_rng(filt).integers(0, 256, (h, w), dtype=np.uint8)
        vp8 = dict(enc.chunks(enc.encode_lossy(rgb)))[b"VP8 "]
        for pre in (0, 1):
            alph = enc.alph_raw(alpha, filt)
            alph = bytes([alph[0] | pre << 4]) + alph[1:]
            data = enc.riff(enc.vp8x(w, h, enc.ALPHA), enc.chunk(b"ALPH", alph),
                            enc.chunk(b"VP8 ", vp8))
            rgba = _same(data) is not None and image._decode_mode(data)[1]
            assert rgba[..., 3].tobytes() == alpha.tobytes()


# ------------------------------------------------------------------ container

def test_extended_and_unknown_chunks():
    rgb = _img(21, 34, 5)
    vp8 = dict(enc.chunks(_save(rgb)))[b"VP8 "]
    vp8l = dict(enc.chunks(_save(rgb, lossless=True)))[b"VP8L"]
    for img_chunk in (enc.chunk(b"VP8 ", vp8), enc.chunk(b"VP8L", vp8l)):
        for flags, extra in ((enc.ICCP, enc.chunk(b"ICCP", b"icc!x")),
                             (enc.EXIF | enc.XMP, enc.chunk(b"EXIF", b"Exif\0\0") +
                              enc.chunk(b"XMP ", b"<x/>")),
                             (0, enc.chunk(b"ABCD", b"odd")), (enc.ALPHA, b"")):
            _same(enc.riff(enc.vp8x(34, 21, flags), extra, img_chunk))
            _same(enc.riff(enc.vp8x(34, 21, flags), img_chunk, extra))
        # bytes after the RIFF chunk are not read; a chunk after a simple image is skipped
        _same(enc.riff(img_chunk) + b"trailing")
        _same(enc.riff(img_chunk, enc.chunk(b"XYZW", b"12")))
    _same(_save(rgb, icc_profile=b"p" * 33, exif=b"Exif\0\0MM", xmp=b"<xmp/>"))
    # an ALPH chunk the flags do not announce: Pillow's mode RGBA
    # (WebPGetFeatures sees the chunk), the alpha 255 (the demuxer drops it)
    alph = enc.chunk(b"ALPH", enc.alph_raw(rgb[..., 0], 0))
    data = enc.riff(enc.vp8x(34, 21, 0), alph, enc.chunk(b"VP8 ", vp8))
    assert _pillow(data)[0] == "RGBA" and (_same(data) is not None)
    assert (image._decode_mode(data)[1][..., 3] == 255).all()


def test_animation_frame_0():
    """Frame 0 of an animation on a canvas filled with transparent black:
    at an offset, lossy with and without alpha, lossless; Pillow's own
    animations."""
    small, big = _img(10, 12, 1), _img(20, 30, 2)
    vp8_small = enc.chunk(b"VP8 ", dict(enc.chunks(_save(small)))[b"VP8 "])
    vp8_big = enc.chunk(b"VP8 ", dict(enc.chunks(_save(big)))[b"VP8 "])
    vp8l = enc.chunk(b"VP8L", dict(enc.chunks(_save(_img(10, 12, 3, channels=4), lossless=True,
                                                    exact=True)))[b"VP8L"])
    alph = enc.chunk(b"ALPH", enc.alph_raw(_img(10, 12, 4)[..., 0], 2))
    second = enc.anmf(0, 0, 30, 20, vp8_big)
    for flags, frame0 in ((enc.ANIMATION, vp8_small), (enc.ANIMATION | enc.ALPHA, alph + vp8_small),
                          (enc.ANIMATION | enc.ALPHA, vp8l), (enc.ANIMATION, vp8l)):
        for x, y in ((0, 0), (4, 6), (18, 10)):
            data = enc.riff(enc.vp8x(30, 20, flags), enc.anim(0xff102030),
                            enc.anmf(x, y, 12, 10, frame0), second)
            rgb = _same(data)
            assert not rgb[:y].any() and not rgb[:, :x].any()
    frames = [Image.fromarray(_img(17, 23, k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=40)
    _same(buf.getvalue())
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], lossless=True)
    _same(buf.getvalue())


def test_form_in_pillows_plugin_order():
    """``image.form`` names what ``Image.open`` would open the bytes as:
    WebP is tried after the first plugins and TIFF, in ``Image.ID``'s
    order."""
    Image.init()
    ids = list(Image.ID)
    assert ids.index("GIF") < ids.index("JPEG") and ids.index("DIB") < ids.index("GIF")
    assert ids.index("TIFF") < ids.index("WEBP")
    data = _save(_img(8, 8, 0))
    assert image.form(data) == Image.open(io.BytesIO(data)).format == "WEBP"
    assert image.form(b"RIFF\0\0\0\0WEBPVP8Z" + bytes(16)) is None
    assert image.form(b"RIFF\0\0\0\0WAVEfmt " + bytes(16)) is None
    assert image.needs_library(data[:64])


# ------------------------------------------------------------------ refusals

def _patched(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def test_refusals(tmp_path):
    """Files Pillow cannot open: the port raises, naming the file and the
    chunk or field; a WebP read as depth names its mode."""
    rgb = _img(30, 41, 9)
    lossy = _save(rgb)
    vp8 = dict(enc.chunks(lossy))[b"VP8 "]
    vp8l = dict(enc.chunks(_save(rgb, lossless=True)))[b"VP8L"]
    alpha = _save(_img(30, 41, 9, channels=4))
    assert "truncated" in _refused(tmp_path, "cut.webp", lossy[:len(lossy) // 2])
    assert "RIFF size" in _refused(tmp_path, "size.webp", _patched(lossy, 4, b"\3\0\0\0"))
    assert "VP8 " in _refused(tmp_path, "vp8cut.webp",
                              enc.riff(enc.chunk(b"VP8 ", vp8[:len(vp8) // 3])))
    assert "start code" in _refused(tmp_path, "code.webp", enc.riff(enc.chunk(
        b"VP8 ", _patched(vp8, 3, b"\0"))))
    assert "VP8X flags" in _refused(tmp_path, "flags.webp", enc.riff(
        enc.vp8x(41, 30, 0x80), enc.chunk(b"VP8 ", vp8)))
    assert "canvas" in _refused(tmp_path, "canvas.webp", enc.riff(
        enc.vp8x(40, 30, 0), enc.chunk(b"VP8 ", vp8)))
    assert "VP8X" in _refused(tmp_path, "twice.webp", enc.riff(
        enc.vp8x(41, 30, 0), enc.vp8x(41, 30, 0), enc.chunk(b"VP8 ", vp8)))
    assert "VP8L" in _refused(tmp_path, "vp8l.webp", enc.riff(enc.chunk(
        b"VP8L", vp8l[:5] + bytes(len(vp8l) - 5))))
    assert "VP8L" in _refused(tmp_path, "vp8lcut.webp", enc.riff(enc.chunk(
        b"VP8L", vp8l[:len(vp8l) // 2])))
    alph = dict(enc.chunks(alpha))[b"ALPH"]
    assert "ALPH" in _refused(tmp_path, "alph.webp", enc.riff(
        enc.vp8x(41, 30, enc.ALPHA), enc.chunk(b"ALPH", b"\xc1" + alph[1:]),
        enc.chunk(b"VP8 ", dict(enc.chunks(alpha))[b"VP8 "])))
    assert "ALPH" in _refused(tmp_path, "alphcut.webp", enc.riff(
        enc.vp8x(41, 30, enc.ALPHA), enc.chunk(b"ALPH", alph[:len(alph) // 2]),
        enc.chunk(b"VP8 ", dict(enc.chunks(alpha))[b"VP8 "])))
    assert "ALPH" in _refused(tmp_path, "rawcut.webp", enc.riff(
        enc.vp8x(41, 30, enc.ALPHA), enc.chunk(b"ALPH", b"\0" + bytes(100)),
        enc.chunk(b"VP8 ", vp8)))
    assert "outside" in _refused(tmp_path, "frame.webp", enc.riff(
        enc.vp8x(40, 30, enc.ANIMATION), enc.anim(),
        enc.anmf(2, 0, 41, 30, enc.chunk(b"VP8 ", vp8))))
    assert "ANIM" in _refused(tmp_path, "anmf.webp", enc.riff(
        enc.vp8x(41, 30, enc.ANIMATION), enc.anmf(0, 0, 41, 30, enc.chunk(b"VP8 ", vp8))))
    assert "animation" in _refused(tmp_path, "still.webp", enc.riff(
        enc.vp8x(41, 30, enc.ANIMATION), enc.anim(), enc.chunk(b"VP8 ", vp8)))
    # the token partitions of a VP8 chunk cut short; an odd VP8X size
    assert "VP8" in _refused(tmp_path, "tokens.webp", enc.riff(
        enc.chunk(b"VP8 ", vp8[:-40])))
    assert "VP8X" in _refused(tmp_path, "vp8x.webp", enc.riff(
        enc.chunk(b"VP8X", bytes(8)), enc.chunk(b"VP8 ", vp8)))
    # depth: a WebP has three or four bands
    assert "mode RGB" in _refused_depth(tmp_path, "depth.webp", lossy)
    assert "mode RGBA" in _refused_depth(tmp_path, "depth_alpha.webp", alpha)


def test_departure_alpha_stream_cut_in_its_last_code(tmp_path):
    """An ``ALPH`` stream (VP8L, colour indexing only) cut inside its last
    prefix code: libwebp's 8-bit alpha path stops once the pixels are
    full and returns an image, the last pixels' alpha taken from bits past
    the end (a departure, ``ROADMAP.md`` Queue 3); the port raises, naming
    the chunk."""
    rng = np.random.default_rng(0)
    h, w = 25, 19
    levels = rng.integers(0, 256, 4)
    alpha = levels[rng.integers(0, 4, (h, w))].astype(np.uint8)
    ch = dict(enc.chunks(_save(np.dstack([_img(h, w, 0), alpha]))))
    alph = ch[b"ALPH"]
    assert alph[0] & 3 == 1
    data = enc.riff(enc.vp8x(w, h, enc.ALPHA), enc.chunk(b"ALPH", alph[:-1]),
                    enc.chunk(b"VP8 ", ch[b"VP8 "]))
    assert _pillow(data) is not None
    path = tmp_path / "alpha_cut.webp"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"alpha_cut.webp: ALPH chunk: .*the data ends at pixel"):
        image.read_colour(str(path))


def _refused_depth(tmp_path, name: str, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    assert _pillow(data) is not None
    with pytest.raises(ValueError) as e:
        image.read_depth(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


# ------------------------------------------------------------------ .klg

def test_klg_webp_payloads_match_jax(tmp_path):
    h, w = 24, 32
    payloads = [_save(_img(h, w, 0)), _save(_img(h, w, 1), lossless=True),
                _save(_img(h, w, 2, channels=4), quality=60)]
    d16 = np.full((h, w), 1234, np.uint16)
    path = tmp_path / "f.klg"
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(payloads)))
        for i, ibuf in enumerate(payloads):
            dbuf = zlib.compress(d16.tobytes())
            f.write(struct.pack("<qii", i, len(dbuf), len(ibuf)) + dbuf + ibuf)
    ref = list(jklg.frames(str(path), w, h))
    got = list(klg.frames(str(path), w, h))
    assert len(got) == len(ref) == len(payloads)
    for a, b in zip(got, ref):
        assert a.rgb.tobytes() == b.rgb.tobytes() and a.depth.tobytes() == b.depth.tobytes()
    with pytest.raises(RuntimeError, match=r"frame 0: WebP colour payload: this loader decodes "
                                           r"JPEG colour only \(io/klg.frames reads WebP"):
        list(native_loader.frames(str(path), w, h))


# ------------------------------------------------------------------ fixture

with open(os.path.join(FIXTURE, "digests.json")) as _f:
    FIXTURE_ENTRIES = [e for e in json.load(_f)["frames"] if e["file"].endswith(".webp")]


@pytest.mark.parametrize("entry", FIXTURE_ENTRIES, ids=lambda e: e["file"])
def test_fixture_digests(entry):
    """The WebP files of the fixture (``chip_smoke`` run_tum (m)): Pillow
    and the port each decode every file to its digest, and libwebp's and
    the port's planes of frame 0 to theirs."""
    with open(os.path.join(FIXTURE, entry["file"]), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"]
    ref = _pillow(data)
    assert ref[0] == entry["mode"] == image._decode_mode(data)[0]
    for a in (ref[2], image.decode_colour(data)):
        assert _sha(a) == entry["rgb_sha256"]
    if "yuv_sha256" in entry:
        assert [_sha(p) for p in webp.planes(data)] == entry["yuv_sha256"]
