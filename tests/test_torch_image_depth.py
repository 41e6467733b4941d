"""Depth images in PGM and TIFF without Pillow: the port's ``io/pnm`` and
``io/tiff`` against Pillow 12 (``np.asarray(Image.open(...))``, which the
JAX package's TUM reader calls), and the port's ``tum.load_frame`` against
JAX's, bit for bit.

Every form runs on a seeded 64x48 and a 640x480 depth frame holding zeros
and values near 65535:

  - PGM: binary ``P5`` at maxval 1, 2, 255, 256, 1023, 4095, 65534 and
    65535 (Pillow rescales every maxval but 255 and 65535, and clips
    binary samples above maxval), plain ``P2`` at 1, 255, 4095 and 65535,
    with comments and mixed whitespace in header and data;
  - TIFF written by Pillow (none, LZW, LZW and deflate with predictor 2,
    PackBits) and by ``torch_tiff_encoder`` (what Pillow cannot write:
    both byte orders, deflate as 8 and 32946, old-style LZW, predictor 2
    with no compression, where it is ignored, a few rows a strip) of
    16-bit unsigned samples, and 8-bit (black 0 and 1), 16-bit signed,
    32-bit signed and unsigned and float samples (predictor 3).

Each decoder's dtype (byte order aside) and values equal Pillow's; the
port's ``load_frame`` gives JAX's depth and colour arrays exactly.  The
forms the port refuses as depth (RGB and JPEG-in-TIFF, CCITT, a form the
port does not read, a broken BMP or PGM header) raise ``ValueError``
naming the file and the tag.
The committed fixture ``tests/data/depth_forms`` decodes to its digests in
both."""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image
from torch_tiff_encoder import LONG, SHORT, encode

from hrbffusion3d_tpu.io import tum as jtum
from hrbffusion3d_tpu_torch.io import image, png, pnm, tiff
from hrbffusion3d_tpu_torch.io import tum as ttum

SIZES = {"64x48": (48, 64), "640x480": (480, 640)}


def _depth(size: str) -> np.ndarray:
    """A seeded uint16 depth frame: a smooth ramp with noise, a block of
    zeros and a corner of values within 8 of 65535."""
    h, w = SIZES[size]
    rng = np.random.default_rng(h * w)
    y, x = np.mgrid[0:h, 0:w]
    d = 4000.0 + 30000.0 * (x / w) + 8000.0 * np.sin(y / 7.0) + rng.normal(0, 40, (h, w))
    d = np.clip(np.round(d), 0, 65535).astype(np.uint16)
    d[h // 4:h // 2, w // 4:w // 2] = 0
    d[:h // 6, w - w // 6:] = 65535 - rng.integers(0, 8, (h // 6, w // 6)).astype(np.uint16)
    return d


def _pgm_binary(d: np.ndarray, maxval: int) -> bytes:
    h, w = d.shape
    v = (d.astype(np.int64) * maxval) // 65535
    if maxval not in (255, 65535):
        # a few samples above maxval, which Pillow clips after rescaling
        v[0, :3] = min(maxval + 3, 255 if maxval < 256 else 65535)
    sample = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    return f"P5\n# depth\n{w}  {h}\t\n{maxval}\n".encode() + v.astype(sample).tobytes()


def _pgm_plain(d: np.ndarray, maxval: int) -> bytes:
    h, w = d.shape
    v = (d.astype(np.int64) * maxval) // 65535
    rows = []
    for i, r in enumerate(v):
        line = " ".join(map(str, r))
        rows.append(line + (" # row\r\n" if i % 5 == 0 else "\t\n"))
    return (f"P2 # plain\n{w} {h}\n# maxval:\n{maxval}\n".encode()
            + "".join(rows).encode())


def _pillow_tiff(d: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(d).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _as(d: np.ndarray, dtype) -> np.ndarray:
    """The depth frame's bits spread over another sample type."""
    if dtype == np.float32:
        return d.astype(np.float32) * np.float32(0.2) - np.float32(100.0)
    info = np.iinfo(dtype)
    scaled = d.astype(np.int64) * ((int(info.max) - int(info.min)) // 65535) + int(info.min)
    return scaled.astype(dtype)


FORMS = {
    **{f"p5_max{m}": (lambda d, m=m: _pgm_binary(d, m))
       for m in (1, 2, 255, 256, 1023, 4095, 65534, 65535)},
    **{f"p2_max{m}": (lambda d, m=m: _pgm_plain(d, m)) for m in (1, 255, 4095, 65535)},
    "pillow_none": lambda d: _pillow_tiff(d),
    "pillow_lzw": lambda d: _pillow_tiff(d, compression="tiff_lzw"),
    "pillow_lzw_pred2": lambda d: _pillow_tiff(d, compression="tiff_lzw", tiffinfo={317: 2}),
    "pillow_deflate_pred2": lambda d: _pillow_tiff(d, compression="tiff_adobe_deflate",
                                                  tiffinfo={317: 2}),
    "pillow_packbits": lambda d: _pillow_tiff(d, compression="packbits"),
    **{f"u16_{o}_{name}": (lambda d, o=o, c=c, p=p: encode(d, o, c, p, rows_per_strip=16))
       for o in ("II", "MM")
       for name, c, p in (("none", 1, 1), ("packbits", 32773, 1), ("deflate8", 8, 1),
                          ("deflate32946", 32946, 1), ("lzw", 5, 1), ("lzw_pred2", 5, 2),
                          ("deflate_pred2", 8, 2), ("none_pred2", 1, 2))},
    "u16_II_old_lzw": lambda d: encode(d, "II", 5, 1, rows_per_strip=7, old_lzw=True),
    "u16_II_black0": lambda d: encode(d, "II", 8, 2, photometric=0),
    "u8_MM_black0": lambda d: encode((d >> 8).astype(np.uint8), "MM", 5, 2, photometric=0),
    "u8_II": lambda d: encode((d >> 8).astype(np.uint8), "II", 32773, 1, rows_per_strip=3),
    "i16_MM_lzw": lambda d: encode(_as(d, np.int16), "MM", 5, 2),
    "i16_II_none": lambda d: encode(_as(d, np.int16), "II", 1, 1),
    "i32_II_deflate": lambda d: encode(_as(d, np.int32), "II", 8, 2),
    "i32_MM_packbits": lambda d: encode(_as(d, np.int32), "MM", 32773, 1),
    "u32_II_lzw": lambda d: encode(_as(d, np.uint32), "II", 5, 2),
    "f32_II_pred3": lambda d: encode(_as(d, np.float32), "II", 8, 3, rows_per_strip=5),
    "f32_MM_pred3": lambda d: encode(_as(d, np.float32), "MM", 5, 3),
    "f32_MM_none": lambda d: encode(_as(d, np.float32), "MM", 1, 1),
}


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("form", list(FORMS))
def test_depth_form(tmp_path, form, size):
    data = FORMS[form](_depth(size))
    ref = _pillow(data)
    dec = pnm if form.startswith("p") and not form.startswith("pillow") else tiff
    got = dec.decode(data)
    assert got.dtype == ref.dtype.newbyteorder("="), (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)
    assert image.decode_depth(data).tobytes() == got.tobytes()

    # the TUM reader: the port's load_frame against JAX's, bit for bit
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "0.dat").write_bytes(data)
    h, w = SIZES[size]
    colour = np.random.default_rng(7).integers(0, 256, (h, w, 3)).astype(np.uint8)
    png.write(str(tmp_path / "c.png"), colour)
    fj = jtum.load_frame(str(tmp_path), "c.png", "d/0.dat", 1.5)
    ft = ttum.load_frame(str(tmp_path), "c.png", "d/0.dat", 1.5)
    assert ft.depth.dtype == fj.depth.dtype == np.float32
    assert ft.depth.tobytes() == fj.depth.tobytes()
    assert ft.rgb.tobytes() == fj.rgb.tobytes()


def test_pgm_rescale_matches_pillow_at_every_sample():
    """Pillow's rescaling, every sample value of a few maxvals (binary)."""
    for maxval in (1, 2, 3, 254, 256, 1000, 4095, 65534):
        v = np.arange(maxval + 1, dtype=np.int64)
        sample = ">u2" if maxval > 255 else "u1"
        data = f"P5 {len(v)} 1 {maxval} ".encode() + v.astype(sample).tobytes()
        np.testing.assert_array_equal(pnm.decode(data), _pillow(data), err_msg=str(maxval))


def test_pgm_header_comments_inside_tokens():
    """A comment inside a header token leaves its halves joined, as in
    Pillow; a plain sample comment takes its line end with it."""
    data = b"P2\n3#w\n 2\n25#mid\n5\n1 2 3 #c\n4 5 6\n"
    np.testing.assert_array_equal(pnm.decode(data), _pillow(data))


def _refused(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        image.read_depth(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


def test_refused_forms_name_file_and_tag(tmp_path):
    d = _depth("64x48")
    # strip tags beside tile tags: Pillow's raw decoder reads the strips
    tiled = encode(d, "II", 1, 1, extra={322: (SHORT, [16]), 323: (SHORT, [16]),
                                         324: (LONG, [8]), 325: (LONG, [2048])})
    np.testing.assert_array_equal(image.decode_depth(tiled), _pillow(tiled))
    rgb = np.stack([d >> 8] * 3, -1).astype(np.uint8)
    assert _pillow(_pillow_tiff(rgb)).shape == (48, 64, 3)
    assert "mode RGB" in _refused(tmp_path, "rgb.tif", _pillow_tiff(rgb))
    jpeg_tiff = _pillow_tiff(rgb, compression="jpeg")
    assert _pillow(jpeg_tiff).shape == (48, 64, 3)
    assert "mode RGB" in _refused(tmp_path, "jpeg_rgb.tif", jpeg_tiff)
    grey_jpeg = encode((d >> 8).astype(np.uint8), "II", 1, 1, extra={259: (SHORT, [7])})
    assert "259" in _refused(tmp_path, "jpeg_grey.tif", grey_jpeg)
    ccitt = encode((d >> 8).astype(np.uint8), "MM", 1, 1, extra={259: (SHORT, [4])})
    assert "259" in _refused(tmp_path, "ccitt.tif", ccitt)
    assert "278" in _refused(tmp_path, "rows0.tif", encode(d, extra={278: (LONG, [0])}))
    assert "not a form the port reads" in _refused(tmp_path, "depth.gif", b"GIF89a" + bytes(64))
    assert "BMP info header size 0" in _refused(tmp_path, "depth.bmp", b"BM" + bytes(64))
    assert "maxval" in _refused(tmp_path, "zero.pgm", b"P5 2 2 0 \0\0\0\0")
    # the TUM reader names the file too
    os.makedirs(tmp_path / "seq")
    (tmp_path / "seq" / "d.tif").write_bytes(grey_jpeg)
    png.write(str(tmp_path / "seq" / "c.png"), np.zeros((48, 64, 3), np.uint8))
    with pytest.raises(ValueError, match=r"seq/d\.tif: .*259"):
        ttum.load_frame(str(tmp_path / "seq"), "c.png", "d.tif", 0.0)


FIXTURE = os.path.join(os.path.dirname(__file__), "data", "depth_forms")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURE) if f != "digests.json")


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_digests(name):
    """The committed depth-forms fixture (``chip_smoke`` run_tum (i)):
    Pillow and the port each decode every file to its digest."""
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        entry = {e["file"]: e for e in json.load(f)["frames"]}[name]
    with open(os.path.join(FIXTURE, name), "rb") as f:
        data = f.read()
    ref = _pillow(data)
    got = image.decode_depth(data)
    assert str(got.dtype) == entry["dtype"] and got.shape == (entry["height"], entry["width"])
    for a in (ref.astype(ref.dtype.newbyteorder("=")), got):
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry["depth_sha256"]
