"""Colour (and the depth that shares its code) in netpbm, BMP and TIFF
without Pillow: the port's ``io/pnm``, ``io/bmp``, ``io/tiff`` and
``io/modes`` against Pillow 12 (``Image.open(...).convert("RGB")`` and
``np.asarray(Image.open(...))``, which the JAX package's TUM and ``.klg``
readers call), and the port's ``tum.load_frame`` and ``klg.frames``
against JAX's, bit for bit.

- netpbm: ``P1`` / ``P4`` bitmaps, ``P3`` / ``P6`` colour at maxval 1,
  100, 255, 1023 and 65535, ``Pf`` in both byte orders;
- BMP: every info header size, 1, 4 and 8 bits with colour, grey and
  black-and-white palettes, 16 (5-5-5 and 5-6-5), 24 and 32 bits (BGRX
  and every bitfield layout Pillow reads), top-down rows, headerless DIB,
  RLE8 and RLE4 with end-of-line, delta and absolute runs (written by
  ``torch_bmp_encoder``);
- TIFF (``torch_tiff_encoder``): RGB, RGBA and the extra samples, 16-bit
  colour, palettes of 1-8 bits, CMYK, grey of 1-32 bits, each in strips
  and tiles, planar configuration 2, fill order 2, predictor 2, both byte
  orders and all four compressions, and the Orientation tag;
- Pillow's raw unpackers, its ``convert("RGB")`` of every mode and the
  CMYK formula of the port's JPEG decoder;
- the refusals: each raises ``ValueError`` naming the file and the tag or
  field;
- the committed fixture ``tests/data/colour_forms`` through Pillow and the
  port to its digests.

Every case runs at 64x48; a few at 640x480.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import chip_smoke
import numpy as np
import pytest
import torch_bmp_encoder as bmpenc
from PIL import Image
from PIL import TiffImagePlugin
from torch_tiff_encoder import SHORT, encode

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu.io import tum as jtum
from hrbffusion3d_tpu_torch.io import image, jpeg, klg, modes, native_loader, tiff
from hrbffusion3d_tpu_torch.io import tum as ttum

H, W = 48, 64


def _rgb(h=H, w=W, seed=0) -> np.ndarray:
    """A seeded colour frame: smooth ramps with noise and flat blocks."""
    rng = np.random.default_rng(seed + h * w)
    y, x = np.mgrid[0:h, 0:w]
    c = np.stack([40 + 150 * x / w, 30 + 180 * y / h, 128 + 100 * np.sin((x + y) / 9.0)], -1)
    c = np.clip(np.round(c + rng.normal(0, 6, (h, w, 3))), 0, 255).astype(np.uint8)
    c[h // 3:h // 2, w // 5:w // 2] = (200, 30, 90)
    return c


def _indices(h=H, w=W, n=256, seed=1) -> np.ndarray:
    """Palette indices with runs (for the run-length encoders) and noise."""
    rng = np.random.default_rng(seed)
    idx = (np.arange(w)[None] // 5 + np.arange(h)[:, None] // 3) % n
    noisy = rng.random((h, w)) < 0.2
    idx[noisy] = rng.integers(0, n, noisy.sum())
    return idx.astype(np.uint8)


def _palette(n: int, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


def _pillow(data: bytes):
    im = Image.open(io.BytesIO(data))
    return im.mode, np.asarray(im), np.asarray(im.convert("RGB"))


def _check(data: bytes, depth: bool = True):
    """The port's colour (and, for a single band, depth) equals Pillow's."""
    mode, ref, ref_rgb = _pillow(data)
    np.testing.assert_array_equal(image.decode_colour(data), ref_rgb)
    if depth and modes.BANDS[mode] == 1:
        got = image.decode_depth(data)
        assert got.dtype == ref.dtype.newbyteorder("="), (got.dtype, ref.dtype)
        if ref.dtype == bool:
            np.testing.assert_array_equal(got, ref)
        else:
            assert got.tobytes() == ref.astype(got.dtype).tobytes()
    return mode


# -------------------------------------------------------------------- netpbm


def _pnm(magic: str, img: np.ndarray, maxval: int | None = None) -> bytes:
    h, w = img.shape[:2]
    if magic in ("P1", "P4"):
        head = f"{magic}\n# bitmap\n{w} {h}\n".encode()
        if magic == "P4":
            return head + np.packbits(img == 0, axis=1).tobytes()
        return head + "\n".join(" ".join("0" if v else "1" for v in r) for r in img).encode()
    if magic == "Pf":
        scale = -1.0 if img.dtype.byteorder == "<" or img.dtype.byteorder == "=" else 1.0
        return f"Pf {w} {h}\n{scale}\n".encode() + img[::-1].tobytes()
    v = (img.astype(np.int64) * maxval) // 255
    head = f"{magic} {w}\t{h}\n#c\n{maxval}\n".encode()
    if magic == "P3":
        return head + "\n".join(" ".join(map(str, r.ravel())) for r in v).encode()
    if maxval not in (255, 65535):
        v[0, 0] = min(maxval + 3, 255 if maxval < 256 else 65535)   # clipped by Pillow
    return head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()


PNM = {
    "P1": lambda: _pnm("P1", _indices(n=2) == 1),
    "P4": lambda: _pnm("P4", _indices(n=2) == 1),
    **{f"P6_max{m}": (lambda m=m: _pnm("P6", _rgb(), m)) for m in (1, 100, 255, 1023, 65535)},
    **{f"P3_max{m}": (lambda m=m: _pnm("P3", _rgb(), m)) for m in (1, 255, 1023)},
    "Pf_le": lambda: _pnm("Pf", (_rgb()[..., 0] * 1.7 - 40).astype("<f4")),
    "Pf_be": lambda: _pnm("Pf", (_rgb()[..., 1] * 1.3 - 9.5).astype(">f4")),
}


@pytest.mark.parametrize("name", list(PNM))
def test_netpbm(name):
    data = PNM[name]()
    mode = _check(data)
    assert mode == {"P1": "1", "P4": "1", "Pf": "F"}.get(name[:2], "RGB")


# ----------------------------------------------------------------------- BMP

_GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
BMP = {
    "24": dict(img=_rgb(), bits=24),
    "24_top_down": dict(img=_rgb(), bits=24, top_down=True),
    "24_os2": dict(img=_rgb(), bits=24, header=12),
    "24_dib": dict(img=_rgb(), bits=24, dib=True),
    "32_bgrx": dict(img=_rgb(), bits=32),
    "16_555": dict(img=_rgb(), bits=16),
    "16_565": dict(img=_rgb(), bits=16, masks=(0xF800, 0x7E0, 0x1F)),
    "16_565_h52": dict(img=_rgb(), bits=16, masks=(0xF800, 0x7E0, 0x1F), header=52),
    "8_palette": dict(img=_indices(), bits=8, palette=_palette(256)),
    "8_palette_short": dict(img=_indices(n=200), bits=8, palette=_palette(180), colors=180),
    "8_grey": dict(img=_indices(), bits=8, palette=_GREY),
    "8_os2": dict(img=_indices(), bits=8, palette=_palette(256), header=12),
    "8_dib_top_down": dict(img=_indices(), bits=8, palette=_palette(256), dib=True,
                           top_down=True),
    "4_palette": dict(img=_indices(n=16), bits=4, palette=_palette(16), header=124),
    "4_grey": dict(img=_indices(w=2, n=16), bits=4, palette=_GREY[:16], colors=16),
    "1_palette": dict(img=_indices(n=2), bits=1, palette=_palette(2), header=108),
    "1_black_white": dict(img=_indices(n=2), bits=1, palette=_GREY[[0, 255]], colors=2),
    "8_black_white": dict(img=_indices(n=2), bits=8, palette=_GREY[[0, 255]], colors=2),
    "rle8": dict(img=_indices(), bits=8, palette=_palette(256), rle=8),
    "rle8_grey_top_down": dict(img=_indices(), bits=8, palette=_GREY, rle=8, top_down=True),
    "rle8_delta": dict(img=_indices(), bits=8, palette=_palette(256), rle=8, delta_row=5),
    "rle8_no_eol": dict(img=_indices(), bits=8, palette=_palette(256), rle=8, drop_eol=True),
    "rle8_dib": dict(img=_indices(), bits=8, palette=_palette(256), rle=8, dib=True),
    "rle4": dict(img=_indices(n=16), bits=4, palette=_palette(16), rle=4),
    "rle4_odd_width": dict(img=_indices(w=W - 3, n=16), bits=4, palette=_palette(16), rle=4),
    **{f"32_bitfields_{i}": dict(img=np.concatenate([_rgb(), _indices()[..., None]], 2),
                                 bits=32, masks=m, header=56)
       for i, m in enumerate([(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                              (0xFF000000, 0xFF00, 0xFF, 0x0),
                              (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                              (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                              (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                              (0xFF000000, 0xFF00, 0xFF, 0xFF0000)])},
    "32_bitfields_h40": dict(img=_rgb(), bits=32, masks=(0xFF0000, 0xFF00, 0xFF)),
    "32_bitfields_h64_top_down": dict(img=_rgb(), bits=32, masks=(0xFF, 0xFF00, 0xFF0000, 0),
                                      header=64, top_down=True),
}


@pytest.mark.parametrize("name", list(BMP))
def test_bmp(name):
    kw = dict(BMP[name])
    data = bmpenc.encode(kw.pop("img"), kw.pop("bits"), **kw)
    assert image.form(data) == ("DIB" if kw.get("dib") else "BMP")
    if _pillow_refuses(data) is None:
        _check(data)
    else:                                   # Pillow refuses it: so does the port
        with pytest.raises(ValueError, match="RLE|BMP"):
            image.decode_colour(data)


# ---------------------------------------------------------------------- TIFF


def _samples(n: int, dtype=np.uint8, hi=256, seed=3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.concatenate([_rgb(), _rgb(seed=4)], 2)[..., :n].astype(np.int64)
    v = base * (hi // 256) + rng.integers(0, max(hi // 256, 1), base.shape)
    return np.clip(v, 0, hi - 1).astype(dtype)


_PAL16 = np.random.default_rng(5).integers(0, 65536, (256, 3))
TIFF_FORMS = {
    "rgb": (_samples(3), dict(photometric=2)),
    "rgba": (_samples(4), dict(photometric=2)),
    "rgbx": (_samples(4), dict(photometric=2, extra_samples=[0])),
    "rgbxxx": (_samples(6), dict(photometric=2, extra_samples=[0, 0, 0])),
    "rgba_associated": (_samples(4), dict(photometric=2, extra_samples=[1])),
    "rgbaX_associated": (_samples(5), dict(photometric=2, extra_samples=[1, 0])),
    "rgba_unassociated": (_samples(4), dict(photometric=2, extra_samples=[2])),
    "rgba_corel": (_samples(4), dict(photometric=2, extra_samples=[999])),
    "rgb16": (_samples(3, np.uint16, 65536), dict(photometric=2)),
    "rgba16": (_samples(4, np.uint16, 65536), dict(photometric=2)),
    "rgba16_associated": (_samples(4, np.uint16, 65536), dict(photometric=2,
                                                             extra_samples=[1])),
    "rgbx16": (_samples(4, np.uint16, 65536), dict(photometric=2, extra_samples=[0])),
    "palette8": (_indices()[..., None], dict(photometric=3, colormap=_PAL16)),
    "palette4": (_indices(n=16)[..., None], dict(photometric=3, colormap=_PAL16[:16], bits=4)),
    "palette2": (_indices(n=4)[..., None], dict(photometric=3, colormap=_PAL16[:4], bits=2)),
    "palette1": (_indices(n=2)[..., None], dict(photometric=3, colormap=_PAL16[:2], bits=1)),
    "palette_alpha": (np.stack([_indices(), _indices(seed=9)], -1),
                      dict(photometric=3, colormap=_PAL16, extra_samples=[2])),
    "palette_x": (np.stack([_indices(), _indices(seed=9)], -1),
                  dict(photometric=3, colormap=_PAL16, extra_samples=[0])),
    "cmyk": (_samples(4), dict(photometric=5)),
    "cmykx": (_samples(5), dict(photometric=5, extra_samples=[0])),
    "cmyk16": (_samples(4, np.uint16, 65536), dict(photometric=5)),
    "grey_alpha": (_samples(2), dict(photometric=1, extra_samples=[2])),
    "grey1": (_indices(n=2)[..., None], dict(photometric=1, bits=1)),
    "grey1_black0": (_indices(n=2)[..., None], dict(photometric=0, bits=1)),
    "grey2": (_indices(n=4)[..., None], dict(photometric=1, bits=2)),
    "grey4_black0": (_indices(n=16)[..., None], dict(photometric=0, bits=4)),
    "grey8": (_samples(1), dict(photometric=1)),
    "grey16": (_samples(1, np.uint16, 65536), dict(photometric=1)),
    "float32": ((_samples(1).astype(np.float32) * 3.3 - 100), dict(photometric=1)),
}
# (byte order, compression, layout): strips of 5 rows, 16x16 tiles, planes,
# fill order 2, predictor 2
TIFF_LAYOUTS = (("II", 1, "strips"), ("MM", 1, "tiles"), ("II", 1, "planar"),
                ("MM", 1, "fill2"), ("II", 5, "predictor2"), ("MM", 5, "tiles_planar"),
                ("II", 8, "fill2_tiles"), ("MM", 32946, "predictor2_planar"),
                ("II", 32773, "strips"), ("MM", 32773, "tiles"))


def _layout_kw(layout: str) -> dict:
    kw = dict(tile=(16, 16)) if "tiles" in layout else dict(rows_per_strip=5)
    if "planar" in layout:
        kw["planar"] = 2
    if "fill2" in layout:
        kw["fill_order"] = 2
    if "predictor2" in layout:
        kw["predictor"] = 2
    return kw


def _pillow_refuses(data: bytes) -> str | None:
    try:
        _pillow(data)
    except Exception as e:                  # noqa: BLE001 - any refusal of Pillow's
        return f"{type(e).__name__}: {e}"
    return None


@pytest.mark.parametrize("layout", TIFF_LAYOUTS, ids=lambda t: f"{t[0]}_{t[1]}_{t[2]}")
@pytest.mark.parametrize("form", list(TIFF_FORMS))
def test_tiff(form, layout):
    img, kw = TIFF_FORMS[form]
    order, compression, name = layout
    kw = dict(kw, **_layout_kw(name))
    if kw.get("predictor") and (kw.get("bits", 8) < 8 or img.dtype == np.float32):
        kw.pop("predictor")
    if "tiles_planar" in name and form == "palette_x":
        return                              # test_tiff_tiled_planes_beyond_a_single_band

    data = encode(img[..., 0] if img.shape[2] == 1 else img, order, compression, **kw)
    refused = _pillow_refuses(data)
    if refused is None:
        _check(data)
        return
    # Pillow refuses: so does the port, naming the tag, the form or the cut
    with pytest.raises(ValueError, match=r"tag \d+|not a form Pillow opens|Pillow has no "
                                         r"unpacker|truncated"):
        image.decode_colour(data)


def test_tiff_tiled_planes_beyond_a_single_band_are_refused():
    """A departure by design: Pillow reads tiles of a one-band mode with
    more planes (``PX``) at twice the plane's row length, into bytes libtiff
    does not write; the port refuses them."""
    img = np.stack([_indices(), _indices(seed=9)], -1)
    data = encode(img, "MM", 5, photometric=3, colormap=_PAL16, extra_samples=[0],
                  tile=(16, 16), planar=2)
    assert _pillow_refuses(data) is None
    with pytest.raises(ValueError, match=r"tag 284.*does not write"):
        image.decode_colour(data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(orientation):
    for img, comp in ((_samples(3), 1), (_samples(1, np.uint16, 65536)[..., 0], 8)):
        data = encode(img, "II", comp, photometric=2 if img.ndim == 3 else 1,
                      extra={274: (SHORT, [orientation])})
        _check(data)


def test_tiff_open_info_is_pillows():
    """The port's table is Pillow's OPEN_INFO but LAB."""
    ref = {(("I" if k[0] == TiffImagePlugin.II else "M"),) + k[1:]: v
           for k, v in TiffImagePlugin.OPEN_INFO.items() if k[1] != 8}
    assert tiff.OPEN_INFO == ref


def test_twelve_bit_and_planar_tiles_read_only_their_bands():
    v = _samples(1, np.uint16, 4096)[..., 0]
    rows = np.unpackbits(v.astype(">u2").view(np.uint8).reshape(H, W, 2), axis=2)
    packed = np.packbits(rows[..., 4:].reshape(H, W * 12), axis=1)
    data = encode(v, "II", 1, extra={258: (SHORT, [12])})
    data = data.replace(v.astype("<u2").tobytes(), packed.tobytes().ljust(v.nbytes, b"\0"))
    _check(data)
    # tiles of planes: the planes beyond the mode's bands are not read
    _check(encode(_samples(5), "II", 5, photometric=2, extra_samples=[0, 0], tile=(16, 16),
                  planar=2))


# ---------------------------------------------------------------- unpackers


UNPACK = [("L", r) for r in ("L;2", "L;2I", "L;2R", "L;2IR", "L;4", "L;4I", "L;4R", "L;4IR",
                             "L;I", "L;R", "L")] + \
    [("1", r) for r in ("1", "1;I", "1;R", "1;IR")] + \
    [("P", r) for r in ("P;1", "P;2", "P;4", "P", "P;R", "PX")] + \
    [("RGB", r) for r in ("RGB", "RGB;R", "RGBX", "RGBXXX", "BGR", "BGRX", "XBGR", "BGXR",
                          "RGB;16L", "RGB;16B", "RGBX;16N", "BGR;15", "BGR;16", "G")] + \
    [("RGBA", r) for r in ("RGBa", "RGBaXX", "RGBAX", "ABGR", "BGRA", "BGAR", "RGBa;16L",
                           "RGBa;16B", "RGBA;16N", "A")] + \
    [("CMYK", r) for r in ("CMYK", "CMYKXX", "CMYK;16B", "K")] + \
    [("LA", "LA"), ("PA", "PA"), ("I;16", "I;16"), ("I;16B", "I;16B"), ("I;16", "I;16R"),
     ("I;16", "I;12"), ("I", "I;16S"), ("I", "I;16BS"), ("I", "I;32N"), ("I", "I;32BS"),
     ("F", "F;32F"), ("F", "F;32BF")]


@pytest.mark.parametrize("mode,rawmode", UNPACK, ids=lambda v: v.replace(";", "_"))
def test_unpack_matches_pillow(mode, rawmode):
    rng = np.random.default_rng(len(rawmode))
    for w in (1, 13):
        bits = modes.rawmode_bits(mode, rawmode)
        data = rng.integers(0, 256, (3, (w * bits + 7) // 8), dtype=np.uint8)
        data[0, :2] = (0, 255)[:data.shape[1]]
        if mode == "F":
            data = np.frombuffer(rng.normal(0, 100, 3 * w).astype(">f4" if "B" in rawmode
                                                                   else "<f4").tobytes(),
                                 np.uint8).reshape(3, -1)
        ref = np.asarray(Image.frombytes(mode, (w, 3), data.tobytes(), "raw", rawmode))
        got = modes.new(mode, 3, w)
        modes.unpack_into(got, mode, rawmode, data, 0, 0, w)
        np.testing.assert_array_equal(got, ref.astype(ref.dtype.newbyteorder("=")))


def test_convert_rgb_of_every_mode():
    rng = np.random.default_rng(11)
    cases = {"F": np.array([[-5.5, 0.5, 100.7, 254.99, 255.0, 1e9, np.nan, np.inf, -np.inf]],
                           np.float32),
             "I": np.array([[-5, 100, 255, 256, 70000, -2 ** 31]], np.int32),
             "I;16": np.array([[0, 100, 300, 65535]], np.uint16),
             "L": rng.integers(0, 256, (3, 5)).astype(np.uint8),
             "1": rng.random((3, 5)) < 0.5,
             "RGBA": rng.integers(0, 256, (3, 5, 4)).astype(np.uint8),
             "CMYK": rng.integers(0, 256, (3, 5, 4)).astype(np.uint8),
             "LA": rng.integers(0, 256, (3, 5, 2)).astype(np.uint8)}
    for mode, a in cases.items():
        im = Image.fromarray(a) if mode in ("F", "I", "I;16", "L", "1") else \
            Image.frombytes(mode, a.shape[1::-1], a.tobytes())
        assert im.mode == mode
        np.testing.assert_array_equal(modes.to_rgb(mode, a), np.asarray(im.convert("RGB")),
                                      err_msg=mode)
    p = Image.frombytes("P", (4, 1), bytes([0, 1, 2, 200]))
    p.putpalette(bytes([10, 20, 30, 40, 50, 60]))
    np.testing.assert_array_equal(
        modes.to_rgb("P", np.array([[0, 1, 2, 200]], np.uint8), np.array([[10, 20, 30],
                                                                        [40, 50, 60]], np.uint8)),
        np.asarray(p.convert("RGB")))


def test_cmyk_formula_is_the_jpeg_decoders():
    """``io/modes``' CMYK -> RGB is what the JPEG decoder applies to a CMYK
    JPEG (Pillow's stored samples, converted as Pillow converts them)."""
    rng = np.random.default_rng(12)
    cmyk = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    cmyk[0, :8, 3] = (0, 255, 128, 1, 254, 0, 255, 3)
    buf = io.BytesIO()
    Image.frombytes("CMYK", (16, 16), cmyk.tobytes()).save(buf, format="JPEG", quality=95)
    stored = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    np.testing.assert_array_equal(jpeg.decode(buf.getvalue()), modes.cmyk_to_rgb(stored))


# ----------------------------------------------------------------- refusals


def _refused(tmp_path, name: str, data: bytes, colour: bool = True) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        (image.read_colour if colour else image.read_depth)(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


def test_refusals_name_file_and_field(tmp_path):
    rgb, idx = _rgb(), _indices()
    # Pillow refuses these too
    assert _pillow_refuses(bmpenc.encode(rgb, 24, masks=(0xFF, 0xFF00, 0xFF0000))) is not None
    assert "bitfields" in _refused(tmp_path, "a.bmp",
                                   bmpenc.encode(rgb, 24, masks=(0xFF, 0xFF00, 0xFF0000)))
    jpeg_in_bmp = bytearray(bmpenc.encode(rgb, 24))
    jpeg_in_bmp[30:34] = struct.pack("<I", 4)
    assert "compression 4" in _refused(tmp_path, "b.bmp", bytes(jpeg_in_bmp))
    two_bit = bytearray(bmpenc.encode(idx % 4, 4, palette=_palette(16)))
    two_bit[28:30] = struct.pack("<H", 2)
    assert "bit count 2" in _refused(tmp_path, "c.bmp", bytes(two_bit))
    rle24 = bytearray(bmpenc.encode(rgb, 24))
    rle24[30:34] = struct.pack("<I", 1)
    assert "run-length" in _refused(tmp_path, "d.bmp", bytes(rle24))
    short = bmpenc.encode(idx, 8, palette=_palette(256), rle=8, drop_eol=True)
    assert "RLE8" in _refused(tmp_path, "e.bmp", short[:len(short) // 2])
    assert "header size 20" in _refused(tmp_path, "f.bmp",
                                        b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(40))
    assert "truncated" in _refused(tmp_path, "g.bmp", bmpenc.encode(rgb, 24)[:-10])
    assert "maxval" in _refused(tmp_path, "h.ppm", b"P0CMYK 1 1 0\n\1\2\3\4")
    assert "truncated" in _refused(tmp_path, "i.ppm", b"P6 4 4 255\n" + bytes(20))
    assert "sample" in _refused(tmp_path, "j.pbm", b"P1 2 2\n1 0 2 0\n")
    assert "scale" in _refused(tmp_path, "k.pfm", b"Pf 1 1 0.0\n\0\0\0\0")
    # TIFF: the queued forms, each by its tag (259 = 7: raw bytes, no JPEG)
    grey = idx
    for tag, value in ((259, 7), (259, 6), (259, 4), (259, 2), (262, 8)):
        bad = encode(np.stack([grey] * 3, -1) if tag == 262 else grey, "II", 1,
                     photometric=value if tag == 262 else 1,
                     extra={tag: (SHORT, [value])})
        assert f"tag {tag}) = {value}" in _refused(tmp_path, f"t{tag}_{value}.tif", bad)
    half = encode(grey.astype(np.uint16), "II", 1, extra={339: (SHORT, [3])})
    assert "not a form Pillow opens" in _refused(tmp_path, "half.tif", half)
    assert "BigTIFF" in _refused(tmp_path, "big.tif", b"II+\0" + bytes(16))
    planar16 = encode(_samples(1, np.uint16, 65536)[..., 0], "II", 1, planar=2)
    assert _pillow_refuses(planar16) is not None
    assert "I;16" in _refused(tmp_path, "planar16.tif", planar16)
    pred1bit = encode(_indices(n=2), "II", 5, bits=1, predictor=2)
    assert _pillow_refuses(pred1bit) is not None
    assert "tag 317" in _refused(tmp_path, "pred.tif", pred1bit)
    rgbx_planar = encode(_samples(4), "II", 8, photometric=2, extra_samples=[0], planar=2)
    assert _pillow_refuses(rgbx_planar) is not None
    assert "tag 284" in _refused(tmp_path, "rgbx.tif", rgbx_planar)
    # a multi-band depth file names its mode
    for name, data in (("rgb.ppm", _pnm("P6", rgb, 255)), ("rgb.bmp", bmpenc.encode(rgb, 24)),
                       ("cmyk.tif", encode(_samples(4), "MM", 5, photometric=5))):
        assert "a depth image has one band" in _refused(tmp_path, name, data, colour=False)


# -------------------------------------------------- the readers against JAX's


def _files(size=(H, W)) -> tuple[dict, dict]:
    """({colour file: writer}, {depth file: writer}): one colour file per
    form beside one depth file per single-band form."""
    h, w = size
    rgb, idx = _rgb(h, w), _indices(h, w)
    d16 = (np.clip(_rgb(h, w)[..., 0].astype(np.uint32) * 200 + 1000, 0, 65535)
           .astype(np.uint16))
    colour = {"c.ppm": lambda: _pnm("P6", rgb, 255), "c.bmp": lambda: bmpenc.encode(rgb, 24),
              "c_rle.bmp": lambda: bmpenc.encode(idx, 8, palette=_palette(256), rle=8),
              "c.tif": lambda: encode(rgb, "II", 5, 2, photometric=2),
              "c_pillow.tif": lambda: _pillow_save(rgb, compression="tiff_lzw",
                                                   tiffinfo={317: 2}),
              "c_tiles.tif": lambda: encode(rgb, "MM", 8, photometric=2, tile=(96, 64)),
              "c_pal.tif": lambda: encode(idx, "II", 8, photometric=3, colormap=_PAL16),
              "c_cmyk.tif": lambda: encode(_samples(4)[:h, :w], "II", 8, photometric=5)}
    depth = {"d.tif": lambda: encode(d16, "MM", 8, tile=(16, 16)),
             "d.pgm": lambda: _pnm("P5", d16.astype(np.uint8), 255),
             "d.bmp": lambda: bmpenc.encode(idx, 8, palette=_GREY, rle=8)}
    return colour, depth


def _pillow_save(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _write_files(root, size=(H, W)):
    colour, depth = _files(size)
    for name, write in {**colour, **depth}.items():
        (root / name).write_bytes(write())
    return list(colour), list(depth)


def test_tum_load_frame_matches_jax(tmp_path):
    colour, depth = _write_files(tmp_path)
    for i, c in enumerate(colour):
        d = depth[i % len(depth)]
        fj = jtum.load_frame(str(tmp_path), c, d, 1.5)
        ft = ttum.load_frame(str(tmp_path), c, d, 1.5)
        assert ft.rgb.tobytes() == fj.rgb.tobytes(), c
        assert ft.depth.tobytes() == fj.depth.tobytes(), d


def test_tum_prefetched_builds_the_library_for_rle_bmp(tmp_path, monkeypatch):
    colour, depth = _write_files(tmp_path)
    (tmp_path / "associations.txt").write_text(
        "".join(f"{i}.0 c_rle.bmp {i}.0 d.pgm\n" for i in range(2)))
    built = []
    monkeypatch.setattr(ttum.jpeg, "library", lambda real=ttum.jpeg.library: built.append(1)
                        or real())
    got = list(ttum.frames_prefetched(str(tmp_path), workers=1, depth_ahead=1))
    ref = list(jtum.frames(str(tmp_path)))
    assert built == [1] and len(got) == len(ref) == 2
    assert all(a.rgb.tobytes() == b.rgb.tobytes() for a, b in zip(got, ref))


def test_klg_payloads_match_jax(tmp_path):
    colour, _ = _write_files(tmp_path)
    d16 = np.full((H, W), 1234, np.uint16)
    path = tmp_path / "f.klg"
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(colour)))
        for i, name in enumerate(colour):
            dbuf, ibuf = zlib.compress(d16.tobytes()), (tmp_path / name).read_bytes()
            f.write(struct.pack("<qii", i, len(dbuf), len(ibuf)) + dbuf + ibuf)
    ref = list(jklg.frames(str(path), W, H))
    got = list(klg.frames(str(path), W, H))
    assert len(got) == len(ref) == len(colour)
    for a, b in zip(got, ref):
        assert a.rgb.tobytes() == b.rgb.tobytes() and a.depth.tobytes() == b.depth.tobytes()
    # the native loader decodes JPEG colour only and names the form it found
    with pytest.raises(RuntimeError, match=r"frame 0: netpbm colour payload: this loader "
                                           r"decodes JPEG colour only"):
        list(native_loader.frames(str(path), W, H))
    # a payload of another size names the form it found
    d16 = np.full((H - 1, W), 1234, np.uint16)
    with open(path, "wb") as f:
        dbuf, ibuf = zlib.compress(d16.tobytes()), (tmp_path / colour[1]).read_bytes()
        f.write(struct.pack("<i", 1) + struct.pack("<qii", 0, len(dbuf), len(ibuf)) + dbuf
                + ibuf)
    with pytest.raises(RuntimeError, match=r"frame 0: BMP colour payload is 64x48, expected "
                                           r"64x47"):
        list(klg.frames(str(path), W, H - 1))


@pytest.mark.parametrize("name", ["c.ppm", "c_rle.bmp", "c_pillow.tif", "c_tiles.tif"])
def test_full_size(name):
    data = _files((480, 640))[0][name]()
    np.testing.assert_array_equal(image.decode_colour(data), _pillow(data)[2])


# ------------------------------------------------------------------ fixture

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "colour_forms")


def _fixture_entries():
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        return json.load(f)["frames"]


@pytest.mark.parametrize("entry", _fixture_entries(), ids=lambda e: e["file"])
def test_fixture_digests(entry):
    """The colour-forms fixture (``chip_smoke`` run_tum (j); two files
    written from their JPEG where used): Pillow and the port each decode
    every file to its digest."""
    data = chip_smoke.colour_form_bytes(entry)
    mode, ref, ref_rgb = _pillow(data)
    if entry["kind"] == "depth":
        got = image.decode_depth(data)
        ref = ref.astype(ref.dtype.newbyteorder("="))
        key = "depth_sha256"
    else:
        got, ref = image.decode_colour(data), ref_rgb
        key = "rgb_sha256"
    for a in (ref, got):
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry[key]
