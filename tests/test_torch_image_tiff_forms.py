"""BigTIFF, JPEG-in-TIFF, YCbCr TIFF, greyscale JPEG depth and Pillow's
extra netpbm forms without Pillow: the port's ``io/tiff``, ``io/jpeg``,
``io/pnm`` and ``io/image`` against Pillow 12 (``Image.open(...).
convert("RGB")`` for colour and ``np.asarray(Image.open(...))`` for depth,
what the JAX package's TUM and ``.klg`` readers call), bit for bit.

- BigTIFF (``II+\\0``): every classic form (strips and tiles, planar 1
  and 2, none / LZW / deflate / PackBits, predictors 1-3), Pillow's own
  BigTIFF writer; big-endian BigTIFF, which Pillow 12 fails to open, is
  refused;
- JPEG-in-TIFF (compression 7): Pillow's writer (RGB and grey, with
  JPEGTables), photometric 6 strips and tiles of Pillow 4:2:0 streams with
  and without JPEGTables and YCbCrSubSampling, photometric 2 and 1 tiles;
- YCbCr (photometric 6) with LZW, deflate and PackBits at subsamplings
  (1, 1), (2, 1), (2, 2), (4, 2) and (4, 4), with and without tag 530, in
  strips of any height and tiles, predictor 2, separate planes,
  non-default YCbCrCoefficients and ReferenceBlackWhite on every (Cb, Cr)
  pair; uncompressed YCbCr through Pillow's raw decoder;
- greyscale JPEG as depth (mode ``L``); ``P0CMYK``, ``PyP``, ``PyRGBA``
  and ``PyCMYK``;
- the refusals: each raises ``ValueError`` naming the file and the tag or
  form, and where Pillow refuses too, Pillow fails;
- the committed fixture ``tests/data/tiff_forms`` through Pillow and the
  port to its digests.

Encoders: ``tests/torch_tiff_encoder.py`` where Pillow cannot write the
form; every case at 64x48 or smaller odd sizes.
"""

import hashlib
import io
import json
import os

import chip_smoke
import numpy as np
import pytest
from PIL import Image
from torch_tiff_encoder import RATIONAL, SHORT, UNDEFINED, encode, jpeg_tables

from hrbffusion3d_tpu_torch.io import image

H, W = 48, 64


def _rgb(h=H, w=W, seed=0) -> np.ndarray:
    """A seeded colour frame: smooth ramps with noise."""
    rng = np.random.default_rng(seed + h * w)
    y, x = np.mgrid[0:h, 0:w]
    c = np.stack([40 + 150 * x / w, 30 + 180 * y / h, 128 + 100 * np.sin((x + y) / 9.0)], -1)
    return np.clip(np.round(c + rng.normal(0, 8, (h, w, 3))), 0, 255).astype(np.uint8)


def _depth(h=H, w=W) -> np.ndarray:
    rng = np.random.default_rng(h * w + 1)
    y, x = np.mgrid[0:h, 0:w]
    d = 4000.0 + 30000.0 * (x / w) + 8000.0 * np.sin(y / 7.0) + rng.normal(0, 40, (h, w))
    return np.clip(np.round(d), 0, 65535).astype(np.uint16)


def _pillow(data: bytes, depth: bool = False) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    if depth:
        a = np.asarray(im)
        return a.astype(a.dtype.newbyteorder("="))
    return np.asarray(im.convert("RGB"))


def _pillow_fails(data: bytes) -> bool:
    try:
        _pillow(data)
    except Exception:                      # noqa: BLE001 - any refusal of Pillow's
        return True
    return False


def _same(data: bytes, depth: bool = False):
    ref = _pillow(data, depth)
    got = image.decode_depth(data) if depth else image.decode_colour(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def _save(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, **kw)
    return buf.getvalue()


def _jpeg(img: np.ndarray, **kw) -> bytes:
    return _save(img, format="JPEG", quality=85, **kw)


# ------------------------------------------------------------------- BigTIFF

BIGTIFF = {
    "grey16": dict(img=_depth()),
    "grey16_deflate_pred2": dict(img=_depth(), compression=8, predictor=2, rows_per_strip=7),
    "grey16_lzw_tiles": dict(img=_depth(), compression=5, tile=(16, 16)),
    "float32_deflate_pred3": dict(img=_depth().astype(np.float32) * np.float32(0.25),
                                  compression=32946, predictor=3),
    "rgb_packbits": dict(img=_rgb(), compression=32773, photometric=2, rows_per_strip=5),
    "rgb_lzw_pred2_tiles": dict(img=_rgb(), compression=5, predictor=2, photometric=2,
                                tile=(32, 16)),
    "rgb_planar_deflate": dict(img=_rgb(), compression=8, photometric=2, planar=2,
                               rows_per_strip=16),
    "rgb_raw_planar_tiles": dict(img=_rgb(), photometric=2, planar=2, tile=(16, 32)),
}


@pytest.mark.parametrize("name", list(BIGTIFF))
def test_bigtiff(name):
    kw = dict(BIGTIFF[name])
    data = encode(kw.pop("img"), bigtiff=True, **kw)
    assert data[:4] == b"II+\0"
    _same(data)
    if "rgb" not in name:
        _same(data, depth=True)


@pytest.mark.parametrize("mode", ["RGB", "I;16"])
def test_bigtiff_pillow_writer(mode):
    img = _rgb() if mode == "RGB" else _depth()
    data = _save(img, format="TIFF", big_tiff=True)
    assert data[:4] == b"II+\0"
    _same(data, depth=mode != "RGB")


# -------------------------------------------------------------- JPEG-in-TIFF

def _tiles(img: np.ndarray, tile, write) -> list[bytes]:
    out = []
    for y in range(0, img.shape[0], tile[1]):
        for x in range(0, img.shape[1], tile[0]):
            block = np.zeros((tile[1], tile[0]) + img.shape[2:], np.uint8)
            part = img[y:y + tile[1], x:x + tile[0]]
            block[:part.shape[0], :part.shape[1]] = part
            out.append(write(block))
    return out


def _abbreviated(streams: list[bytes]) -> tuple[list[bytes], dict]:
    """The streams without their tables, and the tag that holds them."""
    parts = [jpeg_tables(s) for s in streams]
    assert all(t == parts[0][0] for t, _ in parts)
    return [b for _, b in parts], {347: (UNDEFINED, parts[0][0])}


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [75, 40])
def test_jpeg_in_tiff_pillow_writer(mode, quality):
    img = _rgb() if mode == "RGB" else _rgb()[..., 0]
    data = _save(img, format="TIFF", compression="jpeg", quality=quality)
    assert Image.open(io.BytesIO(data)).tag_v2[259] == 7
    _same(data)
    if mode == "L":
        _same(data, depth=True)


@pytest.mark.parametrize("size", [(48, 64), (45, 61)])
@pytest.mark.parametrize("rows", [8, 16, 48])
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("tag530", [False, True])
def test_jpeg_in_tiff_ycbcr_strips(size, rows, tables, tag530):
    """Photometric 6 strips of Pillow 4:2:0 streams: each strip upsampled
    on its own (libjpeg's fancy filter stops at the strip's edge)."""
    img = _rgb(*size)
    streams = [_jpeg(img[r:r + rows]) for r in range(0, size[0], rows)]
    extra = {530: (SHORT, [2, 2])} if tag530 else {}
    if tables:
        streams, t = _abbreviated(streams)
        extra.update(t)
    _same(encode(img, compression=7, photometric=6, rows_per_strip=rows, chunks=streams,
                 extra=extra))


@pytest.mark.parametrize("size", [(48, 64), (45, 61)])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
@pytest.mark.parametrize("tables", [False, True])
def test_jpeg_in_tiff_tiles(size, tile, tables):
    """Photometric 6 (4:2:0), 2 (4:4:4, the components as stored) and 1
    (grey, colour and depth) in tiles cropped at the image's edge."""
    img = _rgb(*size)
    for photometric, sample, write in (
            (6, img, _jpeg),
            (2, img, lambda b: _jpeg(b, subsampling=0)),
            (1, img[..., 0], _jpeg)):
        streams = _tiles(sample, tile, write)
        extra = {}
        if tables:
            streams, extra = _abbreviated(streams)
        data = encode(sample, compression=7, photometric=photometric, tile=tile,
                      chunks=streams, extra=extra)
        _same(data)
        if photometric == 1:
            _same(data, depth=True)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_in_tiff_sampling_read_off_the_stream(subsampling):
    """Without YCbCrSubSampling libtiff takes the first stream's sampling
    (4:4:4, 4:2:2, 4:2:0); a progressive stream decodes too."""
    img = _rgb(45, 61)
    _same(encode(img, compression=7, photometric=6,
                 chunks=[_jpeg(img, subsampling=subsampling,
                               progressive=subsampling == 1)]))
    taller = _jpeg(_rgb(48, 64)[..., 0])
    _same(encode(_rgb()[..., 0], compression=7, photometric=1, chunks=[taller]), depth=True)


# ---------------------------------------------------------------- YCbCr TIFF

def _ycc(h=H, w=W, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("compression", [5, 8, 32773])
@pytest.mark.parametrize("size", [(48, 64), (37, 50)])
def test_ycbcr(sub, compression, size):
    """Data units of each subsampling in strips of several heights and in
    tiles (libtiff's RGBA path: its reads rounded to scanlines, its 4x4
    tile skew)."""
    ycc = _ycc(*size)
    tag = {530: (SHORT, list(sub))}
    for rows in (1, sub[1] * 3, 7, 100):
        _same(encode(ycc, compression=compression, photometric=6, rows_per_strip=rows,
                     subsampling=sub, extra=tag))
    for tile in ((16, 16), (12, 8)):
        _same(encode(ycc, compression=compression, photometric=6, tile=tile, subsampling=sub,
                     extra=tag))


@pytest.mark.parametrize("data_sub", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_ycbcr_without_tag_530(data_sub, compression):
    """Without YCbCrSubSampling libtiff reads (2, 2) units, whatever the
    data holds (up to 255 off the source but for (2, 2) data)."""
    ycc = _ycc()
    data = encode(ycc, compression=compression, photometric=6, rows_per_strip=4,
                  subsampling=data_sub)
    _same(data)
    if data_sub != (2, 2):
        assert not np.array_equal(_pillow(data), _pillow(
            encode(ycc, compression=compression, photometric=6, rows_per_strip=4,
                   subsampling=data_sub, extra={530: (SHORT, list(data_sub))})))


def test_ycbcr_layouts():
    """(1, 1) with predictor 2, in separate planes, big-endian, in BigTIFF;
    one sample of photometric 6 uncompressed reads as grey."""
    ycc = _ycc(45, 61)
    tag = {530: (SHORT, [1, 1])}
    _same(encode(ycc, compression=5, predictor=2, photometric=6, rows_per_strip=5, extra=tag))
    _same(encode(ycc, compression=8, planar=2, photometric=6, rows_per_strip=5, extra=tag))
    _same(encode(ycc, "MM", 32773, photometric=6, rows_per_strip=9, extra=tag))
    _same(encode(ycc, compression=8, photometric=6, subsampling=(2, 2), bigtiff=True,
                 extra={530: (SHORT, [2, 2])}))
    grey = encode(ycc[..., 0], photometric=6)
    _same(grey)
    _same(grey, depth=True)


@pytest.mark.parametrize("coefficients", [
    {529: (RATIONAL, [(2126, 10000), (7152, 10000), (722, 10000)])},
    {529: (RATIONAL, [(2990, 10000), (5870, 10000), (1140, 10000)]),
     532: (RATIONAL, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])},
    {532: (RATIONAL, [(15, 1), (235, 1), (120, 1), (250, 1), (129, 1), (240, 1)])},
])
def test_ycbcr_coefficients(coefficients):
    """libtiff's conversion tables of YCbCrCoefficients (529) and
    ReferenceBlackWhite (532) on every (Cb, Cr) pair, Y seeded."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    y = np.random.default_rng(7).integers(0, 256, (256, 256))
    ycc = np.stack([y, cb, cr], -1).astype(np.uint8)
    _same(encode(ycc, compression=8, photometric=6, rows_per_strip=64,
                 extra={530: (SHORT, [1, 1]), **coefficients}))


def test_uncompressed_ycbcr_is_pillows_raw_read():
    """Uncompressed YCbCr goes through Pillow's raw decoder (4 bytes a
    pixel): where the file is too short both fail, else both read the same
    bytes."""
    ycc = _ycc()
    short = encode(ycc, photometric=6, rows_per_strip=6, subsampling=(2, 2),
                   extra={530: (SHORT, [2, 2])})
    assert _pillow_fails(short)
    with pytest.raises(ValueError, match="truncated"):
        image.decode_colour(short)
    _same(encode(ycc, photometric=6, rows_per_strip=4, extra={530: (SHORT, [1, 1])}))


# ---------------------------------------------------- grey JPEG and netpbm

@pytest.mark.parametrize("progressive", [False, True])
def test_grey_jpeg_depth(progressive):
    data = _jpeg(_rgb()[..., 1], progressive=progressive)
    _same(data, depth=True)
    assert image.decode_depth(data).shape == (H, W)
    _same(data)


@pytest.mark.parametrize("mode", ["RGB", "CMYK"])
def test_colour_jpeg_is_not_depth(tmp_path, mode):
    buf = io.BytesIO()
    Image.fromarray(_rgb()).convert(mode).save(buf, format="JPEG")
    data = buf.getvalue()
    path = tmp_path / "d.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"JPEG image of mode {mode}: a depth image has one"):
        image.read_depth(str(path))
    _same(data)


def _pnm(magic: bytes, bands: int, maxval: int, h=6, w=5) -> bytes:
    v = np.random.default_rng(maxval).integers(0, maxval + 1, (h, w, bands))
    body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return magic + b" %d\n%d %d\n" % (w, h, maxval) + body


@pytest.mark.parametrize("magic,bands", [(b"P0CMYK", 4), (b"PyP", 1), (b"PyRGBA", 4),
                                         (b"PyCMYK", 4)])
@pytest.mark.parametrize("maxval", [255, 100, 1000, 65535])
def test_pillow_netpbm_extensions(tmp_path, magic, bands, maxval):
    data = _pnm(magic, bands, maxval)
    _same(data)
    if bands == 1:
        _same(data, depth=True)
    else:
        path = tmp_path / "d.ppm"
        path.write_bytes(data)
        with pytest.raises(ValueError, match="a depth image has one band"):
            image.read_depth(str(path))


# ----------------------------------------------------------------- refusals

def _refused(tmp_path, name: str, data: bytes, colour: bool = True) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        (image.read_colour if colour else image.read_depth)(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


def test_refusals_name_file_and_tag(tmp_path):
    img, grey = _rgb(), _rgb()[..., 0]
    # queued: old-style JPEG, LAB
    for tag, value, sample in ((259, 6, img), (262, 8, img)):
        bad = encode(sample, photometric=2 if sample.ndim == 3 else 1,
                     extra={tag: (SHORT, [value])})
        msg = _refused(tmp_path, f"t{tag}_{value}.tif", bad)
        assert f"tag {tag}) = {value}" in msg and "not read by the port yet" in msg
    # CCITT of 8-bit samples: libtiff decodes 1 bit a sample, Pillow fails
    for value in (2, 3, 4):
        bad = encode(grey, extra={259: (SHORT, [value])})
        assert _pillow_fails(bad), value
        assert f"tag 259) = {value}" in _refused(tmp_path, f"t259_{value}.tif", bad)
    # refused by Pillow too: float16 / float64 samples, big-endian BigTIFF,
    # YCbCr sampling libtiff does not convert, JPEG sampling libtiff rejects
    for name, bad, field in (
            ("f16.tif", encode(_depth().astype(np.float16)), "not a form Pillow opens"),
            ("f64.tif", encode(_depth().astype(np.float64)), "not a form Pillow opens"),
            ("mm.tif", encode(_depth(), "MM", bigtiff=True), "big-endian BigTIFF"),
            ("y14.tif", encode(_ycc(), compression=5, photometric=6, subsampling=(1, 4),
                               extra={530: (SHORT, [1, 4])}), "tag 530"),
            ("rgb420.tif", encode(img, compression=7, photometric=2, chunks=[_jpeg(img)]),
             "sampling factors"),
            ("y530.tif", encode(img, compression=7, photometric=6, chunks=[_jpeg(img)],
                                extra={530: (SHORT, [2, 1])}), "tag 530")):
        assert _pillow_fails(bad), name
        assert field in _refused(tmp_path, name, bad), name
    # not read by the port yet (Pillow reads them): JPEG in separate planes
    planar = encode(img, compression=7, photometric=2, planar=2,
                    chunks=_tiles(img, (W, H), _jpeg) * 3)
    assert "tag 284" in _refused(tmp_path, "planar.tif", planar)
    # a strip that its stream cannot fill (Pillow zero-fills, with libtiff's
    # and libjpeg's errors on stderr)
    short = encode(_ycc(), compression=5, photometric=6, rows_per_strip=4,
                   subsampling=(4, 2))
    assert "strip 0" in _refused(tmp_path, "short.tif", short)
    small = encode(grey, compression=7, photometric=1, chunks=[_jpeg(grey[:40])])
    assert "a JPEG stream of 64x40 for a 64x48 strip" in _refused(tmp_path, "small.tif", small)
    # YCbCr as depth: three bands
    ycc = encode(_ycc(), compression=8, photometric=6, subsampling=(2, 2),
                 extra={530: (SHORT, [2, 2])})
    assert "mode RGB" in _refused(tmp_path, "ycc.tif", ycc, colour=False)


# ------------------------------------------------------------------ fixture

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tiff_forms")
with open(os.path.join(FIXTURE, "digests.json")) as _f:
    FIXTURE_ENTRIES = json.load(_f)["frames"]


@pytest.mark.parametrize("entry", FIXTURE_ENTRIES, ids=lambda e: e["file"])
def test_fixture_digests(entry):
    """The TIFF-forms fixture (``chip_smoke`` run_tum (k)): Pillow and the
    port each decode every file, committed or written at run time, to its
    digest."""
    data = chip_smoke.tiff_form_bytes(entry)
    assert len(data) == entry["bytes"]
    depth = entry["kind"] == "depth"
    key = "depth_sha256" if depth else "rgb_sha256"
    got = image.decode_depth(data) if depth else image.decode_colour(data)
    for a in (_pillow(data, depth), got):
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry[key]
