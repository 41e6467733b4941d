"""The port's JPEG decoder and the .klg readers built on it.

- ``io/jpeg.decode`` equals Pillow's ``Image.open(...).convert("RGB")``
  bit for bit, on baseline and on progressive streams: qualities 50-100 at
  4:4:4, 4:2:2 and 4:2:0 on sides that are and are not multiples of the
  MCU, a 640x480 frame of each committed fixture, greyscale, restart
  intervals (per block and per MCU row), optimised Huffman tables, an
  Adobe RGB stream, a 4:4:0 stream and images of 7x3 and 1x1 pixels;
- a progressive stream with its refinement scans cut out (EOI kept), or
  with its DC scans only, equals Pillow too: libjpeg-turbo smooths such an
  image's blocks, and so does the decoder (more forms, CMYK, lossless and
  arithmetic coding among them, in ``test_torch_jpeg_forms.py``);
- 12-bit, truncated and corrupt streams (a marker inside the entropy-coded
  data, a byte between it and the next marker) raise ``RuntimeError``
  naming the cause;
- on a JPEG-colour .klg the port's Python reader equals the JAX reader
  (Pillow) bit for bit, and the native loader equals the Python reader
  (timestamps and depth bit for bit, colour bytes equal, colour floats
  within one ulp: the library multiplies by 1/255, the reader divides);
- a corrupt frame in the middle of a .klg makes both readers raise with
  its index after the frames before it, never a shorter sequence;
- the committed fixtures (``tests/data/klg_jpeg``, baseline, and
  ``tests/data/tum_jpeg_progressive``, the same frames progressive; both
  written by ``scripts/make_klg_jpeg_fixture.py``) still decode, in Pillow
  here, to their digests, the progressive frames to the baseline frames'.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu_torch.io import jpeg, native_loader
from hrbffusion3d_tpu_torch.io import klg as tklg

FIXTURE = Path(__file__).resolve().parent / "data" / "klg_jpeg"
PROGRESSIVE_FIXTURE = FIXTURE.parent / "tum_jpeg_progressive"
SIZES = ((47, 61), (48, 64))
QUALITIES = (50, 75, 90, 95, 100)
OTHER_CASES = ("fixture", "grey", "restart_blocks", "restart_rows", "optimize", "adobe_rgb",
               "440", "tiny", "one_pixel")
W, H = 640, 480
SCALE = 1.0 / 5000.0


@pytest.fixture(scope="module")
def lib():
    """The native library, built once for the module (``io/jpeg`` and the
    native loader share it)."""
    assert native_loader.available(), native_loader.status()["build_error"]
    return native_loader.status()["library"]


def _image(h, w, seed=0, grey=False):
    """Gradients, noise and a saturated patch: ringing overshoots both ends."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 5 + yy * 3, xx * 2 + yy, yy * 7 + 40], -1) % 256.0
    img += rng.normal(0, 25, img.shape)
    img[h // 3:h // 2, w // 4:w // 2] = (255, 0, 30)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 1] if grey else img


def _save(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _segments(data: bytes):
    """(marker, bytes) of each segment after SOI, a scan with its
    entropy-coded data (up to the next marker that is not RSTn)."""
    pos, out = 2, []
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            out.append((m, data[pos:pos + 2]))
            break
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((m, data[pos:end]))
        pos = end
    return out


def _scans_kept(data: bytes, keep) -> bytes:
    """The stream with only the scans for which ``keep(Ss, Ah)`` holds."""
    out = data[:2]
    for m, seg in _segments(data):
        if m == 0xDA:
            ns = seg[4]
            ss, ah = seg[5 + 2 * ns], seg[7 + 2 * ns] >> 4
            if not keep(ss, ah):
                continue
        out += seg
    return out


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _fixture_meta():
    return json.loads((FIXTURE / "digests.json").read_text())["frames"]


def _stream(case, progressive=False) -> bytes:
    def save(img, **kwargs):
        return _save(img, progressive=progressive, **kwargs)

    if isinstance(case, tuple):
        quality, subsampling, (h, w) = case
        return save(_image(h, w), quality=quality, subsampling=subsampling)
    if case == "fixture":
        return ((PROGRESSIVE_FIXTURE if progressive else FIXTURE)
                / _fixture_meta()[7]["file"]).read_bytes()
    if case == "grey":
        return save(_image(47, 61, grey=True), quality=85)
    if case == "restart_blocks":
        return save(_image(47, 61), quality=90, subsampling=2, restart_marker_blocks=3)
    if case == "restart_rows":
        return save(_image(48, 64), quality=75, subsampling=1, restart_marker_rows=1)
    if case == "optimize":
        return save(_image(47, 61), quality=80, subsampling=2, optimize=True)
    if case == "adobe_rgb":       # no colour transform (Adobe APP14, transform 0)
        data = save(_image(47, 61), quality=80, subsampling=0, keep_rgb=True)
        assert b"Adobe" in data
        return data
    if case == "tiny":
        return save(_image(3, 7), quality=90, subsampling=2)
    if case == "one_pixel":
        return save(_image(1, 1), quality=95, subsampling=2)
    # 4:4:0 (luma 1x2): a 4:2:2 stream of W x H relabelled as H x W with the
    # luma's factors swapped is a valid 4:4:0 stream of the same blocks
    data = bytearray(save(_image(47, 61), quality=80, subsampling=1))
    sof = data.index(b"\xff\xc2" if progressive else b"\xff\xc0")
    h, w = struct.unpack(">HH", data[sof + 5:sof + 9])
    assert data[sof + 11] == 0x21
    data[sof + 5:sof + 9] = struct.pack(">HH", w, h)
    data[sof + 11] = 0x12
    return bytes(data)


def _case_id(case) -> str:
    return case if isinstance(case, str) else f"q{case[0]}-ss{case[1]}-{case[2][1]}x{case[2][0]}"


DECODE_CASES = [(q, s, hw) for hw in SIZES for q in QUALITIES for s in (0, 1, 2)] + \
    list(OTHER_CASES)


@pytest.mark.parametrize("progressive,case",
                         [(False, c) for c in DECODE_CASES] + [(True, c) for c in DECODE_CASES],
                         ids=[_case_id(c) for c in DECODE_CASES]
                         + [f"progressive-{_case_id(c)}" for c in DECODE_CASES])
def test_decode_matches_pillow(lib, progressive, case):
    data = _stream(case, progressive)
    assert (b"\xff\xc2" in data) == progressive
    ref = _pillow(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kept", ["no_refinement", "dc_only"])
def test_unrefined_progressive_raises(lib, kept):
    """Scans cut out of a progressive stream, EOI kept: Pillow smooths the
    blocks of what is left (jdcoefct.c decompress_smooth_data), and the
    decoder gives the same bytes (it no longer raises)."""
    full = _save(_image(48, 64), quality=90, subsampling=2, progressive=True)
    keep = {"no_refinement": lambda ss, ah: ah == 0, "dc_only": lambda ss, ah: ss == 0}[kept]
    data = _scans_kept(full, keep)
    n_scans = sum(m == 0xDA for m, _ in _segments(data))
    assert 0 < n_scans < sum(m == 0xDA for m, _ in _segments(full))
    ref = _pillow(data)
    assert ref.shape == (48, 64, 3)
    assert not np.array_equal(ref, _pillow(full))   # smoothed, not the full image
    np.testing.assert_array_equal(jpeg.decode(data), ref)


def _patched(offset_from_sof: int, value: int, progressive=False) -> bytes:
    """A baseline (progressive) stream with one byte of its SOF0 (SOF2)
    segment changed."""
    data = bytearray(_save(_image(48, 64), quality=90, progressive=progressive))
    data[data.index(b"\xff\xc2" if progressive else b"\xff\xc0") + offset_from_sof] = value
    return bytes(data)


def _corrupt(data: bytes) -> bytes:
    """16 bytes of 0xFF in the middle of the entropy-coded data: fill
    bytes that end in a marker."""
    data = bytearray(data)
    sos = data.index(b"\xff\xda")
    mid = sos + (len(data) - sos) // 2
    data[mid:mid + 16] = b"\xff" * 16
    return bytes(data)


REFUSED = {
    "12-bit": (lambda: _patched(4, 12), "12-bit JPEG"),
    "truncated": (lambda: _save(_image(48, 64), quality=90)[:-300], "truncated JPEG"),
    "corrupt": (lambda: _corrupt(_save(_image(48, 64), quality=90)), "corrupt JPEG data"),
    "extraneous": (lambda: (lambda d: d[:-2] + b"\x5a" + d[-2:])(_save(_image(48, 64),
                                                                    quality=90)),
                   "corrupt JPEG data: 1 extraneous bytes"),
    "not_jpeg": (lambda: b"\x89PNG\r\n\x1a\n" + bytes(40), "not a JPEG"),
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_streams_raise(lib, kind):
    make, cause = REFUSED[kind]
    with pytest.raises(RuntimeError, match=cause):
        jpeg.decode(make())


def _depth_u16(i: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    d = (np.sin(xx / 40.0 + i) + 2.0) * 4000 + yy * 3
    d[::9, ::7] = 0
    return d.astype(np.uint16)


def _write_klg(path, colours, depth_payloads=None, cut_at=None):
    """A .klg of zlib depth and the given colour payloads (the fixture's
    JPEG bytes); ``cut_at``: the file ends inside that frame's colour."""
    depth_payloads = depth_payloads or [zlib.compress(_depth_u16(i).tobytes())
                                        for i in range(len(colours))]
    blob = bytearray(struct.pack("<i", len(colours)))
    for i, (dbuf, ibuf) in enumerate(zip(depth_payloads, colours)):
        blob += struct.pack("<qii", 1305031102175304 + 33333 * i, len(dbuf), len(ibuf))
        blob += dbuf
        blob += ibuf[:len(ibuf) // 2] if i == cut_at else ibuf
        if i == cut_at:
            break
    Path(path).write_bytes(bytes(blob))


def _fixture_payloads(n):
    return [(FIXTURE / e["file"]).read_bytes() for e in _fixture_meta()[:n]]


def test_python_reader_matches_jax(lib, tmp_path):
    path = str(tmp_path / "jpeg.klg")
    _write_klg(path, _fixture_payloads(3))
    got = list(tklg.frames(path, W, H, SCALE))
    ref = list(jklg.frames(path, W, H, SCALE))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.timestamp == b.timestamp
        assert a.depth.dtype == b.depth.dtype and a.rgb.dtype == b.rgb.dtype
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)


def test_native_loader_matches_python_reader(lib, tmp_path):
    path = str(tmp_path / "jpeg.klg")
    _write_klg(path, _fixture_payloads(4))
    py = list(tklg.frames(path, W, H, SCALE))
    nat = list(native_loader.frames(path, W, H, SCALE))
    assert native_loader.status()["reader"] == "native"
    assert len(nat) == len(py) == 4
    for a, b in zip(py, nat):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(np.round(a.rgb * 255), np.round(b.rgb * 255))
        np.testing.assert_array_max_ulp(a.rgb, b.rgb, maxulp=1)


BAD_AT = 2


def _bad_klg(path, kind):
    colours = _fixture_payloads(4)
    depths = [zlib.compress(_depth_u16(i).tobytes()) for i in range(4)]
    if kind == "jpeg":
        colours[BAD_AT] = _corrupt(colours[BAD_AT])
    elif kind == "zlib":                        # cut short, the header says so too
        depths[BAD_AT] = depths[BAD_AT][:len(depths[BAD_AT]) // 2]
    elif kind == "size":
        colours[BAD_AT] = _save(_image(H // 2, W // 2), quality=90)
    _write_klg(path, colours, depths, cut_at=BAD_AT if kind == "short" else None)


@pytest.mark.parametrize("kind,cause", [("jpeg", "corrupt JPEG data"), ("zlib", "zlib"),
                                        ("size", "expected 640x480"),
                                        ("short", "colour payload truncated")])
def test_corrupt_frame_raises_in_both_readers(lib, tmp_path, kind, cause):
    path = str(tmp_path / f"bad_{kind}.klg")
    _bad_klg(path, kind)
    for reader in (tklg.frames, native_loader.frames):
        got = []
        with pytest.raises(RuntimeError, match=f"frame {BAD_AT}: .*{cause}"):
            for frame in reader(path, W, H, SCALE):
                got.append(frame)
        assert len(got) == BAD_AT, reader


def test_fixture_digests_match_pillow(lib):
    meta = _fixture_meta()
    assert len(meta) == 20
    total = 0
    for e in meta:
        data = (FIXTURE / e["file"]).read_bytes()
        total += len(data)
        assert len(data) == e["bytes"]
        assert (e["width"], e["height"], e["quality"], e["subsampling"]) == (W, H, 90, "4:2:0")
        ref = _pillow(data)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == e["rgb_sha256"], e["file"]
        np.testing.assert_array_equal(jpeg.decode(data), ref)
    assert total < 1 << 20


def test_progressive_fixture_digests_match_baseline(lib):
    meta = json.loads((PROGRESSIVE_FIXTURE / "digests.json").read_text())["frames"]
    base = _fixture_meta()
    assert len(meta) == len(base) == 20
    total = 0
    for e, b in zip(meta, base):
        data = (PROGRESSIVE_FIXTURE / e["file"]).read_bytes()
        total += len(data)
        assert len(data) == e["bytes"] and b"\xff\xc2" in data and b"\xff\xc0" not in data
        assert (e["width"], e["height"], e["quality"], e["subsampling"]) == (W, H, 90, "4:2:0")
        assert e["rgb_sha256"] == b["rgb_sha256"], e["file"]
        ref = _pillow(data)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == e["rgb_sha256"], e["file"]
        np.testing.assert_array_equal(jpeg.decode(data), ref)
    assert total < 1 << 20
