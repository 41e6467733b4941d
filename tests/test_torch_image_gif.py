"""GIF without Pillow: the port's ``io/gif`` (``csrc/gif_decode.cpp``)
through ``io/image`` against Pillow 12.1 (``Image.open(...).
convert("RGB")`` and ``np.asarray(Image.open(...))``, what the JAX
package's TUM and ``.klg`` readers call), bit for bit: the mode, the array
and the RGB of frame 0.

- Pillow's writer: palettes of 2-256 colours, greyscale, transparency,
  interlace on and off, odd sizes, animations;
- ``tests/torch_gif_encoder.py``: minimum code sizes 0-12, no first clear
  code, a deferred clear (12-bit codes once the table is full), clears
  anywhere, local palettes (a grey-ramp one gives mode ``L`` mapped
  through the global palette), a frame rectangle inside the screen, past
  it (the screen grows) and of zero width at x 0 (the whole screen), the
  fill outside it (the transparent index, else 0), indices past the
  palette, extensions and stray bytes before the image, GIF87a;
- refusals (Pillow fails too): a truncated screen, palette, descriptor or
  LZW data, no image, a code size above 12, broken codes, an end code
  before the frame is full; and the departure: past 64 KiB of data Pillow
  decodes on after such an end code, the port raises;
- ``image.form`` in Pillow's plugin order; a GIF read as depth (mode
  ``P`` indices, mode ``L`` values);
- a ``.klg`` with GIF colour through ``io/klg.frames`` against the JAX
  reader, and the native loader naming the form;
- the committed fixture ``tests/data/webp_gif`` to its digests.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch_gif_encoder as g
from PIL import Image

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu_torch.io import image, klg, native_loader

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "webp_gif")
RAMP = bytes(v for i in range(256) for v in (i, i, i))


def _pillow(data: bytes):
    """(mode, np.asarray, convert("RGB")) of Pillow, or None when it fails."""
    try:
        im = Image.open(io.BytesIO(data))
        return im.mode, np.asarray(im), np.asarray(im.convert("RGB"))
    except Exception:                      # noqa: BLE001 - any refusal of Pillow's
        return None


def _same(data: bytes) -> np.ndarray:
    """The port equals Pillow: the mode, the array (``read_depth`` too, the
    file having one band) and the RGB."""
    ref = _pillow(data)
    assert ref is not None
    mode, arr, _ = image._decode_mode(data)
    assert mode == ref[0]
    assert arr.shape == ref[1].shape and arr.tobytes() == ref[1].tobytes()
    assert image.decode_depth(data).tobytes() == ref[1].tobytes()
    rgb = image.decode_colour(data)
    assert rgb.shape == ref[2].shape and rgb.tobytes() == ref[2].tobytes()
    return arr


def _refused(tmp_path, name: str, data: bytes) -> str:
    """Pillow fails on the file, and the port raises naming it."""
    assert _pillow(data) is None
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        image.read_colour(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


def _indices(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """Blobs and noise: runs and repeats of every length."""
    rng = np.random.default_rng(seed * 7919 + h * w + n)
    y, x = np.mgrid[0:h, 0:w]
    v = (np.sin(x / 5.0) + np.cos(y / 3.0) + 2) * n / 4 + rng.normal(0, n / 8 + 0.3, (h, w))
    return np.clip(v, 0, n - 1).astype(np.uint8)


def _palette(n: int, seed: int) -> bytes:
    return bytes(np.random.default_rng(seed).integers(0, 256, 3 * n, dtype=np.uint8))


# ------------------------------------------------------------------ Pillow's writer

@pytest.mark.parametrize("colours", [2, 3, 16, 64, 256])
def test_pillow_writer(colours):
    rng = np.random.default_rng(colours)
    for h, w in ((1, 1), (1, 23), (19, 1), (17, 31), (48, 64)):
        rgb = np.clip(np.stack(np.mgrid[0:h, 0:w], -1).sum(-1)[..., None] * [3, 5, 7]
                      + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
        p = Image.fromarray(rgb).quantize(colours)
        for kw in (dict(), dict(interlace=False), dict(optimize=False),
                   dict(transparency=min(1, colours - 1))):
            buf = io.BytesIO()
            p.save(buf, format="GIF", **kw)
            _same(buf.getvalue())
        buf = io.BytesIO()
        Image.fromarray(rgb[..., 0]).save(buf, format="GIF", optimize=False)
        _same(buf.getvalue())


def test_pillow_animation_frame_0():
    frames = [Image.fromarray(_indices(27, 35, 8, k)).convert("P") for k in range(3)]
    for im in frames:
        im.putpalette(_palette(8, 1))
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=50,
                   loop=0, disposal=2)
    _same(buf.getvalue())


# ------------------------------------------------------------------ the LZW stream

@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_code_sizes_and_clears(bits):
    n = 1 << bits
    for h, w in ((1, 1), (5, 7), (29, 43), (90, 97)):
        idx = _indices(h, w, n, bits)
        pal = _palette(n, bits)
        for interlace in (False, True):
            for lzw in (dict(), dict(clear_first=False), dict(clear_when_full=False),
                        dict(clear_at=(1, 2, 3, h * w // 2, h * w // 2 + 1))):
                _same(g.gif(w, h, [g.frame(idx, bits=bits, interlace=interlace, **lzw)], pal))


def test_deferred_clear_and_long_strings():
    """Past 4096 entries with no clear the codes stay at 12 bits and the
    table grows no more; long runs make strings up to the table's longest."""
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 256, (120, 130)).astype(np.uint8)
    runs = np.zeros((200, 250), np.uint8)
    runs[::7] = rng.integers(0, 256, (len(runs[::7]), 250))
    for idx in (noise, runs):
        for lzw in (dict(), dict(clear_when_full=False)):
            h, w = idx.shape
            _same(g.gif(w, h, [g.frame(idx, **lzw)], RAMP[::-1]))


def test_code_sizes_0_1_and_12():
    """Pillow takes minimum code sizes 0 and 1 (its code size never grows
    there) and 12 (13-bit codes, no entry ever added)."""
    pal = _palette(4, 0)
    for bits in (0, 1, 12):
        clear = 1 << bits
        codes = [(clear, bits + 1)] + [(0, bits + 1)] * 35 + [(clear + 1, bits + 1)]
        _same(g.gif(7, 5, [b",\0\0\0\0\7\0\5\0\0" + bytes([bits]) + g.pack(codes)], pal))


# ------------------------------------------------------------------ the container

def test_palettes_and_modes():
    idx = _indices(13, 17, 4, 0)
    pal, ramp = _palette(4, 3), RAMP[:12]
    cases = {
        "global": g.gif(17, 13, [g.frame(idx, bits=2)], pal),
        "local": g.gif(17, 13, [g.frame(idx, bits=2, local=pal)]),
        "local over global": g.gif(17, 13, [g.frame(idx, bits=2, local=pal)], _palette(4, 9)),
        "no palette": g.gif(17, 13, [g.frame(idx, bits=2)]),
        "grey ramp": g.gif(17, 13, [g.frame(idx, bits=2)], ramp),
        "local grey ramp": g.gif(17, 13, [g.frame(idx, bits=2, local=ramp)], pal),
        "local grey ramp alone": g.gif(17, 13, [g.frame(idx, bits=2, local=ramp)]),
        "past the palette": g.gif(17, 13, [g.frame(idx * 3, bits=4)], pal),
        "GIF87a": g.gif(17, 13, [g.frame(idx, bits=2)], pal, version=b"GIF87a"),
    }
    modes = {name: _same(data) is not None and _pillow(data)[0] for name, data in cases.items()}
    assert modes["global"] == modes["local"] == "P"
    assert modes["grey ramp"] == modes["no palette"] == modes["local grey ramp"] == "L"
    # a local grey ramp: mode L, yet convert("RGB") maps through the global palette
    rgb = image.decode_colour(cases["local grey ramp"])
    assert rgb[0, 0].tolist() == list(pal[3 * idx[0, 0]:3 * idx[0, 0] + 3])


def test_frame_rectangles_and_fill():
    idx = _indices(6, 9, 16, 1)
    pal = _palette(16, 4)
    for x, y, gce in ((0, 0, None), (3, 2, None), (3, 2, (1, 7)), (5, 4, (1, 15)),
                      (20, 11, None), (20, 11, (1, 2)), (3, 2, (0, 9))):
        _same(g.gif(24, 14, [g.frame(idx, x, y, bits=4, gce=gce)], pal))
    # zero width at x 0: Pillow decodes the whole screen
    _same(g.gif(9, 6, [g.frame(idx, 0, 0, bits=4, width=0)], pal))


def test_extensions_and_stray_bytes():
    idx = _indices(11, 14, 4, 2)
    pal = _palette(4, 5)
    frame = g.frame(idx, bits=2, gce=(1, 3))
    for ext in (g.comment(b"hello") + g.netscape_loop(3), g.netscape_loop(0) + g.comment(b""),
                b"!\xff\x0bXMP DataXMP\x02ab\x01c\0", b"!\x01\x0c" + bytes(12) + b"\0",
                b"\x07\x00junk", b"!\xf9\x04\x00\x00\x00\x05\0"):
        _same(g.gif(14, 11, [frame], pal, extensions=ext))
    _same(g.gif(14, 11, [frame, g.frame(idx[::-1].copy(), bits=2)], pal))


def test_form_in_pillows_plugin_order():
    """GIF is tried in ``Image.open``'s first pass, after BMP and DIB and
    before JPEG."""
    Image.preinit()
    ids = list(Image.ID)
    assert ids.index("DIB") < ids.index("GIF") < ids.index("JPEG")
    data = g.gif(3, 2, [g.frame(np.zeros((2, 3), np.uint8), bits=2)], _palette(4, 0))
    assert image.form(data) == Image.open(io.BytesIO(data)).format == "GIF"
    assert image.form(b"GIF88a" + bytes(20)) is None
    assert image.needs_library(data[:64])


# ------------------------------------------------------------------ refusals

def test_refusals(tmp_path):
    idx = _indices(20, 30, 16, 3)
    pal = _palette(16, 6)
    good = g.gif(30, 20, [g.frame(idx, bits=4)], pal)
    at = good.index(b",", 13 + 48)
    assert "truncated" in _refused(tmp_path, "screen.gif", good[:11])
    assert "no image" in _refused(tmp_path, "palette.gif", good[:13 + 20])
    # a grey ramp cut inside an entry: Pillow's palette test itself fails
    ramp = g.gif(30, 20, [g.frame(idx, bits=4)], RAMP[:48])
    assert "truncated" in _refused(tmp_path, "ramp.gif", ramp[:13 + 20])
    assert "truncated" in _refused(tmp_path, "descriptor.gif", good[:at + 5])
    assert "ends at pixel" in _refused(tmp_path, "lzw.gif", good[:-30])
    assert "no image" in _refused(tmp_path, "none.gif", good[:at] + b";")
    assert "no image" in _refused(tmp_path, "empty.gif", b"GIF89a" + bytes(64))
    assert "code size 13" in _refused(tmp_path, "bits.gif", good[:at + 10] + b"\x0d"
                                      + good[at + 11:])
    assert "end code at pixel" in _refused(tmp_path, "eoi.gif", g.gif(
        30, 20, [g.frame(idx, bits=4, stop_at=100)], pal))
    assert "beyond the table" in _refused(tmp_path, "code.gif", g.gif(30, 20, [
        b",\0\0\0\0\x1e\0\x14\0\0\x04" + g.pack([(16, 5), (3, 5), (30, 5)])], pal))
    assert "after a clear" in _refused(tmp_path, "first.gif", g.gif(30, 20, [
        b",\0\0\0\0\x1e\0\x14\0\0\x04" + g.pack([(16, 5), (18, 5)])], pal))
    assert "outside image" in _refused(tmp_path, "width.gif", g.gif(30, 20, [
        g.frame(idx, 4, 0, bits=4, width=0)], pal))
    assert "truncated" in _refused(tmp_path, "gce.gif", g.gif(
        30, 20, [g.frame(idx, bits=4)], pal, extensions=b"!\xf9\x01\x01\0"))


def test_departure_end_code_with_64k_to_come(tmp_path):
    """An end code before the frame is full: with less than 64 KiB of data
    left Pillow fails ("image file is truncated"), as the port does; with
    more it reads on past the end code and returns the frame (a departure,
    ``ROADMAP.md`` Queue 3): the port raises, naming the pixel."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 256, (280, 320)).astype(np.uint8)
    data = g.gif(320, 280, [g.frame(idx, eoi_at=2000)], RAMP[::-1])
    ref = _pillow(data)
    assert ref is not None and ref[1].tobytes() == idx.tobytes()
    path = tmp_path / "eoi_64k.gif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"eoi_64k.gif: GIF frame 0: LZW end code at pixel"):
        image.read_colour(str(path))


# ------------------------------------------------------------------ .klg

def test_klg_gif_payloads_match_jax(tmp_path):
    h, w = 24, 32
    pal = _palette(16, 2)
    payloads = [g.gif(w, h, [g.frame(_indices(h, w, 16, k), bits=4, interlace=k == 1)], pal)
                for k in range(2)]
    buf = io.BytesIO()
    Image.fromarray(_indices(h, w, 200, 3)).save(buf, format="GIF")
    payloads.append(buf.getvalue())
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
    with pytest.raises(RuntimeError, match=r"frame 0: GIF colour payload: this loader decodes "
                                           r"JPEG colour only \(io/klg.frames reads GIF"):
        list(native_loader.frames(str(path), w, h))


# ------------------------------------------------------------------ fixture

with open(os.path.join(FIXTURE, "digests.json")) as _f:
    FIXTURE_ENTRIES = [e for e in json.load(_f)["frames"] if e["file"].endswith(".gif")]


@pytest.mark.parametrize("entry", FIXTURE_ENTRIES, ids=lambda e: e["file"])
def test_fixture_digests(entry):
    """The GIF files of the fixture (``chip_smoke`` run_tum (m)): Pillow
    and the port each decode every file to its digest (colour through
    ``convert("RGB")``, depth as ``np.asarray``)."""
    with open(os.path.join(FIXTURE, entry["file"]), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"]
    ref = _pillow(data)
    assert ref[0] == entry["mode"] == image._decode_mode(data)[0]
    depth = entry["kind"] == "depth"
    key = "depth_sha256" if depth else "rgb_sha256"
    got = image.decode_depth(data) if depth else image.decode_colour(data)
    for a in (ref[1] if depth else ref[2], got):
        assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest() == entry[key]
