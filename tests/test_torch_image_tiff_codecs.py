"""ZSTD, LZMA, CCITT and ThunderScan TIFF without Pillow: the port's
``io/tiff`` (``csrc/zstd_decode.cpp``, Python's ``lzma``,
``csrc/fax_decode.cpp``) through ``io/image`` against Pillow 12.1
(``np.asarray(Image.open(...))`` for depth, ``Image.open(...).
convert("RGB")`` for colour, what the JAX package's TUM and ``.klg``
readers call), bit for bit: the array, its dtype and its shape.

- ZSTD (50000) from Pillow's writer and from ``zstandard``: levels 1, 3,
  19 and 22, long-distance matching, checksum on and off, the content size
  left out, incompressible data (raw blocks), constant data (RLE blocks),
  strips of several blocks; a frame followed by a skippable frame, by a
  second frame or by other bytes once it filled the strip;
- LZMA (34925) from Pillow's writer and Python's ``lzma``: presets 0 and
  9 | ``PRESET_EXTREME``, checks none, CRC32, CRC64 and SHA-256, and what
  libtiff reads past (padding, a second stream, a cut index or a bad check
  once the strip is full);
- each under predictors 1-3, both byte orders, strips and tiles, planar
  configuration 2, BigTIFF and YCbCr (1, 1), (2, 2), (4, 2);
- CCITT 2, 3 (1D, 2D, fill bits), 4 and 32771 x photometric 0 / 1 x fill
  order 1 / 2, Pillow's own CCITT writers, tiles, runs past 2560; no
  libtiff message on stderr where the port reads a file;
- ThunderScan (32809) of every code kind;
- the refusals, each naming the file and the tag or strip: what Pillow
  fails on too, and the departures (a CCITT row libtiff pads, a T.6 end of
  block before the strip's last row, RLE/W rows word-aligned from the
  strip's start, which libtiff misreads), which Pillow reads;
- the committed fixture ``tests/data/tiff_codecs`` to its digests.

Encoders: ``tests/torch_tiff_encoder.py`` where Pillow cannot write the
form (big-endian, tiles, RLE/W, ThunderScan, the streams above); every
case at 64x48 or smaller odd sizes, but the several-block ZSTD strips.
"""

import hashlib
import io
import json
import lzma
import os
import tempfile

import numpy as np
import pytest
import zstandard
from PIL import Image
from torch_tiff_encoder import (EOL, LONG, LZMA, SHORT, ZSTD, encode, fax, mh_row, pack_bits,
                                write)

import chip_smoke
from hrbffusion3d_tpu_torch.io import image

H, W = 48, 64


def _depth(h=H, w=W, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed + h * w)
    y, x = np.mgrid[0:h, 0:w]
    d = 4000.0 + 30000.0 * (x / w) + 8000.0 * np.sin(y / 7.0) + rng.normal(0, 40, (h, w))
    return np.clip(np.round(d), 0, 65535).astype(np.uint16)


def _rgb(h=H, w=W, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed + h * w)
    y, x = np.mgrid[0:h, 0:w]
    c = np.stack([40 + 150 * x / w, 30 + 180 * y / h, 128 + 100 * np.sin((x + y) / 9.0)], -1)
    return np.clip(np.round(c + rng.normal(0, 8, (h, w, 3))), 0, 255).astype(np.uint8)


def _bilevel(h=37, w=61, seed=0) -> np.ndarray:
    """Blobs with noise: runs of every short length, both colours first."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    b = np.sin(x / 5.0) + np.cos(y / 4.0) + 0.6 * rng.standard_normal((h, w)) > 0.3
    b[::7] = rng.random((len(b[::7]), w)) < 0.5
    return b.astype(np.uint8)


def _pillow_run(data: bytes, depth: bool):
    """(Pillow's array or None when it fails, what libtiff wrote to
    stderr meanwhile)."""
    saved, sink = os.dup(2), tempfile.TemporaryFile()
    os.dup2(sink.fileno(), 2)
    try:
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im) if depth else np.asarray(im.convert("RGB"))
        a = a != 0 if a.dtype == bool else a.astype(a.dtype.newbyteorder("="))
    except Exception:                      # noqa: BLE001 - any refusal of Pillow's
        a = None
    finally:
        os.dup2(saved, 2)
        os.close(saved)
    sink.seek(0)
    return a, sink.read().decode(errors="replace")


def _same(data: bytes, depth: bool = True) -> np.ndarray:
    """The port equals Pillow, which read the file without a word from
    libtiff."""
    ref, said = _pillow_run(data, depth)
    assert ref is not None and said == "", said
    got = image.decode_depth(data) if depth else image.decode_colour(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    return got


def _refused(tmp_path, name: str, data: bytes, colour: bool = False) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        (image.read_colour if colour else image.read_depth)(str(path))
    assert str(path) in str(e.value)
    return str(e.value)


def _zstd(level=3, **kw):
    return lambda raw: zstandard.ZstdCompressor(level=level, **kw).compress(raw)


def _pillow_save(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _blocks(frame: bytes) -> list:
    """(type, body) of each block of a Zstandard frame (type 0 raw, 1 RLE,
    2 compressed)."""
    fhd = frame[4]
    single, dict_flag, fcs_flag = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    at = 5 + (not single) + (0, 1, 2, 4)[dict_flag] + ((1 if single else 0, 2, 4, 8)[fcs_flag])
    blocks = []
    while True:
        bh = int.from_bytes(frame[at:at + 3], "little")
        kind, size = (bh >> 1) & 3, (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        blocks.append((kind, frame[at + 3:at + 3 + size]))
        at += 3 + size
        if bh & 1:
            return blocks


def _block_types(frame: bytes) -> list:
    return [kind for kind, _ in _blocks(frame)]


def _frame(content_size: int, body: bytes) -> bytes:
    """A single-segment frame of one compressed block (a 4-byte content
    size)."""
    return (b"\x28\xb5\x2f\xfd\xa0" + content_size.to_bytes(4, "little")
            + ((len(body) << 3) | 5).to_bytes(3, "little") + body)


# ------------------------------------------------------------------- ZSTD

ZSTD_STREAMS = {
    "level1": _zstd(1), "level3": _zstd(3), "level19": _zstd(19), "level22": _zstd(22),
    "long_distance": lambda raw: zstandard.ZstdCompressor(
        compression_params=zstandard.ZstdCompressionParameters.from_level(
            19, enable_ldm=True, window_log=20)).compress(raw),
    "checksum": _zstd(3, write_checksum=True),
    "no_checksum_no_size": _zstd(3, write_checksum=False, write_content_size=False),
    "skippable_after": lambda raw: _zstd(3)(raw) + b"\x50\x2a\x4d\x18\x04\0\0\0abcd",
    "second_frame_after": lambda raw: _zstd(3)(raw) + _zstd(3)(raw[:100]),
    "bytes_after": lambda raw: _zstd(3)(raw) + b"not a frame",
    "content_past_the_strip": lambda raw: _zstd(3)(raw + bytes(range(256)) * 8),
    "dictionary_id_0": lambda raw: _with_dict_id(_zstd(3)(raw), 0),
}


def _with_dict_id(frame: bytes, dict_id: int) -> bytes:
    """``frame`` with a 1-byte Dictionary_ID field holding ``dict_id``."""
    fhd = frame[4]
    at = 5 + (0 if (fhd >> 5) & 1 else 1)
    return frame[:4] + bytes([fhd | 1]) + frame[5:at] + bytes([dict_id]) + frame[at:]


@pytest.mark.parametrize("stream", list(ZSTD_STREAMS))
def test_zstd_streams(stream):
    _same(encode(_depth(), compression=ZSTD, predictor=2, rows_per_strip=20,
                 compressor=ZSTD_STREAMS[stream]))


@pytest.mark.parametrize("kind", ["raw", "rle"])
def test_zstd_raw_and_rle_blocks(kind):
    """Incompressible samples make raw blocks, constant ones RLE blocks (but
    for the first block, which libzstd never writes as RLE)."""
    img = (np.random.default_rng(3).integers(0, 256, (H, W), dtype=np.uint8) if kind == "raw"
           else np.full((300, 500), 77, np.uint8))
    frame = _zstd(3)(img.tobytes())
    assert (0 if kind == "raw" else 1) in _block_types(frame)
    _same(encode(img, compression=ZSTD, chunks=[frame]))


# hand-made compressed blocks: RLE literals and no sequences; 32512
# sequences (the 3-byte count), every code in RLE mode, an empty bitstream
# (one literal and a 3-byte match at repeat offset 1 each)
HAND_MADE = {
    "rle_literals": (16, bytes([16 << 3 | 1, 9, 0])),
    "32512_sequences": (130048, (1 | 3 << 2 | 32512 << 4).to_bytes(3, "little")
                        + b"x" + bytes([255, 0, 0, 0x54, 1, 0, 0, 1])),
}


@pytest.mark.parametrize("block", list(HAND_MADE))
def test_zstd_hand_made_blocks(block):
    size, body = HAND_MADE[block]
    img = np.zeros((size // 16, 16), np.uint8)
    _same(encode(img, compression=ZSTD, chunks=[_frame(size, body)]))


def test_zstd_direct_huffman_weights():
    """Literals of two symbols: libzstd writes their Huffman weights as
    4-bit fields (a header byte of 128 or more)."""
    img = np.random.default_rng(0).choice([7, 9], 5000).astype(np.uint8)
    img = np.concatenate([img, np.zeros(120, np.uint8)]).reshape(-1, 40)
    frame = _zstd(1)(img.tobytes())
    kind, body = _blocks(frame)[0]
    assert kind == 2 and body[0] & 3 == 2 and body[3 if (body[0] >> 2) & 3 < 2 else 4] >= 128
    _same(encode(img, compression=ZSTD, chunks=[frame]))


@pytest.mark.parametrize("n", [5, 15, 36])
def test_zstd_checksum_of_short_content(n):
    """XXH64's paths for fewer than 32 bytes and its 4-byte tail."""
    _same(encode(np.arange(n, dtype=np.uint8)[None], compression=ZSTD,
                 compressor=_zstd(3, write_checksum=True)))


@pytest.mark.parametrize("corrupt", [False, True])
def test_zstd_strip_full_at_a_block_end(corrupt):
    """A frame whose first block fills the strip: libzstd decodes the next
    block before it finds no room, so its corruption is an error."""
    d = _depth(256, 256, seed=2)
    frame = bytearray(_zstd(3)(d.tobytes() + (np.arange(3000) % 251).astype(np.uint8).tobytes()))
    assert len(_blocks(bytes(frame))) == 2
    data = encode(d, compression=ZSTD, chunks=[bytes(frame)])
    if not corrupt:
        _same(data)
        return
    frame[-2] ^= 0xFF
    data = encode(d, compression=ZSTD, chunks=[bytes(frame)])
    assert _pillow_run(data, True)[0] is None
    with pytest.raises(ValueError, match="strip 0: ZSTD: sequences"):
        image.decode_depth(data)


@pytest.mark.parametrize("level", [3, 19])
def test_zstd_strips_of_several_blocks(level):
    """Strips of 150 KiB: several 128 KiB blocks, the later ones with the
    earlier tables (treeless literals, repeat modes)."""
    d = _depth(240, 320, seed=1)
    frame = _zstd(level)(d.tobytes())
    assert len(_block_types(frame)) > 1
    _same(encode(d, compression=ZSTD, compressor=_zstd(level)))


def test_zstd_frame_of_a_whole_depth_frame():
    """A 640x480 depth frame in one strip at level 19: blocks of which
    some repeat the FSE tables of the block before."""
    d = _depth(480, 640, seed=1)
    frame = _zstd(19)(d.tobytes())
    modes = [body for kind, body in _blocks(frame) if kind == 2]
    assert len(modes) > 8
    _same(encode(d, compression=ZSTD, chunks=[frame]))


@pytest.mark.parametrize("mode", ["I;16", "L", "RGB", "1"])
@pytest.mark.parametrize("codec", ["zstd", "lzma"])
def test_pillow_writer(codec, mode):
    img = {"I;16": _depth(), "L": (_depth() >> 8).astype(np.uint8), "RGB": _rgb(45, 61),
           "1": _bilevel().astype(bool)}[mode]
    info = {317: 2} if mode in ("I;16", "RGB") else {}
    data = _pillow_save(img, compression=codec, tiffinfo=info)
    _same(data, depth=mode != "RGB")


# ------------------------------------------------------------------- LZMA

@pytest.mark.parametrize("check", [lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_CRC64,
                                   lzma.CHECK_SHA256])
@pytest.mark.parametrize("preset", [0, 9 | lzma.PRESET_EXTREME])
def test_lzma_presets_and_checks(preset, check):
    _same(encode(_depth(), compression=LZMA, predictor=2, rows_per_strip=16,
                 compressor=lambda raw: lzma.compress(raw, check=check, preset=preset)))


def _bad_check(raw: bytes) -> bytes:
    xz = bytearray(lzma.compress(raw))
    xz[-20] ^= 1                      # inside the index: read after the strip is full
    return bytes(xz)


LZMA_READ_PAST = {
    "padding": lambda raw: lzma.compress(raw) + bytes(4),
    "second_stream": lambda raw: lzma.compress(raw) + lzma.compress(raw[:50]),
    "bytes_after": lambda raw: lzma.compress(raw) + b"not xz",
    "content_past_the_strip": lambda raw: lzma.compress(raw + bytes(300)),
    "index_cut": lambda raw: lzma.compress(raw)[:-5],
}


@pytest.mark.parametrize("stream", list(LZMA_READ_PAST))
def test_lzma_read_past_the_strip(stream):
    _same(encode(_depth(), compression=LZMA, rows_per_strip=24,
                 compressor=LZMA_READ_PAST[stream]))


def test_lzma_error_after_the_strip_is_full():
    """A corrupt index once the strip is full: libtiff reports liblzma's
    error and keeps the strip, and so does the port (no message here)."""
    data = encode(_depth(), compression=LZMA, rows_per_strip=24, compressor=_bad_check)
    ref, said = _pillow_run(data, True)
    assert "data is corrupt" in said
    np.testing.assert_array_equal(image.decode_depth(data), ref)


# --------------------------------------------------- predictors and layouts

LAYOUTS = {
    "II_pred1": dict(order="II", predictor=1, rows_per_strip=13),
    "II_pred2": dict(order="II", predictor=2, rows_per_strip=13),
    "MM_pred1": dict(order="MM", predictor=1, rows_per_strip=13),
    "MM_pred2": dict(order="MM", predictor=2, rows_per_strip=13),
    "II_pred2_tiles": dict(order="II", predictor=2, tile=(32, 16)),
    "MM_pred2_tiles": dict(order="MM", predictor=2, tile=(16, 32)),
    "bigtiff_pred2": dict(order="II", predictor=2, bigtiff=True, rows_per_strip=20),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("codec", [ZSTD, LZMA])
def test_depth_layouts(codec, layout):
    _same(encode(_depth(47, 61), compression=codec, **LAYOUTS[layout]))


SAMPLES = {
    "u8_pred2": lambda: ((_depth() >> 8).astype(np.uint8), 2, 1),
    "u32_pred2": lambda: (_depth().astype(np.uint32) * 65537, 2, 1),
    "f32_pred3": lambda: ((_depth().astype(np.float32) * np.float32(0.2)), 3, 1),
    "f32_pred3_MM": lambda: ((_depth().astype(np.float32) * np.float32(0.2)), 3, 1),
}


@pytest.mark.parametrize("samples", list(SAMPLES))
@pytest.mark.parametrize("codec", [ZSTD, LZMA])
def test_sample_formats(codec, samples):
    img, predictor, photometric = SAMPLES[samples]()
    _same(encode(img, "MM" if samples.endswith("MM") else "II", codec, predictor,
                 photometric=photometric, rows_per_strip=11))


@pytest.mark.parametrize("layout", ["strips", "tiles", "planar2", "planar2_tiles", "MM"])
@pytest.mark.parametrize("codec", [ZSTD, LZMA])
def test_rgb_layouts(codec, layout):
    kw = dict(strips=dict(rows_per_strip=9), tiles=dict(tile=(32, 16)),
              planar2=dict(planar=2, rows_per_strip=16),
              planar2_tiles=dict(planar=2, tile=(16, 16)), MM=dict(order="MM"))[layout]
    _same(encode(_rgb(45, 61), compression=codec, predictor=2, photometric=2, **kw), depth=False)


@pytest.mark.parametrize("sub", [(1, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("codec", [ZSTD, LZMA])
def test_ycbcr(codec, tiled, sub):
    ycc = chip_smoke.rgb_to_ycbcr(_rgb(37, 50, seed=2))
    _same(encode(ycc, compression=codec, photometric=6,
                 subsampling=None if sub == (1, 1) else sub, extra={530: (SHORT, list(sub))},
                 **(dict(tile=(16, 16)) if tiled else dict(rows_per_strip=8))), depth=False)


# ------------------------------------------------------------------ CCITT

FAX_FORMS = {"mh": (2, 0), "g3_1d": (3, 0), "g3_1d_fill": (3, 4), "g3_2d": (3, 1),
             "g3_2d_fill": (3, 5), "g4": (4, 0), "rlew": (32771, 0)}


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("form", list(FAX_FORMS))
def test_ccitt(form, photometric, fill_order):
    compression, options = FAX_FORMS[form]
    src = _bilevel()
    data = encode(src, compression=compression, photometric=photometric, bits=1,
                  fill_order=fill_order, fax_options=options, rows_per_strip=16)
    got = _same(data)
    # coded black is bit 1: white for photometric 1 (MinIsBlack) in Pillow
    np.testing.assert_array_equal(got, src != 0 if photometric == 1 else src == 0)


@pytest.mark.parametrize("codec", ["tiff_ccitt", "group3", "group4"])
def test_pillow_ccitt_writer(codec):
    _same(_pillow_save(_bilevel(45, 63, seed=1).astype(bool), compression=codec))


@pytest.mark.parametrize("form", list(FAX_FORMS))
def test_ccitt_tiles_and_long_runs(form):
    compression, options = FAX_FORMS[form]
    _same(encode(_bilevel(seed=2), compression=compression, bits=1, fax_options=options,
                 tile=(32, 16)))
    rows = np.zeros((6, 5200), np.uint8)
    for i, (a, b) in enumerate(((0, 2700), (5, 5199), (2624, 5200), (0, 0), (63, 2687),
                                (1, 4000))):
        rows[i, a:b] = 1
    _same(encode(rows, compression=compression, bits=1, fax_options=options,
                 rows_per_strip=4))


def test_ccitt_rlew_at_an_odd_offset():
    """libtiff word-aligns RLE/W rows by the raw pointer, so a strip at an
    odd file offset reads with other padding; Pillow and the port agree."""
    src = _bilevel(seed=4)
    even, odd = fax(src, 32771), fax(src, 32771, odd=True)
    assert even != odd
    # the strip at offset 9 (the writer's own offsets go to a private tag)
    tags = {256: (LONG, [src.shape[1]]), 257: (LONG, [src.shape[0]]), 258: (SHORT, [1]),
            259: (SHORT, [32771]), 262: (SHORT, [0]), 273: (LONG, [9]),
            278: (LONG, [src.shape[0]]), 279: (LONG, [len(odd)])}
    got = _same(write(tags, [b"\0" + odd], offsets_tag=65000))
    np.testing.assert_array_equal(got, src == 0)


def test_ccitt_g3_bits_before_each_eol():
    """libtiff skips any bits before a T.4 row's EOL without a word; so does
    the port."""
    src = np.random.default_rng(0).random((20, 33)) < 0.5
    bits = "".join("101" + EOL + mh_row(line) for line in src)
    _same(encode(src.astype(np.uint8), compression=3, bits=1, chunks=[pack_bits(bits)]))


def test_ccitt_2d_every_other_row_1d():
    """Group 3 2D with K = 2 (a 1D row every second row) and K = 4."""
    src = _bilevel(seed=3)
    for k in (2, 4):
        chunks = [fax(src[y:y + 16], 3, 1, k=k) for y in range(0, len(src), 16)]
        _same(encode(src, compression=3, bits=1, fax_options=1, rows_per_strip=16,
                     chunks=chunks))


# ------------------------------------------------------------- ThunderScan

@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("seed", range(4))
def test_thunderscan(seed, photometric):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:29, 0:37]
    img = np.clip(np.round(7 + 3 * np.sin(x / 4.0) + rng.normal(0, 0.7, x.shape)), 0, 15)
    img = img.astype(np.uint8)
    img[5:9, 3:30] = 9
    img[:, 30:] = 4                   # runs that end the rows
    data = encode(img, compression=32809, photometric=photometric, bits=4, rows_per_strip=7)
    got = _same(data)
    np.testing.assert_array_equal(got, img * 17 if photometric == 1 else 255 - img * 17)


@pytest.mark.parametrize("codes", ["c509", "c50868", "c5c600c707", "c50009", "c5c6c7005b9503"])
def test_thunderscan_codes(codes):
    """Hand-made rows of 10 pixels: a run ending the row, a run at an odd
    pixel, a run of 0 at an odd pixel, 2- and 3-bit deltas with skips."""
    img = np.zeros((3, 10), np.uint8)
    _same(encode(img, compression=32809, bits=4, rows_per_strip=3,
                 chunks=[bytes.fromhex(codes) * 3]))


# --------------------------------------------------------------- refusals

def _fax_chunks(src, compression, first: bytes) -> list:
    return [first] + [fax(src[y:y + 16], compression) for y in range(16, len(src), 16)]


def test_refusals_pillow_fails_too(tmp_path):
    d = _depth()
    raw = d.tobytes()
    frame = _zstd(3)(raw)
    checked = bytearray(_zstd(3, write_checksum=True)(raw))
    checked[-1] ^= 1
    reserved = bytearray(frame)
    reserved[4] |= 8
    half = len(raw) // 2
    zstd_bad = {
        "two_frames": (_zstd(3)(raw[:half]) + _zstd(3)(raw[half:]), "ends after 3072"),
        "skippable_first": (b"\x50\x2a\x4d\x18\x04\0\0\0abcd" + frame, "skippable frame"),
        "checksum": (bytes(checked), "checksum"),
        "reserved_bit": (bytes(reserved), "reserved bit"),
        "dictionary": (_with_dict_id(frame, 7), "dictionary 7"),
        "truncated": (frame[:-40], "ends after"),
        "short": (_zstd(3)(raw[:-6]), "ends after 6138"),
        "not_zstd": (b"\0\1\2\3" + frame, "not a Zstandard frame"),
    }
    for name, (stream, why) in zstd_bad.items():
        data = encode(d, compression=ZSTD, chunks=[stream])
        assert _pillow_run(data, True)[0] is None, name
        msg = _refused(tmp_path, f"zstd_{name}.tif", data)
        assert "strip 0: ZSTD" in msg and why in msg, msg
    lzma_bad = {
        "two_streams": lzma.compress(raw[:half]) + lzma.compress(raw[half:]),
        "short": lzma.compress(raw[:-3]),
        "alone": lzma.compress(raw, format=lzma.FORMAT_ALONE),
        "raw": lzma.compress(raw, format=lzma.FORMAT_RAW, filters=[{"id": lzma.FILTER_LZMA2}]),
        "cut": lzma.compress(raw)[:200],
    }
    for name, stream in lzma_bad.items():
        data = encode(d, compression=LZMA, chunks=[stream])
        assert _pillow_run(data, True)[0] is None, name
        assert "strip 0: LZMA" in _refused(tmp_path, f"lzma_{name}.tif", data)
    src = _bilevel()
    mh_short = encode(src, compression=2, bits=1, rows_per_strip=16,
                      chunks=_fax_chunks(src, 2, fax(src[:10], 2)))
    thunder = np.zeros((3, 10), np.uint8)
    others = {
        "mh_short": (mh_short, "strip 0: CCITT 1D: row 10"),
        "thunder_too_much": (encode(thunder, compression=32809, bits=4, rows_per_strip=3,
                                    chunks=[bytes.fromhex("c50c") * 3]),
                             "strip 0: ThunderScan: row 0: too much"),
        "thunder_not_enough": (encode(thunder, compression=32809, bits=4, rows_per_strip=3,
                                      chunks=[bytes.fromhex("c505")]),
                               "strip 0: ThunderScan: row 0: not enough"),
        "thunder_tiles": (encode(thunder, compression=32809, bits=4, tile=(16, 16)),
                          "tag 259) = 32809: ThunderScan in tiles"),
        "thunder_8bit": (encode(thunder, compression=32809), "tag 259) = 32809"),
        "sgilog_34676": (encode(d, compression=34676, chunks=[bytes(64)]),
                         "not a form Pillow opens"),
        "sgilog_34677": (encode(d, compression=34677, chunks=[bytes(64)]),
                         "not a form Pillow opens"),
        "webp": (encode(_rgb(8, 8), compression=50001, photometric=2,
                        chunks=[_webp(_rgb(8, 8))]), "not a form Pillow opens"),
    }
    for name, (data, why) in others.items():
        assert _pillow_run(data, True)[0] is None, name
        assert why in _refused(tmp_path, f"{name}.tif", data), name


def _webp(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", lossless=True)
    return buf.getvalue()


def test_departures_pillow_reads(tmp_path):
    """Where libtiff pads a damaged row (and says so, or not), leaves rows
    unwritten or misreads word-aligned RLE/W rows, Pillow returns an image;
    the port refuses, naming the strip and the row (ROADMAP Queue 3
    "Departures")."""
    src = _bilevel()
    damaged = bytearray(fax(src[:16], 3))
    damaged[len(damaged) // 2] ^= 0x10
    damaged4 = bytearray(fax(src[:16], 4))
    damaged4[5] ^= 0x40
    cases = {
        "g3_damaged_row": (encode(src, compression=3, bits=1, rows_per_strip=16,
                                  chunks=_fax_chunks(src, 3, bytes(damaged))),
                           "strip 0: CCITT group 3: row"),
        "g3_data_ends": (encode(src, compression=3, bits=1, rows_per_strip=16,
                                chunks=_fax_chunks(src, 3, fax(src[:10], 3, rtc=False))),
                         "strip 0: CCITT group 3: row 10: the data ends"),
        "g4_damaged_row": (encode(src, compression=4, bits=1, rows_per_strip=16,
                                  chunks=_fax_chunks(src, 4, bytes(damaged4))),
                           "strip 0: CCITT group 4: row"),
        "g4_early_end_of_block": (encode(src, compression=4, bits=1, rows_per_strip=16,
                                         chunks=_fax_chunks(src, 4, fax(src[:8], 4))),
                                  "row 8: an end of block"),
        "rlew_words": (encode(src, compression=32771, bits=1, rows_per_strip=16,
                              chunks=[fax(src[y:y + 16], 32771, rlew="words")
                                      for y in range(0, len(src), 16)]),
                       "strip 0: CCITT RLE/W: row"),
    }
    for name, (data, why) in cases.items():
        ref, _ = _pillow_run(data, True)
        assert ref is not None and ref.shape == src.shape, name
        assert why in _refused(tmp_path, f"{name}.tif", data), name


# ---------------------------------------------------------------- fixture

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tiff_codecs")
with open(os.path.join(FIXTURE, "digests.json")) as _f:
    FIXTURE_ENTRIES = json.load(_f)["frames"]


@pytest.mark.parametrize("entry", FIXTURE_ENTRIES, ids=lambda e: e["file"])
def test_fixture_digests(entry):
    """The TIFF-codecs fixture (``chip_smoke`` run_tum (l)): Pillow and the
    port each decode every file to its digest."""
    with open(os.path.join(FIXTURE, entry["file"]), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"]
    depth = entry["kind"] == "depth"
    key = "depth_sha256" if depth else "rgb_sha256"
    got = image.decode_depth(data) if depth else image.decode_colour(data)
    for a in (_pillow_run(data, depth)[0], got):
        assert hashlib.sha256(a.tobytes()).hexdigest() == entry[key]
