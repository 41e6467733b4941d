"""The PNG forms that Pillow reads and the port's ``io/png`` decodes,
held against the JAX package's TUM reader (Pillow).

- Adam7 interlacing for every colour type and bit depth that the PNG
  standard allows, on sizes that leave passes empty (1x1, 2x3, 7x5) and on
  30x41, every pass's rows cycling through the five filters; the bytes come
  from the encoder below, since Pillow cannot write interlaced PNG;
- palette at 1, 2, 4 and 8 bits, with and without ``tRNS``; 1-, 2- and
  4-bit grey; 16-bit RGB, RGBA and grey + alpha (Pillow keeps the high
  byte) and 16-bit grey as colour (Pillow's ``I;16`` -> RGB clamps at 255);
- each case: ``io/png.decode`` equals ``np.asarray(Image.open(...))``, and
  the port's TUM ``load_frame`` equals ``hrbffusion3d_tpu/io/tum.py``'s
  bit for bit, with the case as the colour file and, for grey, as the
  depth file;
- forms that Pillow refuses too (16-bit palette, colour type 5, 3-bit
  grey) raise ``ValueError`` naming them.
"""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from hrbffusion3d_tpu.io import tum as jtum
from hrbffusion3d_tpu_torch.io import png
from hrbffusion3d_tpu_torch.io import tum as ttum

# the standard's Adam7 passes: (first row, first column, row step, column step)
PASSES = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7_SIZES = ((1, 1), (2, 3), (7, 5), (30, 41))
H, W = 30, 41


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) sample values -> (h, stride) bytes, most significant bits first."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, -n % per))).reshape(h, -1, per).astype(np.int64)
    return (s << (8 - depth * (np.arange(per) + 1))).sum(-1).astype(np.uint8)


def _filtered(cur: np.ndarray, prev: np.ndarray, bpp: int, f: int) -> np.ndarray:
    """One row under filter type ``f`` (the standard's definitions)."""
    n = len(cur)
    a, c = np.zeros_like(cur), np.zeros_like(prev)
    a[bpp:] = cur[:max(n - bpp, 0)]
    c[bpp:] = prev[:max(n - bpp, 0)]
    b = prev
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = (np.zeros_like(cur), a, b, (a + b) // 2, paeth)[f]
    return ((cur - pred) % 256).astype(np.uint8)


def encode(samples: np.ndarray, depth: int, colour: int, interlace: bool,
           palette: np.ndarray | None = None, trns: bytes | None = None) -> bytes:
    """(h, w, channels) sample values -> PNG bytes, non-interlaced or Adam7,
    the rows of all passes cycling through filter types 0-4."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = bytearray()
    k = 0
    for r0, c0, dr, dc in (PASSES if interlace else ((0, 0, 1, 1),)):
        sub = samples[r0::dr, c0::dc]
        if sub.size == 0:
            continue
        rows = _packed(sub.reshape(sub.shape[0], -1), depth).astype(np.int64)
        prev = np.zeros(rows.shape[1], np.int64)
        for row in rows:
            data.append(k % 5)
            data += _filtered(row, prev, bpp, k % 5).tobytes()
            prev = row
            k += 1
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                             0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(bytes(data))) + _chunk(b"IEND", b"")


def _case(colour: int, depth: int, h: int, w: int, seed: int = 0, trns: bool = False,
          n_palette: int | None = None):
    """PNG bytes of random samples of the form."""
    rng = np.random.default_rng(seed)
    palette, t = None, None
    if colour == 3:
        n_palette = n_palette or min(1 << depth, 200)
        palette = rng.integers(0, 256, (n_palette, 3))
        samples = rng.integers(0, 1 << depth, (h, w, 1))      # some indices beyond PLTE
        t = bytes(rng.integers(0, 256, n_palette // 2 + 1).astype(np.uint8)) if trns else None
    else:
        samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[colour]))
    return encode(samples, depth, colour, False, palette, t), samples, palette


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _check(tmp_path, data: bytes, as_depth: bool):
    """png.decode against Pillow; the port's TUM load_frame against the JAX
    package's with ``data`` as the colour file (and as the depth file)."""
    got, ref = png.decode(data), _pillow(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    (tmp_path / "case.png").write_bytes(data)
    (tmp_path / "depth.png").write_bytes(png.encode(np.full((3, 4), 1234, np.uint16)))
    (tmp_path / "colour.png").write_bytes(png.encode(np.zeros((3, 4, 3), np.uint8)))
    pairs = [("case.png", "depth.png")] + ([("colour.png", "case.png")] if as_depth else [])
    for rgb_p, depth_p in pairs:
        with warnings.catch_warnings():      # Pillow's note on palette transparency
            warnings.simplefilter("ignore", UserWarning)
            want = jtum.load_frame(str(tmp_path), rgb_p, depth_p, 2.5)
        have = ttum.load_frame(str(tmp_path), rgb_p, depth_p, 2.5)
        assert have.timestamp == want.timestamp
        for a, b in ((have.rgb, want.rgb), (have.depth, want.depth)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


ADAM7_CASES = [(c, d, hw) for c, ds in DEPTHS.items() for d in ds for hw in ADAM7_SIZES]


@pytest.mark.parametrize("colour,depth,hw", ADAM7_CASES,
                         ids=[f"ct{c}-{d}bit-{w}x{h}" for c, d, (h, w) in ADAM7_CASES])
def test_adam7_matches_jax_reader(tmp_path, colour, depth, hw):
    h, w = hw
    rng = np.random.default_rng(depth * 10 + colour)
    palette = rng.integers(0, 256, (1 << depth, 3)) if colour == 3 else None
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[colour]))
    data = encode(samples, depth, colour, True, palette)
    plain = encode(samples, depth, colour, False, palette)
    np.testing.assert_array_equal(png.decode(data), png.decode(plain))
    _check(tmp_path, data, as_depth=colour == 0)


@pytest.mark.parametrize("depth", (1, 2, 4, 8))
@pytest.mark.parametrize("trns", (False, True), ids=("plain", "trns"))
def test_palette_matches_jax_reader(tmp_path, depth, trns):
    data, samples, palette = _case(3, depth, H, W, seed=depth, trns=trns,
                                   n_palette=max(1, (1 << depth) - 1))
    np.testing.assert_array_equal(png.decode(data), samples[..., 0])
    want = np.zeros((256, 3), np.uint8)
    want[:len(palette)] = palette
    np.testing.assert_array_equal(png.decode_rgb(data), want[samples[..., 0]])
    _check(tmp_path, data, as_depth=False)


@pytest.mark.parametrize("depth", (1, 2, 4))
def test_low_bit_grey_matches_jax_reader(tmp_path, depth):
    data, samples, _ = _case(0, depth, H, W, seed=depth)
    scaled = samples[..., 0] * (255 // ((1 << depth) - 1))
    np.testing.assert_array_equal(png.decode_rgb(data)[..., 1], scaled)
    _check(tmp_path, data, as_depth=True)


@pytest.mark.parametrize("colour", (2, 4, 6), ids=("rgb", "grey_alpha", "rgba"))
def test_16bit_colour_matches_jax_reader(tmp_path, colour):
    data, samples, _ = _case(colour, 16, H, W, seed=colour)
    np.testing.assert_array_equal(png.decode_rgb(data),
                                  (samples[..., [0, 0, 0] if colour == 4 else [0, 1, 2]] >> 8))
    _check(tmp_path, data, as_depth=False)


def test_16bit_grey_colour_clamps_at_255(tmp_path):
    """Pillow opens 16-bit grey as ``I;16``, whose RGB conversion clamps
    each sample at 255 rather than taking its high byte."""
    rng = np.random.default_rng(16)
    grey = rng.integers(0, 1 << 16, (H, W))
    grey[0, :8] = (0, 1, 200, 254, 255, 256, 511, 65535)
    grey[1] = rng.integers(0, 300, W)
    data = encode(grey[..., None], 16, 0, False)
    rgb = png.decode_rgb(data)
    np.testing.assert_array_equal(rgb[0, :8, 0], (0, 1, 200, 254, 255, 255, 255, 255))
    np.testing.assert_array_equal(rgb, np.repeat(np.minimum(grey, 255)[..., None], 3, -1))
    _check(tmp_path, data, as_depth=True)
    _check(tmp_path, encode(grey[..., None], 16, 0, True), as_depth=True)


@pytest.mark.parametrize("depth,colour,cause", [(16, 3, "bit depth 16 is not defined"),
                                                (8, 5, "colour type 5"),
                                                (3, 0, "bit depth 3 is not defined")])
def test_forms_pillow_refuses_raise(depth, colour, cause):
    rows = np.zeros((2, 5), np.uint8)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 2, depth, colour, 0, 0, 0))
            + _chunk(b"PLTE", bytes(6))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match=cause):
        png.decode(data)
