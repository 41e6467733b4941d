"""The port's IO against the JAX package's and against Pillow.

- ``io/png``: decoding equals Pillow bit for bit, on PNGs that Pillow
  writes (its adaptive row filters) and on the port writer's five filter
  types and a per-row mix of them; Pillow reads the port writer's files
  back exactly;
- ``io/tum``, ``io/klg`` and ``utils/params``: the same numpy as the JAX
  package's, so their results are equal; a TUM-layout sequence with JPEG
  colour (baseline and progressive) reads, through ``frames`` and
  ``frames_prefetched``, as the JAX reader (Pillow) reads it;
- ``io/native_loader``: built by the test from the port's
  ``csrc/klg_loader.cpp`` and ``csrc/jpeg_decode.cpp`` with the host
  compiler, its frames equal the port's Python reader's: timestamps and
  depth bit for bit, colour bytes bit for bit and colour floats within one
  float32 ulp (the library scales by 1/255 as a product, the Python reader
  divides by 255); a JPEG colour payload decodes in both to Pillow's bytes;
- a PNG colour payload (RGB, palette, grey with alpha, beside JPEG and raw
  frames) reads in the port's ``klg.frames`` as JAX's reads it (Pillow); a
  PNG of another size raises naming the frame, and the native loader,
  which decodes JPEG colour only, raises naming the PNG payload.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu.io import tum as jtum
from hrbffusion3d_tpu.utils import params as jparams
from hrbffusion3d_tpu_torch.io import klg as tklg
from hrbffusion3d_tpu_torch.io import native_loader, png
from hrbffusion3d_tpu_torch.io import tum as ttum
from hrbffusion3d_tpu_torch.utils import params as tparams
from torch_parity_utils import port_cfg

RNG = np.random.default_rng(3)
H, W = 30, 41
_yy, _xx = np.mgrid[0:H, 0:W]
RGB = np.stack([(_xx * 5 + _yy * 3) % 256, (_xx * 2 + RNG.integers(0, 40, (H, W))) % 256,
                (_yy * 7) % 256], -1).astype(np.uint8)
DEPTH = ((np.sin(_xx / 6.0) + 2.0) * 9000 + RNG.integers(0, 400, (H, W))).astype(np.uint16)
DEPTH[::7, ::5] = 0


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pillow_png(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["rgb", "depth16", "grey", "rgba"])
@pytest.mark.parametrize("filters", ["pillow", 0, 1, 2, 3, 4, "per_row", "least_sum"])
def test_png_decode_matches_pillow(kind, filters):
    img = {"rgb": RGB, "depth16": DEPTH, "grey": RGB[..., 1],
           "rgba": np.concatenate([RGB, RGB[..., :1]], -1)}[kind]
    if filters == "pillow":
        data = _pillow_png(img)
    else:
        rows = {"per_row": np.arange(H) % 5, "least_sum": None}.get(filters, filters)
        data = png.encode(img, filters=rows)
        np.testing.assert_array_equal(_pillow(data), img)
        if filters == "per_row":
            filt = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:-16]),
                                 np.uint8).reshape(H, -1)[:, 0]
            np.testing.assert_array_equal(filt, np.arange(H) % 5)
    out = png.decode(data)
    ref = _pillow(data)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_png_rejects_corrupt_and_unsupported():
    data = bytearray(png.encode(RGB))
    data[40] ^= 0xFF                        # inside IDAT: its CRC fails
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(20))
    # forms that Pillow refuses too: a 16-bit palette, colour type 5
    for depth, colour, cause in ((16, 3, "bit depth 16 is not defined for colour type 3"),
                                 (8, 5, "colour type 5 is not defined")):
        bad = bytearray(png.encode(RGB[..., 0]))
        bad[24:26] = bytes((depth, colour))
        bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])))
        with pytest.raises(Exception):
            Image.open(io.BytesIO(bytes(bad))).load()
        with pytest.raises(ValueError, match=cause):
            png.decode(bytes(bad))


def _write_tum(root, writer):
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    lines = []
    for i in range(5):
        rgb = np.roll(RGB, i, axis=1)
        depth = np.roll(DEPTH, i, axis=0)
        writer(root / "rgb" / f"{i}.png", rgb)
        writer(root / "depth" / f"{i}.png", depth)
        # the depth-first association variant on odd lines
        lines.append(f"{i}.0 rgb/{i}.png {i}.0 depth/{i}.png" if i % 2 == 0
                     else f"{i}.0 depth/{i}.png {i}.0 rgb/{i}.png")
    (root / "associations.txt").write_text("# comment\n" + "\n".join(lines))


@pytest.mark.parametrize("writer", ["pillow", "port"])
def test_tum_frames_match_jax(tmp_path, writer):
    write = ((lambda p, a: Image.fromarray(a).save(p)) if writer == "pillow"
             else (lambda p, a: png.write(str(p), a, filters=np.arange(a.shape[0]) % 5)))
    _write_tum(tmp_path, write)
    root = str(tmp_path)
    assert ttum.read_associations(root + "/associations.txt") == \
        jtum.read_associations(root + "/associations.txt")
    ref = list(jtum.frames(root, start=1, end=4))
    for got in (list(ttum.frames(root, start=1, end=4)),
                list(ttum.frames_prefetched(root, start=1, end=4, workers=2, depth_ahead=2))):
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            assert a.timestamp == b.timestamp
            assert a.depth.dtype == b.depth.dtype and a.rgb.dtype == b.rgb.dtype
            np.testing.assert_array_equal(a.depth, b.depth)
            np.testing.assert_array_equal(a.rgb, b.rgb)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_tum_jpeg_colour_matches_jax(tmp_path, monkeypatch, progressive):
    def write(path, a):
        if a.ndim == 3:                     # colour: a JPEG, whatever its name says
            Image.fromarray(a).save(path, format="JPEG", quality=90, progressive=progressive)
        else:
            png.write(str(path), a)

    _write_tum(tmp_path, write)
    root = str(tmp_path)
    ref = list(jtum.frames(root))
    got = list(ttum.frames(root))
    built = []       # the parent builds or loads the library before the pool starts

    def library(real=ttum.jpeg.library):
        built.append(real())
        return built[-1]

    monkeypatch.setattr(ttum.jpeg, "library", library)
    got_ahead = list(ttum.frames_prefetched(root, workers=2, depth_ahead=2))
    assert len(built) == 1 and built[0] is native_loader._LIB
    for frames in (got, got_ahead):
        assert len(frames) == len(ref) == 5
        for a, b in zip(frames, ref):
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.depth, b.depth)
            np.testing.assert_array_equal(a.rgb, b.rgb)
    (tmp_path / "rgb" / "2.png").write_bytes(b"\0\0\1\0" + bytes(20))
    with pytest.raises(ValueError, match="rgb/2.png: not a form the port reads"):
        list(ttum.frames(root))
    # a library that cannot build: the parent raises, naming the build error
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setitem(native_loader._STATUS, "build_error", "RuntimeError: g++ failed (1)")
    with pytest.raises(RuntimeError, match=r"did not build: RuntimeError: g\+\+ failed"):
        next(ttum.frames_prefetched(root, workers=2, depth_ahead=2))


def test_tum_groundtruth_and_write_sequence(tmp_path):
    from hrbffusion3d_tpu_torch.eval import synth

    poses = synth.orbit_trajectory(6, angle_per_frame=0.05)
    ts = 1305031102.0 + np.arange(6) / 30.0
    depths = DEPTH[None].repeat(6, 0) / 5000.0
    rgbs = RGB[None].repeat(6, 0) / 255.0
    ttum.write_sequence(str(tmp_path), depths, rgbs, ts, poses, filters=np.arange(H) % 5)
    gt_path = str(tmp_path / "groundtruth.txt")
    (tt, pt), (tj, pj) = ttum.load_groundtruth(gt_path), jtum.load_groundtruth(gt_path)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(pt, poses, atol=1e-6)
    q = ts[[0, 2, 5]] + np.array([0.001, -0.003, 0.05])
    for a, b in zip(ttum.associate_gt(q, tt, pt), jtum.associate_gt(q, tj, pj)):
        np.testing.assert_array_equal(a, b)
    frames = list(jtum.frames(str(tmp_path)))       # read back by the JAX reader (Pillow)
    assert len(frames) == 6
    np.testing.assert_array_equal(frames[3].depth, DEPTH.astype(np.float32) * jtum.TUM_DEPTH_SCALE)
    np.testing.assert_array_equal(frames[3].rgb, RGB.astype(np.float32) / 255.0)


def _klg_frames(n=3):
    depths = np.stack([np.roll(DEPTH, i, 0) for i in range(n)]).astype(np.float32) / 5000.0
    rgbs = np.stack([np.roll(RGB, i, 1) for i in range(n)]).astype(np.float32) / 255.0
    return depths, rgbs


def test_klg_matches_jax(tmp_path):
    depths, rgbs = _klg_frames()
    pt, pj = str(tmp_path / "t.klg"), str(tmp_path / "j.klg")
    tklg.write(pt, depths, rgbs, timestamps=[5, 6, 7], depth_scale=1 / 5000.0)
    jklg.write(pj, depths, rgbs, timestamps=[5, 6, 7], depth_scale=1 / 5000.0)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    got = list(tklg.frames(pt, W, H, 1 / 5000.0))
    ref = list(jklg.frames(pj, W, H, 1 / 5000.0))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)


def _append_jpeg_frame(path, depth_u16, rgb_u8):
    """A .klg of one frame: zlib depth and a JPEG colour payload."""
    buf = io.BytesIO()
    Image.fromarray(rgb_u8).save(buf, format="JPEG", quality=95)
    dbuf, ibuf = zlib.compress(depth_u16.tobytes()), buf.getvalue()
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<qii", 9, len(dbuf), len(ibuf)))
        f.write(dbuf)
        f.write(ibuf)
    return _pillow(ibuf)


def test_native_loader_matches_python_reader(tmp_path):
    assert native_loader.available(), native_loader.status()["build_error"]
    st = native_loader.status()
    assert st["build_error"] is None and "_build" in st["library"]
    assert not st["library"].endswith("native/libhrbfio.so")
    depths, rgbs = _klg_frames(4)
    p = str(tmp_path / "seq.klg")
    tklg.write(p, depths, rgbs, depth_scale=1 / 5000.0)
    py = list(tklg.frames(p, W, H, 1 / 5000.0))
    nat = list(native_loader.frames(p, W, H, 1 / 5000.0))
    assert native_loader.status()["reader"] == "native"
    assert len(nat) == len(py) == 4
    for a, b in zip(py, nat):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(np.round(a.rgb * 255), np.round(b.rgb * 255))
        np.testing.assert_array_max_ulp(a.rgb, b.rgb, maxulp=1)

    # a JPEG colour payload: the port's own decoder in both readers, equal
    # to Pillow's decode bit for bit
    pj = str(tmp_path / "jpeg.klg")
    ref = _append_jpeg_frame(pj, DEPTH, RGB)
    (fr,) = list(native_loader.frames(pj, W, H, 1 / 5000.0))
    np.testing.assert_array_equal(np.round(fr.rgb * 255), ref)
    (fp,) = list(tklg.frames(pj, W, H, 1 / 5000.0))
    np.testing.assert_array_equal(fp.rgb, ref.astype(np.float32) / 255.0)


def _write_klg(path, depth_u16, payloads):
    """A .klg of one frame per colour payload, each with ``depth_u16``."""
    dbuf = zlib.compress(depth_u16.tobytes())
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(payloads)))
        for i, ibuf in enumerate(payloads):
            f.write(struct.pack("<qii", 100 + i, len(dbuf), len(ibuf)))
            f.write(dbuf)
            f.write(ibuf)


def _png_payload(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def test_klg_png_colour_payload_matches_jax(tmp_path):
    rgba = np.concatenate([RGB, RGB[..., :1]], -1)
    payloads = [
        _png_payload(Image.fromarray(RGB)),
        _png_payload(Image.fromarray(RGB).quantize(37)),
        _png_payload(Image.fromarray(rgba[..., 2:])),
        _png_payload(Image.fromarray(rgba)),
        RGB.tobytes(),
    ]
    jbuf = io.BytesIO()
    Image.fromarray(RGB).save(jbuf, format="JPEG", quality=90)
    payloads.append(jbuf.getvalue())
    p = str(tmp_path / "png.klg")
    _write_klg(p, DEPTH, payloads)
    got = list(tklg.frames(p, W, H, 1 / 5000.0))
    ref = list(jklg.frames(p, W, H, 1 / 5000.0))
    assert len(got) == len(ref) == len(payloads)
    for a, b in zip(got, ref):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.rgb.dtype == b.rgb.dtype and a.rgb.tobytes() == b.rgb.tobytes()

    # a PNG of another size: the frame named, as for a JPEG
    small = str(tmp_path / "small.klg")
    _write_klg(small, DEPTH, [payloads[0], _png_payload(Image.fromarray(RGB[:-1]))])
    with pytest.raises(RuntimeError, match=r"frame 1: PNG colour payload is 41x29, expected 41x30"):
        list(tklg.frames(small, W, H, 1 / 5000.0))
    # the native loader decodes JPEG colour only and says so
    assert native_loader.available(), native_loader.status()["build_error"]
    with pytest.raises(RuntimeError, match=r"frame 0: PNG colour payload: this loader decodes "
                                           r"JPEG colour only"):
        list(native_loader.frames(p, W, H, 1 / 5000.0))


def test_parameter_file_matches_jax(tmp_path):
    p = str(tmp_path / "GlobalStateParam.txt")
    with open(p, "w") as f:
        f.write("""
# comment
registrationJointICPWeight = 7.5;
preprocessingUsebilateralFilter = false;
globalDepthCutoff = 4.2;   // inline comment
preictionMaxNeighbors = 12.0;
preprocessingNormalEstimationPCA = 0;
optimizationUseLocalBA = true;
fusionMergeWindowMultiplier = 3;
someUnknownKey = "whatever";
""")
    assert tparams.parse_parameter_file(p) == jparams.parse_parameter_file(p)
    cfg = tparams.config_from_parameter_file(p)
    assert type(cfg).__module__ == "hrbffusion3d_tpu_torch.config"
    assert cfg == port_cfg(jparams.config_from_parameter_file(p))
    assert cfg.icp_weight == 7.5 and cfg.use_bilateral_filter is False
    assert cfg.predict_max_neighbors == 12 and cfg.normal_pca is False
