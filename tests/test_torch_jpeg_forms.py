"""The JPEG forms beyond Huffman-coded DCT of 1 or 3 components sampled at
most 2x2 that Pillow 12.1 (libjpeg-turbo 3.1) decodes, held bit for bit
against Pillow's ``Image.open(...).convert("RGB")`` through the port's
``io/jpeg.decode``.  The streams come from Pillow's writer where it can
write them and else from ``torch_jpeg_encoders`` (numpy), whose streams
only have to be valid: Pillow is the oracle.

- CMYK (Pillow's writer, baseline and progressive; the test encoder with
  and without an Adobe marker; subsampled) and YCCK (Adobe transform 2;
  an unknown transform, which libjpeg-turbo takes as YCCK);
- sampling factors 1-4 in integer ratios: luma 4x1, 1x4, 4x2, 2x4, 3x1,
  1x3, 3x3 (one scan per component), 4x4 (one scan per component) over
  chroma 1x1, chroma at half the luma's factors (fancy filters), chroma
  above luma;
- lossless (SOF3): every predictor 1-7 with point transforms 0, 1 and 3,
  restart intervals, 16-bit sample values (differences modulo 2^16,
  category 16), RGB with luma 4x1 / 2x2 / 1x2 (replicated, not filtered),
  CMYK, one scan per component with a restart inside an iMCU row;
- arithmetic coding (SOF9, SOF10): sequential and progressive with and
  without refinement, restart intervals, a DAC segment, CMYK and YCCK,
  greyscale;
- progressive images left unrefined (Pillow's progressive scans cut
  before refinement, after the DC scans, after two scans), which
  libjpeg-turbo smooths;
- sizes that are and are not multiples of the MCU (37x53, 48x64, 8x8) and
  two seeds;
- forms that Pillow refuses raise ``RuntimeError`` naming the form, and
  so do truncated and corrupt arithmetic-coded data;
- the JAX readers (Pillow) against the port's TUM ``load_frame`` and both
  ``.klg`` readers on a sequence of mixed forms;
- the committed fixture ``tests/data/jpeg_forms`` decodes, in Pillow and
  in the port, to its digests.
"""

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hrbffusion3d_tpu.io import klg as jklg
from hrbffusion3d_tpu.io import tum as jtum
from hrbffusion3d_tpu_torch.io import jpeg, native_loader, png
from hrbffusion3d_tpu_torch.io import klg as tklg
from hrbffusion3d_tpu_torch.io import tum as ttum

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_jpeg_encoders as enc  # noqa: E402

FIXTURE = Path(__file__).resolve().parent / "data" / "jpeg_forms"
SIZES = ((37, 53), (48, 64))
ONE = [(1, 1)]


@pytest.fixture(scope="module")
def lib():
    assert native_loader.available(), native_loader.status()["build_error"]
    return native_loader.status()["library"]


def _image(h, w, n=3, seed=0):
    """Gradients, noise and a saturated patch, ``n`` channels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = [xx * 5 + yy * 3, xx * 2 + yy, yy * 7 + 40, xx * 3 + yy * 11]
    img = np.stack(ramps[:n], -1) % 256.0 + rng.normal(0, 25, (h, w, n))
    img[h // 3:h // 2, w // 4:w // 2] = 255
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pillow_save(img, mode, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _scans_kept(data: bytes, keep) -> bytes:
    """The stream with only its scans i (0-based) for which keep(i, Ss, Ah)."""
    out, pos, i = bytearray(data[:2]), 2, 0
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            out += data[pos:pos + 2]
            break
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            ns = data[pos + 4]
            ss, ah = data[pos + 5 + 2 * ns], data[pos + 7 + 2 * ns] >> 4
            i += 1
            if not keep(i - 1, ss, ah):
                pos = end
                continue
        out += data[pos:end]
        pos = end
    return bytes(out)


def _samples(h, w, sampling, seed):
    """Random 8-bit samples of each component at its resolution."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, enc.component_size(w, h, sampling, ci))
            for ci in range(len(sampling))]


# ---------------------------------------------------------------------- #
# the cases: id -> a function of (h, w, seed) returning the stream
# ---------------------------------------------------------------------- #
def _cases():
    c = {}
    for q in (75, 95):
        for prog in (False, True):
            c[f"cmyk-pillow-q{q}{'-progressive' if prog else ''}"] = (
                lambda h, w, s, q=q, prog=prog: _pillow_save(_image(h, w, 4, s), "CMYK",
                                                             quality=q, progressive=prog))
    c["cmyk-adobe0"] = lambda h, w, s: enc.dct_stream(_image(h, w, 4, s), None, 85, transform=0)
    c["cmyk-no-adobe"] = lambda h, w, s: enc.dct_stream(_image(h, w, 4, s), None, 85)
    c["cmyk-2x2-k2x2"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 4, s), [(2, 2), (1, 1), (1, 1), (2, 2)], 85, transform=0)
    c["ycck"] = lambda h, w, s: enc.dct_stream(_image(h, w, 4, s), None, 85, transform=2)
    c["ycck-2x2"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 4, s), [(2, 2), (1, 1), (1, 1), (2, 2)], 90, transform=2)
    c["ycck-unknown-transform"] = lambda h, w, s: enc.dct_stream(_image(h, w, 4, s), None, 80,
                                                                 transform=5)
    for luma in ((4, 1), (1, 4), (4, 2), (2, 4), (3, 1), (1, 3)):
        c[f"sampling-{luma[0]}x{luma[1]}"] = (
            lambda h, w, s, luma=luma: enc.dct_stream(_image(h, w, 3, s), [luma] + ONE * 2, 90))
    for luma, chroma in (((4, 4), (1, 1)), ((4, 4), (2, 2)), ((3, 3), (1, 1)),
                         ((4, 2), (2, 1)), ((2, 4), (1, 2))):
        c[f"sampling-{luma[0]}x{luma[1]}-{chroma[0]}x{chroma[1]}-scan-per-component"] = (
            lambda h, w, s, luma=luma, chroma=chroma: enc.dct_stream(
                _image(h, w, 3, s), [luma, chroma, chroma], 90, interleave=False))
    c["sampling-4x1-2x1"] = lambda h, w, s: enc.dct_stream(_image(h, w, 3, s),
                                                           [(4, 1), (2, 1), (2, 1)], 90)
    c["sampling-chroma-above-luma"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(1, 1), (2, 2), (1, 1)], 90)
    c["sampling-4x1-restart"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(4, 1)] + ONE * 2, 90, restart=2)
    for psv in range(1, 8):
        for pt in (0, 3):
            c[f"lossless-grey-p{psv}-pt{pt}"] = (
                lambda h, w, s, psv=psv, pt=pt: enc.lossless_stream(
                    [_samples(h, w, ONE, s)[0] >> pt], w, h, psv=psv, pt=pt,
                    restart_rows=(psv % 3) * 2))
        c[f"lossless-16bit-p{psv}-pt1"] = (
            lambda h, w, s, psv=psv: enc.lossless_stream(
                [_samples(h, w, ONE, s)[0] + 32768 * (_samples(h, w, ONE, s + 9)[0] & 1)
                 + 256 * (_samples(h, w, ONE, s + 5)[0] % 3)], w, h, psv=psv, pt=1))
    for luma in ((1, 1), (4, 1), (2, 2), (1, 2), (4, 2)):
        c[f"lossless-rgb-{luma[0]}x{luma[1]}"] = (
            lambda h, w, s, luma=luma: enc.lossless_stream(
                _samples(h, w, [luma] + ONE * 2, s), w, h, [luma] + ONE * 2, psv=7, jfif=False,
                restart_rows=1))
    c["lossless-rgb-ids-RGB"] = lambda h, w, s: enc.lossless_stream(
        _samples(h, w, ONE * 3, s), w, h, psv=4, ids=[82, 71, 66], jfif=False)
    c["lossless-rgb-adobe0"] = lambda h, w, s: enc.lossless_stream(
        _samples(h, w, ONE * 3, s), w, h, psv=5, transform=0)
    for luma in ((2, 2), (1, 2), (4, 4)):
        # one scan per component; a restart every 3 rows falls inside the
        # luma's iMCU rows of 2 or 4 rows
        c[f"lossless-scan-per-component-{luma[0]}x{luma[1]}-restart"] = (
            lambda h, w, s, luma=luma: enc.lossless_stream(
                _samples(h, w, [luma] + ONE * 2, s), w, h, [luma] + ONE * 2, psv=6,
                jfif=False, interleave=False, restart_rows=3))
    c["lossless-cmyk"] = lambda h, w, s: enc.lossless_stream(
        _samples(h, w, ONE * 4, s), w, h, psv=2, pt=2, transform=0)
    for name, samp in (("420", [(2, 2)] + ONE * 2), ("444", ONE * 3), ("4x1", [(4, 1)] + ONE * 2)):
        c[f"arithmetic-{name}"] = (
            lambda h, w, s, samp=samp: enc.dct_stream(_image(h, w, 3, s), samp, 90,
                                                      arithmetic=True))
        c[f"arithmetic-{name}-restart"] = (
            lambda h, w, s, samp=samp: enc.dct_stream(_image(h, w, 3, s), samp, 90,
                                                      arithmetic=True, restart=3))
        c[f"arithmetic-progressive-{name}"] = (
            lambda h, w, s, samp=samp: enc.dct_stream(_image(h, w, 3, s), samp, 90,
                                                      arithmetic=True,
                                                      script=enc.FULL_PROGRESSION))
    dac = {(0, 0): 0x52, (1, 0): 2, (0, 1): 0x10, (1, 1): 40}
    c["arithmetic-dac-restart-1"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(2, 1)] + ONE * 2, 85, arithmetic=True, restart=1, dac=dac)
    c["arithmetic-progressive-dac-restart"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(2, 2)] + ONE * 2, 85, arithmetic=True, restart=2, dac=dac,
        script=enc.FULL_PROGRESSION)
    c["arithmetic-grey"] = lambda h, w, s: enc.dct_stream(_image(h, w, 1, s), None, 75,
                                                          arithmetic=True)
    c["arithmetic-cmyk"] = lambda h, w, s: enc.dct_stream(_image(h, w, 4, s), None, 85,
                                                          arithmetic=True, transform=0)
    c["arithmetic-progressive-ycck"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 4, s), [(2, 2), (1, 1), (1, 1), (2, 2)], 85, arithmetic=True, transform=2,
        script=((None, 0, 0, 0, 0),) + tuple(((ci,), 1, 63, 0, 0) for ci in range(4)))
    c["arithmetic-progressive-unrefined"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(2, 2)] + ONE * 2, 90, arithmetic=True,
        script=enc.UNREFINED_PROGRESSION)
    c["arithmetic-progressive-dc-only"] = lambda h, w, s: enc.dct_stream(
        _image(h, w, 3, s), [(2, 1)] + ONE * 2, 90, arithmetic=True,
        script=((None, 0, 0, 0, 1), (None, 0, 0, 1, 0)))
    unrefined = {"no-refinement": lambda i, ss, ah: ah == 0,
                 "dc-only": lambda i, ss, ah: ss == 0,
                 "first-dc-scan": lambda i, ss, ah: ss == 0 and ah == 0,
                 "first-two-scans": lambda i, ss, ah: i < 2}
    for sub in (0, 1, 2):
        for kept, keep in unrefined.items():
            c[f"unrefined-{kept}-ss{sub}"] = (
                lambda h, w, s, sub=sub, keep=keep: _scans_kept(
                    _pillow_save(_image(h, w, 3, s), "RGB", quality=90, subsampling=sub,
                                 progressive=True), keep))
    c["unrefined-grey"] = lambda h, w, s: _scans_kept(
        _pillow_save(_image(h, w, 1, s)[..., 0], "L", quality=85, progressive=True),
        unrefined["no-refinement"])
    return c


CASES = _cases()
SEEDED = [(name, hw, seed) for name in CASES for hw in SIZES for seed in (0, 1)
          if seed == 0 or hw == SIZES[0]]


@pytest.mark.parametrize("name,hw,seed", SEEDED,
                         ids=[f"{n}-{hw[1]}x{hw[0]}-s{s}" for n, hw, s in SEEDED])
def test_form_matches_pillow(lib, name, hw, seed):
    data = CASES[name](*hw, seed)
    ref = _pillow(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (*hw, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["cmyk-pillow-q75", "ycck", "sampling-4x1", "sampling-1x4",
                                  "lossless-grey-p4-pt3", "arithmetic-420-restart",
                                  "arithmetic-progressive-420", "unrefined-no-refinement-ss2"])
def test_small_images_match_pillow(lib, name):
    """One MCU or less, and single rows and columns."""
    for hw in ((8, 8), (1, 1), (3, 17), (17, 2)):
        data = CASES[name](*hw, 0)
        np.testing.assert_array_equal(jpeg.decode(data), _pillow(data), err_msg=str(hw))


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #
def _grey(h=37, w=53):
    return _samples(h, w, ONE, 0)[0]


def _arith(h=48, w=64):
    return enc.dct_stream(_image(h, w), [(2, 2)] + ONE * 2, 90, arithmetic=True)


def _cut_entropy(data: bytes) -> bytes:
    sos = data.index(b"\xff\xda")
    return data[:sos + (len(data) - sos) // 2]


def _overwrite_entropy(data: bytes, patch: bytes) -> bytes:
    sos = data.index(b"\xff\xda")
    mid = sos + (len(data) - sos) // 2
    return data[:mid] + patch + data[mid + len(patch):]


def _bad_restart(data: bytes) -> bytes:
    i = data.index(b"\xff\xdd")
    return data[:i + 4] + struct.pack(">H", 53 + 1) + data[i + 6:]


REFUSED = {
    "lossless-12-bit": (lambda: enc.lossless_stream([_grey()], 53, 37, precision=12),
                        "lossless JPEG of 12-bit samples", True),
    "lossless-16-bit": (lambda: enc.lossless_stream([_grey()], 53, 37, precision=16),
                        "lossless JPEG of 16-bit samples", True),
    "fractional-sampling": (lambda: enc.dct_stream(_image(37, 53), [(3, 1), (2, 1), (1, 1)], 90),
                            "fractional sampling", True),
    "fractional-sampling-vertical": (
        lambda: enc.dct_stream(_image(37, 53), [(1, 4), (1, 3), (1, 1)], 90,
                               interleave=False), "fractional sampling", True),
    "mcu-of-18-blocks": (lambda: enc.dct_stream(_image(37, 53), [(4, 4)] + ONE * 2, 90),
                         "18 blocks in an MCU", True),
    "arithmetic-lossless": (lambda: enc.lossless_stream([_grey()], 53, 37, sof=0xCB),
                            r"arithmetic-coded lossless JPEG \(SOF11\)", True),
    "lossless-ycbcr-jfif": (lambda: enc.lossless_stream(_samples(37, 53, ONE * 3, 0), 53, 37,
                                                        jfif=True),
                            "lossless JPEG in YCbCr colour", True),
    "lossless-ycbcr-adobe1": (lambda: enc.lossless_stream(_samples(37, 53, ONE * 3, 0), 53, 37,
                                                          transform=1),
                              "lossless JPEG in YCbCr colour", True),
    "lossless-ycck": (lambda: enc.lossless_stream(_samples(37, 53, ONE * 4, 0), 53, 37,
                                                  transform=2),
                      "lossless JPEG in YCCK colour", True),
    "lossless-restart-not-a-row": (
        lambda: _bad_restart(enc.lossless_stream([_grey()], 53, 37, restart_rows=1)),
        "not a multiple of the 53 MCUs of a row", True),
    "arithmetic-truncated": (lambda: _cut_entropy(_arith()), "truncated JPEG", True),
    "arithmetic-progressive-truncated": (
        lambda: _cut_entropy(enc.dct_stream(_image(48, 64), None, 90, arithmetic=True,
                                            script=enc.FULL_PROGRESSION)),
        "truncated JPEG", True),
    # Pillow warns and decodes these; libjpeg-turbo's warning is the
    # decoder's refusal (the decode ends before the data does)
    "arithmetic-corrupt-ones": (lambda: _overwrite_entropy(_arith(), b"\xff\x00" * 16),
                                "corrupt JPEG data: .* extraneous bytes", False),
    "arithmetic-corrupt-pattern": (lambda: _overwrite_entropy(_arith(), b"\x55" * 32),
                                   "corrupt JPEG data: .* extraneous bytes", False),
}
for _sof in (5, 6, 7):
    REFUSED[f"hierarchical-sof{_sof}"] = (
        lambda m=0xC0 + _sof: enc.rewrite_sof(enc.dct_stream(_image(37, 53), None, 90), marker=m),
        rf"hierarchical JPEG \(SOF{_sof}\)", True)
for _sof in (13, 14, 15):
    REFUSED[f"hierarchical-arithmetic-sof{_sof}"] = (
        lambda m=0xC0 + _sof: enc.rewrite_sof(_arith(), marker=m),
        rf"hierarchical arithmetic-coded JPEG \(SOF{_sof}\)", True)


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_forms_raise(lib, kind):
    make, cause, pillow_refuses = REFUSED[kind]
    data = make()
    if pillow_refuses:
        with pytest.raises(OSError):
            _pillow(data)
    with pytest.raises(RuntimeError, match=cause):
        jpeg.decode(data)


# ---------------------------------------------------------------------- #
# the readers on mixed forms
# ---------------------------------------------------------------------- #
MIXED = ("cmyk-pillow-q95", "ycck", "sampling-4x1", "lossless-rgb-4x1",
         "arithmetic-420-restart", "arithmetic-progressive-420", "unrefined-no-refinement-ss2")
H, W = 48, 64


def _depth(i):
    yy, xx = np.mgrid[0:H, 0:W]
    d = ((np.sin(xx / 9.0 + i) + 2.0) * 4000 + yy * 3).astype(np.uint16)
    d[::7, ::5] = 0
    return d


def test_tum_reader_matches_jax_on_mixed_forms(lib, tmp_path):
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    for i, name in enumerate(MIXED):
        (tmp_path / "rgb" / f"{i}.jpg").write_bytes(CASES[name](H, W, i))
        (tmp_path / "depth" / f"{i}.png").write_bytes(png.encode(_depth(i)))
        want = jtum.load_frame(str(tmp_path), f"rgb/{i}.jpg", f"depth/{i}.png", float(i))
        have = ttum.load_frame(str(tmp_path), f"rgb/{i}.jpg", f"depth/{i}.png", float(i))
        assert have.timestamp == want.timestamp
        np.testing.assert_array_equal(have.depth, want.depth)
        np.testing.assert_array_equal(have.rgb, want.rgb, err_msg=name)


def test_klg_readers_match_jax_on_mixed_forms(lib, tmp_path):
    path = tmp_path / "mixed.klg"
    blob = bytearray(struct.pack("<i", len(MIXED)))
    for i, name in enumerate(MIXED):
        dbuf, ibuf = zlib.compress(_depth(i).tobytes()), CASES[name](H, W, i)
        blob += struct.pack("<qii", 1305031102175304 + 33333 * i, len(dbuf), len(ibuf))
        blob += dbuf + ibuf
    path.write_bytes(bytes(blob))
    scale = 1.0 / 5000.0
    ref = list(jklg.frames(str(path), W, H, scale))
    py = list(tklg.frames(str(path), W, H, scale))
    nat = list(native_loader.frames(str(path), W, H, scale))
    assert native_loader.status()["reader"] == "native"
    assert len(ref) == len(py) == len(nat) == len(MIXED)
    for a, b, c in zip(ref, py, nat):
        assert a.timestamp == b.timestamp == c.timestamp
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.depth, c.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(np.round(a.rgb * 255), np.round(c.rgb * 255))


# ---------------------------------------------------------------------- #
# the committed fixture (scripts/make_jpeg_forms_fixture.py)
# ---------------------------------------------------------------------- #
def test_fixture_digests_match_pillow_and_the_port(lib):
    meta = json.loads((FIXTURE / "digests.json").read_text())
    forms = meta["forms"]
    assert len(forms) == 7 and len(meta["frames"]) == 20
    total = 0
    for i, e in enumerate(meta["frames"]):
        assert e["form"] == forms[i % 7], e
        data = (FIXTURE / e["file"]).read_bytes()
        total += len(data)
        assert len(data) == e["bytes"]
        ref = _pillow(data)
        assert ref.shape == (480, 640, 3)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == e["rgb_sha256"], e["file"]
        got = jpeg.decode(data)
        assert hashlib.sha256(got.tobytes()).hexdigest() == e["rgb_sha256"], e["file"]
    assert total < 3 << 20
