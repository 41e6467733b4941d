"""Write the WebP and GIF fixture of ``tests/data/webp_gif/``.

The colour of the first 9 frames of ``tests/data/klg_jpeg`` (as Pillow
decodes them), frame i in form i, each at 640x480, in the forms that
export and capture tools write and Pillow 12.1 reads through libwebp 1.6
and its own GIF decoder:

  0. WebP lossy, Pillow's defaults (quality 80, method 4);
  1. WebP lossy, quality 100, method 6;
  2. WebP lossy with the simple loop filter (``filter_type`` 0);
  3. WebP lossy with no loop filter (``filter_strength`` 0) and 8 token
     partitions (libwebp 1.6 writes them with ``low_memory`` on only);
  4. WebP lossy with one segment and sharpness 7;
  5. WebP lossy with an ``ALPH`` chunk (VP8L-compressed, gradient filter)
     in a ``VP8X`` file with an ICC profile (Pillow's writer; an alpha
     plane f(x) + g(y), for which libwebp picks the gradient filter);
  6. WebP lossless, method 0;
  7. WebP lossless, method 6 (colour cache, predictor, cross-colour and
     LZ77 all in play);
  8. GIF from Pillow's adaptive palette, interlaced;

forms 2-4 written by libwebp's ``WebPEncode`` through ``ctypes``
(``tests/torch_webp_encoder.py``: Pillow's writer does not pass these
settings on); and, held to their digests only: a palette-indexed VP8L of
2, 4 and 16 colours (pixel bundling of 8, 4 and 2 pixels a byte); an
``ALPH`` chunk with compression 0 and the horizontal filter; a two-frame
animated WebP whose frame 0 covers a sub-rectangle at an offset; a GIF
with a local palette and a transparent index; a GIF with the grey-ramp
palette (mode ``L``); a two-frame animated GIF; a GIF read as depth (mode
``P`` indices).

``digests.json`` holds per file its form, size, Pillow's mode and the
sha256 of Pillow's ``Image.open(...).convert("RGB")`` (colour) or of
``np.asarray(Image.open(...))`` (depth), what the JAX package's TUM
reader decodes, and for each file whose frame 0 is ``VP8 `` the sha256 of
libwebp's Y, U and V planes (``WebPDecodeYUV`` of that frame).
``chip_smoke.py`` phase run_tum (m) runs ``run_tum`` on a TUM directory of
these files and holds the port's decoders to the digests (the card's
machine has no Pillow); ``tests/test_torch_image_webp.py`` and
``tests/test_torch_image_gif.py`` hold Pillow and the port to them.  Needs
Pillow; run from the repository root (a few seconds):

    python3 scripts/make_webp_gif_fixture.py
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import PIL
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import torch_webp_encoder as webpenc  # noqa: E402

OUT = ROOT / "tests" / "data" / "webp_gif"
FORMS = ("webp_lossy", "webp_lossy_q100_m6", "webp_simple_filter", "webp_nofilter_8parts",
         "webp_1segment_sharp7", "webp_alph_icc", "webp_lossless_m0", "webp_lossless_m6",
         "gif_adaptive_interlaced")
EXTRA_FORMS = ("webp_palette2", "webp_palette4", "webp_palette16", "webp_alph_raw_horizontal",
               "webp_anim_offset", "gif_local_transparent", "gif_grey_ramp", "gif_anim",
               "gif_depth")
ICC = b"\0" * 128 + b"hrbffusion3d fixture ICC payload"


def pillow(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def alpha_ramp(h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(64 + 160 * x / w + 30 * y / h, 0, 255).astype(np.uint8)


def alpha_sum(h: int, w: int) -> np.ndarray:
    """f(x) + g(y) of random f, g: libwebp's alpha encoder picks the
    gradient filter for it (all its residuals 0)."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 128, w)[None, :] + rng.integers(0, 128, h)[:, None]).astype(np.uint8)


def colour_bytes(form: str, im: Image.Image) -> bytes:
    rgb = np.asarray(im)
    if form == "webp_lossy":
        return pillow(im, "WEBP")
    if form == "webp_lossy_q100_m6":
        return pillow(im, "WEBP", quality=100, method=6)
    if form == "webp_simple_filter":
        return webpenc.encode_lossy(rgb, filter_type=0)
    if form == "webp_nofilter_8parts":
        return webpenc.encode_lossy(rgb, filter_strength=0, partitions=3, low_memory=1)
    if form == "webp_1segment_sharp7":
        return webpenc.encode_lossy(rgb, segments=1, filter_sharpness=7)
    if form == "webp_alph_icc":
        rgba = np.dstack([rgb, alpha_sum(*rgb.shape[:2])])
        return pillow(Image.fromarray(rgba, "RGBA"), "WEBP", icc_profile=ICC)
    if form == "webp_lossless_m0":
        return pillow(im, "WEBP", lossless=True, method=0)
    if form == "webp_lossless_m6":
        return pillow(im, "WEBP", lossless=True, method=6)
    return pillow(im.convert("P", palette=Image.Palette.ADAPTIVE), "GIF", interlace=True)


def extra_bytes(form: str, im: Image.Image) -> tuple[bytes, str]:
    """(the file, its kind) of a form held to its digest only."""
    rgb = np.asarray(im)
    small = im.resize((320, 240), Image.Resampling.BILINEAR)
    if form.startswith("webp_palette"):
        n = int(form[len("webp_palette"):])
        return pillow(im.quantize(n).convert("RGB"), "WEBP", lossless=True), "colour"
    if form == "webp_alph_raw_horizontal":
        lossy = dict(webpenc.chunks(webpenc.encode_lossy(rgb)))[b"VP8 "]
        h, w = rgb.shape[:2]
        alph = webpenc.alph_raw(alpha_ramp(h, w)[:, ::-1].copy(), 1)
        return webpenc.riff(webpenc.vp8x(w, h, webpenc.ALPHA),
                            webpenc.chunk(b"ALPH", alph), webpenc.chunk(b"VP8 ", lossy)), "colour"
    if form == "webp_anim_offset":
        a = dict(webpenc.chunks(webpenc.encode_lossy(np.asarray(small))))[b"VP8 "]
        b = dict(webpenc.chunks(webpenc.encode_lossy(rgb)))[b"VP8 "]
        return webpenc.riff(webpenc.vp8x(640, 480, webpenc.ANIMATION), webpenc.anim(),
                            webpenc.anmf(200, 120, 320, 240, webpenc.chunk(b"VP8 ", a)),
                            webpenc.anmf(0, 0, 640, 480, webpenc.chunk(b"VP8 ", b))), "colour"
    if form == "gif_local_transparent":
        p = small.quantize(64)
        raw = pillow(p, "GIF", transparency=5)
        # the palette moved from the screen to the image descriptor
        flags = raw[10]
        size = 3 << ((flags & 7) + 1)
        palette = raw[13:13 + size]
        body = raw[13 + size:]
        at = body.index(b",")
        desc = bytearray(body[at:at + 10])
        desc[9] = (desc[9] & 0x40) | 0x80 | (flags & 7)
        return (raw[:10] + bytes([flags & 0x70]) + raw[11:13] + body[:at] + bytes(desc)
                + palette + body[at + 10:]), "colour"
    if form == "gif_grey_ramp":
        return pillow(small.convert("L"), "GIF", optimize=False), "colour"
    if form == "gif_anim":
        return pillow(small.quantize(32), "GIF", save_all=True,
                      append_images=[small.transpose(Image.Transpose.FLIP_LEFT_RIGHT).quantize(32)],
                      duration=100, loop=0), "colour"
    return pillow(small.convert("L").quantize(16), "GIF"), "depth"


def digest(kind: str, data: bytes) -> tuple[str, np.ndarray]:
    decoded = Image.open(io.BytesIO(data))
    return decoded.mode, np.asarray(decoded.convert("RGB") if kind == "colour" else decoded)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def vp8_frame0(data: bytes) -> bytes | None:
    """Frame 0's ``VP8 `` payload, or None (lossless, GIF)."""
    if data[:4] != b"RIFF":
        return None
    tags = webpenc.chunks(data)
    for tag, payload in tags:
        if tag == b"ANMF":
            inner = webpenc.chunks(b"RIFF\0\0\0\0WEBP" + payload[16:])
            return next((p for t, p in inner if t == b"VP8 "), None)
        if tag == b"VP8 ":
            return payload
    return None


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    jpegs = json.loads((chip_smoke.KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    entries = []

    def add(entry: dict, data: bytes, kind: str, want: np.ndarray | None = None) -> None:
        mode, a = digest(kind, data)
        if want is not None and not np.array_equal(a, want):
            raise RuntimeError(f"{entry['file']}: Pillow does not read back the frame written")
        (OUT / entry["file"]).write_bytes(data)
        key = "rgb_sha256" if kind == "colour" else "depth_sha256"
        entry.update(kind=kind, width=a.shape[1], height=a.shape[0], bytes=len(data), mode=mode)
        entry[key] = sha(a)
        vp8 = vp8_frame0(data)
        if vp8 is not None:
            planes = webpenc.yuv_planes(webpenc.riff(webpenc.chunk(b"VP8 ", vp8)))
            entry["yuv_sha256"] = [sha(p) for p in planes]
        entries.append(entry)
        print(f"{entry['file']}: {len(data)} bytes, mode {mode}")

    for i, form in enumerate(FORMS):
        source = jpegs[i]["file"]
        im = Image.open(chip_smoke.KLG_JPEG_DIR / source).convert("RGB")
        ext = "gif" if form.startswith("gif") else "webp"
        entry = dict(file=f"{len(entries):03d}_{form}.{ext}", frame=i, form=form, source=source)
        lossless = form.startswith("webp_lossless")
        data = colour_bytes(form, im)
        if form == "webp_alph_icc" and dict(webpenc.chunks(data))[b"ALPH"][0] != 0x0D:
            raise RuntimeError(f"{form}: libwebp did not pick VP8L with the gradient filter")
        add(entry, data, "colour", np.asarray(im) if lossless else None)
    for j, form in enumerate(EXTRA_FORMS):
        source = jpegs[j]["file"]
        im = Image.open(chip_smoke.KLG_JPEG_DIR / source).convert("RGB")
        data, kind = extra_bytes(form, im)
        ext = "gif" if form.startswith("gif") else "webp"
        entry = dict(file=f"{len(entries):03d}_{form}.{ext}", frame=j, form=form, source=source,
                     sequence=False)
        add(entry, data, kind)
    meta = dict(source="tests/data/klg_jpeg (colour of frames 0-8, frame i in form i; frames "
                       "0-8 again for the forms held to their digests only)",
                writer=f"Pillow {PIL.__version__} and its libwebp through "
                       "tests/torch_webp_encoder.py",
                forms=list(FORMS), extra_forms=list(EXTRA_FORMS), frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} files, {sum(e['bytes'] for e in entries)} bytes -> {OUT}")


if __name__ == "__main__":
    main()
