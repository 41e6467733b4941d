"""Write the colour-forms fixture of ``tests/data/colour_forms/``.

The colour of the first 9 frames of ``chip_smoke``'s TUM-format fixture
(the JPEGs of ``tests/data/klg_jpeg``, decoded by Pillow), frame i in form
i, the forms RGB-D tools write:

  0. binary PPM (``P6``, maxval 255), written by Pillow;
  1. BMP, 24 bits, rows bottom to top, written by Pillow;
  2. BMP, 8 bits, RLE8, the frame quantised to 256 colours by Pillow,
     written by ``tests/torch_bmp_encoder.py``;
  3. BMP, 32 bits, BGRA bitfields, a 124-byte header, rows top to bottom;
  4. TIFF RGB, LZW with predictor 2 (as OpenCV writes it), by Pillow;
  5. TIFF RGB, deflate, planar configuration 2, 16 rows a strip;
  6. TIFF RGB, PackBits, 96x64 tiles (the edge tiles cropped);
  7. TIFF palette, 8 bits, LZW, the frame quantised by Pillow, by Pillow;
  8. TIFF CMYK, deflate with predictor 2, Pillow's RGB -> CMYK, by Pillow;

and the depth of frames 1 and 7 (``tests/data/depth_forms``' frames, as
Pillow decodes them) as 16-bit TIFF, deflate, 128x128 tiles, little-endian
(frame 1) and big-endian (frame 7), by ``tests/torch_tiff_encoder.py``.

Forms 3 and 6 hold about 2 MB and do not fit the fixture's 4 MB: they are
not committed but written where they are used (``chip_smoke.
colour_form_bytes``, with the tests' encoders, from the frame's JPEG).

``digests.json`` holds per file its form, size, Pillow's mode and the
sha256 of Pillow's ``Image.open(...).convert("RGB")`` (colour) or
``np.asarray(Image.open(...))`` in native byte order (depth), what the JAX
package's TUM reader decodes.  ``chip_smoke.py`` phase run_tum (j) runs
``run_tum`` on a TUM directory of these files and holds the port's
decoders to the digests; ``tests/test_torch_image_colour.py`` holds Pillow
and the port to them.  Needs Pillow; run from the repository root (a few
seconds):

    python3 scripts/make_colour_forms_fixture.py
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
import torch_bmp_encoder as bmpenc  # noqa: E402
import torch_tiff_encoder as tiffenc  # noqa: E402

OUT = ROOT / "tests" / "data" / "colour_forms"
FORMS = ("ppm_p6", "bmp24_bottom_up", "bmp8_rle8", "bmp32_bitfields_top_down",
         "tiff_rgb_lzw_pred2", "tiff_rgb_deflate_planar", "tiff_rgb_tiled_packbits",
         "tiff_palette8_lzw", "tiff_cmyk_deflate_pred2")
SUFFIX = {"ppm": "ppm", "bmp": "bmp", "tif": "tif"}
# written where they are used, not committed
RUNTIME = ("bmp32_bitfields_top_down", "tiff_rgb_tiled_packbits")
DEPTH_FRAMES = ((1, "II"), (7, "MM"))


def pillow(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, **kw)
    return buf.getvalue()


def colour(form: str, im: Image.Image, entry: dict) -> bytes:
    rgb = np.asarray(im)
    if form == "ppm_p6":
        return pillow(im, format="PPM")
    if form == "bmp24_bottom_up":
        return pillow(im, format="BMP")
    if form == "bmp8_rle8":
        q = im.quantize(256)
        pal = np.asarray(q.getpalette()[:768], np.uint8).reshape(-1, 3)
        return bmpenc.encode(np.asarray(q), 8, palette=pal, rle=8)
    if form == "tiff_rgb_lzw_pred2":
        return pillow(im, format="TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    if form == "tiff_rgb_deflate_planar":
        return tiffenc.encode(rgb, "II", 8, photometric=2, planar=2, rows_per_strip=16)
    if form == "tiff_palette8_lzw":
        return pillow(im.quantize(256), format="TIFF", compression="tiff_lzw")
    if form == "tiff_cmyk_deflate_pred2":
        return pillow(im.convert("CMYK"), format="TIFF", compression="tiff_adobe_deflate",
                      tiffinfo={317: 2})
    return chip_smoke.colour_form_bytes(entry)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    jpegs = json.loads((chip_smoke.KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    entries = []
    for i, form in enumerate(FORMS):
        source = jpegs[i]["file"]
        im = Image.open(chip_smoke.KLG_JPEG_DIR / source).convert("RGB")
        ext = "ppm" if form.startswith("ppm") else "bmp" if form.startswith("bmp") else "tif"
        entry = dict(file=f"{i:03d}_{form}.{ext}", frame=i, form=form, kind="colour",
                     source=source)
        if form in RUNTIME:
            entry["writer"] = form
        data = colour(form, im, entry)
        if form not in RUNTIME:
            (OUT / entry["file"]).write_bytes(data)
        decoded = Image.open(io.BytesIO(data))
        rgb = np.asarray(decoded.convert("RGB"))
        lossless = form not in ("bmp8_rle8", "tiff_palette8_lzw", "tiff_cmyk_deflate_pred2")
        if lossless and not np.array_equal(rgb, np.asarray(im)):
            raise RuntimeError(f"{entry['file']}: Pillow does not read back the frame written")
        entry.update(width=rgb.shape[1], height=rgb.shape[0], bytes=len(data),
                     mode=decoded.mode, rgb_sha256=hashlib.sha256(rgb.tobytes()).hexdigest())
        entries.append(entry)
        print(f"{entry['file']}: {len(data)} bytes, mode {decoded.mode}"
              + (" (written at run time)" if form in RUNTIME else ""))
    depth_files = sorted(chip_smoke.DEPTH_FORMS_DIR.glob("[0-9]*"))
    for i, order in DEPTH_FRAMES:
        src = np.asarray(Image.open(depth_files[i]))
        d16 = src.astype(src.dtype.newbyteorder("=")).astype(np.uint16)
        data = tiffenc.encode(d16, order, 8, tile=(128, 128))
        name = f"{len(entries):03d}_depth_tiff_{order}_tiled_deflate.tif"
        (OUT / name).write_bytes(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        decoded = decoded.astype(decoded.dtype.newbyteorder("="))
        if not np.array_equal(decoded, d16):
            raise RuntimeError(f"{name}: Pillow does not read back the depth written")
        entries.append(dict(file=name, frame=i, form=f"depth_tiff_{order}_tiled_deflate",
                            kind="depth", source=depth_files[i].name, width=d16.shape[1],
                            height=d16.shape[0], bytes=len(data), dtype=str(decoded.dtype),
                            depth_sha256=hashlib.sha256(decoded.tobytes()).hexdigest()))
        print(f"{name}: {len(data)} bytes")
    meta = dict(source="tests/data/klg_jpeg (colour) and tests/data/depth_forms (depth), "
                       "frame i in form i",
                writer=f"Pillow {PIL.__version__}, tests/torch_bmp_encoder.py and "
                       "tests/torch_tiff_encoder.py",
                forms=list(FORMS), runtime=list(RUNTIME), frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    committed = sum(e["bytes"] for e in entries if "writer" not in e)
    print(f"{len(entries)} files, {committed} bytes committed -> {OUT}")


if __name__ == "__main__":
    main()
