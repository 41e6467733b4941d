"""Write the TIFF-forms fixture of ``tests/data/tiff_forms/``.

The colour of the first 9 frames of ``chip_smoke``'s TUM-format fixture
(the JPEGs of ``tests/data/klg_jpeg``, decoded by Pillow), frame i in form
i, the TIFF forms that cameras, scanners and RGB-D exporters write and
Pillow 12 opens through libtiff:

  0. JPEG-in-TIFF RGB (compression 7, photometric 2), strips of 32 rows
     with JPEGTables, written by Pillow;
  1. JPEG-in-TIFF YCbCr (photometric 6), 128x128 tiles (the edge tiles
     cropped), each tile a Pillow 4:2:0 JPEG stream at quality 90 without
     its tables, which JPEGTables holds;
  2. YCbCr, LZW, YCbCrSubSampling (2, 2), 16 rows a strip (the frame in
     ``chip_smoke.rgb_to_ycbcr``, JFIF's equations; each 2x2 block's chroma
     its top-left pixel's);
  3. BigTIFF RGB, no compression;
  4. JPEG-in-TIFF YCbCr, the frame's JPEG as its one strip, no JPEGTables
     and no YCbCrSubSampling (libtiff reads the sampling off the stream);
  5. YCbCr, deflate, YCbCrSubSampling (4, 2), 128x128 tiles;
  6. YCbCr, PackBits, YCbCrSubSampling (1, 1), 32 rows a strip, big-endian;
  7. BigTIFF RGB, LZW with predictor 2, 128x128 tiles;
  8. BigTIFF JPEG-in-TIFF YCbCr, the frame's JPEG split into JPEGTables
     and one strip;

and the depth of frames 1 and 7 (``tests/data/depth_forms``' frames, as
Pillow decodes them) as 16-bit BigTIFF, deflate in 128x128 tiles (frame 1)
and uncompressed (frame 7); and greyscale depth that 8 bits cannot carry
at TUM's 1/5000 m, held to its digest only: the high byte of frame 0's
depth as a Pillow JPEG (mode ``L``) and as Pillow's JPEG-in-TIFF.

The forms written from the frame's JPEG alone (3, 4, 6, 8 and the
uncompressed depth: large, or wrapping a committed stream) are not
committed but written where they are used (``chip_smoke.tiff_form_bytes``,
with the tests' TIFF encoder, from the frame's JPEG as the port decodes
it, bit for bit with Pillow).

``digests.json`` holds per file its form, size, Pillow's mode and the
sha256 of Pillow's ``Image.open(...).convert("RGB")`` (colour) or
``np.asarray(Image.open(...))`` in native byte order (depth), what the JAX
package's TUM reader decodes.  ``chip_smoke.py`` phase run_tum (k) runs
``run_tum`` on a TUM directory of these files and holds the port's
decoders to the digests; ``tests/test_torch_image_tiff_forms.py`` holds
Pillow and the port to them.  Needs Pillow; run from the repository root
(a few seconds):

    python3 scripts/make_tiff_forms_fixture.py
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
import torch_tiff_encoder as tiffenc  # noqa: E402

OUT = ROOT / "tests" / "data" / "tiff_forms"
FORMS = ("tiff_jpeg_rgb_strips", "tiff_jpeg_ycbcr420_tiles_tables", "tiff_ycbcr22_lzw",
         "bigtiff_rgb", "tiff_jpeg_ycbcr420_strip_no_530", "tiff_ycbcr42_deflate_tiles",
         "tiff_ycbcr11_packbits_mm", "bigtiff_rgb_lzw_pred2_tiles",
         "bigtiff_jpeg_ycbcr420_tables")
DEPTH_FORMS = ((1, "bigtiff_depth16_deflate_tiles"), (7, "bigtiff_depth16"))
GREY_FORMS = ("jpeg_grey", "tiff_jpeg_grey")
# written where they are used, not committed
RUNTIME = ("bigtiff_rgb", "tiff_jpeg_ycbcr420_strip_no_530", "tiff_ycbcr11_packbits_mm",
           "bigtiff_jpeg_ycbcr420_tables", "bigtiff_depth16")
SHORT = tiffenc.SHORT


def pillow(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, **kw)
    return buf.getvalue()


def written(form: str, im: Image.Image, entry: dict) -> bytes:
    rgb = np.asarray(im)
    if form == "tiff_jpeg_rgb_strips":
        return pillow(im, format="TIFF", compression="jpeg", strip_size=640 * 3 * 32)
    if form == "tiff_jpeg_ycbcr420_tiles_tables":
        tiles, tables = [], None
        for y in range(0, rgb.shape[0], 128):
            for x in range(0, rgb.shape[1], 128):
                block = np.zeros((128, 128, 3), np.uint8)
                part = rgb[y:y + 128, x:x + 128]
                block[:part.shape[0], :part.shape[1]] = part
                t, body = tiffenc.jpeg_tables(pillow(Image.fromarray(block), format="JPEG",
                                                     quality=90))
                if tables not in (None, t):
                    raise RuntimeError("Pillow's JPEG tiles do not share their tables")
                tables = t
                tiles.append(body)
        return tiffenc.encode(rgb, compression=7, photometric=6, tile=(128, 128), chunks=tiles,
                              extra={530: (SHORT, [2, 2]),
                                     347: (tiffenc.UNDEFINED, tables)})
    ycc = chip_smoke.rgb_to_ycbcr(rgb)
    if form == "tiff_ycbcr22_lzw":
        return tiffenc.encode(ycc, compression=5, photometric=6, rows_per_strip=16,
                              subsampling=(2, 2), extra={530: (SHORT, [2, 2])})
    if form == "tiff_ycbcr42_deflate_tiles":
        return tiffenc.encode(ycc, compression=8, photometric=6, tile=(128, 128),
                              subsampling=(4, 2), extra={530: (SHORT, [4, 2])})
    if form == "bigtiff_rgb_lzw_pred2_tiles":
        return tiffenc.encode(rgb, compression=5, predictor=2, photometric=2, tile=(128, 128),
                              bigtiff=True)
    return chip_smoke.tiff_form_bytes(dict(entry, writer=form))


def digest(kind: str, data: bytes) -> tuple[str, np.ndarray]:
    decoded = Image.open(io.BytesIO(data))
    if kind == "colour":
        return decoded.mode, np.asarray(decoded.convert("RGB"))
    a = np.asarray(decoded)
    return decoded.mode, a.astype(a.dtype.newbyteorder("="))


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    jpegs = json.loads((chip_smoke.KLG_JPEG_DIR / "digests.json").read_text())["frames"]
    depth_files = sorted(chip_smoke.DEPTH_FORMS_DIR.glob("[0-9]*"))
    entries = []

    def add(entry: dict, data: bytes, kind: str, want: np.ndarray | None = None) -> None:
        mode, a = digest(kind, data)
        if want is not None and not np.array_equal(a, want):
            raise RuntimeError(f"{entry['file']}: Pillow does not read back the frame written")
        if entry["form"] not in RUNTIME:
            (OUT / entry["file"]).write_bytes(data)
        else:
            entry["writer"] = entry["form"]
        key = "rgb_sha256" if kind == "colour" else "depth_sha256"
        entry.update(kind=kind, width=a.shape[1], height=a.shape[0], bytes=len(data), mode=mode,
                     **({} if kind == "colour" else {"dtype": str(a.dtype)}))
        entry[key] = hashlib.sha256(a.tobytes()).hexdigest()
        entries.append(entry)
        print(f"{entry['file']}: {len(data)} bytes, mode {mode}"
              + (" (written at run time)" if entry["form"] in RUNTIME else ""))

    for i, form in enumerate(FORMS):
        source = jpegs[i]["file"]
        im = Image.open(chip_smoke.KLG_JPEG_DIR / source).convert("RGB")
        entry = dict(file=f"{i:03d}_{form}.tif", frame=i, form=form, source=source)
        lossless = form.startswith("bigtiff_rgb")
        add(entry, written(form, im, entry), "colour", np.asarray(im) if lossless else None)
    for i, form in DEPTH_FORMS:
        d16 = np.asarray(Image.open(depth_files[i]))
        d16 = d16.astype(d16.dtype.newbyteorder("=")).astype(np.uint16)
        entry = dict(file=f"{len(entries):03d}_{form}.tif", frame=i, form=form,
                     source=depth_files[i].name)
        data = (tiffenc.encode(d16, compression=8, tile=(128, 128), bigtiff=True)
                if form.endswith("tiles") else chip_smoke.tiff_form_bytes(dict(entry, writer=form)))
        add(entry, data, "depth", d16)
    d0 = np.asarray(Image.open(depth_files[0]))
    grey = Image.fromarray((d0.astype(d0.dtype.newbyteorder("=")) >> 8).astype(np.uint8))
    for form in GREY_FORMS:
        ext = "jpg" if form == "jpeg_grey" else "tif"
        entry = dict(file=f"{len(entries):03d}_{form}.{ext}", frame=0, form=form,
                     source=depth_files[0].name, sequence=False)
        data = (pillow(grey, format="JPEG", quality=90) if form == "jpeg_grey"
                else pillow(grey, format="TIFF", compression="jpeg"))
        add(entry, data, "depth")
    meta = dict(source="tests/data/klg_jpeg (colour) and tests/data/depth_forms (depth), "
                       "frame i in form i",
                writer=f"Pillow {PIL.__version__} and tests/torch_tiff_encoder.py",
                forms=list(FORMS), runtime=list(RUNTIME), frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    committed = sum(e["bytes"] for e in entries if "writer" not in e)
    print(f"{len(entries)} files, {committed} bytes committed -> {OUT}")


if __name__ == "__main__":
    main()
