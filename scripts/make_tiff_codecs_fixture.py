"""Write the TIFF-codecs fixture of ``tests/data/tiff_codecs/``.

The depth of the first 9 frames of ``tests/data/depth_forms`` (as Pillow
decodes them, 16-bit), frame i in form i, compressed with the codecs that
current tools write (tifffile's ``compression="zstd"``, GDAL's
``COMPRESS=ZSTD`` / ``LZMA``, OpenCV's ``IMWRITE_TIFF_COMPRESSION``) and
Pillow 12.1 reads through libtiff:

  0. ZSTD (50000), predictor 1, written by Pillow;
  1. ZSTD, predictor 2, written by Pillow;
  2. ZSTD, predictor 1, big-endian, 32 rows a strip;
  3. ZSTD, predictor 2, big-endian, 32 rows a strip;
  4. ZSTD, predictor 2, 128x128 tiles;
  5. BigTIFF ZSTD, predictor 2, 64 rows a strip;
  6. LZMA (34925), predictor 1, written by Pillow;
  7. LZMA, predictor 2, written by Pillow;
  8. LZMA, predictor 2, big-endian, 128x128 tiles;

the colour of frames 0-2 (``tests/data/klg_jpeg``'s JPEGs, decoded by
Pillow): ZSTD RGB with predictor 2 (Pillow's writer), LZMA RGB with
predictor 2, 32 rows a strip, and ZSTD YCbCr with YCbCrSubSampling (2, 2),
16 rows a strip (the frame in ``chip_smoke.rgb_to_ycbcr``); and, held to
their digests only (a 1- or 4-bit image cannot carry a scene), frame 0's
grey (Pillow's ``convert("L")``) above 128 as CCITT group 3 2D with fill
bits (64 rows a strip), group 4 (Pillow's writer) and RLE/W (fill order
2, 64 rows a strip), and its high 4 bits as ThunderScan (64 rows a strip).
The encoders are ``tests/torch_tiff_encoder.py``'s (ZSTD by ``zstandard``
at level 19, LZMA by Python's ``lzma`` at preset 9).

``digests.json`` holds per file its form, size, Pillow's mode and the
sha256 of Pillow's ``Image.open(...).convert("RGB")`` (colour) or
``np.asarray(Image.open(...))`` in native byte order (depth; a mode ``1``
array as bytes 0 and 1), what the JAX package's TUM reader decodes.
``chip_smoke.py`` phase run_tum (l) runs
``run_tum`` on a TUM directory of these files and holds the port's
decoders to the digests; ``tests/test_torch_image_tiff_codecs.py`` holds
Pillow and the port to them.  Needs Pillow and ``zstandard``; run from the
repository root (a few seconds):

    python3 scripts/make_tiff_codecs_fixture.py
"""

from __future__ import annotations

import hashlib
import io
import json
import lzma
import sys
from pathlib import Path

import numpy as np
import PIL
import zstandard
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import torch_tiff_encoder as tiffenc  # noqa: E402

OUT = ROOT / "tests" / "data" / "tiff_codecs"
DEPTH_FORMS = ("zstd_pred1", "zstd_pred2", "zstd_pred1_mm", "zstd_pred2_mm",
               "zstd_pred2_tiles", "bigtiff_zstd_pred2", "lzma_pred1", "lzma_pred2",
               "lzma_pred2_mm_tiles")
COLOUR_FORMS = ("zstd_rgb_pred2", "lzma_rgb_pred2", "zstd_ycbcr22")
BILEVEL_FORMS = ("ccitt_g3_2d", "ccitt_g4", "ccitt_rlew", "thunderscan")


def zstd(raw: bytes) -> bytes:
    return zstandard.ZstdCompressor(level=19).compress(raw)


def xz(raw: bytes) -> bytes:
    return lzma.compress(raw, preset=9)


def pillow(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="TIFF", **kw)
    return buf.getvalue()


def depth_bytes(form: str, d16: np.ndarray) -> bytes:
    im = Image.fromarray(d16)
    pred = 2 if "pred2" in form else 1
    if form in ("zstd_pred1", "zstd_pred2", "lzma_pred1", "lzma_pred2"):
        return pillow(im, compression=form[:4], tiffinfo={317: pred})
    order = "MM" if form.endswith(("_mm", "_mm_tiles")) else "II"
    kw = dict(compression=tiffenc.LZMA if form.startswith("lzma") else tiffenc.ZSTD,
              predictor=pred, compressor=xz if form.startswith("lzma") else zstd,
              bigtiff=form.startswith("bigtiff"))
    if form.endswith("tiles"):
        kw["tile"] = (128, 128)
    else:
        kw["rows_per_strip"] = 64 if kw["bigtiff"] else 32
    return tiffenc.encode(d16, order, **kw)


def colour_bytes(form: str, im: Image.Image) -> bytes:
    rgb = np.asarray(im)
    if form == "zstd_rgb_pred2":
        return pillow(im, compression="zstd", tiffinfo={317: 2})
    if form == "lzma_rgb_pred2":
        return tiffenc.encode(rgb, compression=tiffenc.LZMA, predictor=2, photometric=2,
                              rows_per_strip=32, compressor=xz)
    return tiffenc.encode(chip_smoke.rgb_to_ycbcr(rgb), compression=tiffenc.ZSTD,
                          photometric=6, rows_per_strip=16, subsampling=(2, 2),
                          extra={530: (tiffenc.SHORT, [2, 2])}, compressor=zstd)


def bilevel_bytes(form: str, grey: np.ndarray) -> bytes:
    bw = (grey > 128).astype(np.uint8)
    if form == "ccitt_g3_2d":
        return tiffenc.encode(bw, compression=3, photometric=0, bits=1, rows_per_strip=64,
                              fax_options=5)
    if form == "ccitt_g4":
        return pillow(Image.fromarray(bw.astype(bool)), compression="group4")
    if form == "ccitt_rlew":
        return tiffenc.encode(bw, compression=32771, photometric=0, bits=1, fill_order=2,
                              rows_per_strip=64)
    return tiffenc.encode(grey >> 4, compression=32809, photometric=1, bits=4,
                          rows_per_strip=64)


def digest(kind: str, data: bytes) -> tuple[str, np.ndarray]:
    decoded = Image.open(io.BytesIO(data))
    if kind == "colour":
        return decoded.mode, np.asarray(decoded.convert("RGB"))
    a = np.asarray(decoded)
    if a.dtype == bool:
        return decoded.mode, a != 0  # Pillow's mode-1 array holds its True as byte 255
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
        (OUT / entry["file"]).write_bytes(data)
        key = "rgb_sha256" if kind == "colour" else "depth_sha256"
        entry.update(kind=kind, width=a.shape[1], height=a.shape[0], bytes=len(data), mode=mode,
                     **({} if kind == "colour" else {"dtype": str(a.dtype)}))
        entry[key] = hashlib.sha256(a.tobytes()).hexdigest()
        entries.append(entry)
        print(f"{entry['file']}: {len(data)} bytes, mode {mode}")

    for i, form in enumerate(DEPTH_FORMS):
        d16 = np.asarray(Image.open(depth_files[i]))
        d16 = d16.astype(d16.dtype.newbyteorder("=")).astype(np.uint16)
        entry = dict(file=f"{len(entries):03d}_{form}.tif", frame=i, form=form,
                     source=depth_files[i].name)
        add(entry, depth_bytes(form, d16), "depth", d16)
    for i, form in enumerate(COLOUR_FORMS):
        source = jpegs[i]["file"]
        im = Image.open(chip_smoke.KLG_JPEG_DIR / source).convert("RGB")
        entry = dict(file=f"{len(entries):03d}_{form}.tif", frame=i, form=form, source=source)
        add(entry, colour_bytes(form, im), "colour",
            None if form == "zstd_ycbcr22" else np.asarray(im))
    grey = np.asarray(Image.open(chip_smoke.KLG_JPEG_DIR / jpegs[0]["file"]).convert("L"))
    for form in BILEVEL_FORMS:
        entry = dict(file=f"{len(entries):03d}_{form}.tif", frame=0, form=form,
                     source=jpegs[0]["file"], sequence=False)
        add(entry, bilevel_bytes(form, grey), "depth")
    meta = dict(source="tests/data/depth_forms (depth, frame i in form i), tests/data/klg_jpeg "
                       "(colour of frames 0-2; frame 0's grey for the bilevel and 4-bit forms)",
                writer=f"Pillow {PIL.__version__}, zstandard {zstandard.__version__} and "
                       "tests/torch_tiff_encoder.py",
                forms=list(DEPTH_FORMS), colour_forms=list(COLOUR_FORMS),
                bilevel_forms=list(BILEVEL_FORMS), frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} files, {sum(e['bytes'] for e in entries)} bytes -> {OUT}")


if __name__ == "__main__":
    main()
