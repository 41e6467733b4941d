"""Write the depth-forms fixture of ``tests/data/depth_forms/``.

The first 9 depth frames of ``chip_smoke``'s TUM-format fixture
(``chip_smoke.tum_frames``: bench.py's full-system protocol, 640x480, the
frames whose colour ``tests/data/klg_jpeg`` holds), rendered on the CPU
and stored as TUM depth (16-bit, 5000 per metre), frame i in form i:

  0. binary PGM (``P5``, maxval 65535), written by Pillow;
  1-8. 16-bit grey TIFF with no compression, PackBits, deflate and LZW
     with predictor 2, each little-endian (``II``, written by Pillow) and
     big-endian (``MM``, written by ``tests/torch_tiff_encoder.py``, as
     Pillow writes no big-endian TIFF; 16 rows a strip).

``digests.json`` holds per file its form, size and the sha256 of Pillow's
``np.asarray(Image.open(...))`` in native byte order (what the JAX
package's TUM reader decodes).  ``chip_smoke.py`` phase run_tum (i) runs
``run_tum`` on a TUM directory of these files, with the klg_jpeg
fixture's JPEGs as colour (every second one as PNG), and holds the port's
decoders to the digests; ``tests/test_torch_image_depth.py`` holds Pillow
and the port to them.  Needs Pillow; run from the repository root (about
20 s):

    python3 scripts/make_depth_forms_fixture.py
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import PIL
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import torch_tiff_encoder as enc  # noqa: E402
from hrbffusion3d_tpu_torch.io import tum  # noqa: E402

OUT = ROOT / "tests" / "data" / "depth_forms"
# (name, file suffix, writer): every form once
FORMS = (("pgm16", "pgm", dict(format="PPM")),
         ("tiff_II_none", "tif", dict(format="TIFF")),
         ("tiff_MM_none", "tif", dict(order="MM", compression=1)),
         ("tiff_II_packbits", "tif", dict(format="TIFF", compression="packbits")),
         ("tiff_MM_packbits", "tif", dict(order="MM", compression=32773)),
         ("tiff_II_deflate", "tif", dict(format="TIFF", compression="tiff_adobe_deflate")),
         ("tiff_MM_deflate", "tif", dict(order="MM", compression=8)),
         ("tiff_II_lzw_pred2", "tif", dict(format="TIFF", compression="tiff_lzw",
                                           tiffinfo={317: 2})),
         ("tiff_MM_lzw_pred2", "tif", dict(order="MM", compression=5, predictor=2)))


def encode(d16: np.ndarray, writer: dict) -> bytes:
    if "order" in writer:
        return enc.encode(d16, rows_per_strip=16, **writer)
    buf = io.BytesIO()
    Image.fromarray(d16).save(buf, **writer)
    return buf.getvalue()


def main() -> None:
    torch.set_num_threads(4)
    _, depths, _ = chip_smoke.tum_frames(torch.device("cpu"), first=len(FORMS))
    OUT.mkdir(parents=True, exist_ok=True)
    entries = []
    for i, (depth, (form, suffix, writer)) in enumerate(zip(depths, FORMS)):
        # io/tum.write_sequence's quantisation
        d16 = np.clip(np.round(depth / tum.TUM_DEPTH_SCALE), 0, 65535).astype(np.uint16)
        data = encode(d16, writer)
        name = f"{i:03d}_{form}.{suffix}"
        (OUT / name).write_bytes(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        decoded = decoded.astype(decoded.dtype.newbyteorder("="))
        if not np.array_equal(decoded, d16):
            raise RuntimeError(f"{name}: Pillow does not read back the frame written")
        entries.append(dict(file=name, frame=i, form=form, width=d16.shape[1],
                            height=d16.shape[0], bytes=len(data), dtype=str(decoded.dtype),
                            depth_sha256=hashlib.sha256(decoded.tobytes()).hexdigest()))
        print(f"{name}: {len(data)} bytes, {decoded.dtype}")
    meta = dict(source=f"chip_smoke.tum_frames(cpu), first {len(FORMS)} of RUN_TUM_FRAMES",
                writer=f"Pillow {PIL.__version__} and tests/torch_tiff_encoder.py",
                forms=[f for f, _, _ in FORMS], frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} frames, {sum(e['bytes'] for e in entries)} bytes -> {OUT}")


if __name__ == "__main__":
    main()
