"""Write the JPEG-forms fixture of ``tests/data/jpeg_forms/``.

The first 20 colour frames of ``chip_smoke``'s TUM-format fixture
(``chip_smoke.tum_frames``: bench.py's full-system protocol, 640x480, the
same frames as ``tests/data/klg_jpeg``), rendered on the CPU, frame i
written in form i mod 7:

  0. CMYK, written by Pillow (the frame converted with ``Image.convert``);
  1. YCCK (Adobe transform 2), 4:2:0, K at 255 so that the frame's colour
     comes back;
  2. luma sampled 4x1 (chroma 1x1), Huffman-coded;
  3. lossless (SOF3) RGB, one scan per component, the predictor cycling
     through 1-7 over the lossless frames' scans, point transform 1, a
     restart every 60 rows;
  4. arithmetic-coded sequential (SOF9), 4:2:0, a restart every 40 MCUs;
  5. arithmetic-coded progressive (SOF10), 4:2:0, libjpeg's scan script;
  6. progressive written by Pillow (quality 90, 4:2:0) with its
     refinement scans cut out: libjpeg-turbo smooths its blocks.

Forms 1-5 come from ``tests/torch_jpeg_encoders.py`` (numpy), since
Pillow cannot write them.  ``digests.json`` holds per file its form, size
and the sha256 of Pillow's ``Image.open(...).convert("RGB")`` of it.
``chip_smoke.py`` phase run_tum (h) runs ``run_tum`` on a TUM directory of
these files and holds the port's decoder and both .klg readers to the
digests; ``tests/test_torch_jpeg_forms.py`` holds Pillow and the port to
them.  Needs Pillow; run from the repository root (about a minute, most
of it the arithmetic coder in Python):

    python3 scripts/make_jpeg_forms_fixture.py
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
import torch_jpeg_encoders as enc  # noqa: E402

OUT = ROOT / "tests" / "data" / "jpeg_forms"
FRAMES = 20
FORMS = ("cmyk", "ycck", "h4v1", "lossless", "arithmetic", "arithmetic_progressive",
         "unrefined_progressive")
QUALITY = 90
S420 = [(2, 2), (1, 1), (1, 1)]


def _pillow(img: np.ndarray, mode: str, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _no_refinement(data: bytes) -> bytes:
    """The stream without its refinement scans (Ah > 0), EOI kept."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            return bytes(out + data[pos:pos + 2])
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            ns = data[pos + 4]
            if data[pos + 7 + 2 * ns] >> 4:
                pos = end
                continue
        out += data[pos:end]
        pos = end
    raise ValueError("no EOI")


def encode(rgb: np.ndarray, form: str, lossless_index: int) -> tuple[bytes, dict]:
    """One frame in ``form``; returns the stream and its settings."""
    h, w, _ = rgb.shape
    if form == "cmyk":
        cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
        return _pillow(cmyk, "CMYK", quality=QUALITY), dict(quality=QUALITY, writer="Pillow")
    if form == "ycck":
        planes = np.dstack([enc.rgb_to_ycc(255 - rgb), np.full((h, w), 255, np.uint8)])
        return (enc.dct_stream(planes, S420 + [(2, 2)], QUALITY, transform=2),
                dict(quality=QUALITY, sampling="2x2,1x1,1x1,2x2", transform=2))
    if form == "h4v1":
        return (enc.dct_stream(enc.rgb_to_ycc(rgb), [(4, 1), (1, 1), (1, 1)], QUALITY),
                dict(quality=QUALITY, sampling="4x1,1x1,1x1"))
    if form == "lossless":
        psv = [1 + (3 * lossless_index + s) % 7 for s in range(3)]
        data = enc.lossless_stream([rgb[..., c] >> 1 for c in range(3)], w, h, psv=psv, pt=1,
                                   jfif=False, interleave=False, restart_rows=60)
        return data, dict(predictors=psv, point_transform=1, restart_rows=60)
    if form == "arithmetic":
        return (enc.dct_stream(enc.rgb_to_ycc(rgb), S420, QUALITY, arithmetic=True, restart=40),
                dict(quality=QUALITY, sampling="4:2:0", restart_mcus=40))
    if form == "arithmetic_progressive":
        return (enc.dct_stream(enc.rgb_to_ycc(rgb), S420, QUALITY, arithmetic=True,
                               script=enc.FULL_PROGRESSION),
                dict(quality=QUALITY, sampling="4:2:0"))
    data = _pillow(rgb, "RGB", quality=QUALITY, subsampling="4:2:0", progressive=True)
    return _no_refinement(data), dict(quality=QUALITY, sampling="4:2:0", writer="Pillow")


def main() -> None:
    torch.set_num_threads(4)
    _, _, rgbs = chip_smoke.tum_frames(torch.device("cpu"), first=FRAMES)
    rgb8 = [(np.clip(rgb, 0, 1) * 255).astype(np.uint8) for rgb in rgbs]  # io/klg.write's
    OUT.mkdir(parents=True, exist_ok=True)
    entries = []
    for i, rgb in enumerate(rgb8):
        form = FORMS[i % len(FORMS)]
        data, settings = encode(rgb, form, i // len(FORMS))
        name = f"{i:03d}_{form}.jpg"
        (OUT / name).write_bytes(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        err = float(np.abs(decoded.astype(int) - rgb).mean())
        entries.append(dict(file=name, frame=i, form=form, width=rgb.shape[1],
                            height=rgb.shape[0], bytes=len(data), **settings,
                            mean_abs_err_vs_render=round(err, 3),
                            rgb_sha256=hashlib.sha256(decoded.tobytes()).hexdigest()))
        print(f"{name}: {len(data)} bytes, mean |Pillow - render| {err:.2f}")
    meta = dict(source="chip_smoke.tum_frames(cpu), first 20 of RUN_TUM_FRAMES",
                writer=f"Pillow {PIL.__version__} and tests/torch_jpeg_encoders.py",
                forms=list(FORMS), frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} frames, {sum(e['bytes'] for e in entries)} bytes -> {OUT}")


if __name__ == "__main__":
    main()
