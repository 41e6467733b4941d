"""Write the JPEG colour fixtures of ``tests/data/klg_jpeg/`` (baseline)
and ``tests/data/tum_jpeg_progressive/`` (progressive).

The first 20 colour frames of ``chip_smoke``'s TUM-format fixture
(``chip_smoke.tum_frames``: bench.py's full-system protocol, 640x480, the
same seeds), rendered on the CPU and written by Pillow at quality 90 with
4:2:0 chroma sampling, one ``NNN.jpg`` per frame, once baseline and once
progressive, and in each directory ``digests.json``: per file its
settings, its size and the sha256 of Pillow's RGB decode of it.  The two
encodings differ only in their entropy coding, so each progressive frame
must decode to its baseline frame's digest; the script fails if one does
not.

``chip_smoke.py`` assembles a JPEG-colour .klg from the baseline files
and the card's depth frames (phase run_tum (c)) and a TUM-layout sequence
from the progressive files (phase run_tum (g)), and holds the port's
readers to the digests; ``tests/test_torch_jpeg.py`` holds Pillow and the
port's decoder to them.  Needs Pillow; run from the repository root:

    python3 scripts/make_klg_jpeg_fixture.py
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

import chip_smoke  # noqa: E402

OUT = {False: ROOT / "tests" / "data" / "klg_jpeg",
       True: ROOT / "tests" / "data" / "tum_jpeg_progressive"}
FRAMES, QUALITY, SUBSAMPLING = 20, 90, "4:2:0"


def _write(rgbs, progressive: bool) -> list[dict]:
    out = OUT[progressive]
    out.mkdir(parents=True, exist_ok=True)
    entries = []
    for i, rgb8 in enumerate(rgbs):
        buf = io.BytesIO()
        Image.fromarray(rgb8).save(buf, format="JPEG", quality=QUALITY, subsampling=SUBSAMPLING,
                                   progressive=progressive)
        data = buf.getvalue()
        name = f"{i:03d}.jpg"
        (out / name).write_bytes(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        entry = dict(file=name, frame=i, width=rgb8.shape[1], height=rgb8.shape[0],
                     quality=QUALITY, subsampling=SUBSAMPLING, bytes=len(data),
                     rgb_sha256=hashlib.sha256(decoded.tobytes()).hexdigest())
        if progressive:
            entry["progressive"] = True
        entries.append(entry)
    meta = dict(source="chip_smoke.tum_frames(cpu), first 20 of RUN_TUM_FRAMES",
                writer=f"Pillow {PIL.__version__}", frames=entries)
    (out / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} frames, {sum(e['bytes'] for e in entries)} bytes -> {out}")
    return entries


def main() -> None:
    torch.set_num_threads(4)
    _, _, rgbs = chip_smoke.tum_frames(torch.device("cpu"), first=FRAMES)
    rgb8 = [(np.clip(rgb, 0, 1) * 255).astype(np.uint8) for rgb in rgbs]  # io/klg.write's
    baseline = _write(rgb8, False)
    progressive = _write(rgb8, True)
    differ = [p["file"] for b, p in zip(baseline, progressive)
              if p["rgb_sha256"] != b["rgb_sha256"]]
    if differ:
        raise SystemExit(f"progressive frames {differ} decode to other pixels than their "
                         "baseline frames")


if __name__ == "__main__":
    main()
