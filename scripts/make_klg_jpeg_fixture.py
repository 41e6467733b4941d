"""Write the JPEG colour fixture of ``tests/data/klg_jpeg/``.

The first 20 colour frames of ``chip_smoke``'s TUM-format fixture
(``chip_smoke.tum_frames``: bench.py's full-system protocol, 640x480, the
same seeds), rendered on the CPU and written by Pillow at quality 90 with
4:2:0 chroma sampling, one ``NNN.jpg`` per frame, and ``digests.json``: per
file its settings, its size and the sha256 of Pillow's RGB decode of it.

``chip_smoke.py`` (phase run_tum (c)) assembles a JPEG-colour .klg from
these files and the card's depth frames and holds both of the port's
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

OUT = ROOT / "tests" / "data" / "klg_jpeg"
FRAMES, QUALITY, SUBSAMPLING = 20, 90, "4:2:0"


def main() -> None:
    torch.set_num_threads(4)
    _, _, rgbs = chip_smoke.tum_frames(torch.device("cpu"), first=FRAMES)
    OUT.mkdir(parents=True, exist_ok=True)
    entries = []
    for i, rgb in enumerate(rgbs):
        rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)    # io/klg.write's rounding
        buf = io.BytesIO()
        Image.fromarray(rgb8).save(buf, format="JPEG", quality=QUALITY, subsampling=SUBSAMPLING)
        data = buf.getvalue()
        name = f"{i:03d}.jpg"
        (OUT / name).write_bytes(data)
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        entries.append(dict(file=name, frame=i, width=rgb8.shape[1], height=rgb8.shape[0],
                            quality=QUALITY, subsampling=SUBSAMPLING, bytes=len(data),
                            rgb_sha256=hashlib.sha256(decoded.tobytes()).hexdigest()))
    meta = dict(source="chip_smoke.tum_frames(cpu), first 20 of RUN_TUM_FRAMES",
                writer=f"Pillow {PIL.__version__}", frames=entries)
    (OUT / "digests.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"{len(entries)} frames, {sum(e['bytes'] for e in entries)} bytes -> {OUT}")


if __name__ == "__main__":
    main()
