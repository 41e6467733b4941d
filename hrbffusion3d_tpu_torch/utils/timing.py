"""Per-stage timing instrumentation (port of
``hrbffusion3d_tpu/utils/timing.py``).

Replaces the reference's ``Stopwatch`` singleton + TICK/TOCK macros
(``Core/src/Utils/Stopwatch.h:68-84``, per-frame maps dumped to
``sequence_processing_time.txt`` in ``~HRBFFusion``, HRBFFusion.cpp:172-187),
and its UDP broadcast to Stopviz.

The times are host wall times.  Work on the card is queued
asynchronously, so a region's time includes the card's work only when the
region ends in a host read of a result (``FullSLAM.process`` returns the
pose as numpy, which waits for the step) or when ``time(..., sync=t)`` is
given a tensor: its device is synchronised before the clock stops.
"""

from __future__ import annotations

import contextlib
import json
import socket
import time
from collections import defaultdict

import numpy as np
import torch


class Stopwatch:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str, sync: torch.Tensor | None = None):
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.samples[name].append(time.perf_counter() - t0)

    def tick(self, name: str):
        self._t0 = (name, time.perf_counter())

    def tock(self, name: str):
        n, t0 = self._t0
        if n != name:
            raise ValueError(f"mismatched tick/tock: {n} vs {name}")
        self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "mean_ms": float(a.mean() * 1000),
                "min_ms": float(a.min() * 1000),
                "max_ms": float(a.max() * 1000),
                "count": len(xs),
            }
        return out

    def dump(self, path: str):
        """sequence_processing_time.txt-style dump."""
        with open(path, "w") as f:
            for name, stats in self.summary().items():
                f.write(f"{name} mean={stats['mean_ms']:.3f}ms "
                        f"min={stats['min_ms']:.3f}ms "
                        f"max={stats['max_ms']:.3f}ms n={stats['count']}\n")

    def broadcast(self, host: str = "127.0.0.1", port: int = 45454,
                  signature: int = 0):
        """UDP telemetry packet — the reference Stopwatch streams its timing
        map to the external Stopviz tool every TOCK (Stopwatch.h:136-144,
        signature at HRBFFusion.cpp:63).  One JSON datagram
        {signature, {name: last_ms}} per call; fires and forgets (no
        listener required)."""
        last = {n: xs[-1] * 1000.0 for n, xs in self.samples.items() if xs}
        payload = json.dumps({"signature": signature, "timings_ms": last}).encode()
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.sendto(payload, (host, port))
        except OSError:
            pass  # telemetry must never take the pipeline down
        finally:
            s.close()
