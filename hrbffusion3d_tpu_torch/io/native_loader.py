"""ctypes binding for the native prefetching .klg loader
(``native/dataloader.cpp``); falls back to the Python reader (``io/klg.py``)
when the library cannot be built or loaded.

The JAX package loads a prebuilt ``native/libhrbfio.so``.  The port never
reads or writes that file: at first use it builds ``native/dataloader.cpp``
with the host C++ compiler and the flags of ``native/Makefile`` into
``hrbffusion3d_tpu_torch/_build/`` (named by the hash of the source and the
command, so a changed source is rebuilt), beside the CUDA kernels.  The
loader decodes zlib depth and JPEG colour (libjpeg) on a worker thread of
its own.

``status()`` says which reader the last ``frames`` call ran (``"native"``
or ``"python"``) and, when the build or the load failed, why: the
compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator

import numpy as np

from . import klg
from .klg import KLGFrame

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile: CXXFLAGS and LDFLAGS
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
_LDFLAGS = ["-shared", "-lz", "-ljpeg", "-lpthread"]

_LIB = None
_STATUS = {"reader": None, "build_error": None, "library": None}


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise FileNotFoundError("no C++ compiler found (CXX, c++, g++)")


def _build() -> Path:
    """Build the library where needed; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    if not _SOURCE.exists():
        raise FileNotFoundError(f"native loader source not found: {_SOURCE}")
    cxx = _compiler()
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(
        [cxx] + _CXXFLAGS + _LDFLAGS).encode()).hexdigest()[:16]
    lib = _BUILD / f"libhrbfio_{key}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f".libhrbfio_{key}.{os.getpid()}.so"
    out = subprocess.run([cxx, *_CXXFLAGS, str(_SOURCE), "-o", str(tmp), *_LDFLAGS],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cxx).name} failed ({out.returncode}) on {_SOURCE.name}:\n"
                           + (out.stderr or out.stdout).strip())
    os.replace(tmp, lib)
    return lib


def _load_lib():
    path = _build()
    lib = ctypes.CDLL(str(path))
    lib.klg_open.restype = ctypes.c_void_p
    lib.klg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.klg_num_frames.restype = ctypes.c_int
    lib.klg_num_frames.argtypes = [ctypes.c_void_p]
    lib.klg_next.restype = ctypes.c_int
    lib.klg_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.klg_close.restype = None
    lib.klg_close.argtypes = [ctypes.c_void_p]
    _STATUS["library"] = str(path)
    return lib


def available() -> bool:
    """Whether the native loader is built and loaded (tried once per
    process; the reason of a failure is kept in ``status()``)."""
    global _LIB
    if _LIB is None and _STATUS["build_error"] is None:
        try:
            _LIB = _load_lib()
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _STATUS["build_error"] = f"{type(e).__name__}: {e}"
    return _LIB is not None


def status() -> dict:
    """{"reader": the reader of the last ``frames`` call, "build_error":
    why the native loader is unavailable (None when it loaded),
    "library": the loaded library's path}."""
    return dict(_STATUS)


def frames(path: str, width: int = 640, height: int = 480,
           depth_scale: float = 1.0 / 1000.0) -> Iterator[KLGFrame]:
    """Stream frames through the native double-buffered decoder, or
    through the Python reader when it is unavailable."""
    if not available():
        _STATUS["reader"] = "python"
        yield from klg.frames(path, width, height, depth_scale)
        return

    _STATUS["reader"] = "native"
    h = _LIB.klg_open(str(path).encode(), width, height, depth_scale)
    if not h:
        raise IOError(f"cannot open {path}")
    try:
        depth = np.empty((height, width), np.float32)
        rgb = np.empty((height, width, 3), np.float32)
        ts = ctypes.c_int64()
        while _LIB.klg_next(
            h,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(ts),
        ):
            yield KLGFrame(int(ts.value), depth.copy(), rgb.copy())
    finally:
        _LIB.klg_close(h)
