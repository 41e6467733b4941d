"""ctypes binding for the native prefetching .klg loader
(``csrc/klg_loader.cpp``, the port's own copy of ``native/dataloader.cpp``);
falls back to the Python reader (``io/klg.py``) when the library cannot be
built or loaded.

The JAX package loads a prebuilt ``native/libhrbfio.so``.  The port never
reads that file and builds nothing outside its package: at first use it
compiles (one compiler a source, in parallel, then a link)
``csrc/klg_loader.cpp``, the port's JPEG decoder
``csrc/jpeg_decode.cpp``, its TIFF strip decompressors
``csrc/tiff_decode.cpp`` (with its Zstandard decoder
``csrc/zstd_decode.cpp`` and its CCITT and ThunderScan decoders
``csrc/fax_decode.cpp``) and its BMP run-length decoder
``csrc/bmp_decode.cpp`` with the host C++ compiler into one library in
``hrbffusion3d_tpu_torch/_build/`` (named by the hash of every source file
it reads and the command, so a changed source is rebuilt), beside the CUDA
kernels.  It links zlib and nothing else: no libjpeg.  The loader decodes
zlib depth and JPEG colour on a worker thread of its own (a PNG, BMP,
netpbm or TIFF colour payload is an error that names it: ``io/klg.frames``
reads those); ``io/jpeg``,
``io/tiff`` and ``io/bmp`` call the same library's decoders.

A frame that fails to decode (a corrupt zlib or JPEG payload, a payload cut
short, a JPEG whose size is not ``width`` x ``height``) raises
``RuntimeError`` naming the frame's index, after the frames before it.

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

# klg imports io/image, whose io/jpeg and io/tiff import this module: klg's
# names are read at call time, not bound here
from . import klg

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "klg_loader.cpp"
# every file the build reads: the compiled sources and the header
_SOURCES = (_SOURCE, _CSRC / "jpeg_decode.cpp", _CSRC / "tiff_decode.cpp",
            _CSRC / "zstd_decode.cpp", _CSRC / "fax_decode.cpp", _CSRC / "bmp_decode.cpp")
_HEADERS = (_CSRC / "jpeg_decode.h", _CSRC / "tiff_codecs.h")
_BUILD = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's flags, without libjpeg
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
_LDFLAGS = ["-shared", "-lz", "-lpthread"]

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
    for src in _SOURCES + _HEADERS:
        if not src.exists():
            raise FileNotFoundError(f"native loader source not found: {src}")
    cxx = _compiler()
    key = hashlib.sha256(b"".join(src.read_bytes() for src in _SOURCES + _HEADERS) + " ".join(
        [cxx] + _CXXFLAGS + _LDFLAGS).encode()).hexdigest()[:16]
    lib = _BUILD / f"libhrbfio_{key}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f".libhrbfio_{key}.{os.getpid()}"
    objs = [Path(f"{tmp}.{src.stem}.o") for src in _SOURCES]
    # one compiler a source, all started together, then the link
    jobs = [subprocess.Popen([cxx, *_CXXFLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_SOURCES, objs)]
    try:
        failed = []
        for src, job in zip(_SOURCES, jobs):
            out = job.communicate(timeout=300)[0]
            if job.returncode != 0:
                failed.append((src, job.returncode, out))
        if not failed:
            link = subprocess.run([cxx, *map(str, objs), "-o", f"{tmp}.so", *_LDFLAGS],
                                  capture_output=True, text=True, timeout=300)
            if link.returncode != 0:
                failed = [(Path("the link"), link.returncode, link.stderr or link.stdout)]
    finally:
        for job in jobs:
            job.kill()
            job.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        Path(f"{tmp}.so").unlink(missing_ok=True)
        raise RuntimeError("\n".join(f"{Path(cxx).name} failed ({rc}) on {src.name}:\n"
                                     + out.strip() for src, rc, out in failed))
    os.replace(f"{tmp}.so", lib)
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
    lib.klg_error.restype = ctypes.c_char_p
    lib.klg_error.argtypes = [ctypes.c_void_p]
    lib.klg_close.restype = None
    lib.klg_close.argtypes = [ctypes.c_void_p]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.tiff_decompress.restype = ctypes.c_int
    lib.tiff_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.bmp_rle_decode.restype = ctypes.c_int
    lib.bmp_rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int,
    ]
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


def library(what: str):
    """The loaded library for ``what`` (a decoder's name, for the error):
    ``RuntimeError`` naming the build error when it cannot be built or
    loaded."""
    if not available():
        raise RuntimeError(f"{what} unavailable: the native library did not build: "
                           f"{_STATUS['build_error']}")
    return _LIB


def status() -> dict:
    """{"reader": the reader of the last ``frames`` call, "build_error":
    why the native loader is unavailable (None when it loaded),
    "library": the loaded library's path}."""
    return dict(_STATUS)


def frames(path: str, width: int = 640, height: int = 480,
           depth_scale: float = 1.0 / 1000.0) -> Iterator[klg.KLGFrame]:
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
        while (got := _LIB.klg_next(
            h,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(ts),
        )) == 1:
            yield klg.KLGFrame(int(ts.value), depth.copy(), rgb.copy())
        if got < 0:
            raise RuntimeError(f"{path}: {_LIB.klg_error(h).decode()}")
    finally:
        _LIB.klg_close(h)
