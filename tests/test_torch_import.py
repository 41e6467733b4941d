"""The port runs where there is no JAX and stands alone from the JAX
package: importing the package, every one of its submodules (the sparse
backend's, the full system's, the real-data entry point's, the
distributed BA's, the row-sharded dense step's and the mesh's included) and
``chip_smoke``'s imports
leaves ``jax``, ``PIL``, ``zstandard`` and every ``hrbffusion3d_tpu`` module
out of ``sys.modules``, and succeeds with the four blocked.  Nothing of the
port includes ``jpeglib.h`` or links libjpeg (its native library links zlib
and pthread only), and its native loader compiles only
sources inside the port's package.  The port's copies of the JAX package's
numpy-only code (the BRIEF pattern, the reduction-plan construction,
``patch_information``, ``io/traj.py``, the loop closer's Horn alignment)
equal their originals.

The import probe runs in a fresh interpreter, because ``tests/conftest.py``
imports jax into the test process itself."""

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hrbffusion3d_tpu", "PIL", "zstandard"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
import hrbffusion3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: main() runs under __main__
leaked = sorted(m for m in sys.modules
                if m in ("jax", "hrbffusion3d_tpu", "PIL", "zstandard")
                or m.startswith(("jax.", "jaxlib", "hrbffusion3d_tpu.", "PIL.", "zstandard.")))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    # core, ops, map, tracking, pipeline, eval, utils, backend, io, viz and
    # their modules, the full system's (backend.loop, pipeline.full_slam,
    # io.traj, io.ply) and the real-data entry point's (run_tum, io.png,
    # io.tum, io.klg, io.native_loader, utils.timing, utils.params,
    # utils.checkpoint, viz.stats, viz.viewer, eval.recon, eval.mesh) and
    # the distributed BA's (parallel, parallel.sharding, parallel.dist_ba,
    # parallel.multihost) and the row-sharded step's (parallel.sharded_step,
    # parallel.mesh) and the JPEG decoder's binding (io.jpeg) and the
    # depth decoders and their dispatch (io.pnm, io.tiff, io.image) and the
    # BMP decoder and Pillow's modes (io.bmp, io.modes) and the GIF and
    # WebP readers (io.gif, io.webp) included
    assert int(n_modules) >= 65, out.stdout
    assert leaked == "[]", leaked
    for name in ("backend/brief_pattern", "backend/features", "backend/reduce_plan",
                 "backend/ba", "backend/keyframes", "backend/bow", "backend/vocab",
                 "backend/posegraph", "backend/loop", "pipeline/full_slam", "io/traj",
                 "io/ply", "run_tum", "io/png", "io/tum", "io/klg", "io/native_loader",
                 "io/jpeg", "io/pnm", "io/tiff", "io/image", "io/bmp", "io/modes", "io/gif",
                 "io/webp", "utils/timing", "utils/params",
                 "utils/checkpoint", "viz/stats", "viz/viewer", "eval/recon", "eval/mesh", "parallel/sharding",
                 "parallel/dist_ba", "parallel/multihost", "parallel/sharded_step"):
        assert (ROOT / "hrbffusion3d_tpu_torch" / f"{name}.py").exists(), name


def test_port_links_no_libjpeg():
    """Nothing of the port includes ``jpeglib.h`` or links libjpeg: its JPEG
    decoder is its own (``csrc/jpeg_decode.cpp``), as its Zstandard, CCITT,
    ThunderScan, WebP and GIF decoders are; the native library links zlib
    and pthread and nothing else (no libwebp)."""
    from hrbffusion3d_tpu_torch.io import native_loader

    port = ROOT / "hrbffusion3d_tpu_torch"
    sources = [p for p in port.rglob("*")
               if p.suffix in (".c", ".cc", ".cpp", ".cu", ".h", ".hpp", ".cuh")]
    assert any(p.name == "jpeg_decode.cpp" for p in sources)
    including = [str(p) for p in sources if "jpeglib.h" in p.read_text()]
    assert not including, including
    flags = native_loader._CXXFLAGS + native_loader._LDFLAGS
    assert not any("jpeg" in flag or "webp" in flag or "gif" in flag for flag in flags), flags
    assert [f for f in flags if f.startswith("-l")] == ["-lz", "-lpthread"], flags
    assert {"zstd_decode.cpp", "fax_decode.cpp", "vp8_decode.cpp", "vp8l_decode.cpp",
            "gif_decode.cpp"} <= {p.name for p in native_loader._SOURCES}


def test_native_loader_builds_only_the_ports_sources():
    """The native loader compiles files inside the port's package, never
    ``native/dataloader.cpp``."""
    from hrbffusion3d_tpu_torch.io import native_loader

    port = (ROOT / "hrbffusion3d_tpu_torch").resolve()
    assert native_loader._SOURCE.resolve().is_relative_to(port)
    for src in native_loader._SOURCES + native_loader._HEADERS:
        assert src.resolve().is_relative_to(port), src
        assert src.exists(), src


def test_numpy_copies_equal_their_originals():
    from hrbffusion3d_tpu.backend import brief_pattern as jbp
    from hrbffusion3d_tpu.backend import keyframes as jkf
    from hrbffusion3d_tpu.backend import reduce_plan as jrp
    from hrbffusion3d_tpu.config import CameraIntrinsics
    from hrbffusion3d_tpu_torch.backend import brief_pattern as tbp
    from hrbffusion3d_tpu_torch.backend import keyframes as tkf
    from hrbffusion3d_tpu_torch.backend import reduce_plan as trp
    from hrbffusion3d_tpu_torch.utils.convert import intrinsics_from_fields

    np.testing.assert_array_equal(tbp.LEARNED_PATTERN, jbp.LEARNED_PATTERN)
    assert tbp.LEARNED_PATTERN.dtype == jbp.LEARNED_PATTERN.dtype
    rng = np.random.default_rng(0)
    lm = rng.integers(0, 40, 300)
    cam = rng.integers(0, 6, 300)
    for a, b in zip(trp.build_pairs_np(lm), jrp.build_pairs_np(lm)):
        np.testing.assert_array_equal(a, b)
    for (it, rt), (ij, rj) in zip(trp.build_reduce_plan(lm, 40, 310, "cpu").tables,
                                  jrp.build_reduce_plan(lm, 40, 310).tables):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    cell_t = trp.build_cell_plan(cam, lm, 6, 310, n_real=250, device="cpu")
    cell_j = jrp.build_cell_plan(cam, lm, 6, 310, n_real=250)
    assert len(cell_t.tables) == len(cell_j.tables)
    for a, b in zip(cell_t.tables, cell_j.tables):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    intr = CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96)
    depth = rng.uniform(0.2, 3.0, (96, 128)).astype(np.float32)
    depth[:, 60:] += 1.0
    depth[::5, ::3] = 0.0
    xy = rng.uniform([-3, -3], [131, 99], (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tkf.patch_information(depth, xy, intrinsics_from_fields(intr.__dict__)),
        jkf.patch_information(depth, xy, intr))


def test_traj_and_horn_copies_equal_their_originals(tmp_path):
    """``io/traj.py`` is a verbatim copy below its docstring, and
    ``horn_se3`` / ``robust_se3_3d3d`` are copied function for function;
    both give the same numbers."""
    import inspect

    from hrbffusion3d_tpu.backend import loop as jloop
    from hrbffusion3d_tpu.io import traj as jtraj
    from hrbffusion3d_tpu_torch.backend import loop as tloop
    from hrbffusion3d_tpu_torch.io import traj as ttraj

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index('"""', 3) + 3:]

    assert body(ttraj) == body(jtraj)
    for name in ("horn_se3", "robust_se3_3d3d"):
        assert inspect.getsource(getattr(tloop, name)) == inspect.getsource(getattr(jloop, name))
    rng = np.random.default_rng(2)
    p = rng.normal(size=(40, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R[:, 0] *= np.linalg.det(R)                      # a rotation
    q = p @ R.T + 0.3
    q[:5] += 0.5                                     # outliers
    fit_t, fit_j = tloop.robust_se3_3d3d(p, q), jloop.robust_se3_3d3d(p, q)
    assert fit_t[1] == fit_j[1] == 35
    np.testing.assert_array_equal(fit_t[0], fit_j[0])
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    ttraj.save_tum(str(tmp_path / "t.txt"), [0.0, 1.0, 2.0], poses)
    jtraj.save_tum(str(tmp_path / "j.txt"), [0.0, 1.0, 2.0], poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
