"""The port runs where there is no JAX and stands alone from the JAX
package: importing the package, every one of its submodules (the sparse
backend's included) and ``chip_smoke``'s imports leaves ``jax`` and every
``hrbffusion3d_tpu`` module out of ``sys.modules``, and succeeds with both
blocked.  The port's copies of the JAX package's numpy-only code (the
BRIEF pattern, the reduction-plan builders, ``patch_information``) equal
their originals.

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
        if name.split(".")[0] in ("jax", "jaxlib", "hrbffusion3d_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
import hrbffusion3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: main() runs under __main__
leaked = sorted(m for m in sys.modules
                if m in ("jax", "hrbffusion3d_tpu")
                or m.startswith(("jax.", "jaxlib", "hrbffusion3d_tpu.")))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    # core, ops, map, tracking, pipeline, eval, utils, backend and their modules
    assert int(n_modules) >= 29, out.stdout
    assert leaked == "[]", leaked
    for name in ("brief_pattern", "features", "reduce_plan", "ba", "keyframes", "bow",
                 "vocab", "posegraph"):
        assert (ROOT / "hrbffusion3d_tpu_torch" / "backend" / f"{name}.py").exists(), name


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
