"""The port runs where there is no JAX and stands alone from the JAX
package: importing the package, every one of its submodules and
``chip_smoke``'s imports leaves ``jax`` and every ``hrbffusion3d_tpu``
module out of ``sys.modules``.

It runs in a fresh interpreter, because ``tests/conftest.py`` imports jax
into the test process itself."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
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
    # core, ops, map, tracking, pipeline, eval, utils and their modules
    assert int(n_modules) >= 20, out.stdout
    assert leaked == "[]", leaked
