"""The port's float32 square roots round correctly, on every device.

On the CPU, torch's vectorised float32 ``sqrt`` (and ``pow(x, 0.5)`` and
``linalg.vector_norm``, built on it) is one ulp off IEEE on about a fifth
of inputs, where XLA (the JAX package) rounds correctly; a tap of the HRBF
kernel at d2 / T2 = 0.99997 turns that ulp into 0.4 % of ``1 - r``.  So the
port takes every float32 square root through ``utils.tensors.sqrt`` and
``norm``:

  - the helper against numpy (``np.sqrt`` and ``sqrt(sum(v * v))`` summed
    in index order), bit for bit, on 2^20 seeded float32 draws over every
    exponent, denormals, zeros and values within 2 ulp of perfect squares,
    and on 3- and 2-vectors along either axis;
  - a scan of the port's source (comments and strings left out) for a
    ``torch.sqrt``, ``.sqrt()``, ``vector_norm``, ``linalg.norm``,
    ``F.normalize``, ``.norm(``, ``** 0.5`` or ``pow(..., 0.5)`` outside the
    helper's module; the float64 sites that stay as they are are listed by
    name, and each must still be there."""

import io
import re
import tokenize
from pathlib import Path

import numpy as np
import torch

from hrbffusion3d_tpu_torch.utils import tensors

PORT = Path(__file__).resolve().parent.parent / "hrbffusion3d_tpu_torch"
N = 1 << 20


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _draws() -> np.ndarray:
    rng = np.random.default_rng(16)
    # every finite non-negative float32 bit pattern is equally likely
    anywhere = rng.integers(0, 0x7F800000, N // 2, dtype=np.uint32).view(np.float32)
    unit = rng.uniform(0.0, 4.0, N // 4).astype(np.float32)
    denormal = rng.integers(0, 0x00800000, N // 16, dtype=np.uint32).view(np.float32)
    roots = rng.uniform(0.0, 4096.0, N // 16).astype(np.float32)
    square = (roots * roots).astype(np.float32)
    near, up, down = [square], square, square
    for _ in range(2):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(0))
        near += [up, down]
    ints = np.arange(N // 64, dtype=np.float32) ** 2
    special = np.array([0.0, -0.0, 1.0, np.inf, np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, np.finfo(np.float32).smallest_subnormal],
                       np.float32)
    return np.concatenate([anywhere, unit, denormal, *near, ints, special])


def test_sqrt_is_correctly_rounded():
    x = _draws()
    assert x.size >= N
    got = tensors.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.sqrt(x)))
    neg = tensors.sqrt(torch.tensor([-1.0, -np.inf, np.nan]))
    assert torch.isnan(neg).all()
    # float64 goes through as it is
    x64 = torch.from_numpy(np.random.default_rng(1).uniform(0, 9, 1000))
    assert torch.equal(tensors.sqrt(x64), torch.sqrt(x64))


def test_norm_is_sqrt_of_the_ordered_sum():
    rng = np.random.default_rng(17)
    v = (rng.normal(size=(N, 3)) * rng.uniform(1e-3, 1e3, (N, 1))).astype(np.float32)
    p = v * v
    want = np.sqrt((p[:, 0] + p[:, 1]) + p[:, 2])
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(_bits(tensors.norm(t).numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(tensors.norm(t, dim=-1, keepdim=True).numpy()[:, 0]),
                                  _bits(want))
    np.testing.assert_array_equal(_bits(tensors.norm(t.T.contiguous(), dim=0).numpy()),
                                  _bits(want))
    w = v[:, :2]
    np.testing.assert_array_equal(_bits(tensors.norm(torch.from_numpy(w)).numpy()),
                                  _bits(np.sqrt(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1])))


# the square roots that stay outside the helper: float64 tensors and Python
# floats, (module, the code of the line)
EXEMPT = {
    ("backend/ba.py", "d = HUBER_DELTA2 ** 0.5"),
    ("parallel/dist_ba.py", "d = ba.HUBER_DELTA2 ** 0.5"),
    ("tracking/odometry.py", "/ icp_ops.saliency_count(cfg.tracking_topk, lv.height, w)) ** 0.5"),
    ("eval/mesh.py", "nn = torch.clamp(torch.linalg.vector_norm(n, dim=-1), min=1e-30)"),
    ("eval/mesh.py", "out[lo:lo + chunk] = torch.sqrt(d2.min(-1).values)"),
}
ROOTS = re.compile(r"(?<!np\.)linalg\.(?:vector_)?norm\s*\(|(?<![\w.])F\.normalize\s*\("
                   r"|functional\.normalize\s*\(|(?<!np)(?<!math)\.sqrt\s*\("
                   r"|(?<!linalg)\.norm\s*\(|\*\*\s*0?\.5\b"
                   r"|pow\s*\(\s*(?:[^()]*,\s*)?0?\.5\s*\)")


def _code_lines(path: Path):
    """(line number, code with comments and strings blanked) of a module."""
    src = path.read_text()
    lines = src.splitlines()
    keep = [list(ln) for ln in lines]
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type in (tokenize.COMMENT, tokenize.STRING):
            (r0, c0), (r1, c1) = tok.start, tok.end
            for r in range(r0, r1 + 1):
                a = c0 if r == r0 else 0
                b = c1 if r == r1 else len(keep[r - 1])
                keep[r - 1][a:b] = " " * (b - a)
    return [(i + 1, "".join(k)) for i, k in enumerate(keep)]


def test_no_float32_square_root_outside_the_helper():
    found, exempt_seen = [], set()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel == "utils/tensors.py":
            continue
        for no, code in _code_lines(path):
            if not ROOTS.search(code):
                continue
            hit = next((e for e in EXEMPT if e[0] == rel and e[1] in code), None)
            if hit:
                exempt_seen.add(hit)
            else:
                found.append(f"{rel}:{no}: {code.strip()}")
    assert not found, "square roots outside utils.tensors.sqrt / norm:\n" + "\n".join(found)
    assert exempt_seen == EXEMPT, f"exemptions no longer in the source: {EXEMPT - exempt_seen}"


def test_scan_finds_each_form():
    """The scan's pattern catches every form it names (and not numpy's)."""
    for line in ("y = torch.sqrt(x)", "y = x.sqrt()", "n = torch.linalg.vector_norm(v)",
                 "n = torch.linalg.norm(v, dim=-1)", "u = F.normalize(v, dim=-1)",
                 "n = v.norm(dim=-1)", "r = x ** 0.5", "r = torch.pow(x, 0.5)",
                 "r = x.pow(.5)"):
        assert ROOTS.search(line), line
    for line in ("y = np.sqrt(x)", "y = math.sqrt(x)", "n = np.linalg.norm(v)",
                 "y = sqrt(x)", "n = norm(v, dim=-1)", "r = x ** 0.25"):
        assert not ROOTS.search(line), line
