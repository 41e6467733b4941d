"""The port's three preprocessing stencil kernels (``csrc/preprocess.cu``)
through their plain versions on the CPU, against the TPU kernels they
replace (``hrbffusion3d_tpu/ops/pallas_kernels.py``), at 64x48 and at 61x47
(no multiple of the bilateral and PCA kernels' tiles), with holes and a
depth step at the image border.

The JAX side runs the bilateral and PCA Pallas kernels' own code with
numpy standing in for ``jax.numpy`` (``_pallas``): each kernel body runs
block by block over its grid, as interpret mode runs it, without compiling
the whole grid as one XLA program first.
``test_numpy_grid_is_interpret_mode`` holds this to interpret mode on both
kernels.  The curvature kernel's plain version is held to the
Pallas kernel's plain reference in the JAX suite, the XLA
``preprocess.curvature_gradient``, by
tests/test_torch_preprocess.py::test_curvature_gradient with the rules of
test_curvature_matches_xla (which holds the Pallas kernel to the same
reference): in interpret mode the curvature kernel compiles for minutes
on a CPU, and run op by op its body multiplies masks by 0 * inf
at every centre tap (d2 = 0), which compiled XLA turns into selects, so an
op-by-op run gives NaN where interpret mode does not.

Tolerances are the JAX suite's (tests/test_pallas_kernels.py):
  - bilateral atol 1e-5 m, for both denominators: the Pallas form against
    ``pk.bilateral_filter``, the shader form against the XLA
    ``preprocess.bilateral_filter``.  On room-scale depths the two forms
    agree to float rounding (an invalid neighbour's weight is below
    exp(-50)), so a near-range copy (depths scaled to 2 %, depth_min 0)
    shows the argument is wired;
  - PCA normals: valid on > 90 % in both (> 70 % on the border case, whose
    holes and step leave fewer valid), dot > 0.999 on 99 % (the Pallas
    kernel sums raw coordinates, the port centre-relative ones).  The
    Pallas wrapper's eigen-solve, which it takes from ``preprocess``, runs
    in numpy too: eager JAX would compile it op by op for each new shape.
Each wrapper takes the plain version for a CPU tensor and moves no launch
count; the plain versions' work counts (``stats=True``, which the chip
smoke run's bounds read) are held to counts made here.  The ``cuda``-marked
tests hold each kernel against its plain version on the card and skip here:
the bilateral kernel on every frame here in both forms, the PCA kernel on
the room frame and the 61x47 border case, each kernel unspilled; the
curvature sums within 1e-5 of their terms' summed magnitude (count exact),
k1/k2 and the principal directions where |g_z| >= 0.1 |g| (at most 1 % of
the valid pixels left out), gradient_mag and radius_opt where both are
valid, the k = 1000 sentinel where not."""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import CFG, INTR, PINTR, n, port_cfg, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.core import camera as jcam
from hrbffusion3d_tpu.ops import pallas_kernels as pk
from hrbffusion3d_tpu.ops import preprocess as jpre
from hrbffusion3d_tpu_torch.core import camera as tcam
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import kernels
from hrbffusion3d_tpu_torch.ops import preprocess as tpre

PCFG = port_cfg(CFG)
# near range: depths scaled to 2 % (about 4-7 cm), depth_min 0
NEAR_CFG = dataclasses.replace(CFG, depth_min=0.0)
_DEPTH = n(synth.render_frame(synth.default_room("cpu"), np.eye(4, dtype=np.float32),
                              PINTR)[0])
_HOLES = np.random.default_rng(7).uniform(size=_DEPTH.shape) < 0.1


def _border_case(depth, seed):
    """``depth`` with 10 % of its pixels zeroed (seeded), its 3 leftmost
    columns stepped 0.25 m back, its last 2 rows zeroed and a 4x5 hole in
    its top-right corner: chip_smoke.border_case in numpy (the card's case
    draws its holes from torch's generator), kept equal to it by hand."""
    d = np.where(np.random.default_rng(seed).uniform(size=depth.shape) < 0.1, 0.0, depth)
    d[:, :3] += 0.25
    d[-2:, :] = 0.0
    d[:4, -5:] = 0.0
    return d.astype(np.float32)


DEPTHS = {"room": (_DEPTH * ~_HOLES, CFG),
          "near": (0.02 * _DEPTH * ~_HOLES, NEAR_CFG),
          "border61x47": (_border_case(_DEPTH[:47, :61], 2), CFG)}


def _grid_pallas_call(kernel, *, grid, in_specs, out_specs, out_shape, **_):
    """``pl.pallas_call`` for the kernels of pallas_kernels.py, whose every
    block is one slab ``[i]`` of a stacked input: runs ``kernel`` on numpy
    refs, block by block."""
    for spec in (*in_specs, out_specs):
        assert spec.block_shape[0] == 1 and tuple(spec.index_map(3))[0] == 3

    def run(*args):
        out = np.zeros(out_shape.shape, np.float32)
        for i in range(grid[0]):
            kernel(*(np.asarray(a[i:i + 1]) for a in args), out[i:i + 1])
        return out
    return run


class _Value(np.ndarray):
    """A numpy array whose augmented assignments rebind, as a jax array's
    do (the kernels start their accumulators as one shared zeros array)."""

    def __iadd__(self, other):
        return self + other

    def __isub__(self, other):
        return self - other


class _NumpyAsJnp:
    """numpy in place of ``jax.numpy`` in the pallas_kernels module and in
    the eigen-solve it takes from ``preprocess``."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def zeros(shape, dtype=np.float32):
        return np.zeros(shape, dtype).view(_Value)

    @staticmethod
    def sqrt(x):
        # a Python float stays one (jnp keeps float32 arrays float32 against
        # it; numpy would widen them against a numpy float64)
        return np.sqrt(x) if isinstance(x, np.ndarray) else float(np.sqrt(x))


def _pallas(fn, *args):
    """A pallas_kernels wrapper and its kernel body, in float32 numpy."""
    as_np = _NumpyAsJnp()
    with mock.patch.object(pk.pl, "pallas_call", _grid_pallas_call), \
            mock.patch.object(pk, "jnp", as_np), mock.patch.object(jpre, "jnp", as_np):
        return fn(*args)


def _vertex(depth):
    return np.asarray(jcam.unproject(jnp.asarray(depth), INTR))


def _port_pre():
    """The port's vertex/normal/radius of the room frame with holes."""
    d = t(DEPTHS["room"][0])
    return tpre.vertex_normal_radius(d, d, PINTR, PCFG)


@pytest.mark.parametrize("name", ["bilateral_filter", "normal_pca"])
def test_numpy_grid_is_interpret_mode(name):
    # the compile, not the size, costs: two grid blocks of the bilateral
    # kernel, one of the PCA kernel (whose compile takes twice as long)
    x = DEPTHS["room"][0][:16] if name == "bilateral_filter" else _vertex(_DEPTH)[:8]
    fn = getattr(pk, name)
    np.testing.assert_allclose(n(_pallas(fn, x, CFG)),
                               n(fn(jnp.asarray(x), CFG, interpret=True)), atol=1e-6)


@pytest.mark.parametrize("scale", sorted(DEPTHS))
@pytest.mark.parametrize("form", ["pallas", "shader"])
def test_bilateral_plain_matches_jax(form, scale):
    depth, cfg = DEPTHS[scale]
    out = n(tpre.bilateral_filter_ref(t(depth), port_cfg(cfg), pallas_form=form == "pallas"))
    if form == "pallas":
        ref = n(_pallas(pk.bilateral_filter, depth, cfg))
    else:
        ref = n(jpre.bilateral_filter(jnp.asarray(depth), cfg))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert (out > 0).mean() > 0.8
    other = n(tpre.bilateral_filter_ref(t(depth), port_cfg(cfg), pallas_form=form != "pallas"))
    gap = np.abs(out - other).max()
    if scale == "near":
        assert gap > 1e-3, gap     # the holes pull the shader form's average down
    else:
        assert gap < 1e-5, gap


# the vertex maps the PCA kernels take: the room frame as it is, and the
# border case at 61x47 filtered (its holes and step leave ~75 % valid); the
# port unprojects it (test_torch_core.py holds its camera to JAX's)
PCA_INPUTS = {"room": (lambda: _vertex(_DEPTH), 0.9),
              "border61x47": (lambda: n(tcam.unproject(tpre.bilateral_filter_ref(
                  t(DEPTHS["border61x47"][0]), PCFG), PINTR)), 0.7)}


@pytest.mark.parametrize("frame", sorted(PCA_INPUTS))
def test_normal_pca_plain_matches_pallas(frame):
    make, min_valid = PCA_INPUTS[frame]
    v = make()
    r = n(_pallas(pk.normal_pca, v, CFG))
    o = n(tpre.normal_pca_ref(t(v), PCFG))
    both = (np.linalg.norm(r, axis=-1) > 0.5) & (np.linalg.norm(o, axis=-1) > 0.5)
    assert both.mean() > min_valid
    assert (np.sum(r[both] * o[both], axis=-1) > 0.999).mean() > 0.99


def _window_sum(x, radius):
    """Per pixel, the sum of ``x`` over its (2R+1)^2 window (0 outside)."""
    h, w = x.shape
    xp = np.pad(x, radius)
    d = 2 * radius + 1
    return sum(xp[dy:dy + h, dx:dx + w] for dy in range(d) for dx in range(d))


@pytest.mark.parametrize("form", ["pallas", "shader"])
def test_bilateral_stats_count_taps(form):
    depth = DEPTHS["room"][0]
    out, taps = tpre.bilateral_filter_ref(t(depth), PCFG, pallas_form=form == "pallas",
                                          stats=True)
    np.testing.assert_array_equal(n(out), n(tpre.bilateral_filter_ref(
        t(depth), PCFG, pallas_form=form == "pallas")))
    d = np.where((depth > CFG.depth_min) & (depth <= CFG.depth_cutoff), depth, 0.0)
    kept = _window_sum((d > 0) if form == "pallas" else np.ones_like(d), 6)
    np.testing.assert_array_equal(n(taps), np.where(d > 0, kept, 0))


def test_pca_and_curvature_stats():
    v = t(_vertex(_DEPTH))
    normals, cnt = tpre.normal_pca_ref(v, PCFG, stats=True)
    np.testing.assert_array_equal(n(normals), n(tpre.normal_pca_ref(v, PCFG)))
    valid = np.linalg.norm(n(normals), axis=-1) > 0.5
    np.testing.assert_array_equal(valid, (n(cnt) >= 8) & (n(v)[..., 2] > CFG.depth_min))
    pre = _port_pre()
    args = (pre.vertex_filtered, pre.normal, pre.radius, PCFG)
    sums, scale, inside = tpre.curvature_sums_ref(*args, stats=True)
    np.testing.assert_array_equal(n(sums), n(tpre.curvature_sums_ref(*args)))
    assert (np.abs(n(sums))[..., :9] <= n(scale)[..., :9] * (1 + 1e-5)).all()
    assert (n(scale)[..., 9] == 0).all()
    assert (n(inside) <= n(sums)[..., 9]).all() and 0 < n(inside).sum() < n(sums)[..., 9].sum()


def _calls(device):
    """kernel -> (wrapper call, plain call) on the room frame on ``device``."""
    depth = t(DEPTHS["room"][0]).to(device)
    v = t(_vertex(_DEPTH)).to(device)
    pre = tpre.VertexNormalRadius(*(x.to(device) for x in _port_pre()))
    return {
        "bilateral_filter": (lambda: tpre.bilateral_filter(depth, PCFG, pallas_form=True),
                             lambda: tpre.bilateral_filter_ref(depth, PCFG, pallas_form=True)),
        "normal_pca": (lambda: tpre.normal_pca(v, PCFG), lambda: tpre.normal_pca_ref(v, PCFG)),
        "curvature_gradient": (lambda: tpre.curvature_gradient(pre, PINTR, PCFG),
                               lambda: tpre.curvature_gradient_ref(pre, PINTR, PCFG)),
    }


@pytest.mark.parametrize("name", ["bilateral_filter", "normal_pca", "curvature_gradient"])
def test_wrapper_on_cpu_runs_plain(name):
    wrapper, plain = _calls("cpu")[name]
    before = dict(kernels.LAUNCHES)
    out, ref = wrapper(), plain()
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(n(a), n(b))
    assert kernels.LAUNCHES == before


def test_curvature_result_fields_on_cpu():
    """The curvature wrapper on CPU tensors returns every CurvatureResult
    field through the plain path, with the contract the fused kernel is held
    to: k = 1000 exactly and every other field 0 where not valid."""
    pre = _port_pre()
    before = dict(kernels.LAUNCHES)
    out = tpre.curvature_gradient(pre, PINTR, PCFG)
    assert kernels.LAUNCHES == before
    assert isinstance(out, tpre.CurvatureResult)
    h, w = pre.radius.shape
    for f in out._fields:
        x = getattr(out, f)
        assert x.device.type == "cpu" and x.shape[:2] == (h, w), f
        assert x.dtype == (torch.bool if f == "valid" else torch.float32), f
    valid = n(out.valid)
    assert 0.3 < valid.mean() < 1.0
    assert (n(out.k1)[~valid] == 1000.0).all() and (n(out.k2)[~valid] == 1000.0).all()
    for f in ("dir1", "dir2", "gradient_mag", "normal_opt", "radius_opt"):
        assert (n(getattr(out, f))[~valid] == 0.0).all(), f
    for f in ("dir1", "dir2", "normal_opt"):
        np.testing.assert_allclose(np.linalg.norm(n(getattr(out, f))[valid], axis=-1), 1.0,
                                   atol=1e-5)
    assert (n(out.radius_opt)[valid] > 0).all() and (n(out.gradient_mag)[valid] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bilateral_filter", "normal_pca", "curvature_gradient"])
def test_cuda_kernel_matches_plain(name):
    """On the card: each kernel against its plain version, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    wrapper, plain = _calls("cuda")[name]
    before = kernels.LAUNCHES[name]
    out = wrapper()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    ref = plain()
    if name == "bilateral_filter":
        np.testing.assert_allclose(n(out), n(ref), atol=1e-5)
        # both denominators on every frame, the 61x47 border case among them
        for scale, (depth, cfg) in DEPTHS.items():
            d, pcfg = t(depth).cuda(), port_cfg(cfg)
            for form in (False, True):
                np.testing.assert_allclose(
                    n(tpre.bilateral_filter(d, pcfg, pallas_form=form)),
                    n(tpre.bilateral_filter_ref(d, pcfg, pallas_form=form)), atol=1e-5,
                    err_msg=f"{scale}, pallas_form={form}")
    elif name == "normal_pca":
        v = t(PCA_INPUTS["border61x47"][0]()).cuda()
        pairs = [(out, ref), (tpre.normal_pca(v, PCFG), tpre.normal_pca_ref(v, PCFG))]
        for o, r in ((n(a), n(b)) for a, b in pairs):
            vo, vr = np.linalg.norm(o, axis=-1) > 0.5, np.linalg.norm(r, axis=-1) > 0.5
            assert (vo == vr).mean() >= 0.999
            assert (np.sum(o[vo & vr] * r[vo & vr], axis=-1) > 0.9999).mean() >= 0.99
    else:
        pre = tpre.VertexNormalRadius(*(x.cuda() for x in _port_pre()))
        args = (pre.vertex_filtered, pre.normal, pre.radius, PCFG)
        sums, scale, _ = (n(x) for x in tpre.curvature_sums_ref(*args, stats=True))
        assert (np.abs(n(tpre.curvature_sums(*args)) - sums) <= 1e-5 * scale).all()
        assert (n(out.valid) == n(ref.valid)).mean() > 0.999
        both = n(out.valid) & n(ref.valid)
        g = sums[..., 0:3]
        held = both & (np.abs(g[..., 2]) >= 0.1 * np.linalg.norm(g, axis=-1))
        assert held.sum() >= 0.99 * both.sum()
        np.testing.assert_allclose(n(out.k1)[held], n(ref.k1)[held], atol=5e-2, rtol=1e-3)
        np.testing.assert_allclose(n(out.k2)[held], n(ref.k2)[held], atol=5e-2, rtol=1e-3)
        dots = np.sum(n(out.normal_opt)[both] * n(ref.normal_opt)[both], axis=-1)
        assert (dots > 0.9999).mean() >= 0.99
        for f in ("dir1", "dir2"):
            dots = np.abs(np.sum(n(getattr(out, f))[held] * n(getattr(ref, f))[held], axis=-1))
            assert (dots > 0.9999).mean() >= 0.99, f
        np.testing.assert_allclose(n(out.gradient_mag)[both], n(ref.gradient_mag)[both],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n(out.radius_opt)[both], n(ref.radius_opt)[both], atol=1e-6)
        for res in (out, ref):
            inv = ~n(res.valid)
            assert (n(res.k1)[inv] == 1000.0).all() and (n(res.k2)[inv] == 1000.0).all()
    at = kernels.kernel_attributes(name, *([PCFG.curv_window] if name == "curvature_gradient"
                                           else []))
    assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2
