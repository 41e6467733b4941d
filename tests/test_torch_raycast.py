"""Parity of the port's HRBF ray cast with the JAX package.

The JAX reference is the XLA ``predict_hrbf`` (use_pallas_raycast=False):
the Pallas ``raycast_core`` in interpret mode takes ~100 s and 3.5 GB at
64x48 on this CPU, too slow for tier-1.  The port's ``predict_hrbf`` runs
``raycast_core_ref`` (the plain version of the CUDA kernel) on the CPU; it
is compared for the bench's false-position refinement, for bisection and
for the batched k-section, and ``fill_in`` on top.  Tolerances are those of
tests/test_pallas_kernels.py::test_raycast_matches_xla (kernel form vs XLA
form): ``found`` agreement > 0.995 (the XLA form also gates ``found`` by
the nearest tap's selection, the kernel form does not), vertex atol 1e-4
where both found, normal dot > 0.9999 on 99 %, nearest-surfel attributes
(conf) equal on > 99 % (float ties in the nearest-tap argmin).

The surfel-splat prediction (``predict_splat``, the step's off-frames at
``raycast_period > 1``) and ``render_depth`` are row gathers of the same
map: within atol 1e-5 of JAX's on a shared map.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and the
``cuda``-marked test below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import (CFG, INTR, PCFG, PINTR, n, port_cfg, port_frames,
                                port_measurement, t)

from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu.ops import pallas_kernels as jpk
from hrbffusion3d_tpu.ops import raycast as jray
from hrbffusion3d_tpu_torch.core import lie as tlie
from hrbffusion3d_tpu_torch.map import surfel_map as tsm
from hrbffusion3d_tpu_torch.ops import kernels as tk
from hrbffusion3d_tpu_torch.ops import raycast as tray

POSES, FRAMES = port_frames(2, angle_per_frame=0.01)
_jax_predict = jax.jit(jray.predict_hrbf, static_argnames=("intr", "cfg", "chunk"))
VARIANTS = {
    # bench.py: geometric ladder + 3 false-position iterations
    "false_position": dict(raycast_bisection_iters=6, raycast_false_position=3),
    # JAX default: geometric ladder + bisection
    "bisection": {},
    # batched k-section, 7 points per pass (tests/test_raycast.py)
    "ksection": dict(raycast_bisection_batch=7),
}


@pytest.fixture(scope="module")
def scene():
    """Map of frame 0 seen from frame 1 (made by the port; its parity is
    test_torch_surfel_map.py's): the pose, index map, attr images and the
    frame-0 live measurement, all numpy."""
    meas = port_measurement(*FRAMES[0])
    m = tsm.initialise(PCFG.map_capacity, tsm.FrameMeasurement(*map(t, meas)),
                       t(POSES[0]), PCFG)
    pinv = tlie.se3_inverse(t(POSES[1]))
    idx = tsm.render_index(m, pinv, PINTR)
    attr_ext = n(tsm.render_attr_image(m, idx, pinv, extended=True))
    attr9 = attr_ext[..., [0, 1, 2, 3, 4, 5, tsm.A_CONF, tsm.A_RADIUS, tsm.A_VALID]]
    live = {k: getattr(meas, f) for k, f in (
        ("vertex", "vertex_f"), ("normal", "normal"), ("radius", "radius"),
        ("color", "color"), ("conf", "conf"), ("k1", "k1"), ("k2", "k2"))}
    return n(pinv), n(idx), attr_ext, attr9, live


def _predict_pair(scene, cfg):
    pinv, idx, attr_ext, _, _ = scene
    # predict_hrbf reads only the attr image when it is given (no map)
    pj = _jax_predict(None, jnp.asarray(pinv), jnp.asarray(idx), INTR, cfg,
                      chunk=cfg.raycast_chunk, attr_ext=jnp.asarray(attr_ext))
    pt = tray.predict_hrbf(None, t(pinv), t(idx), PINTR, port_cfg(cfg), attr_ext=t(attr_ext))
    return pt, pj


def _check_prediction(pt, pj):
    fnd_t, fnd_j = n(pt.found), n(pj.found)
    assert (fnd_t == fnd_j).mean() > 0.995, (fnd_t != fnd_j).mean()
    both = fnd_t & fnd_j
    assert both.mean() > 0.5
    np.testing.assert_allclose(n(pt.vertex)[both], n(pj.vertex)[both], atol=1e-4)
    assert (np.sum(n(pt.normal)[both] * n(pj.normal)[both], axis=-1) > 0.9999).mean() > 0.99
    assert (np.abs(n(pt.conf) - n(pj.conf))[both] < 1e-5).mean() > 0.99
    np.testing.assert_allclose(n(pt.icp_weight)[both], n(pj.icp_weight)[both],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_raycast_core_ref_matches_jax(scene, variant):
    cfg = dataclasses.replace(CFG, **VARIANTS[variant])
    pt, pj = _predict_pair(scene, cfg)
    _check_prediction(pt, pj)
    # the wrapper takes the plain version for a CPU tensor, and no launch
    # count moves
    attr9 = t(scene[3])
    before = dict(tk.LAUNCHES)
    out = tk.raycast_core(attr9, PINTR, port_cfg(cfg))
    assert out[2].dtype == torch.int32 and out[3].dtype == torch.bool
    for a, b in zip(out, tk.raycast_core_ref(attr9, PINTR, port_cfg(cfg))):
        np.testing.assert_array_equal(n(a), n(b))
    assert tk.LAUNCHES == before


def test_ref_stats_count_selected_taps(scene):
    """The plain version's work count: per pixel, the stable taps of its
    ring-ordered window, capped at K, and the taps the ring walk tests
    before it holds K."""
    attr9 = scene[3]
    cfg = PCFG
    *out, st = tk.raycast_core_ref(t(attr9), PINTR, cfg, stats=True)
    for a, b in zip(out, tk.raycast_core_ref(t(attr9), PINTR, cfg)):
        np.testing.assert_array_equal(n(a), n(b))
    pos, nrm = attr9[..., 0:3], attr9[..., 3:6]
    stable = ((attr9[..., 8] > 0.5) & (pos[..., 2] > 0.1) & ((nrm * nrm).sum(-1) > 0.01)
              & (attr9[..., 6] >= cfg.predict_conf_threshold) & (nrm[..., 2] > 0.0))
    R, K = cfg.predict_window_multiplier, cfg.predict_max_neighbors
    h, w = stable.shape
    sp = np.pad(stable, R)
    ring = [sp[R + dy:R + dy + h, R + dx:R + dx + w] for dy, dx in tk.ring_taps(R)]
    count = np.cumsum(np.stack(ring).astype(np.int64), axis=0)     # (taps, H, W)
    np.testing.assert_array_equal(n(st.n_sel), np.minimum(count[-1], K))
    assert n(st.n_sel).max() == K
    visit = np.where(count[-1] >= K, np.argmax(count >= K, axis=0) + 1, len(ring))
    np.testing.assert_array_equal(n(st.n_visit), visit)
    assert (n(st.n_visit) < len(ring)).any()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ref_stats_count_evaluations(scene, variant):
    """Evaluations of f per pixel: f0, the ladder taps up to the bracket and
    the refinement, so at least 2 + refinement where found and at most
    1 + |ladder| + refinement; the kernel's batched ladder (and k-section)
    adds fewer than a batch per pass, and nothing where no tap is
    selected."""
    cfg = port_cfg(dataclasses.replace(CFG, **VARIANTS[variant]))
    *out, st = tk.raycast_core_ref(t(scene[3]), PINTR, cfg, stats=True)
    ladder, fp, bis, ksec_b, ksec_p = tk._variant(cfg)
    refine = fp if fp > 0 else (ksec_b * ksec_p if ksec_b > 1 else bis)
    found, n_eval = n(out[3]), n(st.n_eval)
    assert len(ladder) == 8 and found.mean() > 0.5
    assert (n_eval[found] >= 2 + refine).all()
    assert (n_eval >= 2 + refine).all() and (n_eval <= 1 + len(ladder) + refine).all()
    assert (n_eval[~found] == 1 + len(ladder) + refine).any()
    done = n(tk.raycast_kernel_evals(st, cfg))
    sel = n(st.n_sel) > 0
    G = tk.RAYCAST_LADDER_BATCH
    spare = (G - 1) * (1 + (ksec_p if fp <= 0 and ksec_b > 1 else 0))
    assert (done[sel] >= n_eval[sel]).all() and (done[sel] <= n_eval[sel] + spare).all()
    assert (done[~sel] == 0).all()


@pytest.mark.parametrize("radius", [0, 1, 3, 7])
def test_ring_table_is_ring_order(radius):
    """The table the wrapper passes to the kernel is ring_taps(R), the TPU
    kernel's order."""
    table = list(tk.ring_table(radius))
    pairs = list(zip(table[0::2], table[1::2]))
    assert pairs == tk.ring_taps(radius) == jpk._ring_taps(radius)
    assert len(pairs) == (2 * radius + 1) ** 2


def test_ring_order_and_ladder():
    assert tk.ring_taps(3) == jpk._ring_taps(3) == jray._ring_offsets(3)
    for kw in ({}, {"raycast_geometric_ladder": False}, {"raycast_coarse_steps": 10}):
        cfg = dataclasses.replace(CFG, **kw)
        assert tray.ladder_offsets(port_cfg(cfg)) == jray.ladder_offsets(cfg)
        assert tray.bisection_plan(port_cfg(cfg)) == jray.bisection_plan(cfg)


def test_fill_in(scene):
    live = scene[4]
    cfg = dataclasses.replace(CFG, **VARIANTS["false_position"])
    pt, pj = _predict_pair(scene, cfg)
    keys = ("vertex", "normal", "radius", "color", "conf", "k1", "k2")
    fj = jray.fill_in(pj, *(jnp.asarray(live[k]) for k in keys), cfg)
    ft = tray.fill_in(pt, *(t(live[k]) for k in keys), port_cfg(cfg))
    same = n(ft.from_model) == n(fj.from_model)
    assert same.mean() > 0.995
    for f in ("vertex", "normal", "conf", "radius", "color", "k1", "k2", "icp_weight"):
        a, b = n(getattr(ft, f)), n(getattr(fj, f))
        close = np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)
        close = close.reshape(close.shape[:2] + (-1,)).all(-1)
        assert close[same].mean() > 0.99, f


def test_predict_splat_and_render_depth_match_jax():
    """On the map of frame 0 seen from frame 1 (the ``scene`` fixture's)."""
    meas = port_measurement(*FRAMES[0])
    m = tsm.initialise(PCFG.map_capacity, tsm.FrameMeasurement(*map(t, meas)),
                       t(POSES[0]), PCFG)
    pinv = tlie.se3_inverse(t(POSES[1]))
    idx = tsm.render_index(m, pinv, PINTR)
    jm = jsm.SurfelMap(data=jnp.asarray(n(m.data)), count=jnp.asarray(n(m.count)))
    pj = jray.predict_splat(jm, jnp.asarray(n(pinv)), jnp.asarray(n(idx)), INTR, CFG)
    pt = tray.predict_splat(m, pinv, idx, PINTR, PCFG)
    assert n(pt.found).mean() > 0.5
    for f in pt._fields:
        a, b = n(getattr(pt, f)), n(getattr(pj, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(
        n(tray.render_depth(m, pinv, idx, PINTR)),
        n(jray.render_depth(jm, jnp.asarray(n(pinv)), jnp.asarray(n(idx)), INTR)), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k_cap", [10, 16])
def test_cuda_kernel_matches_ref(scene, k_cap):
    """On the card: the CUDA kernel against its plain version, for both tap
    caps the kernel is built for (K = 10 within 128 registers, no spills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    *_, attr9, _ = scene
    if k_cap == 10:
        at = tk.kernel_attributes("raycast_core", 10, PCFG.predict_window_multiplier)
        assert at["registers"] <= 128 and at["local_bytes"] == 0 and at["blocks_per_sm"] >= 2
    for variant in sorted(VARIANTS):
        cfg = port_cfg(dataclasses.replace(CFG, predict_max_neighbors=k_cap,
                                           **VARIANTS[variant]))
        a = t(attr9).cuda()
        before = tk.LAUNCHES["raycast_core"]
        out = tk.raycast_core(a, PINTR, cfg)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["raycast_core"] == before + 1
        ref = tk.raycast_core_ref(a, PINTR, cfg)
        f_k, f_r = n(out[3]), n(ref[3])
        assert (f_k == f_r).mean() > 0.995
        both = f_k & f_r
        np.testing.assert_allclose(n(out[0])[both], n(ref[0])[both], atol=1e-4)
        assert (n(out[2])[both] == n(ref[2])[both]).mean() >= 0.99
