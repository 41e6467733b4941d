"""Parity of the port's surfel map (init, render, fuse, clean) with the JAX
package: the same measurements (from the port's preprocess, as numpy) and
the same map go through both.

Tolerances: the index map and every integer output exactly (integer
scatter-mins and stable sorts are deterministic); map rows and attribute
images atol 1e-5 (float32 pose products in another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import (CFG, INTR, PCFG, PINTR, n, port_cfg, port_frames,
                                port_measurement, t)
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

from hrbffusion3d_tpu.core import lie as jlie
from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu_torch.map import surfel_map as tsm

POSES, FRAMES = port_frames(2, angle_per_frame=0.01)


@pytest.fixture(scope="module")
def world():
    """Frame-0 map in both implementations + the frame-1 measurement."""
    m0, m1 = (port_measurement(*f) for f in FRAMES)
    pose0 = jnp.asarray(POSES[0])
    with jax.disable_jit():
        jm = jsm.initialise(CFG.map_capacity, jsm.FrameMeasurement(*map(jnp.asarray, m0)),
                            pose0, CFG)
    tm = tsm.initialise(PCFG.map_capacity, tsm.FrameMeasurement(*map(t, m0)), t(POSES[0]), PCFG)
    return jm, tm, m1


def _assert_map(tm, jm):
    assert int(tm.count) == int(jm.count)
    np.testing.assert_allclose(n(tm.data), n(jm.data), atol=1e-5)


def test_initialise(world):
    jm, tm, _ = world
    _assert_map(tm, jm)


@pytest.mark.parametrize("active", [False, True])
def test_render_index(world, active):
    jm, tm, _ = world
    pinv = np.asarray(jlie.se3_inverse(jnp.asarray(POSES[1])))
    kw_j = {"active": jm.active} if active else {}
    kw_t = {"active": tm.active} if active else {}
    ij = jsm.render_index(jm, jnp.asarray(pinv), INTR, **kw_j)
    it = tsm.render_index(tm, t(pinv), PINTR, **kw_t)
    assert (n(ij) >= 0).sum() > 1000
    np.testing.assert_array_equal(n(it), n(ij))


@pytest.mark.parametrize("extended", [False, True])
def test_render_attr_image(world, extended):
    jm, tm, _ = world
    pinv = np.asarray(jlie.se3_inverse(jnp.asarray(POSES[1])))
    idx = jsm.render_index(jm, jnp.asarray(pinv), INTR)
    aj = jsm.render_attr_image(jm, idx, jnp.asarray(pinv), extended=extended)
    at = tsm.render_attr_image(tm, t(idx), t(pinv), extended=extended)
    np.testing.assert_allclose(n(at), n(aj), atol=1e-5)


@pytest.fixture(scope="module")
def fused(world):
    jm, tm, m1 = world
    pose1 = POSES[1]
    pinv = np.asarray(jlie.se3_inverse(jnp.asarray(pose1)))
    idx = np.asarray(jsm.render_index(jm, jnp.asarray(pinv), INTR))
    jm2, jidx = jax.jit(jsm.fuse, static_argnames=("intr", "cfg"))(
        jm, jsm.FrameMeasurement(*map(jnp.asarray, m1)), jnp.asarray(pose1),
        jnp.asarray(idx), INTR, CFG, time=jnp.int32(2), submap_idx=jnp.int32(0))
    tm2, tidx = tsm.fuse(tm, tsm.FrameMeasurement(*map(t, m1)), t(pose1), t(idx),
                         PINTR, PCFG, time=2, submap_idx=0)
    return (jm2, jidx), (tm2, tidx), pose1


def test_fuse(fused):
    (jm2, jidx), (tm2, tidx), _ = fused
    _assert_map(tm2, jm2)
    np.testing.assert_array_equal(n(tidx), n(jidx))


@pytest.mark.parametrize("mode", ["compact", "tombstone"])
def test_clean_with_remap(fused, mode):
    """compact: clean_compact_period 1 (crowd rules on); tombstone: period 4
    at an off-frame (crowd rules off too, clean_crowd_period 4)."""
    (jm2, jidx), _, pose1 = fused
    cfg = CFG if mode == "compact" else dataclasses.replace(
        CFG, clean_compact_period=4, clean_crowd_period=4)
    # a map with tombstone-able surfels: some stale, some curvature-invalid
    data = np.array(n(jm2.data))
    rng = np.random.default_rng(3)
    cnt = int(jm2.count)
    stale = rng.uniform(size=cnt) < 0.05
    data[:cnt][stale, jsm.STAMP] = -300.0
    data[:cnt][rng.uniform(size=cnt) < 0.02, jsm.K1] = 500.0
    jm3 = jsm.SurfelMap(data=jnp.asarray(data), count=jm2.count)
    tm3 = tsm.SurfelMap(data=t(data), count=t(np.asarray(jm2.count)))
    pinv = np.asarray(jlie.se3_inverse(jnp.asarray(pose1)))
    aj = jsm.render_attr_image(jm3, jidx, jnp.asarray(pinv), extended=True)
    at = tsm.render_attr_image(tm3, t(jidx), t(pinv), extended=True)
    jm4, jremap = jax.jit(jsm.clean_with_remap, static_argnames=("intr", "cfg"))(
        jm3, jnp.asarray(pose1), jidx, INTR, cfg, time=jnp.int32(2),
        attr=aj[..., :jsm.ATTR_CHANNELS])
    tm4, tremap = tsm.clean_with_remap(tm3, t(pose1), t(jidx), PINTR, port_cfg(cfg), time=2,
                                       attr=at[..., :tsm.ATTR_CHANNELS])
    assert (n(jremap)[:cnt] < 0).sum() > 0
    np.testing.assert_array_equal(n(tremap), n(jremap))
    _assert_map(tm4, jm4)
    np.testing.assert_array_equal(n(tsm.remap_index_map(t(jidx), tremap)),
                                  n(jsm.remap_index_map(jidx, jremap)))
    if mode == "tombstone":
        keep_j = jsm.pixel_keep_mask(aj, cfg, 2)
        keep_t = tsm.pixel_keep_mask(at, port_cfg(cfg), 2)
        np.testing.assert_array_equal(n(keep_t), n(keep_j))
        # on tombstone frames the pixel-space mask IS the remap
        via_remap = n(tsm.remap_index_map(t(jidx), tremap))
        via_pixel = np.where((n(jidx) >= 0) & n(keep_t), n(jidx), -1)
        np.testing.assert_array_equal(via_pixel, via_remap)


def test_clean(fused):
    """clean = compact(clean_mask): the fused map with some surfels made
    stale, cleaned at the frame-1 render."""
    (jm2, jidx), _, pose1 = fused
    data = np.array(n(jm2.data))
    cnt = int(jm2.count)
    data[:cnt][np.random.default_rng(4).uniform(size=cnt) < 0.05, jsm.STAMP] = -300.0
    jm3 = jax.jit(jsm.clean, static_argnames=("intr", "cfg"))(
        jsm.SurfelMap(data=jnp.asarray(data), count=jm2.count), jnp.asarray(pose1), jidx,
        INTR, CFG, time=jnp.int32(2))
    tm3 = tsm.clean(tsm.SurfelMap(data=t(data), count=t(np.asarray(jm2.count))), t(pose1),
                    t(jidx), PINTR, PCFG, time=2)
    assert int(jm3.count) < cnt
    _assert_map(tm3, jm3)


def test_grow_and_empty():
    m = tsm.empty_map(8, "cpu")
    g = tsm.grow(m, 16)
    jg = jsm.grow(jsm.empty_map(8), 16)
    np.testing.assert_array_equal(n(g.data), n(jg.data))
    assert int(g.count) == 0 and g.count.dtype == torch.int32


# --------------------------------------------------------------------------- #
# keyframe boundary: exchange, corrections, activity channel, large render
# --------------------------------------------------------------------------- #

def _toy_rows(n_per_submap, submaps, cap, seed=0):
    """tests/test_active_archive.py::_toy_map's rows for the given submaps."""
    rng = np.random.default_rng(seed)
    n_rows = n_per_submap * len(submaps)
    data = np.zeros((cap, jsm.N_CHANNELS), np.float32)
    data[:n_rows, 0:3] = rng.normal(0, 1, (n_rows, 3))
    data[:n_rows, jsm.SUBMAP] = np.repeat(submaps, n_per_submap)
    data[:n_rows, jsm.CONF] = 50.0
    data[:n_rows, jsm.STAMP] = 1.0
    data[:n_rows, jsm.VALID] = 1.0
    data[:n_rows, jsm.ACT] = 1.0
    data[:n_rows, jsm.NORMAL] = rng.normal(0, 1, (n_rows, 3))
    data[:n_rows, jsm.CURV_DIR1] = rng.normal(0, 1, (n_rows, 3))
    data[:n_rows, jsm.CURV_DIR2] = rng.normal(0, 1, (n_rows, 3))
    return data, n_rows


def _pair(data, count):
    return (jsm.SurfelMap(data=jnp.asarray(data), count=jnp.int32(count)),
            tsm.SurfelMap(data=t(data), count=torch.tensor(count, dtype=torch.int32)))


# (active rows, archive rows, active submaps, time): everything fits, with
# a junk (unstable, timed-out) submap among the leavers; the archive too
# small for the leavers (test_exchange_overflow_drops_and_reports); the
# active map too small for the enter rows
EXCHANGES = {
    "fits": (_toy_rows(50, [0, 1, 2, 3], 512), _toy_rows(20, [4, 5], 256, 1), [0, 2, 4], 1000),
    "archive_overflow": (_toy_rows(50, [0, 1, 2, 3], 512), (np.zeros((64, 24), np.float32), 0),
                         [0, 2], 5),
    "enter_overflow": (_toy_rows(30, [0, 1, 2, 3], 128), _toy_rows(50, [4, 5], 512, 1),
                       [0, 1, 4, 5], 5),
}


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_exchange_active_matches_jax(case):
    """exchange_active equal to JAX's: both maps' rows and counts exactly
    and stats [n_active, n_archive, dropped] exactly, overflow drops
    included."""
    (ad, an), (rd, rn), active, time = EXCHANGES[case]
    ad = ad.copy()
    if case == "fits":
        ad[(ad[:, jsm.SUBMAP] == 1) & (ad[:, jsm.VALID] > 0), jsm.CONF] = 0.5   # junk at time 1000
    ja, ta = _pair(ad, an)
    jr, tr = _pair(rd, rn)
    mask = np.zeros(8, bool)
    mask[active] = True
    ja2, jr2, jst = jsm.exchange_active(ja, jr, jnp.asarray(mask), jnp.int32(time), CFG)
    ta2, tr2, tst = tsm.exchange_active(ta, tr, t(mask), time, PCFG)
    np.testing.assert_array_equal(n(tst), n(jst))
    assert tst.dtype == torch.int32
    if case != "fits":
        assert int(n(jst)[2]) > 0
    for a, b in ((ta2, ja2), (tr2, jr2)):
        assert int(a.count) == int(b.count) and a.count.dtype == torch.int32
        np.testing.assert_array_equal(n(a.data), n(b.data))


def test_apply_submap_deltas_and_activity_channel():
    """apply_submap_deltas within 1e-6 (valid rows move with their submap,
    tombstones stay); refresh_active_channel and active_from_submaps
    exactly."""
    data, cnt = _toy_rows(40, [0, 1, 2, 3, 5], 256)
    data[::7, jsm.VALID] = 0.0
    jm, tm = _pair(data, cnt)
    rng = np.random.default_rng(4)
    xi = (0.2 * rng.standard_normal((6, 6))).astype(np.float32)
    deltas = np.array(jlie.se3_exp(jnp.asarray(xi)))
    deltas[2] = np.eye(4)
    np.testing.assert_allclose(n(tsm.apply_submap_deltas(tm, t(deltas)).data),
                               n(jsm.apply_submap_deltas(jm, jnp.asarray(deltas)).data), atol=1e-6)
    mask = np.zeros(8, bool)
    mask[[1, 5]] = True
    np.testing.assert_array_equal(n(tsm.refresh_active_channel(tm, t(mask)).data),
                                  n(jsm.refresh_active_channel(jm, jnp.asarray(mask)).data))
    np.testing.assert_array_equal(n(tsm.active_from_submaps(tm, t(mask))),
                                  n(jsm.active_from_submaps(jm, jnp.asarray(mask))))


def test_render_index_large_capacity(world):
    """Above 2**20 rows render_index takes the exact float z-buffer: on a
    map of 2**20 + 64 rows (the frame-0 surfels at the front, a shifted
    copy of some at the tail so that ids past 2**20 win pixels) equal to
    JAX's."""
    jm, _, _ = world
    cnt = int(jm.count)
    data = np.zeros(((1 << 20) + 64, jsm.N_CHANNELS), np.float32)
    data[:cnt] = n(jm.data)[:cnt]
    tail = n(jm.data)[:cnt:max(1, cnt // 64)][:64].copy()
    tail[:, 2] -= 0.05
    data[1 << 20:(1 << 20) + tail.shape[0]] = tail
    pinv = np.asarray(jlie.se3_inverse(jnp.asarray(POSES[1])))
    jl, tl = _pair(data, data.shape[0])
    ij = n(jax.jit(jsm.render_index, static_argnames=("intr",))(jl, jnp.asarray(pinv), INTR))
    it = n(tsm.render_index(tl, t(pinv), PINTR))
    assert (ij >= (1 << 20)).sum() > 10
    np.testing.assert_array_equal(it, ij)
