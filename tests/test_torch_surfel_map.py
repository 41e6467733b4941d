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


def test_grow_and_empty():
    m = tsm.empty_map(8, "cpu")
    g = tsm.grow(m, 16)
    jg = jsm.grow(jsm.empty_map(8), 16)
    np.testing.assert_array_equal(n(g.data), n(jg.data))
    assert int(g.count) == 0 and g.count.dtype == torch.int32
