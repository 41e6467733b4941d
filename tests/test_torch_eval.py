"""The port's reconstruction evaluation against the JAX package's.

- ``eval/recon``: ``point_to_scene_distance`` and ``map_accuracy`` within
  1e-6 relative (float32 on both sides, the same formulas);
- ``eval/mesh``: the PLY mesh IO and ``scene_to_mesh`` are the JAX
  package's numpy (equal results); ``point_to_mesh_distance`` and
  ``map_accuracy_mesh`` run in torch float64 and agree with the JAX
  package's numpy float64 within 1e-9 (m), on the exact cases of
  tests/test_mesh_eval.py and on points around a tessellated scene.

The map is the port's bootstrap map of one 64x48 frame, handed to the JAX
functions as a JAX ``SurfelMap`` of the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import PCFG, PINTR, n, port_frames, t

from hrbffusion3d_tpu.eval import mesh as jmesh
from hrbffusion3d_tpu.eval import recon as jrecon
from hrbffusion3d_tpu.eval import synth as jsynth
from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu_torch.eval import mesh as tmesh
from hrbffusion3d_tpu_torch.eval import recon as trecon
from hrbffusion3d_tpu_torch.eval import synth as tsynth
from hrbffusion3d_tpu_torch.pipeline import slam as tslam

RNG = np.random.default_rng(11)
# points around the default room's surfaces
POINTS = RNG.uniform([-2.0, -1.8, -1.8], [2.0, 1.3, 3.0], (400, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    poses, frames = port_frames(1)
    state = tslam.bootstrap(tslam.FrameInput(t(frames[0][0]), t(frames[0][1])), PINTR, PCFG,
                            init_pose=poses[0])
    m = state.map
    return m, jsm.SurfelMap(data=jnp.asarray(n(m.data)), count=jnp.asarray(n(m.count)))


def test_point_to_scene_distance_matches_jax():
    for make in ("default_room", "complex_room"):
        d_t = n(trecon.point_to_scene_distance(t(POINTS), getattr(tsynth, make)("cpu")))
        d_j = np.asarray(jrecon.point_to_scene_distance(jnp.asarray(POINTS),
                                                        getattr(jsynth, make)()))
        np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("conf_threshold", [0.0, 0.5])
def test_map_accuracy_matches_jax(maps, conf_threshold):
    tm, jm = maps
    a = trecon.map_accuracy(tm, tsynth.default_room("cpu"), conf_threshold)
    b = jrecon.map_accuracy(jm, jsynth.default_room(), conf_threshold)
    assert a["n"] == b["n"] > 1000
    for k in ("mean", "median", "rmse", "p95"):
        assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("scene", ["default_room", "complex_room"])
def test_scene_to_mesh_and_ply_match_jax(tmp_path, scene):
    mt = tmesh.scene_to_mesh(getattr(tsynth, scene)("cpu"), sphere_res=8)
    mj = jmesh.scene_to_mesh(getattr(jsynth, scene)(), sphere_res=8)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)
    pt, pj = tmp_path / "t.ply", tmp_path / "j.ply"
    tmesh.save_ply_mesh(str(pt), mt)
    jmesh.save_ply_mesh(str(pj), mj)
    assert pt.read_bytes() == pj.read_bytes()
    back = tmesh.load_ply_mesh(str(pt))
    np.testing.assert_array_equal(back.vertices, jmesh.load_ply_mesh(str(pt)).vertices)
    np.testing.assert_array_equal(back.faces, mt.faces)


def test_point_to_mesh_distance_matches_jax():
    tri = tmesh.TriMesh(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                        faces=np.array([[0, 1, 2]], np.int32))
    exact = np.array([[0.25, 0.25, 0.5], [2.0, 0.0, 0.0], [0.5, -1.0, 0.0],
                      [0.25, 0.25, 0.0]], np.float32)
    d = tmesh.point_to_mesh_distance(t(exact), tri)
    assert d.dtype == torch.float64
    np.testing.assert_allclose(n(d), [0.5, 1.0, 1.0, 0.0], atol=1e-12)

    mesh = tmesh.scene_to_mesh(tsynth.default_room("cpu"), sphere_res=16)
    d_t = n(tmesh.point_to_mesh_distance(t(POINTS), mesh, chunk=128))
    d_j = jmesh.point_to_mesh_distance(POINTS, mesh)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-9)
    # numpy input: computed on the CPU
    np.testing.assert_allclose(n(tmesh.point_to_mesh_distance(POINTS, mesh)), d_j, atol=1e-9)


def test_map_accuracy_mesh_matches_jax(maps):
    tm, jm = maps
    mesh = tmesh.scene_to_mesh(tsynth.default_room("cpu"), sphere_res=16)
    a = tmesh.map_accuracy_mesh(tm, mesh)
    b = jmesh.map_accuracy_mesh(jm, mesh)
    assert a["n"] == b["n"] > 1000
    for k in ("mean", "median", "rmse", "p95"):
        assert a[k] == pytest.approx(b[k], rel=0, abs=1e-9), k
    assert a["rmse"] < 0.02
