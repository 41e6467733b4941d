"""The port's headless viewer, run statistics and stopwatch against the JAX
package's.

- ``viz/viewer.render_view``: the same map (the port's bootstrap map of a
  64x48 frame, given to JAX as a JAX ``SurfelMap``) rendered from the same
  virtual camera: uint8 within 1 level on >= 99.9 % of the pixels, in each
  mode; ``turntable`` writes PNGs that Pillow reads back;
- ``viz/stats``: ``StatsLogger`` rows within 1e-6 of JAX's on the same
  state, and the reference artefacts and prediction dumps equal to JAX's;
- ``utils/timing.Stopwatch``: the JAX suite's checks (tests/test_utils_eval.py,
  tests/test_viz.py), and the same summary and dump as JAX's on the same
  samples.
"""

import json
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity_utils import INTR, PCFG, PINTR, n, port_frames, t

from hrbffusion3d_tpu.map import surfel_map as jsm
from hrbffusion3d_tpu.utils import timing as jtiming
from hrbffusion3d_tpu.viz import stats as jstats
from hrbffusion3d_tpu.viz import viewer as jviewer
from hrbffusion3d_tpu_torch.io import png
from hrbffusion3d_tpu_torch.pipeline import slam as tslam
from hrbffusion3d_tpu_torch.utils import timing as ttiming
from hrbffusion3d_tpu_torch.viz import stats as tstats
from hrbffusion3d_tpu_torch.viz import viewer as tviewer


@pytest.fixture(scope="module")
def boot():
    poses, frames = port_frames(1)
    state = tslam.bootstrap(tslam.FrameInput(t(frames[0][0]), t(frames[0][1])), PINTR, PCFG,
                            init_pose=poses[0])
    jmap = jsm.SurfelMap(data=jnp.asarray(n(state.map.data)),
                         count=jnp.asarray(n(state.map.count)))
    return state, jmap, poses[0]


@pytest.mark.parametrize("mode", ["color", "normal", "phong", "conf"])
def test_render_view_matches_jax(boot, mode):
    state, jmap, pose0 = boot
    cam = pose0.copy()
    cam[:3, 3] += [0.05, -0.03, -0.1]          # a step back and aside
    a = tviewer.render_view(state.map, cam, PINTR, mode=mode)
    b = jviewer.render_view(jmap, cam, INTR, mode=mode)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (48, 64, 3)
    diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999, np.argwhere(diff > 1)
    bg = int(0.12 * 255)
    assert (np.abs(a.astype(int) - bg).sum(-1) > 10).mean() > 0.4
    with pytest.raises(ValueError, match="unknown mode"):
        tviewer.render_view(state.map, cam, PINTR, mode="x")


def test_turntable_writes_pngs(boot, tmp_path):
    state, jmap, _ = boot
    paths = tviewer.turntable(state.map, PINTR, str(tmp_path), n_views=2,
                              look_at=(0.0, 0.0, 1.5))
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["view_000.png", "view_001.png"]
    for k, p in enumerate(paths):
        img = png.read(p)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        assert img.shape == (48, 64, 3) and img.dtype == np.uint8


def _jax_state(state):
    """The JAX-side twin of the scalars and maps ``viz/stats`` reads."""
    class JState:
        last_icp_error = jnp.float32(0.25)
        last_icp_count = jnp.float32(1234.0)
        dense_frac = jnp.asarray(n(state.dense_frac))
        map = jsm.SurfelMap(data=jnp.zeros((1, 24)), count=jnp.asarray(n(state.map.count)))
        t = jnp.asarray(n(state.t))

    for name in ("pred_vertex", "pred_normal", "pred_intensity", "pred_icp_weight",
                 "pred_k1", "pred_k2"):
        setattr(JState, name, jnp.asarray(n(getattr(state, name))))
    return JState()


def test_stats_logger_matches_jax(boot, tmp_path):
    state, _, _ = boot
    state = state._replace(last_icp_error=torch.tensor(0.25), last_icp_count=torch.tensor(1234.0))
    js = _jax_state(state)
    rows = {}
    for side, mod, st in (("t", tstats, state), ("j", jstats, js)):
        d = tmp_path / side
        d.mkdir()
        lg = mod.StatsLogger(str(d / "stats.jsonl"))
        lg.log_state(0, st, extra={"fps": 3.0})
        lg.log_state(1, st)
        lg.close()
        lg.dump_reference_artifacts(str(d))
        mod.dump_prediction_textures(st, str(d / "pred"), frame=3)
        rows[side] = [json.loads(line) for line in open(d / "stats.jsonl")]
    for a, b in zip(rows["t"], rows["j"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    assert rows["t"][0]["icp_count"] == 1234 and rows["t"][0]["fps"] == 3.0
    assert rows["t"][1]["surfels"] == int(state.map.count)
    for name in ("mean_error_pose.txt", "inliers_num.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    for name in ("pred_vertex", "pred_normal", "pred_intensity", "pred_icp_weight",
                 "pred_k1", "pred_k2"):
        a = np.load(tmp_path / "t" / "pred" / f"{name}_00003.npy")
        b = np.load(tmp_path / "j" / "pred" / f"{name}_00003.npy")
        np.testing.assert_array_equal(a, b)


def test_stopwatch(tmp_path):
    sw = ttiming.Stopwatch()
    with sw.time("stage_a", sync=torch.zeros(2)):
        time.sleep(0.01)
    sw.tick("stage_b")
    time.sleep(0.005)
    sw.tock("stage_b")
    s = sw.summary()
    assert s["stage_a"]["mean_ms"] >= 9 and s["stage_b"]["count"] == 1
    with pytest.raises(ValueError, match="mismatched"):
        sw.tick("x")
        sw.tock("y")
    # the same samples give JAX's summary and dump
    jw = jtiming.Stopwatch()
    jw.samples.update({k: list(v) for k, v in sw.samples.items()})
    assert sw.summary() == jw.summary()
    sw.dump(str(tmp_path / "t.txt"))
    jw.dump(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    sw.broadcast(port=rx.getsockname()[1], signature=42)
    payload = json.loads(rx.recv(65536).decode())
    rx.close()
    assert payload["signature"] == 42 and set(payload["timings_ms"]) == {"stage_a", "stage_b"}
