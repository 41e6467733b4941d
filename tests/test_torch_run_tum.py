"""The port's ``run_tum`` entry point end to end on the CPU, on a 12-frame
TUM-format fixture at 128x96 that ``io/tum.write_sequence`` writes from the
port's synthetic orbit (PNG rows cycling through all five filters):

- the tracked run (the production mode: keyframe backend on its worker
  thread) writes every artefact, each parses, and the ATE against the
  fixture's ``groundtruth.txt`` is finite and under 3 cm (the full-system
  tests' bound);
- the replay run (``--load-trajectory`` on the ground truth, BA off,
  the first 6 frames) writes back the input trajectory within 1e-6;
- the command line maps its options onto ``run`` as ``scripts/run_tum.py``
  does (``run`` itself is stubbed there: the presets are 640x480).
"""

import dataclasses
import json

import numpy as np
import pytest
from PIL import Image
from torch_parity_utils import port_cfg, port_intr

from hrbffusion3d_tpu.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch import config as tconfig
from hrbffusion3d_tpu_torch import run_tum
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.io import ply, traj, tum
from hrbffusion3d_tpu_torch.pipeline import slam

N = 12
# at 64x48 the small config's tracking alone drifts 3-4 cm over this orbit
PINTR = port_intr(CameraIntrinsics(fx=103.0, fy=103.0, cx=64.0, cy=48.0, width=128, height=96))
CFG = port_cfg(small_test_config(map_capacity=1 << 14, pyramid_iterations=(4, 3, 2),
                                 predict_conf_threshold=0.2, keyframe_period=5))
BACKEND = dict(fast_threshold=8.0, ba_pad_min=(0, 0, 0))
TS = 1305031102.175304 + np.arange(N) / 30.0


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    gt = synth.orbit_trajectory(N, angle_per_frame=0.004)
    scene = synth.default_room("cpu")
    frames = [slam.FrameInput(*synth.render_frame(scene, p, PINTR)) for p in gt]
    tum.write_sequence(str(root), np.stack([f.depth.numpy() for f in frames]),
                       np.stack([f.rgb.numpy() for f in frames]), TS, gt,
                       filters=np.arange(PINTR.height) % 5)
    return str(root), gt


def test_run_writes_and_parses_every_artefact(fixture, tmp_path):
    root, gt = fixture
    out = tmp_path / "out"
    res = run_tum.run(root, PINTR, CFG, out=str(out), stats=True, views=2, device="cpu",
                      backend_kwargs=BACKEND)
    assert res["frames"] == N and res["ate_matched"] == N
    assert np.isfinite(res["ate_m"]) and res["ate_m"] < 0.03, res
    # keyframes due at frames 1, 6, 11: the worker took every one
    assert res["keyframes"] == 3 and res["archive_dropped"] == 0

    ts, poses = traj.load_tum(str(out / "hrbf_trajectory.freiburg"))
    np.testing.assert_allclose(ts, TS, atol=1e-6)
    assert poses.shape == (N, 4, 4) and np.isfinite(poses).all()
    kts, _ = traj.load_tum(str(out / "KeyFrameTrajectory.txt"))
    np.testing.assert_array_equal(kts, [1, 6, 11])
    assert ply.load_ply_positions(str(out / "hrbf_globalModel.ply")).shape == (res["surfels"], 3)
    rows = [json.loads(line) for line in open(out / "stats.jsonl")]
    assert [r["frame"] for r in rows] == list(range(N))
    assert rows[-1]["surfels"] > 1000 and rows[-1]["icp_count"] > 0
    assert "processFrame" in (out / "sequence_processing_time.txt").read_text()
    assert len((out / "mean_error_pose.txt").read_text().splitlines()) == N
    assert len((out / "inliers_num.txt").read_text().splitlines()) == N
    for k in range(2):
        img = np.asarray(Image.open(out / "views" / f"view_{k:03d}.png"))
        assert img.shape == (PINTR.height, PINTR.width, 3)


def test_replay_writes_back_the_input_trajectory(fixture, tmp_path):
    root, gt = fixture
    _, replay = traj.load_tum(root + "/groundtruth.txt")
    cfg = dataclasses.replace(CFG, use_local_ba=False, use_global_ba=False)
    res = run_tum.run(root, PINTR, cfg, out=str(tmp_path), end=6, replay_poses=replay,
                      device="cpu", backend_kwargs=BACKEND)
    _, poses = traj.load_tum(str(tmp_path / "hrbf_trajectory.freiburg"))
    np.testing.assert_allclose(poses, replay[:6], atol=1e-6)
    assert res["frames"] == 6 and res["keyframes"] == 0 and res["ate_m"] < 1e-6


def test_command_line_maps_onto_run(fixture, tmp_path, monkeypatch, capsys):
    root, _ = fixture
    seen = []
    monkeypatch.setattr(run_tum, "run", lambda *a, **k: seen.append((a, k)) or {"frames": 0})
    run_tum.main([root, "--camera", "TUM2", "--start", "2", "--end", "9", "--out",
                  str(tmp_path), "--no-ba", "--capacity", "4096", "--stats", "--views", "3"])
    (args, kw), = seen
    assert args[:2] == (root, tconfig.TUM2)
    assert args[2] == dataclasses.replace(tconfig.SLAMConfig(), map_capacity=4096,
                                          use_local_ba=False, use_global_ba=False)
    assert (kw["start"], kw["end"], kw["stats"], kw["views"], kw["replay_poses"]) == \
        (2, 9, True, 3, None)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"run_tum": {"frames": 0}}

    seen.clear()
    run_tum.main([root, "--load-trajectory", root + "/groundtruth.txt"])
    (args, kw), = seen
    assert args[1] == tconfig.TUM1 and args[2].map_capacity == 1 << 19
    assert not (args[2].use_local_ba or args[2].use_global_ba)
    np.testing.assert_array_equal(kw["replay_poses"],
                                  traj.load_tum(root + "/groundtruth.txt")[1])
