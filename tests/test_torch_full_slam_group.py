"""``FullSLAM(mesh=)`` over a process group: 2 ``gloo`` processes
(``multihost.launch_local`` running ``tests/torch_dist_child.py``, no JAX)
on ``tests/test_torch_full_slam_mesh.py``'s protocol (13 frames of the
orbit at 128x96, a keyframe every 4 frames) rendered by the port's own
``eval/synth``, with the active-window / archive split; 32 features per
keyframe, so that keyframes share fewer than 15 landmarks and the older
submaps leave the active window (rows move to the archive).

  (a) the sync run on 2 processes x 2 shards (``process_batch`` over
      frames 0-7, then 8-12) equals ``FullSLAM(mesh=make_mesh(4))`` in
      this process bit for bit: every pose, every keyframe pose, the map
      rows (each process holds its own half), the map's count, the
      archive and ``archive_dropped``;
  (b) the async run through ``process`` (2 processes x 1 shard) gives
      both processes the same results bit for bit, and the same
      corrections applied at the same frames (the processes agree on how
      many finished results to apply);
  (c) the checkpoint (a)'s group saved after frame 8, resumed by a new
      group of new processes on 2 x 2 shards over frames 8-12, equals (a)
      bit for bit;
  (d) when process 1's local BA returns deltas moved by 1e-6 (2 processes
      x 1 shard), ``multihost.check_replicas`` raises on both processes at
      that keyframe and the launch fails.

The JAX anchor of this protocol is ``tests/test_torch_full_slam_mesh.py``,
which holds the in-process mesh against JAX; no JAX multi-process
FullSLAM runs here: the JAX package's multi-process path cannot run
(ROADMAP Queue 3 item 6).

One module fixture makes a launch for each of (a)-(d) at once ((c) waits
for (a)'s checkpoint) and runs (a) on the in-process mesh meanwhile, so
that the file stays within its time."""

import threading

import numpy as np
import pytest
import torch
import torch_dist_child as child

from hrbffusion3d_tpu_torch.parallel import multihost, sharding

torch.set_num_threads(1)

SHARDS = 2
REPLICATED = ("poses", "kf_poses", "count", "archive", "archive_count", "archive_dropped",
              "loops", "applied", "async_corrections")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four launches and the in-process ``make_mesh(4)`` run of (a),
    all at once; returns (their directory, (a)'s rows in this process,
    each failed launch's error)."""
    out = tmp_path_factory.mktemp("full_group")
    failures = {}

    def launch(key, target, args):
        try:
            multihost.launch_local(target, 2, args=args, timeout_s=150.0)
        except Exception as e:  # noqa: BLE001 -- the tests read it
            failures[key] = e

    threads = [threading.Thread(target=launch, args=a) for a in (
        ("sync", child.full_sync_rank, (SHARDS, str(out))),
        ("async", child.full_async_rank, (1, str(out))),
        ("resume", child.full_resume_rank, (SHARDS, str(out))),
        ("mismatch", child.full_mismatch_rank, (1, str(out))))]
    for t in threads:
        t.start()
    try:
        ref = child.full_sync_run(sharding.make_mesh(2 * SHARDS, devices=["cpu"]))
    finally:
        # launch_local kills its processes after 150 s and then returns
        for t in threads:
            t.join(200.0)
    assert not any(t.is_alive() for t in threads)
    return out, ref, failures


def _ranks(out, part):
    return [np.load(out / f"{part}_{r}.npz") for r in range(2)]


def _assert_equal_to(ranks, ref, label):
    for key in ref:
        if key == "map":
            # each process holds its own shards' rows, half the map
            assert ranks[0][key].shape[0] * 2 == ref[key].shape[0]
            whole = np.concatenate([g[key] for g in ranks])
            np.testing.assert_array_equal(whole, ref[key], err_msg=f"{label} map")
        else:
            for r, g in enumerate(ranks):
                np.testing.assert_array_equal(g[key], ref[key], err_msg=f"{label} {key} {r}")


def test_sync_group_equals_in_process_mesh(runs):
    out, ref, failures = runs
    assert "sync" not in failures, failures.get("sync")
    assert ref["poses"].shape == (child.FULL_FRAMES, 4, 4) and np.isfinite(ref["poses"]).all()
    assert len(ref["kf_poses"]) >= 3
    # rows left the active window for the archive at the exchanges
    assert int(ref["archive_count"]) > 0
    _assert_equal_to(_ranks(out, "sync"), ref, "sync")


def test_async_group_processes_agree(runs):
    out, _, failures = runs
    assert "async" not in failures, failures.get("async")
    ranks = _ranks(out, "async")
    assert ranks[0]["poses"].shape == (child.FULL_FRAMES, 4, 4)
    assert np.isfinite(ranks[0]["poses"]).all()
    applied = ranks[0]["applied"]
    # every keyframe after the bootstrap's was handed back and applied
    assert len(applied) >= 2 and list(applied[:, 1]) == list(range(1, len(applied) + 1))
    # the replicated fields; the map rows are each process's own half
    for key in REPLICATED:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=f"async {key}")


def test_checkpoint_resumed_by_a_new_group(runs):
    out, ref, failures = runs
    assert "resume" not in failures, failures.get("resume")
    _assert_equal_to(_ranks(out, "resume"), ref, "resume")


def test_replica_mismatch_raises_on_every_process(runs):
    out, _, failures = runs
    err = failures.get("mismatch")
    assert isinstance(err, RuntimeError) and "codes {0: 1, 1: 1}" in str(err), err
    for r in range(2):
        msg = (out / f"mismatch_{r}.txt").read_text()
        assert "replicas differ in keyframe 1" in msg and "ranks [1]" in msg, msg
        assert f"this is rank {r}" in msg
