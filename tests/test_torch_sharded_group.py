"""The row-sharded dense step over a process group: 2 ``gloo`` processes
(``multihost.launch_local`` running ``tests/torch_dist_child.py``, no
JAX), with 1 shard each on the flat ``("map",)`` mesh and 4 each on the
two-level ``("host", "chip")`` mesh, run ``torch_dist_child.dense_run``
for the default and the top-k tracking settings: bootstrap of a sharded
frame, a tracked step on a compaction and crowd-rule frame, ``grow``, a
tracked step, ``exchange_active`` with a whole archive (rows leave and
enter), and a replayed step on a compaction and crowd-rule frame.  Every
process holds only its own shards' rows, and they equal the in-process
mesh of the same shard count bit for bit (map rows and count, every image
field, the pose, the archive and the exchange's stats); every row move
brings a process only the rows that land in its block.

The in-process mesh's ``grow`` and ``exchange_active`` are held to the
unsharded map's here too: ``grow`` bit for bit, the exchange on the active
map, the archive's live rows and the stats (past its count the sharded
archive's rows are pristine, where the unsharded one holds dead active
rows)."""

import numpy as np
import pytest
import torch
import torch_dist_child

from hrbffusion3d_tpu_torch.map import surfel_map as sm
from hrbffusion3d_tpu_torch.parallel import multihost, sharded_step, sharding
from hrbffusion3d_tpu_torch.pipeline import slam

torch.set_num_threads(1)

MODES = tuple(torch_dist_child.DENSE_MODES)
REPLICATED = ("count", "R", "t", "archive", "archive_count", "stats", "active_submaps",
              "last_icp_error", "last_icp_count", "dense_frac")


LAYOUTS = ((1, False), (4, True))


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """One launch of the two processes for both layouts (one rendezvous)."""
    out = tmp_path_factory.mktemp("group")
    multihost.launch_local(torch_dist_child.dense_rank, 2, args=(LAYOUTS, MODES, str(out)),
                           timeout_s=150.0)
    return out


@pytest.mark.parametrize("local_shards,two_level", LAYOUTS)
def test_group_equals_in_process_mesh(group_runs, local_shards, two_level):
    for mode in MODES:
        ref = np.load(group_runs / f"{local_shards}_{mode}_ref.npz")
        ranks = [np.load(group_runs / f"{local_shards}_{mode}_{r}.npz") for r in range(2)]
        assert ref["stats"][0] > 0 and ref["stats"][1] > 0
        for r, got in enumerate(ranks):
            assert set(got["devices"]) == {"cpu"} and len(got["devices"]) == local_shards
            # a process holds its own half of the map rows, no more
            assert got["map"].shape[0] * 2 == ref["map"].shape[0]
        # every row move (new surfels, merges, compactions, grow, the
        # exchange) brought a process exactly the rows that the other one
        # sent to its block, never the whole map
        moves = [got["moves"] for got in ranks]
        assert moves[0].shape == moves[1].shape and moves[0].shape[0] >= 10
        for r in range(2):
            received, held = moves[r][:, 0], moves[r][:, 2]
            np.testing.assert_array_equal(received, moves[1 - r][:, 1], err_msg=f"{mode} {r}")
            assert (received <= held).all() and received.sum() < held.sum()
        assert moves[0][:, 0].sum() + moves[1][:, 0].sum() > 0
        for key in ref.files:
            if key == "devices":
                continue
            if key in REPLICATED:
                for r, got in enumerate(ranks):
                    np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{mode} {key} {r}")
            else:
                whole = np.concatenate([got[key] for got in ranks])
                np.testing.assert_array_equal(whole, ref[key], err_msg=f"{mode} {key}")


def test_in_process_grow_and_exchange_match_unsharded():
    intr, cfg, poses, frames, archive = torch_dist_child.dense_setup("default")
    whole = slam.step(slam.bootstrap(frames[0], intr, cfg, init_pose=poses[0]), frames[1],
                      intr, cfg)
    mesh = sharding.make_mesh(3, devices=["cpu"])
    st = sharding.shard_state(whole, mesh, cfg)
    grown = sharded_step.grow(st.map, 2 * cfg.map_capacity)
    want = sm.grow(whole.map, 2 * cfg.map_capacity)
    assert len(grown.data.parts) == 3
    assert torch.equal(grown.data.gather(), want.data) and torch.equal(grown.count, want.count)
    active = torch.tensor([False, True, True, True])
    a2, r2, stats = sharded_step.exchange_active(st.map, archive, active, whole.time, cfg)
    wa, wr, wstats = sm.exchange_active(whole.map, archive, active, whole.time, cfg)
    assert torch.equal(stats, wstats) and int(wstats[0]) > 0 and int(wstats[1]) > 1500
    assert torch.equal(a2.data.gather(), wa.data) and torch.equal(a2.count, wa.count)
    n_arch = int(wr.count)
    assert torch.equal(r2.count, wr.count)
    assert torch.equal(r2.data[:n_arch], wr.data[:n_arch])
    assert torch.equal(r2.data[n_arch:], sm._empty_rows(r2.data.shape[0] - n_arch, "cpu"))
