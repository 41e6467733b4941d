"""The port's multi-process setup (``parallel/multihost.py``): JAX's cases
of ``tests/test_multihost.py`` on the port (one process, an 8-shard CPU
mesh: the flat and the two-level ``global_mesh``, ``host_local_batch``),
the mesh's ``psum`` and the one-process ``globalize_sharded_ba``, a real
2-process ``gloo`` solve of the landmark-sharded BA, 4 shards per process,
equal bit for bit to the in-process 8-shard solve of the same problem
(``psum`` over a group adds every shard's system in the global shard
order, as one process does; ``tests/test_multihost_2proc.py`` bounds the
JAX pair by 2e-5), and the mesh's collectives (``psum``, also on values
whose sum depends on its grouping, ``pmin``, ``all_gather`` of blocks of
unequal length, the exclusive scan, ``move_rows``) over a 2-process
``gloo`` group, equal to the one-process results.

The children run ``tests/torch_dist_child.py`` (no JAX), meet at a file
rendezvous in a fresh temporary directory (no port to collide with other
test workers), time out their rendezvous and collectives after 60 s, and
are killed if they outlive the test's deadline."""

import numpy as np
import pytest
import torch
import torch_dist_child

from hrbffusion3d_tpu_torch.parallel import dist_ba, multihost, sharding

torch.set_num_threads(1)


def test_global_mesh_flat_and_two_level():
    """JAX's case: one process gives a mesh of its own shards, on the flat
    ``("map",)`` axis or on ``("host", "chip")`` with ``host`` the process
    count."""
    mesh = multihost.global_mesh(local_shards=8, device="cpu")
    assert mesh.size == 8 and mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.group is None and mesh.first_shard == 0
    assert mesh.axis_names == ("map",)
    mesh2 = multihost.global_mesh(local_shards=8, device="cpu", two_level=True)
    assert mesh2.axis_names == ("host", "chip")
    assert mesh2.size == 8 and mesh2.shape["host"] == 1 and mesh2.shape["chip"] == 8


def test_host_local_batch_single_process():
    """JAX's case: one process's frame stack is the whole batch, its frames
    split over the mesh's shards."""
    mesh = multihost.global_mesh(local_shards=8, device="cpu")
    n = mesh.size
    depth = np.random.RandomState(0).rand(n, 8, 16).astype(np.float32)
    rgb = np.random.RandomState(1).rand(n, 8, 16, 3).astype(np.float32)
    fi = multihost.host_local_batch(mesh, depth, rgb)
    assert fi.depth.shape == (n, 8, 16) and len(fi.depth.parts) == 8
    np.testing.assert_allclose(fi.depth.gather().numpy(), depth)
    np.testing.assert_allclose(fi.rgb.gather().numpy(), rgb)
    assert multihost.is_coordinator()
    with pytest.raises(ValueError, match="no axis 'pix'"):
        multihost.host_local_batch(mesh, depth, rgb, axis="pix")


def test_make_mesh_layout_and_setup_errors(monkeypatch):
    """Shards lie round-robin over the devices given (a device may repeat);
    without devices a mesh needs the card; ``initialize`` needs its three
    settings and an explicit backend."""
    mesh = sharding.make_mesh(3, devices=["cpu", "meta"])
    assert mesh.devices == tuple(torch.device(d) for d in ("cpu", "meta", "cpu"))
    assert mesh.size == 3 and mesh.group is None
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 1, 0, backend="mpi")
    with pytest.raises(ValueError, match="process count"):
        multihost.initialize("localhost:1", backend="gloo")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices are valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()


def test_psum_adds_shards_in_order():
    """``Mesh.psum`` adds the shards' parts in shard order and hands each
    shard the sums; it needs one part list per local shard."""
    mesh = sharding.make_mesh(3, devices=["cpu"])
    rng = np.random.default_rng(0)
    parts = [[torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
              torch.tensor(float(k))] for k in range(3)]
    sums = mesh.psum(parts)
    assert len(sums) == 3
    want = (parts[0][0] + parts[1][0]) + parts[2][0]
    for s in sums:
        assert torch.equal(s[0], want) and float(s[1]) == 3.0
    with pytest.raises(ValueError, match="psum got 2"):
        mesh.psum(parts[:2])


def test_globalize_sharded_ba_one_process():
    """In one process ``globalize_sharded_ba`` is the placed problem; it
    and the solver refuse a partition for another shard count."""
    prob = torch_dist_child.make_problem(n_lms=16)[0]
    mesh = sharding.make_mesh(4, devices=["cpu"])
    sb = dist_ba.partition_problem(prob, 4)
    placed = multihost.globalize_sharded_ba(sb, mesh)
    assert len(placed.shards) == 4
    for a, b in zip(placed.shards, sb.shards):
        assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
    with pytest.raises(ValueError, match="the problem has 2 shards, the mesh 4"):
        multihost.globalize_sharded_ba(dist_ba.partition_problem(prob, 2), mesh)
    with pytest.raises(ValueError, match="2 shards for a mesh that runs 4"):
        dist_ba.make_optimizer(mesh)(dist_ba.partition_problem(prob, 2))


def test_two_process_dist_ba_matches_single_process(tmp_path):
    out = tmp_path / "proc0.npz"
    multihost.launch_local(torch_dist_child.solve_rank, 2, args=(4, str(out)), timeout_s=90.0)
    got = np.load(out)

    prob = torch_dist_child.make_problem()[0]
    mesh = sharding.make_mesh(8, devices=["cpu"])
    cams, points, chi = dist_ba.make_optimizer(mesh)(dist_ba.partition_problem(prob, 8))
    # the group adds the 8 shards' systems in the in-process order: exact
    np.testing.assert_array_equal(got["cams"], cams.numpy())
    np.testing.assert_array_equal(got["points"],
                                  dist_ba.gather_points(points, prob.points.shape[0]))
    np.testing.assert_array_equal(got["chi"], chi.numpy())


def test_two_process_collectives_match_single_process(tmp_path):
    out = tmp_path / "proc0.npz"
    multihost.launch_local(torch_dist_child.collectives_rank, 2, args=(3, str(out)),
                           timeout_s=90.0)
    got = np.load(out)
    mesh = sharding.make_mesh(6, devices=["cpu"])
    vals = [torch_dist_child.shard_values(k) for k in range(6)]
    np.testing.assert_array_equal(got["psum"],
                                  mesh.psum([[v[1].to(torch.float32)] for v in vals])[0][0])
    # the group adds every shard's part in the global shard order, as one
    # process does; each process's sum first would round otherwise
    cancelling = [torch.tensor([x], dtype=torch.float32) for x in torch_dist_child.CANCELLING]
    in_process = mesh.psum([[x] for x in cancelling])[0][0]
    per_process = sum(cancelling[:3], torch.zeros(1)) + sum(cancelling[3:], torch.zeros(1))
    assert float(in_process[0]) == 2.0 and float(per_process[0]) == 0.0
    np.testing.assert_array_equal(got["exact"], in_process)
    np.testing.assert_array_equal(got["pmin"], mesh.pmin([[v[1]] for v in vals])[0][0])
    np.testing.assert_array_equal(got["gathered"], torch.cat([v[0] for v in vals]))
    counts = [int(v[2]) for v in vals]
    assert int(got["total"]) == sum(counts)
    np.testing.assert_array_equal(got["offsets"], np.cumsum([0] + counts)[:3])
    # the row move: process 0's rows after it, and the rows that came from
    # process 1, which are exactly those of its shards that land in
    # process 0's block
    n_rows, pos = torch_dist_child.move_positions(6)
    bounds = sharding.row_bounds(n_rows, 6)
    want = mesh.move_rows([v[0] for v in vals], pos, bounds,
                          [torch.zeros(b - a, 3) for a, b in bounds])
    np.testing.assert_array_equal(got["moved"], torch.cat(want[:3]))
    came = sum(int((p < bounds[2][1]).sum()) for p in pos[3:])
    assert int(got["received_rows"]) == came and 0 < came < sum(p.numel() for p in pos[3:])
