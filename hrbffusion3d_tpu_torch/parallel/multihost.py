"""Multi-process setup for the landmark-sharded bundle adjustment and the
row-sharded dense step (port of ``hrbffusion3d_tpu/parallel/multihost.py``).

Each process runs the same engine; ``torch.distributed`` joins them, and a
mesh over all of them (``global_mesh``) gives each process its own shards,
whose collectives (``Mesh.psum`` of the partial camera systems and Gram
matrices, the halo and owner exchanges of the dense step) run over the
group:

  initialize()            -- ``torch.distributed.init_process_group`` with
                             the JAX module's environment fallbacks and an
                             explicit backend
  global_mesh()           -- a mesh over every process, the same number of
                             shards in each, on one ``("map",)`` axis or on
                             two, ``("host", "chip")``
  host_local_batch()      -- a frame batch made of each process's own frame
                             stack, split over the mesh
  globalize_sharded_ba()  -- this process's shards of a partitioned problem,
                             placed on its devices
  is_coordinator()        -- process 0 (of the world, or of a group)
  agree_min()             -- the least of one host integer over the
                             processes (how many finished keyframe results
                             every process holds)
  check_replicas()        -- raise on every process, naming the field and
                             the ranks, where values that every process
                             computes alike differ (``digest()``, a 64-bit
                             digest of each process's host arrays,
                             all-gathered)
  barrier()               -- every process of the group reaches it
  same_ranks_group()      -- a new process group of a group's processes,
                             in the same order (a second communicator)
  launch_local()          -- run a function in N spawned processes on this
                             host, joined by a file rendezvous, with a
                             deadline after which every one is killed

Without ``initialize`` every helper works on the one process (the
collective ones do nothing).  The host-integer collectives run on a CPU
tensor over a ``gloo`` group, on the process's card over ``nccl``.

Departures from JAX: nothing auto-detects a cluster here, so ``initialize``
needs all three of its settings; the backend is named by the caller
(``nccl`` for one GPU per process, ``gloo`` otherwise) and never switched
silently.  ``globalize_sharded_ba`` takes each process's own shards and
their own plans (the JAX function still builds the problem's fields from
before the plans were added).

The two-level layout names the axes as JAX does (``host`` = the process
count, ``chip`` = the shards of each process).  The row-sharded dense
state (``sharding.shard_state``, ``parallel/sharded_step``) splits over
the flat mesh's ``"map"`` axis or over both axes of the two-level one, in
the global shard order; over a group each process holds only its own
shards, and the step exchanges halos, owner-merged rows and moved rows
through the group.
"""

from __future__ import annotations

import datetime
import hashlib
import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..pipeline.slam import FrameInput
from ..utils.tensors import device_or_card
from .dist_ba import ShardedBA, place
from .mesh import host_ints
from .sharding import Mesh, ShardedRows, concrete_device, row_bounds


# rendezvous and every collective give up after this long
TIMEOUT = datetime.timedelta(seconds=60)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str) -> None:
    """``torch.distributed.init_process_group`` for this process, with the
    environment fallbacks ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
    ``PROCESS_ID``.  The address is ``host:port`` (TCP) or an init URL
    (``tcp://...``, ``file://...``).  ``backend``: ``nccl`` (one GPU per
    process: the process takes ``cuda:<process_id % device count>``) or
    ``gloo``.  Rendezvous and every collective time out after ``TIMEOUT``;
    the caller leaves the group with
    ``torch.distributed.destroy_process_group()``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    n = num_processes or os.environ.get("NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get("PROCESS_ID")
    if not addr or n is None or pid is None:
        raise ValueError("initialize needs the coordinator address, the process count and "
                         "this process's id (arguments or COORDINATOR_ADDRESS / "
                         "NUM_PROCESSES / PROCESS_ID)")
    n, pid = int(n), int(pid)
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=n, rank=pid, timeout=TIMEOUT)


def global_mesh(local_shards: int = 1, device=None, two_level: bool = False) -> Mesh:
    """A mesh over every process, ``local_shards`` shards each on this
    process's ``device`` (None: its CUDA card).  ``two_level=False``: the
    flat ``("map",)`` axis; ``True``: ``("host", "chip")``, ``host`` the
    process count and ``chip`` the shards of each process."""
    dev = concrete_device(device_or_card(device))
    group = dist.group.WORLD if dist.is_initialized() else None
    if not two_level:
        return Mesh((dev,) * local_shards, group)
    n_hosts = dist.get_world_size(group) if group is not None else 1
    return Mesh((dev,) * local_shards, group, axis_names=("host", "chip"),
                axis_sizes=(n_hosts, local_shards))


def host_local_batch(mesh: Mesh, local_depth, local_rgb, axis: str = "map") -> FrameInput:
    """A frame batch whose leading axis is the frames of every process in
    process order (each process passes its own stack, all of one length),
    split over the mesh's shards: this process's stack over its own
    shards.  ``axis`` must name an axis of the mesh."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r}: its axes are {mesh.axis_names}")
    out = []
    for x in (local_depth, local_rgb):
        x = torch.as_tensor(x)
        n = x.shape[0]
        every = [(r * n + a, r * n + b) for r in range(mesh.n_ranks)
                 for a, b in row_bounds(n, len(mesh.devices))]
        bounds, lo = mesh.local(every), mesh.rank * n
        parts = [x[a - lo:b - lo].to(dev, copy=True) for (a, b), dev in zip(bounds, mesh.devices)]
        out.append(ShardedRows(parts, bounds, n * mesh.n_ranks, mesh, all_bounds=every))
    return FrameInput(*out)


def globalize_sharded_ba(sb: ShardedBA, mesh: Mesh) -> ShardedBA:
    """This process's shards of a problem partitioned for the whole mesh
    (``partition_problem(prob, mesh.size)``, the same on every process),
    with their plans, on their devices; the cameras and gauge replicated.
    One process: the placed problem, which ``make_optimizer``'s solver
    takes."""
    if len(sb.shards) != mesh.size:
        raise ValueError(f"the problem has {len(sb.shards)} shards, the mesh {mesh.size}")
    lo = mesh.first_shard
    return place(sb._replace(shards=sb.shards[lo:lo + len(mesh.devices)]), mesh)


def is_coordinator(group=None) -> bool:
    """Whether this is process 0 of ``group`` (None: the world)."""
    return not dist.is_initialized() or dist.get_rank(group) == 0


def agree_min(n: int, group=None) -> int:
    """The least of ``n`` over ``group``'s processes (None: the world);
    ``n`` itself on one process."""
    if not dist.is_initialized():
        return int(n)
    t = host_ints([int(n)], group)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t[0])


def digest(arrays) -> int:
    """A 64-bit digest of a sequence of host values (numpy arrays, numbers,
    None, nested tuples and lists): each one's bytes with its shape and
    dtype."""
    h = hashlib.blake2b(digest_size=8)

    def feed(x):
        if x is None:
            h.update(b"None;")
        elif isinstance(x, (tuple, list)):
            h.update(f"seq{len(x)}(".encode())
            for y in x:
                feed(y)
            h.update(b")")
        else:
            a = np.ascontiguousarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
            h.update(f"{a.dtype.str}{a.shape};".encode())
            h.update(a.tobytes())

    for x in arrays:
        feed(x)
    return int.from_bytes(h.digest(), "little", signed=True)


def check_replicas(name: str, arrays, group=None) -> None:
    """Raise, on every process of ``group`` (None: the world), unless every
    process holds the same ``arrays`` (host values that each process
    computes alike: a keyframe's pose, a correction's deltas, a loop's
    pair): a 64-bit digest of them is all-gathered, and the error names
    ``name`` and the ranks that differ from rank 0.  Nothing on one
    process."""
    if not dist.is_initialized():
        return
    mine = host_ints([digest(arrays)], group)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    digests = [int(x[0]) for x in every]
    differ = [r for r, d in enumerate(digests) if d != digests[0]]
    if differ:
        raise RuntimeError(f"replicas differ in {name}: ranks {differ} hold other values than "
                           f"rank 0 (digests {digests}, this is rank "
                           f"{dist.get_rank(group)})")


def barrier(group=None) -> None:
    """Every process of ``group`` (None: the world) reaches this point;
    nothing on one process."""
    if dist.is_initialized():
        dist.barrier(group=group)


def same_ranks_group(group=None):
    """A new process group of ``group``'s processes (None: the world), in
    the same order and on the same backend.  Every process of the world
    must call it, in the same order as its other ``new_group`` calls."""
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    return dist.new_group(ranks=ranks, backend=dist.get_backend(group), timeout=TIMEOUT)


def launch_local(target, n_processes: int, args: tuple = (), timeout_s: float = 120.0) -> None:
    """Run ``target(coordinator_address, n_processes, process_id, *args)`` in
    ``n_processes`` processes started with the spawn method (a process that
    has used CUDA cannot fork), each to call ``initialize`` with the
    address, a file rendezvous in a fresh temporary directory.  ``target``
    must be importable by the children (a module-level function).  Waits
    at most ``timeout_s`` for all of them, then kills any still running;
    raises unless every one exited with 0."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        addr = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=target, args=(addr, n_processes, r, *args), daemon=True)
                 for r in range(n_processes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
    if hung:
        raise TimeoutError(f"processes {hung} of {n_processes} still ran after {timeout_s} s "
                           "and were killed")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"processes exited with codes {failed} (their tracebacks are on "
                           "stderr)")
