"""A mesh of shards for the landmark-sharded bundle adjustment (port of
``hrbffusion3d_tpu/parallel/sharding.py``'s ``make_mesh``).

PyTorch has no single-controller mesh, so the port defines a small one.
A ``Mesh`` holds the shards this process runs, one device each, and, when
several processes share the work, the ``torch.distributed`` process group
that joins them (every process runs as many shards).  Its one
collective is ``psum``: the partial tensors of this process's shards are
summed in shard order on the first shard's device, then all-reduced over
the group when there is one, and the sum is handed back on every shard's
device.

Departure from JAX: a ``jax.sharding.Mesh`` cannot name a device twice.
This one can, and lays its shards out round-robin over the devices it is
given, so that one card or one CPU holds a mesh of any size:
``make_mesh(8, devices=["cpu"])`` is 8 shards on the CPU, ``make_mesh(4)``
on a machine with one card is 4 shards on ``cuda:0``.  Shards that share a
device run one after another.

The dense-state helpers of the JAX module (``map_sharding``,
``image_sharding``, ``state_sharding``, ``frame_sharding``,
``shard_state``, ``shard_frame``, ``shard_frame_batch``: the surfel map's
rows and the images' rows split over the mesh) are not ported yet, nor
the named axes (``("map",)``, ``("host", "chip")``) that lay them out:
the landmark-sharded BA reads only the shard count.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def concrete_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The shards of one mesh.

    ``devices``: the device of each shard this process runs (a device may
    repeat).  ``group``: the process group of a multi-process mesh, or
    None; there, every process runs ``len(devices)`` shards and this one
    runs the shards ``first_shard .. first_shard + len(devices) - 1`` of
    the global order."""

    def __init__(self, devices, group=None):
        self.devices = tuple(concrete_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.n_ranks = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.n_ranks * len(self.devices)

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    def psum(self, parts):
        """Sum over the mesh.  ``parts``: one sequence of tensors per local
        shard, the same shapes in each.  The local shards' tensors are
        added in shard order on the first shard's device, the sum is
        all-reduced over the group (one flat buffer), and each shard gets
        the result on its own device: a list of tensor lists, one per
        local shard (shards on one device share the same tensors)."""
        if len(parts) != len(self.devices):
            raise ValueError(f"psum got {len(parts)} shards' parts, the mesh holds "
                             f"{len(self.devices)} here")
        home = self.devices[0]
        total = [x.to(home) for x in parts[0]]
        for shard in parts[1:]:
            total = [a + b.to(home) for a, b in zip(total, shard)]
        if self.group is not None:
            flat = torch.cat([x.reshape(-1) for x in total])
            dist.all_reduce(flat, group=self.group)
            sizes = [x.numel() for x in total]
            total = [y.view_as(x) for x, y in zip(total, flat.split(sizes))]
        on = {home: total}
        for dev in self.devices:
            if dev not in on:
                on[dev] = [x.to(dev) for x in total]
        return [on[dev] for dev in self.devices]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards laid out round-robin
    over ``devices`` (default: every visible CUDA device; raises when
    there is none).  Without ``n_devices``, one shard per device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    return Mesh([devices[i % len(devices)] for i in range(n)])
