"""A mesh of shards, its collectives, and the row-sharded dense state (port
of ``hrbffusion3d_tpu/parallel/sharding.py``).

PyTorch has no single-controller mesh, so the port defines a small one.
A ``Mesh`` holds the shards this process runs, one device each, and, when
several processes share the work, the ``torch.distributed`` process group
that joins them (every process runs as many shards).  Its collectives take
one part per local shard and hand each local shard the result on its own
device; the local parts are combined in shard order on the first shard's
device, then over the group when there is one:
  ``psum``            sum (the landmark-sharded BA's reduced systems, the
                      dense step's Gram matrices);
  ``all_gather``      rows, concatenated in shard order;
  ``pmin``            elementwise minimum (exact in any order);
  ``exclusive_scan``  per-shard integer counts -> each shard's offset (the
                      sum of the counts of the shards before it) and the
                      total.

Departure from JAX: a ``jax.sharding.Mesh`` cannot name a device twice.
This one can, and lays its shards out round-robin over the devices it is
given, so that one card or one CPU holds a mesh of any size:
``make_mesh(8, devices=["cpu"])`` is 8 shards on the CPU, ``make_mesh(4)``
on a machine with one card is 4 shards on ``cuda:0``.  Shards that share a
device run one after another.

The dense state (JAX's ``state_sharding``): the surfel map's rows (the
capacity axis) and the rows of every image-shaped field (``prev_intensity``
and the ``pred_*`` maps) are split over the mesh's ``"map"`` axis as
``ShardedRows`` (one tensor per local shard, on its device); the pose, the
map's count, ``active_submaps`` and the tracking scalars are replicated,
held once on the mesh's first device (a shard on another device reads a
copy); ``time`` and ``submap_idx`` are host ints.  Frames are split by
rows, a frame batch by rows along axis 1 with the time axis whole.  Map
rows split evenly (the first shards take one more row when the capacity
does not divide), so the live prefix sits on the first shards, as GSPMD
places it.  Image rows split in units of ``row_unit`` rows (2^(levels-1)
of the config's pyramid, so that every level splits whole; the last shard
takes the rows that do not fill a unit).  ``gather_state`` brings a sharded state back
whole on the first device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import SLAMConfig
from ..map.surfel_map import SurfelMap
from ..pipeline.slam import FrameInput, SLAMState

ROWS, REPLICATED = "rows", "replicated"


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
    the global order.  ``axis_names`` / ``axis_sizes``: the named axes the
    shards are laid out on (default one axis, ``("map",)``), row-major over
    the global shard order."""

    def __init__(self, devices, group=None, axis_names=("map",), axis_sizes=None):
        self.devices = tuple(concrete_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.n_ranks = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.axis_names = tuple(axis_names)
        sizes = (self.size,) if axis_sizes is None else tuple(axis_sizes)
        if len(sizes) != len(self.axis_names) or _prod(sizes) != self.size:
            raise ValueError(f"axes {self.axis_names} of sizes {sizes} do not lay out "
                             f"{self.size} shards")
        self.axis_sizes = sizes

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.n_ranks * len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis name -> its size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def home(self) -> torch.device:
        """The first local shard's device: where replicated values live."""
        return self.devices[0]

    def _check(self, name, parts):
        if len(parts) != len(self.devices):
            raise ValueError(f"{name} got {len(parts)} shards' parts, the mesh holds "
                             f"{len(self.devices)} here")

    def _spread(self, total):
        """``total`` (tensors on the first device) handed to every local
        shard on its own device (shards on one device share the tensors)."""
        on = {self.home: total}
        for dev in self.devices:
            if dev not in on:
                on[dev] = [x.to(dev) for x in total]
        return [on[dev] for dev in self.devices]

    def _reduce(self, parts, combine, op):
        home = self.home
        total = [x.to(home) for x in parts[0]]
        for shard in parts[1:]:
            total = [combine(a, b.to(home)) for a, b in zip(total, shard)]
        if self.group is not None:
            flat = torch.cat([x.reshape(-1) for x in total])
            dist.all_reduce(flat, op=op, group=self.group)
            sizes = [x.numel() for x in total]
            total = [y.view_as(x) for x, y in zip(total, flat.split(sizes))]
        return self._spread(total)

    def psum(self, parts):
        """Sum over the mesh.  ``parts``: one sequence of tensors per local
        shard, the same shapes in each.  The local shards' tensors are
        added in shard order on the first shard's device, the sum is
        all-reduced over the group (one flat buffer), and each shard gets
        the result on its own device: a list of tensor lists, one per
        local shard."""
        self._check("psum", parts)
        return self._reduce(parts, torch.add, dist.ReduceOp.SUM)

    def pmin(self, parts):
        """Elementwise minimum over the mesh, laid out as ``psum``'s (the
        minimum is exact, so the order does not change it)."""
        self._check("pmin", parts)
        return self._reduce(parts, torch.minimum, dist.ReduceOp.MIN)

    def all_gather(self, parts, dim: int = 0):
        """``parts`` (one tensor per local shard, equal but along ``dim``)
        concatenated along ``dim`` in global shard order; every local shard
        gets the whole on its own device.  Over a group the per-process
        lengths are exchanged first (a host read) and the blocks padded to
        the longest."""
        self._check("all_gather", parts)
        home = self.home
        local = torch.cat([x.to(home) for x in parts], dim=dim)
        if self.group is not None:
            n = torch.tensor([local.shape[dim]], dtype=torch.int64, device=home)
            ns = [torch.empty_like(n) for _ in range(self.n_ranks)]
            dist.all_gather(ns, n, group=self.group)
            lens = [int(x) for x in ns]
            pad = list(local.shape)
            pad[dim] = max(lens) - local.shape[dim]
            padded = torch.cat([local, local.new_zeros(pad)], dim=dim)
            blocks = [torch.empty_like(padded) for _ in range(self.n_ranks)]
            dist.all_gather(blocks, padded.contiguous(), group=self.group)
            local = torch.cat([b.narrow(dim, 0, k) for b, k in zip(blocks, lens)], dim=dim)
        return [t[0] for t in self._spread([local])]

    def exclusive_scan(self, counts):
        """``counts``: one integer tensor per local shard (equal shapes).
        Returns (offsets, total): per local shard, on its device, the
        elementwise sum of the counts of every shard before it in the
        global order, and the sum over all shards."""
        self._check("exclusive_scan", counts)
        home = self.home
        run = torch.zeros_like(counts[0], device=home)
        offs = []
        for c in counts:
            offs.append(run)
            run = run + c.to(home)
        if self.group is not None:
            blocks = [torch.empty_like(run) for _ in range(self.n_ranks)]
            dist.all_gather(blocks, run.contiguous(), group=self.group)
            before = sum(blocks[:self.rank], torch.zeros_like(run))
            offs = [o + before for o in offs]
            run = sum(blocks[1:], blocks[0].clone())
        return ([o.to(d) for o, d in zip(offs, self.devices)],
                [t[0] for t in self._spread([run])])


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards on the axis ``("map",)``, laid out
    round-robin over ``devices`` (default: every visible CUDA device;
    raises when there is none).  Without ``n_devices``, one shard per
    device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n_devices is None else n_devices
    return Mesh([devices[i % len(devices)] for i in range(n)])


# --------------------------------------------------------------------------- #
# sharded rows
# --------------------------------------------------------------------------- #

def row_bounds(n_rows: int, n_shards: int, unit: int = 1) -> list[tuple[int, int]]:
    """Global row range of each of ``n_shards`` shards: whole units of
    ``unit`` rows split as evenly as they go (the first shards one more),
    the rows that fill no unit to the last shard.  Raises when a shard
    would be empty."""
    units = n_rows // unit
    if units < n_shards:
        raise ValueError(f"{n_rows} rows in units of {unit} cannot be split over "
                         f"{n_shards} shards")
    base, extra = divmod(units, n_shards)
    out, lo = [], 0
    for k in range(n_shards):
        hi = lo + (base + (k < extra)) * unit
        out.append((lo, hi))
        lo = hi
    out[-1] = (out[-1][0], n_rows)
    return out


class ShardedRows:
    """A tensor split by rows over a mesh: ``parts[i]`` is the local shard
    i's block, the global rows ``bounds[i]`` along ``axis``, on the shard's
    device; ``total`` is the global row count.  ``axis`` 1 (a frame batch)
    indexes along its leading axis like a tensor (``x[i]``, ``x[i:j]``)."""

    __slots__ = ("parts", "bounds", "total", "mesh", "axis")

    def __init__(self, parts, bounds, total: int, mesh: Mesh, axis: int = 0):
        self.parts = tuple(parts)
        self.bounds = tuple(bounds)
        self.total = total
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh, unit: int = 1, axis: int = 0):
        """``x``'s rows along ``axis`` split over ``mesh``: this process's
        shards' blocks, each a copy on its shard's device."""
        bounds = row_bounds(x.shape[axis], mesh.size, unit)
        mine = bounds[mesh.first_shard:mesh.first_shard + len(mesh.devices)]
        parts = [x.narrow(axis, lo, hi - lo).to(dev, copy=True).contiguous()
                 for (lo, hi), dev in zip(mine, mesh.devices)]
        return cls(parts, mine, x.shape[axis], mesh, axis)

    def like(self, parts, axis: int | None = None):
        """Other parts with this layout."""
        return ShardedRows(parts, self.bounds, self.total, self.mesh,
                           self.axis if axis is None else axis)

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.axis] = self.total
        return tuple(s)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        return self.mesh.all_gather(list(self.parts), dim=self.axis)[0]

    def __getitem__(self, idx):
        if self.axis == 0:
            raise TypeError("index the rows of a sharded tensor through its parts")
        return self.like([p[idx] for p in self.parts],
                         self.axis if isinstance(idx, slice) else self.axis - 1)


def is_sharded(x) -> bool:
    """Whether ``x`` (a state, a frame or a tensor) is split over a mesh."""
    if isinstance(x, SLAMState):
        x = x.map.data
    elif isinstance(x, FrameInput):
        x = x.depth
    return isinstance(x, ShardedRows)


def row_unit(levels: int) -> int:
    """Image rows per unit of the split for a pyramid of ``levels``."""
    return 1 << max(levels - 1, 0)


# --------------------------------------------------------------------------- #
# placements (JAX's NamedSharding pytrees)
# --------------------------------------------------------------------------- #

def map_sharding(mesh: Mesh) -> SurfelMap:
    """Placement of each SurfelMap field: the capacity axis split."""
    _check_axis(mesh)
    return SurfelMap(data=ROWS, count=REPLICATED)


def image_sharding(mesh: Mesh) -> str:
    """Rows of (H, W[, C]) image maps split over ``"map"``."""
    _check_axis(mesh)
    return ROWS


def state_sharding(mesh: Mesh) -> SLAMState:
    img, rep = image_sharding(mesh), REPLICATED
    return SLAMState(
        map=map_sharding(mesh), R=rep, t=rep, time=rep, submap_idx=rep,
        prev_intensity=img, pred_vertex=img, pred_normal=img, pred_intensity=img,
        pred_icp_weight=img, pred_k1=img, pred_k2=img,
        active_submaps=rep, last_icp_error=rep, last_icp_count=rep, dense_frac=rep)


def frame_sharding(mesh: Mesh) -> FrameInput:
    img = image_sharding(mesh)
    return FrameInput(depth=img, rgb=img)


def _check_axis(mesh: Mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh, not {type(mesh).__name__}")
    if "map" not in mesh.axis_names:
        raise ValueError(f"the dense state splits over a mesh axis named 'map'; this mesh's "
                         f"axes are {mesh.axis_names}")


def _place(x, how: str, mesh: Mesh, unit: int):
    if how == ROWS:
        return ShardedRows.split(x, mesh, unit=unit)
    if isinstance(x, torch.Tensor):
        return x.to(mesh.home)
    return x


def shard_state(state: SLAMState, mesh: Mesh, cfg: SLAMConfig) -> SLAMState:
    """``state`` laid out as ``state_sharding(mesh)`` says (map rows
    evenly, image rows in units of ``row_unit`` of ``cfg``'s pyramid)."""
    if is_sharded(state):
        raise ValueError("the state is sharded already")
    spec = state_sharding(mesh)
    unit = row_unit(cfg.num_pyramid_levels)
    fields = {}
    for name, how in zip(SLAMState._fields, spec):
        x = getattr(state, name)
        if name == "map":
            x = SurfelMap(ShardedRows.split(x.data, mesh), x.count.to(mesh.home))
        else:
            x = _place(x, how, mesh, unit)
        fields[name] = x
    return SLAMState(**fields)


def shard_frame(frame: FrameInput, mesh: Mesh, cfg: SLAMConfig) -> FrameInput:
    """``frame``'s image rows split as ``shard_state`` splits the state's."""
    frame_sharding(mesh)
    unit = row_unit(cfg.num_pyramid_levels)
    return FrameInput(*(ShardedRows.split(x, mesh, unit=unit) for x in frame))


def shard_frame_batch(frames: FrameInput, mesh: Mesh, cfg: SLAMConfig) -> FrameInput:
    """Stacked (N, H, W[, C]) frame batches: the image rows (axis 1) split
    as ``shard_frame`` splits them, the time axis whole (the step consumes
    it in order)."""
    frame_sharding(mesh)
    unit = row_unit(cfg.num_pyramid_levels)
    return FrameInput(*(ShardedRows.split(x, mesh, unit=unit, axis=1) for x in frames))


def gather(x):
    """A sharded tensor brought whole onto its mesh's first device; anything
    else as it is."""
    return x.gather() if isinstance(x, ShardedRows) else x


def gather_state(state: SLAMState) -> SLAMState:
    """A sharded state whole on the mesh's first device (for comparisons,
    checkpoints, poses and exports); an unsharded state as it is."""
    if not is_sharded(state):
        return state
    return state._replace(map=SurfelMap(gather(state.map.data), state.map.count),
                          **{f: gather(getattr(state, f)) for f in SLAMState._fields
                             if f not in ("map",)})


def gather_frame(frame: FrameInput) -> FrameInput:
    return FrameInput(*(gather(x) for x in frame))
