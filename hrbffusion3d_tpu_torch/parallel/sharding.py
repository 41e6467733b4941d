"""The row-sharded dense state (port of
``hrbffusion3d_tpu/parallel/sharding.py``) on a ``Mesh`` of shards
(``parallel/mesh.py``, re-exported here with ``make_mesh``: its
collectives ``psum``, ``pmin``, ``all_gather``, ``exclusive_scan``, its
halo exchange ``slabs``, its owner merge ``gather_rows`` and its row move
``move_rows``, within one process or over a ``torch.distributed`` group).

The dense state (JAX's ``state_sharding``): the surfel map's rows (the
capacity axis) and the rows of every image-shaped field (``prev_intensity``
and the ``pred_*`` maps) are split over the mesh's ``"map"`` axis (or both
axes of the two-level ``("host", "chip")`` mesh, in its global shard
order) as ``ShardedRows`` (one tensor per local shard, on its device, with
every shard's row bounds); the pose, the map's count, ``active_submaps``
and the tracking scalars are replicated, held once on the mesh's first
device (a shard on another device reads a copy); ``time`` and
``submap_idx`` are host ints.  Frames are split by rows, a frame batch by
rows along axis 1 with the time axis whole.  Map rows split evenly (the
first shards take one more row when the capacity does not divide), so the
live prefix sits on the first shards, as GSPMD places it.  Image rows
split in units of ``row_unit`` rows (2^(levels-1) of the config's pyramid,
so that every level splits whole; the last shard takes the rows that do
not fill a unit).  Over a process group every process keeps only its own
shards.  ``gather_state`` brings a sharded state back whole on the first
device (of every process).
"""

from __future__ import annotations

import torch

from ..config import SLAMConfig
from ..map.surfel_map import SurfelMap
from ..pipeline.slam import FrameInput, SLAMState
from .mesh import Mesh, concrete_device, make_mesh, row_bounds  # noqa: F401 (re-exported)

ROWS, REPLICATED = "rows", "replicated"


# --------------------------------------------------------------------------- #
# sharded rows
# --------------------------------------------------------------------------- #

class ShardedRows:
    """A tensor split by rows over a mesh: ``parts[i]`` is the local shard
    i's block, the global rows ``bounds[i]`` along ``axis``, on the shard's
    device; ``total`` is the global row count; ``all_bounds`` every shard's
    rows in the global order (this process's ``bounds`` among them; on a
    mesh of one process they are ``bounds``).  ``axis`` 1 (a frame batch)
    indexes along its leading axis like a tensor (``x[i]``, ``x[i:j]``)."""

    __slots__ = ("parts", "bounds", "total", "mesh", "axis", "all_bounds")

    def __init__(self, parts, bounds, total: int, mesh: Mesh, axis: int = 0,
                 all_bounds=None):
        self.parts = tuple(parts)
        self.bounds = tuple(bounds)
        self.total = total
        self.mesh = mesh
        self.axis = axis
        if all_bounds is None:
            if mesh.group is not None:
                raise ValueError("rows split over a process group need every shard's bounds")
            all_bounds = self.bounds
        self.all_bounds = tuple(all_bounds)

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh, unit: int = 1, axis: int = 0):
        """``x``'s rows along ``axis`` split over ``mesh``: this process's
        shards' blocks, each a copy on its shard's device."""
        bounds = row_bounds(x.shape[axis], mesh.size, unit)
        mine = mesh.local(bounds)
        parts = [x.narrow(axis, lo, hi - lo).to(dev, copy=True).contiguous()
                 for (lo, hi), dev in zip(mine, mesh.devices)]
        return cls(parts, mine, x.shape[axis], mesh, axis, bounds)

    def like(self, parts, axis: int | None = None):
        """Other parts with this layout."""
        return ShardedRows(parts, self.bounds, self.total, self.mesh,
                           self.axis if axis is None else axis, self.all_bounds)

    def slabs(self, lo: int, hi: int):
        """Per local shard: (its rows with ``lo`` rows above and ``hi``
        below, clipped to the whole, on its device; the first row's
        index): ``Mesh.slabs``."""
        return self.mesh.slabs(self.parts, self.all_bounds, self.total, lo, hi)

    def gather_rows(self, ids_list):
        """Per local shard, the rows of its ids, each from the shard that
        owns it: ``Mesh.gather_rows``."""
        return self.mesh.gather_rows(self.parts, self.all_bounds, self.total, ids_list)

    def move_rows(self, pos, into: "ShardedRows") -> "ShardedRows":
        """``into`` with each local shard's rows written at their new
        global positions ``pos`` of its layout: ``Mesh.move_rows``."""
        return into.like(self.mesh.move_rows(self.parts, pos, into.all_bounds, into.parts))

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
    _check_axis(mesh)
    return _state_spec()


def _state_spec() -> SLAMState:
    img, rep = ROWS, REPLICATED
    return SLAMState(
        map=SurfelMap(data=ROWS, count=REPLICATED), R=rep, t=rep, time=rep, submap_idx=rep,
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


def _check_rows(mesh: Mesh) -> None:
    """The dense state's rows split over the axis ``"map"``, or over both
    axes of the two-level ``("host", "chip")`` mesh in its global shard
    order (JAX's ``P(("host", "chip"))``; ``state_sharding`` stays
    ``P("map")``)."""
    if isinstance(mesh, Mesh) and mesh.axis_names == ("host", "chip"):
        return
    _check_axis(mesh)


def _place(x, how: str, mesh: Mesh, unit: int):
    if how == ROWS:
        return ShardedRows.split(x, mesh, unit=unit)
    if isinstance(x, torch.Tensor):
        return x.to(mesh.home)
    return x


def shard_state(state: SLAMState, mesh: Mesh, cfg: SLAMConfig) -> SLAMState:
    """``state`` laid out as ``state_sharding(mesh)`` says (map rows
    evenly, image rows in units of ``row_unit`` of ``cfg``'s pyramid; on a
    two-level mesh over both of its axes).  Over a process group every
    process passes the whole state and keeps its own shards."""
    if is_sharded(state):
        raise ValueError("the state is sharded already")
    _check_rows(mesh)
    spec = _state_spec()
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
    _check_rows(mesh)
    unit = row_unit(cfg.num_pyramid_levels)
    return FrameInput(*(ShardedRows.split(x, mesh, unit=unit) for x in frame))


def shard_frame_batch(frames: FrameInput, mesh: Mesh, cfg: SLAMConfig) -> FrameInput:
    """Stacked (N, H, W[, C]) frame batches: the image rows (axis 1) split
    as ``shard_frame`` splits them, the time axis whole (the step consumes
    it in order)."""
    _check_rows(mesh)
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
