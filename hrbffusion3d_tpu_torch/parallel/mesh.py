"""A mesh of shards and its collectives (the part of
``parallel/sharding.py`` that knows nothing of the SLAM state, so that the
tracker can run on a mesh of one shard without importing the pipeline).

PyTorch has no single-controller mesh, so the port defines a small one.
A ``Mesh`` holds the shards this process runs, one device each, and, when
several processes share the work, the ``torch.distributed`` process group
that joins them (every process runs as many shards).  Its collectives take
one part per local shard and hand each local shard the result on its own
device:
  ``psum``            sum (the landmark-sharded BA's reduced systems, the
                      dense step's Gram matrices), added left to right in
                      the global shard order on the first shard's device:
                      over a group every shard's parts are all-gathered
                      first, so that a group of processes adds exactly as
                      one process with the same shards does;
  ``all_gather``      rows, concatenated in shard order;
  ``pmin``            elementwise minimum (exact in any order: the local
                      parts are combined first, then all-reduced over the
                      group);
  ``exclusive_scan``  per-shard integer counts -> each shard's offset (the
                      sum of the counts of the shards before it) and the
                      total;
and three exchanges of row-split tensors (``bounds``: every shard's global
row range, in the global shard order):
  ``slabs``           each local shard's rows with a halo above and below,
                      cut from every shard they span: within a process a
                      direct read, over a group the edge rows that other
                      processes need, exchanged with one ``all_gather``
                      whose sizes every process computes alike;
  ``gather_rows``     rows read by global id, each from the shard that owns
                      it: over a group the ids are all-gathered, every
                      process answers for the rows it owns, and an
                      ``all_reduce`` with MAX over the rows' int32 bits
                      selects the owner's answer exactly;
  ``move_rows``       rows sent to new global positions (a compaction, a
                      new layout, new surfels written into the map): within
                      a process each shard's rows are scattered into the
                      shards that own their positions, over a group every
                      row goes only to the process that owns its position
                      (one ``all_to_all``, whose split sizes are read to
                      the host).
Over a group ``sent_bytes`` counts the bytes this process put into the
collectives, ``received_rows`` the rows that ``move_rows`` brought it
from other processes and ``host_reads`` the device reads its collectives
made (one per ``move_rows``: the ``all_to_all``'s split sizes).  Lengths
that every process knows on the host (``all_gather``'s,
``gather_rows``') are exchanged as host integers, on the CPU over
``gloo`` (``host_ints``).  A failed collective raises; nothing falls back
to a gathered run.

Departure from JAX: a ``jax.sharding.Mesh`` cannot name a device twice.
This one can, and lays its shards out round-robin over the devices it is
given, so that one card or one CPU holds a mesh of any size:
``make_mesh(8, devices=["cpu"])`` is 8 shards on the CPU, ``make_mesh(4)``
on a machine with one card is 4 shards on ``cuda:0``.  Shards that share a
device run one after another.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.tensors import const

_INT_MIN = torch.iinfo(torch.int32).min


def concrete_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class On:
    """A replicated value's copy on each device (made once)."""

    def __init__(self, x):
        self.x = x
        self.copies = {x.device: x}

    def __call__(self, dev):
        if dev not in self.copies:
            self.copies[dev] = self.x.to(dev)
        return self.copies[dev]


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
        self.sent_bytes = 0
        self.received_rows = 0
        self.host_reads = 0

    def with_group(self, group) -> "Mesh":
        """The same shards and axes on another process group of the same
        processes (a second communicator, e.g. for a thread of its own:
        collectives of two threads must not share a group)."""
        if (group is None) != (self.group is None) or (
                group is not None and (dist.get_world_size(group) != self.n_ranks
                                       or dist.get_rank(group) != self.rank)):
            raise ValueError("the group must hold the mesh's processes in the same order")
        return Mesh(self.devices, group, self.axis_names, self.axis_sizes)

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

    def local(self, bounds):
        """This process's shards' entries of a global per-shard list."""
        return list(bounds[self.first_shard:self.first_shard + len(self.devices)])

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

    def _all_reduce(self, flat, op):
        self.sent_bytes += flat.numel() * flat.element_size()
        dist.all_reduce(flat, op=op, group=self.group)

    def _gather_ints(self, n: int) -> list:
        """Every process's host integer ``n``, in rank order (no device
        read over ``gloo``: ``host_ints``)."""
        return [int(b[0]) for b in self._all_gather(host_ints([n], self.group))]

    def _all_gather(self, x):
        """Every process's ``x`` (equal shapes), in rank order."""
        x = x.contiguous()
        self.sent_bytes += x.numel() * x.element_size()
        blocks = [torch.empty_like(x) for _ in range(self.n_ranks)]
        dist.all_gather(blocks, x, group=self.group)
        return blocks

    def _every_shard(self, parts):
        """Every shard's parts in the global shard order, on the first
        device: over a group one ``all_gather`` per dtype of a flat buffer
        holding this process's shards' parts, shard after shard."""
        home = self.home
        local = [[x.to(home) for x in shard] for shard in parts]
        if self.group is None:
            return local
        n = len(self.devices)
        every = [[None] * len(local[0]) for _ in range(self.size)]
        for dtype in dict.fromkeys(x.dtype for x in local[0]):
            at = [i for i, x in enumerate(local[0]) if x.dtype == dtype]
            flat = torch.cat([shard[i].reshape(-1) for shard in local for i in at])
            sizes = [local[0][i].numel() for i in at] * n
            for r, block in enumerate(self._all_gather(flat)):
                pieces = block.split(sizes)
                for k in range(n):
                    for j, i in enumerate(at):
                        every[r * n + k][i] = pieces[k * len(at) + j].view_as(local[0][i])
        return every

    def psum(self, parts):
        """Sum over the mesh.  ``parts``: one sequence of tensors per local
        shard, the same shapes in each.  Every shard's tensors (over a
        group all-gathered, one flat buffer per dtype) are added left to
        right in the global shard order on the first shard's device, so
        the sum rounds as it does on one process with the same shards, and
        each local shard gets the result on its own device: a list of
        tensor lists, one per local shard."""
        self._check("psum", parts)
        every = self._every_shard(parts)
        total = every[0]
        for shard in every[1:]:
            total = [a + b for a, b in zip(total, shard)]
        return self._spread(total)

    def pmin(self, parts):
        """Elementwise minimum over the mesh, laid out as ``psum``'s (the
        minimum is exact, so the order does not change it: the local
        shards' parts are combined first, then all-reduced over the group,
        one flat buffer per dtype)."""
        self._check("pmin", parts)
        home = self.home
        total = [x.to(home) for x in parts[0]]
        for shard in parts[1:]:
            total = [torch.minimum(a, b.to(home)) for a, b in zip(total, shard)]
        if self.group is not None:
            for dtype in dict.fromkeys(x.dtype for x in total):
                at = [i for i, x in enumerate(total) if x.dtype == dtype]
                flat = torch.cat([total[i].reshape(-1) for i in at])
                self._all_reduce(flat, dist.ReduceOp.MIN)
                for i, y in zip(at, flat.split([total[i].numel() for i in at])):
                    total[i] = y.view_as(total[i])
        return self._spread(total)

    def all_gather(self, parts, dim: int = 0):
        """``parts`` (one tensor per local shard, equal but along ``dim``)
        concatenated along ``dim`` in global shard order; every local shard
        gets the whole on its own device.  Over a group the per-process
        lengths are exchanged first and the blocks padded to the longest."""
        self._check("all_gather", parts)
        home = self.home
        local = torch.cat([x.to(home) for x in parts], dim=dim)
        if self.group is not None:
            lens = self._gather_ints(local.shape[dim])
            pad = list(local.shape)
            pad[dim] = max(lens) - local.shape[dim]
            blocks = self._all_gather(torch.cat([local, local.new_zeros(pad)], dim=dim))
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
            blocks = self._all_gather(run)
            before = sum(blocks[:self.rank], torch.zeros_like(run))
            offs = [o + before for o in offs]
            run = sum(blocks[1:], blocks[0].clone())
        return ([o.to(d) for o, d in zip(offs, self.devices)],
                [t[0] for t in self._spread([run])])

    # ------------------------------------------------------------------ #
    # exchanges of row-split tensors
    # ------------------------------------------------------------------ #

    def _block(self, bounds, r):
        """Global rows [A, B) of process r's shards."""
        n = len(self.devices)
        return bounds[r * n][0], bounds[(r + 1) * n - 1][1]

    def slabs(self, parts, bounds, total: int, lo: int, hi: int):
        """Per local shard k of rows [a, b): (the rows [a - lo, b + hi) of
        the whole clipped to [0, total), on its device; the first row's
        index).  ``parts``: the local shards' rows; ``bounds``: every
        shard's."""
        self._check("slabs", parts)
        mine = self.local(bounds)
        if self.group is None:
            return [(_cut(parts, mine, dev, max(a - lo, 0), min(b + hi, total)), max(a - lo, 0))
                    for (a, b), dev in zip(mine, self.devices)]
        blocks = [self._block(bounds, r) for r in range(self.n_ranks)]
        need = [(max(A - lo, 0), min(B + hi, total)) for A, B in blocks]
        # rows of each process that another one needs: a head (read by the
        # processes below) and a tail (read by those above)
        sends = []
        for r, (A, B) in enumerate(blocks):
            head_end = max([A] + [need[q][1] for q in range(r)])
            tail_start = min([B] + [need[q][0] for q in range(r + 1, self.n_ranks)])
            sends.append(((A, min(head_end, B)), (max(tail_start, A), B)))
        width = max(h1 - h0 + t1 - t0 for (h0, h1), (t0, t1) in sends)
        (h0, h1), (t0, t1) = sends[self.rank]
        home = self.home
        A, B = blocks[self.rank]
        own = _cut(parts, mine, home, A, B)
        buf = torch.cat([own[h0 - A:h1 - A], own[t0 - A:t1 - A]])
        pad = own.new_zeros((width - buf.shape[0],) + tuple(own.shape[1:]))
        got = self._all_gather(_bits(torch.cat([buf, pad])))
        got = [_unbits(g, own.dtype) for g in got]
        n0, n1 = need[self.rank]
        pieces = []
        for q in list(range(self.rank)) + [None] + list(range(self.rank + 1, self.n_ranks)):
            if q is None:
                pieces.append(own)
                continue
            (qh0, qh1), (qt0, qt1) = sends[q]
            if q < self.rank:       # rows of [n0, A) from q's tail
                r0, r1 = max(n0, qt0), min(A, qt1)
                off = qh1 - qh0 + r0 - qt0
            else:                   # rows of [B, n1) from q's head
                r0, r1 = max(B, qh0), min(n1, qh1)
                off = r0 - qh0
            if r1 > r0:
                pieces.append(got[q][off:off + r1 - r0])
        ext = torch.cat(pieces)
        out = []
        for (a, b), dev in zip(mine, self.devices):
            s0, s1 = max(a - lo, 0), min(b + hi, total)
            out.append((ext[s0 - n0:s1 - n0].to(dev), s0))
        return out

    def gather_rows(self, parts, bounds, total: int, ids_list):
        """Per local shard, ``whole[clamp(ids, 0, total - 1)]`` on its ids'
        device: each row from the shard that owns it (an id owned by no
        shard takes global shard 0's clamped row).  ``parts``: the local
        shards' rows (float32 or int32); ``ids_list``: one id tensor per
        local shard."""
        self._check("gather_rows", ids_list)
        mine = self.local(bounds)
        if self.group is None:
            return [_owner_select(parts, mine, ids)[0] for ids in ids_list]
        home = self.home
        req = torch.cat([ids.reshape(-1).to(home, torch.int32) for ids in ids_list])
        lens = self._gather_ints(req.shape[0])
        padded = torch.cat([req, req.new_zeros(max(lens) - req.shape[0])])
        every = torch.cat([g[:k] for g, k in zip(self._all_gather(padded), lens)])
        ans, owned = _owner_select(parts, mine, every)
        if self.rank == 0:
            owned = owned | (every < 0) | (every >= total)
        bits = _bits(ans).reshape(ans.shape[0], -1)
        bits = torch.where(owned[:, None], bits, _INT_MIN).contiguous()
        self._all_reduce(bits, dist.ReduceOp.MAX)
        mine_rows = _unbits(bits, ans.dtype).reshape(ans.shape)
        out, at = [], sum(lens[:self.rank])
        for ids in ids_list:
            k = ids.numel()
            out.append(mine_rows[at:at + k].reshape(ids.shape + ans.shape[1:]).to(ids.device))
            at += k
        return out

    def move_rows(self, parts, pos, bounds, into):
        """Rows sent to new global positions: row i of local shard k's
        ``parts[k]`` (4-byte rows) goes to the global row ``pos[k][i]`` of
        the layout ``bounds`` (every shard's rows; nowhere where the
        position is negative).  ``into``: the local shards' rows of that
        layout before the move.  Returns them, per local shard on its
        device, with every row that arrived written at its position (a
        position should get at most one).  Within a process each new shard
        scatters the rows of every local shard that land in it; over a
        group each process first sends every row only to the process that
        owns its position (one ``all_to_all``, after one of the counts), so
        no process receives a row that it does not keep."""
        self._check("move_rows", parts)
        if self.group is not None:
            parts, pos = self._send_to_owners(parts, pos, bounds)
        out = []
        for base, (lo, hi) in zip(into, self.local(bounds)):
            dev = base.device
            # one more row takes the rows that land elsewhere
            buf = torch.cat([base, base.new_empty((1,) + tuple(base.shape[1:]))])
            for part, p in zip(parts, pos):
                p = p.to(dev)
                at = torch.where((p >= lo) & (p < hi), p - lo, hi - lo)
                buf.index_copy_(0, at.long(), part.to(dev))
            out.append(buf[:hi - lo])
        return out

    def _send_to_owners(self, parts, pos, bounds):
        """([the rows that other processes and this one send here], [their
        positions]) on the first device: each row of the local ``parts``
        sent to the process whose block of ``bounds`` holds its position."""
        home = self.home
        rows = torch.cat([p.to(home) for p in parts])
        at = torch.cat([p.to(home, torch.int32) for p in pos])
        ends = const([self._block(bounds, r)[1] for r in range(self.n_ranks)], home,
                     torch.int32)
        dest = torch.where(at < 0, self.n_ranks, torch.searchsorted(ends, at, right=True))
        # (bincount would read its maximum back to the host)
        counts = torch.zeros(self.n_ranks + 1, dtype=torch.int64, device=home).index_add_(
            0, dest, torch.ones_like(dest))[:self.n_ranks]
        got_counts = torch.empty_like(counts)
        self.sent_bytes += counts.numel() * counts.element_size()
        dist.all_to_all_single(got_counts, counts, group=self.group)
        # the split sizes: the one host read of a move over a group
        self.host_reads += 1
        send, recv = torch.stack([counts, got_counts]).tolist()
        order = torch.argsort(dest, stable=True)[:sum(send)]
        payload = torch.cat([_bits(rows).reshape(rows.shape[0], -1), at[:, None]], dim=1)[order]
        got = payload.new_empty((sum(recv), payload.shape[1]))
        self.sent_bytes += (sum(send) - send[self.rank]) * payload.shape[1] * 4
        dist.all_to_all_single(got, payload, recv, send, group=self.group)
        self.received_rows += sum(recv) - recv[self.rank]
        moved = _unbits(got[:, :-1].contiguous(), rows.dtype).reshape((-1,) + rows.shape[1:])
        return [moved], [got[:, -1]]


def host_ints(values, group) -> torch.Tensor:
    """Host integers as an int64 tensor where ``group``'s backend takes it:
    on the CPU over ``gloo`` (so reading the result back reads no device),
    on this process's card over ``nccl``."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return torch.tensor(values, dtype=torch.int64, device=dev)


def _cut(parts, mine, dev, lo: int, hi: int):
    """Rows [lo, hi) taken from the local parts that hold them, on ``dev``."""
    pieces = [p[max(lo, a) - a:min(hi, b) - a].to(dev)
              for p, (a, b) in zip(parts, mine) if a < hi and b > lo]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _owner_select(parts, mine, ids):
    """(rows of ``ids`` from the local parts that own them, an id owned by
    none taking the first part's clamped row; whether a local part owns
    each id)."""
    dev = ids.device
    out, owned = None, torch.zeros(ids.shape, dtype=torch.bool, device=dev)
    for part, (lo, hi) in zip(parts, mine):
        if hi == lo:
            continue
        local = ids.to(part.device)
        got = part[torch.clamp(local - lo, 0, hi - lo - 1).long()].to(dev)
        own = (ids >= lo) & (ids < hi)
        if out is None:
            out = got
        else:
            out = torch.where(own.reshape(ids.shape + (1,) * (got.dim() - ids.dim())), got, out)
        owned = owned | own
    return out, owned


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte tensor's bits as int32 (bool as int32 0 / 1)."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.element_size() != 4:
        raise TypeError(f"exchanged rows must be 4-byte or bool, not {x.dtype}")
    return x.contiguous().view(torch.int32)


def _unbits(x: torch.Tensor, dtype) -> torch.Tensor:
    return x != 0 if dtype == torch.bool else x.view(dtype)


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
