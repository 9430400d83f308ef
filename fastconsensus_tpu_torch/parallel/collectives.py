"""Collectives over one axis of a device mesh, on lists of per-shard
tensors.

The reference lets XLA's SPMD partitioner insert its collectives
(``jax.lax.psum``/``pmax``/``all_gather``/``axis_index`` inside
``shard_map``).  The port places its shards explicitly, so a collective
is a plain function: it takes the shards' tensors in shard order,
reduces them on the first shard's device (a peer copy,
``tensor.to(device)``, between distinct GPUs; nothing on one device) and
hands the result back to each shard's device.

A mesh that spans processes (``sharding.initialize_multihost``) passes
the axis as an :class:`Axis`: ``xs`` then holds only this process's
shards, in shard order, and may be empty.  Every process gathers every
shard's tensor over the default ``torch.distributed`` group
(:func:`gather_shards`) and runs the same fold on its home device, so
each process ends with the one-process result, bit for bit, floats
included.  Every process calls every collective, in the same order,
whether it holds shards of the axis or not.

The fold runs in shard order 0, 1, ... on every call.  Every reduction
the sharded tail relies on for bit parity is integer-valued or a max, so
that order changes nothing there; only float sums (the quality bundle's
agreement and modularity) depend on it, and gathering every shard before
folding keeps that order across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis whose shards live in several processes:
    ``owners[s]`` is the process that holds shard s, ``rank`` this
    process, ``home`` the device where this process folds (its first
    device)."""

    owners: Tuple[int, ...]
    rank: int
    home: torch.device

    @property
    def local(self) -> List[int]:
        """The global indices of this process's shards, in shard order."""
        return [s for s, o in enumerate(self.owners) if o == self.rank]


def gather_shards(xs: Sequence[torch.Tensor], axis: Optional[Axis]
                  ) -> List[torch.Tensor]:
    """Every shard's tensor along ``axis``, in shard order: ``xs`` itself
    on a one-process axis (``None``), else gathered from every process
    onto ``axis.home``.  The shards of one axis share a shape and dtype;
    where some process holds none, the shape travels first as an object.
    ``gloo`` carries host tensors, so device tensors cross it through
    the host."""
    if axis is None:
        return list(xs)
    import torch.distributed as dist

    world = dist.get_world_size()
    held = [axis.owners.count(r) for r in range(world)]
    if len(xs) != held[axis.rank]:
        raise ValueError(f"process {axis.rank} passed {len(xs)} shards; it "
                         f"holds {held[axis.rank]} of this axis")
    if min(held) == 0:
        metas = [None] * world
        dist.all_gather_object(
            metas, (tuple(xs[0].shape), xs[0].dtype) if xs else None)
        shape, dtype = next(m for m in metas if m is not None)
    else:
        shape, dtype = tuple(xs[0].shape), xs[0].dtype
    via = torch.device("cpu") if dist.get_backend() == "gloo" else axis.home
    buf = torch.zeros((max(held),) + shape, dtype=dtype, device=via)
    for i, x in enumerate(xs):
        buf[i] = x
    wire = buf.view(torch.uint8) if dtype == torch.bool else buf
    outs = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(outs, wire)
    if dtype == torch.bool:
        outs = [o.view(torch.bool) for o in outs]
    slot = [0] * world
    every = []
    for o in axis.owners:
        every.append(outs[o][slot[o]].to(axis.home))
        slot[o] += 1
    return every


def _fold(xs: Sequence[torch.Tensor],
          op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
          axis: Optional[Axis]) -> List[torch.Tensor]:
    every = gather_shards(xs, axis)
    acc = every[0]
    for x in every[1:]:
        acc = op(acc, x.to(acc.device))
    return [acc.to(x.device) for x in xs] or [acc]


def psum(xs: Sequence[torch.Tensor], axis: Optional[Axis] = None
         ) -> List[torch.Tensor]:
    """Sum over the shards; one copy per shard in ``xs``, on its device
    (one, on the axis's home device, where this process holds none)."""
    return _fold(xs, torch.add, axis)


def pmax(xs: Sequence[torch.Tensor], axis: Optional[Axis] = None
         ) -> List[torch.Tensor]:
    """Elementwise max over the shards; copies as :func:`psum`'s."""
    return _fold(xs, torch.maximum, axis)


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False,
               axis: Optional[Axis] = None) -> List[torch.Tensor]:
    """The shards' tensors stacked along a new leading axis, or with
    ``tiled`` concatenated along axis 0; copies as :func:`psum`'s."""
    every = gather_shards(xs, axis)
    dev = every[0].device
    parts = [x.to(dev) for x in every]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return [out.to(x.device) for x in xs] or [out]


def axis_index(xs: Sequence, axis: Optional[Axis] = None) -> List[int]:
    """Each shard's index along the axis ``xs`` spans, in shard order
    (inside ``shard_map`` the reference asks each device for its own);
    across processes, the global indices of this process's shards."""
    return list(range(len(xs))) if axis is None else axis.local
