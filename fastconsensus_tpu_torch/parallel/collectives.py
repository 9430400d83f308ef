"""Collectives over one axis of a device mesh, on lists of per-shard
tensors.

The reference lets XLA's SPMD partitioner insert its collectives
(``jax.lax.psum``/``pmax``/``all_gather``/``axis_index`` inside
``shard_map``).  The port drives every shard from one host thread, so a
collective is a plain function: it takes the shards' tensors in shard
order, reduces them on the first shard's device (a peer copy,
``tensor.to(device)``, between distinct GPUs; nothing on one device) and
hands the result back to each shard's device.

The fold runs in shard order 0, 1, ... on every call.  Every reduction
the sharded tail relies on for bit parity is integer-valued or a max, so
that order changes nothing there; only float sums (the quality bundle's
agreement and modularity) depend on it.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def _fold(xs: Sequence[torch.Tensor],
          op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
          ) -> List[torch.Tensor]:
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device))
    return [acc.to(x.device) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over the shards; one copy per shard, on its device."""
    return _fold(xs, torch.add)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise max over the shards; one copy per shard."""
    return _fold(xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False
               ) -> List[torch.Tensor]:
    """The shards' tensors stacked along a new leading axis, or with
    ``tiled`` concatenated along axis 0; one copy per shard."""
    dev = xs[0].device
    parts = [x.to(dev) for x in xs]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return [out.to(x.device) for x in xs]


def axis_index(xs: Sequence) -> List[int]:
    """Each shard's index along the axis ``xs`` spans, in shard order
    (inside ``shard_map`` the reference asks each device for its own)."""
    return list(range(len(xs)))
