"""Device mesh: ensemble- and edge-sharding for the consensus loop.

Counterpart of ``fastconsensus_tpu/parallel/sharding.py``.  The reference
lays a ``jax.sharding.Mesh`` over its devices and lets XLA's SPMD
partitioner place the work; the port is single-controller too (one host
thread drives every device), and places it explicitly:

* **ensemble axis "p"**: the ``n_p`` keys and labels split into P
  contiguous blocks, block i on ``mesh.devices[i][0]``, where its members
  detect against a whole (replicated) slab;
* **edge axis "e"**: the slab's capacity splits into E contiguous chunks,
  chunk s (slots ``[s * cap_l, (s + 1) * cap_l)``) on
  ``mesh.devices[0][s]``; the consensus tail runs edge-locally over the
  chunks (``ops/sharded_tail.py``), and what crosses devices goes
  through ``parallel/collectives.py``.

A mesh may list one device more than once, as the reference's tests force
8 CPU devices: on one card the chunks and blocks then share it, and every
collective's copy is a no-op.

The reference's ``keys_sharding``/``labels_sharding``/``slab_sharding``
(``NamedSharding`` builders) and ``put_keys``/``constrain_keys``/
``_key_data_sharding`` (workarounds for JAX's typed PRNG keys) have no
counterpart: the layout is the :class:`Mesh` and the ``shard_*``
functions below, and a key here is a plain ``[.., 2]`` tensor.  Its
``initialize_multihost`` (a mesh across processes and hosts) is not
ported: it needs ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from fastconsensus_tpu_torch.graph import GraphSlab, grow_slab
from fastconsensus_tpu_torch.parallel import collectives as coll

ENSEMBLE_AXIS = "p"
EDGE_AXIS = "e"

Labels = Union[torch.Tensor, Sequence[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(p, e)`` grid of torch devices (rows: ensemble shards)."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {ENSEMBLE_AXIS: len(self.devices),
                EDGE_AXIS: len(self.devices[0])}

    def ensemble_devices(self) -> List[torch.device]:
        """Where each ensemble shard's keys, labels and detection live."""
        return [row[0] for row in self.devices]

    def edge_devices(self) -> List[torch.device]:
        """Where each edge chunk of a sharded slab lives."""
        return list(self.devices[0])


def make_mesh(ensemble: Optional[int] = None, edge: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (ensemble, edge) mesh over ``devices`` (default: every
    CUDA device; without CUDA and without ``devices`` this raises, it
    never falls back to the CPU).  ``ensemble=None`` takes every device
    not claimed by the edge axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available; pass devices= (e.g. "
                "[torch.device('cpu')] * 8) for a mesh on other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if ensemble is None:
        if n % edge:
            raise ValueError(f"{n} devices not divisible by edge={edge}")
        ensemble = n // edge
    if ensemble * edge > n:
        raise ValueError(
            f"mesh {ensemble}x{edge} needs {ensemble * edge} devices, "
            f"have {n}")
    return Mesh(tuple(tuple(devices[i * edge:(i + 1) * edge])
                      for i in range(ensemble)))


def pad_n_p(n_p: int, mesh: Mesh) -> int:
    """Round n_p up to a multiple of the ensemble axis size."""
    p = mesh.shape[ENSEMBLE_AXIS]
    return math.ceil(n_p / p) * p


@dataclasses.dataclass(frozen=True)
class ShardedSlab:
    """A slab split along its capacity over a mesh's edge axis.

    ``chunks[s]`` is a :class:`GraphSlab` of the slots ``[s * cap_l,
    (s + 1) * cap_l)`` on ``mesh.edge_devices()[s]``; each carries the
    global statics (``n_nodes``, ``d_cap``, ``cap_hint``, ``d_hyb``,
    ``hub_cap``, ``agg_cap``), which this object exposes as a slab does,
    so the sizing rules read them unchanged.  ``capacity`` is the global
    one."""

    chunks: Tuple[GraphSlab, ...]
    mesh: Mesh

    n_nodes = property(lambda self: self.chunks[0].n_nodes)
    d_cap = property(lambda self: self.chunks[0].d_cap)
    cap_hint = property(lambda self: self.chunks[0].cap_hint)
    d_hyb = property(lambda self: self.chunks[0].d_hyb)
    hub_cap = property(lambda self: self.chunks[0].hub_cap)
    agg_cap = property(lambda self: self.chunks[0].agg_cap)

    @property
    def capacity(self) -> int:
        return sum(c.capacity for c in self.chunks)

    @property
    def device(self) -> torch.device:
        return self.chunks[0].device

    def num_alive(self) -> torch.Tensor:
        return coll.psum([c.num_alive() for c in self.chunks])[0]

    def degrees(self) -> torch.Tensor:
        return coll.psum([c.degrees() for c in self.chunks])[0]

    def with_statics(self, **statics) -> "ShardedSlab":
        return ShardedSlab(tuple(c.with_statics(**statics)
                                 for c in self.chunks), self.mesh)


def shard_slab(slab: GraphSlab, mesh: Mesh) -> ShardedSlab:
    """Place a slab on the mesh: pad the capacity to a multiple of the
    edge axis with dead tail slots (``graph.grow_slab``, which changes no
    result), then split every field into contiguous chunks."""
    e = mesh.shape[EDGE_AXIS]
    slab = grow_slab(slab, math.ceil(slab.capacity / e) * e)
    cap_l = slab.capacity // e
    chunks = []
    for s, dev in enumerate(mesh.edge_devices()):
        part = slice(s * cap_l, (s + 1) * cap_l)
        chunks.append(dataclasses.replace(
            slab, src=slab.src[part].to(dev), dst=slab.dst[part].to(dev),
            weight=slab.weight[part].to(dev),
            alive=slab.alive[part].to(dev)))
    return ShardedSlab(tuple(chunks), mesh)


def gather_slab(sharded: ShardedSlab) -> GraphSlab:
    """The inverse of :func:`shard_slab`: one slab on the first chunk's
    device (the chunk itself when the edge axis has one shard)."""
    if len(sharded.chunks) == 1:
        return sharded.chunks[0]
    dev = sharded.device

    def cat(name):
        return torch.cat([getattr(c, name).to(dev) for c in sharded.chunks])

    return dataclasses.replace(sharded.chunks[0], src=cat("src"),
                               dst=cat("dst"), weight=cat("weight"),
                               alive=cat("alive"))


def replicate_slab(slab: Union[GraphSlab, ShardedSlab], mesh: Mesh
                   ) -> List[GraphSlab]:
    """The detection-side view: one whole slab per ensemble shard, on its
    device (the same tensors, not a copy, where the devices coincide)."""
    whole = gather_slab(slab) if isinstance(slab, ShardedSlab) else slab

    def put(dev):
        return dataclasses.replace(
            whole, src=whole.src.to(dev), dst=whole.dst.to(dev),
            weight=whole.weight.to(dev), alive=whole.alive.to(dev))

    return [put(dev) for dev in mesh.ensemble_devices()]


def shard_keys(keys: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Keys ``[n_p, 2]`` split along the ensemble axis, block i on its
    shard's device."""
    p = mesh.shape[ENSEMBLE_AXIS]
    if keys.shape[0] % p:
        raise ValueError(
            f"n_p={keys.shape[0]} not divisible by ensemble axis {p}; use "
            f"pad_n_p")
    return [k.to(dev) for k, dev in
            zip(keys.chunk(p), mesh.ensemble_devices())]


def shard_labels(labels: Labels, mesh: Mesh) -> List[torch.Tensor]:
    """Labels ``[n_p, N]`` split along the ensemble axis, as the keys
    are; per-shard blocks (a list) pass through."""
    if not isinstance(labels, torch.Tensor):
        return list(labels)
    return shard_keys(labels, mesh)


def gather_labels(labels: Labels) -> torch.Tensor:
    """Per-shard label blocks as one ``[n_p, N]`` tensor on the first
    block's device (a tensor passes through)."""
    if isinstance(labels, torch.Tensor):
        return labels
    if len(labels) == 1:
        return labels[0]
    dev = labels[0].device
    return torch.cat([b.to(dev) for b in labels])
