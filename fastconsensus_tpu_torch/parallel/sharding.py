"""Device mesh: ensemble- and edge-sharding for the consensus loop.

Counterpart of ``fastconsensus_tpu/parallel/sharding.py``.  The reference
lays a ``jax.sharding.Mesh`` over its devices and lets XLA's SPMD
partitioner place the work; the port places it explicitly:

* **ensemble axis "p"**: the ``n_p`` keys and labels split into P
  contiguous blocks, block i on ``mesh.devices[i][0]``, where its members
  detect against a whole (replicated) slab;
* **edge axis "e"**: the slab's capacity splits into E contiguous chunks,
  chunk s (slots ``[s * cap_l, (s + 1) * cap_l)``) on
  ``mesh.devices[0][s]``; the consensus tail runs edge-locally over the
  chunks (``ops/sharded_tail.py``), and what crosses devices goes
  through ``parallel/collectives.py``.

Cells off row 0 and column 0 hold nothing.  A mesh may list one device
more than once, as the reference's tests force 8 CPU devices: on one card
the chunks and blocks then share it, and every collective's copy is a
no-op.

One process drives every device of a mesh, unless the run joined a
multi-process group (:func:`initialize_multihost`, the reference's
``jax.distributed.initialize``).  Then :func:`make_mesh` lays the axes
over every process's devices, each cell belongs to the process that
listed its device, and every process runs the same program (SPMD): it
holds only its own chunks and blocks, calls every collective, and ends
with the same gathered results.

The reference's ``keys_sharding``/``labels_sharding``/``slab_sharding``
(``NamedSharding`` builders) and ``put_keys``/``constrain_keys``/
``_key_data_sharding`` (workarounds for JAX's typed PRNG keys) have no
counterpart: the layout is the :class:`Mesh` and the ``shard_*``
functions below, and a key here is a plain ``[.., 2]`` tensor.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from fastconsensus_tpu_torch.graph import GraphSlab, grow_slab
from fastconsensus_tpu_torch.parallel import collectives as coll
from fastconsensus_tpu_torch.utils.env import env_int

ENSEMBLE_AXIS = "p"
EDGE_AXIS = "e"

Labels = Union[torch.Tensor, Sequence[torch.Tensor]]


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's index in a multi-process run (0 outside one)."""
    import torch.distributed as dist

    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The processes of a multi-process run (1 outside one)."""
    import torch.distributed as dist

    return dist.get_world_size() if _joined() else 1


def _env_address() -> Optional[str]:
    env = os.environ
    if env.get("COORDINATOR_ADDRESS"):
        return env["COORDINATOR_ADDRESS"]
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    return None


def _own_gpu(process_id: int) -> int:
    """The GPU a process drives alone: ``LOCAL_RANK`` (torchrun sets it),
    else its process index, modulo the visible GPUs."""
    return env_int("LOCAL_RANK", process_id) % torch.cuda.device_count()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> int:
    """Join a multi-process run; returns this process's index.

    Every process calls this once, before its first mesh, and then runs
    the same program: :func:`make_mesh` lays both axes over every
    process's devices and ``run_consensus(mesh=)`` runs SPMD, each
    process holding its own chunks and blocks and ending with the same
    result.

    Args default from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID,
    as the reference's do, or torchrun's MASTER_ADDR:MASTER_PORT /
    WORLD_SIZE / RANK.  The address is ``host:port`` (a TCP store that
    process 0 serves) or a ``torch.distributed`` init URL
    (``tcp://...``, ``file://...``).

    ``backend``: ``"nccl"`` by default, which needs CUDA and one GPU for
    each process (``LOCAL_RANK``, else the process index, picks it);
    ``"gloo"`` carries host tensors and is the only way for processes
    to share one card or to run on the CPU.  A backend that cannot serve
    the processes' devices raises, naming it; nothing switches to
    another backend or to the CPU unasked.
    """
    import torch.distributed as dist

    address = coordinator_address or _env_address()
    world = num_processes if num_processes is not None else env_int(
        "NUM_PROCESSES", env_int("WORLD_SIZE"))
    rank = process_id if process_id is not None else env_int(
        "PROCESS_ID", env_int("RANK"))
    for value, what in ((address, "coordinator_address (COORDINATOR_"
                                  "ADDRESS, or MASTER_ADDR and "
                                  "MASTER_PORT)"),
                        (world, "num_processes (NUM_PROCESSES or "
                                "WORLD_SIZE)"),
                        (rank, "process_id (PROCESS_ID or RANK)")):
        if value is None:
            raise ValueError(f"initialize_multihost: {what} is not given")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_multihost: CUDA is not available, so the "
                "default backend 'nccl' cannot serve this process; pass "
                "backend='gloo' for a run on the CPU")
        backend = "nccl"
    if backend == "nccl" and not (torch.cuda.is_available() and
                                  dist.is_nccl_available()):
        raise RuntimeError(
            "initialize_multihost: backend 'nccl' cannot serve this "
            "process: it needs CUDA and a PyTorch built with NCCL; pass "
            "backend='gloo' for host tensors")
    url = address if "://" in address else f"tcp://{address}"
    store, rank, world = next(dist.rendezvous(url, rank, world))
    if backend == "nccl":
        gpu = _own_gpu(rank)
        props = torch.cuda.get_device_properties(gpu)
        me = str(getattr(props, "uuid", "")) or \
            f"{socket.gethostname()}:{gpu}"
        store.set(f"fastconsensus/gpu/{rank}", me)
        claims = [store.get(f"fastconsensus/gpu/{r}").decode()
                  for r in range(world)]
        others = [r for r, c in enumerate(claims) if c == me and r != rank]
        if others:
            raise RuntimeError(
                f"initialize_multihost: backend 'nccl' cannot serve "
                f"process {rank}: it shares GPU {gpu} ({me}) with process "
                f"{others[0]}, and NCCL needs one GPU for each process; "
                f"pass backend='gloo' to share a card")
        torch.cuda.set_device(gpu)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return rank


def shutdown_multihost() -> None:
    """Leave the multi-process run (a no-op outside one)."""
    import torch.distributed as dist

    if _joined():
        dist.destroy_process_group()


def local_devices() -> List[torch.device]:
    """The CUDA devices this process drives: every visible GPU, or in a
    multi-process run under NCCL or torchrun (``LOCAL_RANK``) the one
    GPU of this process.  Raises without CUDA: it never falls back to
    the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: CUDA is not available; pass devices= (e.g. "
            "[torch.device('cpu')] * 8) for a mesh on other devices")
    if process_count() > 1:
        import torch.distributed as dist

        if dist.get_backend() == "nccl" or env_int("LOCAL_RANK") is not None:
            return [torch.device("cuda", _own_gpu(process_index()))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(p, e)`` grid of torch devices (rows: ensemble shards).

    ``processes`` (a grid of the same shape) names the process that owns
    each cell in a multi-process run, ``rank`` this process and ``home``
    its first device; ``None`` (one process) owns every cell."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    processes: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0
    home: Optional[torch.device] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {ENSEMBLE_AXIS: len(self.devices),
                EDGE_AXIS: len(self.devices[0])}

    @property
    def spans_processes(self) -> bool:
        return self.processes is not None

    @property
    def home_device(self) -> torch.device:
        """Where this process runs the work every process replicates."""
        return self.home if self.home is not None else self.devices[0][0]

    def owner(self, i: int, j: int) -> int:
        return 0 if self.processes is None else self.processes[i][j]

    def device(self, i: int, j: int) -> torch.device:
        """Cell ``(i, j)``'s device; raises where another process owns
        it (that device is not this process's to use)."""
        if self.owner(i, j) != self.rank:
            raise RuntimeError(
                f"mesh cell ({i}, {j}) belongs to process "
                f"{self.owner(i, j)}; process {self.rank} cannot use its "
                f"device {self.devices[i][j]}")
        return self.devices[i][j]

    def local_blocks(self) -> List[int]:
        """The ensemble shards this process holds, in order."""
        return [i for i in range(len(self.devices))
                if self.owner(i, 0) == self.rank]

    def local_chunks(self) -> List[int]:
        """The edge shards this process holds, in order."""
        return [s for s in range(len(self.devices[0]))
                if self.owner(0, s) == self.rank]

    def _axis(self, owners) -> Optional[coll.Axis]:
        if self.processes is None:
            return None
        return coll.Axis(tuple(owners), self.rank, self.home_device)

    def edge_axis(self) -> Optional[coll.Axis]:
        """The "e" axis for the collectives (None: one process)."""
        return self._axis(self.processes[0] if self.processes else ())

    def ensemble_axis(self) -> Optional[coll.Axis]:
        """The "p" axis for the collectives (None: one process)."""
        return self._axis([row[0] for row in self.processes or ()])


def make_mesh(ensemble: Optional[int] = None, edge: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build an (ensemble, edge) mesh over ``devices`` (default
    :func:`local_devices`: every CUDA device; without CUDA and without
    ``devices`` this raises, it never falls back to the CPU).
    ``ensemble=None`` takes every device not claimed by the edge axis.

    In a multi-process run ``devices`` are this process's own: every
    process passes its list, the lists are exchanged once, and the mesh
    lays out the global list ordered by process index, as
    ``jax.devices()`` is."""
    devices = [torch.device(d) for d in (
        local_devices() if devices is None else devices)]
    world = process_count()
    owners = [0] * len(devices)
    home = devices[0] if devices else None
    if world > 1:
        import torch.distributed as dist

        if dist.get_backend() == "nccl" and \
                any(d.type != "cuda" for d in devices):
            raise ValueError(
                f"make_mesh: backend 'nccl' cannot carry tensors on "
                f"{[str(d) for d in devices]}; a mesh off CUDA needs "
                f"initialize_multihost(backend='gloo')")
        every = [None] * world
        dist.all_gather_object(every, [str(d) for d in devices])
        devices = [torch.device(d) for names in every for d in names]
        owners = [r for r, names in enumerate(every) for _ in names]
    n = len(devices)
    if ensemble is None:
        if n % edge:
            raise ValueError(f"{n} devices not divisible by edge={edge}")
        ensemble = n // edge
    if ensemble * edge > n:
        raise ValueError(
            f"mesh {ensemble}x{edge} needs {ensemble * edge} devices, "
            f"have {n}")

    def grid(xs):
        return tuple(tuple(xs[i * edge:(i + 1) * edge])
                     for i in range(ensemble))

    if world == 1:
        return Mesh(grid(devices))
    return Mesh(grid(devices), processes=grid(owners),
                rank=process_index(), home=home)


def pad_n_p(n_p: int, mesh: Mesh) -> int:
    """Round n_p up to a multiple of the ensemble axis size."""
    p = mesh.shape[ENSEMBLE_AXIS]
    return math.ceil(n_p / p) * p


@dataclasses.dataclass(frozen=True)
class ShardedSlab:
    """A slab split along its capacity over a mesh's edge axis.

    ``chunks`` are this process's chunks (every chunk in one process),
    each a :class:`GraphSlab` of the slots ``[s * cap_l, (s + 1) *
    cap_l)`` on its cell's device.  ``head`` is an empty slab on the
    mesh's home device that carries the global statics (``n_nodes``,
    ``d_cap``, ``cap_hint``, ``d_hyb``, ``hub_cap``, ``agg_cap``), which
    this object exposes as a slab does, so the sizing rules read them
    unchanged, also in a process that holds no chunk.  ``capacity`` is
    the global one."""

    chunks: Tuple[GraphSlab, ...]
    mesh: Mesh
    chunk_capacity: int
    head: GraphSlab

    n_nodes = property(lambda self: self.head.n_nodes)
    d_cap = property(lambda self: self.head.d_cap)
    cap_hint = property(lambda self: self.head.cap_hint)
    d_hyb = property(lambda self: self.head.d_hyb)
    hub_cap = property(lambda self: self.head.hub_cap)
    agg_cap = property(lambda self: self.head.agg_cap)

    @property
    def capacity(self) -> int:
        return self.chunk_capacity * self.mesh.shape[EDGE_AXIS]

    @property
    def device(self) -> torch.device:
        return self.head.device

    def num_alive(self) -> torch.Tensor:
        return coll.psum([c.num_alive() for c in self.chunks],
                         self.mesh.edge_axis())[0]

    def degrees(self) -> torch.Tensor:
        return coll.psum([c.degrees() for c in self.chunks],
                         self.mesh.edge_axis())[0]

    def with_statics(self, **statics) -> "ShardedSlab":
        return dataclasses.replace(
            self, chunks=tuple(c.with_statics(**statics)
                               for c in self.chunks),
            head=self.head.with_statics(**statics))

    def with_chunks(self, chunks: Sequence[GraphSlab]) -> "ShardedSlab":
        return dataclasses.replace(self, chunks=tuple(chunks))


def _placed(slab: GraphSlab, part: Optional[slice], dev) -> GraphSlab:
    """The slots ``part`` (None: the fields themselves) on ``dev``."""
    def put(t):
        return (t if part is None else t[part]).to(dev)

    return dataclasses.replace(slab, src=put(slab.src), dst=put(slab.dst),
                               weight=put(slab.weight),
                               alive=put(slab.alive))


def shard_slab(slab: GraphSlab, mesh: Mesh) -> ShardedSlab:
    """Place a slab on the mesh: pad the capacity to a multiple of the
    edge axis with dead tail slots (``graph.grow_slab``, which changes no
    result), then split every field into contiguous chunks and keep this
    process's."""
    e = mesh.shape[EDGE_AXIS]
    slab = grow_slab(slab, math.ceil(slab.capacity / e) * e)
    cap_l = slab.capacity // e
    chunks = [_placed(slab, slice(s * cap_l, (s + 1) * cap_l),
                      mesh.device(0, s)) for s in mesh.local_chunks()]
    return ShardedSlab(tuple(chunks), mesh, cap_l,
                       _placed(slab, slice(0, 0), mesh.home_device))


def gather_slab(sharded: ShardedSlab) -> GraphSlab:
    """The inverse of :func:`shard_slab`: one slab on the mesh's home
    device, in every process (the chunk itself when one process holds
    the whole edge axis in one chunk)."""
    ax = sharded.mesh.edge_axis()
    if ax is None and len(sharded.chunks) == 1:
        return sharded.chunks[0]
    dev = sharded.device

    def cat(name):
        return torch.cat([x.to(dev) for x in coll.gather_shards(
            [getattr(c, name) for c in sharded.chunks], ax)])

    return dataclasses.replace(sharded.head, src=cat("src"),
                               dst=cat("dst"), weight=cat("weight"),
                               alive=cat("alive"))


def replicate_slab(slab: Union[GraphSlab, ShardedSlab], mesh: Mesh
                   ) -> List[GraphSlab]:
    """The detection-side view: one whole slab per ensemble shard this
    process holds, on its device (the same tensors, not a copy, where
    the devices coincide)."""
    whole = gather_slab(slab) if isinstance(slab, ShardedSlab) else slab
    return [_placed(whole, None, mesh.device(i, 0))
            for i in mesh.local_blocks()]


def shard_keys(keys: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Keys ``[n_p, 2]`` split along the ensemble axis: this process's
    blocks, block i on its shard's device."""
    p = mesh.shape[ENSEMBLE_AXIS]
    if keys.shape[0] % p:
        raise ValueError(
            f"n_p={keys.shape[0]} not divisible by ensemble axis {p}; use "
            f"pad_n_p")
    blocks = keys.chunk(p)
    return [blocks[i].to(mesh.device(i, 0)) for i in mesh.local_blocks()]


def shard_labels(labels: Labels, mesh: Mesh) -> List[torch.Tensor]:
    """Labels ``[n_p, N]`` split along the ensemble axis, as the keys
    are; per-shard blocks (a list) pass through."""
    if not isinstance(labels, torch.Tensor):
        return list(labels)
    return shard_keys(labels, mesh)


def gather_labels(labels: Labels, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """Per-shard label blocks as one ``[n_p, N]`` tensor on the first
    block's device (a tensor passes through).  On a mesh that spans
    processes (pass it) every process gets every block, on its home
    device."""
    if isinstance(labels, torch.Tensor):
        return labels
    blocks = coll.gather_shards(labels, None if mesh is None
                                else mesh.ensemble_axis())
    if len(blocks) == 1:
        return blocks[0]
    dev = blocks[0].device
    return torch.cat([b.to(dev) for b in blocks])
