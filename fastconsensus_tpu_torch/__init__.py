"""PyTorch/CUDA port of fastconsensus_tpu for NVIDIA Hopper GPUs.

The JAX package ``fastconsensus_tpu`` is the reference; this package
computes the same consensus clustering with PyTorch and hand-written CUDA
kernels (``ops/csrc``), and imports nothing of JAX or of the reference.
Entry points: ``fast_consensus``, ``run_consensus`` (also incremental,
from a parent run's partitions), ``run_consensus_batch`` (B same-bucket
graphs, ``serve/bucketer.pad_to_bucket``) and ``python -m
fastconsensus_tpu_torch.cli``; they run on CUDA unless the caller passes
``device="cpu"`` (or CPU slabs).  All five detectors of the reference are
ported: Louvain, Leiden and LPM on the device, CNM and Infomap as host
C++.
"""

from fastconsensus_tpu_torch.version import __version__

__all__ = ["GraphSlab", "pack_edges", "host_edges", "fast_consensus",
           "run_consensus", "run_consensus_batch", "ConsensusConfig",
           "get_detector", "__version__"]


def __getattr__(name):
    # lazy, as the reference's top level: importing the package loads no
    # module until a name is used
    if name in ("GraphSlab", "pack_edges", "host_edges"):
        from fastconsensus_tpu_torch import graph

        return getattr(graph, name)
    if name in ("fast_consensus", "run_consensus", "run_consensus_batch",
                "ConsensusConfig"):
        from fastconsensus_tpu_torch import consensus

        return getattr(consensus, name)
    if name == "get_detector":
        from fastconsensus_tpu_torch.models.registry import get_detector

        return get_detector
    raise AttributeError(
        f"module 'fastconsensus_tpu_torch' has no attribute {name!r}")
