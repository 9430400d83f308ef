"""fcobs: the port's runtime observability, the reference's
``fastconsensus_tpu/obs`` on PyTorch.

* **obs/tracer.py** — nested host-side spans (wall + CPU time,
  thread-safe, a shared no-op when disabled), on the Unix clock through
  ``Tracer.spans()``; a device-timed tracer gives the layer boundaries
  (``tracer.DEVICE_TIMED``) a device range too.  ``run_consensus`` is the
  root ``consensus``, over ``round`` and ``rounds_block`` (step spans, a
  block's keyed by its first round), ``setup_executables`` (a block's
  CUDA-graph capture), ``detect``, ``tail``, ``stats_readback``,
  ``grow_and_replay``, ``checkpoint`` and ``final_detect``;
  ``run_consensus_batch`` the root ``consensus_batch``, over
  ``batch_round`` (an eager batched round: ``detect``, a ``tail`` per
  job, ``stats_readback``), ``batch_block`` (a block) and
  ``batch_final_detect``.  Inside detection: the persisted driver chunks
  ``detect_chunk``, the member chunks ``member_chunk``
  (``models/base.ensemble``), and a Louvain sweep's ``sweep`` and its
  exit read ``sweep_exit`` (``models/louvain.local_move``, eager path).
  Round-level spans are mirrored into the flight ring
  (``tracer.FLIGHT_MIRRORED``).
* **obs/counters.py** — always-on counter/gauge/series registry: round
  stats folded per round, the driver's deliberate host reads and the
  eager Louvain round's own (``host_sync.*``: ``round_stats``, a fused block's ``block_stats``,
  ``batch_block_stats``, ``final_labels``, ``batch_final_labels``,
  ``checkpoint``, ``budget_histogram``, ``detect_chunk``, a sweep's exit
  test ``sweep_exit``, a batched sweep's row read ``member_take``, an
  eager tail's convergence test ``tail_converged``),
  ``round.seconds`` (a block's rounds each observe the block's average)
  and ``rounds_block.seconds``, the captures
  (``engine.setup_executables`` and its ``.seconds``), detection's work
  (``detect.member_chunks`` on every path, ``detect.chunks`` the
  persisted ones, ``detect.sweeps``, ``detect.member_sweeps``), the
  batch's occupancy (``batch.rounds``, ``batch.job_rounds``), device
  memory from ``torch.cuda.memory_stats``.
* **obs/device.py** — ``torch.profiler`` sessions, ``record_function``
  annotations and the merge of the profiler's Chrome trace into the
  fcobs Perfetto blob (``cli.py --trace --profile-dir``).
* **obs/export.py**, **obs/roundlog.py**, **obs/flight.py**,
  **obs/latency.py**, **obs/postmortem.py** — the reference's modules,
  unchanged apart from the package name (the round log without its
  ``phase_span``): Perfetto/JSONL export and the rotated-chain reader,
  the round log, the flight recorder, latency histograms and
  post-mortem bundles.
* **obs/quality.py** — the device half of fcqual, computed in the tail.

The compile guard's ``xla.compiles*`` have no counterpart here: eager
PyTorch compiles nothing.  ``engine.setup_executables`` counts the fused
block's CUDA-graph captures, the port's counterpart of the reference's
re-jit.  The serving tier's build counters (``serve.xla_compiles`` and
its kin) count the port's ``nvcc``/``g++`` builds instead
(``analysis/recompile_guard.py``).

Continuity: checkpoints carry the counter snapshot
(``utils/checkpoint.py``'s ``telemetry``), restored by delta on resume,
and ``utils/supervise.py`` rotates the JSONL event log across restarts.
"""

from fastconsensus_tpu_torch.obs.counters import (  # noqa: F401
    ObsRegistry, device_memory, fold_round, get_registry, host_sync,
    record_device_memory)
from fastconsensus_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, get_flight_recorder)
from fastconsensus_tpu_torch.obs.latency import (  # noqa: F401
    LatencyHistogram, LatencyRegistry, get_latency_registry)
from fastconsensus_tpu_torch.obs.roundlog import RoundLog  # noqa: F401
from fastconsensus_tpu_torch.obs.tracer import (  # noqa: F401
    Tracer, get_tracer, set_tracer, traced, use_tracer)

__all__ = [
    "Tracer", "get_tracer", "set_tracer", "use_tracer", "traced",
    "ObsRegistry", "get_registry", "host_sync", "fold_round",
    "device_memory", "record_device_memory",
    "LatencyHistogram", "LatencyRegistry", "get_latency_registry",
    "FlightRecorder", "get_flight_recorder",
    "RoundLog",
]
