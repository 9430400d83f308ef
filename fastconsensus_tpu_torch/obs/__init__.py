"""fcobs: the port's runtime observability, the reference's
``fastconsensus_tpu/obs`` on PyTorch.

* **obs/tracer.py** — nested host-side spans (wall + CPU time,
  thread-safe, a shared no-op when disabled).  ``run_consensus`` opens
  ``round`` (a step span), ``detect``, ``tail``, ``grow_and_replay``,
  ``checkpoint`` and ``final_detect``; the chunked detection
  ``detect_dispatch`` / ``detect_chunk``; ``run_consensus_batch``
  ``batch_block`` / ``batch_final_detect``.
* **obs/counters.py** — always-on counter/gauge/series registry: round
  stats folded per round, deliberate host syncs (``round_stats``,
  ``final_labels``, ``checkpoint``, ``budget_histogram``,
  ``detect_chunk``), detect-chunk counts and latency, device memory from
  ``torch.cuda.memory_stats``.
* **obs/device.py** — ``torch.profiler`` sessions, ``record_function``
  annotations and the merge of the profiler's Chrome trace into the
  fcobs Perfetto blob (``cli.py --trace --profile-dir``).
* **obs/export.py**, **obs/roundlog.py**, **obs/flight.py**,
  **obs/latency.py**, **obs/postmortem.py** — the reference's modules,
  unchanged apart from the package name: Perfetto/JSONL export and the
  rotated-chain reader, the round log, the flight recorder, latency
  histograms and post-mortem bundles.
* **obs/quality.py** — the device half of fcqual, computed in the tail.

Counters the reference takes from XLA have no counterpart here and are
not recorded: ``engine.setup_executables``, the compile guard's
``xla.compiles*``, the ``rounds_block`` spans and series and the fused
block's readback ``host_sync.block_stats``.  Eager PyTorch builds no
executables, and the port runs one round per host step (its readback is
``host_sync.round_stats``).  The serving tier's build counters
(``serve.xla_compiles`` and its kin) count the port's ``nvcc``/``g++``
builds instead (``analysis/recompile_guard.py``).

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
from fastconsensus_tpu_torch.obs.roundlog import (  # noqa: F401
    RoundLog, phase_span)
from fastconsensus_tpu_torch.obs.tracer import (  # noqa: F401
    Tracer, get_tracer, set_tracer, traced, use_tracer)

__all__ = [
    "Tracer", "get_tracer", "set_tracer", "use_tracer", "traced",
    "ObsRegistry", "get_registry", "host_sync", "fold_round",
    "device_memory", "record_device_memory",
    "LatencyHistogram", "LatencyRegistry", "get_latency_registry",
    "FlightRecorder", "get_flight_recorder",
    "RoundLog", "phase_span",
]
