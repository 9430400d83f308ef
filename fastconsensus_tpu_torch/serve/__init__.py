"""fcserve on the port: the request-serving layer over the consensus
engine, counterpart of ``fastconsensus_tpu/serve`` (one replica; the
fleet router and the mesh-sharded huge tier are not ported yet).

* **serve/bucketer.py** — shape buckets: graphs pad onto a small
  ``{2^k, 3*2^k}`` ladder of (n_nodes, n_edges) classes with every
  content-derived slab static canonicalized, so any two graphs of one
  bucket stack into one batch.
* **serve/jobs.py** — job spec, states, priorities and the content hash
  (equal to the reference's for the same request).
* **serve/cache.py** — content-addressed result cache (LRU + TTL, the
  reference's ``.npz`` spill layout).
* **serve/queue.py** — bounded EDF admission queue with explicit
  backpressure (HTTP 429); ``pop_batch`` coalesces same-bucket jobs.
* **serve/shaping.py**, **serve/scheduler.py**, **serve/watchdog.py** —
  SLO shaping, sticky bucket->device routing, the hang watchdog.
* **serve/pool.py** — one worker per GPU (``torch.cuda.device(i)``).
* **serve/server.py** — the service core and the stdlib HTTP front end
  (``POST /submit``, ``GET /status/<id>``, ``/result/<id>``,
  ``/healthz``, ``/metricsz``, ``/debugz/*``, ``/cachez``).
* **serve/delta.py** — fcdelta: incremental re-consensus of a cached
  parent's child graph.
* **serve/client.py** — stdlib urllib client (``cli.py --server``),
  importing neither torch nor jax.

Run one: ``python -m fastconsensus_tpu_torch.serve --port 8765``
(``--device cpu`` without a GPU); SIGTERM drains gracefully.
"""

# Lazy re-exports (PEP 562), as the package root: importing
# fastconsensus_tpu_torch.serve.client (the thin-client path, cli.py
# --server) must stay torch-free, and eager submodule imports here would
# pull bucketer -> graph -> torch into every client process.
_EXPORTS = {
    "Bucket": "bucketer", "BucketTooLarge": "bucketer",
    "bucket_for": "bucketer", "pad_to_bucket": "bucketer",
    "ResultCache": "cache",
    "Job": "jobs", "JobSpec": "jobs", "content_hash": "jobs",
    "SLO_CLASSES": "jobs",
    "AdmissionQueue": "queue", "QueueClosed": "queue",
    "QueueFull": "queue", "DeadlineShed": "queue",
    "ShapingConfig": "shaping", "TrafficShaper": "shaping",
    "ConsensusService": "server", "GraphTooLarge": "server",
    "ServeConfig": "server", "make_http_server": "server",
    "DeviceWorker": "pool", "WorkerPool": "pool",
    "NoEligibleWorker": "scheduler", "StickyScheduler": "scheduler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"fastconsensus_tpu_torch.serve.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
