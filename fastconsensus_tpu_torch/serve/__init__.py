"""fcserve on the port: the request-serving layer over the consensus
engine, counterpart of ``fastconsensus_tpu/serve`` (one replica with
its mesh-sharded huge tier, and the fleet of replicas behind a router).

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
* **serve/pool.py** — one worker per GPU (``torch.cuda.device(i)``),
  and the huge tier's mesh group (``MeshWorker``).
* **serve/server.py** — the service core and the stdlib HTTP front end
  (``POST /submit``, ``GET /status/<id>``, ``/result/<id>``,
  ``/healthz``, ``/metricsz``, ``/debugz/*``, ``/cachez``).
* **serve/delta.py** — fcdelta: incremental re-consensus of a cached
  parent's child graph.
* **serve/client.py** — stdlib urllib client (``cli.py --server``) with
  the typed replica and fleet blocks, importing neither torch nor jax.
* **serve/router.py** — fcfleet: the consistent-hash router over N
  replicas (``route_key``, ``HashRing``, ``FleetRouter``: cordon and
  re-home, fleet-wide backpressure, cross-replica cache reuse, the
  ``/fleetz`` merge), torch-free.
* **serve/fleet.py** — ``FleetManager``: spawns ``python -m
  fastconsensus_tpu_torch.serve`` replicas, death inheritance, prewarm
  shipping, bundle collection; torch-free.

Run one: ``python -m fastconsensus_tpu_torch.serve --port 8765``
(``--device cpu`` without a GPU); SIGTERM drains gracefully.  Run a
fleet: ``python -m fastconsensus_tpu_torch.serve.fleet --replicas 2``
(``--replica-arg=--device --replica-arg=cpu`` without a GPU).
"""

# Lazy re-exports (PEP 562), as the package root: importing
# fastconsensus_tpu_torch.serve.client (the thin-client path, cli.py
# --server) or the fleet tier (router, fleet) must stay torch-free, and
# eager submodule imports here would pull bucketer -> graph -> torch into
# every client and router process.
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
    "FleetRouter": "router", "HashRing": "router", "route_key": "router",
    "FleetManager": "fleet",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"fastconsensus_tpu_torch.serve.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
