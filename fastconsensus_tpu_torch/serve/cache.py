"""fcserve result cache: content-addressed, LRU + TTL bounded.

Counterpart of ``fastconsensus_tpu/serve/cache.py``, with its ``.npz``
spill layout: a cache either package spills loads in the other.

Keyed by :func:`serve.jobs.content_hash` — the canonical-graph + config
digest — so a resubmission of the same work (any edge order, any client)
is answered from memory: no queue slot, no device time, no detect spans.
Consensus is deterministic per (graph, config, seed), which is what
makes caching *results* (not just executables) sound.

Two bounds, both mandatory (a serving cache that only ever grows is a
slow OOM):

* **LRU capacity** — at most ``max_entries`` results resident; inserts
  beyond it evict the least-recently-hit entry;
* **TTL** — entries older than ``ttl_seconds`` answer nothing and are
  dropped on touch (long-lived servers should not serve arbitrarily
  stale artifacts once operators rotate configs/data around them).

fcdelta lineage pins: a delta submission (serve/delta.py) resolves its
parent's cached partitions *by reference* during admission — between
the moment the handler reads the parent hash and the moment the
warm-start labels are copied out, an LRU eviction or TTL expiry would
turn an admissible delta into a spurious 404.  :meth:`pin` marks an
entry unevictable (refcounted — concurrent deltas may share a parent)
for exactly that resolve window; :meth:`unpin` releases it.  Pinned
entries are skipped by the LRU eviction loop and survive TTL on touch;
the cache may transiently exceed ``max_entries`` by the number of live
pins, which is bounded by in-flight delta admissions.  Counted as
``serve.cache.parent_pins``.

Every outcome counts itself in the fcobs registry
(``serve.cache.{hit,miss,insert,evict_lru,expired}`` + the
``serve.cache.entries`` gauge), so ``/metricsz`` exposes hit rate
directly.  The clock is injectable for deterministic TTL tests.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from fastconsensus_tpu_torch.obs import counters as obs_counters


class ResultCache:
    """Thread-safe LRU+TTL map of content hash -> result payload."""

    def __init__(self, max_entries: int = 256,
                 ttl_seconds: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self.ttl_seconds = float(ttl_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        # key -> (stored_at, value); OrderedDict end = most recent
        self._entries: "OrderedDict[str, Tuple[float, Any]]" = OrderedDict()
        # fcdelta lineage pins: key -> refcount of in-flight delta
        # admissions currently resolving this entry as their parent
        self._pins: dict = {}
        self._reg = obs_counters.get_registry()
        # Spill coordination (fcfleet): the periodic background spill
        # and the drain-time spill may race; one coarse lock serializes
        # the npz write, and the dirty flag lets the loser skip instead
        # of rewriting identical bytes (spill_if_dirty).
        self._spill_lock = threading.Lock()
        self._dirty = False

    def get(self, key: str, count_miss: bool = True) -> Optional[Any]:
        """The cached result, or None (counts hit/miss/expired).

        ``count_miss=False`` is for RE-checks of one admission (the
        worker re-probes right before running in case an identical
        queued job completed meanwhile — serve/server.py): a hit there
        is a genuine serve and always counts, but recounting the miss
        would double it per computed job and halve the hit rate an
        operator reads off ``/metricsz``.
        """
        now = self._clock()
        ttl = self.ttl_seconds   # immutable after init; read unlocked
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if count_miss:
                    self._reg.inc("serve.cache.miss")
                return None
            stored_at, value = entry
            if now - stored_at > ttl and key not in self._pins:
                del self._entries[key]
                self._reg.inc("serve.cache.expired")
                if count_miss:
                    self._reg.inc("serve.cache.miss")
                self._reg.gauge("serve.cache.entries", len(self._entries))
                return None
            # fcheck: ok=key-reuse (this `key` is the content-hash
            # cache-key STRING, not a PRNG key — the name-based
            # heuristic misfires; strings have no consumption semantics)
            self._entries.move_to_end(key)
            self._reg.inc("serve.cache.hit")
            return value

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._dirty = True
            self._entries[key] = (self._clock(), value)
            self._entries.move_to_end(key)
            self._reg.inc("serve.cache.insert")
            # evict least-recently-hit UNPINNED entries; a pinned parent
            # (fcdelta resolve in flight) is skipped even at capacity —
            # the transient overshoot is bounded by live pins
            excess = len(self._entries) - self.max_entries
            if excess > 0:
                victims = [k for k in self._entries
                           if k not in self._pins][:excess]
                for k in victims:
                    del self._entries[k]
                    self._reg.inc("serve.cache.evict_lru")
            self._reg.gauge("serve.cache.entries", len(self._entries))

    # -- fcdelta lineage pins ------------------------------------------

    def pin(self, key: str) -> bool:
        """Hold ``key`` against LRU eviction and TTL expiry for a delta
        admission's parent-resolve window.  Returns False (and pins
        nothing) when the entry is absent or already past its TTL —
        the caller's "parent not cached" signal.  Refcounted: every
        successful pin needs exactly one :meth:`unpin`."""
        now = self._clock()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            if now - entry[0] > self.ttl_seconds and \
                    key not in self._pins:
                # already dead, just not collected yet — pinning it
                # would resurrect an expired artifact
                del self._entries[key]
                self._reg.inc("serve.cache.expired")
                self._reg.gauge("serve.cache.entries",
                                len(self._entries))
                return False
            # fcheck: ok=key-reuse (this `key` is the content-hash
            # cache-key STRING, not a PRNG key — the name-based
            # heuristic misfires; strings have no consumption semantics)
            self._pins[key] = self._pins.get(key, 0) + 1
            self._reg.inc("serve.cache.parent_pins")
            return True

    def unpin(self, key: str) -> None:
        """Release one :meth:`pin`.  Unknown/unpinned keys are a no-op
        (the pin may have returned False).  An entry that outlived its
        TTL only because it was pinned drops on the next touch."""
        with self._lock:
            # fcheck: ok=key-reuse (cache-key string, not a PRNG key —
            # same name-based misfire as get() above)
            n = self._pins.get(key, 0)
            if n <= 1:
                self._pins.pop(key, None)  # fcheck: ok=key-reuse
            else:
                self._pins[key] = n - 1  # fcheck: ok=key-reuse

    def pinned(self) -> dict:
        """Snapshot of live pin refcounts (introspection/tests)."""
        with self._lock:
            return dict(self._pins)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    # -- persistence across restarts (npz spill / reload) -------------
    #
    # A restarted server otherwise starts cold: every request recomputes
    # until the cache refills.  Result payloads are plain numpy (the
    # partitions) plus JSON scalars, so the utils/checkpoint-style npz
    # spill captures them losslessly.  TTL survives the restart as
    # REMAINING lifetime: the monotonic stored_at clock is meaningless
    # across processes, so each entry persists its *age* at spill time
    # and re-enters the new process's clock with that age pre-spent.

    def spill(self, path: str) -> int:
        """Write every live (unexpired) entry to ``path`` (npz,
        atomic); returns the number spilled.  Entries whose payload is
        not the standard result shape (a dict with a ``partitions``
        array list and JSON scalars) are skipped with a counter — the
        spill must never fail the drain that triggers it.  Serialized
        against concurrent spills (blocking): the drain-time spill and
        the fcfleet periodic spill share one atomic-write path."""
        with self._spill_lock:
            return self._spill_locked(path)

    def spill_if_dirty(self, path: str) -> int:
        """The fcfleet periodic-spill entry (serve/server.py
        ``--cache-spill-s`` loop): spill only when entries changed
        since the last spill, and never while another spill is already
        writing — returns -1 when skipped because a concurrent spill
        holds the lock (counted), 0 when clean, else the number
        spilled.  This is what keeps a SIGKILLed replica's cache
        recoverable (serve/fleet.py ``on_death`` feeds the file to the
        ring successor) without the drain-time spill ever racing it
        into a double write."""
        if not self._spill_lock.acquire(blocking=False):
            self._reg.inc("serve.cache.persist_concurrent_skip")
            return -1
        try:
            with self._lock:
                if not self._dirty:
                    return 0
            return self._spill_locked(path)
        finally:
            self._spill_lock.release()

    def _spill_locked(self, path: str) -> int:
        import json

        import numpy as np

        now = self._clock()
        with self._lock:
            self._dirty = False
            items = [(k, t, v) for k, (t, v) in self._entries.items()]
        meta, arrays = [], {}
        for key, stored_at, value in items:
            age = now - stored_at
            if age > self.ttl_seconds:
                continue
            try:
                payload = dict(value)
                parts = payload.pop("partitions")
                # fcheck: ok=sync-in-loop (cached partitions are host
                # numpy already — this is pure serialization, no device)
                arr = np.stack([np.asarray(p, dtype=np.int32)
                                for p in parts])
                # fcdelta: the canonical graph block rides cached
                # results so a spilled/inherited parent can still
                # resolve delta submissions; arrays spill beside the
                # partitions, never through json
                graph = payload.pop("graph", None)
                garr = None
                if graph is not None:
                    # host numpy/list blocks — pure spill serialization,
                    # no device round-trip (hence the pragmas below)
                    garr = {
                        "u": np.asarray(  # fcheck: ok=sync-in-loop
                            graph["u"], dtype=np.int64),
                        "v": np.asarray(  # fcheck: ok=sync-in-loop
                            graph["v"], dtype=np.int64),
                    }
                    if graph.get("w") is not None:
                        # fcheck: ok=sync-in-loop (same: host-side spill)
                        garr["w"] = np.asarray(graph["w"],
                                               dtype=np.float32)
                json.dumps(payload)  # everything else must be JSON
            except (TypeError, ValueError, KeyError):
                self._reg.inc("serve.cache.persist_skipped")
                continue
            idx = len(meta)
            arrays[f"p{idx}"] = arr
            if garr is not None:
                for name, a in garr.items():
                    arrays[f"g{idx}{name}"] = a
            meta.append({"key": key, "age": age, "payload": payload,
                         "graph": sorted(garr) if garr else None})
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8),
                **arrays)
        import os

        os.replace(tmp, path)
        self._reg.inc("serve.cache.persist_saved", len(meta))
        return len(meta)

    def load(self, path: str) -> int:
        """Reload a :meth:`spill` artifact into this cache (LRU order
        preserved; entries past their remaining TTL are dropped).
        Returns the number loaded; missing/corrupt files load nothing
        (a cold start, not a crash — counted)."""
        import json

        import numpy as np

        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode("utf-8"))
                loaded = 0
                now = self._clock()
                for idx, ent in enumerate(meta):
                    if ent["age"] > self.ttl_seconds:
                        self._reg.inc("serve.cache.persist_expired")
                        continue
                    arr = z[f"p{idx}"]
                    value = dict(ent["payload"])
                    value["partitions"] = [arr[i].copy()
                                           for i in range(arr.shape[0])]
                    if ent.get("graph"):
                        value["graph"] = {
                            name: z[f"g{idx}{name}"].copy()
                            for name in ent["graph"]}
                        value["graph"].setdefault("w", None)
                    with self._lock:
                        self._entries[ent["key"]] = (now - ent["age"],
                                                     value)
                        self._entries.move_to_end(ent["key"])
                        while len(self._entries) > self.max_entries:
                            self._entries.popitem(last=False)
                            self._reg.inc("serve.cache.evict_lru")
                    loaded += 1
        except Exception as e:  # noqa: BLE001 — the persistence
            # contract is "corrupt or missing file means a cold start,
            # never a crash": np.load surfaces OSError/ValueError for
            # most damage but zipfile.BadZipFile/EOFError for truncated
            # archives, and server startup must survive ALL of them
            self._reg.inc("serve.cache.persist_load_failed")
            import logging

            logging.getLogger("fastconsensus_tpu_torch").warning(
                "result-cache reload from %s failed (%s); starting cold",
                path, e)
            return 0
        with self._lock:
            if loaded:
                # loaded entries count as un-spilled content: a replica
                # that inherits a dead sibling's cache must re-spill it
                # on its own schedule or lose it at its own crash
                self._dirty = True
            self._reg.gauge("serve.cache.entries", len(self._entries))
        self._reg.inc("serve.cache.persist_loaded", loaded)
        return loaded
