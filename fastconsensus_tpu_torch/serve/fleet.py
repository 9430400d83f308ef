"""fcfleet manager: spawn, watch, and retire fcserve replica processes.

The port's own copy of ``fastconsensus_tpu/serve/fleet.py``, with the
same names and flags.  serve/router.py routes traffic across replicas
it is GIVEN; this module is what gives it them — a torch-free manager
that launches N ``python -m fastconsensus_tpu_torch.serve``
subprocesses (each one a full ConsensusService with its own worker
pool, result cache and flight recorder), fronts them with a
:class:`~.router.FleetRouter`, and owns the fleet's lifecycle stories.

Replicas run on CUDA, as that entry point does by default; a caller
that wants CPU replicas says so (``replica_args=("--device", "cpu")``,
or ``--replica-arg=--device --replica-arg=cpu`` on the command line),
and a replica that cannot reach CUDA exits and surfaces as
:class:`ReplicaSpawnError` with its log tail.  The manager pins no
replica to a GPU: every replica sees the devices its environment shows
it, so on a host with several GPUs a caller splits them with
``spawn(..., env_extra={"CUDA_VISIBLE_DEVICES": "1"})``, and replicas
given the same card share it (each with its own CUDA context).


* **spawn + readiness** — each replica gets its own port, cache spill
  file, and flight-bundle directory; ``wait_healthy`` polls
  ``/healthz`` until the replica answers (pre-warm included), so the
  router never routes into a replica that is still pre-warming;
* **chaos hooks** — a replica can be spawned with an
  ``FCTPU_FAULT_INJECT`` site armed in ITS environment only (the
  fleet-level use of serve/faultinject.py: one replica misbehaves, the
  fleet must not), killed hard (SIGKILL — the crash story the periodic
  cache spill exists for) or drained (SIGTERM — the rolling-restart
  story, exit 0 means every admitted job finished);
* **death inheritance** — when a replica dies, its groups re-home via
  the router's cordon machinery, and :meth:`on_death` tells the
  ring successor to load the dead replica's spilled cache file
  (``POST /cachez/load``), so resubmissions of the dead replica's work
  answer from cache instead of recomputing;
* **prewarm shipping** — :meth:`add_replica` asks the router which
  current member the joiner will inherit groups from, copies that
  donor's warm-bucket residency into the joiner's ``--warm`` flags,
  and ships the donor's cached results (``GET /cachez`` +
  ``GET /cachez/<hash>`` -> ``POST /cachez``) before the ring add —
  the new replica takes its first request warm;
* **bundle collection** — :meth:`snapshot_bundles` SIGQUITs every live
  replica (the fcflight "dump and keep serving" signal) and gathers
  the per-replica post-mortem bundle paths; :meth:`collect_bundles`
  goes one step further (fctrace) and copies every replica's bundles —
  dead ones included — into ONE ``<replica>__<bundle>`` directory that
  ``python -m fastconsensus_tpu_torch.obs.fleettrace render`` merges
  into a clock-aligned fleet incident timeline.

Like the router, this module imports neither torch nor jax: the
replicas pay the engine cost in their own processes, the manager is
pure stdlib.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import signal
import subprocess
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.serve.router import (FleetRouter, _http_json,
                                                  make_router_server)

_logger = logging.getLogger("fastconsensus_tpu_torch")

# How many cached results prewarm shipping copies donor -> joiner.  A
# bounded snapshot: shipping is a warm-start optimization, not a
# replication protocol, and an unbounded copy of a large donor cache
# would stall the join it is supposed to speed up.
SHIP_CACHE_MAX_ENTRIES = 64


class ReplicaSpawnError(RuntimeError):
    """A replica process exited or never answered /healthz in time."""


class ReplicaProc:
    """One managed fcserve subprocess."""

    def __init__(self, name: str, port: int, proc: subprocess.Popen,
                 cache_path: str, flight_dir: str,
                 warm: Tuple[str, ...]) -> None:
        self.name = name
        self.port = port
        self.proc = proc
        self.cache_path = cache_path
        self.flight_dir = flight_dir
        self.warm = warm

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def alive(self) -> bool:
        return self.proc.poll() is None

    def bundles(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.flight_dir,
                                             "fcflight_*")))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FleetManager:
    """Own a replica fleet + its router, end to end.

    Typical use (chip_smoke.py phase fleet)::

        fleet = FleetManager(workdir, warm=("n64_e96:2",))
        fleet.spawn("r0"); fleet.spawn("r1", fault="...:ValueError")
        url = fleet.start_router()
        ... drive traffic at url ...
        fleet.kill("r1", graceful=False)   # chaos
        fleet.on_death("r1")               # cordon + cache inheritance
        ... burst completes with zero failed jobs ...
        fleet.stop_all()
    """

    def __init__(self, workdir: str,
                 warm: Sequence[str] = (),
                 replica_args: Sequence[str] = (),
                 cache_spill_s: Optional[float] = 1.0,
                 spawn_timeout_s: float = 240.0,
                 poll_s: float = 0.5) -> None:
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.warm = tuple(warm)
        self.replica_args = tuple(replica_args)
        self.cache_spill_s = cache_spill_s
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.replicas: Dict[str, ReplicaProc] = {}
        self.router = FleetRouter({}, poll_s=poll_s)
        self._httpd = None
        self._http_thread = None
        self._reg = obs_counters.get_registry()

    # -- spawning -----------------------------------------------------

    def _spawn_proc(self, name: str, warm: Tuple[str, ...],
                    fault: Optional[str] = None,
                    fault_count: Optional[int] = None,
                    env_extra: Optional[Dict[str, str]] = None
                    ) -> ReplicaProc:
        port = _free_port()
        cache_path = os.path.join(self.workdir, f"{name}_cache.npz")
        flight_dir = os.path.join(self.workdir, f"{name}_flight")
        log_path = os.path.join(self.workdir, f"{name}.log")
        cmd = [sys.executable, "-m", "fastconsensus_tpu_torch.serve",
               "--port", str(port),
               "--cache-file", cache_path,
               "--flight-dir", flight_dir]
        if self.cache_spill_s:
            cmd += ["--cache-spill-s", str(self.cache_spill_s)]
        for spec in warm:
            cmd += ["--warm", spec]
        cmd += list(self.replica_args)
        env = dict(os.environ)
        if fault:
            env["FCTPU_FAULT_INJECT"] = fault
            if fault_count is not None:
                env["FCTPU_FAULT_INJECT_COUNT"] = str(fault_count)
        env.update(env_extra or {})
        log = open(log_path, "ab")
        try:
            proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env)
        finally:
            log.close()   # the child holds its own fd now
        return ReplicaProc(name, port, proc, cache_path, flight_dir,
                           warm)

    def wait_healthy(self, rep: ReplicaProc,
                     timeout_s: Optional[float] = None) -> None:
        """Poll the replica's /healthz until it answers with pre-warm
        finished; raise :class:`ReplicaSpawnError` on process death or
        timeout (with the tail of the replica's log — the spawn
        failure is otherwise invisible in the parent)."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.spawn_timeout_s)
        while time.monotonic() < deadline:
            if not rep.alive():
                raise ReplicaSpawnError(
                    f"replica {rep.name} exited rc={rep.proc.returncode} "
                    f"before serving: {self._log_tail(rep.name)}")
            try:
                with urllib.request.urlopen(rep.base_url + "/healthz",
                                            timeout=2.0) as resp:
                    body = json.loads(resp.read() or b"{}")
                prewarm = body.get("prewarm") or {}
                if prewarm.get("finished", True):
                    return
            # fcheck: ok=swallowed-error (not listening YET is the
            # expected state this loop exists to wait out; death and
            # timeout are both surfaced above/below)
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        raise ReplicaSpawnError(
            f"replica {rep.name} not healthy after "
            f"{timeout_s or self.spawn_timeout_s:.0f}s: "
            f"{self._log_tail(rep.name)}")

    def _log_tail(self, name: str, n: int = 12) -> str:
        path = os.path.join(self.workdir, f"{name}.log")
        try:
            with open(path, "r", encoding="utf-8",
                      errors="replace") as fh:
                return " | ".join(fh.read().splitlines()[-n:])
        except OSError:
            return "<no log>"

    def spawn(self, name: str, fault: Optional[str] = None,
              fault_count: Optional[int] = None,
              env_extra: Optional[Dict[str, str]] = None,
              warm: Optional[Sequence[str]] = None,
              register: bool = True) -> ReplicaProc:
        """Launch a replica, wait for it to serve, and (by default)
        join it to the router's ring."""
        if name in self.replicas:
            raise ValueError(f"replica {name!r} already exists")
        rep = self._spawn_proc(name,
                               tuple(warm if warm is not None
                                     else self.warm),
                               fault=fault, fault_count=fault_count,
                               env_extra=env_extra)
        self.replicas[name] = rep
        try:
            self.wait_healthy(rep)
        except ReplicaSpawnError:
            self.replicas.pop(name, None)
            if rep.alive():
                rep.proc.kill()
                rep.proc.wait(timeout=10)
            raise
        if register:
            self.router.add_replica(name, rep.base_url)
        self._reg.inc("serve.fleet.spawns")
        return rep

    # -- elastic join (prewarm shipping) ------------------------------

    def add_replica(self, name: str,
                    env_extra: Optional[Dict[str, str]] = None
                    ) -> ReplicaProc:
        """Grow the fleet by one WARM replica: before the ring add, the
        joiner inherits its donor's warm-spec (spawned with the
        donor's resident buckets as ``--warm`` flags) and a bounded
        snapshot of the donor's cached results — so the ~1/N of groups
        that re-home onto it arrive on a replica that has already run
        their buckets and already holds their recent answers.
        """
        donor_name = self.router.preview_donor(name)
        warm = list(self.warm)
        donor = self.replicas.get(donor_name) if donor_name else None
        if donor is not None:
            try:
                _, health, _ = _http_json(donor.base_url + "/healthz",
                                          timeout=5.0)
                for bucket in (health.get("buckets") or {}):
                    spec = f"{bucket}:1"
                    if bucket not in {w.split(":")[0] for w in warm}:
                        warm.append(spec)
            except (OSError, ValueError):
                donor = None   # unreachable donor: join cold
        rep = self.spawn(name, env_extra=env_extra, warm=warm,
                         register=False)
        if donor is not None:
            shipped = self.ship_cache(donor.name, name)
            self._reg.inc("serve.fleet.prewarm_shipped", 1 if shipped
                          else 0)
        self.router.add_replica(name, rep.base_url)
        return rep

    def ship_cache(self, donor: str, target: str,
                   max_entries: int = SHIP_CACHE_MAX_ENTRIES) -> int:
        """Copy up to ``max_entries`` cached results donor -> target
        over the /cachez endpoints; returns the number shipped."""
        d, t = self.replicas[donor], self.replicas[target]
        try:
            _, listing, _ = _http_json(d.base_url + "/cachez",
                                       timeout=10.0)
        except (OSError, ValueError):
            return 0
        shipped = 0
        for key in (listing.get("keys") or [])[:max_entries]:
            try:
                status, res, _ = _http_json(
                    d.base_url + f"/cachez/{key}", timeout=10.0)
                if status != 200:
                    continue
                status, _, _ = _http_json(
                    t.base_url + "/cachez",
                    json.dumps(res).encode("utf-8"), timeout=10.0)
            # fcheck: ok=swallowed-error (one unshippable entry must
            # not abort the whole shipment; the cache_shipped counter
            # vs the donor's listing carries the shortfall)
            except (OSError, ValueError):
                continue
            if status == 200:
                shipped += 1
        if shipped:
            self._reg.inc("serve.fleet.cache_shipped", shipped)
        return shipped

    # -- chaos / retirement -------------------------------------------

    def kill(self, name: str, graceful: bool = True,
             timeout_s: float = 120.0) -> Optional[int]:
        """Stop a replica: SIGTERM (graceful=True — the rolling-drain
        path; returns its exit code, 0 = every admitted job finished)
        or SIGKILL (the crash drill; returns None immediately after
        reaping).  Either way the caller follows with
        :meth:`on_death` to cordon + inherit."""
        rep = self.replicas[name]
        if not rep.alive():
            return rep.proc.returncode
        if graceful:
            rep.proc.send_signal(signal.SIGTERM)
            try:
                return rep.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                _logger.warning("fcfleet: %s drain timed out; killing",
                                name)
                rep.proc.kill()
                rep.proc.wait(timeout=10)
                return rep.proc.returncode
        rep.proc.kill()
        rep.proc.wait(timeout=10)
        return None

    def on_death(self, name: str) -> Optional[str]:
        """A replica is gone: cordon it (re-home + replay its
        in-flight jobs) and tell the successor that inherits its
        groups to load its spilled cache file.  Returns the successor
        name (None when nothing could inherit)."""
        self.router.cordon(name, "replica process death")
        rep = self.replicas.get(name)
        successor = self._successor_of(name)
        if successor is None or rep is None:
            return None
        if os.path.exists(rep.cache_path):
            srep = self.replicas[successor]
            try:
                status, out, _ = _http_json(
                    srep.base_url + "/cachez/load",
                    json.dumps({"path": rep.cache_path}).encode("utf-8"),
                    timeout=30.0)
                if status == 200:
                    self._reg.inc("serve.fleet.cache_inherited",
                                  int(out.get("loaded", 0)))
                    for h in out.get("content_hashes") or ():
                        # re-point the content-hash index at the
                        # inheritor so fetch-on-miss can source from it
                        self.router.note_holder(str(h), successor)
                    _logger.info(
                        "fcfleet: %s inherited %s cached result(s) "
                        "from dead replica %s", successor,
                        out.get("loaded"), name)
            except (OSError, ValueError):
                self._reg.inc("serve.fleet.cache_inherit_failed")
        return successor

    def _successor_of(self, dead: str) -> Optional[str]:
        """The live replica that now owns the plurality of the dead
        replica's route-key assignments — the cache-inheritance
        target."""
        stats = self.router.fleet_stats()
        owned = {k for k, owner in (stats.get("assignments") or {}
                                    ).items() if owner == dead}
        excluded = frozenset({dead})
        for r in stats["replicas"]:
            if r["name"] == dead:
                # the poll loop usually cordons the dead replica before
                # on_death runs, and live traffic then overwrites its
                # _assignments entries with the new homes — the
                # cordon-time rehomed_keys snapshot is the authoritative
                # record of what it owned
                owned.update(r.get("rehomed_keys") or ())
            elif r["state"] == "cordoned":
                excluded |= {r["name"]}
        live = [r["name"] for r in stats["replicas"]
                if r["state"] == "up" and r["name"] != dead]
        if not live:
            return None
        if not owned:
            return live[0]
        counts: Dict[str, int] = {}
        for key in sorted(owned):
            try:
                # exclude every cordoned replica, not just the dead one:
                # the successor must be where live routing actually
                # sends these keys, or the inherited cache is useless
                new_owner = self.router.ring.route(key, excluded)
            except Exception:  # noqa: BLE001 — an all-cordoned ring has
                # no successor; cache inheritance is then moot
                return None
            counts[new_owner] = counts.get(new_owner, 0) + 1
        return max(sorted(counts), key=lambda n: counts[n])

    def snapshot_bundles(self, timeout_s: float = 30.0) -> List[str]:
        """SIGQUIT every live replica (fcflight: dump a post-mortem
        bundle, keep serving) and collect the bundle paths that
        appear.  A bundle counts only once its MANIFEST.json exists —
        the dump writes the manifest LAST, so a bare fresh directory
        is still mid-write and a collector that took it would skip it
        as a partial."""
        live = [r for r in self.replicas.values() if r.alive()]
        before = {r.name: set(r.bundles()) for r in live}
        for r in live:
            r.proc.send_signal(signal.SIGQUIT)
        deadline = time.monotonic() + timeout_s
        collected: List[str] = []
        pending = set(r.name for r in live)
        while pending and time.monotonic() < deadline:
            for r in live:
                if r.name not in pending:
                    continue
                fresh = {
                    b for b in set(r.bundles()) - before[r.name]
                    if os.path.isfile(os.path.join(b, "MANIFEST.json"))}
                if fresh:
                    collected += sorted(fresh)
                    pending.discard(r.name)
            if pending:
                time.sleep(0.2)
        return collected

    def all_bundles(self) -> List[str]:
        out: List[str] = []
        for r in self.replicas.values():
            out += r.bundles()
        return out

    def collect_bundles(self, dest_dir: Optional[str] = None,
                        snapshot: bool = True,
                        timeout_s: float = 30.0) -> Dict[str, List[str]]:
        """Gather EVERY replica's bundles into one directory — the
        fctrace incident-merge input.  ``snapshot=True`` first SIGQUITs
        the live replicas (:meth:`snapshot_bundles`) so the collection
        includes a fresh dump of each survivor; dead replicas
        contribute whatever their flight dirs already hold (the
        watchdog/death bundles written before they went).

        Each bundle lands as ``<replica>__<bundle_name>`` (the
        :data:`~fastconsensus_tpu_torch.obs.fleettrace.REPLICA_SEP` layout
        ``fleettrace render`` splits its replica tracks on); returns
        replica name -> collected paths.  Collection is copy-based so
        the replicas' own flight dirs stay intact for any later reader.
        """
        import shutil

        from fastconsensus_tpu_torch.obs import flight as obs_flight
        from fastconsensus_tpu_torch.obs.fleettrace import REPLICA_SEP

        if snapshot:
            self.snapshot_bundles(timeout_s=timeout_s)
        dest = os.path.abspath(dest_dir or os.path.join(
            self.workdir, "collected_bundles"))
        os.makedirs(dest, exist_ok=True)
        out: Dict[str, List[str]] = {}
        for name, rep in sorted(self.replicas.items()):
            collected: List[str] = []
            for bundle in rep.bundles():
                if not os.path.isfile(os.path.join(bundle,
                                                   "MANIFEST.json")):
                    continue   # manifest-less partial: incomplete dump
                target = os.path.join(
                    dest, f"{name}{REPLICA_SEP}"
                          f"{os.path.basename(bundle)}")
                try:
                    if not os.path.isdir(target):
                        shutil.copytree(bundle, target)
                    collected.append(target)
                # fcheck: ok=swallowed-error (one uncopyable bundle
                # must not abort the fleet collection; the per-replica
                # counts in the return value carry the shortfall)
                except OSError:
                    continue
            out[name] = collected
            self._reg.inc("serve.fleet.bundles_collected",
                          len(collected))
            obs_flight.record("fleet_bundle", replica=name,
                              n_bundles=len(collected))
        return out

    # -- router front end ---------------------------------------------

    def start_router(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Start the router's poll loop + HTTP front end; returns the
        fleet's base URL."""
        import threading

        self.router.start()
        self._httpd = make_router_server(self.router, host, port)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fcfleet-http",
            daemon=True)
        self._http_thread.start()
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def stop_all(self, graceful: bool = True) -> Dict[str, Optional[int]]:
        """Retire the fleet: stop the router front end, then drain (or
        kill) every live replica; returns name -> exit code."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.router.stop()
        codes: Dict[str, Optional[int]] = {}
        for name, rep in self.replicas.items():
            if rep.alive():
                codes[name] = self.kill(name, graceful=graceful)
            else:
                codes[name] = rep.proc.returncode
        return codes


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m fastconsensus_tpu_torch.serve.fleet`` — run a local
    fleet: N replicas + the router, drained as a fleet on
    SIGTERM/SIGINT.  Replicas serve on CUDA unless ``--replica-arg``
    says otherwise (``--replica-arg=--device --replica-arg=cpu``)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.serve.fleet",
        description="fcfleet: N fcserve replicas behind a "
                    "consistent-hash router")
    p.add_argument("--replicas", type=int, default=2, metavar="N",
                   help="fleet size (default 2)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8770,
                   help="router port (0 picks a free one; default 8770)")
    p.add_argument("--workdir", default="./fcfleet",
                   help="per-replica cache/flight/log directory")
    p.add_argument("--warm", action="append", default=[],
                   metavar="BUCKET[:B]",
                   help="pre-warm spec passed to every replica")
    p.add_argument("--cache-spill-s", type=float, default=5.0,
                   metavar="S",
                   help="periodic replica cache spill interval "
                        "(default 5; 0 disables)")
    p.add_argument("--replica-arg", action="append", default=[],
                   metavar="ARG", help="extra flag passed to every "
                                       "replica CLI; repeatable (CPU "
                                       "replicas: --replica-arg=--device "
                                       "--replica-arg=cpu)")
    args = p.parse_args(argv)
    if args.replicas < 1:
        print("error: --replicas must be >= 1", file=sys.stderr)
        return 2
    fleet = FleetManager(args.workdir, warm=args.warm,
                         replica_args=args.replica_arg,
                         cache_spill_s=args.cache_spill_s or None)
    import threading

    stop = threading.Event()
    try:
        for i in range(args.replicas):
            name = f"r{i}"
            print(f"[fcfleet] spawning replica {name}...",
                  file=sys.stderr, flush=True)
            fleet.spawn(name)
        url = fleet.start_router(args.host, args.port)
        print(f"[fcfleet] routing {args.replicas} replica(s) at {url}",
              file=sys.stderr, flush=True)
    except (ReplicaSpawnError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        fleet.stop_all(graceful=False)
        return 2

    def _on_signal(signum, frame) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    stop.wait()
    print("[fcfleet] draining fleet...", file=sys.stderr, flush=True)
    codes = fleet.stop_all(graceful=True)
    bad = {n: c for n, c in codes.items() if c not in (0, None)}
    for name, code in sorted(codes.items()):
        print(f"[fcfleet] {name}: exit {code}", file=sys.stderr,
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
