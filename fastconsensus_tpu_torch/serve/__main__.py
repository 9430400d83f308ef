"""CLI: ``python -m fastconsensus_tpu_torch.serve`` — run one fcserve
instance of the port, with the flags of the reference's serve entry
point (``fastconsensus_tpu/serve/__main__.py``) and ``--device``
(default ``cuda``: one worker per GPU; without CUDA the server exits 2
unless given ``--device cpu``).  ``--huge-devices K --chip-max-edges E``
reserve the last K devices as the huge tier's mesh group;
``--chip-max-edges auto`` derives E from the footprint memory model
(``analysis/footprint.derive_chip_ceiling``) at the card's memory or at
``--hbm-bytes``, which also holds an explicit E to the model.

Binds the stdlib HTTP front end, launches the device workers, and waits
for SIGTERM/SIGINT; on signal the server **drains**: admissions close
(submits answer 503), every already-admitted job finishes, the server's
own fcobs trace artifacts are exported (``--trace-dir``), and the
process exits 0.  A non-zero exit means the drain timed out with work
still in flight.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    from fastconsensus_tpu_torch.serve.server import ServeConfig

    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.serve",
        description="fcserve: long-lived consensus-clustering service "
                    "on a GPU (shape-bucketed batching, content-addressed "
                    "result cache, admission control).")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default: loopback only)")
    p.add_argument("--port", type=int, default=8765,
                   help="TCP port (0 picks a free one; default 8765)")
    p.add_argument("--queue-depth", type=int, default=d.queue_depth,
                   help="admission bound: jobs beyond this are rejected "
                        f"with HTTP 429 (default {d.queue_depth})")
    p.add_argument("--cache-entries", type=int, default=d.cache_entries,
                   help="result-cache LRU capacity "
                        f"(default {d.cache_entries})")
    p.add_argument("--cache-ttl", type=float, default=d.cache_ttl_s,
                   metavar="SECONDS",
                   help="result-cache TTL "
                        f"(default {d.cache_ttl_s:.0f}s)")
    p.add_argument("--max-nodes", type=int, default=d.max_nodes,
                   help="largest admissible graph, nodes (HTTP 413 above)")
    p.add_argument("--max-edges", type=int, default=d.max_edges,
                   help="largest admissible graph, edges (HTTP 413 above)")
    p.add_argument("--drain-timeout", type=float, default=d.drain_timeout_s,
                   metavar="SECONDS",
                   help="max seconds to finish admitted work on SIGTERM "
                        f"(default {d.drain_timeout_s:.0f})")
    p.add_argument("--max-batch", type=int, default=d.max_batch,
                   metavar="B",
                   help="coalesce up to B queued same-bucket jobs into "
                        "one batched device call (executed at ladder "
                        "rungs 1/2/4/8; 1 disables coalescing; default "
                        f"{d.max_batch})")
    p.add_argument("--warm", action="append", default=[],
                   metavar="BUCKET[:B]",
                   help="pre-warm a bucket before serving: drive probe "
                        "graphs through its solo path and, with :B, the "
                        "batch ladder up to rung B (a cold worker builds "
                        "its kernels there); repeatable")
    p.add_argument("--warm-config", type=str, default=None,
                   metavar="JSON",
                   help="ConsensusConfig overrides for --warm probes, "
                        "e.g. '{\"n_p\": 50, \"algorithm\": \"leiden\"}' "
                        "(default: louvain with its default tau)")
    p.add_argument("--cache-file", type=str, default=None, metavar="PATH",
                   help="persist the result cache across restarts: "
                        "loaded at startup, spilled (npz) on graceful "
                        "drain — a restarted server answers repeats of "
                        "pre-restart work without touching the device")
    p.add_argument("--cache-spill-s", type=float, default=None,
                   metavar="SECONDS",
                   help="ALSO spill --cache-file every SECONDS while "
                        "serving (skipped when nothing changed) so a "
                        "crashed replica's cache survives for fleet "
                        "inheritance (serve/fleet.py); default: drain-"
                        "time only")
    p.add_argument("--device", type=str, default=d.device,
                   help="torch device type to serve on: cuda (one worker "
                        "per GPU) or cpu (default: cuda; without CUDA "
                        "the server exits 2 rather than fall back)")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="run N workers: the first N GPUs (default: all of "
                        "them), or N workers sharing the CPU (default 1). "
                        "Same-bucket traffic sticks to the worker that "
                        "first ran the bucket (serve/scheduler.py)")
    p.add_argument("--huge-devices", type=int, default=d.huge_devices,
                   metavar="K",
                   help="reserve the last K devices as a mesh group for "
                        "the huge tier (graphs past --chip-max-edges run "
                        "edge-sharded across it; default "
                        f"{d.huge_devices} = tier off)")
    p.add_argument("--chip-max-edges", default=d.chip_max_edges,
                   metavar="E",
                   help="single-chip bucket ceiling: buckets with edge "
                        "class > E route to the huge tier (requires "
                        "--huge-devices >= 1).  'auto' derives the "
                        "largest ladder edge class whose every kind fits "
                        "one card from the footprint memory model "
                        "(analysis/footprint.py)")
    p.add_argument("--hbm-bytes", type=int, default=None, metavar="BYTES",
                   help="per-card memory budget for the footprint model "
                        "(default: the serving card's total memory; on "
                        "--device cpu the model's synthetic 24 GiB); with "
                        "an integer --chip-max-edges, refuse a ceiling "
                        "the model says would run out of memory")
    p.add_argument("--spill-backlog", type=int, default=d.spill_backlog,
                   metavar="J",
                   help="sticky-affinity spill threshold: a bucket's "
                        "work leaves its home device only when more "
                        "than J jobs are queued there (default "
                        f"{d.spill_backlog})")
    p.add_argument("--hold-ms", type=float, default=None, metavar="MS",
                   help="cap on the adaptive hold-for-coalesce window "
                        "(serve/shaping.py): pop_batch may wait up to "
                        "MS ms — never past the tightest queued "
                        "deadline's slack — for predicted same-bucket "
                        "arrivals to fill a larger batch rung "
                        "(default 50; 0 disables holding)")
    p.add_argument("--no-edf", action="store_true",
                   help="order the admission queue FIFO within a "
                        "priority instead of earliest-deadline-first")
    p.add_argument("--no-hold", action="store_true",
                   help="disable the hold-for-coalesce window "
                        "(pop_batch never waits — the pre-fcshape "
                        "posture)")
    p.add_argument("--no-shed", action="store_true",
                   help="disable deadline-aware shedding (jobs that "
                        "provably cannot meet their SLO at the current "
                        "depth are queued anyway; 429s still carry the "
                        "derived Retry-After)")
    p.add_argument("--no-pin-sizing", action="store_true",
                   help="do not set the reference's serving env pin "
                        "FCTPU_DETECT_CALL_MEMBERS=0 (on the port it only "
                        "sizes --detect-cache chunks, which serving never "
                        "uses; see ServeConfig.pin_sizing)")
    p.add_argument("--trace-dir", type=str, default=None, metavar="DIR",
                   help="export the server's fcobs trace artifacts "
                        "(fcserve_trace.json + .jsonl) to DIR on drain")
    p.add_argument("--flight-dir", type=str, default=None, metavar="DIR",
                   help="where fcflight post-mortem bundles land "
                        "(SIGQUIT / watchdog trip / worker death / "
                        "drain timeout; default: FCTPU_FLIGHT_DIR, "
                        "else ./fcflight)")
    wd = ServeConfig().watchdog
    p.add_argument("--watchdog-k", type=float, default=wd.k, metavar="K",
                   help="hang watchdog: a device call is suspect past "
                        "K x the bucket's measured service p95 "
                        f"(default {wd.k:g})")
    p.add_argument("--watchdog-floor-s", type=float, default=wd.floor_s,
                   metavar="S",
                   help="hang watchdog: never trip below S seconds "
                        f"elapsed (default {wd.floor_s:g})")
    p.add_argument("--no-watchdog", action="store_true",
                   help="disable the hang watchdog (no suspect "
                        "detection, no cordon-on-stall)")
    p.add_argument("--watchdog-observe-only", action="store_true",
                   help="watchdog trips count and write bundles but "
                        "never cordon the worker (first-deploy posture)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress startup/drain log lines")
    return p


def _device_hbm_bytes(device: str) -> Optional[int]:
    """The serving cards' memory: the smallest ``total_memory`` of the
    visible CUDA devices, None for ``--device cpu`` (the caller then takes
    the model's synthetic budget, as the reference does on its CPU
    backends).  The total, not ``mem_get_info``'s free bytes: the ceiling
    is a property of the deployment and must not move with whatever else
    happens to be resident at startup (replicas sharing a card pass
    their share with --hbm-bytes).  Raises RuntimeError when CUDA is
    asked for and the card cannot be read: a CUDA server never falls
    back to the synthetic budget."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this PyTorch build or machine; pass "
            "--device cpu to serve on the CPU")
    return min(torch.cuda.get_device_properties(i).total_memory
               for i in range(torch.cuda.device_count()))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # imports deferred so -h never pays the torch/engine import
    from fastconsensus_tpu_torch.serve.server import (ConsensusService,
                                                      ServeConfig,
                                                      make_http_server)

    def say(msg: str) -> None:
        if not args.quiet:
            print(f"[fcserve] {msg}", file=sys.stderr, flush=True)

    logging.basicConfig(level=logging.WARNING)
    warm_config = None
    if args.warm_config:
        import json

        try:
            warm_config = json.loads(args.warm_config)
            if not isinstance(warm_config, dict):
                raise ValueError("expected a JSON object")
        except ValueError as e:
            print(f"error: bad --warm-config: {e}", file=sys.stderr)
            return 2
    if args.max_batch < 1:
        print("error: --max-batch must be >= 1", file=sys.stderr)
        return 2
    if args.cache_spill_s is not None:
        if args.cache_spill_s <= 0:
            print("error: --cache-spill-s must be > 0", file=sys.stderr)
            return 2
        if not args.cache_file:
            print("error: --cache-spill-s needs --cache-file (there is "
                  "nowhere to spill to)", file=sys.stderr)
            return 2
    chip_max_edges = args.chip_max_edges
    if isinstance(chip_max_edges, str):
        if chip_max_edges.lower() == "auto":
            chip_max_edges = "auto"
        else:
            try:
                chip_max_edges = int(chip_max_edges)
            except ValueError:
                print(f"error: --chip-max-edges {chip_max_edges!r}: "
                      f"expected an integer or 'auto'", file=sys.stderr)
                return 2
    if chip_max_edges is not None and args.huge_devices < 1:
        print("error: --chip-max-edges needs --huge-devices >= 1 (the "
              "huge tier is what runs graphs past the ceiling)",
              file=sys.stderr)
        return 2
    if args.huge_devices >= 1 and chip_max_edges is None:
        print("error: --huge-devices without --chip-max-edges reserves "
              "a mesh group no bucket can ever route to; set the "
              "single-chip ceiling too", file=sys.stderr)
        return 2
    if chip_max_edges == "auto" or (chip_max_edges is not None
                                    and args.hbm_bytes is not None):
        # the footprint memory model: derive the largest ladder bucket
        # whose worst case fits one card, and hold an explicit ceiling to
        # the same standard (failing at startup beats running out of
        # memory on first traffic)
        from fastconsensus_tpu_torch.analysis import footprint

        budget = args.hbm_bytes
        if budget is None:
            try:
                budget = _device_hbm_bytes(args.device) or \
                    footprint.CHIP_HBM_BYTES_DEFAULT
            except RuntimeError as e:
                print(f"error: --chip-max-edges auto needs the card's "
                      f"memory: {e}", file=sys.stderr)
                return 2
        spec = footprint.SurfaceSpec(
            max_nodes=args.max_nodes, max_edges=args.max_edges,
            max_batch=args.max_batch,
            n_p=int((warm_config or {}).get("n_p", 20)),
            algorithm=str((warm_config or {}).get("algorithm",
                                                  "louvain")),
            device=args.device)
        say(f"deriving the single-chip ceiling from the footprint "
            f"model (budget {budget / 2**30:.1f} GiB)...")
        derived = footprint.derive_chip_ceiling(budget, spec)
        if derived is None:
            print(f"error: no ladder bucket fits --hbm-bytes {budget} "
                  f"under this posture; lower --max-nodes/--max-batch "
                  f"or raise the budget", file=sys.stderr)
            return 2
        if chip_max_edges == "auto":
            if derived >= footprint.grid_up(
                    args.max_edges, footprint.MIN_EDGE_CLASS):
                # the whole admissible ladder fits one card, so nothing
                # would ever route to the mandatory huge tier
                print(f"error: --chip-max-edges auto derived {derived} "
                      f"edges, which covers every admissible bucket "
                      f"(--max-edges {args.max_edges}); the reserved "
                      f"--huge-devices group would idle forever — drop "
                      f"the huge tier, raise --max-edges, or set an "
                      f"explicit lower ceiling", file=sys.stderr)
                return 2
            chip_max_edges = derived
            say(f"--chip-max-edges auto -> {derived} edges")
        elif chip_max_edges > derived:
            print(f"error: --chip-max-edges {chip_max_edges} exceeds "
                  f"the derived single-chip ceiling {derived} for "
                  f"--hbm-bytes {budget}: buckets between them would "
                  f"OOM on first traffic (footprint model)",
                  file=sys.stderr)
            return 2
    from fastconsensus_tpu_torch.serve.shaping import ShapingConfig

    shaping_defaults = ShapingConfig()
    if args.hold_ms is not None and args.hold_ms < 0:
        print("error: --hold-ms must be >= 0", file=sys.stderr)
        return 2
    shaping = ShapingConfig(
        edf=not args.no_edf,
        hold=not args.no_hold and args.hold_ms != 0,
        shed=not args.no_shed,
        max_hold_s=(args.hold_ms / 1000.0 if args.hold_ms
                    else shaping_defaults.max_hold_s))
    from fastconsensus_tpu_torch.serve.watchdog import WatchdogConfig

    wd_defaults = WatchdogConfig()
    watchdog = WatchdogConfig(
        enabled=not args.no_watchdog,
        k=args.watchdog_k,
        floor_s=args.watchdog_floor_s,
        min_history=wd_defaults.min_history,
        poll_s=wd_defaults.poll_s,
        cordon=not args.watchdog_observe_only)
    try:
        watchdog.validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = ServeConfig(queue_depth=args.queue_depth,
                      cache_entries=args.cache_entries,
                      cache_ttl_s=args.cache_ttl,
                      max_nodes=args.max_nodes,
                      max_edges=args.max_edges,
                      drain_timeout_s=args.drain_timeout,
                      pin_sizing=not args.no_pin_sizing,
                      trace_dir=args.trace_dir,
                      max_batch=args.max_batch,
                      cache_path=args.cache_file,
                      cache_spill_s=args.cache_spill_s,
                      prewarm=tuple(args.warm),
                      prewarm_config=warm_config,
                      device=args.device,
                      devices=args.devices,
                      huge_devices=args.huge_devices,
                      chip_max_edges=chip_max_edges,
                      spill_backlog=args.spill_backlog,
                      shaping=shaping,
                      watchdog=watchdog,
                      flight_dir=args.flight_dir)
    from fastconsensus_tpu_torch.serve import faultinject

    try:
        # fcfault: arm the FCTPU_FAULT_INJECT site (if any) BEFORE the
        # pool starts, so worker threads capture the injected callable;
        # a bad site id fails startup loudly instead of injecting
        # nothing silently
        site = faultinject.maybe_install_from_env()
    except (ValueError, ImportError, AttributeError) as e:
        print(f"error: bad {faultinject.ENV_VAR}: {e}", file=sys.stderr)
        return 2
    if site is not None:
        say(f"fault injection armed: {site}")
    try:
        service = ConsensusService(cfg).start()
    except (ValueError, RuntimeError) as e:
        # RuntimeError: the device cannot be had (no CUDA without
        # --device cpu), which never falls back
        print(f"error: {e}", file=sys.stderr)
        return 2
    pool = service.pool
    say(f"worker pool: {len(pool.chip_workers)} chip worker(s)"
        + (f" + 1 mesh group of {len(pool.mesh_workers[0].devices)}"
           f" device(s) (huge tier, bucket ceiling "
           f"{cfg.chip_max_edges} edges)" if pool.mesh_workers else "")
        + f" on {service.device.type}")
    if args.warm:
        say(f"pre-warming {len(args.warm)} bucket(s): "
            f"{', '.join(args.warm)}")
    try:
        httpd = make_http_server(service, args.host, args.port)
    except OSError as e:
        print(f"error: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = httpd.server_address[:2]
    say(f"listening on http://{host}:{port} "
        f"(queue depth {cfg.queue_depth}, cache {cfg.cache_entries} "
        f"entries / {cfg.cache_ttl_s:.0f}s TTL)")

    stop = threading.Event()

    def _on_signal(signum, frame) -> None:
        say(f"signal {signum}: draining")
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    if hasattr(signal, "SIGQUIT"):
        # fcflight: SIGQUIT = "dump a post-mortem bundle and KEEP
        # serving" — the live-incident snapshot (contrast SIGTERM's
        # drain).  Routed through the service so the bundle carries the
        # full serving state and /healthz learns the path.
        def _on_sigquit(signum, frame) -> None:
            path = service.write_bundle("sigquit")
            say(f"SIGQUIT: flight bundle "
                f"{'failed' if path is None else path}")

        signal.signal(signal.SIGQUIT, _on_sigquit)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   name="fcserve-http", daemon=True)
    http_thread.start()
    stop.wait()
    # Drain order: stop admissions FIRST (in-flight handler threads get
    # 503 from the closed queue), then stop the listener, then finish
    # every admitted job.
    service.begin_drain()
    httpd.shutdown()
    ok = service.drain(cfg.drain_timeout_s)
    httpd.server_close()
    say("drained cleanly" if ok
        else f"drain timed out after {cfg.drain_timeout_s:.0f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
