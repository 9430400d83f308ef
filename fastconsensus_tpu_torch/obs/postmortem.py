"""fcflight post-mortem bundles: one self-contained incident directory.

When a serving replica wedges (hang-watchdog trip), dies mid-batch
(unhandled worker exception), refuses to drain, or an operator sends
SIGQUIT, the process dumps everything an incident responder needs into
ONE directory — no live process required to read it:

================  =====================================================
``MANIFEST.json`` schema/reason/timestamps/pid/thread names + the
                  section list (always written LAST, so a manifest's
                  presence means the bundle is complete)
``flight.json``   the flight-recorder snapshot (obs/flight.py): every
                  thread's bounded event ring
``stacks.txt``    ``faulthandler`` tracebacks of every thread — where
                  each one actually was, including a thread stuck
                  inside a device call
``counters.json`` the fcobs counter/gauge/series snapshot
``latency.json``  the fclat histogram registry snapshot (per-phase
                  distributions + exemplars)
``<name>.json``   caller sections: the serving layer adds ``jobs``
                  (in-flight table with per-job phase timelines),
                  ``pool``/``scheduler``/``queue`` describes and
                  ``config`` (the resolved ServeConfig); ``cli.py
                  --dump-on-signal`` adds ``run`` (consensus round +
                  policy state)
================  =====================================================

The reader is jax-free by construction (stdlib imports only, and the
package root is PEP-562 lazy, so ``python -m
fastconsensus_tpu_torch.obs.postmortem`` never touches jax — it must work on
the box where jax is exactly what is broken):

    python -m fastconsensus_tpu_torch.obs.postmortem render BUNDLE_DIR
    python -m fastconsensus_tpu_torch.obs.postmortem diff OLD_DIR NEW_DIR

``render`` prints the manifest, thread stacks, counter highlights, the
in-flight jobs table (id / state / bucket / per-phase timeline) and the
tail of the merged flight timeline; ``diff`` prints counter deltas and
per-kind flight-event deltas between two bundles of one process.

Bundle triggers: :func:`install_signal_handler` wires SIGQUIT (and any
other signal) to a collector callback; ``utils/supervise.py`` sends
exactly that SIGQUIT before a stall-SIGKILL and collects the bundle
path into its rotated artifact chain.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

SCHEMA = 1
BUNDLE_PREFIX = "fcflight"
ENV_DIR = "FCTPU_FLIGHT_DIR"

# process-lifetime bundle counter: makes names unique within one second
# and gives "how many bundles has this process written" for telemetry
_seq_lock = threading.Lock()
_seq = 0


def default_bundle_dir() -> str:
    """Where bundles land when the caller does not say: the
    ``FCTPU_FLIGHT_DIR`` env var, else ``./fcflight``."""
    return os.environ.get(ENV_DIR) or os.path.join(".", "fcflight")


def bundles_written() -> int:
    """How many bundles this process has written (telemetry)."""
    with _seq_lock:
        return _seq


def _json_default(obj: Any) -> str:
    return repr(obj)


def write_bundle(reason: str, sections: Optional[Dict[str, Any]] = None,
                 base_dir: Optional[str] = None) -> str:
    """Write one bundle directory and return its path.

    ``sections`` maps section name -> JSON-serializable payload; the
    flight/counters/latency/stacks sections are collected here so every
    trigger site gets them for free.  Never raises on a serialization
    problem: a section that cannot serialize is written as its repr —
    an incident dump that throws during the incident is worse than a
    lossy one.
    """
    global _seq
    with _seq_lock:
        _seq += 1
        seq = _seq
    base = base_dir or default_bundle_dir()
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    name = f"{BUNDLE_PREFIX}_{stamp}_p{os.getpid()}_n{seq}_{reason}"
    out_dir = os.path.join(base, name)
    os.makedirs(out_dir, exist_ok=True)

    # local imports: stdlib-only siblings, deferred so a half-broken
    # interpreter (the incident case) fails per-section, not wholesale
    auto: Dict[str, Any] = {}
    try:
        from fastconsensus_tpu_torch.obs import flight as _flight
        auto["flight"] = _flight.get_flight_recorder().snapshot()
    except Exception as exc:  # noqa: BLE001 — see docstring
        auto["flight"] = {"error": repr(exc)}
    try:
        from fastconsensus_tpu_torch.obs import counters as _counters
        auto["counters"] = _counters.get_registry().snapshot()
    except Exception as exc:  # noqa: BLE001
        auto["counters"] = {"error": repr(exc)}
    try:
        from fastconsensus_tpu_torch.obs import latency as _latency
        auto["latency"] = _latency.get_latency_registry().snapshot()
    except Exception as exc:  # noqa: BLE001
        auto["latency"] = {"error": repr(exc)}

    written: List[str] = []
    for sec_name, payload in {**auto, **(sections or {})}.items():
        path = os.path.join(out_dir, f"{sec_name}.json")
        try:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, default=_json_default)
                fh.write("\n")
            written.append(f"{sec_name}.json")
        # fcheck: ok=swallowed-error (a post-mortem writer that
        # throws mid-incident destroys the evidence it exists to
        # save: lossy beats throwing, and the manifest records
        # which sections made it)
        except Exception:  # noqa: BLE001 — lossy beats throwing
            continue

    try:
        with open(os.path.join(out_dir, "stacks.txt"), "w",
                  encoding="utf-8") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
        written.append("stacks.txt")
    # fcheck: ok=swallowed-error (same lossy-beats-throwing contract
    # as the sections above; stacks.txt is the most failure-prone
    # section — faulthandler under a dying interpreter)
    except Exception:  # noqa: BLE001
        pass

    manifest = {
        "schema": SCHEMA,
        "tool": "fcflight-bundle",
        "reason": reason,
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "time_unix": round(time.time(), 3),
        "time_mono": round(time.monotonic(), 6),
        "pid": os.getpid(),
        "seq": seq,
        "argv": list(sys.argv),
        "threads": sorted(t.name for t in threading.enumerate()),
        "sections": sorted(written),
    }
    # the manifest lands LAST: its presence marks the bundle complete
    # (a SIGKILL racing the dump leaves a manifest-less partial dir a
    # collector can recognize and skip)
    with open(os.path.join(out_dir, "MANIFEST.json"), "w",
              encoding="utf-8") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    return out_dir


def list_bundles(base_dir: Optional[str] = None) -> List[str]:
    """Complete bundle directories under ``base_dir`` (manifest
    present), sorted oldest first by manifest timestamp."""
    base = base_dir or default_bundle_dir()
    out = []
    try:
        entries = sorted(os.listdir(base))
    except OSError:
        return []
    for entry in entries:
        path = os.path.join(base, entry)
        if entry.startswith(BUNDLE_PREFIX + "_") and \
                os.path.isfile(os.path.join(path, "MANIFEST.json")):
            out.append(path)
    return out


def install_signal_handler(collect: Optional[
        Callable[[], Dict[str, Any]]] = None,
        base_dir: Optional[str] = None,
        signum: int = signal.SIGQUIT,
        reason: str = "sigquit",
        on_written: Optional[Callable[[str], None]] = None) -> Any:
    """Install a signal handler that writes a bundle and returns to the
    interrupted program (the process keeps running — SIGQUIT becomes
    "dump state", not "die").  ``collect`` supplies extra sections at
    dump time; ``on_written`` observes the bundle path (logging,
    ``/healthz``).  Returns the previous handler."""
    def _handler(sig: int, frame: Any) -> None:  # noqa: ARG001
        sections: Dict[str, Any] = {}
        if collect is not None:
            try:
                sections = collect() or {}
            except Exception as exc:  # noqa: BLE001 — dump anyway
                sections = {"collect_error": {"error": repr(exc)}}
        path = write_bundle(reason, sections, base_dir=base_dir)
        if on_written is not None:
            try:
                on_written(path)
            except Exception:  # noqa: BLE001
                pass

    return signal.signal(signum, _handler)


# ---------------------------------------------------------------------
# jax-free reader: render / diff
# ---------------------------------------------------------------------

def _load(bundle_dir: str, section: str) -> Optional[Any]:
    path = os.path.join(bundle_dir, section)
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def _fmt_phases(phases: Optional[Dict[str, Any]]) -> str:
    if not phases:
        return "-"
    return " ".join(f"{k}={1000.0 * float(v):.1f}ms"
                    for k, v in phases.items() if v is not None)


def render(bundle_dir: str, tail: int = 40) -> str:
    """Human-readable bundle summary (the ``render`` subcommand)."""
    from fastconsensus_tpu_torch.obs.flight import merge_events

    manifest = _load(bundle_dir, "MANIFEST.json")
    if manifest is None:
        return f"{bundle_dir}: no MANIFEST.json — not a complete bundle"
    lines = [
        f"== fcflight bundle {os.path.basename(bundle_dir)} ==",
        f"reason   : {manifest.get('reason')}",
        f"written  : {manifest.get('wall_time')} (pid "
        f"{manifest.get('pid')}, bundle #{manifest.get('seq')})",
        f"threads  : {len(manifest.get('threads', []))} "
        f"({', '.join(manifest.get('threads', [])[:8])}"
        f"{', ...' if len(manifest.get('threads', [])) > 8 else ''})",
        f"sections : {', '.join(manifest.get('sections', []))}",
    ]
    config = _load(bundle_dir, "config.json")
    if config:
        lines.append(f"config   : {json.dumps(config, sort_keys=True)}")
    jobs = _load(bundle_dir, "jobs.json")
    if jobs:
        rows = jobs.get("jobs", jobs) if isinstance(jobs, dict) else jobs
        live = [j for j in rows
                if j.get("state") in ("queued", "running")]
        lines.append("")
        lines.append(f"-- jobs: {len(rows)} tracked, {len(live)} "
                     f"in flight --")
        for j in live or rows[-5:]:
            lines.append(
                f"  {j.get('job_id', '?')} state={j.get('state')} "
                f"bucket={j.get('bucket', '-')} "
                f"phases: {_fmt_phases(j.get('phases_s'))}")
    watchdog = _load(bundle_dir, "watchdog.json")
    if watchdog:
        lines.append("")
        lines.append(f"-- watchdog: {json.dumps(watchdog, sort_keys=True)}")
    counters = _load(bundle_dir, "counters.json")
    if counters and isinstance(counters.get("counters"), dict):
        lines.append("")
        lines.append("-- counters (serve.* / quality.*) --")
        for key, val in sorted(counters["counters"].items()):
            if key.startswith(("serve.", "quality.")):
                lines.append(f"  {key} = {val}")
    flight = _load(bundle_dir, "flight.json")
    if flight:
        events = merge_events(flight)
        lines.append("")
        lines.append(f"-- flight timeline: {len(events)} event(s), "
                     f"{flight.get('dropped', 0)} overwritten; "
                     f"last {min(tail, len(events))} --")
        for event in events[-tail:]:
            extra = {k: v for k, v in event.items()
                     if k not in ("ts", "kind", "thread", "job")}
            job = f" job={event['job']}" if "job" in event else ""
            extra_s = f" {extra}" if extra else ""
            lines.append(
                f"  [{event.get('ts', 0.0):.6f}] "
                f"{event.get('thread', '?')}: "
                f"{event.get('kind')}{job}{extra_s}")
    stacks_path = os.path.join(bundle_dir, "stacks.txt")
    if os.path.isfile(stacks_path):
        with open(stacks_path, encoding="utf-8") as fh:
            stacks = fh.read().rstrip()
        lines.append("")
        lines.append("-- thread stacks (faulthandler) --")
        lines.append(stacks)
    return "\n".join(lines)


def _event_kinds(flight: Optional[Dict[str, Any]]) -> Dict[str, int]:
    from fastconsensus_tpu_torch.obs.flight import merge_events

    if not flight:
        return {}
    counts: Dict[str, int] = {}
    for event in merge_events(flight):
        kind = str(event.get("kind"))
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def diff(old_dir: str, new_dir: str) -> str:
    """Counter and flight-event deltas between two bundles (the
    ``diff`` subcommand): what happened between two dumps of one
    process — e.g. a pre-incident SIGQUIT bundle vs the watchdog's."""
    lines = [f"== bundle diff: {os.path.basename(old_dir)} -> "
             f"{os.path.basename(new_dir)} =="]
    old_c = (_load(old_dir, "counters.json") or {}).get("counters") or {}
    new_c = (_load(new_dir, "counters.json") or {}).get("counters") or {}
    deltas = {k: new_c.get(k, 0) - old_c.get(k, 0)
              for k in sorted(set(old_c) | set(new_c))
              if new_c.get(k, 0) != old_c.get(k, 0)}
    lines.append(f"-- counters: {len(deltas)} changed --")
    for key, dv in deltas.items():
        lines.append(f"  {key} {old_c.get(key, 0)} -> {new_c.get(key, 0)}"
                     f" ({'+' if dv >= 0 else ''}{dv})")
    old_k = _event_kinds(_load(old_dir, "flight.json"))
    new_k = _event_kinds(_load(new_dir, "flight.json"))
    lines.append("-- flight events by kind (ring-windowed counts) --")
    for kind in sorted(set(old_k) | set(new_k)):
        lines.append(f"  {kind}: {old_k.get(kind, 0)} -> "
                     f"{new_k.get(kind, 0)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m fastconsensus_tpu_torch.obs.postmortem",
        description="fcflight post-mortem bundle reader (jax-free)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="summarize one bundle")
    pr.add_argument("bundle", help="bundle directory")
    pr.add_argument("--tail", type=int, default=40,
                    help="flight-timeline events to show (default 40)")
    pd = sub.add_parser("diff", help="delta between two bundles")
    pd.add_argument("old", help="earlier bundle directory")
    pd.add_argument("new", help="later bundle directory")
    args = p.parse_args(argv)
    if args.cmd == "render":
        if not os.path.isfile(os.path.join(args.bundle, "MANIFEST.json")):
            print(f"{args.bundle}: no MANIFEST.json — not a complete "
                  f"fcflight bundle", file=sys.stderr)
            return 2
        print(render(args.bundle, tail=args.tail))
        return 0
    print(diff(args.old, args.new))
    return 0


if __name__ == "__main__":
    sys.exit(main())
