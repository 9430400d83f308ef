"""fcobs device attribution: pair host spans with ``torch.profiler``.

Host spans (obs/tracer.py) answer *where the driver's wall clock went*;
this module makes the same span names show up inside the profiler's
timeline, beside the card's kernels, so a Perfetto view distinguishes
"the `detect` span is slow because the kernels are slow" from "the span
is slow because the host sat in launch overhead".  Three pieces:

* **Annotations** — an annotating
  :class:`~fastconsensus_tpu_torch.obs.tracer.Tracer` (``Tracer(annotate=
  True)``) checks :func:`available` once and wraps every span in a
  ``torch.profiler.record_function`` range of the same name (a round's
  step span as ``"round#<step>"``).
* **Session** — :class:`ProfilerSession` runs ``torch.profiler.profile``
  over a region (the CPU activity, plus CUDA when the session's device is
  a CUDA device), writes its Chrome trace into ``log_dir`` on exit, and
  remembers *when* the profiler started on the host's wall and
  ``perf_counter`` clocks, which is what timeline merging needs.
* **Merge** — :func:`merge_profiler_trace` grafts that Chrome trace into
  an fcobs Perfetto blob, shifting its timestamps onto the fcobs clock,
  so ``cli.py --trace --profile-dir`` yields ONE ``ui.perfetto.dev``-
  loadable file with aligned host-span and kernel tracks.

Clocks: the profiler's ``ts`` are microseconds after the trace's
``baseTimeNanoseconds`` on the wall clock (an export without that key
carries absolute wall-clock microseconds).  The session captures
``time.time()`` and ``time.perf_counter()`` together before the profiler
starts, which maps a wall-clock microsecond onto the tracer's
``perf_counter``-based clock.

Every entry point degrades to a stamped no-op when the profiler cannot
start or left no trace: observability must never take down the run it
observes.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
from typing import List, Optional, Tuple

_logger = logging.getLogger("fastconsensus_tpu_torch")

# Chrome-trace categories of work that ran on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the profiler's per-op host events: PyTorch operators, CUDA runtime and
# driver calls, Python frames, and the flow arrows joining them to
# kernels; three quarters of a CUDA trace's events
_HOST_OP_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
                 "ac2g")
_TRACE_GLOB = "*.pt.trace.json"


def available() -> bool:
    """True when ``torch.profiler`` offers ``record_function`` (False
    only on import failure)."""
    try:
        import torch.profiler as prof
    except Exception:  # noqa: BLE001 — observability must never raise
        return False
    return hasattr(prof, "record_function") and hasattr(prof, "profile")


class ProfilerSession:
    """``torch.profiler`` trace over a region, with a merge-ready clock
    anchor.

    ``with ProfilerSession(log_dir, device) as sess:`` profiles the CPU
    activity, and the CUDA activity when ``device`` is a CUDA device, and
    on exit writes the Chrome trace to ``log_dir`` (:attr:`trace_path`).
    It is a no-op when ``log_dir`` is falsy; a profiler that refuses to
    start (a second concurrent session) leaves :attr:`start_pc` None and
    the run continues host-only, with a warning.
    """

    def __init__(self, log_dir: Optional[str], device=None) -> None:
        self.log_dir = log_dir
        self.device = device
        self.active = False
        self.start_pc: Optional[float] = None
        self.start_wall: Optional[float] = None
        self.trace_path: Optional[str] = None
        self._prof = None

    def __enter__(self) -> "ProfilerSession":
        if not self.log_dir:
            return self
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device is not None and \
                    torch.device(self.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.log_dir, exist_ok=True)
            # both anchors before the profiler starts: its first start in
            # a process initialises the tracing library, and an anchor
            # taken after that would shift every merged event late
            self.start_wall = time.time()
            self.start_pc = time.perf_counter()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self.active = True
        except Exception as e:  # noqa: BLE001
            self.start_pc = self.start_wall = None
            self._prof = None
            _logger.warning("torch.profiler unavailable (%s); continuing "
                            "host-only", e)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.active:
            self.active = False
            try:
                self._prof.__exit__(None, None, None)
                path = os.path.join(
                    self.log_dir, f"fcobs_{int(self.start_wall * 1e3)}_"
                                  f"{os.getpid()}.pt.trace.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
            except Exception as e:  # noqa: BLE001
                # a log line is not an outlet: the counter carries the
                # failure into /metricsz and the trace's counters line
                from fastconsensus_tpu_torch.obs import counters

                counters.get_registry().inc("obs.profiler.export_failed")
                _logger.warning("torch.profiler trace export failed: %s", e)
            self._prof = None
        return False

    def offset_us(self, tracer_t0: float) -> float:
        """Shift (µs) that maps wall-clock microseconds (the profiler's
        events as :func:`load_trace_events` returns them) onto a tracer
        clock whose zero is perf_counter ``tracer_t0``."""
        if self.start_pc is None:
            return 0.0
        return (self.start_pc - tracer_t0 - self.start_wall) * 1e6


def _attach_info(blob: dict, info: dict) -> dict:
    """Return a copy of ``blob`` with ``info`` recorded under
    ``otherData.device_attribution``."""
    other = dict(blob.get("otherData") or {})
    other["device_attribution"] = info
    blob = dict(blob)
    blob["otherData"] = other
    return blob


def stamp_attribution(blob: dict, reason: str) -> Tuple[dict, dict]:
    """Record a merge-didn't-happen outcome on the blob: a
    ``--profile-dir`` trace ALWAYS carries
    ``otherData.device_attribution``, also when the profiler never
    started (and merging could pick up an earlier session's file)."""
    info = {"merged": False, "device_track": False, "reason": reason}
    return _attach_info(blob, info), info


def find_trace_file(log_dir: str,
                    newer_than: Optional[float] = None) -> Optional[str]:
    """Newest ``*.pt.trace.json`` under ``log_dir``, or None.
    ``newer_than`` (wall time, seconds) skips files written before THIS
    session started, so a reused ``--profile-dir`` never merges a stale
    trace; a small slack absorbs filesystem timestamp granularity."""
    hits = sorted(glob.glob(os.path.join(log_dir, _TRACE_GLOB)),
                  key=os.path.getmtime)
    if newer_than is not None:
        hits = [h for h in hits if os.path.getmtime(h) >= newer_than - 2.0]
    return hits[-1] if hits else None


def load_trace_events(path: str) -> List[dict]:
    """The ``traceEvents`` of one profiler Chrome-trace file, their
    ``ts`` in wall-clock microseconds (``baseTimeNanoseconds`` added)."""
    with open(path, encoding="utf-8") as fh:
        blob = json.load(fh)
    base_us = float(blob.get("baseTimeNanoseconds") or 0) / 1e3
    events = list(blob.get("traceEvents") or [])
    for ev in events:
        if "ts" in ev:
            ev["ts"] = float(ev["ts"]) + base_us
    return events


def _has_device_track(events: List[dict]) -> bool:
    """Did the profiler record work on the card (CUDA kernels, copies or
    memsets)?"""
    return any(ev.get("cat") in _DEVICE_CATS for ev in events)


def finalize_merge(blob: dict, session: ProfilerSession,
                   tracer_t0: float) -> Tuple[dict, dict]:
    """The exporter's one merge-or-stamp policy: a session that never
    started is stamped, not merged; a started one merges only the trace
    file written since it began."""
    if session.start_pc is None:
        return stamp_attribution(
            blob, "torch.profiler failed to start (see run log); nothing "
                  "to merge")
    return merge_profiler_trace(blob, session.log_dir,
                                offset_us=session.offset_us(tracer_t0),
                                newer_than=session.start_wall)


def merge_profiler_trace(blob: dict, log_dir: str,
                         offset_us: float = 0.0,
                         drop_host_ops: bool = True,
                         newer_than: Optional[float] = None
                         ) -> Tuple[dict, dict]:
    """Graft the newest profiler trace under ``log_dir`` into an fcobs
    Perfetto blob (obs/export.to_perfetto output).

    Profiler events keep their own pids and tids and are shifted by
    ``offset_us`` (:meth:`ProfilerSession.offset_us`) onto the fcobs
    clock.  ``drop_host_ops`` (default) drops the profiler's per-op host
    events (``_HOST_OP_CATS``): the fcobs spans already cover the host
    side, and what stays is the card's kernels and copies, the
    ``record_function`` ranges of the annotating tracer and the track
    names.  Returns ``(merged_blob, info)``: ``info`` (``merged``,
    ``device_track``, the source path, the event and dropped counts, or
    the reason) is also stored under ``otherData.device_attribution``, so
    a CPU-only trace *says* it is host-only.  Any failure returns the
    blob unmerged, with the reason.
    """
    info = {"merged": False, "device_track": False}
    try:
        path = find_trace_file(log_dir, newer_than=newer_than)
        if path is None:
            fresh = " fresh" if newer_than is not None else ""
            info["reason"] = (f"no{fresh} profiler trace found under "
                              f"{log_dir}")
        else:
            events = load_trace_events(path)
            shifted = []
            for ev in events:
                if drop_host_ops and ev.get("cat") in _HOST_OP_CATS:
                    continue
                if "ts" in ev:
                    ev["ts"] += offset_us
                shifted.append(ev)
            blob = dict(blob)
            blob["traceEvents"] = list(blob["traceEvents"]) + shifted
            info.update(merged=True, source=os.path.relpath(path, log_dir),
                        events=len(shifted),
                        host_ops_dropped=len(events) - len(shifted),
                        device_track=_has_device_track(events))
            if not info["device_track"]:
                info["reason"] = ("profiler recorded no device track (a "
                                  "CPU run): host-side profiler events "
                                  "only")
    except Exception as e:  # noqa: BLE001 — never break the export
        info["reason"] = f"profiler trace merge failed: {e}"
        _logger.warning("%s", info["reason"])
    return _attach_info(blob, info), info
