"""fcobs spans: a low-overhead host-side span tracer for the driver loop.

Spans measure the *host-visible* phases of a consensus run — rounds,
detection chunks, executable (re)builds, growth replays, the final
re-detection — as nested intervals with wall time (``time.perf_counter``)
and CPU time (``time.process_time``).  Device-side kernel timing belongs
to ``torch.profiler`` — and an *annotating* tracer (``Tracer(annotate=
True)``, obs/device.py) mirrors every span into the profiler's timeline
as a ``record_function`` range so the two views share one vocabulary; fcobs
alone answers the cheaper, always-available question: where did the
driver's wall clock go, and how often did it cross the host-device
boundary (obs/counters.py).

Overhead contract: **disabled is the default and costs ~nothing.**  A
disabled tracer's :meth:`Tracer.span` is one attribute check returning a
shared no-op context manager — no event objects, no clock reads, no lock
traffic — so the instrumentation stays in the hot path permanently and
``cli.py --trace`` / tests merely swap in an enabled tracer
(:func:`set_tracer` / :func:`use_tracer`).

Thread-safety: each thread keeps its own span stack (nesting and
parenting are per-thread properties), and finished spans append to one
shared list under a lock.  Spans opened from worker threads interleave
correctly.

Finished spans are plain dicts shaped for the exporters (obs/export.py):
``name``, ``ph`` ("X" complete / "i" instant), ``ts``/``dur`` in integer
microseconds relative to the tracer's start, ``cpu_us``, ``tid``,
``depth``, ``parent`` and optional ``args``.  Children close before their
parents, so the event list is ordered by span *end*; exporters re-sort by
``ts``.

Clocks: the tracer reads ``time.time_ns()`` beside its ``perf_counter``
zero, so :meth:`Tracer.spans` gives every finished span on the Unix clock
in ns, the clock of ``torch.profiler``'s raw device records.  A
*device-timed* tracer (``Tracer(device_timed=True)``) also gives the
layer-boundary spans (:data:`DEVICE_TIMED`) a device range: on the card a
pair of timing events recorded on the current stream at enter and exit,
resolved onto the Unix clock once, by :meth:`Tracer.spans`, along the
line through two anchors (an event recorded after a synchronize, read
between ``time.time_ns()`` calls), one taken when the tracer is made and
one then; on the CPU, where ops run as they are called, the host
interval.
Inside a CUDA-graph capture (``ops/capture.active()``) no event is
recorded, and a span keeps its host interval only.
"""

from __future__ import annotations

import contextlib
import functools
import threading
# fcheck: ok=sync-in-loop (the tracer's whole job is deliberate host
# clock reads — time.perf_counter/process_time on span entry and exit;
# they touch no device values and never force a device sync)
import time
from typing import Callable, Dict, List, Optional

from fastconsensus_tpu_torch.obs import flight as obs_flight

# time.time_ns() brackets tried for each anchor of the card's clock
ANCHOR_TRIES = 5

# The layer boundaries a device-timed tracer gives a device range.
DEVICE_TIMED = frozenset({
    "consensus", "consensus_batch", "round", "detect", "tail",
    "final_detect", "batch_round", "batch_final_detect"})

# The round-level spans mirrored into the flight ring: per-sweep and
# per-chunk spans would push out the serving events a post-mortem bundle
# needs.
FLIGHT_MIRRORED = frozenset({
    "consensus", "consensus_batch", "round", "rounds_block", "batch_round",
    "batch_block", "final_detect", "batch_final_detect"})


class _NullSpan:
    """Shared do-nothing context manager handed out by disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records itself into the tracer on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_cpu0", "_parent",
                 "_depth", "_dev0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        self._parent = stack[-1].name if stack else None
        self._depth = len(stack)
        stack.append(self)
        # fcflight mirror: round-level spans of an enabled tracer also
        # land in the flight recorder's ring, so a post-mortem bundle of
        # a traced run shows the driver's phase structure next to the
        # serving events.  One O(1) ring append; the disabled tracer
        # never constructs a _Span so the overhead contract above is
        # untouched.
        if self.name in FLIGHT_MIRRORED:
            obs_flight.record("span_open", name=self.name)
        self._t0 = time.perf_counter()
        self._cpu0 = time.process_time()
        # after the host clock: a device range starts no earlier
        self._dev0 = tracer._device_start(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tracer = self._tracer
        dev1 = None if self._dev0 is None or self._dev0 is _HOST \
            else tracer._device_end()
        t1 = time.perf_counter()
        cpu1 = time.process_time()
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": int((self._t0 - tracer._t0) * 1e6),
            "dur": int((t1 - self._t0) * 1e6),
            "cpu_us": int((cpu1 - self._cpu0) * 1e6),
            "tid": threading.get_ident(),
            "depth": self._depth,
            "parent": self._parent,
        }
        if self.args:
            ev["args"] = self.args
        tracer._record(ev, self._dev0 if dev1 is None
                       else (self._dev0, dev1))
        if self.name in FLIGHT_MIRRORED:
            obs_flight.record("span_close", name=self.name,
                              dur_us=ev["dur"])
        return False


# a device-timed span on the CPU: its device range is its host interval
_HOST = object()


class _AnnotatedSpan:
    """Host span + ``torch.profiler`` annotation entered/exited together.

    The annotation is entered first and exited last, so the device-side
    region fully encloses the host span it names.  Handed out only by
    annotating tracers (``Tracer(annotate=True)``) — the disabled and
    host-only paths never construct one.
    """

    __slots__ = ("_span", "_ann")

    def __init__(self, span: "_Span", ann) -> None:
        self._span = span
        self._ann = ann

    def __enter__(self) -> "_Span":
        self._ann.__enter__()
        return self._span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            return bool(self._span.__exit__(exc_type, exc, tb))
        finally:
            self._ann.__exit__(exc_type, exc, tb)


class Tracer:
    """Collects nested spans; see the module docstring for the contract.

    ``annotate=True`` additionally wraps every span in a
    ``torch.profiler.record_function`` range of the same name (and
    :meth:`step_span` in one named ``"{name}#{step}"``), so a concurrent
    ``torch.profiler`` trace (obs/device.py ProfilerSession) shows the
    same span names beside the device's kernels.  Requested but
    unavailable annotation (no usable ``torch.profiler``) silently
    degrades to host-only spans.

    ``device_timed=True`` gives the :data:`DEVICE_TIMED` spans a device
    range (module docstring); on the card it synchronizes here, to
    record its first anchor, and in :meth:`spans`, to record its second.
    """

    def __init__(self, enabled: bool = True,
                 annotate: bool = False,
                 device_timed: bool = False) -> None:
        self.enabled = enabled
        self.annotate = False
        self.device_timed = bool(device_timed and enabled)
        if annotate:
            from fastconsensus_tpu_torch.obs import device as obs_device

            if obs_device.available():
                # bind the profiler function ONCE: span()/step_span()
                # are on the per-round / per-detect-chunk hot path and
                # must not pay a module import lookup per call
                from torch.profiler import record_function

                self.annotate = True
                self._annotation = record_function
                self._step_annotation = (
                    lambda name, step: record_function(
                        f"{name}#{int(step)}"))
        self._events: List[dict] = []
        # id(event) -> device range: _HOST, [start, end] Unix ns, or the
        # card's (start, end) timing events until spans() resolves them
        self._device: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._anchor = None
        if self.device_timed:
            import torch

            from fastconsensus_tpu_torch.ops import capture

            self._capture_active = capture.active
            if torch.cuda.is_available():
                self._new_event = functools.partial(torch.cuda.Event,
                                                    enable_timing=True)
                torch.cuda.synchronize()
                self._anchor = self._anchor_pair()
        self._t0 = time.perf_counter()
        self._unix0 = time.time_ns()

    @property
    def t0(self) -> float:
        """perf_counter value of the tracer's ts=0 (timeline merging —
        obs/device.ProfilerSession.offset_us)."""
        return self._t0

    # -- device ranges -----------------------------------------------

    def _anchor_pair(self):
        """``(event, Unix ns)``: a timing event recorded on an idle stream
        and the middle of the tightest of a few ``time.time_ns()``
        brackets around its record and completion."""
        best = None
        for _ in range(ANCHOR_TRIES):
            ev = self._new_event()
            before = time.time_ns()
            ev.record()
            ev.synchronize()
            after = time.time_ns()
            if best is None or after - before < best[2] - best[1]:
                best = (ev, before, after)
        return best[0], (best[1] + best[2]) // 2

    def _device_start(self, name: str):
        """The start of span ``name``'s device range: a timing event
        recorded on the current stream, :data:`_HOST` on the CPU, or None
        (no range: not a device-timed span, or inside a capture)."""
        if not self.device_timed or name not in DEVICE_TIMED or \
                self._capture_active():
            return None
        if self._anchor is None:
            return _HOST
        return self._device_end()

    def _device_end(self):
        ev = self._new_event()
        ev.record()
        return ev

    # -- recording ---------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, ev: dict, device=None) -> None:
        with self._lock:
            self._events.append(ev)
            if device is not None:
                self._device[id(ev)] = device

    # -- public API --------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing a named region; ``args`` become the
        span's Perfetto args.  Returns the shared no-op span when the
        tracer is disabled (nothing is allocated or recorded).  An
        annotating tracer pairs the span with a profiler
        ``record_function`` range of the same name."""
        if not self.enabled:
            return _NULL_SPAN
        span = _Span(self, name, args or None)
        if self.annotate:
            return _AnnotatedSpan(span, self._annotation(name))
        return span

    def step_span(self, name: str, step: int, **args):
        """Like :meth:`span`, but the unit of repetition — one consensus
        round.  ``step`` is recorded in the span args, and an annotating
        tracer emits a ``record_function`` range named ``"{name}#{step}"``
        so the profiler's timeline groups the round's kernels per step."""
        if not self.enabled:
            return _NULL_SPAN
        span = _Span(self, name, {"step": int(step), **args})
        if self.annotate:
            return _AnnotatedSpan(span,
                                  self._step_annotation(name, step))
        return span

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (Perfetto ``ph: "i"``)."""
        if not self.enabled:
            return
        stack = self._stack()
        ev = {
            "name": name,
            "ph": "i",
            "ts": int((time.perf_counter() - self._t0) * 1e6),
            "dur": 0,
            "cpu_us": 0,
            "tid": threading.get_ident(),
            "depth": len(stack),
            "parent": stack[-1].name if stack else None,
        }
        if args:
            ev["args"] = args
        self._record(ev)

    def events(self) -> List[dict]:
        """Snapshot of all finished spans (ordered by span end)."""
        with self._lock:
            return list(self._events)

    def events_since(self, start: int) -> List[dict]:
        """Finished spans from index ``start`` on — the incremental-
        export primitive (export.JsonlStreamer): copies only the new
        tail under the lock, so per-round streaming stays O(new spans)
        instead of re-copying the whole history every flush."""
        with self._lock:
            return list(self._events[start:])

    def spans(self) -> List[dict]:
        """Finished spans (``ph`` "X") on the Unix clock, in ns, ordered
        by end: ``name``, ``parent``, ``depth``, ``args``, ``host``
        ``[start, end]`` and ``device`` ``[start, end]`` (None where the
        span has no device range).  The card's events are resolved here,
        after one synchronize, so call it after the traced work."""
        with self._lock:
            events = list(self._events)
            device = dict(self._device)
        pending = {k: v for k, v in device.items() if isinstance(v, tuple)}
        if pending:
            import torch

            # a second anchor, now: the line through both maps the card's
            # clock onto the Unix one, its drift included
            torch.cuda.synchronize()
            (a, a_ns), (b, b_ns) = self._anchor, self._anchor_pair()
            elapsed = a.elapsed_time(b) * 1e6
            scale = (b_ns - a_ns) / elapsed if elapsed > 0 else 1.0
            for k, pair in pending.items():
                device[k] = [a_ns + int(a.elapsed_time(e) * 1e6 * scale)
                             for e in pair]
            with self._lock:
                for k in pending:
                    if k in self._device:
                        self._device[k] = device[k]
        out = []
        for ev in events:
            if ev["ph"] != "X":
                continue
            host = [self._unix0 + ev["ts"] * 1000,
                    self._unix0 + (ev["ts"] + ev["dur"]) * 1000]
            dev = device.get(id(ev))
            out.append({"name": ev["name"], "parent": ev["parent"],
                        "depth": ev["depth"], "args": ev.get("args"),
                        "host": host, "device": host if dev is _HOST
                        else dev})
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._device.clear()

    def drain_since(self, start: int) -> List[dict]:
        """Atomically snapshot finished spans from ``start`` on AND
        clear the buffer — the window-reset primitive for multi-worker
        streamers (serve/server.py): a separate ``events_since`` +
        ``clear`` pair can lose a span another thread closes between
        the two calls (wiped from memory without ever being
        streamed)."""
        with self._lock:
            tail = list(self._events[start:])
            self._events.clear()
            self._device.clear()
            return tail


# The ambient tracer consulted by instrumented code.  Disabled by default:
# run_consensus and the engine call get_tracer() unconditionally, and the
# no-op path is the permanent cost of having the instrumentation at all.
_DISABLED = Tracer(enabled=False)
_active: Tracer = _DISABLED


def get_tracer() -> Tracer:
    """The ambient tracer (a disabled singleton unless one was set)."""
    return _active


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the ambient tracer (None restores the
    disabled default).  Returns the now-active tracer."""
    global _active
    _active = tracer if tracer is not None else _DISABLED
    return _active


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scoped :func:`set_tracer`: restores the previous tracer on exit."""
    global _active
    prev = _active
    _active = tracer
    try:
        yield tracer
    finally:
        _active = prev


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form: time every call of ``fn`` as a span on the tracer
    active *at call time*.  With tracing disabled the wrapper adds one
    global read and one attribute check per call."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tracer = _active
            if not tracer.enabled:
                return fn(*a, **kw)
            with tracer.span(label):
                return fn(*a, **kw)

        return wrapper

    return deco
