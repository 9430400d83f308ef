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
                 "_depth")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._parent = stack[-1].name if stack else None
        self._depth = len(stack)
        stack.append(self)
        # fcflight mirror: enabled-tracer spans also land in the flight
        # recorder's ring, so a post-mortem bundle of a traced run shows
        # the driver's phase structure next to the serving events.  One
        # O(1) ring append; the disabled tracer never constructs a _Span
        # so the overhead contract above is untouched.
        obs_flight.record("span_open", name=self.name)
        self._t0 = time.perf_counter()
        self._cpu0 = time.process_time()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        cpu1 = time.process_time()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": int((self._t0 - self._tracer._t0) * 1e6),
            "dur": int((t1 - self._t0) * 1e6),
            "cpu_us": int((cpu1 - self._cpu0) * 1e6),
            "tid": threading.get_ident(),
            "depth": self._depth,
            "parent": self._parent,
        }
        if self.args:
            ev["args"] = self.args
        self._tracer._record(ev)
        obs_flight.record("span_close", name=self.name,
                          dur_us=ev["dur"])
        return False


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
    """

    def __init__(self, enabled: bool = True,
                 annotate: bool = False) -> None:
        self.enabled = enabled
        self.annotate = False
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
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.perf_counter()

    @property
    def t0(self) -> float:
        """perf_counter value of the tracer's ts=0 (timeline merging —
        obs/device.ProfilerSession.offset_us)."""
        return self._t0

    # -- recording ---------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

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

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

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
