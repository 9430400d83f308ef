"""A runtime guard on the builds a region runs, the port's counterpart
of the reference's ``CompileGuard`` (``fastconsensus_tpu/analysis/
recompile_guard.py``), with the same interface: ``registry``,
``counter``, ``thread_ident``, ``max_compiles``, ``.count``, usable as a
context manager.

The reference counts XLA backend compilations.  Eager PyTorch compiles
nothing of the sort, so the port counts the builds it really runs:

* an ``nvcc`` build of one ``ops/csrc/*.cu`` source
  (``ops/row_kernels.build``), one per source it compiles;
* the ``g++`` build of the host C++ library (``native._compile``).

Each builder calls :func:`note_build` on the thread that runs the
compiler, once per build.  Loading a library that is already built (from
``fastconsensus_tpu_torch/_build/``) counts nothing, as the reference's
persistent-cache hits fire no event.  So on the card a cold worker's
first job counts the kernels it builds, and every later job counts 0;
on the CPU no kernel is ever built and the count stays 0.

The serving tier keeps the reference's names for what this counts —
``serve.xla_compiles``, ``serve.prewarm.compiles``,
``serve.device.<i>.xla_compiles`` and the result field ``compiles`` —
so that the wire stays the reference's.
"""

from __future__ import annotations

import threading
from typing import List, Optional

_active: List["CompileGuard"] = []
_active_lock = threading.Lock()


class RecompileError(AssertionError):
    """Raised when a guarded region exceeds its build budget."""


def note_build(what: str) -> None:
    """Called by a builder once per build it runs, on the building
    thread: every active guard that watches this thread counts it."""
    with _active_lock:
        guards = list(_active)
    for g in guards:
        g._on_build(what)


class CompileGuard:
    """Count the builds of a region; optionally bound them.

    Guards may nest, each counting independently.  ``events`` records
    what was built (``"nvcc:row_totals"``, ``"g++:fcnative"``).
    ``registry``/``counter`` fold each build into a counter registry as
    it happens (anything with ``.inc(name)``).  ``thread_ident`` counts
    only builds run on that thread, so concurrent pool workers each
    count their own.
    """

    def __init__(self, max_compiles: Optional[int] = None,
                 registry=None, counter: str = "xla.compiles",
                 thread_ident: Optional[int] = None) -> None:
        self.max_compiles = max_compiles
        self.count = 0
        self.events: List[str] = []
        self._lock = threading.Lock()
        self._registry = registry
        self._counter = counter
        self._thread_ident = thread_ident

    def attach(self, registry, counter: str = "xla.compiles"
               ) -> "CompileGuard":
        """Mirror every build into ``registry.inc(counter)``; returns
        self."""
        self._registry = registry
        self._counter = counter
        return self

    def _on_build(self, what: str) -> None:
        if self._thread_ident is not None and \
                threading.get_ident() != self._thread_ident:
            return
        with self._lock:
            self.count += 1
            self.events.append(what)
        if self._registry is not None:
            self._registry.inc(self._counter)

    def __enter__(self) -> "CompileGuard":
        with _active_lock:
            _active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _active_lock:
            if self in _active:
                _active.remove(self)
        if exc_type is None and self.max_compiles is not None and \
                self.count > self.max_compiles:
            raise RecompileError(
                f"guarded region ran {self.count} builds (budget "
                f"{self.max_compiles}): {self.events}")
        return False


def assert_max_compiles(n: int) -> CompileGuard:
    """``with assert_max_compiles(2): ...`` — sugar over CompileGuard."""
    return CompileGuard(max_compiles=n)
