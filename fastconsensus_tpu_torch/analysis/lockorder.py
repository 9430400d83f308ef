"""Runtime lock-order recorder: the dynamic half of fcheck-concurrency.

The port's own copy of the reference's ``analysis/lockorder.py``.  The
static ``lock-order`` rule (analysis/concurrency.py) cannot see through
stored callables: ``AdmissionQueue._extra_depth`` is a lambda installed
at runtime that reaches the workers' deques from under the queue's own
condition, an edge no AST walk can attribute.  This module records the
acquisition digraph actually *observed* while the code runs, so a test
(or ``chip_smoke.py``'s ``serve`` phase, on real CUDA dispatch threads)
can assert that the union of the static and the observed graphs stays
acyclic.

Opt-in only, through a :func:`recording` block (or :func:`install` /
:func:`uninstall`): it replaces ``threading.Lock`` / ``RLock`` /
``Condition`` with recording wrappers **for locks created from inside
the fastconsensus_tpu_torch tree**.  Every other construction (stdlib,
third-party, and the reference package's tree, which its own recorder
keys on) gets an unwrapped lock from the factory that was installed
before this one.  Each wrapped lock remembers its *creation site*
(``file:line``, which for the ``self._lock = threading.Lock()`` idiom
is the declaration the static pass keys on, see
``concurrency.lock_sites``), and every acquisition while other recorded
locks are held appends the edge (held site -> acquired site) to the
active :class:`LockOrderRecorder`.

``_REAL`` holds the stdlib lock constructors themselves (``_thread``'s),
not whatever ``threading`` holds at import, so the wrappers and the
recorder's own lock stay real locks when another recorder patched
``threading`` first.  The two recorders then run side by side: each
wraps only its own tree's locks, at creation, and :func:`uninstall`
restores the factories this module replaced, not the stdlib's.  A
lock created from the other tree while this module's factories are the
outer ones comes out unwrapped for both recorders (the other recorder
sees this module's frame as the creator), so create each tree's objects
under its own recorder.

``Condition`` is wrapped by handing the real ``threading.Condition`` a
recording lock: ``wait()`` then releases and re-acquires through the
wrapper, so the held-stack is correct across waits (a thread parked in
``wait`` holds nothing; edges re-record on wake-up).

Overhead is a thread-local list append per acquisition of a wrapped
lock.  The serving stack never imports this module; tests and the card's
release check do.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from fastconsensus_tpu_torch.analysis.concurrency import find_cycle

_REAL = {
    "Lock": _thread.allocate_lock,
    "RLock": _thread.RLock,
}
_FACTORIES = ("Lock", "RLock", "Condition")

_recorder: Optional["LockOrderRecorder"] = None
# the threading factories install() replaced, while installed
_prev: Optional[Dict[str, object]] = None
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class LockOrderRecorder:
    """Accumulates observed acquisition edges between lock creation
    sites ((abspath, lineno) pairs)."""

    def __init__(self) -> None:
        self._lock = _REAL["Lock"]()
        self._edges: Dict[Tuple[Tuple[str, int], Tuple[str, int]],
                          int] = {}
        self._local = threading.local()

    def _held(self) -> List[Tuple[Tuple[str, int], int]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def note_acquire(self, site: Tuple[str, int], lid: int) -> None:
        stack = self._held()
        if stack:
            with self._lock:
                for held_site, held_lid in stack:
                    if held_lid == lid:
                        # re-entrant RLock acquisition of the SAME
                        # instance: not an ordering edge (a same-SITE
                        # edge between DISTINCT instances is: that is
                        # the two-workers-in-opposite-orders hazard)
                        continue
                    key = (held_site, site)
                    self._edges[key] = self._edges.get(key, 0) + 1
        stack.append((site, lid))

    def note_release(self, site: Tuple[str, int], lid: int) -> None:
        stack = self._held()
        # release order may not be LIFO (rare but legal): drop the
        # most recent matching entry
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == (site, lid):
                del stack[i]
                return

    def edges(self) -> Set[Tuple[Tuple[str, int], Tuple[str, int]]]:
        with self._lock:
            return set(self._edges)

    def edge_counts(self) -> Dict[Tuple[Tuple[str, int],
                                        Tuple[str, int]], int]:
        with self._lock:
            return dict(self._edges)

    def named_edges(self, sites: Dict[Tuple[str, int], str]
                    ) -> Set[Tuple[str, str]]:
        """Observed edges mapped onto the static pass's lock keys
        (``concurrency.lock_sites``); sites the static pass does not
        know keep their ``file:line`` spelling so nothing is silently
        dropped."""
        def name(site: Tuple[str, int]) -> str:
            return sites.get(site, f"{site[0]}:{site[1]}")

        return {(name(a), name(b)) for a, b in self.edges()}

    def assert_acyclic(self, extra_edges: Optional[
            Set[Tuple[str, str]]] = None,
            sites: Optional[Dict[Tuple[str, int], str]] = None) -> None:
        """Raise AssertionError when the observed digraph, unioned with
        ``extra_edges`` (canonically the static graph), has a cycle:
        every ordering the runtime exhibits must compose with every
        ordering the static pass proved, or a deadlock is one unlucky
        interleaving away."""
        edges = self.named_edges(sites or {})
        if extra_edges:
            edges = edges | set(extra_edges)
        cyc = find_cycle(edges)
        if cyc is not None:
            raise AssertionError(
                "observed lock-order cycle (union with static graph): "
                + " -> ".join(cyc + [cyc[0]]))


class _TracedLock:
    """Records acquisitions of one underlying lock against the active
    recorder.  Duck-types the full Lock protocol; ``threading.
    Condition`` drives it through acquire/release, so waits release the
    held-stack entry and re-add it on wake-up."""

    def __init__(self, inner, site: Tuple[str, int]) -> None:
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        # fcheck: ok=resource-leak (lock-wrapper protocol: the
        # paired release() is the caller's obligation, exactly
        # as with the raw lock this class impersonates)
        ok = self._inner.acquire(blocking, timeout)
        if ok and _recorder is not None:
            _recorder.note_acquire(self._site, id(self))
        return ok

    def release(self) -> None:
        if _recorder is not None:
            _recorder.note_release(self._site, id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition protocol: threading.Condition binds these when present.
    # Delegating keeps wait() correct for a re-entrant inner lock (the
    # plain-Lock fallbacks Condition would use otherwise misdetect
    # ownership of a held RLock) while the recorder's held-stack still
    # drops the entry across the wait and re-adds it on wake-up.

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # fcheck: ok=resource-leak (ownership probe: a
        # successful non-blocking acquire is released on the
        # very next line)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        if _recorder is not None:
            _recorder.note_release(self._site, id(self))
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            # fcheck: ok=resource-leak (Condition protocol: the
            # paired release happened in _release_save before the
            # wait; this is the wake-up re-acquire)
            self._inner.acquire()
        if _recorder is not None:
            _recorder.note_acquire(self._site, id(self))

    def __enter__(self) -> bool:
        # fcheck: ok=resource-leak (context-manager protocol:
        # __exit__ below is the paired release)
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self._site[0]}:{self._site[1]} " \
               f"{self._inner!r}>"


def _creation_site() -> Optional[Tuple[str, int]]:
    """(abspath, lineno) of the first stack frame outside this module
    and threading.py, or None when the construction did not come from
    the fastconsensus_tpu_torch tree (those locks stay unwrapped).  The
    ``os.sep`` after the package directory keeps the reference's tree
    (``fastconsensus_tpu/``) out."""
    f = sys._getframe(2)
    this = os.path.abspath(__file__)
    while f is not None:
        fname = os.path.abspath(f.f_code.co_filename)
        if fname != this and not fname.endswith(
                os.sep + "threading.py"):
            if fname.startswith(_PKG_DIR + os.sep):
                return (fname, f.f_lineno)
            return None
        f = f.f_back
    return None


def _make_lock() -> object:
    site = _creation_site()
    if site is None:
        return _prev["Lock"]()
    return _TracedLock(_REAL["Lock"](), site)


def _make_rlock() -> object:
    site = _creation_site()
    if site is None:
        return _prev["RLock"]()
    return _TracedLock(_REAL["RLock"](), site)


def _make_condition(lock=None) -> object:
    site = _creation_site()
    if site is not None and lock is None:
        # the condition's internal lock IS the recorded lock: every
        # with-block, notify and wait goes through the wrapper
        lock = _TracedLock(_REAL["RLock"](), site)
    # the factory installed before this one builds the real Condition:
    # it is called from this module, outside any other recorder's tree
    return _prev["Condition"](lock)


_OURS = {"Lock": _make_lock, "RLock": _make_rlock,
         "Condition": _make_condition}


def install(recorder: Optional[LockOrderRecorder] = None
            ) -> LockOrderRecorder:
    """Patch ``threading.Lock/RLock/Condition`` so locks created from
    the port's code record into ``recorder`` (a fresh one by default).
    Idempotent: calling again swaps the active recorder only."""
    global _recorder, _prev
    if recorder is None:
        recorder = LockOrderRecorder()
    _recorder = recorder
    if _prev is None:
        _prev = {name: getattr(threading, name) for name in _FACTORIES}
        for name in _FACTORIES:
            setattr(threading, name, _OURS[name])
    return recorder


def uninstall() -> None:
    """Restore the factories :func:`install` replaced (those another
    recorder installed since are left alone).  Locks already wrapped
    keep working (they hold real locks inside) but stop recording."""
    global _recorder, _prev
    _recorder = None
    if _prev is not None:
        for name in _FACTORIES:
            if getattr(threading, name) is _OURS[name]:
                setattr(threading, name, _prev[name])
        _prev = None


def maybe_install_from_env() -> Optional[LockOrderRecorder]:
    """Install iff ``FCTPU_LOCK_ORDER=1`` (the test-suite hook, as the
    reference's): the recorder installed, else None and nothing
    patched."""
    if os.environ.get("FCTPU_LOCK_ORDER") == "1":
        return install()
    return None


class recording:
    """``with lockorder.recording() as rec:``: scoped install/swap.

    If the factories are already patched by this module, only the
    active recorder is swapped and restored; otherwise the factories
    are patched for the block and unpatched after."""

    def __enter__(self) -> LockOrderRecorder:
        self._was_installed = _prev is not None
        self._prev_rec = _recorder
        self._rec = LockOrderRecorder()
        install(self._rec)
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> None:
        global _recorder
        if self._was_installed:
            _recorder = self._prev_rec
        else:
            uninstall()
