"""fcfault: opt-in fault injection at named raise sites of the port's
serving stack (counterpart of ``fastconsensus_tpu/serve/faultinject.py``).

Every raise site in the serving stack has an *absorbing boundary* — the handler
that turns the exception into a counted, flight-recorded, client-visible
failure instead of a dead thread. This module makes that falsifiable: point
``FCTPU_FAULT_INJECT`` at a ``site_id`` and the named function raises the named
exception on entry, so a test can drive real traffic through a live pool and
assert the per-site contract — the injected job fails *as itself*, the
``serve.*`` failure counters and flight events are stamped, sibling jobs
complete, and SIGTERM drain still exits 0.

Environment contract (mirrors ``FCTPU_LOCK_ORDER``):

- ``FCTPU_FAULT_INJECT=<module>:<qualname>:<ExcName>`` — the site to
  arm, a function of one of the port's modules, e.g.
  ``fastconsensus_tpu_torch.serve.bucketer:pad_to_bucket:ValueError``
  (a job fails at pack) or
  ``fastconsensus_tpu_torch.serve.pool:_Worker._run:RuntimeError`` (a
  worker dies mid-batch: cordon and requeue).
- ``FCTPU_FAULT_INJECT_COUNT=<n>`` — how many calls raise before the
  site heals and calls pass through again (default 1: one poisoned
  job, then normal service — the isolation contract is only visible
  when siblings *can* succeed).  ``-1`` never heals.

Unset, nothing in this module runs and the serving stack pays zero
overhead (``maybe_install_from_env`` is one ``os.environ.get``).
Kept import-light and torch-free on purpose: a fault injector that
cannot load is a fault injector that silently stops injecting.
"""

from __future__ import annotations

import builtins
import functools
import importlib
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)

ENV_VAR = "FCTPU_FAULT_INJECT"
ENV_COUNT_VAR = "FCTPU_FAULT_INJECT_COUNT"

# Exception names that are neither builtins nor attributes of the module
# that raises them, by their stdlib spelling.
_EXC_HOMES = {
    "URLError": "urllib.error",
    "HTTPError": "urllib.error",
    "JSONDecodeError": "json",
}

_lock = threading.Lock()
# site_id -> (owner object, attribute name, original callable)
_installed: Dict[str, Tuple[Any, str, Any]] = {}


def parse_site_id(site_id: str) -> Tuple[str, str, str]:
    """Split ``module:Qual.name:ExcName`` into its three parts.

    The module is dotted, so the split anchors on the two colons: the
    format is exactly the ``site_id`` the environment carries."""
    parts = site_id.split(":")
    if len(parts) != 3 or not all(p.strip() for p in parts):
        raise ValueError(
            f"bad fault site id {site_id!r}: expected "
            f"'<module>:<qualname>:<ExcName>'")
    module, qualname, exc_name = (p.strip() for p in parts)
    return module, qualname, exc_name


def _resolve_exc(module_obj: Any, exc_name: str) -> type:
    """The exception type a site raises, found where the raising module
    would find it: the module's own namespace first (project exception
    classes and its imports), then builtins, then the stdlib home
    table."""
    exc = getattr(module_obj, exc_name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    exc = getattr(builtins, exc_name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    home = _EXC_HOMES.get(exc_name)
    if home is not None:
        exc = getattr(importlib.import_module(home), exc_name, None)
        if isinstance(exc, type) and issubclass(exc, BaseException):
            return exc
    raise ValueError(
        f"cannot resolve exception type {exc_name!r} for module "
        f"{module_obj.__name__!r}")


def _make_exc(exc_type: type, site_id: str) -> BaseException:
    """Construct the injected exception.  Most types take a message;
    project backpressure types take positional ints (QueueFull(depth,
    max_depth), DeadlineShed(depth, max_depth, reason)) — the argument
    shapes are tried in order so the instance always carries the
    attributes its mapped handler reads (a 429 arm reading ``e.depth``
    off a half-built exception would itself crash, masking the very
    contract under test)."""
    msg = f"fault injected: {site_id}"
    for args in ((msg,), (0, 0), (0, 0, msg), ()):
        try:
            exc = exc_type(*args)
        # fcheck: ok=swallowed-error (trying the next constructor
        # shape IS the handling; exhausting them raises below)
        except TypeError:
            continue
        return exc
    raise ValueError(f"cannot construct {exc_type.__name__} for "
                     f"injection at {site_id}")


def _locate(module: str, qualname: str) -> Tuple[Any, str, Any]:
    """(owner, attribute, original) for a dotted qualname: the owner is
    the module for a plain function, the class for a method."""
    owner: Any = importlib.import_module(module)
    parts = qualname.split(".")
    for part in parts[:-1]:
        owner = getattr(owner, part)
    attr = parts[-1]
    original = getattr(owner, attr)
    if not callable(original):
        raise ValueError(
            f"fault site {module}:{qualname} is not callable")
    return owner, attr, original


def install(site_id: str, count: int = 1) -> None:
    """Arm one site: the named function raises the named
    exception on entry for its next ``count`` calls (-1 = forever),
    then heals and calls through.  Idempotent per site; thread-safe."""
    module, qualname, exc_name = parse_site_id(site_id)
    with _lock:
        if site_id in _installed:
            return
        owner, attr, original = _locate(module, qualname)
        exc_type = _resolve_exc(importlib.import_module(module), exc_name)
        remaining = [count]

        @functools.wraps(original)
        def _injected(*args: Any, **kwargs: Any) -> Any:
            with _lock:
                armed = remaining[0] != 0
                if remaining[0] > 0:
                    remaining[0] -= 1
            if armed:
                _logger.warning("fcfault: injecting %s at %s",
                                exc_name, site_id)
                raise _make_exc(exc_type, site_id)
            return original(*args, **kwargs)

        _injected.__fcfault_site__ = site_id  # type: ignore[attr-defined]
        setattr(owner, attr, _injected)
        _installed[site_id] = (owner, attr, original)


def uninstall(site_id: str) -> bool:
    """Heal one armed site; True if it was armed."""
    with _lock:
        entry = _installed.pop(site_id, None)
        if entry is None:
            return False
        owner, attr, original = entry
        setattr(owner, attr, original)
        return True


def uninstall_all() -> List[str]:
    """Heal every armed site; returns their ids (test teardown)."""
    healed = []
    for site_id in list(_installed):
        if uninstall(site_id):
            healed.append(site_id)
    return healed


def installed_sites() -> List[str]:
    with _lock:
        return sorted(_installed)


def maybe_install_from_env() -> Optional[str]:
    """Arm the site ``FCTPU_FAULT_INJECT`` names, if any; the armed
    site id, or None when the variable is unset (the only cost on the
    normal path).  Called once from ``serve.__main__.main`` after
    config validation, before the pool starts — a bad site id must
    fail startup loudly (exit 2), never inject nothing silently."""
    site_id = os.environ.get(ENV_VAR, "").strip()
    if not site_id:
        return None
    raw = os.environ.get(ENV_COUNT_VAR, "1").strip()
    try:
        count = int(raw)
    except ValueError:
        raise ValueError(
            f"bad {ENV_COUNT_VAR}={raw!r}: expected an integer")
    install(site_id, count=count)
    return site_id
