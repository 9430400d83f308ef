"""Algorithm dispatch: the ``--alg`` seam.

All five of the reference's detectors: Louvain, LPM and Leiden on the
device, CNM and Infomap as host C++ (``native/``).  A host detector whose
library did not build raises ``NotImplementedError`` carrying the
compiler's error; there is no fallback.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict

from fastconsensus_tpu_torch.models.base import Detector

_REGISTRY: Dict[str, Callable[..., Detector]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> list:
    return sorted(_REGISTRY)


def supports_param(name: str, param: str) -> bool:
    _check(name)
    return param in inspect.signature(_REGISTRY[name]).parameters


def _check(name: str) -> None:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {available()}")


def get_detector(name: str, gamma: float = 1.0) -> Detector:
    """Resolve a detector (memoized per (name, gamma))."""
    _check(name)
    return _get_cached(name, float(gamma))


@functools.lru_cache(maxsize=64)
def _get_cached(name: str, gamma: float) -> Detector:
    factory = _REGISTRY[name]
    if "gamma" in inspect.signature(factory).parameters:
        return factory(gamma=gamma)
    return factory()


@register("lpm")
def _lpm() -> Detector:
    from fastconsensus_tpu_torch.models.lpm import lpm
    return lpm


@register("louvain")
def _louvain(gamma: float = 1.0) -> Detector:
    from fastconsensus_tpu_torch.models.louvain import louvain, make_louvain
    return louvain if gamma == 1.0 else make_louvain(gamma=gamma)


@register("leiden")
def _leiden(gamma: float = 1.0) -> Detector:
    from fastconsensus_tpu_torch.models.leiden import leiden, make_leiden
    return leiden if gamma == 1.0 else make_leiden(gamma=gamma)


def _require_native(name: str) -> None:
    from fastconsensus_tpu_torch import native

    try:
        native.load()
    except native.NativeBuildError as e:
        raise NotImplementedError(
            f"algorithm {name!r} needs the host C++ library: {e}") from e


@register("cnm")
def _cnm() -> Detector:
    _require_native("cnm")
    from fastconsensus_tpu_torch.models.cnm import cnm
    return cnm


@register("infomap")
def _infomap() -> Detector:
    _require_native("infomap")
    from fastconsensus_tpu_torch.models.infomap import infomap
    return infomap
