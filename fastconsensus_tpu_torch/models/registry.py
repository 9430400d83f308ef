"""Algorithm dispatch: the ``--alg`` seam.

Louvain, LPM and Leiden are ported; the reference's host C++ detectors
(cnm, infomap) raise a clear "not yet ported" error.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict

from fastconsensus_tpu_torch.models.base import Detector

_REGISTRY: Dict[str, Callable[..., Detector]] = {}
NOT_YET_PORTED = ("cnm", "infomap")


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
    if name in _REGISTRY:
        return
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not yet ported to the PyTorch package "
            f"(ported: {available()})")
    raise ValueError(f"unknown algorithm {name!r}; available: {available()}")


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
