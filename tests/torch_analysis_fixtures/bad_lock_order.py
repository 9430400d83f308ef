"""Violating fixture: the device lock and the cache lock taken in both
orders; the device -> cache edge crosses a call."""

import threading

_device = threading.Lock()
_cache = threading.Lock()


def _store(result):
    with _cache:
        return result


def run_and_store(job):
    with _device:
        return _store(job)               # _device -> _cache


def evict_and_reset(job):
    with _cache:
        with _device:                    # _cache -> _device: the cycle
            return job
