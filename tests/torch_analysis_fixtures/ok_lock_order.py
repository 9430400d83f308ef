"""Clean twin of bad_lock_order.py: the device lock is always taken
first."""

import threading

_device = threading.Lock()
_cache = threading.Lock()


def _store(result):
    with _cache:
        return result


def run_and_store(job):
    with _device:
        return _store(job)


def evict_and_reset(job):
    with _device:
        with _cache:
            return job
