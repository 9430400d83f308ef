"""Clean twin of bad_blocking_sync.py: sync and read back first, then
take the lock for the store only."""

import threading

import torch


class LaunchStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0.0

    def record(self, t):
        torch.cuda.synchronize()
        value = t.sum().item()
        with self._lock:
            self._last = value
