"""Violating fixture: host syncs while a lock is held: every thread that
needs the lock waits for the card's queue too."""

import threading

import torch


class LaunchStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0.0

    def record(self, t):
        with self._lock:
            torch.cuda.synchronize()          # barrier under the lock
            self._last = t.sum().item()       # readback under the lock
