"""Violating fixture: a kernel-launch tally read without its lock.
The launching worker bumps a per-kernel dict under the lock, while the
metrics endpoint copies the dict without it: a launch of a new kernel
between the two raises "dictionary changed size during iteration"."""

import threading


class LaunchTally:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._thread = threading.Thread(target=self._worker, daemon=True)

    def _worker(self):
        while True:
            self.launched("row_totals")

    def launched(self, name):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def metricsz(self):
        return dict(self._counts)         # no lock: races launched()
