"""Clean twin of bad_guarded_field.py: the copy is taken under the
lock."""

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
        with self._lock:
            return dict(self._counts)
