"""Clean twin of bad_root_write.py: the write and the read share a
lock."""

import threading
import time


class DeviceWorker:
    def __init__(self):
        self._lock = threading.Lock()
        self.last_step_s = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            t0 = time.perf_counter()
            dt = time.perf_counter() - t0
            with self._lock:
                self.last_step_s = dt

    def status(self):
        with self._lock:
            return self.last_step_s
