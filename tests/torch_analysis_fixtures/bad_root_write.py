"""Violating fixture: a device worker thread publishes its last step
time with no lock, and the caller reads it."""

import threading
import time


class DeviceWorker:
    def __init__(self):
        self.last_step_s = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            t0 = time.perf_counter()
            self.last_step_s = time.perf_counter() - t0   # unguarded

    def status(self):
        return self.last_step_s
