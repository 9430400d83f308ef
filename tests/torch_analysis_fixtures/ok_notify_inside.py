"""Clean twin of bad_notify_outside.py."""

import threading


class BatchQueue:
    def __init__(self):
        self._cond = threading.Condition()
        self._jobs = []

    def submit(self, job):
        with self._cond:
            self._jobs.append(job)
            self._cond.notify()
