"""Violating fixture: a loader thread whose torch.load can raise
(OSError, RuntimeError, UnpicklingError: the raiser table) with nothing
on the path to catch it, so the thread dies with a traceback."""

import threading

import torch


class CheckpointWatcher:
    def __init__(self, path):
        self.path = path
        self.state = None
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while True:
            self._reload()

    def _reload(self):
        self.state = torch.load(self.path)
