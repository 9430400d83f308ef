"""Clean twin of bad_escape_thread_root.py: the loop absorbs a failed
load and counts it."""

import pickle
import threading

import torch


class CheckpointWatcher:
    def __init__(self, path, reg):
        self.path = path
        self.state = None
        self._reg = reg
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while True:
            try:
                self._reload()
            except (OSError, RuntimeError, pickle.UnpicklingError):
                self._reg.inc("checkpoint.reload_failed")

    def _reload(self):
        self.state = torch.load(self.path)
