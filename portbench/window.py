"""The measured window: whole units of work, closed by the clock.

A unit is what a driver finishes at once (a consensus job, a batch of
jobs).  The window opens at :meth:`Window.open` and
closes at the end of the first unit that ends at or after ``seconds``;
its length is from the opening to that end, and it counts the partitions
of the units that ended inside it, none in part.  Work a driver still
has in hand when it closes runs on outside the window.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional


class Window:
    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.perf_counter,
                 on_close: Optional[Callable[[], None]] = None):
        self.seconds = float(seconds)
        self.clock = clock
        self.on_close = on_close
        self.t0: Optional[float] = None
        self.t_close: Optional[float] = None
        self.partitions = 0
        self.units = 0
        self.final_detect_s = 0.0
        self.unit_ends: List[float] = []

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    @property
    def length(self) -> float:
        if self.t0 is None or self.t_close is None:
            raise RuntimeError("the window has not closed")
        return self.t_close - self.t0

    def open(self) -> None:
        self.t0 = self.clock()

    def unit(self, partitions: int, final_detect_s: float = 0.0) -> bool:
        """A unit ended now with ``partitions`` partitions detected in it
        (``final_detect_s``: the seconds of a final re-detection in it).
        Returns whether the window is closed after it."""
        if self.t0 is None:
            raise RuntimeError("unit before the window opened")
        if self.closed:
            return True
        now = self.clock()
        self.partitions += int(partitions)
        self.units += 1
        self.final_detect_s += float(final_detect_s)
        self.unit_ends.append(now - self.t0)
        if now - self.t0 >= self.seconds:
            self.t_close = now
            if self.on_close is not None:
                self.on_close()
        return self.closed
