"""The device's own record of the window, from ``torch.profiler``.

One session traces the card (CUPTI activity: kernels, copies, memsets)
from the window's opening to its close.  The records are read raw
(``kineto_results.events()``), not through ``prof.events()``, whose
event tree costs tens of seconds over a million kernels; nothing is
written to disk.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

# (name, start ns, end ns, stream: the device's resource id of the record)
Record = Tuple[str, int, int, int]

_NAME_CHARS = 96


def short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:_NAME_CHARS]


class Session:
    """A profiler session of the card's activity (on a CPU run, which only
    the CPU tests make, of the host's operators instead)."""

    def __init__(self, device: str = "cuda"):
        self.on_card = device == "cuda"
        self.prof = None

    def _new(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if self.on_card
                                   else ProfilerActivity.CPU])

    def warm(self, fn) -> None:
        """A throwaway session around ``fn`` (set-up): CUPTI's first
        start is slow."""
        prof = self._new()
        prof.start()
        fn()
        prof.stop()

    def start(self) -> None:
        self.prof = self._new()
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def records(self) -> List[Record]:
        import torch

        kind = torch.autograd.DeviceType.CUDA if self.on_card \
            else torch.autograd.DeviceType.CPU
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == kind:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns(),
                            e.device_resource_id()))
        return out


def copy_stream(records: List[Record], copies: int) -> Optional[int]:
    """The stream on which exactly ``copies`` records ran, all of them
    copies (``Memcpy``) and nothing else: the benchmark's own copies'
    stream, or ``None`` where no stream fits."""
    count = defaultdict(int)
    other = set()
    for name, _, _, stream in records:
        count[stream] += 1
        if not name.startswith("Memcpy"):
            other.add(stream)
    fits = [s for s, c in count.items() if c == copies and s not in other]
    return fits[0] if copies > 0 and len(fits) == 1 else None


def summarize(records: List[Record], top: int = 10,
              exclude: Optional[int] = None) -> dict:
    """Busy seconds (the union of the records' intervals), the record
    count, seconds by name, and the longest idle gaps inside the traced
    span, each named by the operation the device had just finished; the
    records of stream ``exclude`` left out of all of these and counted
    apart (``left_out_records``, ``left_out_s``)."""
    kept = [r for r in records if exclude is None or r[3] != exclude]
    left = [r for r in records if exclude is not None and r[3] == exclude]
    records = kept
    by_name = defaultdict(float)
    for name, s, e, _ in records:
        by_name[name] += (e - s) / 1e9
    by_short = defaultdict(float)
    for name, v in by_name.items():
        by_short[short(name)] += v
    busy = 0
    gaps = []
    end, last = None, None
    for name, s, e, _ in sorted(records, key=lambda r: r[1]):
        if end is None:
            busy += e - s
            end, last = e, name
            continue
        if s > end:
            gaps.append(((s - end) / 1e9, f"after {short(last)}"))
        if e > end:
            busy += e - max(s, end)
            end, last = e, name
    ops = sorted(by_short.items(), key=lambda x: -x[1])[:top]
    gaps = sorted(gaps, key=lambda g: -g[0])[:top]
    return {"busy_s": busy / 1e9, "records": len(records),
            "seconds_by_name": dict(by_name),
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[label, g] for g, label in gaps],
            "left_out_records": len(left),
            "left_out_s": sum(e - s for _, s, e, _ in left) / 1e9}
