"""Where the idle card waits, by layer: the device records of a traced
window (``devtrace.Session.records``) against the program's own spans
(``fastconsensus_tpu_torch.obs.Tracer.spans``), both on the Unix clock in
ns.

:func:`attribute` splits the window's busy and idle seconds among the
union of detection's device ranges (spans :data:`DETECT`), the union of
the tails' (:data:`TAIL`, less detection's where they touch) and the rest
(the driver: stats readbacks, policy, final labels, padding), and sums
each idle gap by the innermost host span open when it began, named by
its path from the root span (``consensus/round/detect/member_chunk/
sweep_exit``).  Vectorized over the records: a traced lfr100k window
holds about 3.2 M of them.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

DETECT = ("detect", "final_detect", "batch_final_detect")
TAIL = ("tail",)
OUTSIDE = "(outside the program)"


def union(intervals: Iterable[Sequence[int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint ``(start, end)`` covering ``intervals``."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((int(s), int(e)) for s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def subtract(a: List[Tuple[int, int]], b: List[Tuple[int, int]]
             ) -> List[Tuple[int, int]]:
    """``a`` less ``b`` (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def _covered(ranges: List[Tuple[int, int]], t: np.ndarray) -> np.ndarray:
    """For each time in ``t``, the ns of ``ranges`` before it."""
    if not ranges:
        return np.zeros(len(t), np.int64)
    r = np.asarray(ranges, np.int64)
    before = np.concatenate([[0], np.cumsum(r[:, 1] - r[:, 0])])
    k = np.searchsorted(r[:, 0], t, side="right")
    last = np.maximum(k - 1, 0)
    inside = np.clip(t - r[last, 0], 0, r[last, 1] - r[last, 0])
    return before[last] + np.where(k > 0, inside, 0)


def _overlap(ranges, starts: np.ndarray, ends: np.ndarray) -> int:
    """ns of ``ranges`` inside the intervals ``[starts, ends)``."""
    return int((_covered(ranges, ends) - _covered(ranges, starts)).sum())


def _innermost(spans: List[dict]):
    """The timeline cut where a host span opens or closes, and the path
    of the innermost span open on each piece (``OUTSIDE`` where none)."""
    marks = []
    for i, s in enumerate(spans):
        marks.append((s["host"][0], 1, s["depth"], i))
        marks.append((s["host"][1], 0, -s["depth"], i))
    marks.sort()
    cuts, paths, stack = [], [], []
    path_of = {}
    for t, opens, _, i in marks:
        if opens:
            parent = path_of[stack[-1]] if stack else None
            name = spans[i]["name"]
            path_of[i] = name if parent is None else f"{parent}/{name}"
            stack.append(i)
        elif i in stack:
            # spans close innermost first: what lies above it closed too
            del stack[stack.index(i):]
        cuts.append(t)
        paths.append(path_of[stack[-1]] if stack else OUTSIDE)
    return np.asarray(cuts, np.int64), paths


def attribute(records, spans: List[dict], exclude: Optional[int] = None,
              window: Optional[Tuple[int, int]] = None) -> dict:
    """Busy and idle seconds inside detection's device ranges, inside the
    tails' and outside both, over ``window`` (Unix ns; default: from the
    first record's start to the last one's end), and the idle seconds by
    the path of the innermost host span open when each gap began.
    ``records`` are ``(name, start, end, stream)`` tuples, stream
    ``exclude`` left out; ``spans`` are the tracer's, a span's ``device``
    ``[start, end]`` or None (no device range)."""
    t0 = time.perf_counter()
    rec = np.asarray([(s, e) for _, s, e, stream in records
                      if exclude is None or stream != exclude],
                     np.int64).reshape(-1, 2)
    rec = rec[np.argsort(rec[:, 0], kind="stable")]
    if window is None:
        window = (int(rec[0, 0]), int(rec[:, 1].max())) if len(rec) \
            else (0, 0)
    w0, w1 = int(window[0]), int(window[1])
    starts = np.clip(rec[:, 0], w0, w1)
    ends = np.maximum.accumulate(np.clip(rec[:, 1], w0, w1))
    # the idle gaps: from the busy time's end so far to the next start
    gap_s = np.concatenate([[w0], ends])
    gap_e = np.concatenate([starts, [w1]])
    gap_s = np.minimum(gap_s, gap_e)
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]

    def ranges(names):
        return union(s["device"] for s in spans
                     if s["name"] in names and s["device"] is not None)

    detect = [(max(s, w0), min(e, w1)) for s, e in ranges(DETECT)
              if e > w0 and s < w1]
    tail = subtract([(max(s, w0), min(e, w1)) for s, e in ranges(TAIL)
                     if e > w0 and s < w1], detect)
    out = {"window_s": (w1 - w0) / 1e9,
           "idle_s": float((gap_e - gap_s).sum()) / 1e9}
    out["busy_s"] = out["window_s"] - out["idle_s"]
    for name, rs in (("detect", detect), ("tail", tail)):
        span_s = sum(e - s for s, e in rs) / 1e9
        idle = _overlap(rs, gap_s, gap_e) / 1e9
        out[name] = {"busy_s": span_s - idle, "idle_s": idle}
    out["driver"] = {
        k: out[k] - out["detect"][k] - out["tail"][k]
        for k in ("busy_s", "idle_s")}
    cuts, paths = _innermost(spans)
    names = sorted(set(paths) | {OUTSIDE})
    index = {n: i for i, n in enumerate(names)}
    ids = np.asarray([index[p] for p in [OUTSIDE] + paths], np.int64)
    piece = np.searchsorted(cuts, gap_s, side="right")
    idle = np.bincount(ids[piece], weights=(gap_e - gap_s) / 1e9,
                       minlength=len(names))
    out["idle_by_span"] = sorted(
        ([n, float(s)] for n, s in zip(names, idle) if s > 0),
        key=lambda x: -x[1])
    out["spans"] = len(spans)
    out["attribute_s"] = time.perf_counter() - t0
    return out
