"""One run of one cell: set-up, the window, the check, the result line.

The driver of the cell's mix (``drivers/<driver>.py``) offers the load;
this module times it, reads the card, runs the reference's check on what
the jobs returned, and reads every metric through its reader.

What the timed path produced is taken as it was produced: the drivers
keep each job's return value, and :class:`TailTap` keeps a host copy of
the inputs and output of every consensus tail the program runs while
the jobs run (the port's ``engine.consensus_tail``, wrapped for the run
without changing what it computes; the copies run on a stream of their
own into pinned host memory allocated in set-up, and the device's
metrics leave that stream out).
"""

from __future__ import annotations

import inspect
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

from portbench import spec
from portbench.window import Window

# top-level module names that must not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "fastconsensus_tpu")


class NoChip(RuntimeError):
    pass


class _Arena:
    """Host buffers carved from chunks allocated ahead (pinned on the
    card's runs); a chunk that runs out is followed by another."""

    ALIGN = 256

    def __init__(self, chunk_bytes: int, pinned: bool):
        self.chunk, self.pinned = int(chunk_bytes), pinned
        self.chunks: list = []
        self.off = 0
        self._grow(self.chunk)

    def _grow(self, nbytes: int) -> None:
        import torch

        self.chunks.append(torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=self.pinned))
        self.off = 0

    def take(self, shape, dtype):
        import torch

        n = 1
        for d in shape:
            n *= int(d)
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        start = -(-self.off // self.ALIGN) * self.ALIGN
        if start + nbytes > self.chunks[-1].numel():
            self._grow(max(self.chunk, nbytes))
            start = 0
        self.off = start + nbytes
        return self.chunks[-1][start:start + nbytes].view(dtype).view(shape)


class TailTap:
    """Host copies of each ``consensus_tail`` call's graph and partitions
    in and graph out, while ``on``.

    The check binds to the port's ``engine.consensus_tail`` as called
    through the module's attribute: a change to the program that renames
    the tail, fuses it into another call or stops calling it there has to
    move this tap with it, or every job reads as a chain fault.

    On the card the copies run on a stream of the tap's own, into pinned
    memory from chunks allocated in set-up (:meth:`reserve`, sized from
    the warm-up's tails); the program's stream then waits for them, so
    nothing it writes later races a copy.  The trace leaves the tap's
    stream out of the device's metrics (:func:`tap_stream`).
    """

    # a chunk holds the warm-up's tails this many times, and 1 GiB at least
    CHUNK_WARMUPS = 8
    MIN_CHUNK = 1 << 30

    def __init__(self, on_card: bool):
        import torch

        from fastconsensus_tpu_torch import engine

        self.engine = engine
        self.orig = engine.consensus_tail
        self.sig = inspect.signature(self.orig)
        self.on_card = on_card
        self.stream = torch.cuda.Stream() if on_card else None
        self.on = False
        self.sizing = False
        self.sized_bytes = 0
        self.arena: Optional[_Arena] = None
        self.copies = 0
        self.tails: List[dict] = []

    def install(self) -> None:
        self.engine.consensus_tail = self._call

    def remove(self) -> None:
        self.engine.consensus_tail = self.orig

    def reserve(self) -> None:
        """Allocate the first chunk: :attr:`CHUNK_WARMUPS` times the bytes
        of the tails seen while :attr:`sizing` (the warm-up)."""
        self.arena = _Arena(max(self.MIN_CHUNK,
                                self.CHUNK_WARMUPS * self.sized_bytes),
                            self.on_card)

    def _copy(self, tensors: list) -> list:
        import torch

        if not self.on_card:
            return [t.clone() for t in tensors]
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = []
            for t in tensors:
                buf = self.arena.take(t.shape, t.dtype)
                buf.copy_(t, non_blocking=True)
                out.append(buf)
        main.wait_stream(self.stream)
        self.copies += len(tensors)
        return out

    def _call(self, *args, **kwargs):
        out, stats = self.orig(*args, **kwargs)
        if self.on or self.sizing:
            a = self.sig.bind(*args, **kwargs)
            a.apply_defaults()
            slab = a.arguments["slab"]
            fields = ("src", "dst", "weight", "alive")
            ts = [getattr(slab, f) for f in fields] + \
                [a.arguments["labels"]] + [getattr(out, f) for f in fields] + \
                [stats.n_dropped.reshape(1)]
            if self.sizing:
                self.sized_bytes += sum(t.numel() * t.element_size()
                                        for t in ts)
            else:
                h = self._copy(ts)
                self.tails.append(dict(n=slab.n_nodes, slab_in=tuple(h[:4]),
                                       labels=h[4], slab_out=tuple(h[5:9]),
                                       n_dropped=h[9]))
        return out, stats

    @property
    def chunks(self) -> int:
        return len(self.arena.chunks) if self.arena is not None else 0


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def job_nmi(job) -> float:
    """Mean NMI of a job's final partitions to its planted labels (the
    graph's own nodes; a size class's padding nodes left out)."""
    from portbench.reference.nmi import nmi

    n = job.truth.shape[0]
    return sum(nmi(p[:n], job.truth) for p in job.partitions) / \
        len(job.partitions)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, root: Path = spec.ROOT, device: str = "cuda",
        clock: Callable[[], float] = time.perf_counter,
        err=sys.stderr) -> dict:
    """Run the cell once; returns the result line's object.  Raises
    :class:`NoChip` when ``device`` is CUDA and the card the cell asks
    for is not there (the CPU tests pass ``device="cpu"``)."""
    import torch

    # the program first: a checkout without it fails here, card or none
    from fastconsensus_tpu_torch.ops import row_kernels as rk

    cell = spec.cell(workload, root)
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or
                    torch.cuda.device_count() < cell.chips):
        raise NoChip(
            f"{workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    if on_card:
        rk.build()     # the first run in a checkout compiles, in set-up
    drv = spec.driver(cell.mix["driver"], root).Driver(cell, seed, device)
    tap = TailTap(on_card)
    tap.install()
    try:
        tap.sizing = True
        drv.setup()
        tap.sizing = False
        tap.reserve()
        return _measure(cell, drv, tap, seconds, trace, t_start, root,
                        device, clock, err)
    finally:
        tap.remove()


def _measure(cell, drv, tap, seconds, trace, t_start, root, device, clock,
             err):
    import torch

    from fastconsensus_tpu_torch.ops import row_kernels as rk
    from portbench import devtrace
    from portbench.reference import check as ref_check

    on_card = device == "cuda"
    session = devtrace.Session(device) if trace else None
    if session is not None:
        session.warm(lambda: torch.zeros(1, device=device).add_(1))
    limit_w = power_limit_w() if on_card else None
    closed = {}

    def on_close():
        if on_card:
            torch.cuda.synchronize()
            closed["peak"] = torch.cuda.max_memory_reserved()
            closed["peak_allocated"] = torch.cuda.max_memory_allocated()
        closed["row_totals_shapes"] = dict(rk.ROW_TOTALS_SHAPES)
        closed["tap_copies"] = tap.copies
        if session is not None:
            session.stop()

    window = Window(seconds, clock=clock, on_close=on_close)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rk.reset_launches()
    tap.on = True
    setup_s = clock() - t_start
    if session is not None:
        session.start()
    copies_at_open = tap.copies
    window.open()
    try:
        jobs = drv.run(window)
        if on_card:
            torch.cuda.synchronize()
    finally:
        tap.on = False
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in the run: {bad}")
    facts = {"setup_s": setup_s, "window_s": window.length,
             "partitions": window.partitions, "units": window.units,
             "final_detect_s": window.final_detect_s,
             "peak_reserved_bytes": closed.get("peak"),
             "peak_allocated_bytes": closed.get("peak_allocated"),
             "row_totals_shapes": closed["row_totals_shapes"]}
    summary = None
    tap_card = {"copies": tap.copies, "chunks": tap.chunks}
    if session is not None:
        records = session.records()
        traced = closed["tap_copies"] - copies_at_open
        left_out = devtrace.copy_stream(records, traced) if on_card else None
        summary = devtrace.summarize(records, exclude=left_out)
        facts["trace"] = summary
        tap_card.update(traced_copies=traced,
                        left_out_records=summary["left_out_records"],
                        left_out_s=summary["left_out_s"])
    # the check: after the window, with the program's state freed
    tails = [ref_check.Tail(n_dropped=int(t.pop("n_dropped")[0]), **t)
             for t in tap.tails]
    del tap
    if on_card:
        torch.cuda.empty_cache()
    got = ref_check.check(jobs, tails, cell.config, cell.limits, device)
    if not trace:
        facts["nmi"] = [job_nmi(j) for j in jobs]
    kind = "per_layer" if trace else "end_to_end"
    metrics = spec.read_metrics(cell.metrics, kind, facts, root)
    checks = {k: {"value": got[k], "limit": cell.limits[k]}
              for k in ref_check.COMPARED}
    correct = got["failed_jobs"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": closed.get("peak")}
    line = {"correct": bool(correct), "attempted": len(jobs),
            "failed": int(got["failed_jobs"]), "metrics": metrics,
            "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = window.length
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["card"] = {"power_limit_w": limit_w, "partitions": window.partitions,
                    "unit_ends_s": window.unit_ends,
                    "job_rounds": [j.rounds for j in jobs],
                    "unstable_share_max": got["unstable_share_max"],
                    "round_shares": got["round_shares"], "tap": tap_card}
    line["checks"] = checks
    for note in got["notes"][:20]:
        print(f"check note: {note}", file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    return line
