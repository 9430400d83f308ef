"""fcserve admission queue: bounded, thread-safe, deadline-ordered.

Counterpart of ``fastconsensus_tpu/serve/queue.py``, unchanged in
behaviour.

The serving layer's backpressure contract lives here: the queue has a
**hard depth bound** and :meth:`AdmissionQueue.submit` on a full queue
raises :class:`QueueFull` immediately — it never blocks the submitting
HTTP thread and never grows without bound.  An overloaded server
therefore answers "429, retry later" in microseconds instead of
accepting work it cannot finish (the failure mode that turns overload
into OOM or timeout storms; the north-star "heavy traffic" posture is
*reject early, finish what you accepted*).  Since fcshape the 429 is
also HONEST: the raised :class:`QueueFull` carries a derived
``retry_after_s`` (serve/shaping.py) instead of a literal guess, and
:class:`DeadlineShed` refuses — at submit — work that provably cannot
meet its deadline at the current depth.

Ordering is a min-heap on ``(priority, deadline, seq)``: lower priority
values pop first (jobs.PRIORITY_INTERACTIVE before PRIORITY_BATCH), and
within a priority jobs pop **earliest-deadline-first** —
``Job.deadline_mono`` = admit + the job's SLO target — so a
tight-deadline job never starves behind earlier-admitted loose ones
(each reordering EDF actually performs counts into
``serve.shape.edf_promotions``).  Jobs of one SLO class share a target,
so their deadlines increase with admission time and equal-class traffic
stays FIFO (``seq`` is assigned under the queue lock, breaking exact
ties deterministically).  ``edf=False`` restores pure
(priority, seq) FIFO — the CI deadline-inversion probe runs against
exactly that posture to prove the check can fail.

Coalescing: :meth:`pop_batch` pops the EDF head plus same-group
ride-alongs, and — when a :class:`serve.shaping.TrafficShaper` is
installed — may **hold** for a few milliseconds when the head bucket's
arrival rate predicts a larger batch rung will fill within the
deadline slack (the adaptive hold-for-coalesce window; every decision
is the shaper's, the queue only enforces it).  A hold ends early the
moment the rung fills or the queue closes, and every popped job gets a
``hold_start`` stamp so the window shows up as the fclat ``hold``
phase, never smeared into ``queue_wait``.

Drain: :meth:`close` stops admissions (submit raises
:class:`QueueClosed` -> HTTP 503) while :meth:`pop` keeps handing out
already-admitted jobs until the heap is empty, then returns ``None`` —
the worker's signal that a graceful SIGTERM drain is complete
(serve/server.py).  A closed queue never holds: drain latency beats
rung occupancy.
"""

from __future__ import annotations

import heapq
import time
import threading
from typing import Callable, List, Optional, Tuple

from fastconsensus_tpu_torch.obs import counters as obs_counters
from fastconsensus_tpu_torch.obs import flight as obs_flight
from fastconsensus_tpu_torch.serve.jobs import Job


class QueueFull(RuntimeError):
    """Admission refused: the queue is at its depth bound (backpressure,
    not an internal error — HTTP maps it to 429 with a Retry-After
    derived from the observed service rate when a shaper is present; a
    bucket with no service history yet derives it from the static cost
    prior the shaper seeds (analysis/cost.py), so even the FIRST 429 a
    cold bucket ever sends carries model-derived honesty rather than
    the configured constant.  ``retry_after_s`` stays None only without
    a shaper, and the handler falls back to the default)."""

    retry_after_s: Optional[float] = None

    def __init__(self, depth: int, max_depth: int) -> None:
        super().__init__(
            f"queue full ({depth}/{max_depth} jobs); retry later")
        self.depth = depth
        self.max_depth = max_depth


class DeadlineShed(QueueFull):
    """Admission refused: at the current queued depth this job provably
    cannot meet its SLO deadline (serve/shaping.py ``should_shed``), so
    it is rejected at submit instead of occupying a slot just to miss.
    Maps to HTTP 429 like :class:`QueueFull` — from the client's side
    both mean "retry after the queue drains" — but the message names
    the deadline math."""

    def __init__(self, depth: int, max_depth: int, reason: str) -> None:
        RuntimeError.__init__(self, reason)
        self.depth = depth
        self.max_depth = max_depth


class QueueClosed(RuntimeError):
    """Admission refused: the service is draining (HTTP 503)."""


class AdmissionQueue:
    """Bounded thread-safe deadline-ordered priority queue of
    :class:`Job`s."""

    def __init__(self, max_depth: int, edf: bool = True) -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self.edf = bool(edf)
        # entries: (priority, deadline-or-0, seq, job); the deadline
        # slot is 0.0 under edf=False so ordering degrades to the
        # pre-fcshape (priority, seq) FIFO without a second heap shape
        self._heap: List[Tuple[int, float, int, Job]] = []
        self._seq = 0
        self._closed = False
        self._cond = threading.Condition()
        self._extra_depth: Optional[Callable[[], int]] = None
        self._shaper = None   # serve/shaping.TrafficShaper, optional
        self._reg = obs_counters.get_registry()

    def set_extra_depth(self, fn: Callable[[], int]) -> None:
        """Count admitted-but-undispatched jobs parked OUTSIDE the heap
        toward the depth bound.  The fcpool dispatcher (serve/pool.py)
        eagerly moves popped batches into per-worker deques; without
        this hook that would hollow out the backpressure contract — the
        heap would drain in microseconds and a depth-1 queue would
        absorb an unbounded burst into worker backlogs.  ``fn`` is
        called under the queue lock and must not take the queue lock
        itself (worker deque locks are always acquired after it)."""
        with self._cond:
            self._extra_depth = fn

    def set_shaper(self, shaper) -> None:
        """Install the traffic shaper consulted by :meth:`pop_batch`
        for hold-for-coalesce decisions (None disables holding — the
        pre-fcshape never-waits posture).  The shaper is called under
        the queue lock; its own locks (estimate cache, fclat registry)
        are leaves that never take the queue's, keeping the
        acquisition graph acyclic."""
        with self._cond:
            self._shaper = shaper

    def submit(self, job: Job) -> None:
        """Admit ``job`` or raise :class:`QueueFull` /
        :class:`QueueClosed` — never blocks, never exceeds the bound."""
        with self._cond:
            if self._closed:
                self._reg.inc("serve.queue.rejected_draining")
                raise QueueClosed("service is draining; not accepting jobs")
            depth = len(self._heap) + (self._extra_depth()
                                       if self._extra_depth else 0)
            if depth >= self.max_depth:
                self._reg.inc("serve.queue.rejected_full")
                # fcflight: 429s are exactly the events a post-incident
                # timeline needs next to the hangs that caused them
                obs_flight.record("reject_429", job=job.job_id,
                                  depth=depth)
                raise QueueFull(depth, self.max_depth)
            self._seq += 1
            heapq.heappush(
                self._heap,
                (job.spec.priority,
                 job.deadline_mono if self.edf else 0.0,
                 self._seq, job))
            self._reg.inc("serve.queue.admitted")
            depth = len(self._heap)
            self._reg.gauge("serve.queue.depth", depth)
            self._cond.notify()
        # flight append outside _cond: admits race the dispatcher's
        # pop for this lock, and the timeline doesn't need the
        # critical section — only the depth observed inside it
        trace = getattr(job.spec, "trace", None)
        obs_flight.record("admit", job=job.job_id,
                          priority=job.spec.priority, depth=depth,
                          **({"trace": trace} if trace else {}))

    def _note_promotion(self, heap, popped_seq: int,
                        priority: int) -> None:
        """Count one EDF reordering: the popped head left behind a
        same-priority job admitted EARLIER (smaller seq) — under FIFO
        that job would have popped first, so EDF provably promoted a
        tighter deadline past it.  ``heap`` is the caller's
        lock-guarded heap (passed explicitly — the caller holds
        ``_cond`` for the whole pop); depth-bounded, so the scan is
        O(max_depth)."""
        if not self.edf:
            return
        for prio, _, seq, _ in heap:
            if prio == priority and seq < popped_seq:
                self._reg.inc("serve.shape.edf_promotions")
                return

    def pop(self, timeout: Optional[float] = None) -> Optional[Job]:
        """Next job by (priority, deadline, admission order).

        Blocks until a job is available or the queue is closed *and*
        empty (returns ``None`` — drain complete).  With ``timeout``,
        also returns ``None`` if nothing arrived in time; callers that
        need to distinguish check :meth:`draining`.
        """
        with self._cond:
            while True:
                if self._heap:
                    prio, _, seq, job = heapq.heappop(self._heap)
                    self._note_promotion(self._heap, seq, prio)
                    self._reg.gauge("serve.queue.depth", len(self._heap))
                    # fclat queue_wait closes HERE — the moment the job
                    # leaves the admission heap (Job.stamp is a leaf
                    # lock; no cycle with _cond).  The solo pop never
                    # holds, so hold_start == the pop instant (hold=0).
                    t_pop = time.monotonic()
                    job.stamp_hold(t_pop)
                    job.stamp("dispatched", at=t_pop)
                    obs_flight.record("pop", job=job.job_id,
                                      depth=len(self._heap))
                    return job
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None

    def pop_batch(self, max_b: int,
                  group_key: Callable[[Job], str],
                  timeout: Optional[float] = None
                  ) -> Optional[List[Job]]:
        """The next job plus up to ``max_b - 1`` already-queued jobs of
        the same batch group (serve/jobs.JobSpec.batch_group) — the
        cross-request coalescing pop, with an optional adaptive
        hold-for-coalesce window (serve/shaping.py).

        Priority is never starved: the HEAD is always the strict
        ``(priority, deadline, seq)`` front of the queue, coalescing
        only pulls *ride-along* jobs that would otherwise run later,
        in that same EDF order.  Without a shaper a lone job pops
        immediately as a batch of one (the pre-fcshape contract, and
        still the test posture).  With a shaper, the pop may wait —
        bounded by the shaper's decision, which is itself bounded by
        the tightest queued deadline minus the measured service time —
        for the head bucket's predicted arrivals to fill a larger
        batch rung; the wait ends the instant the rung fills, the hold
        window expires, or the queue closes.

        Same drain semantics as :meth:`pop`: ``None`` once the queue is
        closed *and* empty (or on ``timeout`` with nothing queued).
        """
        with self._cond:
            hold_began: Optional[float] = None   # first episode start
            hold_until: Optional[float] = None   # active episode end
            hold_target = 0
            held_group: Optional[str] = None
            while True:
                if self._heap:
                    head = self._heap[0][3]
                    g = group_key(head)
                    shaper = self._shaper
                    if shaper is not None and max_b > 1 \
                            and not self._closed:
                        now = time.monotonic()
                        have = 0
                        tightest = None
                        blocks_solo = False
                        for _, _, _, j in self._heap:
                            if group_key(j) == g:
                                have += 1
                            if tightest is None \
                                    or j.deadline_mono < tightest:
                                tightest = j.deadline_mono
                            if not blocks_solo and j is not head:
                                # a queued mesh-tier job: holding the
                                # head parks it behind the window while
                                # its own (separate) tier may be idle
                                try:
                                    blocks_solo = shaper.runs_solo(
                                        j.spec.bucket().key())
                                except Exception:  # noqa: BLE001 — a
                                    # probe: blocks_solo stays False,
                                    # and the failure is counted
                                    self._reg.inc(
                                        "serve.queue.solo_probe_errors")
                        if held_group is not None and held_group != g:
                            # a tighter-deadline job of another group
                            # took the head mid-hold: the old episode
                            # is moot, decide afresh for the new head —
                            # and the new head's pop must not inherit
                            # the aborted episode's start stamp (its
                            # group never held)
                            hold_until = None
                            held_group = None
                            hold_began = None
                        if hold_until is not None \
                                and have >= hold_target:
                            # rung filled early: close this episode and
                            # re-decide (the shaper may chase the next
                            # rung, still deadline-bounded, or pop)
                            hold_until = None
                            held_group = None
                            continue
                        if hold_until is None:
                            try:
                                bucket = head.spec.bucket().key()
                            except Exception:  # noqa: BLE001 — an
                                bucket = None  # unbucketable spec pops
                            decision = shaper.hold_decision(
                                bucket, have=have, max_b=max_b,
                                slack_s=tightest - now, now=now,
                                group=g, blocks_solo=blocks_solo)
                            if decision.hold_s > 0.0:
                                hold_until = now + decision.hold_s
                                hold_target = decision.target
                                held_group = g
                                if hold_began is None:
                                    hold_began = now
                        if hold_until is not None:
                            if now >= hold_until \
                                    or not shaper.hold_is_free():
                                # window expired — or a worker went
                                # idle mid-hold, making every further
                                # held millisecond real latency: pop
                                hold_until = None
                                held_group = None
                            else:
                                # short wait slices so the idle check
                                # above re-runs every few ms, not only
                                # on submit wakeups
                                self._cond.wait(
                                    min(hold_until - now, 0.005))
                                continue
                    prio, _, head_seq, head = heapq.heappop(self._heap)
                    self._note_promotion(self._heap, head_seq, prio)
                    taken = [head]
                    if max_b > 1 and self._heap:
                        rest: List[Tuple[int, float, int, Job]] = []
                        # sorted() of a heap is a valid heap, and gives
                        # ride-alongs in strict (priority, deadline,
                        # seq) order — EDF order
                        for entry in sorted(self._heap):
                            if len(taken) < max_b and \
                                    group_key(entry[3]) == g:
                                taken.append(entry[3])
                            else:
                                rest.append(entry)
                        self._heap = rest
                        if len(taken) > 1:
                            self._reg.inc("serve.queue.coalesced_pops")
                    self._reg.gauge("serve.queue.depth", len(self._heap))
                    t_pop = time.monotonic()
                    t_hold = hold_began if hold_began is not None \
                        else t_pop
                    for t in taken:
                        # queue_wait closes at the hold start (or the
                        # pop, when nothing held) for the head AND
                        # every ride-along; the hold phase then spans
                        # to the coalesced pop they leave the heap in
                        t.stamp_hold(t_hold)
                        t.stamp("dispatched", at=t_pop)
                        obs_flight.record("pop", job=t.job_id,
                                          n=len(taken))
                    if hold_began is not None:
                        obs_flight.record(
                            "hold", job=head.job_id,
                            held_s=round(t_pop - hold_began, 6),
                            n=len(taken))
                    return taken
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None

    def close(self) -> None:
        """Stop admissions; wake blocked poppers so they can drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def total_depth(self) -> int:
        """Heap depth plus the dispatched-but-unstarted backlog the
        ``extra_depth`` hook tracks — the depth the admission bound
        (and the shaping Retry-After / shed math) actually judges."""
        with self._cond:
            return len(self._heap) + (self._extra_depth()
                                      if self._extra_depth else 0)

    def draining(self) -> bool:
        with self._cond:
            return self._closed
