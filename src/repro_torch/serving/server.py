"""Async serving front door: admission, QoS classes, deadlines, backpressure
(port of :mod:`repro.serving.server`).

The engine (:mod:`repro_torch.serving.engine`) answers *batches*; nothing
there owns arrival, queueing, deadlines, or overload.  This module is that
owner — the layer live traffic actually talks to:

    submit ──> bounded arrival queue ──> per-class coalescing ──> dispatch
    (shed          (``max_queue``           (flush at               (engine
     when           lanes across            ``max_lanes`` or         begin +
     full)          all classes)            the batch window)        finish)
                                                    │
                         deadline timers ───────────┘
                         (best-so-far partial at expiry, or timeout)

**QoS classes.**  Each :class:`QoSClass` names its own
:class:`~repro_torch.serving.engine.SearchEngine` — so each class carries
its own calibrated ``(lam, l_min)`` budget law (see
:func:`repro_torch.core.calibrate.calibrate_budget_law_per_class`): an
"interactive" class trades recall for I/O independently of a "batch" class,
while both engines share one backend (and therefore one slow tier, one
index); each engine has its own CUDA stream on the card.

**Admission.**  ``submit`` enqueues one query lane.  Admission is bounded
by ``max_queue`` *open* lanes across all classes (queued + dispatched but
not yet complete): a submit that finds the bound hit is *shed* — its
future completes immediately with status ``"shed"`` (an explicit response,
never a silent drop).  A wedged backend therefore converts into sheds, not
unbounded queues; its stuck lanes complete via their deadline hedges,
which re-opens admission.  Pending lanes of a class are
flushed into one engine dispatch when ``max_lanes`` accumulate or when the
oldest lane has waited ``batch_window_s`` — the front door's own admission
coalescing, upstream of the engine's ``coalesce_lanes`` (which remains the
right tool for *batch* streams; the front door coalesces *lanes*).

**Deadlines.**  Every request carries a deadline (class default, or per
``submit``).  A deadline that expires while the request is still queued
completes it as ``"timeout"`` and frees its queue slot.  One that expires
mid-flight is the *hedge*: the front door asks the engine for a best-so-far
result at the probe horizon (:meth:`SearchEngine.partial_result` — the
probe state's beam reranked through the normal finish path) and completes
the request as ``"partial"``; if even the probe isn't available (a wedged
backend) the request completes as ``"timeout"``.  The full result, when it
eventually lands, never overwrites a completed future — futures complete
exactly once.

**Live index swaps.**  The front door never pins the backend: every
dispatch goes through :meth:`SearchEngine.begin`, which snapshots the
backend's bindings into the flight, and ``finish_from`` /
``partial_result`` run against that snapshot.  So a live
``engine.update_backend(...)`` — e.g. the delta tier publishing a merged
generation (:class:`repro_torch.index.delta.LiveIndex`) — is safe under
traffic: requests in flight at the swap complete against the index they
were dispatched on, requests admitted after it serve the new one, and
nothing observes a half-swapped backend.

**The clock seam.**  All timing flows through an injectable clock/scheduler:
:class:`WallClock` (a daemon timer thread over ``time.monotonic``) in
production, :class:`VirtualClock` in tests.  The virtual clock is a manual
heap of (time, submission-seq) events — same-instant timers fire in
submission order, so every interleaving (bursty arrival, deadline expiry
mid-continue, shed under overload, drain on shutdown) is replayable
bit-exactly, with no ``time.sleep`` anywhere.

**The dispatcher seam.**  How engine work runs is likewise injectable.
A dispatcher has ``launch`` (where a flush's ``begin`` runs), ``submit``
(where its ``finish_from`` runs) and ``close``.
:class:`ThreadDispatcher` (production) runs ``begin`` on a thread of its
own and ``finish_from`` on a worker pool.  :class:`VirtualDispatcher`
(tests, replays) runs both *synchronously at flush* — so served results are bit-identical to a direct
engine call by construction — while modelling the completion as a clock
event at an injectable service time: a constant, a callable, ``math.inf``
(a wedged backend: the completion never arrives and only deadline hedges
complete the futures), or ``"measured"`` (the synchronous call's real wall
time, which grounds a replay's latency distributions in the card's).

**On the card.**  :meth:`SearchEngine.begin` queues admission, probe and
grant on the class engine's CUDA stream and returns with no host sync (the
walk's convergence check is read where the flight is first read on the
host), but it is still tens of launches: milliseconds of host time, where
the reference's asynchronous dispatch takes microseconds.  So a flush
registers its dispatches under the door's lock and, once the lock is
released, hands them to the dispatcher's own begin thread
(:meth:`ThreadDispatcher.launch`): ``submit`` stays cheap for its caller,
a host that cannot keep up fills the open-lane bound and sheds instead of
stalling its callers, and a dispatch whose lanes all completed (deadline
hedges) before its turn is not begun.  A deadline hedge waits only for its
flight's probe (an event recorded right after it) and copies and reranks
the probe beam on a stream of its own
(:meth:`SearchEngine.partial_result`), outside the door's lock; a full
result that is ready when the hedge completes its lanes wins over the
partial.  The timer thread, the dispatch workers and the submitting
threads share the interpreter lock with the engine's Python, which bounds
how promptly a timer fires.

**Shutdown.**  ``close()`` stops admission (later submits shed), force-
flushes every pending lane, lets every admitted request complete — full
results, or best-so-far/timeout via their deadline timers — and only then
closes each distinct engine exactly once (engine close is idempotent, so
classes sharing a backend are safe).  Idempotent and safe from any thread.

Lane padding: ``QoSClass(lane_quantum=)`` pads each dispatch to a lane-count
grid (repeating the first lane; padded rows are dropped on completion) so a
front door under ragged traffic launches a bounded family of batch shapes —
the same discipline as the pipeline's bucket ``pad_quantum``.  Under a
pinned LID center padding is result-transparent per lane; with batch-mean
centering, budgets depend on dispatch composition (the reducer's property,
as with any batching choice).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools
import math
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Mapping

import numpy as np

from repro_torch.serving.engine import BatchResult, SearchEngine

__all__ = [
    "OK", "PARTIAL", "TIMEOUT", "SHED", "ERROR",
    "Timer", "VirtualClock", "WallClock",
    "VirtualDispatcher", "ThreadDispatcher",
    "QoSClass", "ServedResult", "RequestFuture", "FrontDoor",
    "drain_virtual",
]

# Response statuses (every admitted request completes with exactly one).
OK = "ok"            # full engine result before the deadline
PARTIAL = "partial"  # deadline hedge: best-so-far at the probe horizon
TIMEOUT = "timeout"  # deadline expired with nothing servable
SHED = "shed"        # refused at admission (queue full, or closing)
ERROR = "error"      # the dispatch raised; see ServedResult.note


# --------------------------------------------------------------------- clocks


class Timer:
    """Cancelable handle for one scheduled callback.  ``cancel`` is a flag,
    not a heap removal — a cancelled entry is skipped when popped."""

    __slots__ = ("when", "cancelled")

    def __init__(self, when: float):
        self.when = when
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class VirtualClock:
    """Deterministic manual-advance clock + scheduler (the test seam).

    Single-threaded by design: callbacks run on the thread calling
    :meth:`advance`, in strict (time, submission order) — two timers at the
    same instant fire in the order they were scheduled, so a replay of the
    same schedule is bit-exact.  ``now`` advances *through* each event's
    timestamp as it fires (a callback scheduling "0.1s later" lands relative
    to its own fire time, not the horizon)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_at(self, when: float, fn: Callable, *args) -> Timer:
        """Schedule ``fn(*args)`` at absolute time ``when`` (clamped to now;
        ``inf`` never fires — the wedged-dispatch model — but still returns
        a cancelable handle for uniformity)."""
        if not math.isfinite(when):
            return Timer(math.inf)
        t = Timer(max(float(when), self._now))
        heapq.heappush(self._heap, (t.when, next(self._seq), t, fn, args))
        return t

    def call_later(self, delay: float, fn: Callable, *args) -> Timer:
        return self.call_at(self._now + delay, fn, *args)

    def pending(self) -> int:
        """Live (uncancelled) scheduled events — drain checks in tests."""
        return sum(1 for e in self._heap if not e[2].cancelled)

    def advance(self, dt: float) -> int:
        """Run every event due within the next ``dt`` seconds, in order,
        then set now to the horizon.  Returns the number of callbacks run."""
        return self.run_until(self._now + dt)

    def run_until(self, horizon: float) -> int:
        ran = 0
        while self._heap and self._heap[0][0] <= horizon:
            _when, _seq, t, fn, args = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            self._now = t.when
            fn(*args)
            ran += 1
        self._now = max(self._now, float(horizon))
        return ran

    def close(self) -> None:
        self._heap.clear()


class WallClock:
    """Real-time scheduler: one daemon timer thread over ``time.monotonic``
    — the production seam behind the same ``now``/``call_at`` interface as
    :class:`VirtualClock`.  Callback exceptions are printed, never fatal to
    the timer thread."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="front-door-timer", daemon=True)
        self._thread.start()

    def now(self) -> float:
        return time.monotonic()

    def call_at(self, when: float, fn: Callable, *args) -> Timer:
        t = Timer(float(when))
        if not math.isfinite(t.when):
            return t
        with self._cv:
            # Wake the timer thread only for a new earliest timer: it
            # already waits until the earliest one (each wake-up costs the
            # serving threads a turn at the interpreter lock).
            earliest = not self._heap or t.when < self._heap[0][0]
            heapq.heappush(self._heap, (t.when, next(self._seq), t, fn, args))
            if earliest:
                self._cv.notify()
        return t

    def call_later(self, delay: float, fn: Callable, *args) -> Timer:
        return self.call_at(self.now() + delay, fn, *args)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if not self._heap:
                    self._cv.wait()
                    continue
                delay = self._heap[0][0] - self.now()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                _when, _seq, t, fn, args = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            try:
                fn(*args)
            except Exception:       # pragma: no cover - defensive
                traceback.print_exc()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        # A deadline callback can itself trigger teardown — never join the
        # timer thread from the timer thread.
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------- dispatchers


def _resolve(spec, disp) -> float:
    return float(spec(disp)) if callable(spec) else float(spec)


class ThreadDispatcher:
    """Production dispatch: ``begin`` runs on one thread of its own, in
    flush order (:meth:`launch`), and ``finish`` on a small worker pool;
    the completion callback fires from the worker thread.  The probe is
    available as soon as the flight was dispatched (``begin`` already queued
    it on the device, and a partial waits for the probe's event), so
    deadline hedges can always ask for a partial.  The full result is put
    on the dispatch as soon as it is ready, before the callback waits for
    the door's lock."""

    def __init__(self, workers: int = 2):
        import concurrent.futures

        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, workers),
            thread_name_prefix="front-door-dispatch")
        self._begins = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="front-door-begin")

    def launch(self, fly: Callable[[], None]) -> None:
        """Run ``fly`` (the door's begin of registered dispatches) on the
        begin thread; its errors surface through the door's completions."""
        self._begins.submit(fly)

    def submit(self, disp: "_Dispatch", finish: Callable[[], BatchResult],
               on_done: Callable[[Any], None]) -> None:
        disp.probe_ready = True

        def run():
            try:
                res = finish()
            except Exception as e:   # surfaced as status "error"
                res = e
            else:
                disp.ready = res
            on_done(res)

        self._pool.submit(run)

    def close(self) -> None:
        # wait=False: the front door's drain already guarantees every
        # dispatch completed — and close may run *on* a worker thread (the
        # last completion claims engine teardown), where waiting would
        # deadlock on joining ourselves.
        self._begins.shutdown(wait=False)
        self._pool.shutdown(wait=False)


class VirtualDispatcher:
    """Deterministic dispatch for the virtual clock: the engine programs run
    *synchronously at submit* — so served results are bit-identical to a
    direct engine call by construction — while probe availability and
    completion are modelled as clock events at injectable times.

    ``service_time`` / ``probe_time``: seconds (float), a callable
    ``(dispatch) -> seconds``, or for ``service_time`` the string
    ``"measured"`` (the synchronous call's real wall time).  ``math.inf``
    models a wedged backend: the event never fires, and only the requests'
    deadline timers complete their futures (the hedge path)."""

    def __init__(self, clock, service_time: Any = 0.0,
                 probe_time: Any = 0.0):
        self.clock = clock
        self.service_time = service_time
        self.probe_time = probe_time

    def launch(self, fly: Callable[[], None]) -> None:
        """Run ``fly`` (the door's begin of registered dispatches) at once,
        on the flushing thread."""
        fly()

    def submit(self, disp: "_Dispatch", finish: Callable[[], BatchResult],
               on_done: Callable[[Any], None]) -> None:
        t0 = time.perf_counter()
        try:
            res = finish()
        except Exception as e:
            res = e
        wall = time.perf_counter() - t0
        if self.service_time == "measured":
            svc = wall
        else:
            svc = _resolve(self.service_time, disp)
        probe = min(_resolve(self.probe_time, disp), svc)
        self.clock.call_later(probe, self._mark_probe, disp)
        self.clock.call_later(svc, on_done, res)

    @staticmethod
    def _mark_probe(disp: "_Dispatch") -> None:
        disp.probe_ready = True

    def close(self) -> None:
        pass


# ------------------------------------------------------------- request model


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One admission class: its own deadline, coalescing knobs, and (via the
    front door's ``engines`` mapping) its own budget-law engine.

    ``deadline_s`` — default per-request deadline.  ``batch_window_s`` — max
    time the oldest pending lane waits for coalescing partners before the
    class flushes anyway.  ``max_lanes`` — flush as soon as this many lanes
    are pending.  ``lane_quantum`` — pad each dispatch to this lane grid
    (bounded batch-shape family under ragged traffic; see module
    docstring).
    """

    name: str
    deadline_s: float
    batch_window_s: float = 0.0
    max_lanes: int = 32
    lane_quantum: int = 1


@dataclasses.dataclass
class ServedResult:
    """One request's response.  ``ids``/``d2`` are the lane's top-k (None
    for shed/timeout); ``hops``/``budget`` are the lane's walk cost and
    granted budget when the engine reports them (the per-class I/O
    divergence the load benchmark plots); ``extras`` carries the lane's
    slice of the batch extras (e.g. shard ids, slow-tier counters)."""

    status: str
    qos: str
    t_arrival: float
    t_done: float
    ids: np.ndarray | None = None
    d2: np.ndarray | None = None
    hops: float | None = None
    budget: float | None = None
    note: str = ""
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


class RequestFuture:
    """Completed exactly once; thread-safe.  Under the virtual clock
    nothing ever blocks — drive the clock, then read ``result(timeout=0)``.
    """

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: ServedResult | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> ServedResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        return self._result

    def _complete(self, res: ServedResult) -> bool:
        with self._lock:
            if self._result is not None:
                return False
            self._result = res
        self._event.set()
        return True


@dataclasses.dataclass(eq=False)   # identity semantics: queries are arrays
class _Request:
    query: np.ndarray
    cls: QoSClass
    t_arrival: float
    deadline: float
    future: RequestFuture
    dispatch: "_Dispatch | None" = None
    timer: Timer | None = None


@dataclasses.dataclass(eq=False)   # identity semantics, hashable
class _Dispatch:
    """One flushed batch: the engine flight plus completion bookkeeping."""

    cls: QoSClass
    requests: list
    t_dispatch: float
    n_real: int
    flight: Any = None
    probe_ready: bool = False
    done: bool = False
    ready: BatchResult | None = None     # the full result, not yet delivered
    partial: BatchResult | None = None   # deadline hedge, computed once
    partial_failed: bool = False
    partial_lock: Any = dataclasses.field(default_factory=threading.Lock)


# ----------------------------------------------------------------- front door


class FrontDoor:
    """The async admission front door (see module docstring for the story).

    ``engines`` maps class name -> :class:`SearchEngine` (classes may share
    an engine; engines may share a backend).  ``clock`` / ``dispatcher``
    default to production seams (:class:`WallClock`,
    :class:`ThreadDispatcher`); tests inject :class:`VirtualClock` /
    :class:`VirtualDispatcher`.  ``max_queue`` bounds *open* lanes across
    all classes — queued plus dispatched-but-incomplete — so a wedged or
    slow backend fills the bound and later submits shed instead of
    accumulating unbounded work; deadline hedges complete stuck lanes and
    re-open admission (every admitted lane completes by its deadline at
    the latest)."""

    def __init__(self, engines: Mapping[str, SearchEngine],
                 classes: Iterable[QoSClass], *, max_queue: int = 256,
                 clock=None, dispatcher=None):
        self.classes = {c.name: c for c in classes}
        self.engines = dict(engines)
        missing = [n for n in self.classes if n not in self.engines]
        if missing:
            raise ValueError(f"no engine for QoS class(es) {missing}")
        self.max_queue = int(max_queue)
        self._own_clock = clock is None
        self.clock = WallClock() if clock is None else clock
        self._own_dispatcher = dispatcher is None
        self.dispatcher = (ThreadDispatcher() if dispatcher is None
                           else dispatcher)
        lacks = [m for m in ("launch", "submit", "close")
                 if not callable(getattr(self.dispatcher, m, None))]
        if lacks:
            raise TypeError(f"dispatcher {type(self.dispatcher).__name__} "
                            f"lacks {lacks}")
        self._lock = threading.RLock()
        self._pending: dict[str, list[_Request]] = {
            n: [] for n in self.classes}
        self._window_timers: dict[str, Timer | None] = {
            n: None for n in self.classes}
        self._inflight: set[int] = set()     # id(_Dispatch) of open batches
        self._queued_lanes = 0
        self._open = 0                       # admitted, future not complete
        self._closing = False
        self._engines_closed = False
        self._drained = threading.Event()
        self.counts: dict[str, int] = {
            s: 0 for s in (OK, PARTIAL, TIMEOUT, SHED, ERROR)}
        self.per_class: dict[str, dict[str, int]] = {
            n: {s: 0 for s in (OK, PARTIAL, TIMEOUT, SHED, ERROR)}
            for n in self.classes}
        self.submitted = 0
        self.admitted = 0
        self.dispatches = 0
        self.max_queued_lanes = 0
        self.max_open_lanes = 0

    # ---------------------------------------------------------- admission

    def submit(self, query, cls: str | None = None,
               deadline_s: float | None = None) -> RequestFuture:
        """Admit one query lane into ``cls`` (defaults to the sole class).
        Returns a future that completes exactly once — with a full result,
        a best-so-far partial, a timeout, or an immediate shed."""
        if cls is None:
            if len(self.classes) != 1:
                raise ValueError("multiple QoS classes; name one")
            cls = next(iter(self.classes))
        c = self.classes[cls]
        q = np.asarray(query)
        if q.ndim != 1:
            raise ValueError(f"submit() takes one lane (d,); got {q.shape}")
        fut = RequestFuture()
        with self._lock:
            now = self.clock.now()
            self.submitted += 1
            if self._closing or self._open >= self.max_queue:
                note = ("front door closing" if self._closing
                        else f"queue full ({self.max_queue} open lanes)")
                self._count(SHED, c.name)
                fut._complete(ServedResult(status=SHED, qos=c.name,
                                           t_arrival=now, t_done=now,
                                           note=note))
                return fut
            self.admitted += 1
            self._open += 1
            deadline = now + (c.deadline_s if deadline_s is None
                              else deadline_s)
            req = _Request(query=q, cls=c, t_arrival=now, deadline=deadline,
                           future=fut)
            self._pending[c.name].append(req)
            self._queued_lanes += 1
            self.max_open_lanes = max(self.max_open_lanes, self._open)
            self.max_queued_lanes = max(self.max_queued_lanes,
                                        self._queued_lanes)
            req.timer = self.clock.call_at(deadline, self._on_deadline, req)
            todo = []
            if len(self._pending[c.name]) >= c.max_lanes:
                todo = self._flush_class(c)
            else:
                self._arm_window(c)
        self._launch(todo)
        return fut

    # ------------------------------------------------------------ flushing

    def _arm_window(self, c: QoSClass) -> None:
        """(lock held) Keep the invariant: pending lanes of a class always
        have a live window timer at oldest-arrival + batch_window_s."""
        t = self._window_timers[c.name]
        if t is not None:
            t.cancel()
        self._window_timers[c.name] = None
        pend = self._pending[c.name]
        if pend:
            when = max(self.clock.now(),
                       pend[0].t_arrival + c.batch_window_s)
            self._window_timers[c.name] = self.clock.call_at(
                when, self._on_window, c)

    def _on_window(self, c: QoSClass) -> None:
        with self._lock:
            self._window_timers[c.name] = None
            todo = (self._flush_class(c, force=True)
                    if self._pending[c.name] else [])
        self._launch(todo)

    def _flush_class(self, c: QoSClass, force: bool = False) -> list:
        """(lock held) Pop pending lanes into engine dispatches —
        ``max_lanes`` at a time, all of them when forced (window expiry,
        shutdown drain).  Returns them for :meth:`_launch`, which the caller
        runs once it has released the lock."""
        pend = self._pending[c.name]
        todo = []
        while pend and (force or len(pend) >= c.max_lanes):
            take, self._pending[c.name] = pend[:c.max_lanes], pend[c.max_lanes:]
            pend = self._pending[c.name]
            todo.append(self._dispatch_batch(c, take))
        self._arm_window(c)
        return todo

    def _dispatch_batch(self, c: QoSClass, reqs: list) -> tuple:
        """(lock held) Register one engine dispatch; returns what
        :meth:`_launch` needs to fly it."""
        now = self.clock.now()
        self._queued_lanes -= len(reqs)
        lanes = [r.query for r in reqs]
        quantum = max(1, c.lane_quantum)
        pad = (-len(lanes)) % quantum
        batch = np.stack(lanes + [lanes[0]] * pad)
        disp = _Dispatch(cls=c, requests=list(reqs), t_dispatch=now,
                         n_real=len(reqs))
        for r in reqs:
            r.dispatch = disp
        self._inflight.add(id(disp))
        self.dispatches += 1
        return self.engines[c.name], disp, batch

    def _launch(self, todo: list) -> None:
        """(lock not held) Begin the registered dispatches where the
        dispatcher says: :class:`ThreadDispatcher` on its begin thread (see
        "On the card"), :class:`VirtualDispatcher` here and now (the
        reference's timing)."""
        if todo:
            self.dispatcher.launch(functools.partial(self._fly, todo))

    def _fly(self, todo: list) -> None:
        """Begin each dispatch and hand its finish to the dispatcher seam;
        a deadline that fires first finds no probe yet.  A dispatch whose
        lanes all completed before its turn is not begun."""
        for engine, disp, batch in todo:
            if all(r.future.done() for r in disp.requests):
                self._handle_done(disp, None)
                continue
            try:
                disp.flight = engine.begin(batch)
            except Exception as e:
                self._handle_done(disp, e)
                continue
            self.dispatcher.submit(
                disp, functools.partial(engine.finish_from, disp.flight),
                functools.partial(self._handle_done, disp))

    # ---------------------------------------------------------- completion

    def _count(self, status: str, cls: str) -> None:
        self.counts[status] += 1
        self.per_class[cls][status] += 1

    def _complete(self, req: _Request, status: str, now: float,
                  note: str = "") -> None:
        """(lock held) Complete a request without results (shed in queue /
        timeout / error)."""
        if req.timer is not None:
            req.timer.cancel()
        if req.future._complete(ServedResult(
                status=status, qos=req.cls.name, t_arrival=req.t_arrival,
                t_done=now, note=note)):
            self._count(status, req.cls.name)
            self._open -= 1

    def _complete_row(self, req: _Request, res: BatchResult, row: int,
                      status: str, now: float) -> None:
        """(lock held) Complete a request from row ``row`` of a batch
        result (full or partial)."""
        if req.timer is not None:
            req.timer.cancel()
        hops = budget = None
        if res.stats is not None:
            hops = float(np.asarray(res.stats.hops)[row])
        if res.astats is not None:
            # Distributed budgets are per (query, shard): report the mean.
            budget = float(np.mean(np.asarray(res.astats.budget)[row]))
        n = res.ids.shape[0]
        extras = {k: v[row] if isinstance(v, np.ndarray) and v.shape[:1] == (n,)
                  else v for k, v in res.extras.items()}
        if req.future._complete(ServedResult(
                status=status, qos=req.cls.name, t_arrival=req.t_arrival,
                t_done=now, ids=np.array(res.ids[row]),
                d2=np.array(res.d2[row]), hops=hops, budget=budget,
                extras=extras)):
            self._count(status, req.cls.name)
            self._open -= 1

    def _handle_done(self, disp: _Dispatch, res) -> None:
        """Dispatch completion (worker thread or clock event).  Completes
        every still-open future of the batch; deadline hedges that already
        completed a row win — the late full result never overwrites."""
        with self._lock:
            disp.done = True
            self._inflight.discard(id(disp))
            now = self.clock.now()
            for row, req in enumerate(disp.requests):
                if req.future.done():
                    continue
                if isinstance(res, Exception):
                    self._complete(req, ERROR, now, note=repr(res))
                else:
                    self._complete_row(req, res, row, OK, now)
            should_close = self._drain_check()
        if should_close:
            self._close_engines()

    def _partial_of(self, disp: _Dispatch) -> BatchResult | None:
        """Best-so-far batch result at the probe horizon, computed at most
        once per dispatch, without the door's lock (on the card it copies
        and reranks the probe beam: about a millisecond).  None when the
        probe is unavailable (not begun, or a wedged backend), the engine
        has no host-side probe view, or the full result is ready."""
        with disp.partial_lock:
            if disp.partial is not None:
                return disp.partial
            if (disp.partial_failed or not disp.probe_ready
                    or disp.flight is None or disp.ready is not None):
                return None
            engine = self.engines[disp.cls.name]
            if not engine.supports_partial:
                disp.partial_failed = True
                return None
            try:
                disp.partial = engine.partial_result(disp.flight)
            except Exception:
                disp.partial_failed = True
                return None
            return disp.partial

    def _on_deadline(self, req: _Request) -> None:
        with self._lock:
            if req.future.done():
                return
            disp = req.dispatch
            if disp is None:
                # Still queued: free the slot, complete as timeout.
                pend = self._pending[req.cls.name]
                if req in pend:
                    pend.remove(req)
                    self._queued_lanes -= 1
                    self._arm_window(req.cls)
                self._complete(req, TIMEOUT, self.clock.now(),
                               note="deadline expired in queue")
                should_close = self._drain_check()
        if disp is not None:
            partial = self._partial_of(disp)
            with self._lock:
                if not req.future.done():
                    now = self.clock.now()
                    row = disp.requests.index(req)
                    if disp.ready is not None:   # landed while hedging
                        self._complete_row(req, disp.ready, row, OK, now)
                    elif partial is not None:
                        self._complete_row(req, partial, row, PARTIAL, now)
                    else:
                        self._complete(req, TIMEOUT, now,
                                       note="deadline expired in flight")
                if all(r.future.done() for r in disp.requests):
                    # A wedged dispatch never reports done; once every lane
                    # is hedged the batch is no longer tracked as open.
                    self._inflight.discard(id(disp))
                should_close = self._drain_check()
        if should_close:
            self._close_engines()

    # ------------------------------------------------------------ lifecycle

    @property
    def drained(self) -> bool:
        """True once every admitted request completed after ``close()``
        (and the engines are closed)."""
        return self._drained.is_set()

    def _drain_check(self) -> bool:
        """(lock held) Claim engine teardown exactly once, when closing and
        every admitted request has completed."""
        if self._closing and self._open == 0 and not self._engines_closed:
            self._engines_closed = True
            return True
        return False

    def _close_engines(self) -> None:
        """Engine/backend teardown, outside the lock (pool shutdowns block).
        Each *distinct* engine closes exactly once; engine close itself is
        idempotent, so classes sharing a backend are safe too."""
        seen: list = []
        for eng in self.engines.values():
            if not any(eng is s for s in seen):
                seen.append(eng)
                eng.close()
        if self._own_dispatcher:
            self.dispatcher.close()
        if self._own_clock:
            self.clock.close()
        self._drained.set()

    def close(self, wait: bool = True, timeout: float | None = None) -> None:
        """Drain and shut down: stop admitting (later submits shed), flush
        every pending lane immediately, let every admitted request complete
        (full results, or best-so-far/timeout via its deadline timer), then
        close each distinct engine exactly once.  Idempotent, any thread.

        ``wait`` blocks until drained — meaningful with the wall clock only;
        under a virtual clock use :func:`drain_virtual` (close can't drive
        virtual time)."""
        todo = []
        with self._lock:
            first = not self._closing
            self._closing = True
            if first:
                for c in self.classes.values():
                    if self._pending[c.name]:
                        todo += self._flush_class(c, force=True)
            should_close = self._drain_check()
        self._launch(todo)
        if should_close:
            self._close_engines()
        if wait and not self._drained.wait(timeout):
            raise TimeoutError("front door did not drain in time")

    # -------------------------------------------------------- observability

    def stats(self) -> dict:
        """Admission/outcome counters (snapshot)."""
        with self._lock:
            return {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "dispatches": self.dispatches,
                "queued_lanes": self._queued_lanes,
                "open_lanes": self._open,
                "max_queued_lanes": self.max_queued_lanes,
                "max_open_lanes": self.max_open_lanes,
                **{s: self.counts[s]
                   for s in (OK, PARTIAL, TIMEOUT, SHED, ERROR)},
                "per_class": {n: dict(c)
                              for n, c in self.per_class.items()},
            }


def drain_virtual(door: FrontDoor, clock: VirtualClock, *,
                  step: float = 0.05, max_steps: int = 100_000) -> None:
    """Close a virtual-clock front door and advance the clock until it
    drains (tests and replays share this; the wall-clock path just calls
    ``close(wait=True)``)."""
    door.close(wait=False)
    for _ in range(max_steps):
        if door.drained:
            return
        clock.advance(step)
    raise RuntimeError("front door failed to drain under the virtual clock")
