"""Event queues — DAOS-style non-blocking I/O.

Every DAOS API call can run asynchronously against an event queue
(daos_eq_create / daos_event_test / daos_eq_poll).  The checkpointer uses this
to overlap checkpoint serialisation + store writes with the next training
steps.  Implementation: a thread pool per queue; an Event is a future with
DAOS test/poll semantics.

``SubmissionQueue`` is the *data-path* sibling: the per-handle queue behind
``FileHandle.write_at_async``/``read_at_async``.  Where ``EventQueue`` runs
arbitrary callables on real threads, the submission queue is deterministic
and threadless — queued IODs execute lazily, in submission order, bounded by
a per-engine in-flight window of ``qd`` — because the cost of concurrency is
charged by the simulation's solver, not by host parallelism.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading as _threading
import time as _time
from collections import Counter
from typing import Any, Callable, Iterable


class Event:
    def __init__(self, future: _fut.Future) -> None:
        self._future = future

    def test(self) -> bool:
        """Non-blocking completion probe (daos_event_test)."""
        return self._future.done()

    def wait(self, timeout: float | None = None) -> Any:
        return self._future.result(timeout)

    def on_complete(self, fn: Callable[["Event"], Any]) -> "Event":
        """Completion-callback chaining (the daos_event callback slot):
        ``fn(self)`` runs exactly once when this event completes — on the
        worker thread that completed it, or immediately on the caller if
        it already has.  Callbacks are allowed to submit follow-on work to
        the queue; that is the chaining.  The event completes (and
        ``wait`` returns) regardless of what the callback does — an
        exception inside ``fn`` is swallowed by the future machinery, so
        callbacks that can fail must capture their own errors."""
        self._future.add_done_callback(lambda _f: fn(self))
        return self

    @property
    def error(self) -> BaseException | None:
        return self._future.exception() if self._future.done() else None


class EventQueue:
    """daos_eq_*: submit async ops, poll for completions.

    ``depth`` is a real bound: once that many events are in flight,
    ``submit`` first poll-retires completions and, if the queue is still
    full, blocks on the oldest in-flight event before admitting the new one
    (daos_eq semantics — the queue is the backpressure).  Errors of events
    retired that way are not lost: they re-raise at the next ``drain``.

    The queue is thread-safe: completion callbacks (``on_complete``) run
    on worker threads and may submit follow-on events, so the in-flight
    list is guarded by a lock (waits happen outside it).
    """

    def __init__(self, depth: int = 8) -> None:
        self.depth = max(1, int(depth))
        self._pool = _fut.ThreadPoolExecutor(max_workers=self.depth,
                                             thread_name_prefix="repro-eq")
        self._inflight: list[Event] = []
        self._errors: list[BaseException] = []
        self._lock = _threading.Lock()

    def submit(self, fn: Callable, /, *args,
               on_complete: Callable[[Event], Any] | None = None,
               **kwargs) -> Event:
        while True:
            with self._lock:
                if len(self._inflight) < self.depth:
                    ev = Event(self._pool.submit(fn, *args, **kwargs))
                    self._inflight.append(ev)
                    break
            # full: poll-retire completions first, then block on the oldest
            for done in self.poll():
                if done.error is not None:
                    self._errors.append(done.error)
            with self._lock:
                oldest = (self._inflight[0]
                          if len(self._inflight) >= self.depth else None)
            if oldest is None:
                continue
            try:
                oldest.wait()
            except BaseException as exc:  # noqa: BLE001 — re-raised at drain
                self._errors.append(exc)
            with self._lock:
                if self._inflight and self._inflight[0] is oldest:
                    self._inflight.pop(0)
        if on_complete is not None:
            # registered after admission: if the event already completed,
            # the callback fires right here on the submitting thread
            ev.on_complete(on_complete)
        return ev

    def poll(self) -> list[Event]:
        """Return (and retire) completed events.  ``test()`` is snapshotted
        exactly once per event: probing twice would let an event complete
        between the probes and vanish from both the returned and retained
        lists."""
        done: list[Event] = []
        pending: list[Event] = []
        with self._lock:
            for e in self._inflight:
                (done if e.test() else pending).append(e)
            self._inflight[:] = pending
        return done

    def drain(self, timeout: float | None = None) -> None:
        """Wait for everything in flight; re-raise the first error.

        ``timeout`` is a deadline over the whole drain, not a per-event
        allowance — draining N slow events takes at most ``timeout``
        seconds before TimeoutError, not N * timeout."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        errs = self._errors
        self._errors = []
        with self._lock:
            inflight = list(self._inflight)
        for e in inflight:
            try:
                left = (None if deadline is None
                        else max(0.0, deadline - _time.monotonic()))
                e.wait(left)
            except BaseException as exc:  # noqa: BLE001 — surfaced below
                errs.append(exc)
        # retire only the snapshot: events chained in by completion
        # callbacks DURING the drain stay in flight for the next one
        with self._lock:
            self._inflight[:] = [e for e in self._inflight
                                 if e not in inflight]
        if errs:
            raise errs[0]

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "EventQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class QueuedOp:
    """One queued IOD: an event with DAOS test/wait semantics, completed by
    its queue's deterministic in-order execution."""

    __slots__ = ("_sq", "_fn", "engines", "_done", "_result", "_error")

    def __init__(self, sq: "SubmissionQueue", fn: Callable[[], Any],
                 engines: Iterable[int] = ()) -> None:
        self._sq = sq
        self._fn = fn
        self.engines = frozenset(engines)
        self._done = False
        self._result: Any = None
        self._error: BaseException | None = None

    def _run(self) -> None:
        if self._done:
            return
        try:
            self._result = self._fn()
        except BaseException as exc:  # noqa: BLE001 — surfaced at wait/flush
            self._error = exc
        self._done = True

    def test(self) -> bool:
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        """Force completion.  Ops ahead of this one in the queue execute
        first (submission order is completion order — ordered commit)."""
        self._sq.flush_until(self)
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def error(self) -> BaseException | None:
        return self._error if self._done else None


class SubmissionQueue:
    """Per-handle async submission: at most ``qd`` IODs in flight per engine.

    Submission beyond the window retires the oldest queued ops first (the
    submitting process blocks on a completion slot — exactly the
    backpressure the solver's in-flight window models).  ``qd <= 1``
    degenerates to immediate execution: the async API then produces
    byte- and flow-identical accounting to the sync path.
    """

    def __init__(self, qd: int = 1) -> None:
        self.qd = max(1, int(qd))
        self._pending: list[QueuedOp] = []
        self._first_error: BaseException | None = None
        self._executing = False

    # -- internals -----------------------------------------------------------
    def _run_op(self, op: QueuedOp) -> None:
        # ops may re-enter the handle's sync paths (cache fills, RMW reads);
        # the guard stops such nested calls from being queued behind the op
        # that issued them, which would deadlock the in-order contract
        self._executing = True
        try:
            op._run()
        finally:
            self._executing = False
        if op._error is not None and self._first_error is None:
            self._first_error = op._error

    def _over_window(self) -> bool:
        seen: Counter = Counter()
        for op in self._pending:
            for key in (op.engines or (None,)):
                seen[key] += 1
                if seen[key] > self.qd:
                    return True
        return False

    # -- submission ----------------------------------------------------------
    def submit(self, fn: Callable[[], Any],
               engines: Iterable[int] = ()) -> QueuedOp:
        op = QueuedOp(self, fn, engines)
        if self.qd <= 1 or self._executing:
            self._run_op(op)
            return op
        self._pending.append(op)
        while self._pending and self._over_window():
            self._run_op(self._pending.pop(0))
        return op

    # -- completion ----------------------------------------------------------
    def flush_until(self, op: QueuedOp) -> None:
        if op._done:
            return
        while self._pending:
            nxt = self._pending.pop(0)
            self._run_op(nxt)
            if nxt is op:
                return

    def flush(self) -> None:
        """Retire every queued op in submission order; re-raise the first
        error any op in this queue ever hit (including ones force-retired
        by window backpressure)."""
        while self._pending:
            self._run_op(self._pending.pop(0))
        err, self._first_error = self._first_error, None
        if err is not None:
            raise err

    def discard(self) -> None:
        """Abort path: queued-but-unexecuted ops never reach the engines.
        Each is completed with a TxStateError so a caller holding its event
        learns the write was torn away rather than silently dropped."""
        from .transactions import TxStateError
        for op in self._pending:
            op._done = True
            op._error = TxStateError(
                "queued submission discarded (transaction aborted)")
        self._pending.clear()
        self._first_error = None

    @property
    def inflight(self) -> int:
        return len(self._pending)
