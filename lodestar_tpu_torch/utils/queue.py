"""JobItemQueue — bounded async job queue with FIFO/LIFO order.

The port's copy of `lodestar_tpu/utils/queue.py`; it imports nothing of the
JAX package.

Mirror of the reference's util queue (reference:
packages/beacon-node/src/util/queue/itemQueue.ts): jobs are enqueued
with a max length (overflow rejects the NEWEST for FIFO / evicts via
error for LIFO), executed with bounded concurrency, yielding to other
work periodically.  Used by the regen analog and the block processor;
the BLS service has its own coalescing buffer (bls/service.py).

Thread-based rather than event-loop-based: the TPU framework's
concurrency model is a small number of host threads feeding one device
stream, so a worker thread + condition variable is the idiomatic shape.
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class QueueError(RuntimeError):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class QueueType(enum.Enum):
    FIFO = "FIFO"
    LIFO = "LIFO"


class QueueMetrics:
    __slots__ = ("length", "dropped_jobs", "job_time", "job_wait_time")

    def __init__(self):
        self.length = 0
        self.dropped_jobs = 0
        self.job_time = []
        self.job_wait_time = []


class JobItemQueue(Generic[T, R]):
    """Execute `process_fn(item)` for queued items, concurrency 1.

    push() returns a Future; on overflow the queue rejects:
      FIFO: the incoming job errors (queue keeps oldest work),
      LIFO: the oldest queued job errors (queue keeps newest work).
    """

    def __init__(
        self,
        process_fn: Callable[[T], R],
        max_length: int = 256,
        queue_type: QueueType = QueueType.FIFO,
        yield_every_ms: float = 50.0,
    ):
        self.process_fn = process_fn
        self.max_length = max_length
        self.queue_type = queue_type
        self.yield_every = yield_every_ms / 1000.0
        self.metrics = QueueMetrics()
        self._items: Deque[Tuple[T, Future, float]] = deque()
        self._lock = threading.Condition()
        self._stopped = False
        self._worker = threading.Thread(
            target=self._run, name="job-item-queue", daemon=True
        )
        self._worker.start()

    def __len__(self) -> int:
        return len(self._items)

    def can_accept_work(self, threshold: int = 16) -> bool:
        """Backpressure signal (reference: regen queued.ts:52 uses a
        16-job threshold against its 256 cap)."""
        return not self._stopped and len(self._items) < threshold

    def push(self, item: T) -> "Future[R]":
        # futures settle AFTER the lock releases: set_exception runs
        # done-callbacks synchronously on this thread, and a callback
        # that re-enters the queue (or blocks) must not do so inside
        # the Condition (tpulint async-lock-safety)
        fut: Future = Future()
        reject: Optional[QueueError] = None
        dropped: Optional[Future] = None
        with self._lock:
            if self._stopped:
                reject = QueueError("QUEUE_ABORTED")
            elif len(self._items) >= self.max_length:
                self.metrics.dropped_jobs += 1
                if self.queue_type is QueueType.FIFO:
                    reject = QueueError("QUEUE_MAX_LENGTH")
                else:  # LIFO: evict oldest
                    _, dropped, _ = self._items.popleft()
            if reject is None:
                self._items.append((item, fut, time.perf_counter()))
                self.metrics.length = len(self._items)
                self._lock.notify()
        if reject is not None:
            fut.set_exception(reject)
        if dropped is not None:
            dropped.set_exception(QueueError("QUEUE_MAX_LENGTH"))
        return fut

    def _next(self):
        if self.queue_type is QueueType.FIFO:
            return self._items.popleft()
        return self._items.pop()

    def _run(self) -> None:
        last_yield = time.perf_counter()
        while True:
            with self._lock:
                while not self._items and not self._stopped:
                    self._lock.wait()
                if self._stopped:
                    return
                item, fut, t_push = self._next()
                self.metrics.length = len(self._items)
            t0 = time.perf_counter()
            self.metrics.job_wait_time.append(t0 - t_push)
            try:
                res = self.process_fn(item)
                if not fut.done():
                    fut.set_result(res)
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
            self.metrics.job_time.append(time.perf_counter() - t0)
            # yield the core periodically so submitters make progress
            if time.perf_counter() - last_yield > self.yield_every:
                time.sleep(0)
                last_yield = time.perf_counter()

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            pending = list(self._items)
            self._items.clear()
            self._lock.notify_all()
        for _, fut, _ in pending:
            if not fut.done():
                fut.set_exception(QueueError("QUEUE_ABORTED"))
        self._worker.join(timeout=5)
