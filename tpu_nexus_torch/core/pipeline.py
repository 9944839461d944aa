"""Generic rate-limited work-queue actor: a copy of
``tpu_nexus/core/pipeline.py``.

Equivalent of nexus-core `pipeline.DefaultPipelineStageActor[In, Out]` as
consumed at reference services/supervisor.go:38,107-117,377-387 (behavior
contract in SURVEY.md §2.3):

  * `receive(elem)` enqueues from any thread / informer callback and returns
    immediately (the classify-then-enqueue seam, SURVEY §3.2);
  * N worker tasks drain the queue through `process_fn`;
  * a token bucket (rate/s + burst) throttles dequeues;
  * a failed element (process_fn raises) is re-delivered after exponential
    backoff base*2^attempt capped at max (reference defaults 100ms -> 1s,
    .helm/values.yaml:145-149);
  * an optional `next_stage` actor receives successful outputs (nil in the
    reference supervisor — kept for parity with the chained-pipeline API);
  * `start(ctx, post_start)` BLOCKS for the process lifetime, running
    `post_start` once workers are up (the reference starts informers there,
    services/supervisor.go:377-384).

Implementation is a single asyncio loop (SURVEY §7.1: the hot path is
I/O-bound; 10 events/s default), with thread-safe `receive` so sync
callbacks and tests can feed it.
"""

from __future__ import annotations

import asyncio
import threading
import time
from datetime import timedelta
from typing import Awaitable, Callable, Generic, Mapping, Optional, Tuple, TypeVar, Union

from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics, VLogger, get_logger

In = TypeVar("In")
Out = TypeVar("Out")

ProcessFn = Callable[[In], Union[Out, Awaitable[Out]]]


class TokenBucket:
    """Async token bucket: `rate` tokens/s, capacity `burst`.

    Virtual-slot (GCRA-style) implementation: each acquire is assigned its
    admission time under the lock — in strict arrival order, so waiters are
    FIFO and cannot be starved by newcomers — then sleeps OUTSIDE the lock
    until its slot.  One sleep per acquire, no re-check loop, no thundering
    herd, and burst capacity is spendable at once (the slot floor trails
    `now` by (burst-1)/rate, which is exactly "burst tokens available after
    idle refill").

    rate <= 0 disables limiting (always admits immediately).
    """

    def __init__(self, rate: float, burst: int) -> None:
        self.rate = float(rate)
        self.burst = max(1, int(burst)) if rate > 0 else 0
        self._next_slot = 0.0
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        if self.rate <= 0:
            return
        async with self._lock:
            now = time.monotonic()
            slot = max(self._next_slot, now - (self.burst - 1) / self.rate)
            self._next_slot = slot + 1.0 / self.rate
        wait = slot - now
        if wait > 0:
            try:
                await asyncio.sleep(wait)
            except asyncio.CancelledError:
                # refund the abandoned slot: without this a burst of cancelled
                # waiters (task teardown) advances _next_slot far into the
                # future and throttles later acquires for work that never ran.
                # Single assignment on the event-loop thread — no lock needed.
                # Accepted tradeoff: the freed instant is this waiter's, but
                # the refund shrinks the TAIL, so when OTHER waiters are still
                # sleeping a fresh acquire can land on the same instant as one
                # of them — a transient simultaneous admission, bounded by the
                # number of cancellations, with the average rate preserved.
                # Exact hole tracking would need a reservation heap; not
                # worth it for a work-queue throttle.
                self._next_slot -= 1.0 / self.rate
                raise


class PipelineStageActor(Generic[In, Out]):
    """Rate-limited multi-worker actor with exponential failure backoff."""

    def __init__(
        self,
        name: str,
        tags: Optional[Mapping[str, str]] = None,
        failure_base_delay: timedelta = timedelta(milliseconds=100),
        failure_max_delay: timedelta = timedelta(seconds=1),
        rate_per_second: float = 10.0,
        burst: int = 100,
        workers: int = 2,
        process_fn: Optional[ProcessFn] = None,
        next_stage: Optional["PipelineStageActor"] = None,
        metrics: Optional[Metrics] = None,
        logger: Optional[VLogger] = None,
    ) -> None:
        if process_fn is None:
            raise ValueError("process_fn is required")
        self.name = name
        self.tags = dict(tags or {})
        self._base_delay = failure_base_delay.total_seconds()
        self._max_delay = failure_max_delay.total_seconds()
        self._workers_n = max(1, workers)
        self._process_fn = process_fn
        self._next_stage = next_stage
        self._metrics = metrics or NullMetrics()
        self._log = logger or get_logger(f"tpu_nexus_torch.pipeline.{name}")
        self._bucket = TokenBucket(rate_per_second, burst)
        self._queue: "asyncio.Queue[Tuple[In, int]]" = asyncio.Queue()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._prestart_buffer: list = []
        self._ingest_lock = threading.Lock()  # guards _loop/_prestart_buffer handoff
        self._inflight = 0
        self._pending_retries = 0
        self._retry_tasks: set = set()
        self._started = asyncio.Event()
        self.processed = 0
        self.failed = 0
        self.retried = 0

    # -- ingestion ----------------------------------------------------------

    def receive(self, elem: In) -> None:
        """Enqueue an element; safe from any thread, returns immediately."""
        self._enqueue(elem, 0)

    def _enqueue(self, elem: In, attempts: int) -> None:
        with self._ingest_lock:
            if self._loop is None:
                self._prestart_buffer.append((elem, attempts))
                return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            self._queue.put_nowait((elem, attempts))
        else:
            self._loop.call_soon_threadsafe(self._queue.put_nowait, (elem, attempts))

    # -- lifecycle ----------------------------------------------------------

    async def start(
        self,
        ctx: LifecycleContext,
        post_start: Optional[Callable[[], Union[None, Awaitable[None]]]] = None,
    ) -> None:
        """Run workers until ctx is cancelled.  Blocks (like the reference)."""
        with self._ingest_lock:
            self._loop = asyncio.get_running_loop()
            buffered, self._prestart_buffer = self._prestart_buffer, []
        for elem, attempts in buffered:
            self._queue.put_nowait((elem, attempts))
        workers = [
            asyncio.create_task(self._worker(i), name=f"{self.name}-worker-{i}")
            for i in range(self._workers_n)
        ]
        self._started.set()
        try:
            if post_start is not None:
                result = post_start()
                if asyncio.iscoroutine(result):
                    await result
            await ctx.wait()
        finally:
            for w in workers:
                w.cancel()
            for t in list(self._retry_tasks):
                t.cancel()
            await asyncio.gather(*workers, *self._retry_tasks, return_exceptions=True)

    async def _worker(self, index: int) -> None:
        while True:
            elem, attempts = await self._queue.get()
            self._inflight += 1  # before the bucket: rate-limit waits count as in-flight
            try:
                await self._bucket.acquire()
            except asyncio.CancelledError:
                self._inflight -= 1
                raise
            t0 = time.perf_counter()
            try:
                result = self._process_fn(elem)
                if asyncio.iscoroutine(result):
                    result = await result
            except asyncio.CancelledError:
                self._inflight -= 1
                raise
            except Exception as exc:  # noqa: BLE001 - actor isolation: any element failure becomes retry-with-backoff
                self.failed += 1
                self._metrics.count(f"{self.name}.failures", tags=self.tags)
                delay = min(self._base_delay * (2.0 ** attempts), self._max_delay)
                self._log.warning(
                    "element processing failed; re-delivering with backoff",
                    actor=self.name,
                    attempts=attempts + 1,
                    delay_s=round(delay, 4),
                    error=repr(exc),
                )
                self.retried += 1
                self._pending_retries += 1
                task = asyncio.create_task(self._redeliver(elem, attempts + 1, delay))
                self._retry_tasks.add(task)
                task.add_done_callback(self._retry_tasks.discard)
            else:
                self.processed += 1
                self._metrics.count(f"{self.name}.processed", tags=self.tags)
                self._metrics.timing(f"{self.name}.process_seconds", time.perf_counter() - t0, tags=self.tags)
                if self._next_stage is not None and result is not None:
                    self._next_stage.receive(result)
            finally:
                self._inflight -= 1
                self._metrics.gauge(f"{self.name}.queue_depth", self._queue.qsize(), tags=self.tags)
                self._queue.task_done()

    async def _redeliver(self, elem: In, attempts: int, delay: float) -> None:
        try:
            await asyncio.sleep(delay)
            self._queue.put_nowait((elem, attempts))
        finally:
            self._pending_retries -= 1

    # -- test support -------------------------------------------------------

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    async def wait_started(self) -> None:
        await self._started.wait()

    async def idle(self, timeout: float = 10.0, settle: float = 0.02) -> bool:
        """Poll-with-deadline until the actor has fully drained (no queued
        items, no in-flight work, no scheduled retries).  Replaces the
        reference test suite's fixed sleeps (SURVEY §4 flake-risk note)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.qsize() == 0 and self._inflight == 0 and self._pending_retries == 0:
                await asyncio.sleep(settle)
                if self._queue.qsize() == 0 and self._inflight == 0 and self._pending_retries == 0:
                    return True
            await asyncio.sleep(0.005)
        return False


def new_actor_post_start(fn: Callable[[], Union[None, Awaitable[None]]]):
    """Parity shim for nexus-core `NewActorPostStart` (services/supervisor.go:378)."""
    return fn
