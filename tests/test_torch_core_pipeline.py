"""The port's counterpart of ``tests/test_core_pipeline.py`` (``tpu_nexus_torch``).

Tests for the rate-limited actor (nexus-core DefaultPipelineStageActor
parity, SURVEY §2.3): multi-worker draining, exponential failure backoff
re-delivery, token-bucket rate limiting, next-stage chaining."""

import asyncio
import time
from datetime import timedelta

from tpu_nexus_torch.core.pipeline import PipelineStageActor, TokenBucket
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import RecordingMetrics


async def run_actor_until_idle(actor, ctx, timeout=10.0):
    task = asyncio.create_task(actor.start(ctx))
    await actor.wait_started()
    assert await actor.idle(timeout=timeout)
    ctx.cancel()
    await task


async def test_processes_all_elements_and_chains_next_stage():
    seen = []
    sink = PipelineStageActor(
        "sink", process_fn=lambda x: seen.append(x), rate_per_second=0, workers=1
    )
    doubler = PipelineStageActor(
        "double", process_fn=lambda x: x * 2, rate_per_second=0, workers=4, next_stage=sink
    )
    ctx = LifecycleContext()
    for i in range(20):
        doubler.receive(i)  # pre-start buffering must work (informers race startup)
    t1 = asyncio.create_task(doubler.start(ctx))
    t2 = asyncio.create_task(sink.start(ctx))
    await doubler.wait_started()
    assert await doubler.idle()
    assert await sink.idle()
    ctx.cancel()
    await asyncio.gather(t1, t2)
    assert sorted(seen) == [i * 2 for i in range(20)]
    assert doubler.processed == 20


async def test_failure_redelivery_with_backoff():
    attempts = {}
    metrics = RecordingMetrics()

    def flaky(x):
        attempts[x] = attempts.get(x, 0) + 1
        if attempts[x] < 3:
            raise RuntimeError("transient")
        return x

    actor = PipelineStageActor(
        "flaky",
        process_fn=flaky,
        rate_per_second=0,
        workers=2,
        failure_base_delay=timedelta(milliseconds=5),
        failure_max_delay=timedelta(milliseconds=20),
        metrics=metrics,
    )
    ctx = LifecycleContext()
    actor.receive("a")
    actor.receive("b")
    await run_actor_until_idle(actor, ctx)
    assert attempts == {"a": 3, "b": 3}
    assert actor.failed == 4  # two failures per element
    assert actor.processed == 2
    assert metrics.counters["flaky.processed"] == 2
    assert metrics.counters["flaky.failures"] == 4


async def test_token_bucket_throttles():
    bucket = TokenBucket(rate=100.0, burst=1)
    t0 = time.monotonic()
    for _ in range(6):
        await bucket.acquire()
    elapsed = time.monotonic() - t0
    # 1 burst token + 5 refills at 100/s => >= ~50ms
    assert elapsed >= 0.04


async def test_token_bucket_burst_admits_concurrently():
    """Waiters sleep OUTSIDE the bucket lock: concurrent acquirers on a
    drained bucket share the refill stream instead of serializing behind a
    single lock-holding sleeper, and burst capacity is spendable at once."""
    import asyncio

    bucket = TokenBucket(rate=100.0, burst=8)
    t0 = time.monotonic()
    await asyncio.gather(*(bucket.acquire() for _ in range(8)))
    assert time.monotonic() - t0 < 0.05  # all 8 burst tokens spent at once
    # drained: 4 concurrent waiters need 4 refills at 100/s ~= 40ms total,
    # which also proves no waiter sat behind another's full sleep chain
    t0 = time.monotonic()
    await asyncio.gather(*(bucket.acquire() for _ in range(4)))
    elapsed = time.monotonic() - t0
    assert 0.02 <= elapsed < 0.5


async def test_token_bucket_refunds_cancelled_waiters():
    """A cancelled waiter must hand its admission slot back: a burst of
    cancellations (task teardown) must not throttle later acquires for work
    that never ran."""
    import asyncio

    bucket = TokenBucket(rate=10.0, burst=1)
    await bucket.acquire()  # spend the burst token; bucket now drained
    # 20 waiters would reserve slots 2s into the future...
    waiters = [asyncio.create_task(bucket.acquire()) for _ in range(20)]
    await asyncio.sleep(0.01)
    for w in waiters:
        w.cancel()
    await asyncio.gather(*waiters, return_exceptions=True)
    # ...but every cancelled slot was refunded, so a fresh acquire waits at
    # most ~1 refill (100ms), not the 2s the abandoned slots reserved
    t0 = time.monotonic()
    await bucket.acquire()
    assert time.monotonic() - t0 < 0.5


async def test_rate_limited_actor_respects_rate():
    done = []
    actor = PipelineStageActor(
        "limited", process_fn=lambda x: done.append(x), rate_per_second=50, burst=1, workers=4
    )
    ctx = LifecycleContext()
    for i in range(10):
        actor.receive(i)
    t0 = time.monotonic()
    await run_actor_until_idle(actor, ctx)
    # 9 post-burst elements at 50/s => at least ~180ms
    assert time.monotonic() - t0 >= 0.15
    assert len(done) == 10


async def test_async_process_fn():
    out = []

    async def work(x):
        await asyncio.sleep(0.001)
        out.append(x)
        return x

    actor = PipelineStageActor("async", process_fn=work, rate_per_second=0, workers=3)
    ctx = LifecycleContext()
    for i in range(9):
        actor.receive(i)
    await run_actor_until_idle(actor, ctx)
    assert sorted(out) == list(range(9))


async def test_post_start_runs_once_workers_up():
    ran = asyncio.Event()
    actor = PipelineStageActor("ps", process_fn=lambda x: x, rate_per_second=0, workers=1)
    ctx = LifecycleContext()

    async def post_start():
        ran.set()

    task = asyncio.create_task(actor.start(ctx, post_start))
    await asyncio.wait_for(ran.wait(), timeout=2)
    ctx.cancel()
    await task
