"""The port's counterpart of ``tests/test_watchdog.py`` (``tpu_nexus_torch``).

Heartbeat watchdog: hung runs (no k8s event, no ledger progress) must be
detected and failed — the one failure class event classification cannot see
(the ``hang`` mode in tpu_nexus_torch.workload.faults)."""

import asyncio
import threading
import uuid
from datetime import timedelta

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.supervisor.taxonomy import MSG_STUCK_IN_RUNNING, DecisionAction
from tpu_nexus_torch.supervisor.watchdog import HeartbeatWatchdog

from tests.test_supervisor import ALGORITHM, NS, job_obj, jobset_obj, seed_checkpoint

WATCHDOG_CONFIG = ProcessingConfig(
    failure_rate_base_delay=timedelta(milliseconds=5),
    failure_rate_max_delay=timedelta(milliseconds=50),
    rate_limit_elements_per_second=0,
    workers=2,
    heartbeat_stale_after=timedelta(seconds=0.3),
    watchdog_interval=timedelta(seconds=0.05),
)


async def test_watchdog_unit_flags_stalled_run_only():
    store = InMemoryCheckpointStore()
    stalled, alive = str(uuid.uuid4()), str(uuid.uuid4())
    for rid in (stalled, alive):
        store.upsert_checkpoint(
            CheckpointedRequest(
                algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.RUNNING,
                per_chip_steps={"host0/chip0": 5},
            )
        )
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        stale_after=timedelta(seconds=10), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    assert not flagged  # first observation only records the fingerprint
    # the alive run makes progress; the stalled one doesn't
    store.merge_chip_steps(ALGORITHM, alive, {"host0/chip0": 6})
    await wd.sweep(now=5.0)
    assert not flagged  # inside the window
    store.merge_chip_steps(ALGORITHM, alive, {"host0/chip0": 7})
    await wd.sweep(now=11.0)
    assert [r.request_id for r in flagged] == [stalled]
    result = flagged[0]
    assert result.action == DecisionAction.TO_FAIL_STUCK_IN_RUNNING
    assert result.run_status_message == MSG_STUCK_IN_RUNNING
    assert "no ledger progress" in result.run_status_trace


async def test_watchdog_forgets_rows_leaving_running():
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.RUNNING)
    )
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        stale_after=timedelta(seconds=10), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    store.update_fields(ALGORITHM, rid, {"lifecycle_stage": LifecycleStage.COMPLETED})
    await wd.sweep(now=20.0)
    assert not flagged and not wd._observations


async def _run_supervised(objects, seed_rid, stage=LifecycleStage.RUNNING, settle=2.0):
    """Start a supervisor with a fast watchdog, wait for the hung run to be
    failed (poll-with-deadline), return (fixture-ish tuple)."""
    store = InMemoryCheckpointStore()
    client = FakeKubeClient(objects)
    sup = Supervisor(client, store, NS, resync_period=timedelta(0))
    sup.init(WATCHDOG_CONFIG)
    seed_checkpoint(store, seed_rid, stage)
    ctx = LifecycleContext()
    task = asyncio.create_task(sup.start(ctx))
    try:
        deadline = asyncio.get_event_loop().time() + settle
        while asyncio.get_event_loop().time() < deadline:
            cp = store.read_checkpoint(ALGORITHM, seed_rid)
            if cp and cp.lifecycle_stage == LifecycleStage.FAILED:
                break
            await asyncio.sleep(0.02)
        await sup.idle(timeout=5)
    finally:
        ctx.cancel()
        await task
    return store, client, sup


async def test_hung_run_failed_and_job_deleted():
    rid = str(uuid.uuid4())
    store, client, sup = await _run_supervised({"Job": [job_obj(rid)]}, rid)
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert cp.algorithm_failure_cause == MSG_STUCK_IN_RUNNING
    assert "no ledger progress" in cp.algorithm_failure_details
    assert rid in client.deleted("Job")
    assert sup.watchdog.flagged == 1


async def test_hung_jobset_run_deletes_jobset():
    rid = str(uuid.uuid4())
    store, client, sup = await _run_supervised({"JobSet": [jobset_obj(rid)]}, rid)
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert rid in client.deleted("JobSet")


async def test_hang_fault_mode_detected_end_to_end():
    """The ``hang`` fault: a real workload thread heartbeats, then freezes at
    the fault step without emitting any event.  The watchdog must fail the
    run within the window while the workload is still stuck."""
    from tpu_nexus_torch.models import LlamaConfig
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.faults import ENV_FAULT_MODE, ENV_FAULT_STEP
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
    from tpu_nexus_torch.workload.train import TrainConfig

    rid = str(uuid.uuid4())
    store = InMemoryCheckpointStore()
    seed_checkpoint(store, rid, LifecycleStage.BUFFERED)
    cfg = WorkloadConfig(
        model=LlamaConfig.tiny(),
        train=TrainConfig(warmup_steps=2, total_steps=50),
        batch_size=8, seq_len=32, steps=20, heartbeat_every=1, device="cpu",
    )
    ctx = ProcessContext(run_id=rid, algorithm=ALGORITHM, process_id=0, num_processes=1, coordinator=None)
    import os

    os.environ[ENV_FAULT_MODE] = "hang"
    os.environ[ENV_FAULT_STEP] = "3"
    try:
        worker = threading.Thread(
            target=lambda: run_workload(cfg, store=store, ctx=ctx), daemon=True
        )
        worker.start()
        # wait until the workload has heartbeated and hit the hang
        deadline = asyncio.get_event_loop().time() + 60
        while asyncio.get_event_loop().time() < deadline:
            cp = store.read_checkpoint(ALGORITHM, rid)
            if cp and cp.per_chip_steps:
                break
            await asyncio.sleep(0.05)
        assert cp.lifecycle_stage == LifecycleStage.RUNNING
    finally:
        del os.environ[ENV_FAULT_MODE], os.environ[ENV_FAULT_STEP]

    client = FakeKubeClient({"Job": [job_obj(rid)]})
    sup = Supervisor(client, store, NS, resync_period=timedelta(0))
    sup.init(WATCHDOG_CONFIG)
    lctx = LifecycleContext()
    task = asyncio.create_task(sup.start(lctx))
    try:
        deadline = asyncio.get_event_loop().time() + 10
        while asyncio.get_event_loop().time() < deadline:
            cp = store.read_checkpoint(ALGORITHM, rid)
            if cp.lifecycle_stage == LifecycleStage.FAILED:
                break
            await asyncio.sleep(0.05)
        await sup.idle(timeout=5)
    finally:
        lctx.cancel()
        await task
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert cp.algorithm_failure_cause == MSG_STUCK_IN_RUNNING
    assert rid in client.deleted("Job")
    # the hung thread is still alive and frozen — detection didn't need it
    assert worker.is_alive()


async def test_first_progress_grace_for_never_heartbeated_runs():
    """A RUNNING row with no heartbeats yet (long first XLA compile) gets a
    3x leash before being called hung."""
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.RUNNING)
    )
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        stale_after=timedelta(seconds=10), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    await wd.sweep(now=15.0)  # past stale_after, inside the 30s grace
    assert not flagged
    await wd.sweep(now=31.0)  # past 3x stale_after
    assert [r.request_id for r in flagged] == [rid]
