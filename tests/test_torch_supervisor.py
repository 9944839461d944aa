"""The port's counterpart of ``tests/test_supervisor.py`` (``tpu_nexus_torch``).

End-to-end supervision scenarios.

Port of the reference's integration-in-miniature suite
(services/supervisor_test.go:542-580; SURVEY.md §3.4/§4): fake k8s client
seeded with Events/Pods/Jobs replayed through real informers, in-memory
ledger seeded with one row per scenario, full service loop, then assert the
resulting lifecycle stage.  Poll-with-deadline (actor idle()) replaces the
reference's fixed sleeps.

Scenarios 1-7 are the reference matrix + the CANCELLED guard; the TPU
scenarios exercise the extended taxonomy (compile abort, HBM OOM,
preemption, ICI) from BASELINE.json.
"""

import asyncio
import uuid

import pytest

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_TEMPLATE_NAME_KEY,
    NEXUS_COMPONENT_LABEL,
    POD_JOB_NAME_LABEL,
    CheckpointedRequest,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.supervisor.taxonomy import (
    MSG_DEADLINE_EXCEEDED,
    MSG_FATAL_ERROR,
    MSG_STUCK_IN_PENDING,
)
from datetime import timedelta

NS = "nexus"
ALGORITHM = "test-algorithm"


def run_labels():
    return {
        NEXUS_COMPONENT_LABEL: JOB_LABEL_ALGORITHM_RUN,
        JOB_TEMPLATE_NAME_KEY: ALGORITHM,
    }


def job_obj(request_id):
    return {
        "kind": "Job",
        "metadata": {
            "name": request_id,
            "namespace": NS,
            "uid": str(uuid.uuid4()),
            "labels": run_labels(),
        },
        "status": {},
    }


def jobset_obj(request_id, conditions=None):
    return {
        "kind": "JobSet",
        "metadata": {
            "name": request_id,
            "namespace": NS,
            "uid": str(uuid.uuid4()),
            "labels": run_labels(),
        },
        "status": {"conditions": conditions or []},
    }


def pod_obj(request_id, suffix="-pod-0", container_statuses=None):
    return {
        "kind": "Pod",
        "metadata": {
            "name": request_id + suffix,
            "namespace": NS,
            "uid": str(uuid.uuid4()),
            "labels": {POD_JOB_NAME_LABEL: request_id, **run_labels()},
        },
        "status": {"containerStatuses": container_statuses or []},
    }


def event_obj(reason, message, kind, obj_name):
    return {
        "kind": "Event",
        "metadata": {"name": f"evt-{reason}-{obj_name}", "namespace": NS},
        "reason": reason,
        "message": message,
        "type": "Warning",
        "involvedObject": {"kind": kind, "name": obj_name, "namespace": NS},
    }


def seed_checkpoint(store, request_id, stage=LifecycleStage.BUFFERED):
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=request_id, lifecycle_stage=stage)
    )


class Fixture:
    """newFixture parity (reference supervisor_test.go:31-44)."""

    def __init__(self, objects):
        self.store = InMemoryCheckpointStore()
        self.client = FakeKubeClient(objects)
        self.supervisor = Supervisor(
            self.client,
            self.store,
            NS,
            resync_period=timedelta(0),
        )
        self.supervisor.init(
            ProcessingConfig(
                failure_rate_base_delay=timedelta(milliseconds=5),
                failure_rate_max_delay=timedelta(milliseconds=50),
                rate_limit_elements_per_second=0,
                rate_limit_elements_burst=100,
                workers=4,
            )
        )
        self.ctx = LifecycleContext()

    async def run_until_idle(self, timeout=10.0):
        task = asyncio.create_task(self.supervisor.start(self.ctx))
        # let informers sync + events flow, then wait for the queues to drain
        await asyncio.sleep(0.05)
        assert await self.supervisor.idle(timeout=timeout)
        self.ctx.cancel()
        await task

    def stage_of(self, request_id):
        cp = self.store.read_checkpoint(ALGORITHM, request_id)
        return cp.lifecycle_stage if cp else None


# ---------------------------------------------------------------------------
# Reference scenario matrix (SURVEY §4): one fixture per scenario, pre-seeded
# ---------------------------------------------------------------------------


async def scenario(reason, kind_under_test, seed_stage, event_message="boom",
                   container_statuses=None, event_kind=None):
    rid = str(uuid.uuid4())
    job = job_obj(rid)
    pod = pod_obj(rid, container_statuses=container_statuses)
    target_name = rid if (event_kind or kind_under_test) == "Job" else pod["metadata"]["name"]
    objects = {
        "Job": [job],
        "Pod": [pod],
        "Event": [event_obj(reason, event_message, event_kind or kind_under_test, target_name)],
    }
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid, seed_stage)
    await fx.run_until_idle()
    return fx, rid


async def test_job_failed_create_to_scheduling_failed():
    fx, rid = await scenario("FailedCreate", "Job", LifecycleStage.BUFFERED)
    assert fx.stage_of(rid) == LifecycleStage.SCHEDULING_FAILED
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.algorithm_failure_cause == MSG_STUCK_IN_PENDING
    assert cp.algorithm_failure_details == "boom"
    assert rid in fx.client.deleted("Job")


async def test_job_deadline_exceeded():
    fx, rid = await scenario("DeadlineExceeded", "Job", LifecycleStage.RUNNING)
    assert fx.stage_of(rid) == LifecycleStage.DEADLINE_EXCEEDED
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.algorithm_failure_cause == MSG_DEADLINE_EXCEEDED
    assert rid in fx.client.deleted("Job")


async def test_job_backoff_limit_exceeded_to_deadline_exceeded():
    fx, rid = await scenario("BackoffLimitExceeded", "Job", LifecycleStage.RUNNING)
    assert fx.stage_of(rid) == LifecycleStage.DEADLINE_EXCEEDED
    assert rid in fx.client.deleted("Job")


async def test_job_pod_failure_policy_oom_to_failed():
    # exit 137 (OOM) surfaced via PodFailurePolicy (reference comments
    # services/supervisor.go:310-313)
    fx, rid = await scenario(
        "PodFailurePolicy",
        "Job",
        LifecycleStage.RUNNING,
        event_message="Container main for pod nexus/x failed with exit code 137 matching FailJob rule at index 0",
    )
    assert fx.stage_of(rid) == LifecycleStage.FAILED
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.algorithm_failure_cause == MSG_FATAL_ERROR
    assert "137" in cp.algorithm_failure_details
    assert rid in fx.client.deleted("Job")


async def test_pod_started_to_running():
    fx, rid = await scenario("Started", "Pod", LifecycleStage.BUFFERED, event_message="Started container")
    assert fx.stage_of(rid) == LifecycleStage.RUNNING
    assert fx.client.deleted("Job") == []  # no delete on ToRunning


async def test_pod_failed_maps_to_scheduling_failed_quirk():
    # quirk preserved: Pod Failed -> SCHEDULING_FAILED, not FAILED
    # (reference services/supervisor.go:234-243; supervisor_test.go:398-401)
    fx, rid = await scenario("Failed", "Pod", LifecycleStage.RUNNING)
    assert fx.stage_of(rid) == LifecycleStage.SCHEDULING_FAILED
    assert rid in fx.client.deleted("Job")


async def test_pod_backoff_to_failed():
    fx, rid = await scenario("BackOff", "Pod", LifecycleStage.RUNNING,
                             event_message="Back-off restarting failed container")
    assert fx.stage_of(rid) == LifecycleStage.FAILED
    assert rid in fx.client.deleted("Job")


async def test_pod_started_on_cancelled_checkpoint_is_noop():
    # the IsFinished guard: cancelled runs are protected from late Started
    # events (reference services/supervisor.go:275-279; CANCELLED fixture
    # supervisor_test.go:473-540)
    fx, rid = await scenario("Started", "Pod", LifecycleStage.CANCELLED)
    assert fx.stage_of(rid) == LifecycleStage.CANCELLED
    assert fx.client.deleted("Job") == []


async def test_unknown_job_reason_ignored():
    fx, rid = await scenario("SuccessfulCreate", "Job", LifecycleStage.BUFFERED)
    assert fx.stage_of(rid) == LifecycleStage.BUFFERED
    assert fx.supervisor.decisions_enqueued == 0


async def test_non_nexus_event_filtered():
    rid = str(uuid.uuid4())
    job = job_obj(rid)
    del job["metadata"]["labels"][NEXUS_COMPONENT_LABEL]  # not a nexus run
    objects = {"Job": [job], "Event": [event_obj("FailedCreate", "x", "Job", rid)]}
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid)
    await fx.run_until_idle()
    assert fx.stage_of(rid) == LifecycleStage.BUFFERED
    assert fx.supervisor.events_filtered >= 1


async def test_missing_checkpoint_deletes_job_and_retries():
    # reference :265-273: no metadata -> delete job anyway, return error
    rid = str(uuid.uuid4())
    objects = {"Job": [job_obj(rid)], "Event": [event_obj("FailedCreate", "x", "Job", rid)]}
    fx = Fixture(objects)  # store NOT seeded
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    deadline = asyncio.get_event_loop().time() + 5
    while asyncio.get_event_loop().time() < deadline and rid not in fx.client.deleted("Job"):
        await asyncio.sleep(0.01)
    assert rid in fx.client.deleted("Job")
    assert fx.store.read_checkpoint(ALGORITHM, rid) is None
    fx.ctx.cancel()
    await task


# ---------------------------------------------------------------------------
# TPU taxonomy scenarios (BASELINE.json failure classes)
# ---------------------------------------------------------------------------


async def test_pod_xla_compile_abort():
    statuses = [
        {
            "name": "main",
            "state": {
                "terminated": {
                    "exitCode": 1,
                    "reason": "Error",
                    "message": "jaxlib.xla_extension.XlaRuntimeError: INVALID_ARGUMENT: XLA compilation failed: HLO module has mismatched shapes",
                }
            },
        }
    ]
    fx, rid = await scenario(
        "Failed", "Pod", LifecycleStage.RUNNING,
        event_message="Pod failed", container_statuses=statuses,
    )
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert "compile" in cp.algorithm_failure_cause.lower()
    assert "XLA compilation failed" in cp.algorithm_failure_details
    assert rid in fx.client.deleted("Job")


async def test_pod_hbm_oom():
    statuses = [
        {
            "name": "main",
            "state": {
                "terminated": {
                    "exitCode": 137,
                    "reason": "Error",
                    "message": "RESOURCE_EXHAUSTED: Attempting to allocate 12.5G. That was not possible. There are 9.1G free. HBM exhausted on device 3",
                }
            },
        }
    ]
    fx, rid = await scenario(
        "Failed", "Pod", LifecycleStage.RUNNING,
        event_message="Pod failed", container_statuses=statuses,
    )
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert "HBM" in cp.algorithm_failure_cause
    assert rid in fx.client.deleted("Job")


async def test_pod_tpu_preemption_is_restartable():
    fx, rid = await scenario(
        "TPUPreempted", "Pod", LifecycleStage.RUNNING,
        event_message="TPU node was preempted by Cloud provider",
    )
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
    assert cp.restart_count == 1
    assert not cp.is_finished()  # restartable, NOT terminal
    assert fx.client.deleted("Job") == []  # restart-from-step: no delete


async def test_jobset_ici_link_down():
    rid = str(uuid.uuid4())
    jobset = jobset_obj(rid)
    objects = {
        "JobSet": [jobset],
        "Event": [
            event_obj(
                "FailedJobs",
                "worker-2 terminated: ICI link down on chip 5, interconnect failure detected",
                "JobSet",
                rid,
            )
        ],
    }
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid, LifecycleStage.RUNNING)
    await fx.run_until_idle()
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert "ICI" in cp.algorithm_failure_cause
    assert rid in fx.client.deleted("JobSet")


async def test_jobset_started_to_running():
    rid = str(uuid.uuid4())
    objects = {
        "JobSet": [jobset_obj(rid)],
        "Event": [event_obj("Started", "all replicated jobs started", "JobSet", rid)],
    }
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid, LifecycleStage.BUFFERED)
    await fx.run_until_idle()
    assert fx.stage_of(rid) == LifecycleStage.RUNNING


async def test_hlo_trace_ref_extracted():
    statuses = [
        {
            "name": "main",
            "state": {
                "terminated": {
                    "exitCode": 1,
                    "reason": "Error",
                    "message": "XLA compilation failed; HLO dumped to gs://nexus-traces/run-42/module_0001.hlo",
                }
            },
        }
    ]
    fx, rid = await scenario(
        "Failed", "Pod", LifecycleStage.RUNNING,
        event_message="Pod failed", container_statuses=statuses,
    )
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.hlo_trace_ref == "gs://nexus-traces/run-42/module_0001.hlo"


# ---------------------------------------------------------------------------
# Live injection: events arriving after startup (watch path, not just LIST)
# ---------------------------------------------------------------------------


async def test_live_injected_event_storm_all_processed():
    """16-host storm: many events for one run -> exactly one terminal
    transition (idempotent via the IsFinished guard), p50 well under 5s."""
    rid = str(uuid.uuid4())
    objects = {"Job": [job_obj(rid)], "Pod": [pod_obj(rid)]}
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid, LifecycleStage.RUNNING)
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    await asyncio.sleep(0.05)
    # storm: 16 duplicate failure events (one per host) for the same run
    for i in range(16):
        evt = event_obj("DeadlineExceeded", f"host-{i} deadline", "Job", rid)
        evt["metadata"]["name"] = f"evt-{i}"
        fx.client.inject("ADDED", "Event", evt)
    assert await fx.supervisor.idle(timeout=10)
    fx.ctx.cancel()
    await task
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.DEADLINE_EXCEEDED
    # first writer wins; the other 15 hit the IsFinished guard
    assert fx.client.deleted("Job").count(rid) == 1
    assert fx.supervisor.commit_latencies, "latency metric must be recorded"
    p50 = sorted(fx.supervisor.commit_latencies)[len(fx.supervisor.commit_latencies) // 2]
    assert p50 < 5.0
    summary = fx.supervisor.latency_summary()
    assert summary["count"] == len(fx.supervisor.commit_latencies)
    assert summary["p50"] <= summary["p95"] <= summary["max"]


async def test_duplicate_preemption_events_count_once():
    """One preemption incident fans out to N hosts' events; restart_count
    must record ONE preemption (PREEMPTED -> PREEMPTED duplicates are
    suppressed — a genuine second preemption passes through RUNNING first)."""
    rid = str(uuid.uuid4())
    pod = pod_obj(rid)
    fx = Fixture({"Job": [job_obj(rid)], "Pod": [pod]})
    seed_checkpoint(fx.store, rid, LifecycleStage.RUNNING)
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    await asyncio.sleep(0.05)
    for host in range(8):
        evt = event_obj("TPUPreempted", f"host-{host} preempted", "Pod", pod["metadata"]["name"])
        evt["metadata"]["name"] = f"evt-preempt-{host}"
        fx.client.inject("ADDED", "Event", evt)
    assert await fx.supervisor.idle(timeout=10)
    fx.ctx.cancel()
    await task
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
    assert cp.restart_count == 1
    assert not fx.client.deleted("Job")


async def test_second_preemption_outside_window_counts_again():
    """A preemption landing on a PREEMPTED run with a STALE ledger write is
    a new incident (the replacement pod was reclaimed before the workload
    ever heartbeated) — it must increment restart_count, not be suppressed."""
    from datetime import datetime, timezone

    rid = str(uuid.uuid4())
    pod = pod_obj(rid)
    fx = Fixture({"Job": [job_obj(rid)], "Pod": [pod]})
    cp = CheckpointedRequest(
        algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.PREEMPTED, restart_count=1
    )
    cp.last_modified = datetime(2026, 1, 1, tzinfo=timezone.utc)  # long ago
    fx.store.upsert_checkpoint(cp)
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    await asyncio.sleep(0.05)
    fx.client.inject(
        "ADDED", "Event",
        event_obj("TPUPreempted", "reclaimed again", "Pod", pod["metadata"]["name"]),
    )
    assert await fx.supervisor.idle(timeout=10)
    fx.ctx.cancel()
    await task
    got = fx.store.read_checkpoint(ALGORITHM, rid)
    assert got.lifecycle_stage == LifecycleStage.PREEMPTED
    assert got.restart_count == 2


async def test_second_preemption_counts_despite_future_skewed_clock():
    """Dedup must not trust workload-written wall clocks:
    a PREEMPTED row whose last_modified was written by a host with a clock
    skewed into the FUTURE still gets its genuine second preemption counted.
    The supervisor judges dedup only from its own monotonic record of
    preemptions it committed — here there is none, so this must count."""
    from datetime import datetime, timedelta, timezone

    rid = str(uuid.uuid4())
    pod = pod_obj(rid)
    fx = Fixture({"Job": [job_obj(rid)], "Pod": [pod]})
    cp = CheckpointedRequest(
        algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.PREEMPTED, restart_count=1
    )
    # a skewed host stamped this ledger write 10 minutes in the future; the
    # old wall-clock dedup would read age < window and suppress forever
    cp.last_modified = datetime.now(timezone.utc) + timedelta(minutes=10)
    fx.store.upsert_checkpoint(cp)
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    await asyncio.sleep(0.05)
    fx.client.inject(
        "ADDED", "Event",
        event_obj("TPUPreempted", "reclaimed again", "Pod", pod["metadata"]["name"]),
    )
    assert await fx.supervisor.idle(timeout=10)
    fx.ctx.cancel()
    await task
    got = fx.store.read_checkpoint(ALGORITHM, rid)
    assert got.restart_count == 2
    # refcounted per-run lock entries fully evict once drained
    assert fx.supervisor._run_locks == {}


async def test_latency_percentile_gauges_exported():
    """Every 16th executed decision exports p50/p95 gauges to the metrics
    plane (the north-star number must not live only in an in-process
    deque)."""
    from tpu_nexus_torch.core.telemetry import RecordingMetrics

    metrics = RecordingMetrics()
    rids = [str(uuid.uuid4()) for _ in range(16)]
    objects = {"Job": [job_obj(rid) for rid in rids]}
    store = InMemoryCheckpointStore()
    client = FakeKubeClient(objects)
    supervisor = Supervisor(client, store, NS, metrics=metrics, resync_period=timedelta(0))
    supervisor.init(
        ProcessingConfig(
            failure_rate_base_delay=timedelta(milliseconds=5),
            failure_rate_max_delay=timedelta(milliseconds=50),
            rate_limit_elements_per_second=0,
            workers=4,
        )
    )
    for rid in rids:
        seed_checkpoint(store, rid, LifecycleStage.RUNNING)
    ctx = LifecycleContext()
    task = asyncio.create_task(supervisor.start(ctx))
    await asyncio.sleep(0.05)
    for rid in rids:  # 16 distinct runs -> 16 EXECUTED decisions
        client.inject("ADDED", "Event", event_obj("DeadlineExceeded", "deadline", "Job", rid))
    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task
    assert supervisor.decisions_executed == 16
    assert "detect_to_commit_p50_seconds" in metrics.gauges
    assert "detect_to_commit_p95_seconds" in metrics.gauges
    assert metrics.gauges["detect_to_commit_p50_seconds"] < 5.0


async def test_pod_failure_reenriched_from_fresh_cache():
    """Failed event classified BEFORE the pod cache sees the terminated
    container status: the executor must re-enrich from the freshest cached
    pod state and upgrade to the TPU decision (race found by live drive)."""
    rid = str(uuid.uuid4())
    pod = pod_obj(rid)
    objects = {"Job": [job_obj(rid)], "Pod": [pod]}
    fx = Fixture(objects)
    seed_checkpoint(fx.store, rid, LifecycleStage.RUNNING)
    task = asyncio.create_task(fx.supervisor.start(fx.ctx))
    await asyncio.sleep(0.05)
    # inject the event FIRST (cache still has no termination info)...
    fx.client.inject("ADDED", "Event", event_obj("Failed", "Pod failed", "Pod", pod["metadata"]["name"]))
    # ...then the pod status update lands
    pod["status"] = {"containerStatuses": [{"name": "main", "state": {"terminated": {
        "exitCode": 1, "reason": "Error",
        "message": "XLA compilation failed: unsupported dynamic shape"}}}]}
    fx.client.inject("MODIFIED", "Pod", pod)
    assert await fx.supervisor.idle(timeout=10)
    fx.ctx.cancel()
    await task
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert "compile" in cp.algorithm_failure_cause.lower()
    assert "XLA compilation failed" in cp.algorithm_failure_details


async def test_pod_without_job_name_label_cannot_trigger_collection_delete():
    """A run-labeled pod missing its batch.kubernetes.io/job-name backlink
    classifies with request_id="" — that must be dropped at classification,
    and even if it slipped through, delete_object must refuse empty names
    (a DELETE at the collection URL is a namespace-wide deletecollection)."""
    rid = str(uuid.uuid4())
    pod = pod_obj(rid)
    del pod["metadata"]["labels"][POD_JOB_NAME_LABEL]
    objects = {
        "Pod": [pod],
        "Event": [event_obj("Failed", "boom", "Pod", pod["metadata"]["name"])],
    }
    fx = Fixture(objects)
    await fx.run_until_idle()
    # no delete of any kind happened — especially not an empty-name one
    assert not [a for a in fx.client.actions if a[0] == "delete"], fx.client.actions
    assert fx.store.read_checkpoint(ALGORITHM, rid) is None


async def test_delete_object_refuses_empty_name():
    from tpu_nexus_torch.k8s.client import KubeClientError
    from tpu_nexus_torch.k8s.rest import RestKubeClient

    fake = FakeKubeClient({})
    with pytest.raises(KubeClientError):
        await fake.delete_object("Job", NS, "")
    rest = RestKubeClient("https://127.0.0.1:1")  # guard fires before any I/O
    with pytest.raises(KubeClientError):
        await rest.delete_object("Job", NS, "")
