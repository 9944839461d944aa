"""The port's counterpart of ``tests/test_jobset_children.py`` (``tpu_nexus_torch``).

JobSet child-pod / child-Job event resolution.

For JobSet-launched multi-host runs, the JobSet controller creates a child
Job named `{run_id}-workers-0` whose pods carry BOTH backlinks:
`batch.kubernetes.io/job-name: {run_id}-workers-0` (the Job controller's)
and `jobset.sigs.k8s.io/jobset-name: {run_id}` (the JobSet controller's).
The reference maps a pod to its run via the job-name backlink alone
(services/supervisor.go:231,241,251), which for JobSet children resolves a
request id with NO ledger row — a supervisor that did so deleted the healthy
JobSet's child Job and retried forever.  These tests drive the supervisor
against a fake that plays the real controllers (FakeKubeClient's
jobset_controller mode materializes the children exactly as they label
them) and assert the jobset-name backlink wins.
"""

import asyncio
import uuid
from datetime import timedelta

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_TEMPLATE_NAME_KEY,
    JOBSET_NAME_LABEL,
    NEXUS_COMPONENT_LABEL,
    POD_JOB_NAME_LABEL,
    CheckpointedRequest,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.launcher.client import Launcher
from tpu_nexus_torch.launcher.jobset import LaunchSpec, compose_jobset
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.supervisor.taxonomy import MSG_DEADLINE_EXCEEDED, MSG_PREEMPTED

NS = "nexus"
ALGORITHM = "llama-multihost"


def _spec(rid, num_hosts=2):
    return LaunchSpec(
        run_id=rid,
        algorithm=ALGORITHM,
        image="tpu-nexus-workload:test",
        num_hosts=num_hosts,
        namespace=NS,
    )


def _event(reason, message, kind, obj_name):
    return {
        "kind": "Event",
        "metadata": {"name": f"evt-{reason}-{obj_name}"[:63], "namespace": NS},
        "reason": reason,
        "message": message,
        "type": "Warning",
        "involvedObject": {"kind": kind, "name": obj_name, "namespace": NS},
    }


class JobSetFixture:
    """Launch a real JobSet through the Launcher against a controller-playing
    fake; run the supervisor over the materialized children."""

    def __init__(self):
        self.store = InMemoryCheckpointStore()
        self.client = FakeKubeClient({}, jobset_controller=True)
        self.supervisor = Supervisor(
            self.client, self.store, NS, resync_period=timedelta(0)
        )
        self.supervisor.init(
            ProcessingConfig(
                failure_rate_base_delay=timedelta(milliseconds=5),
                failure_rate_max_delay=timedelta(milliseconds=50),
                rate_limit_elements_per_second=0,
                workers=4,
            )
        )
        self.ctx = LifecycleContext()
        self.task = None

    async def launch(self, rid, num_hosts=2):
        launcher = Launcher(self.client, self.store, use_jobset=True)
        await launcher.launch(_spec(rid, num_hosts))

    async def start(self):
        self.task = asyncio.create_task(self.supervisor.start(self.ctx))
        await asyncio.sleep(0.05)

    async def stop(self):
        assert await self.supervisor.idle(timeout=10)
        self.ctx.cancel()
        await self.task

    def checkpoint(self, rid):
        return self.store.read_checkpoint(ALGORITHM, rid)


async def test_controller_materializes_labeled_children():
    """The fake plays the controllers the way the real ones label things —
    the substrate every other test here rests on."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid, num_hosts=2)
    jobs, _ = await fx.client.list_objects("Job", NS)
    assert [j["metadata"]["name"] for j in jobs] == [f"{rid}-workers-0"]
    labels = jobs[0]["metadata"]["labels"]
    assert labels[JOBSET_NAME_LABEL] == rid
    assert labels[NEXUS_COMPONENT_LABEL] == JOB_LABEL_ALGORITHM_RUN  # template metadata propagated
    pods, _ = await fx.client.list_objects("Pod", NS)
    assert sorted(p["metadata"]["name"] for p in pods) == [
        f"{rid}-workers-0-0", f"{rid}-workers-0-1",
    ]
    for p in pods:
        pl = p["metadata"]["labels"]
        assert pl[POD_JOB_NAME_LABEL] == f"{rid}-workers-0"
        assert pl[JOBSET_NAME_LABEL] == rid
        assert pl[JOB_TEMPLATE_NAME_KEY] == ALGORITHM


async def test_recreate_scopes_dependents_to_namespace():
    """Jobset names are only unique per namespace: recreating one
    namespace's JobSet children must not touch (or uid-cycle) a SAME-NAMED
    jobset's children in another namespace — label-only dependent matching
    crossed that boundary."""
    client = FakeKubeClient({}, jobset_controller=True)

    def _jobset(ns):
        return {
            "kind": "JobSet",
            "metadata": {"name": "run-x", "namespace": ns, "uid": f"js-{ns}"},
            "spec": {
                "replicatedJobs": [
                    {
                        "name": "workers",
                        "replicas": 1,
                        "template": {"spec": {"parallelism": 1, "template": {}}},
                    }
                ]
            },
        }

    await client.create_object("JobSet", "ns-a", _jobset("ns-a"))
    await client.create_object("JobSet", "ns-b", _jobset("ns-b"))
    # both namespaces materialized their own children despite the shared name
    pods, _ = await client.list_objects("Pod", "")
    assert sorted((p["metadata"]["namespace"]) for p in pods) == ["ns-a", "ns-b"]
    uid_b_before = {
        p["metadata"]["name"]: p["metadata"]["uid"]
        for p in pods
        if p["metadata"]["namespace"] == "ns-b"
    }

    client.recreate_jobset_children("ns-a", "run-x")

    pods, _ = await client.list_objects("Pod", "")
    by_ns = {p["metadata"]["namespace"]: p for p in pods}
    assert set(by_ns) == {"ns-a", "ns-b"}  # neither namespace lost its pod
    # ns-b's generation is untouched; ns-a's was cycled to fresh uids
    assert by_ns["ns-b"]["metadata"]["uid"] == uid_b_before[by_ns["ns-b"]["metadata"]["name"]]
    jobs, _ = await client.list_objects("Job", "ns-a")
    assert jobs and jobs[0]["metadata"]["uid"] != "js-ns-a"


async def test_child_pod_preemption_resolves_owning_run():
    """The bug: a TPUPreempted event on a child pod must increment the
    OWNING run's restart_count — and must not delete anything."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    cp = fx.checkpoint(rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    fx.store.upsert_checkpoint(cp)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("TPUPreempted", "TPU node was preempted by Cloud provider",
               "Pod", f"{rid}-workers-0-1"),
    )
    await fx.stop()
    cp = fx.checkpoint(rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
    assert cp.restart_count == 1
    assert cp.algorithm_failure_cause == MSG_PREEMPTED
    assert fx.client.deleted("Job") == []
    assert fx.client.deleted("JobSet") == []
    # and crucially: NO phantom row for the child job's name
    assert fx.store.read_checkpoint(ALGORITHM, f"{rid}-workers-0") is None


async def test_child_pod_started_marks_owning_run_running():
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("Started", "Started container algorithm", "Pod", f"{rid}-workers-0-0"),
    )
    await fx.stop()
    assert fx.checkpoint(rid).lifecycle_stage == LifecycleStage.RUNNING


async def test_child_pod_fatal_failure_deletes_owning_jobset():
    """A terminal pod failure on a child pod must delete the OWNING JobSet —
    deleting the child Job would just make the controller recreate it."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    cp = fx.checkpoint(rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    fx.store.upsert_checkpoint(cp)
    await fx.start()
    # enrich the cached pod with an HBM OOM termination, as the kubelet would
    pods, _ = await fx.client.list_objects("Pod", NS)
    pod = next(p for p in pods if p["metadata"]["name"] == f"{rid}-workers-0-0")
    pod["status"] = {
        "containerStatuses": [
            {
                "name": "algorithm",
                "state": {
                    "terminated": {
                        "exitCode": 137,
                        "reason": "Error",
                        "message": "RESOURCE_EXHAUSTED: HBM exhausted on device 2",
                    }
                },
            }
        ]
    }
    fx.client.inject("MODIFIED", "Pod", pod)
    fx.client.inject(
        "ADDED", "Event",
        _event("Failed", "Pod failed", "Pod", f"{rid}-workers-0-0"),
    )
    await fx.stop()
    cp = fx.checkpoint(rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert "HBM" in cp.algorithm_failure_cause
    assert fx.client.deleted("JobSet") == [rid]
    assert fx.client.deleted("Job") == []  # never the child


async def test_child_job_backoff_limit_resolves_and_deletes_jobset():
    """Child-Job events (the Job controller's own signals) resolve to the
    owning run via the jobset-name label on the child Job."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    cp = fx.checkpoint(rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    fx.store.upsert_checkpoint(cp)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("BackoffLimitExceeded", "Job has reached the specified backoff limit",
               "Job", f"{rid}-workers-0"),
    )
    await fx.stop()
    cp = fx.checkpoint(rid)
    assert cp.lifecycle_stage == LifecycleStage.DEADLINE_EXCEEDED
    assert cp.algorithm_failure_cause == MSG_DEADLINE_EXCEEDED
    assert fx.client.deleted("JobSet") == [rid]


async def test_child_pod_event_without_ledger_row_deletes_owning_jobset():
    """Missing-checkpoint path (reference services/supervisor.go:265-273)
    generalized: the orphan delete must target the top-level JobSet, not the
    child Job."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    # materialize the JobSet directly — no ledger row at all
    manifest = compose_jobset(_spec(rid))
    await fx.client.create_object("JobSet", NS, manifest)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("Failed", "Pod failed", "Pod", f"{rid}-workers-0-0"),
    )
    # the missing-row path raises for backoff re-delivery (reference parity),
    # so poll-with-deadline for the delete instead of waiting for idle
    deadline = asyncio.get_event_loop().time() + 5
    while asyncio.get_event_loop().time() < deadline and rid not in fx.client.deleted("JobSet"):
        await asyncio.sleep(0.01)
    assert fx.client.deleted("JobSet") == [rid]
    # retries after the JobSet is gone may fall back to a (NotFound, harmless)
    # Job delete on the run id — but the CHILD job must never be targeted
    assert f"{rid}-workers-0" not in fx.client.deleted("Job")
    fx.ctx.cancel()
    await fx.task


def _recreate_children(fx, rid):
    """The JobSet Recreate policy after a preemption: same names, fresh uids
    (a new generation) — now played by the fake controller itself."""
    fx.client.recreate_jobset_children(NS, rid)


async def test_restart_budget_exhaustion_goes_terminal():
    """The launcher composes failurePolicy.maxRestarts=3
    but nothing capped the ledger's restart accounting — a preemption loop
    never went terminal.  Drive 4 distinct preemption incidents (the JobSet
    controller recreating the children — fresh pod generation — and the
    harness heartbeating RUNNING between them): the first 3 count as
    restarts; the 4th lands DEADLINE_EXCEEDED with a trace explaining the
    spent budget, and the JobSet is deleted."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    cp = fx.checkpoint(rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    fx.store.upsert_checkpoint(cp)
    await fx.start()

    for incident in range(1, 4):
        fx.client.inject(
            "ADDED", "Event",
            _event("TPUPreempted", f"TPU node preempted (incident {incident})",
                   "Pod", f"{rid}-workers-0-0"),
        )
        assert await fx.supervisor.idle(timeout=10)
        cp = fx.checkpoint(rid)
        assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
        assert cp.restart_count == incident, (incident, cp.restart_count)
        # controller recreates the workers (new generation); harness
        # heartbeats RUNNING again
        _recreate_children(fx, rid)
        cp = cp.deep_copy()
        cp.lifecycle_stage = LifecycleStage.RUNNING
        fx.store.upsert_checkpoint(cp)
        await asyncio.sleep(0.01)

    fx.client.inject(
        "ADDED", "Event",
        _event("TPUPreempted", "TPU node preempted (incident 4)", "Pod", f"{rid}-workers-0-0"),
    )
    await fx.stop()
    cp = fx.checkpoint(rid)
    assert cp.lifecycle_stage == LifecycleStage.DEADLINE_EXCEEDED
    assert cp.restart_count == 3  # never advertises a 4th restart
    assert cp.algorithm_failure_cause == MSG_DEADLINE_EXCEEDED
    assert "maxRestarts=3" in cp.algorithm_failure_details
    assert fx.client.deleted("JobSet") == [rid]


async def test_same_incident_fanout_does_not_escalate_at_budget():
    """The Nth host's event for the FINAL allowed restart must stay a
    suppressed duplicate, not tip the run over the budget."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    cp = fx.checkpoint(rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    cp.restart_count = 2  # two incidents already recorded
    fx.store.upsert_checkpoint(cp)
    await fx.start()
    # the 3rd (last allowed) incident fans out to both hosts within seconds
    for i in range(2):
        fx.client.inject(
            "ADDED", "Event",
            _event("TPUPreempted", "TPU node preempted", "Pod", f"{rid}-workers-0-{i}"),
        )
    await fx.stop()
    cp = fx.checkpoint(rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED  # NOT terminal
    assert cp.restart_count == 3
    assert fx.client.deleted("JobSet") == []


async def test_jobset_delete_cascades_to_children():
    """Background-propagation parity in the fake: deleting the JobSet GCs
    child Jobs and their pods (the supervisor relies on this to not re-fire
    on orphaned children)."""
    fx = JobSetFixture()
    rid = str(uuid.uuid4())
    await fx.launch(rid)
    await fx.client.delete_object("JobSet", NS, rid)
    await asyncio.sleep(0)  # let call_soon GC run
    jobs, _ = await fx.client.list_objects("Job", NS)
    pods, _ = await fx.client.list_objects("Pod", NS)
    assert jobs == [] and pods == []
