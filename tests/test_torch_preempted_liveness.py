"""The port's counterpart of ``tests/test_preempted_liveness.py`` (``tpu_nexus_torch``).

PREEMPTED liveness guard.

The restart policy axis bets that the JobSet controller recreates a
preempted run's children.  Nothing used to watch the other side of that
bet: with the controller down / quota gone / node pool deleted, the row sat
PREEMPTED forever and no k8s event ever fired.  The reference cannot wedge
— every failure decision deletes the Job and writes a terminal stage
(services/supervisor.go:283-360) — and these tests pin that guarantee onto
the restart axis:

* the watchdog's PREEMPTED sweep escalates a wedged run to terminal
  DEADLINE_EXCEEDED within the restart deadline and deletes the JobSet;
* a run whose controller DOES come back (new generation / RUNNING
  transition) is never flagged;
* budget escalation survives a supervisor restart mid-incident: the
  launch-time ``max_restarts`` ledger column decides, not the informer
  cache.
"""

import asyncio
import uuid
from datetime import timedelta

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
from tpu_nexus_torch.launcher.client import Launcher
from tpu_nexus_torch.launcher.jobset import LaunchSpec
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.supervisor.taxonomy import (
    MSG_DEADLINE_EXCEEDED,
    MSG_RESTART_STALLED,
    DecisionAction,
)
from tpu_nexus_torch.supervisor.watchdog import HeartbeatWatchdog

NS = "nexus"
ALGORITHM = "llama-multihost"


def _spec(rid, num_hosts=2):
    return LaunchSpec(
        run_id=rid, algorithm=ALGORITHM, image="tpu-nexus-workload:test",
        num_hosts=num_hosts, namespace=NS,
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


# -- watchdog unit: the PREEMPTED sweep ---------------------------------------


def _preempted_cp(rid, restart_count=1, generation="gen-1"):
    return CheckpointedRequest(
        algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.PREEMPTED,
        restart_count=restart_count, preempted_generation=generation,
    )


async def test_preempted_sweep_flags_only_past_deadline():
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(_preempted_cp(rid))
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        restart_deadline=timedelta(seconds=60), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    assert not flagged  # first observation only records the fingerprint
    await wd.sweep(now=30.0)
    assert not flagged  # inside the deadline
    await wd.sweep(now=61.0)
    assert [r.request_id for r in flagged] == [rid]
    result = flagged[0]
    assert result.action == DecisionAction.TO_FAIL_RESTART_STALLED
    assert result.run_status_message == MSG_RESTART_STALLED
    assert "never restarted" in result.run_status_trace


async def test_new_preemption_rearms_the_deadline():
    """A second COUNTED preemption (restart_count bump / fresh generation)
    means the controller DID restart the run once — the deadline must
    restart from the new incident, not fire on the old timer."""
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(_preempted_cp(rid, restart_count=1, generation="gen-1"))
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        restart_deadline=timedelta(seconds=60), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    store.update_fields(
        ALGORITHM, rid, {"restart_count": 2, "preempted_generation": "gen-2"}
    )
    await wd.sweep(now=59.0)  # fingerprint changed -> timer restarted
    await wd.sweep(now=100.0)  # 41s into the NEW window
    assert not flagged
    await wd.sweep(now=120.0)  # 61s into the new window
    assert [r.request_id for r in flagged] == [rid]


async def test_stray_writes_do_not_rearm_the_deadline():
    """A draining generation keeps writing after the preemption — late
    heartbeats flushing, a final checkpoint commit, last_modified bumps.
    None of those are restart signals (lifecycle_stage / restart_count /
    preempted_generation), so they must NOT restart the restart-deadline
    clock: a wedged controller would otherwise never be escalated as long
    as the dying workers stay chatty."""
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(_preempted_cp(rid))
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        restart_deadline=timedelta(seconds=60), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    # stray non-restart writes, spread across the deadline window
    store.merge_chip_steps(ALGORITHM, rid, {"host0/chip0": 101})
    await wd.sweep(now=20.0)
    store.update_fields(  # nxlint: disable=NX007 simulated stray write from a dying generation
        ALGORITHM, rid,
        {"tensor_checkpoint_uri": "gs://ckpt/late-flush", "last_modified": "t+40"},
    )
    await wd.sweep(now=40.0)
    assert not flagged  # still inside the deadline
    await wd.sweep(now=61.0)  # deadline measured from the FIRST observation
    assert [r.request_id for r in flagged] == [rid]


async def test_resumed_run_is_forgotten():
    """PREEMPTED -> RUNNING (the controller came back) clears the
    observation even when the RUNNING sweep is disabled."""
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(_preempted_cp(rid))
    flagged = []
    wd = HeartbeatWatchdog(
        store, enqueue=flagged.append,
        restart_deadline=timedelta(seconds=60), interval=timedelta(seconds=1),
    )
    await wd.sweep(now=0.0)
    store.update_fields(ALGORITHM, rid, {"lifecycle_stage": LifecycleStage.RUNNING})
    await wd.sweep(now=100.0)
    assert not flagged and not wd._observations


# -- end to end: wedged run goes terminal through the normal commit path ------


class WedgeFixture:
    """JobSet launch against a controller-playing fake that is then told to
    NEVER recreate the children (the wedge), with a fast watchdog."""

    def __init__(self, restart_deadline=timedelta(seconds=0.3)):
        self.store = InMemoryCheckpointStore()
        self.client = FakeKubeClient({}, jobset_controller=True)
        self.supervisor = Supervisor(self.client, self.store, NS, resync_period=timedelta(0))
        self.supervisor.init(
            ProcessingConfig(
                failure_rate_base_delay=timedelta(milliseconds=5),
                failure_rate_max_delay=timedelta(milliseconds=50),
                rate_limit_elements_per_second=0,
                workers=2,
                preempted_restart_deadline=restart_deadline,
                watchdog_interval=timedelta(seconds=0.05),
            )
        )
        self.ctx = LifecycleContext()
        self.task = None

    async def launch_running(self, rid):
        await Launcher(self.client, self.store, use_jobset=True).launch(_spec(rid))
        cp = self.store.read_checkpoint(ALGORITHM, rid).deep_copy()
        cp.lifecycle_stage = LifecycleStage.RUNNING
        self.store.upsert_checkpoint(cp)

    async def start(self):
        self.task = asyncio.create_task(self.supervisor.start(self.ctx))
        await asyncio.sleep(0.05)

    async def wait_for_stage(self, rid, stage, timeout=5.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            cp = self.store.read_checkpoint(ALGORITHM, rid)
            if cp and cp.lifecycle_stage == stage:
                return cp
            await asyncio.sleep(0.02)
        raise AssertionError(
            f"run never reached {stage}; at "
            f"{self.store.read_checkpoint(ALGORITHM, rid).lifecycle_stage}"
        )

    async def stop(self):
        await self.supervisor.idle(timeout=10)
        self.ctx.cancel()
        await self.task


async def test_wedged_preempted_run_lands_terminal_and_jobset_deleted():
    fx = WedgeFixture()
    rid = str(uuid.uuid4())
    await fx.launch_running(rid)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("TPUPreempted", "TPU node was preempted by Cloud provider",
               "Pod", f"{rid}-workers-0-1"),
    )
    await fx.wait_for_stage(rid, LifecycleStage.PREEMPTED)
    # the controller never recreates the children; the watchdog must escalate
    cp = await fx.wait_for_stage(rid, LifecycleStage.DEADLINE_EXCEEDED)
    await fx.stop()
    assert cp.restart_count == 1
    assert cp.algorithm_failure_cause == MSG_RESTART_STALLED
    assert "never restarted" in cp.algorithm_failure_details
    assert fx.client.deleted("JobSet") == [rid]
    assert cp.is_finished()  # the reference's cannot-wedge guarantee, restored


async def test_restarted_run_is_never_flagged():
    fx = WedgeFixture(restart_deadline=timedelta(seconds=0.25))
    rid = str(uuid.uuid4())
    await fx.launch_running(rid)
    await fx.start()
    fx.client.inject(
        "ADDED", "Event",
        _event("TPUPreempted", "TPU node was preempted by Cloud provider",
               "Pod", f"{rid}-workers-0-0"),
    )
    await fx.wait_for_stage(rid, LifecycleStage.PREEMPTED)
    # the controller comes back within the deadline: new generation, and the
    # restarted workload heartbeats RUNNING
    fx.client.recreate_jobset_children(NS, rid)
    cp = fx.store.read_checkpoint(ALGORITHM, rid).deep_copy()
    cp.lifecycle_stage = LifecycleStage.RUNNING
    fx.store.upsert_checkpoint(cp)
    await asyncio.sleep(0.6)  # several full deadlines
    await fx.stop()
    cp = fx.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.RUNNING
    assert fx.supervisor.watchdog.flagged == 0
    assert fx.client.deleted("JobSet") == []


# -- budget escalation must survive a supervisor restart ----------------------


def _plain_job_objects(rid):
    labels = {
        NEXUS_COMPONENT_LABEL: JOB_LABEL_ALGORITHM_RUN,
        JOB_TEMPLATE_NAME_KEY: ALGORITHM,
    }
    job = {
        "kind": "Job",
        "metadata": {"name": rid, "namespace": NS, "uid": str(uuid.uuid4()), "labels": labels},
        "status": {},
    }
    pod = {
        "kind": "Pod",
        "metadata": {
            "name": f"{rid}-pod-0", "namespace": NS, "uid": str(uuid.uuid4()),
            "labels": {POD_JOB_NAME_LABEL: rid, **labels},
        },
        "status": {},
    }
    return job, pod


async def test_budget_escalation_survives_supervisor_restart():
    """The budget used to live only in the JobSet
    informer cache — a supervisor restarted mid-incident (fresh caches, the
    JobSet possibly already gone) saw budget=None and counted preemptions
    forever.  The launch-time ledger column must decide instead.

    The run here is at restart_count == max_restarts with NO JobSet object
    in the cluster at all; a NEW preemption incident against the fresh
    supervisor must still escalate to DEADLINE_EXCEEDED."""
    store = InMemoryCheckpointStore()
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(
        CheckpointedRequest(
            algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.RUNNING,
            restart_count=3, max_restarts=3, preempted_generation="gen-old",
        )
    )
    job, pod = _plain_job_objects(rid)
    client = FakeKubeClient({"Job": [job], "Pod": [pod]})  # note: NO JobSet
    supervisor = Supervisor(client, store, NS, resync_period=timedelta(0))
    supervisor.init(
        ProcessingConfig(
            failure_rate_base_delay=timedelta(milliseconds=5),
            failure_rate_max_delay=timedelta(milliseconds=50),
            rate_limit_elements_per_second=0,
            workers=2,
        )
    )
    ctx = LifecycleContext()
    task = asyncio.create_task(supervisor.start(ctx))
    await asyncio.sleep(0.05)
    client.inject(
        "ADDED", "Event",
        _event("TPUPreempted", "TPU node was preempted by Cloud provider",
               "Pod", f"{rid}-pod-0"),
    )
    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.DEADLINE_EXCEEDED
    assert cp.restart_count == 3  # never advertises a 4th restart
    assert cp.algorithm_failure_cause == MSG_DEADLINE_EXCEEDED
    assert "maxRestarts=3" in cp.algorithm_failure_details


async def test_launcher_persists_restart_budget():
    store = InMemoryCheckpointStore()
    client = FakeKubeClient({}, jobset_controller=True)
    rid = str(uuid.uuid4())
    await Launcher(client, store, use_jobset=True).launch(_spec(rid, num_hosts=2))
    assert store.read_checkpoint(ALGORITHM, rid).max_restarts == 3
    # plain-Job runs carry no controller budget
    rid2 = str(uuid.uuid4())
    await Launcher(client, store, use_jobset=False).launch(_spec(rid2, num_hosts=1))
    assert store.read_checkpoint(ALGORITHM, rid2).max_restarts is None
