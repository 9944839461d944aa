"""The port's counterpart of ``tests/test_chaos.py`` (``tpu_nexus_torch``).

Sustained-load chaos: many runs x many hosts x interleaved event storms
(SURVEY §5.2 — the reference has no stress coverage at all; a 16-event
storm was the ceiling before).

32 runs, each assigned a random scenario, every event duplicated by 8
"hosts" and injected from 4 concurrent tasks in globally shuffled order with
jittered delays.  Asserts per-run terminal-state correctness (the stage
partial order made every interleaving deterministic), delete-exactly-once,
no regressions of finished runs, and full queue drain under production-like
concurrency.
"""

import asyncio
import random
import uuid
from datetime import timedelta

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor

from tests.test_torch_supervisor import ALGORITHM, NS, event_obj, job_obj, pod_obj

HOSTS = 8
RUNS = 32

# scenario -> (events fired for the run, expected terminal stage, job deleted?)
SCENARIOS = {
    "deadline": (["Started", "DeadlineExceeded"], LifecycleStage.DEADLINE_EXCEEDED, True),
    "fatal": (["Started", "BackOff"], LifecycleStage.FAILED, True),
    "oom": (["Started", "PodFailurePolicy"], LifecycleStage.FAILED, True),
    "preempt": (["Started", "TPUPreempted"], LifecycleStage.PREEMPTED, False),
    "healthy": (["Started"], LifecycleStage.RUNNING, False),
    "cancelled": (["Started"], LifecycleStage.CANCELLED, False),  # pre-cancelled run
}

_JOB_REASONS = {"DeadlineExceeded", "PodFailurePolicy"}


async def test_chaos_storm_32_runs_8_hosts():
    rng = random.Random(42)
    store = InMemoryCheckpointStore()
    runs = []
    objects = {"Job": [], "Pod": []}
    for i in range(RUNS):
        rid = str(uuid.uuid4())
        kind = rng.choice(list(SCENARIOS))
        runs.append((rid, kind))
        objects["Job"].append(job_obj(rid))
        objects["Pod"].append(pod_obj(rid))
        seed = (
            LifecycleStage.CANCELLED if kind == "cancelled" else LifecycleStage.BUFFERED
        )
        store.upsert_checkpoint(
            CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=seed)
        )

    client = FakeKubeClient(objects)
    supervisor = Supervisor(client, store, NS, resync_period=timedelta(0))
    supervisor.init(
        ProcessingConfig(
            failure_rate_base_delay=timedelta(milliseconds=5),
            failure_rate_max_delay=timedelta(milliseconds=50),
            # production-like: info lane rate-limited, failure lane unthrottled
            rate_limit_elements_per_second=200,
            rate_limit_elements_burst=100,
            workers=2,
            failure_lane_workers=4,
        )
    )
    ctx = LifecycleContext()
    task = asyncio.create_task(supervisor.start(ctx))
    await asyncio.sleep(0.05)

    # Build the storm in causal PHASES: within one run, all hosts' Started
    # duplicates precede the failure-event duplicates (after the pods die no
    # kubelet emits Started again — a fully random interleaving would be
    # unphysical).  WITHIN a phase, events from all runs and hosts race in
    # shuffled order across 4 concurrent injector tasks.
    phases = [[], []]
    for rid, kind in runs:
        reasons, _, _ = SCENARIOS[kind]
        pod_name = rid + "-pod-0"
        for phase_idx, reason in enumerate(reasons):
            for host in range(HOSTS):
                target_kind = "Job" if reason in _JOB_REASONS else "Pod"
                target = rid if target_kind == "Job" else pod_name
                evt = event_obj(reason, f"host-{host}: {reason}", target_kind, target)
                evt["metadata"]["name"] = f"evt-{reason}-{rid[:8]}-{host}"
                phases[phase_idx].append(evt)
    storm_size = sum(len(p) for p in phases)

    async def injector(chunk):
        for evt in chunk:
            client.inject("ADDED", "Event", evt)
            if rng.random() < 0.1:
                await asyncio.sleep(0.001)

    for phase in phases:
        rng.shuffle(phase)
        await asyncio.gather(*(injector(phase[i::4]) for i in range(4)))
        # drain between phases: the dual lanes (rate-limited info lane vs
        # unthrottled failure lane) would otherwise reorder ACROSS the
        # causal boundary, which no real cluster produces
        assert await supervisor.idle(timeout=60)

    assert await supervisor.idle(timeout=60), "queues must drain under sustained load"
    ctx.cancel()
    await task

    deletes = client.deleted("Job")
    for rid, kind in runs:
        _, expected_stage, deleted = SCENARIOS[kind]
        cp = store.read_checkpoint(ALGORITHM, rid)
        assert cp.lifecycle_stage == expected_stage, (kind, rid, cp.lifecycle_stage)
        # delete-exactly-once despite 8 duplicate events per decision
        assert deletes.count(rid) == (1 if deleted else 0), (kind, rid, deletes.count(rid))
        if kind == "preempt":
            # ONE preemption incident -> restart_count exactly 1 despite 8
            # duplicate events (duplicate-suppression found by this test)
            assert cp.restart_count == 1, (rid, cp.restart_count)
        if kind == "cancelled":
            # the IsFinished guard held against every late Started event
            assert cp.restart_count == 0

    # the full storm was seen and the latency pipeline kept up
    assert supervisor.events_seen == storm_size
    summary = supervisor.latency_summary()
    assert summary["count"] > 0
    assert summary["p50"] < 5.0, summary  # north star under 1,280-event chaos


class _CountingStore(InMemoryCheckpointStore):
    """Records every SUCCESSFUL lifecycle CAS commit — the observable for
    exactly-once assertions across supervisor replicas."""

    def __init__(self):
        super().__init__()
        self.commits = []  # (run id, committed stage)

    def compare_and_set(self, algorithm, id, expected, fields):
        ok = super().compare_and_set(algorithm, id, expected, fields)
        if ok and "lifecycle_stage" in fields:
            self.commits.append((id, fields["lifecycle_stage"]))
        return ok


async def test_chaos_storm_two_supervisor_replicas():
    """The reference chart scales past one replica at
    ~1000 pods (.helm/values.yaml:124-125), so TWO supervisors over ONE
    store and ONE cluster must coexist.  Both replicas see the full storm;
    the CAS ledger commits + the preemption generation fence must land
    every run terminal EXACTLY ONCE with restart_count equal to distinct
    incidents (= 1 here), despite 2 replicas x 8 host-duplicates."""
    rng = random.Random(7)
    store = _CountingStore()
    runs = []
    objects = {"Job": [], "Pod": []}
    for i in range(RUNS):
        rid = str(uuid.uuid4())
        kind = rng.choice(list(SCENARIOS))
        runs.append((rid, kind))
        objects["Job"].append(job_obj(rid))
        objects["Pod"].append(pod_obj(rid))
        seed = (
            LifecycleStage.CANCELLED if kind == "cancelled" else LifecycleStage.BUFFERED
        )
        store.upsert_checkpoint(
            CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=seed)
        )

    client = FakeKubeClient(objects)
    replicas, ctxs, tasks = [], [], []
    for _ in range(2):
        sup = Supervisor(client, store, NS, resync_period=timedelta(0))
        sup.init(
            ProcessingConfig(
                failure_rate_base_delay=timedelta(milliseconds=5),
                failure_rate_max_delay=timedelta(milliseconds=50),
                rate_limit_elements_per_second=200,
                rate_limit_elements_burst=100,
                workers=2,
                failure_lane_workers=4,
            )
        )
        ctx = LifecycleContext()
        replicas.append(sup)
        ctxs.append(ctx)
        tasks.append(asyncio.create_task(sup.start(ctx)))
    await asyncio.sleep(0.05)

    phases = [[], []]
    for rid, kind in runs:
        reasons, _, _ = SCENARIOS[kind]
        pod_name = rid + "-pod-0"
        for phase_idx, reason in enumerate(reasons):
            for host in range(HOSTS):
                target_kind = "Job" if reason in _JOB_REASONS else "Pod"
                target = rid if target_kind == "Job" else pod_name
                evt = event_obj(reason, f"host-{host}: {reason}", target_kind, target)
                evt["metadata"]["name"] = f"evt-{reason}-{rid[:8]}-{host}"
                phases[phase_idx].append(evt)

    async def injector(chunk):
        for evt in chunk:
            client.inject("ADDED", "Event", evt)
            if rng.random() < 0.1:
                await asyncio.sleep(0.001)

    for phase in phases:
        rng.shuffle(phase)
        await asyncio.gather(*(injector(phase[i::4]) for i in range(4)))
        for sup in replicas:
            assert await sup.idle(timeout=60)

    for sup in replicas:
        assert await sup.idle(timeout=60)
    for ctx in ctxs:
        ctx.cancel()
    for task in tasks:
        await task

    deletes = client.deleted("Job")
    for rid, kind in runs:
        _, expected_stage, deleted = SCENARIOS[kind]
        cp = store.read_checkpoint(ALGORITHM, rid)
        assert cp.lifecycle_stage == expected_stage, (kind, rid, cp.lifecycle_stage)
        terminal_commits = [
            (i, s) for (i, s) in store.commits
            if i == rid and LifecycleStage.is_terminal(s)
        ]
        if kind in ("deadline", "fatal", "oom"):
            # the crux: EXACTLY ONE terminal ledger commit across 2 replicas
            assert len(terminal_commits) == 1, (kind, rid, terminal_commits)
            # both replicas may ATTEMPT the k8s delete (idempotent; the
            # loser's is a swallowed NotFound) but never more than one each
            assert 1 <= deletes.count(rid) <= 2, (kind, rid, deletes.count(rid))
        else:
            assert terminal_commits == [], (kind, rid, terminal_commits)
        if kind == "preempt":
            # ONE incident -> restart_count exactly 1 despite 16 deliveries
            # (8 hosts x 2 replicas): the generation fence + CAS held
            assert cp.restart_count == 1, (rid, cp.restart_count)
            preempt_commits = [
                (i, s) for (i, s) in store.commits
                if i == rid and s == LifecycleStage.PREEMPTED
            ]
            assert len(preempt_commits) == 1, (rid, preempt_commits)
        if kind == "cancelled":
            assert cp.restart_count == 0
