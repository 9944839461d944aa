"""CAS under real contention, in the port: the case of
``tests/test_cql_contention.py`` with the port's ``Supervisor``,
``ScyllaCqlStore`` and ``FakeKubeClient`` against the same arbitrating
coordinator (``tests/cql_arbiter.py``, a test helper that speaks the wire
through the JAX package's frame helpers — the wire is one protocol).

TWO supervisors, each with its OWN ``ScyllaCqlStore`` (a real CQL v4 wire
client over its own TCP session), drive one storm through ONE arbitrating
coordinator: every LWT is genuinely decided by the shared row store,
scripted ``[applied]=false`` interleavings force the retry loop
deterministically, and every run must still land terminal EXACTLY once.
"""

import asyncio
import random
import uuid
from datetime import timedelta
from typing import Dict

from tpu_nexus_torch.checkpoint.cql import ScyllaCqlStore
from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import NullMetrics
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor

from tests.cql_arbiter import ArbiterCqlServer
from tests.test_torch_supervisor import ALGORITHM, NS, event_obj, job_obj, pod_obj

RUNS = 12
HOSTS = 4

SCENARIOS = {
    "deadline": (["Started", "DeadlineExceeded"], LifecycleStage.DEADLINE_EXCEEDED),
    "oom": (["Started", "PodFailurePolicy"], LifecycleStage.FAILED),
    "preempt": (["Started", "TPUPreempted"], LifecycleStage.PREEMPTED),
}
_JOB_REASONS = {"DeadlineExceeded", "PodFailurePolicy"}


class CountingMetrics(NullMetrics):
    def __init__(self):
        self.counts: Dict[str, int] = {}

    def count(self, name, value=1, tags=None):
        self.counts[name] = self.counts.get(name, 0) + value


async def test_two_cql_clients_race_one_arbiter():
    server = ArbiterCqlServer(scripted_conflicts=3)
    server.start()
    seed_store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)

    rng = random.Random(11)
    runs = []
    objects = {"Job": [], "Pod": []}
    for i in range(RUNS):
        rid = str(uuid.uuid4())
        kind = list(SCENARIOS)[i % len(SCENARIOS)]
        runs.append((rid, kind))
        objects["Job"].append(job_obj(rid))
        objects["Pod"].append(pod_obj(rid))
        seed_store.upsert_checkpoint(
            CheckpointedRequest(
                algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.BUFFERED
            )
        )

    client = FakeKubeClient(objects)
    replicas, metrics, ctxs, tasks, stores = [], [], [], [], []
    for _ in range(2):
        # each replica gets its OWN wire client -> its own TCP session; the
        # shared thing is the arbitrating coordinator, as in production
        store = ScyllaCqlStore(hosts=["127.0.0.1"], port=server.port)
        stores.append(store)
        m = CountingMetrics()
        metrics.append(m)
        sup = Supervisor(client, store, NS, resync_period=timedelta(0), metrics=m)
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
        reasons, _ = SCENARIOS[kind]
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

    # the conflict-re-read-reconverge loop demonstrably executed: the
    # arbiter refused at least the scripted interleavings, and the clients
    # counted each refusal
    total_conflicts = sum(m.counts.get("ledger_cas_conflicts", 0) for m in metrics)
    assert total_conflicts >= 3, (total_conflicts, server.lwt_conflicts)
    assert server.lwt_conflicts >= total_conflicts  # arbiter saw every refusal

    for rid, kind in runs:
        _, expected_stage = SCENARIOS[kind]
        cp = seed_store.read_checkpoint(ALGORITHM, rid)
        assert cp.lifecycle_stage == expected_stage, (kind, rid, cp.lifecycle_stage)
        terminal_commits = [
            (i, s) for (i, s) in server.commits
            if i == rid and LifecycleStage.is_terminal(s)
        ]
        if kind in ("deadline", "oom"):
            # the crux: EXACTLY ONE terminal commit landed at the arbiter
            # across 2 replicas x 4 host duplicates x scripted conflicts
            assert len(terminal_commits) == 1, (kind, rid, terminal_commits)
        else:
            assert terminal_commits == [], (kind, rid, terminal_commits)
        if kind == "preempt":
            assert cp.restart_count == 1, (rid, cp.restart_count)
            preempt_commits = [
                (i, s) for (i, s) in server.commits
                if i == rid and s == LifecycleStage.PREEMPTED
            ]
            assert len(preempt_commits) == 1, (rid, preempt_commits)

    for store in stores:
        store.close()
    seed_store.close()
    server.close()
