"""The port's counterpart of ``tests/test_preempt_restart.py`` (``tpu_nexus_torch``).

The preempt → restart → resume loop, end to end (SURVEY §7.4).

This is the framework's flagship policy axis over the reference's
always-delete handling (services/supervisor.go:289,314,339): a TPU
preemption records PREEMPTED + restart_count WITHOUT deleting the run's
JobSet, and a relaunched workload resumes from its tensor checkpoint with
heartbeats continuous across the restart.

The test drives one run through the whole loop against a shared on-disk
sqlite ledger:

  phase A  workload subprocess, ``preempt`` fault at step 5 → dies by
           SIGTERM after committing tensor checkpoints + heartbeats;
  phase B  supervisor (real informers over a fake k8s plane) classifies the
           preemption event → PREEMPTED, restart_count=1, JobSet alive;
  phase C  relaunched workload restores from the latest committed tensor
           checkpoint, transitions PREEMPTED→RUNNING→COMPLETED, and the
           per-chip heartbeats advance past the preemption point.
"""

import asyncio
import subprocess
import sys
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
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.models import LlamaConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer
from tpu_nexus_torch.workload.train import TrainConfig

NS = "nexus"
ALGORITHM = "llama-pretrain"
STEPS = 8
FAULT_STEP = 5  # steps 0-4 run; checkpoints commit at steps 2 and 4

# Phase-A entrypoint: the same run_workload production path, in a subprocess
# because the ``preempt`` fault SIGTERMs its own process (faults.py).
_WORKLOAD_SCRIPT = """
import os, sys
os.environ["NEXUS_FAULT_MODE"] = "preempt"
os.environ["NEXUS_FAULT_STEP"] = "{fault_step}"
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.models import LlamaConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.train import TrainConfig

ledger, ckpt_dir, rid, algo = sys.argv[1:5]
run_workload(
    WorkloadConfig(
        model=LlamaConfig.tiny(),
        train=TrainConfig(warmup_steps=2, total_steps=50, learning_rate=1e-3),
        batch_size=4,
        seq_len=32,
        steps={steps},
        heartbeat_every=2,
        checkpoint_every=2,
        checkpoint_dir=ckpt_dir,
        device="cpu",
    ),
    store=SqliteCheckpointStore(ledger),
    ctx=ProcessContext(run_id=rid, algorithm=algo, process_id=0, num_processes=1, coordinator=None),
)
""".format(fault_step=FAULT_STEP, steps=STEPS)


def _preemption_objects(rid):
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
            "name": f"{rid}-pod-0",
            "namespace": NS,
            "uid": str(uuid.uuid4()),
            "labels": {POD_JOB_NAME_LABEL: rid, **labels},
        },
        "status": {},
    }
    event = {
        "kind": "Event",
        "metadata": {"name": f"evt-preempt-{rid}", "namespace": NS},
        "reason": "TPUPreempted",
        "message": "TPU node was preempted by Cloud provider",
        "type": "Warning",
        "involvedObject": {"kind": "Pod", "name": pod["metadata"]["name"], "namespace": NS},
    }
    return {"Job": [job], "Pod": [pod], "Event": [event]}


async def test_preempt_restart_resume_loop(tmp_path):
    ledger = str(tmp_path / "ledger.db")
    ckpt_dir = str(tmp_path / "ckpt")
    rid = str(uuid.uuid4())
    store = SqliteCheckpointStore(ledger)
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.BUFFERED)
    )

    # ---- phase A: the run is preempted mid-training -----------------------
    proc = await asyncio.to_thread(
        subprocess.run,
        [sys.executable, "-c", _WORKLOAD_SCRIPT, ledger, ckpt_dir, rid, ALGORITHM],
        capture_output=True,
        text=True,
        timeout=240,
    )
    # SIGTERM default disposition kills the process: -15 (or 143 via a shell)
    assert proc.returncode in (-15, 143), (proc.returncode, proc.stderr[-2000:])
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.RUNNING
    assert cp.per_chip_steps == {"host0/chip0": 4}, cp.per_chip_steps
    assert cp.tensor_checkpoint_uri.startswith(ckpt_dir)
    # commits are atomic; the latest durable step survives the SIGTERM
    resume_step = TensorCheckpointer(ckpt_dir).latest_step()
    assert resume_step in (2, 4), resume_step

    # ---- phase B: the supervisor classifies the preemption ----------------
    client = FakeKubeClient(_preemption_objects(rid))
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
    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task

    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
    assert cp.restart_count == 1
    assert not cp.is_finished()
    # the restart policy axis: NO delete — the JobSet restarts the workload
    assert not [a for a in client.actions if a[0] == "delete"], client.actions

    # ---- phase C: the restarted workload resumes from the checkpoint ------
    result = run_workload(
        WorkloadConfig(
            model=LlamaConfig.tiny(),
            train=TrainConfig(warmup_steps=2, total_steps=50, learning_rate=1e-3),
            batch_size=4,
            seq_len=32,
            steps=STEPS,
            heartbeat_every=2,
            checkpoint_every=2,
            checkpoint_dir=ckpt_dir,
            device="cpu",
        ),
        store=store,
        ctx=ProcessContext(run_id=rid, algorithm=ALGORITHM, process_id=0, num_processes=1, coordinator=None),
    )
    assert result["final_step"] == STEPS
    assert result["resumed_from"] == resume_step

    cp = store.read_checkpoint(ALGORITHM, rid)
    # PREEMPTED → RUNNING is a legal equal-rank transition; the run then
    # completes, and the restart counter records exactly one preemption
    assert cp.lifecycle_stage == LifecycleStage.COMPLETED
    assert cp.restart_count == 1
    # heartbeats continuous across the restart: every chip advanced from the
    # preemption-time step 4 to the final step
    assert cp.per_chip_steps == {"host0/chip0": STEPS}


def test_supervisor_wires_checkpoint_resolver_into_watchdog():
    """The repoint feature must exist in PRODUCTION, not only when a test
    injects the resolver: Supervisor.init wires a CachingUriResolver (the
    sweep re-checks every PREEMPTED row every interval — the bare function
    would re-hash the full checkpoint each time) and the
    watchdog_verify_checkpoints knob turns it off."""
    from tpu_nexus_torch.workload import durability

    def build(**over):
        sup = Supervisor(FakeKubeClient([]), SqliteCheckpointStore(":memory:"), NS)
        sup.init(
            ProcessingConfig(preempted_restart_deadline=timedelta(minutes=5), **over)
        )
        return sup

    assert isinstance(
        build().watchdog._resolve_verified_uri, durability.CachingUriResolver
    )
    assert build(watchdog_verify_checkpoints=False).watchdog._resolve_verified_uri is None


async def test_watchdog_repoints_unverifiable_checkpoint_uri(tmp_path):
    """The restart path's checkpoint side: a PREEMPTED
    row whose published ``tensor_checkpoint_uri`` fails manifest verification
    is restart-from-PREVIOUS-step material, not a crash loop.  The watchdog
    sweep repoints the ledger at the newest verified step (without touching
    the restart fingerprint, so the rewrite never re-arms the restart
    deadline), and the genuine restart-stalled escalation still fires."""
    import os

    import torch

    from tpu_nexus_torch.supervisor.taxonomy import DecisionAction
    from tpu_nexus_torch.supervisor.watchdog import HeartbeatWatchdog
    from tpu_nexus_torch.workload import durability
    from tpu_nexus_torch.workload.faults import flip_committed_leaf

    d = str(tmp_path / "ckpt")
    tc = TensorCheckpointer(d)
    for step in (2, 4):
        tc.save(step, {"params": {"w": torch.arange(4.0) * step}, "step": torch.tensor(step, dtype=torch.int32)})
        tc.commit(step)
    tc.close()
    flip_committed_leaf(os.path.join(d, "4"))  # silent rot on the published step

    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    rid = str(uuid.uuid4())
    store.upsert_checkpoint(
        CheckpointedRequest(
            algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.PREEMPTED,
            restart_count=1, tensor_checkpoint_uri=f"{d}/4",
        )
    )
    flagged = []
    dog = HeartbeatWatchdog(
        store, flagged.append, restart_deadline=timedelta(seconds=1000),
        resolve_verified_uri=durability.resolve_verified_uri,
    )
    await dog.sweep(now=0.0)
    cp = store.read_checkpoint(ALGORITHM, rid)
    # repointed at the newest VERIFIED step; no escalation fired
    assert cp.tensor_checkpoint_uri == f"{d}/2"
    assert dog.ckpt_rollbacks == 1 and flagged == []
    # restart fingerprint untouched by the rewrite
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED and cp.restart_count == 1
    # idempotent: the verified pointer is left alone on the next sweep
    await dog.sweep(now=1.0)
    assert dog.ckpt_rollbacks == 1
    # the rewrite is not an escalation amnesty: a genuinely stalled restart
    # still escalates once the deadline passes
    await dog.sweep(now=2000.0)
    assert [r.action for r in flagged] == [DecisionAction.TO_FAIL_RESTART_STALLED]
    # quarantine is the workload's job — the watchdog reads, never renames
    assert sorted(n for n in os.listdir(d) if n.isdigit()) == ["2", "4"]
    store.close()
