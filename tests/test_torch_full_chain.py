"""The port's counterpart of ``tests/test_full_chain.py`` (``tpu_nexus_torch``).

Full-chain integration: the receiver-facing flow in one test (SURVEY §7.3).

    Launcher.launch (manifest + ledger-first BUFFERED row)
      → fake k8s plane (real informers watch it)
      → Supervisor (classification + decision execution)
      → REAL workload subprocess — ``python -m tpu_nexus_torch.workload`` run with
        the env extracted from the composed Job manifest, against the same
        sqlite ledger — dying with exit code 137
      → ledger BUFFERED → RUNNING → FAILED with cause + trace, Job deleted.

The reference proves this only piecewise (its test fakes the workload
entirely); here the subprocess really executes the training loop on the
CPU (``NEXUS_DEVICE=cpu``), heartbeats into the ledger, and dies by fault
injection with the container-exit-code contract the Job's PodFailurePolicy
surfaces (reference services/supervisor.go:310-313).  The two multi-host
chains of the JAX package's file (a JobSet of two worker processes, and the
preempt-recreate-resume loop across them) need more than one process and
wait for the multi-GPU slice (ROADMAP.md A6).
"""

import asyncio
import os
import subprocess
import sys
import uuid
from datetime import timedelta

from tpu_nexus_torch.checkpoint.models import (
    POD_JOB_NAME_LABEL,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient
from tpu_nexus_torch.launcher.client import Launcher
from tpu_nexus_torch.launcher.jobset import LaunchSpec, run_labels
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor
from tpu_nexus_torch.supervisor.taxonomy import MSG_FATAL_ERROR

NS = "nexus"
ALGORITHM = "llama-pretrain"


def _manifest_env(manifest) -> dict:
    """The container env a kubelet would materialize: literal values plus the
    downward-API completion index (host 0)."""
    env_list = manifest["spec"]["template"]["spec"]["containers"][0]["env"]
    env = {e["name"]: e["value"] for e in env_list if "value" in e}
    env["NEXUS_PROCESS_ID"] = "0"  # downward-API annotation, single host
    return env


async def test_full_chain_launch_run_fail(tmp_path):
    ledger = str(tmp_path / "ledger.db")
    store = SqliteCheckpointStore(ledger)
    client = FakeKubeClient({})
    rid = str(uuid.uuid4())

    # ---- launch: ledger-first BUFFERED row + Job manifest on the plane ----
    launcher = Launcher(client, store, use_jobset=False)
    spec = LaunchSpec(
        run_id=rid,
        algorithm=ALGORITHM,
        image="tpu-nexus-workload:test",
        num_hosts=1,
        namespace=NS,
        env={
            "NEXUS_FAULT_MODE": "oom",  # os._exit(137) at the fault step
            "NEXUS_FAULT_STEP": "2",
            "NEXUS_STEPS": "4",
            "NEXUS_HEARTBEAT_EVERY": "2",
            "NEXUS_BATCH": "8",
            "NEXUS_SEQ_LEN": "64",
        },
    )
    cp = await launcher.launch(spec)
    assert cp.lifecycle_stage == LifecycleStage.BUFFERED
    jobs, _ = await client.list_objects("Job", NS)
    assert len(jobs) == 1 and jobs[0]["metadata"]["name"] == rid
    assert jobs[0]["metadata"]["labels"] == run_labels(spec)

    # ---- supervisor watches the plane the launcher populated ---------------
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

    # ---- kubelet starts the pod: Started event -> RUNNING via supervisor ---
    pod = {
        "kind": "Pod",
        "metadata": {
            "name": f"{rid}-0",
            "namespace": NS,
            "uid": str(uuid.uuid4()),
            "labels": {POD_JOB_NAME_LABEL: rid, **run_labels(spec)},
        },
        "status": {},
    }
    client.inject("ADDED", "Pod", pod)
    client.inject(
        "ADDED",
        "Event",
        {
            "kind": "Event",
            "metadata": {"name": f"evt-started-{rid[:8]}", "namespace": NS},
            "reason": "Started",
            "message": "Started container workload",
            "type": "Normal",
            "involvedObject": {"kind": "Pod", "name": pod["metadata"]["name"], "namespace": NS},
        },
    )
    assert await supervisor.idle(timeout=10)
    assert store.read_checkpoint(ALGORITHM, rid).lifecycle_stage == LifecycleStage.RUNNING

    # ---- the REAL workload container, env from the composed manifest -------
    env = dict(os.environ)
    env.update(_manifest_env(jobs[0]))
    env.update(
        {
            # the workload entrypoint builds its store from the same config
            # mechanism as the supervisor: appconfig.yaml + NEXUS__* env
            "NEXUS__CQL_STORE_TYPE": "sqlite",
            "NEXUS__SQLITE_STORE_PATH": ledger,
            "NEXUS_DEVICE": "cpu",
            # sentinel off: this chain is about supervisor classification of
            # the fault-injected death (health has its own e2e drills)
            "NEXUS_HEALTH": "0",
        }
    )
    proc = await asyncio.to_thread(
        subprocess.run,
        [sys.executable, "-m", "tpu_nexus_torch.workload"],
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 137, (proc.returncode, proc.stderr[-2000:])
    cp = store.read_checkpoint(ALGORITHM, rid)
    # the subprocess really ran: steps 0-1 heartbeated before the 137 exit,
    # under the port's one device's key
    assert cp.per_chip_steps == {"host0/chip0": 2}, cp.per_chip_steps

    # ---- job controller surfaces the exit code as PodFailurePolicy ---------
    client.inject(
        "ADDED",
        "Event",
        {
            "kind": "Event",
            "metadata": {"name": f"evt-pfp-{rid[:8]}", "namespace": NS},
            "reason": "PodFailurePolicy",
            "message": (
                f"Container workload for pod {NS}/{rid}-0 failed with exit code 137 "
                "matching FailJob rule at index 0"
            ),
            "type": "Warning",
            "involvedObject": {"kind": "Job", "name": rid, "namespace": NS},
        },
    )
    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task

    # ---- terminal state: FAILED with cause + trace, Job deleted ------------
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert cp.algorithm_failure_cause == MSG_FATAL_ERROR
    assert "exit code 137" in cp.algorithm_failure_details
    assert client.deleted("Job") == [rid]
    jobs_after, _ = await client.list_objects("Job", NS)
    assert jobs_after == []


async def test_full_chain_serve_mode(tmp_path):
    """Launcher-composed manifest with NEXUS_MODE=serve: the REAL workload
    subprocess runs the batch-decode loop and commits COMPLETED — inference
    jobs ride the identical launch/env/ledger contract as training."""
    ledger = str(tmp_path / "ledger.db")
    store = SqliteCheckpointStore(ledger)
    client = FakeKubeClient({})
    rid = str(uuid.uuid4())
    launcher = Launcher(client, store, use_jobset=False)
    spec = LaunchSpec(
        run_id=rid,
        algorithm=ALGORITHM,
        image="tpu-nexus-workload:test",
        num_hosts=1,
        namespace=NS,
        env={
            "NEXUS_MODE": "serve",
            "NEXUS_STEPS": "3",
            "NEXUS_BATCH": "2",
            "NEXUS_PROMPT_LEN": "8",
            "NEXUS_GEN_TOKENS": "4",
            "NEXUS_HEARTBEAT_EVERY": "1",
        },
    )
    await launcher.launch(spec)
    jobs, _ = await client.list_objects("Job", NS)

    env = dict(os.environ)
    env.update(_manifest_env(jobs[0]))
    env.update(
        {
            "NEXUS__CQL_STORE_TYPE": "sqlite",
            "NEXUS__SQLITE_STORE_PATH": ledger,
            "NEXUS_DEVICE": "cpu",
        }
    )
    proc = await asyncio.to_thread(
        subprocess.run,
        [sys.executable, "-m", "tpu_nexus_torch.workload"],
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.COMPLETED
    assert cp.per_chip_steps  # decode-round heartbeats landed

