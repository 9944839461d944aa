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
chains of the JAX package's file run here too: a JobSet of two worker
processes, each running two training ranks of one fsdp mesh on the CPU
(the rehearsal map; the reference's hosts drive four virtual devices each),
dying with exit 137; and the preempt-recreate-resume loop across them.
"""

import asyncio
import os
import re
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
from tpu_nexus_torch.parallel.distributed import reserved_port
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



#: two training ranks a worker process, one fsdp mesh over both processes,
#: on the CPU under the rehearsal map
_MULTIHOST_ENV = {
    "NEXUS_DEVICE": "cpu",
    "NEXUS_RANK_DEVICE_MAP": "shared",
    "NEXUS_MESH": "fsdp=4",
    "NEXUS_DIST_TIMEOUT_S": "120",
    "NEXUS_HEALTH": "0",
}
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jobset_env(jobsets, ledger):
    env_list = (
        jobsets[0]["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
        ["containers"][0]["env"]
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
    env.update({e["name"]: e["value"] for e in env_list if "value" in e})
    env.update({"NEXUS__CQL_STORE_TYPE": "sqlite", "NEXUS__SQLITE_STORE_PATH": ledger, "PYTHONPATH": _ROOT,
                **_MULTIHOST_ENV})
    return env


async def _run_hosts(env, extra=None):
    """Both hosts' processes to their end: ``(procs, (out, err) each)``.
    The coordinator's port is held until they end (host 0 listens on it
    beside the hold)."""
    with reserved_port() as port:
        env = {**env, "NEXUS_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", **(extra or {})}
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "tpu_nexus_torch.workload"],
                env={**env, "NEXUS_PROCESS_ID": str(i)},
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=_ROOT,
            )
            for i in range(2)
        ]
        try:
            return procs, [await asyncio.to_thread(p.communicate, timeout=240) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _supervisor(client, store):
    supervisor = Supervisor(client, store, NS, resync_period=timedelta(0))
    supervisor.init(
        ProcessingConfig(
            failure_rate_base_delay=timedelta(milliseconds=5),
            failure_rate_max_delay=timedelta(milliseconds=50),
            rate_limit_elements_per_second=0,
            workers=2,
        )
    )
    return supervisor


async def test_full_chain_jobset_multihost(tmp_path):
    """The flagship deployment shape, end to end with ``use_jobset=True``:
    the Launcher creates a JobSet, the fake controllers materialize the
    child Job and pods, TWO real workload processes (two training ranks
    each, one mesh) run the sharded step with env lifted from the composed
    manifest and die with exit 137, and the supervisor resolves every
    child-pod/child-Job event to the OWNING run: Started -> RUNNING on the
    right row, PodFailurePolicy -> FAILED, and the delete targets the
    JobSet, never the child Job."""
    ledger = str(tmp_path / "ledger.db")
    store = SqliteCheckpointStore(ledger)
    client = FakeKubeClient({}, jobset_controller=True)
    rid = str(uuid.uuid4())

    launcher = Launcher(client, store, use_jobset=True)
    spec = LaunchSpec(
        run_id=rid,
        algorithm=ALGORITHM,
        image="tpu-nexus-workload:test",
        num_hosts=2,
        namespace=NS,
        env={
            "NEXUS_FAULT_MODE": "oom",  # every rank os._exit(137) at step 2
            "NEXUS_FAULT_STEP": "2",
            "NEXUS_STEPS": "4",
            "NEXUS_HEARTBEAT_EVERY": "2",
            "NEXUS_BATCH": "8",
            "NEXUS_SEQ_LEN": "64",
        },
    )
    cp = await launcher.launch(spec)
    assert cp.lifecycle_stage == LifecycleStage.BUFFERED
    jobsets, _ = await client.list_objects("JobSet", NS)
    assert [j["metadata"]["name"] for j in jobsets] == [rid]
    jobs, _ = await client.list_objects("Job", NS)
    assert [j["metadata"]["name"] for j in jobs] == [f"{rid}-workers-0"]
    pods, _ = await client.list_objects("Pod", NS)
    assert len(pods) == 2

    supervisor = _supervisor(client, store)
    ctx = LifecycleContext()
    task = asyncio.create_task(supervisor.start(ctx))
    await asyncio.sleep(0.05)

    client.inject(
        "ADDED",
        "Event",
        {
            "kind": "Event",
            "metadata": {"name": f"evt-started-{rid[:8]}", "namespace": NS},
            "reason": "Started",
            "message": "Started container algorithm",
            "type": "Normal",
            "involvedObject": {"kind": "Pod", "name": f"{rid}-workers-0-0", "namespace": NS},
        },
    )
    assert await supervisor.idle(timeout=10)
    assert store.read_checkpoint(ALGORITHM, rid).lifecycle_stage == LifecycleStage.RUNNING
    assert store.read_checkpoint(ALGORITHM, f"{rid}-workers-0") is None

    procs, outs = await _run_hosts(_jobset_env(jobsets, ledger))
    for i, (p, (out, _)) in enumerate(zip(procs, outs)):
        assert p.returncode == 137, f"host {i}: rc={p.returncode}\n{out[-3000:]}"
    cp = store.read_checkpoint(ALGORITHM, rid)
    # both processes heartbeated their ranks into the SAME row before dying
    assert cp.per_chip_steps == {f"host{h}/chip{c}": 2 for h in range(2) for c in range(2)}, cp.per_chip_steps

    client.inject(
        "ADDED",
        "Event",
        {
            "kind": "Event",
            "metadata": {"name": f"evt-pfp-{rid[:8]}", "namespace": NS},
            "reason": "PodFailurePolicy",
            "message": (
                f"Container algorithm for pod {NS}/{rid}-workers-0-0 failed with exit "
                "code 137 matching FailJob rule at index 0"
            ),
            "type": "Warning",
            "involvedObject": {"kind": "Job", "name": f"{rid}-workers-0", "namespace": NS},
        },
    )
    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task

    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.FAILED
    assert cp.algorithm_failure_cause == MSG_FATAL_ERROR
    assert "exit code 137" in cp.algorithm_failure_details
    assert client.deleted("JobSet") == [rid]
    assert f"{rid}-workers-0" not in client.deleted("Job")
    jobsets_after, _ = await client.list_objects("JobSet", NS)
    assert jobsets_after == []


async def test_north_star_preempt_recreate_resume_one_piece(tmp_path):
    """The north-star loop as one test: a JobSet launch; TWO real workload
    processes (two ranks each) train, heartbeat, checkpoint and die by the
    ``preempt`` fault (SIGTERM); a child-pod TPUPreempted event ->
    PREEMPTED, restart_count 1, no delete, the fence on generation 1's
    child-Job uid; the other host's event for the SAME incident and a late
    one after the recreation are suppressed; the restarted processes resume
    from the committed step and run to COMPLETED, restart_count still 1,
    per-chip heartbeats continuous across the restart, the JobSet never
    deleted."""
    ledger = str(tmp_path / "ledger.db")
    ckpt_dir = str(tmp_path / "ckpt")
    store = SqliteCheckpointStore(ledger)
    client = FakeKubeClient({}, jobset_controller=True)
    rid = str(uuid.uuid4())

    launcher = Launcher(client, store, use_jobset=True)
    spec = LaunchSpec(
        run_id=rid,
        algorithm=ALGORITHM,
        image="tpu-nexus-workload:test",
        num_hosts=2,
        namespace=NS,
        env={
            "NEXUS_STEPS": "8",
            "NEXUS_HEARTBEAT_EVERY": "2",
            "NEXUS_CHECKPOINT_EVERY": "2",
            "NEXUS_CHECKPOINT_DIR": ckpt_dir,
            "NEXUS_BATCH": "8",
            "NEXUS_SEQ_LEN": "32",
        },
    )
    cp = await launcher.launch(spec)
    assert cp.max_restarts == 3
    jobs, _ = await client.list_objects("Job", NS)
    gen1_uid = jobs[0]["metadata"]["uid"]

    supervisor = _supervisor(client, store)
    ctx = LifecycleContext()
    task = asyncio.create_task(supervisor.start(ctx))
    await asyncio.sleep(0.05)
    jobsets, _ = await client.list_objects("JobSet", NS)
    env = _jobset_env(jobsets, ledger)

    # ---- generation 1: both hosts die by the preempt fault (SIGTERM) ------
    procs, outs = await _run_hosts(env, {"NEXUS_FAULT_MODE": "preempt", "NEXUS_FAULT_STEP": "5"})
    for i, (p, (out, _)) in enumerate(zip(procs, outs)):
        assert p.returncode in (-15, 143), f"host {i}: rc={p.returncode}\n{out[-3000:]}"
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.RUNNING
    assert cp.per_chip_steps == {f"host{h}/chip{c}": 4 for h in range(2) for c in range(2)}, cp.per_chip_steps
    assert cp.tensor_checkpoint_uri.startswith(ckpt_dir)

    def preempt_event(pod_index, tag):
        return {
            "kind": "Event",
            "metadata": {"name": f"evt-preempt-{tag}-{rid[:8]}", "namespace": NS},
            "reason": "TPUPreempted",
            "message": "TPU node was preempted by Cloud provider",
            "type": "Warning",
            "involvedObject": {"kind": "Pod", "name": f"{rid}-workers-0-{pod_index}", "namespace": NS},
        }

    client.inject("ADDED", "Event", preempt_event(1, "a"))
    assert await supervisor.idle(timeout=10)
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED
    assert cp.restart_count == 1
    assert cp.preempted_generation == gen1_uid
    assert client.deleted("JobSet") == [] and client.deleted("Job") == []

    client.inject("ADDED", "Event", preempt_event(0, "b"))
    assert await supervisor.idle(timeout=10)
    assert store.read_checkpoint(ALGORITHM, rid).restart_count == 1

    client.recreate_jobset_children(NS, rid)
    jobs, _ = await client.list_objects("Job", NS)
    assert jobs[0]["metadata"]["uid"] != gen1_uid
    client.inject("ADDED", "Event", preempt_event(0, "c"))
    assert await supervisor.idle(timeout=10)
    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.restart_count == 1
    assert cp.lifecycle_stage == LifecycleStage.PREEMPTED

    # ---- generation 2: the restarted workload resumes and completes ------
    procs, outs = await _run_hosts(env)
    for i, (p, (out, _)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {i}: rc={p.returncode}\n{out[-3000:]}"
        # saves are synchronous: the step-4 commit landed before the SIGTERM
        m = re.search(r"'resumed_from': (\d+)", out)
        assert m and int(m.group(1)) == 4, out[-2000:]

    assert await supervisor.idle(timeout=10)
    ctx.cancel()
    await task

    cp = store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.COMPLETED
    assert cp.restart_count == 1
    assert cp.per_chip_steps == {f"host{h}/chip{c}": 8 for h in range(2) for c in range(2)}, cp.per_chip_steps
    assert client.deleted("JobSet") == [] and client.deleted("Job") == []
