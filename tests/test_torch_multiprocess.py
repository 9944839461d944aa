"""A launched world of processes training one run, through the port's
``workload/rehearsal.py`` (the counterpart of ``tests/test_multiprocess.py``)
and its harness, on the CPU under the one-device rehearsal map.

* 2 processes × 2 local ranks (``NEXUS_MESH=fsdp=4``) against one sqlite
  ledger: both processes report the same final loss (within 1e-6), the row
  is COMPLETED, and ``per_chip_steps`` holds exactly the reference's keys
  for the topology, ``host0/chip0 .. host1/chip1``, at 6.
* ``sp=2`` across the two processes (every ring hop crosses processes; the
  data is the replicated global batch): within 2e-3 of a one-process run
  on the same data.  ``dp=2,fsdp=2,tp=2`` over the two processes' four
  ranks each: within 2e-3 of the fsdp-4 run on the same rows.
* Checkpoints of an fsdp-2 run (f32): the save writes the one-device
  layout (the tree index equals a one-device run's); a run preempted after
  step 3 (the lifecycle's SIGTERM path) lands PREEMPTED with the emergency
  save at 3; resumed under fsdp 2 its losses equal the uninterrupted run's
  bit for bit, and resumed on one device they stay within 1e-5 of them.
* ``pp=2`` across the two processes (one rank each: every hand-off of
  the pipeline crosses the process boundary; the data is the replicated
  global batch): both processes report the same loss, within 2e-3 of a
  one-process run on the same data.
* A container whose spawned rank is killed exits non-zero inside the
  collectives' timeout.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore, SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import NullMetrics
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext, reserved_port
from tpu_nexus_torch.parallel.mesh import MeshSpec
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.train import TrainConfig

ROOT = Path(__file__).resolve().parent.parent


def _run_rehearsal(tmp_path, tag, n_procs, extra_env):
    """Launch ``n_procs`` rehearsal processes against a fresh ledger; return
    (REHEARSAL_RESULT dicts, ledger db path, run_id, algorithm)."""
    db = str(tmp_path / f"ledger-{tag}.db")
    run_id, algorithm = f"rehearsal-{tag}", "llama-rehearsal"
    store = SqliteCheckpointStore(db)
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=algorithm, id=run_id, lifecycle_stage=LifecycleStage.BUFFERED)
    )
    store.close()
    with reserved_port() as port:  # held until the processes end: process 0 listens on it beside the hold
        env_base = {
            **{k: v for k, v in os.environ.items() if not k.startswith("NEXUS")},
            "PYTHONPATH": str(ROOT),
            "NEXUS_DEVICE": "cpu",
            "NEXUS_RANK_DEVICE_MAP": "shared",
            "NEXUS_DIST_TIMEOUT_S": "120",
            "NEXUS_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "NEXUS_NUM_PROCESSES": str(n_procs),
            "NEXUS_RUN_ID": run_id,
            "NEXUS_ALGORITHM": algorithm,
            "NEXUS_REHEARSAL_DB": db,
            "NEXUS_BATCH": "4",
            "NEXUS_SEQ_LEN": "128",
            "NEXUS_STEPS": "6",
            "NEXUS_HEARTBEAT_EVERY": "2",
            **extra_env,
        }
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "tpu_nexus_torch.workload.rehearsal"],
                env={**env_base, "NEXUS_PROCESS_ID": str(i)},
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=str(tmp_path),
            )
            for i in range(n_procs)
        ]
        try:
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} ({tag}) failed:\n{out[-3000:]}"
    results = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("REHEARSAL_RESULT ")][0]
        results.append(json.loads(line[len("REHEARSAL_RESULT "):]))
    return results, db, run_id, algorithm


@pytest.fixture(scope="module")
def fsdp4(tmp_path_factory):
    """Two processes of two ranks, fsdp over the four."""
    return _run_rehearsal(tmp_path_factory.mktemp("fsdp4"), "fsdp2x2", 2, {"NEXUS_MESH": "fsdp=4"})


def test_two_processes_of_two_ranks_train_one_run(fsdp4):
    results, db, run_id, algorithm = fsdp4
    assert results[0]["final_step"] == results[1]["final_step"] == 6
    assert abs(results[0]["loss"] - results[1]["loss"]) < 1e-6
    cp = SqliteCheckpointStore(db).read_checkpoint(algorithm, run_id)
    assert cp.lifecycle_stage == LifecycleStage.COMPLETED
    # every process heartbeats its ranks' keys: 2 processes x 2 ranks
    assert cp.per_chip_steps == {
        "host0/chip0": 6, "host0/chip1": 6, "host1/chip0": 6, "host1/chip1": 6,
    }, cp.per_chip_steps


def test_ring_attention_crosses_process_boundary(tmp_path):
    ring, _, _, _ = _run_rehearsal(tmp_path, "ring-sp2", 2, {"NEXUS_MESH": "sp=2"})
    assert ring[0]["final_step"] == ring[1]["final_step"] == 6
    assert abs(ring[0]["loss"] - ring[1]["loss"]) < 1e-6
    single, _, _, _ = _run_rehearsal(tmp_path, "single", 1, {})
    assert abs(ring[0]["loss"] - single[0]["loss"]) < 2e-3, (ring[0], single[0])


def test_dp_fsdp_tp_over_two_processes_of_four_ranks(tmp_path, fsdp4):
    """Three axes at once (a group for every set of them: the gradients'
    dp all-reduce, the norm over a leaf's fsdp x tp shards): within 2e-3 of
    fsdp 4 over the same two processes (tp stays inside a process, so both
    draw the batch-rows mode's rows: the same global batch)."""
    mesh, _, _, _ = _run_rehearsal(tmp_path, "dp2fsdp2tp2", 2, {"NEXUS_MESH": "dp=2,fsdp=2,tp=2"})
    assert mesh[0]["final_step"] == mesh[1]["final_step"] == 6
    assert abs(mesh[0]["loss"] - mesh[1]["loss"]) < 1e-6
    fsdp = fsdp4[0]
    assert abs(mesh[0]["loss"] - fsdp[0]["loss"]) < 2e-3, (mesh[0], fsdp[0])


# -- checkpoints of a sharded run --------------------------------------------------------

F32 = LlamaConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=128,
                  max_seq_len=256, remat=False, dtype=torch.float32, param_dtype=torch.float32)


class _Losses(NullMetrics):
    """The per-step losses (heartbeat every step); cancels ``lifecycle``
    (the SIGTERM handler's call) once ``cancel_after`` losses are in."""

    def __init__(self, lifecycle=None, cancel_after=None):
        self.losses, self.lifecycle, self.cancel_after = [], lifecycle, cancel_after

    def gauge(self, name, value, tags=None):
        if name == "train.loss":
            self.losses.append(value)
            if self.cancel_after is not None and len(self.losses) == self.cancel_after:
                self.lifecycle.cancel("SIGTERM")


def _train(directory, mesh, store, run_id, cancel_after=None):
    lifecycle = LifecycleContext()
    telemetry = _Losses(lifecycle, cancel_after)
    cfg = WorkloadConfig(model=F32, train=TrainConfig(warmup_steps=1, total_steps=6), mesh=mesh, rank_map="shared",
                         batch_size=4, seq_len=32, steps=6, heartbeat_every=1, checkpoint_every=2,
                         checkpoint_dir=directory, device="cpu")
    ctx = ProcessContext(run_id=run_id, algorithm="a", process_id=0, num_processes=1, coordinator=None)
    summary = run_workload(cfg, store=store, ctx=ctx, lifecycle=lifecycle, telemetry=telemetry)
    return summary, telemetry.losses, store.read_checkpoint("a", run_id)


def test_a_preempted_fsdp2_run_resumes_on_fsdp2_and_on_one_device(tmp_path, monkeypatch):
    monkeypatch.setenv("NEXUS_DIST_TIMEOUT_S", "120")
    store = InMemoryCheckpointStore()
    fsdp2, one = MeshSpec(fsdp=2), MeshSpec(fsdp=1)
    _, full, row = _train(str(tmp_path / "a"), fsdp2, store, "a")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED and row.per_chip_steps == {"host0/chip0": 6, "host0/chip1": 6}
    # the sharded save is the one-device layout
    _train(str(tmp_path / "one"), one, store, "one")
    for step in ("2", "6"):
        index = [json.loads((tmp_path / d / step / "_NEXUS_TREE.json").read_text()) for d in ("a", "one")]
        assert index[0] == index[1]

    summary, head, row = _train(str(tmp_path / "b"), fsdp2, store, "b", cancel_after=3)
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED and summary["emergency_step"] == 3
    assert head == full[:3]
    shutil.copytree(tmp_path / "b", tmp_path / "c")
    summary, tail, row = _train(str(tmp_path / "b"), fsdp2, store, "b")
    assert summary["resumed_from"] == 3 and row.lifecycle_stage == LifecycleStage.COMPLETED
    assert tail == full[3:]  # bit for bit
    summary, tail, _ = _train(str(tmp_path / "c"), one, store, "c")
    assert summary["resumed_from"] == 3 and len(tail) == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(tail, full[3:])) < 1e-5


def test_pipeline_handoff_crosses_process_boundary(tmp_path):
    """pp=2 over two launched processes of one rank each: every microbatch
    hand-off (and its cotangent's) crosses the process boundary."""
    pp, db, run_id, algorithm = _run_rehearsal(tmp_path, "pp2", 2, {"NEXUS_MESH": "pp=2,fsdp=1",
                                                                    "NEXUS_PP_MICROBATCHES": "2"})
    assert pp[0]["final_step"] == pp[1]["final_step"] == 6
    assert abs(pp[0]["loss"] - pp[1]["loss"]) < 1e-6
    cp = SqliteCheckpointStore(db).read_checkpoint(algorithm, run_id)
    assert cp.lifecycle_stage == LifecycleStage.COMPLETED
    assert cp.per_chip_steps == {"host0/chip0": 6, "host1/chip0": 6}
    single, _, _, _ = _run_rehearsal(tmp_path, "pp-single", 1, {"NEXUS_MESH": "fsdp=1"})
    assert abs(pp[0]["loss"] - single[0]["loss"]) < 2e-3, (pp[0], single[0])


def test_a_dead_local_rank_fails_the_container(tmp_path):
    """A container of two ranks whose spawned rank is killed mid-run exits
    non-zero, well inside NEXUS_DIST_TIMEOUT_S, its row not COMPLETED."""
    import re
    import signal
    import time

    db = str(tmp_path / "ledger.db")
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}, "PYTHONPATH": str(ROOT),
           "NEXUS_DEVICE": "cpu", "NEXUS_RANK_DEVICE_MAP": "shared", "NEXUS_MESH": "fsdp=2",
           "NEXUS_DIST_TIMEOUT_S": "60", "NEXUS_STEPS": "500", "NEXUS_HEARTBEAT_EVERY": "1", "NEXUS_BATCH": "2",
           "NEXUS_SEQ_LEN": "32", "NEXUS_RUN_ID": "dead", "NEXUS_ALGORITHM": "a",
           "NEXUS__CQL_STORE_TYPE": "sqlite", "NEXUS__SQLITE_STORE_PATH": db}
    proc = subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], env=env, cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        pid, lines = None, []
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"started local rank 1 \(global 1\) pid (\d+)", line)
            pid = int(m.group(1)) if m else pid
            if pid and re.search(r"\bstep 2 loss ", line):
                break
        assert pid, "".join(lines[-20:])
        os.kill(pid, signal.SIGKILL)
        t0 = time.monotonic()
        rest = proc.stderr.read()
        rc = proc.wait(timeout=120)
        assert rc != 0, rest[-2000:]
        assert time.monotonic() - t0 < 60, rest[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cp = SqliteCheckpointStore(db).read_checkpoint("a", "dead")
    assert cp.lifecycle_stage == LifecycleStage.RUNNING and cp.hlo_trace_ref
