"""Checkpoint chaos through the port's training harness on the CPU: torn
saves, bit rot, preemption, poisoned data and wedged steps — and the
recovery the restart-from-step contract promises.

* one fault plan (``nan-grads`` at draw 5, and a ``loss-spike`` streak
  past the skip budget; ``checkpoint_every`` 2) run through the JAX
  package's harness and the port's gives equal ``health_rollback`` records
  (``flagged_step``, ``restored_step``, ``skipped_window``) and the same
  final lifecycle stage;
* a crash between the payload write and the commit marker
  (``ckpt-crash-mid-save``), at every checkpoint boundary, restarts from
  the last committed step and ends bit-identical to the uninterrupted run;
* the ledger never points at an uncommitted step: a failing commit leaves
  the previous pointer;
* a flipped committed byte (``ckpt-bitflip``) rolls the next restore back
  one step, cause recorded in the summary, the metrics and the ledger;
* preemption converts to a saved step (and skips the duplicate when the
  step is already durable), in process and as a real SIGTERM to
  ``python -m tpu_nexus_torch.workload``;
* ``step-hang``: the watchdog saves the last completed step and exits 70 —
  unless the hang sits inside the window where the step writes the
  in-place state, where it saves nothing;
* a drill that injects nothing fails loudly;
* a corruption fuzz over 100 seeds lands the newest step that proves itself.

Model: the mnist MLP (float batches carry the data poison).  Tolerance:
none — losses and parameters are compared bit for bit within the port;
across packages only the recovery records and stages are compared.
"""

import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from tpu_nexus.checkpoint.models import LifecycleStage as JaxStage
from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxStore
from tpu_nexus.models.registry import get_adapter as jax_get_adapter
from tpu_nexus.parallel import MeshSpec
from tpu_nexus.parallel.distributed import ProcessContext as JaxContext
from tpu_nexus.workload.harness import WorkloadConfig as JaxWorkloadConfig
from tpu_nexus.workload.harness import run_workload as jax_run_workload
from tpu_nexus.workload.health import HealthConfig as JaxHealthConfig
from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore, SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import NullMetrics, RecordingMetrics
from tpu_nexus_torch.models.registry import get_adapter
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.workload import durability, harness
from tpu_nexus_torch.workload.faults import (
    FaultPlan,
    checkpoint_fault_hook,
    flip_committed_leaf,
    maybe_inject,
)
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.health import HealthConfig
from tpu_nexus_torch.workload.tensor_checkpoint import CheckpointUncommitted, TensorCheckpointer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
ALGORITHM = "mnist-train"
CTX = ProcessContext(run_id="run-ckpt", algorithm=ALGORITHM, process_id=0, num_processes=1, coordinator=None)
#: the drills' launcher env: the mnist preset on the CPU, checkpoints every
#: 2, and one CPU thread as in this process — a bit-identical resume needs
#: the crashed run and the restart to reduce in the same order
DRILL_ENV = {
    "OMP_NUM_THREADS": "1",
    "NEXUS_MODEL_PRESET": "mnist", "NEXUS_DEVICE": "cpu", "NEXUS_BATCH": "8", "NEXUS_SEQ_LEN": "16",
    "NEXUS_STEPS": "6", "NEXUS_HEARTBEAT_EVERY": "2", "NEXUS_CHECKPOINT_EVERY": "2",
    "NEXUS_WARMUP_STEPS": "2", "NEXUS_ALGORITHM": ALGORITHM,
}


def mnist_cfg(**over):
    base = dict(model=get_adapter("mnist"), batch_size=8, seq_len=16, steps=6, heartbeat_every=2,
                checkpoint_every=2, health=HealthConfig(warmup_steps=2), device="cpu")
    base.update(over)
    return WorkloadConfig(**base)


def seeded_store(rid=CTX.run_id):
    store = InMemoryCheckpointStore()
    store.upsert_checkpoint(CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.BUFFERED))
    return store


def _run(cfg, store=None, **kw):
    kw.setdefault("lifecycle", LifecycleContext())
    kw.setdefault("telemetry", NullMetrics())
    return run_workload(cfg, store=store if store is not None else seeded_store(), ctx=CTX, **kw)


# -- one fault plan through both harnesses --------------------------------------


@pytest.mark.parametrize(
    "mode,fault_step,times,cause",
    [("nan-grads", 5, 1, "numeric-nan"), ("loss-spike", 4, 4, "loss-spike")],
)
def test_one_fault_plan_rolls_back_alike_in_both_packages(tmp_path, monkeypatch, mode, fault_step, times, cause):
    monkeypatch.setenv("NEXUS_FAULT_MODE", mode)
    monkeypatch.setenv("NEXUS_FAULT_STEP", str(fault_step))
    monkeypatch.setenv("NEXUS_FAULT_TIMES", str(times))
    common = dict(batch_size=8, seq_len=16, steps=10, heartbeat_every=2, checkpoint_every=2)
    jax_store = JaxStore()
    jax_ctx = JaxContext(run_id="run-ckpt", algorithm=ALGORITHM, process_id=0, num_processes=1, coordinator=None)
    ref = jax_run_workload(
        JaxWorkloadConfig(model=jax_get_adapter("mnist"), mesh=MeshSpec(fsdp=-1), checkpoint_dir=str(tmp_path / "jax"),
                          health=JaxHealthConfig(warmup_steps=2), **common),
        store=jax_store, ctx=jax_ctx, lifecycle=LifecycleContext(),
    )
    store = seeded_store()
    rec = RecordingMetrics()
    mine = _run(WorkloadConfig(model=get_adapter("mnist"), checkpoint_dir=str(tmp_path / "port"),
                               health=HealthConfig(warmup_steps=2), device="cpu", **common),
                store, telemetry=rec)
    keys = ("cause", "flagged_step", "restored_step", "skipped_window")
    records = [{k: e[k] for k in keys} for e in mine["health_rollbacks"]]
    assert records == [{k: e[k] for k in keys} for e in ref["health_rollbacks"]]
    assert records and records[0]["cause"] == cause
    assert mine["final_step"] == ref["final_step"] == 10
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert jax_store.read_checkpoint(ALGORITHM, "run-ckpt").lifecycle_stage == JaxStage.COMPLETED
    # the port's COMPLETED details keep the recovery beside the goodput
    details = json.loads(row.algorithm_failure_details)
    assert [{k: e[k] for k in keys} for e in details["health_rollback"]] == records
    assert "goodput" in details
    assert rec.tagged_counts[("train.rollback", (f"cause:{cause}",))] == 1
    restored = records[0]["restored_step"]
    assert any(n.startswith(f"{restored + 2}{durability.ABANDONED_SUFFIX}") for n in os.listdir(tmp_path / "port"))
    assert row.tensor_checkpoint_uri == f"{tmp_path / 'port'}/10"


def test_nan_rollback_is_bit_identical_to_the_post_skip_schedule(tmp_path, monkeypatch):
    """After the rollback the run is a fault-free run on the post-skip
    schedule: a run that skips the same window from the start ends with
    the same loss and parameters."""
    from tpu_nexus_torch.workload.data import DataCursor

    monkeypatch.setenv("NEXUS_FAULT_MODE", "nan-grads")
    monkeypatch.setenv("NEXUS_FAULT_STEP", "5")
    result = _run(mnist_cfg(steps=8, checkpoint_dir=str(tmp_path / "a")))
    monkeypatch.delenv("NEXUS_FAULT_MODE")
    [event] = result["health_rollbacks"]
    clean = _run(mnist_cfg(steps=8, checkpoint_dir=str(tmp_path / "b")),
                 data=DataCursor(get_adapter("mnist").data(8, 16, seed=0), skips=[event["skipped_window"]]))
    assert result["loss"] == clean["loss"]
    a = TensorCheckpointer(str(tmp_path / "a")).restore_params(8, device="cpu")
    b = TensorCheckpointer(str(tmp_path / "b")).restore_params(8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


# -- fault seams ------------------------------------------------------------------


def test_maybe_inject_guards_vacuous_checkpoint_drills():
    plan = FaultPlan(mode="ckpt-bitflip", step=3)
    with pytest.raises(ValueError, match="no checkpointer"):
        maybe_inject(plan, 3)
    maybe_inject(plan, 3, checkpoint_faults_handled=True)
    maybe_inject(plan, 2)
    assert checkpoint_fault_hook(FaultPlan(mode=None, step=0)) is None
    assert checkpoint_fault_hook(FaultPlan(mode="hbm-oom", step=0)) is None
    assert checkpoint_fault_hook(FaultPlan(mode="ckpt-bitflip", step=2)) is not None


@pytest.mark.parametrize(
    "env",
    [
        {"NEXUS_FAULT_MODE": "ckpt-bitflip", "NEXUS_FAULT_STEP": "3"},  # boundaries are 2, 4, 6
        {"NEXUS_FAULT_MODE": "nan-grads", "NEXUS_FAULT_STEP": "99"},
        {"NEXUS_FAULT_MODE": "step-hang", "NEXUS_FAULT_STEP": "99", "NEXUS_STEP_TIMEOUT_S": "30"},
    ],
)
def test_a_drill_that_injects_nothing_fails_loudly(tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    health = HealthConfig.from_env(env)
    with pytest.raises(RuntimeError, match="injected nothing"):
        _run(mnist_cfg(checkpoint_dir=str(tmp_path), health=health))


def test_commit_failure_never_reaches_ledger(tmp_path, monkeypatch):
    original = TensorCheckpointer.commit

    def failing_commit(self, step):
        if step == 4:
            raise RuntimeError("injected save failure at the barrier")
        return original(self, step)

    monkeypatch.setattr(TensorCheckpointer, "commit", failing_commit)
    store = seeded_store()
    with pytest.raises(RuntimeError, match="injected save failure"):
        _run(mnist_cfg(checkpoint_dir=str(tmp_path)), store)
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    assert row.tensor_checkpoint_uri == f"{tmp_path}/2"
    assert row.lifecycle_stage == LifecycleStage.RUNNING  # crash: the supervisor's call
    assert TensorCheckpointer(str(tmp_path)).latest_verified_step() == 2


def _cancelling_data(lc, at, seed=0):
    src = get_adapter("mnist").data(8, 16, seed=seed)
    i = 0
    while True:
        if i == at:
            lc.cancel("SIGTERM")
        yield next(src)
        i += 1


def test_emergency_save_on_cancellation_and_resume(tmp_path):
    d = str(tmp_path)
    store = seeded_store()
    lc = LifecycleContext()
    rec = RecordingMetrics()
    result = _run(mnist_cfg(steps=10, checkpoint_every=50, checkpoint_dir=d), store,
                  data=_cancelling_data(lc, 3), lifecycle=lc, telemetry=rec)
    step = result["emergency_step"]
    assert result["preempted"] is True and step == result["final_step"] and 0 < step < 10
    assert result["emergency_skipped"] is False and result["emergency_save_s"] <= result["grace_s"]
    assert rec.counters["train.emergency_save"] == 1
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED and row.algorithm_failure_cause == "signal:SIGTERM"
    details = json.loads(row.algorithm_failure_details)
    assert details["emergency_step"] == step and details["reason"] == "SIGTERM" and "goodput" in details
    assert row.tensor_checkpoint_uri == f"{d}/{step}"
    resumed = _run(mnist_cfg(steps=10, checkpoint_every=50, checkpoint_dir=d), store)
    assert resumed["resumed_from"] == step and resumed["final_step"] == 10
    assert store.read_checkpoint(ALGORITHM, CTX.run_id).lifecycle_stage == LifecycleStage.COMPLETED
    baseline = _run(mnist_cfg(steps=10, checkpoint_every=50, checkpoint_dir=str(tmp_path / "base")))
    assert resumed["loss"] == baseline["loss"]


def test_emergency_save_skips_duplicate_of_committed_step(tmp_path):
    store = seeded_store()
    lc = LifecycleContext()
    result = _run(mnist_cfg(steps=2, checkpoint_every=2, checkpoint_dir=str(tmp_path)), store,
                  data=_cancelling_data(lc, 1), lifecycle=lc, telemetry=RecordingMetrics())
    assert result["preempted"] is True
    assert result["emergency_skipped"] is True and result["emergency_step"] == 2
    assert os.listdir(tmp_path) == ["2"]
    details = json.loads(store.read_checkpoint(ALGORITHM, CTX.run_id).algorithm_failure_details)
    assert details["emergency_skipped"] is True


def _bitflip_then_restart(tmp_path, monkeypatch, store, **run_kw):
    d = str(tmp_path)
    monkeypatch.setenv("NEXUS_FAULT_MODE", "ckpt-bitflip")
    monkeypatch.setenv("NEXUS_FAULT_STEP", "4")
    _run(mnist_cfg(steps=4, checkpoint_dir=d), store)
    monkeypatch.delenv("NEXUS_FAULT_MODE")
    monkeypatch.delenv("NEXUS_FAULT_STEP")
    row = store.read_checkpoint(ALGORITHM, CTX.run_id).deep_copy()
    row.lifecycle_stage = LifecycleStage.PREEMPTED  # a restarted run arrives non-terminal
    store.upsert_checkpoint(row)
    return _run(mnist_cfg(steps=8, checkpoint_dir=d), store, **run_kw)


def test_bitflip_rollback_records_cause_everywhere(tmp_path, monkeypatch):
    store = seeded_store()
    rec = RecordingMetrics()
    result = _bitflip_then_restart(tmp_path, monkeypatch, store, telemetry=rec)
    assert result["resumed_from"] == 2 and result["final_step"] == 8
    assert [e["cause"] for e in result["ckpt_rollbacks"]] == ["corrupt"]
    assert rec.tagged_counts[("train.ckpt_rollback", ("cause:corrupt",))] == 1
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    rollback = json.loads(row.algorithm_failure_details)["ckpt_rollback"]
    assert rollback[0]["step"] == 4 and rollback[0]["cause"] == "corrupt"
    assert any(n.startswith("4" + durability.QUARANTINE_SUFFIX) for n in os.listdir(tmp_path))
    assert row.tensor_checkpoint_uri == f"{tmp_path}/8"
    assert TensorCheckpointer(str(tmp_path)).latest_verified_step() == 8


def test_preemption_details_keep_rollback_evidence(tmp_path, monkeypatch):
    store = seeded_store()
    lc = LifecycleContext()
    result = _bitflip_then_restart(tmp_path, monkeypatch, store, data=_cancelling_data(lc, 3), lifecycle=lc)
    assert result["preempted"] is True and result["resumed_from"] == 2
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED
    details = json.loads(row.algorithm_failure_details)
    assert details["emergency_step"] == result["final_step"]
    assert details["ckpt_rollback"][0]["step"] == 4 and details["ckpt_rollback"][0]["cause"] == "corrupt"


# -- the hang protocol --------------------------------------------------------------


@pytest.mark.parametrize("inside_the_write_window", [False, True])
def test_hang_handler_saves_only_a_consistent_state(tmp_path, monkeypatch, inside_the_write_window):
    from tpu_nexus_torch.workload.train import TrainConfig, init_train_state

    cfg = mnist_cfg(checkpoint_dir=str(tmp_path))
    state = init_train_state(torch.Generator().manual_seed(0), cfg.model, TrainConfig(), "cpu")
    state["step"] += 5
    store = seeded_store()
    ckpt = TensorCheckpointer(str(tmp_path))
    lock = threading.Lock()
    latest_ref = {"snap": (state, {"position": 5, "skips": []})}
    exits = []
    monkeypatch.setattr("os._exit", exits.append)
    handler = harness._make_hang_handler(cfg, harness.LedgerReporter(store, CTX), CTX, RecordingMetrics(),
                                         ckpt=ckpt, latest_ref=latest_ref, state_lock=lock)
    if inside_the_write_window:
        lock.acquire()
    handler(5, 1.0)
    assert exits == [70]
    row = store.read_checkpoint(ALGORITHM, CTX.run_id)
    details = json.loads(row.algorithm_failure_details)
    assert row.lifecycle_stage == LifecycleStage.FAILED and details["hang_step"] == 5
    if inside_the_write_window:
        assert details["emergency_step"] is None and os.listdir(tmp_path) == []
    else:
        assert details["emergency_step"] == 5 and row.tensor_checkpoint_uri == f"{tmp_path}/5"
        assert ckpt.load_cursor(5) == {"position": 5, "skips": []}
        assert lock.locked()  # held until the exit: no step may write under the save


# -- subprocess drills: real crashes, real signals ---------------------------------


def _entrypoint(tmp_path, rid, fault=None, timeout=240, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT), NEXUS_RUN_ID=rid, NEXUS__CQL_STORE_TYPE="sqlite",
                NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"),
                NEXUS_CHECKPOINT_DIR=str(tmp_path / "ckpt"), **dict(DRILL_ENV, **env))
    if fault is not None:
        full.update(NEXUS_FAULT_MODE=fault[0], NEXUS_FAULT_STEP=str(fault[1]))
    return subprocess.run([sys.executable, "-m", "tpu_nexus_torch.workload"], env=full, cwd=tmp_path,
                          capture_output=True, text=True, timeout=timeout)


def _ledger(tmp_path, rid):
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        return store.read_checkpoint(ALGORITHM, rid)
    finally:
        store.close()


def _drill_cfg(ckpt_dir, steps=6):
    env = dict(DRILL_ENV, NEXUS_STEPS=str(steps), NEXUS_CHECKPOINT_DIR=str(ckpt_dir))
    return WorkloadConfig.from_env(env)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted 6-step run: its loss and final parameters."""
    d = tmp_path_factory.mktemp("baseline")
    result = _run(_drill_cfg(d / "ckpt"))
    params = TensorCheckpointer(str(d / "ckpt")).restore_params(6, device="cpu")
    return result["loss"], [p.detach().clone() for p in params.parameters()]


@pytest.mark.parametrize("boundary", [2, 4, 6])
def test_crash_at_every_checkpoint_boundary_resumes_bit_identical(tmp_path, baseline, boundary):
    rid = f"crash-{boundary}"
    proc = _entrypoint(tmp_path, rid, fault=("ckpt-crash-mid-save", boundary))
    assert proc.returncode == 1, proc.stderr[-3000:]
    ckpt_dir = tmp_path / "ckpt"
    row = _ledger(tmp_path, rid)
    # the ledger never saw the torn URI: publish is behind the barrier
    expected_resume = boundary - 2
    assert (row.tensor_checkpoint_uri or None) == (f"{ckpt_dir}/{expected_resume}" if expected_resume else None)
    with pytest.raises(CheckpointUncommitted):
        durability.verify_step(str(ckpt_dir / str(boundary)), boundary)
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        result = run_workload(_drill_cfg(ckpt_dir), store=store, lifecycle=LifecycleContext(),
                              telemetry=NullMetrics(),
                              ctx=ProcessContext(run_id=rid, algorithm=ALGORITHM, process_id=0, num_processes=1,
                                                 coordinator=None))
        row = store.read_checkpoint(ALGORITHM, rid)
    finally:
        store.close()
    assert result["resumed_from"] == (expected_resume or None) and result["final_step"] == 6
    assert [e["cause"] for e in result["ckpt_rollbacks"]] == ["uncommitted"]
    assert os.path.isdir(str(ckpt_dir / str(boundary)) + durability.QUARANTINE_SUFFIX)
    loss, params = baseline
    assert result["loss"] == loss
    final = TensorCheckpointer(str(ckpt_dir)).restore_params(6, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(final.parameters(), params))
    assert row.lifecycle_stage == LifecycleStage.COMPLETED and row.tensor_checkpoint_uri == f"{ckpt_dir}/6"
    assert "ckpt_rollback" in row.algorithm_failure_details


def test_preempt_sigterm_is_a_real_signal_to_the_entrypoint(tmp_path):
    """``preempt-sigterm`` sends SIGTERM to the process during the step-4
    save window: the handler catches it, the commit completes, and the
    emergency path skips the duplicate and lands PREEMPTED at 4."""
    proc = _entrypoint(tmp_path, "sigterm", fault=("preempt-sigterm", 4), NEXUS_STEPS="8")
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = _ledger(tmp_path, "sigterm")
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED and row.algorithm_failure_cause == "signal:SIGTERM"
    details = json.loads(row.algorithm_failure_details)
    assert details["emergency_step"] == 4 and details["emergency_skipped"] is True
    assert row.tensor_checkpoint_uri == f"{tmp_path / 'ckpt'}/4"
    assert TensorCheckpointer(str(tmp_path / "ckpt")).latest_verified_step() == 4


def test_an_external_sigterm_mid_run_saves_and_resumes(tmp_path):
    """A SIGTERM from outside (the runtime's preemption) while the loop
    runs: the row lands PREEMPTED at a saved step, and a restart resumes
    from it to COMPLETED."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), NEXUS_RUN_ID="ext", NEXUS__CQL_STORE_TYPE="sqlite",
               NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"), NEXUS_CHECKPOINT_DIR=str(tmp_path / "ckpt"),
               **dict(DRILL_ENV, NEXUS_STEPS="1000000", NEXUS_CHECKPOINT_EVERY="1000"))
    proc = subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], env=env, cwd=tmp_path,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stderr:
            if "step 4 loss" in line:
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    row = _ledger(tmp_path, "ext")
    details = json.loads(row.algorithm_failure_details)
    saved = details["emergency_step"]
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED and saved >= 4
    assert row.tensor_checkpoint_uri == f"{tmp_path / 'ckpt'}/{saved}"
    resumed = _entrypoint(tmp_path, "ext", NEXUS_STEPS=str(saved + 2), NEXUS_CHECKPOINT_EVERY="1000")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert f"restored verified tensor checkpoint at step {saved}" in resumed.stderr
    assert _ledger(tmp_path, "ext").lifecycle_stage == LifecycleStage.COMPLETED


def test_step_hang_drill_saves_and_exits_classified(tmp_path):
    proc = _entrypoint(tmp_path, "hang", fault=("step-hang", 5), NEXUS_STEPS="8", NEXUS_STEP_TIMEOUT_S="1.0")
    assert proc.returncode == 70, proc.stderr[-3000:]
    row = _ledger(tmp_path, "hang")
    details = json.loads(row.algorithm_failure_details)
    assert row.lifecycle_stage == LifecycleStage.FAILED and "step-hang" in row.algorithm_failure_cause
    assert details["hang_step"] == 5 and details["emergency_step"] == 5
    assert row.tensor_checkpoint_uri == f"{tmp_path / 'ckpt'}/5"
    ckpt = TensorCheckpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_verified_step() == 5 and ckpt.load_cursor(5)["position"] == 5


# -- the corruption fuzz -------------------------------------------------------------


def _tiny_state(step, scale):
    return {"params": {"w": torch.arange(8.0) * scale, "b": torch.ones(3) * step},
            "step": torch.tensor(step, dtype=torch.int32)}


@pytest.mark.parametrize("block", range(10))
def test_corruption_fuzz(tmp_path, block):
    """Seeds ``10 * block`` .. ``10 * block + 9``: random step series, a
    random corruption of a random step; the scan always lands the newest
    step that still proves itself, and a fresh restore lands there too."""
    ops = ("none", "bitflip", "remove-marker", "truncate", "delete-file", "delete-dir")
    for seed in range(10 * block, 10 * block + 10):
        rng = random.Random(seed)
        d = str(tmp_path / f"s{seed}")
        steps = sorted(rng.sample(range(1, 20), rng.randint(1, 3)))
        ckpt = TensorCheckpointer(d, max_to_keep=10)
        for s in steps:
            ckpt.save(s, _tiny_state(s, scale=rng.random() + 0.5))
            ckpt.commit(s)
        victim, op = rng.choice(steps), rng.choice(ops)
        step_dir = os.path.join(d, str(victim))
        if op == "bitflip":
            flip_committed_leaf(step_dir)
        elif op == "remove-marker":
            os.remove(os.path.join(step_dir, durability.MANIFEST_NAME))
        elif op == "truncate":
            target = os.path.join(step_dir, durability.manifest_files(step_dir)[0])
            with open(target, "r+b") as fh:
                fh.truncate(max(os.path.getsize(target) - 1, 0))
        elif op == "delete-file":
            os.remove(os.path.join(step_dir, durability.manifest_files(step_dir)[-1]))
        elif op == "delete-dir":
            shutil.rmtree(step_dir)
        expected = [s for s in steps if op == "none" or s != victim]
        found, rollbacks = durability.newest_verified_step(d, quarantine=bool(seed % 2))
        assert found == (max(expected) if expected else None), (seed, op, victim, steps)
        if op in ("bitflip", "remove-marker", "truncate", "delete-file") and victim > (found or -1):
            assert rollbacks and rollbacks[0]["step"] == victim, (seed, op)
        if found is not None:
            restored = TensorCheckpointer(d, max_to_keep=10).restore(_tiny_state(0, 1.0))
            assert int(restored["step"]) == found, (seed, op)
