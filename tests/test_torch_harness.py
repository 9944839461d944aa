"""The port's training harness (``run_workload``) on the CPU.

* a ``tiny`` run lands COMPLETED with per-chip heartbeats and the goodput
  accounting in the details (buckets summing to elapsed);
* a cancelled lifecycle lands PREEMPTED with the signal as the cause;
* a NaN step with no checkpoint ends the run with text the supervisor's
  taxonomy (``tpu_nexus.supervisor.taxonomy``) classifies as NUMERIC_NAN,
  whose stage there is FAILED — the reference's contract: the crash path
  raises with a trace ref, the supervisor lands the verdict;
* a CUDA out-of-memory error from the step reaches the taxonomy as an
  HBM OOM (its raw wording matches no signature);
* the hang handler writes FAILED with a classified ``step-hang`` cause;
* the mnist preset trains (loss falls);
* knobs of unported slices raise at parse, naming their ROADMAP.md item;
  the checkpoint and fault-injection knobs parse.
"""

import json

import numpy as np
import pytest
import torch

from tpu_nexus.supervisor.taxonomy import DECISION_STAGE, DecisionAction, classify_tpu_failure
from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import NullMetrics, RecordingMetrics
from tpu_nexus_torch.models.registry import get_adapter
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.workload import harness
from tpu_nexus_torch.workload import train as port_train
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.workload.health import HealthConfig

torch.set_num_threads(1)
CTX = ProcessContext(run_id="r-train", algorithm="train", process_id=0, num_processes=1, coordinator=None)


def _store():
    store = InMemoryCheckpointStore()
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm="train", id="r-train", lifecycle_stage=LifecycleStage.BUFFERED)
    )
    return store


def _tiny(**over):
    base = dict(model=get_adapter("tiny"), batch_size=2, seq_len=32, steps=4, heartbeat_every=2,
                device="cpu")
    base.update(over)
    return WorkloadConfig(**base)


def _mnist(**over):
    base = dict(model=get_adapter("mnist"), batch_size=8, seq_len=16, steps=6, heartbeat_every=2,
                device="cpu", health=HealthConfig(warmup_steps=2),
                train=port_train.TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=30))
    base.update(over)
    return WorkloadConfig(**base)


def test_run_workload_lands_completed_with_goodput():
    store = _store()
    summary = run_workload(_tiny(), store=store, ctx=CTX, lifecycle=LifecycleContext(),
                           telemetry=NullMetrics())
    row = store.read_checkpoint("train", "r-train")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 4}
    goodput = json.loads(row.algorithm_failure_details)["goodput"]
    assert goodput["steps"] == 4 and goodput["tokens"] == 4 * 2 * 32
    assert sum(goodput["buckets_s"].values()) == pytest.approx(goodput["elapsed_s"], abs=1e-5)
    assert goodput["mfu"] == 0.0  # the CPU has no peak: no fabricated MFU
    assert summary["final_step"] == 4 and np.isfinite(summary["loss"])
    assert summary["health_applied"] == 1.0 and summary["device"] == "cpu"


def test_corpus_and_held_out_eval(tmp_path):
    """``data_path`` trains on windows of a ``.npy`` token corpus and, with
    ``eval_every``, evaluates on its held-out tail."""
    from tpu_nexus_torch.workload.data import write_token_npy

    corpus = write_token_npy(str(tmp_path / "corpus.npy"),
                             np.random.default_rng(0).integers(0, 256, 4096).astype(np.int32))
    store = _store()
    summary = run_workload(_tiny(data_path=corpus, eval_every=2, eval_steps=1), store=store, ctx=CTX,
                           lifecycle=LifecycleContext(), telemetry=NullMetrics())
    assert store.read_checkpoint("train", "r-train").lifecycle_stage == LifecycleStage.COMPLETED
    assert np.isfinite(summary["eval_loss"]) and summary["final_step"] == 4
    with pytest.raises(ValueError, match="token-batch"):
        run_workload(_mnist(data_path=corpus), store=_store(), ctx=CTX, lifecycle=LifecycleContext(),
                     telemetry=NullMetrics())


def test_cancelled_lifecycle_lands_preempted():
    lifecycle = LifecycleContext()

    def stream():
        for i, batch in enumerate(get_adapter("tiny").data(2, 32, seed=0)):
            if i == 2:
                lifecycle.cancel("SIGTERM")
            yield batch

    store = _store()
    summary = run_workload(_tiny(steps=10), store=store, ctx=CTX, data=stream(), lifecycle=lifecycle,
                           telemetry=NullMetrics())
    row = store.read_checkpoint("train", "r-train")
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED
    assert row.algorithm_failure_cause == "signal:SIGTERM"
    details = json.loads(row.algorithm_failure_details)
    assert details["reason"] == "SIGTERM" and "goodput" in details
    assert summary["preempted"] and summary["final_step"] == 3


def test_nan_without_checkpoint_fails_classified_as_numeric():
    def poisoned():
        for i, batch in enumerate(get_adapter("mnist").data(8, 16, seed=0)):
            if i == 3:
                batch = dict(batch, x=np.full_like(batch["x"], np.nan))
            yield batch

    store = _store()
    telemetry = RecordingMetrics()
    with pytest.raises(RuntimeError, match="no verified checkpoint") as err:
        run_workload(_mnist(steps=8), store=store, ctx=CTX, data=poisoned(),
                     lifecycle=LifecycleContext(), telemetry=telemetry)
    action = classify_tpu_failure(str(err.value))
    assert action == DecisionAction.TO_FAIL_NUMERIC_NAN
    assert DECISION_STAGE[action] == LifecycleStage.FAILED
    assert telemetry.tagged_counts[("train.anomaly", ("cause:numeric-nan",))] == 1
    row = store.read_checkpoint("train", "r-train")
    # the crash path records the trace ref; the FAILED verdict is the
    # supervisor's, from the raised text classified above
    assert row.lifecycle_stage == LifecycleStage.RUNNING
    assert row.hlo_trace_ref.startswith("file://") and row.hlo_trace_ref.endswith(".hlo")


def test_cuda_out_of_memory_reaches_the_taxonomy_as_hbm_oom(monkeypatch):
    raw = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB "
           "of which 1.05 GiB is free. Of the allocated memory 75.31 GiB is allocated by PyTorch.")
    assert classify_tpu_failure(raw) is None  # why the harness rewords it

    def oom_step(*args, **kwargs):
        def step_fn(state, batch):
            raise torch.OutOfMemoryError(raw)
        return step_fn

    monkeypatch.setattr(port_train, "make_train_step", oom_step)
    with pytest.raises(RuntimeError) as err:
        run_workload(_tiny(), store=_store(), ctx=CTX, lifecycle=LifecycleContext(),
                     telemetry=NullMetrics())
    assert raw in str(err.value)
    assert classify_tpu_failure(str(err.value)) == DecisionAction.TO_FAIL_HBM_OOM
    assert isinstance(err.value.__cause__, torch.OutOfMemoryError)


def test_hang_handler_lands_failed_with_a_classified_cause(monkeypatch):
    store = _store()
    reporter = harness.LedgerReporter(store, CTX)
    telemetry = RecordingMetrics()
    exits = []
    monkeypatch.setattr("os._exit", exits.append)
    handler = harness._make_hang_handler(_tiny(), reporter, CTX, telemetry)
    handler(7, 2.0)
    assert exits == [70]
    row = store.read_checkpoint("train", "r-train")
    assert row.lifecycle_stage == LifecycleStage.FAILED
    assert classify_tpu_failure(row.algorithm_failure_cause) == DecisionAction.TO_FAIL_STEP_HANG
    assert json.loads(row.algorithm_failure_details)["hang_step"] == 7


class _Gauges(NullMetrics):
    def __init__(self):
        self.losses = []

    def gauge(self, name, value, tags=None):
        if name == "train.loss":
            self.losses.append(value)


def test_mnist_preset_trains():
    telemetry = _Gauges()
    train = port_train.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=30)
    summary = run_workload(_mnist(steps=24, heartbeat_every=4, health=HealthConfig(), train=train),
                           store=_store(), ctx=CTX, lifecycle=LifecycleContext(), telemetry=telemetry)
    assert summary["final_step"] == 24 and len(telemetry.losses) == 6
    assert telemetry.losses[-1] < 0.1 * telemetry.losses[0]
    assert summary["accuracy"] > 0.9 and "health_skips" not in summary


@pytest.mark.parametrize(
    "key,value,item",
    [
        ("NEXUS_MESH", "pp=2", "A6b-ii"),
        ("NEXUS_MESH", "fsdp=2,pp=2", "A6b-ii"),
        ("NEXUS_PP_MICROBATCHES", "4", "A6b-ii"),
    ],
)
def test_unported_knobs_raise_at_parse(key, value, item):
    """Pipeline parallelism (ROADMAP.md A6b-ii) raises at parse, naming it."""
    with pytest.raises(NotImplementedError, match=item):
        WorkloadConfig.from_env({key: value})


@pytest.mark.parametrize(
    "env,mesh,sp_attn,rank_map",
    [
        ({}, dict(fsdp=-1), "ring", ""),
        ({"NEXUS_MESH": "fsdp=2,tp=2"}, dict(fsdp=2, tp=2), "ring", ""),
        ({"NEXUS_MESH": "sp=2", "NEXUS_SP_ATTN": "ulysses", "NEXUS_RANK_DEVICE_MAP": "shared"}, dict(fsdp=-1, sp=2),
         "ulysses", "shared"),
    ],
)
def test_mesh_knobs_parse_as_the_reference(env, mesh, sp_attn, rank_map):
    """NEXUS_MESH, NEXUS_SP_ATTN and the rank map parse as the reference's
    harness parses them (default: fsdp over every rank)."""
    from tpu_nexus_torch.parallel.mesh import MeshSpec

    cfg = WorkloadConfig.from_env(env)
    assert (cfg.mesh, cfg.train.sp_attn, cfg.rank_map) == (MeshSpec(**mesh), sp_attn, rank_map)


@pytest.mark.parametrize(
    "key,value,field,want",
    [
        ("NEXUS_CHECKPOINT_EVERY", "2", "checkpoint_every", 2),
        ("NEXUS_CHECKPOINT_DIR", "/ckpt", "checkpoint_dir", "/ckpt"),
        ("NEXUS_FAULT_MODE", "nan-grads", None, None),
    ],
)
def test_checkpoint_and_fault_knobs_parse(key, value, field, want):
    """Tensor checkpoints and training fault injection are ported: their
    knobs parse (the drills themselves run in test_torch_checkpoint_chaos)."""
    cfg = WorkloadConfig.from_env({key: value})
    if field is not None:
        assert getattr(cfg, field) == want
    assert harness.FaultPlan.from_env({key: value}).mode == (value if key == "NEXUS_FAULT_MODE" else None)


def test_env_contract_defaults_and_device():
    cfg = WorkloadConfig.from_env({"NEXUS_MODEL_PRESET": "nexus_1b", "NEXUS_MESH": "fsdp=-1",
                                   "NEXUS_OPTIMIZER": "adafactor", "NEXUS_STEPS": "20"})
    assert cfg.device == "cuda" and cfg.steps == 20 and cfg.train.total_steps == 20
    assert cfg.train.optimizer == "adafactor" and cfg.model.config.remat_policy == "attn_out"
    assert WorkloadConfig.from_env({"NEXUS_DEVICE": "cpu"}).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NEXUS_DEVICE"):
            run_workload(_tiny(device="cuda"), store=_store(), ctx=CTX, lifecycle=LifecycleContext(),
                         telemetry=NullMetrics())
