"""The port's counterpart of ``tests/test_trace_capture.py`` (``tpu_nexus_torch``).

Failure-time trace capture: artifact written, ledger ref recorded, and the
ref rides the error message into the supervisor's extractor (north-star
hlo_trace_ref column end-to-end)."""

import pytest

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.supervisor.taxonomy import classify_tpu_failure, extract_hlo_trace_ref
from tpu_nexus_torch.workload.faults import ENV_FAULT_MODE, ENV_FAULT_STEP
from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload
from tpu_nexus_torch.models import LlamaConfig
from tpu_nexus_torch.workload.train import TrainConfig

CTX = ProcessContext(run_id="trace-run", algorithm="llama", process_id=0, num_processes=1, coordinator=None)


def workload(tmp_path):
    return WorkloadConfig(
        model=LlamaConfig.tiny(),
        train=TrainConfig(warmup_steps=2, total_steps=50),
        batch_size=2,
        seq_len=32,
        steps=6,
        heartbeat_every=2,
        checkpoint_dir=str(tmp_path),
        device="cpu",
    )


def test_failure_writes_trace_and_ledger_ref(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_FAULT_MODE, "xla-abort")
    monkeypatch.setenv(ENV_FAULT_STEP, "3")
    store = InMemoryCheckpointStore()
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=CTX.algorithm, id=CTX.run_id, lifecycle_stage=LifecycleStage.BUFFERED)
    )
    with pytest.raises(RuntimeError, match="hlo_trace: file://") as ei:
        run_workload(workload(tmp_path), store=store, ctx=CTX)
    message = str(ei.value)
    # the ref is extractable from the message exactly as the supervisor would
    ref = extract_hlo_trace_ref(message)
    assert ref.startswith("file://") and ref.endswith(".hlo")
    # the original failure text is preserved for classification
    assert classify_tpu_failure(message) is not None
    # artifact exists and carries context
    path = ref[len("file://"):]
    content = open(path).read()
    assert "trace-run" in content and "step=3" in content and "Mosaic" in content
    # ledger row got the ref without a lifecycle change (supervisor's call)
    cp = store.read_checkpoint(CTX.algorithm, CTX.run_id)
    assert cp.hlo_trace_ref == ref
    assert cp.lifecycle_stage == LifecycleStage.RUNNING


# -- classification precedence + message totality (pure taxonomy units) --------

def test_classify_precedence_on_combined_traces():
    """preempt > ICI > HBM OOM > compile abort: infrastructure causes win
    over program causes when one trace carries several signatures."""
    from tpu_nexus_torch.supervisor.taxonomy import DecisionAction

    preempt = "node shutdown: spot reclaim"
    ici = "ICI link down on chip 3"
    oom = "RESOURCE_EXHAUSTED: HBM OOM while allocating"
    compile_ = "XLA compilation error: Mosaic lowering failed"

    everything = "\n".join([compile_, oom, ici, preempt])
    assert classify_tpu_failure(everything) == DecisionAction.TO_PREEMPT_RESTARTABLE
    assert (
        classify_tpu_failure("\n".join([compile_, oom, ici]))
        == DecisionAction.TO_FAIL_ICI_LINK_DOWN
    )
    assert (
        classify_tpu_failure("\n".join([compile_, oom]))
        == DecisionAction.TO_FAIL_HBM_OOM
    )
    assert classify_tpu_failure(compile_) == DecisionAction.TO_FAIL_COMPILE_ABORT
    assert classify_tpu_failure("") is None
    assert classify_tpu_failure("container exited 1: assertion failed") is None


def test_health_causes_classify_and_do_not_shadow():
    """The training-health signatures (NUMERIC_NAN /
    LOSS_SPIKE / STEP_HANG) rank BELOW every pre-existing signature and,
    symmetrically, none of the pre-existing canonical texts trips a health
    pattern — extend the precedence matrix in both directions."""
    from tpu_nexus_torch.supervisor.taxonomy import (
        MSG_LOSS_SPIKE,
        MSG_NUMERIC_NAN,
        MSG_STEP_HANG,
        DecisionAction,
    )

    nan = "numeric health sentinel: non-finite loss/grad_norm at step 5 (loss=nan)"
    spike = "numeric health sentinel: loss spike at step 7; skip budget exhausted"
    hang = "step-hang: step 5 exceeded its 2s step deadline"
    assert classify_tpu_failure(nan) == DecisionAction.TO_FAIL_NUMERIC_NAN
    assert classify_tpu_failure(spike) == DecisionAction.TO_FAIL_LOSS_SPIKE
    assert classify_tpu_failure(hang) == DecisionAction.TO_FAIL_STEP_HANG
    # the human messages round-trip (k8s event text re-classification)
    assert classify_tpu_failure(MSG_NUMERIC_NAN) == DecisionAction.TO_FAIL_NUMERIC_NAN
    assert classify_tpu_failure(MSG_LOSS_SPIKE) == DecisionAction.TO_FAIL_LOSS_SPIKE
    assert classify_tpu_failure(MSG_STEP_HANG) == DecisionAction.TO_FAIL_STEP_HANG

    # every pre-existing signature WINS over every health signature when
    # both appear in one trace (hardware cause > self-reported symptom)
    preempt = "node shutdown: spot reclaim"
    ici = "ICI link down on chip 3"
    oom = "RESOURCE_EXHAUSTED: HBM OOM while allocating"
    compile_ = "XLA compilation error: Mosaic lowering failed"
    for health_text in (nan, spike, hang):
        assert classify_tpu_failure(f"{health_text}\n{preempt}") == (
            DecisionAction.TO_PREEMPT_RESTARTABLE
        ), health_text
        assert classify_tpu_failure(f"{health_text}\n{ici}") == (
            DecisionAction.TO_FAIL_ICI_LINK_DOWN
        ), health_text
        assert classify_tpu_failure(f"{health_text}\n{oom}") == (
            DecisionAction.TO_FAIL_HBM_OOM
        ), health_text
        assert classify_tpu_failure(f"{health_text}\n{compile_}") == (
            DecisionAction.TO_FAIL_COMPILE_ABORT
        ), health_text
    # and within the health family: hang > nan > spike
    assert classify_tpu_failure(f"{nan}\n{hang}") == DecisionAction.TO_FAIL_STEP_HANG
    assert classify_tpu_failure(f"{spike}\n{nan}") == DecisionAction.TO_FAIL_NUMERIC_NAN

    # symmetric non-shadowing: old canonical texts still classify OLD —
    # none of them matches a health pattern first (they classify the same
    # as before the health signatures existed)
    assert classify_tpu_failure(preempt) == DecisionAction.TO_PREEMPT_RESTARTABLE
    assert classify_tpu_failure(ici) == DecisionAction.TO_FAIL_ICI_LINK_DOWN
    assert classify_tpu_failure(oom) == DecisionAction.TO_FAIL_HBM_OOM
    assert classify_tpu_failure(compile_) == DecisionAction.TO_FAIL_COMPILE_ABORT
    # non-failure text still classifies to nothing
    assert classify_tpu_failure("container exited 1: assertion failed") is None


@pytest.mark.parametrize(
    "text,expected",
    [
        ("dump at gs://bucket/run/module_0001.hlo end", "gs://bucket/run/module_0001.hlo"),
        ("see s3://b/trace.pbtxt for details", "s3://b/trace.pbtxt"),
        ("profiler wrote file:///tmp/t/plugins/profile/run.xplane.pb", "file:///tmp/t/plugins/profile/run.xplane.pb"),
        ("proto at gs://bucket/mod.pb trailing", "gs://bucket/mod.pb"),
        ("no refs in this message", ""),
        ("http://bucket/mod.hlo is not an object-store scheme", ""),
    ],
)
def test_extract_hlo_trace_ref_uris(text, expected):
    assert extract_hlo_trace_ref(text) == expected


def test_tpu_message_total_over_all_decisions():
    """Regression for the `_tpu_message` totality hazard: every decision has
    a reachable human message, and an unknown action raises a descriptive
    error instead of a bare KeyError (nxlint NX001 guards this thereafter)."""
    from tpu_nexus_torch.supervisor.taxonomy import (
        ACTION_MESSAGES,
        DECISION_STAGE,
        DELETES_JOB,
        NON_DELETING_ACTIONS,
        DecisionAction,
        _tpu_message,
    )

    actions = {
        value
        for name, value in vars(DecisionAction).items()
        if name.isupper() and isinstance(value, str)
    }
    assert actions == set(ACTION_MESSAGES)
    assert actions == set(DECISION_STAGE)
    assert actions == (DELETES_JOB | NON_DELETING_ACTIONS)
    assert not (DELETES_JOB & NON_DELETING_ACTIONS)
    for action in actions:
        assert _tpu_message(action) == ACTION_MESSAGES[action]

    with pytest.raises(ValueError, match="ToBrandNew.*ACTION_MESSAGES"):
        _tpu_message("ToBrandNew")


# -- the card's own wordings (the port's additions to the signatures) --------

#: (class, the card's wording): one per added alternative
CARD_WORDINGS = [
    ("oom", "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 96.00 GiB. GPU 0 has a total "
            "capacity of 79.19 GiB of which 62.81 GiB is free."),
    ("oom", "RuntimeError: CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
    ("oom", "cudaErrorMemoryAllocation: out of memory"),
    ("ici", "torch.distributed.DistBackendError: NCCL error in: ProcessGroupNCCL.cpp:1970, unhandled system "
            "error, NCCL version 2.21.5\nncclSystemError: System call (e.g. socket, malloc) or external "
            "library call failed or device error."),
    ("ici", "[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=7, OpType=ALLREDUCE) "
            "ran for 600000 milliseconds before timing out."),
    ("ici", "NCCL communicator was aborted on rank 1"),
    ("ici", "NVLink error: link 3 inactive on GPU 0"),
    ("compile", "RuntimeError: nvcc failed (1): /usr/local/cuda/bin/nvcc -O3 -std=c++17 "
                "-gencode=arch=compute_90a,code=sm_90a -c tpu_nexus_torch/csrc/flash_attention.cu"),
    ("compile", "ptxas fatal   : Unresolved extern function 'nexus_missing'"),
]


def test_card_wordings_keep_the_precedence():
    """Each of the card's wordings reaches the class the taxonomy already
    has for it, and the precedence matrix above holds with them in place of
    the TPU wordings: preempt > interconnect > memory > compile > the
    training-health signatures."""
    from tpu_nexus_torch.supervisor.taxonomy import DecisionAction

    want = {"oom": DecisionAction.TO_FAIL_HBM_OOM, "ici": DecisionAction.TO_FAIL_ICI_LINK_DOWN,
            "compile": DecisionAction.TO_FAIL_COMPILE_ABORT}
    rank = ["ici", "oom", "compile"]
    preempt = "node shutdown: spot reclaim"
    nan = "numeric health sentinel: non-finite loss/grad_norm at step 5 (loss=nan)"
    hang = "step-hang: step 5 exceeded its 2s step deadline"
    for cls, text in CARD_WORDINGS:
        assert classify_tpu_failure(text) == want[cls], text
        assert classify_tpu_failure(f"{text}\n{preempt}") == DecisionAction.TO_PREEMPT_RESTARTABLE, text
        for symptom in (nan, hang):
            assert classify_tpu_failure(f"{symptom}\n{text}") == want[cls], text
        for other_cls, other in CARD_WORDINGS:
            if rank.index(other_cls) > rank.index(cls):
                assert classify_tpu_failure(f"{other}\n{text}") == want[cls], (text, other)


@pytest.mark.parametrize(
    "text",
    [
        "NVRM: Xid (PCI:0000:3b:00): 79, pid=4242, name=python, GPU has fallen off the bus.",
        "NVRM: Xid (PCI:0000:18:00): 48, pid=4242, An uncorrectable double bit error (DBE) has been detected",
        "RuntimeError: CUDA error: uncorrectable ECC error encountered",
        "RuntimeError: CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be "
        "asynchronously reported at some other API call, so the stacktrace below might be incorrect.\n"
        "For debugging consider passing CUDA_LAUNCH_BLOCKING=1\n"
        "Compile with `TORCH_USE_CUDA_DSA` to enable device-side assertions.",
    ],
    ids=["xid79-off-the-bus", "xid48-dbe", "ecc", "illegal-address"],
)
def test_card_hardware_faults_stay_unmatched(text):
    """Xid, uncorrectable ECC and illegal-address errors name no class the
    taxonomy has: they reach the generic fatal verdict, as an unknown error
    does in the reference."""
    assert classify_tpu_failure(text) is None
