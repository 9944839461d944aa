"""Failure classification: event -> decision.  A copy of
``tpu_nexus/supervisor/taxonomy.py`` (the port imports nothing of the JAX
package), with the card's own failure wordings added to the classes that
already name them.

Reproduces the reference's supervision state machine exactly
(services/supervisor.go:159-258; table in SURVEY.md §2.2) and its
accelerator failure classes: interconnect link down, compile abort,
preemption, device-memory OOM — detected from event reasons/messages, pod
container termination states (exit codes 137/255 parity, reference comments
services/supervisor.go:310-313,336-338), and JobSet failure conditions.

The decision constants and human messages keep the JAX package's names and
words (``ToFailHbmOom``, "TPU HBM memory", ...): the ledger, the metrics and
the serving fleet read them.  On an NVIDIA card the same classes are
reached by the card's wordings as well:

  * device-memory OOM: ``CUDA out of memory``, ``torch.OutOfMemoryError``,
    ``CUBLAS_STATUS_ALLOC_FAILED``, ``cudaErrorMemoryAllocation``;
  * interconnect: NCCL errors and timeouts, NVLink errors (a watchdog's
    "collective operation timeout" already matched);
  * compile abort: the port's kernel build error (``nvcc failed (``,
    ``ops/_build.py``) and ``ptxas`` errors.

Xid, uncorrectable-ECC, "fallen off the bus" and "illegal memory access"
errors stay unmatched: they reach the generic fatal verdict, as an unknown
error does in the reference.

Reference-exact behavioral quirks preserved:
  * Pod `Failed` maps to STUCK_IN_PENDING -> SCHEDULING_FAILED, not FAILED
    (services/supervisor.go:234-243, asserted supervisor_test.go:398-401);
  * Job `FailedCreate` -> SCHEDULING_FAILED; `DeadlineExceeded` |
    `BackoffLimitExceeded` -> DEADLINE_EXCEEDED; `PodFailurePolicy` -> FAILED;
  * the three human RunStatusMessage strings are byte-identical to the
    reference's (services/supervisor.go:176,187,198).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

from tpu_nexus_torch.checkpoint.models import JOB_TEMPLATE_NAME_KEY, LifecycleStage
from tpu_nexus_torch.k8s.informer import Informer
from tpu_nexus_torch.k8s.objects import EventObj, JobObj, JobSetObj, PodObj
from tpu_nexus_torch.supervisor.resolvers import get_cached_object


class DecisionAction:
    """Decision constants (reference DecisionAction + 4 constants,
    services/supervisor.go:49-56; TPU classes appended)."""

    TO_RUNNING = "ToRunning"
    TO_FAIL_STUCK_IN_PENDING = "ToFailStuckInPending"
    TO_FAIL_DEADLINE_EXCEEDED = "ToFailDeadlineExceeded"
    TO_FAIL_FATAL_ERROR = "ToFailFatalError"
    # -- TPU-native extensions --
    TO_FAIL_COMPILE_ABORT = "ToFailXlaCompileAbort"
    TO_FAIL_HBM_OOM = "ToFailHbmOom"
    TO_FAIL_ICI_LINK_DOWN = "ToFailIciLinkDown"
    TO_PREEMPT_RESTARTABLE = "ToPreemptRestartable"
    #: emitted by the heartbeat watchdog, not event classification: a RUNNING
    #: run whose ledger progress fingerprint stalled past the stale window
    TO_FAIL_STUCK_IN_RUNNING = "ToFailStuckInRunning"
    #: emitted by the watchdog's PREEMPTED sweep: the restart axis bet that
    #: the JobSet controller would recreate the children, and it never did
    #: (controller down, quota gone, node pool deleted) — without this the
    #: row sits PREEMPTED forever and no k8s event ever fires ("nothing
    #: happened" is not an event).  The reference cannot wedge (every failure
    #: deletes + writes terminal, services/supervisor.go:283-360); this
    #: restores that guarantee for the restart axis.
    TO_FAIL_RESTART_STALLED = "ToFailRestartStalled"
    # -- training-health extensions (workload/health.py): a run
    # that is alive and SICK — the heartbeat watchdog never sees it stop --
    #: non-finite loss/gradients the self-healing policy could not recover
    #: (no verified pre-window checkpoint, or recurrence after rollback)
    TO_FAIL_NUMERIC_NAN = "ToFailNumericNan"
    #: loss/grad spike streak past the skip budget that rollback-and-skip
    #: could not heal — divergence, not transient noise
    TO_FAIL_LOSS_SPIKE = "ToFailLossSpike"
    #: a training step exceeded its wall-clock deadline (wedged collective);
    #: the in-process step-hang watchdog saved what it could and exited
    TO_FAIL_STEP_HANG = "ToFailStepHang"
    # -- disaggregated-serving extensions (serving/handoff.py):
    # faults in the prefill->decode KV block transfer.  The fleet dispatch
    # layer retries/degrades in-process; these decisions are the POD-level
    # verdicts when a handoff fault escalates past the request --
    #: a KV handoff transfer aborted (dropped in transit or rejected by
    #: payload validation) past the in-process retry budget
    TO_FAIL_KV_HANDOFF_ABORT = "ToFailKvHandoffAbort"
    #: a replica died MID-handoff (the peer held half the conversation)
    TO_FAIL_KV_HANDOFF_REPLICA_LOST = "ToFailKvHandoffReplicaLost"
    #: handoff retry + hop budgets spent — requests are degrading to fused
    #: serving; the disaggregated topology itself is unhealthy
    TO_FAIL_KV_HANDOFF_EXHAUSTED = "ToFailKvHandoffExhausted"


#: decision -> resulting lifecycle stage (SURVEY §2.2 classification table +
#: TPU rows; preemption is NON-terminal: restart-from-step, SURVEY §7.4)
DECISION_STAGE: Dict[str, str] = {
    DecisionAction.TO_RUNNING: LifecycleStage.RUNNING,
    DecisionAction.TO_FAIL_STUCK_IN_PENDING: LifecycleStage.SCHEDULING_FAILED,
    DecisionAction.TO_FAIL_DEADLINE_EXCEEDED: LifecycleStage.DEADLINE_EXCEEDED,
    DecisionAction.TO_FAIL_FATAL_ERROR: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_COMPILE_ABORT: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_HBM_OOM: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_ICI_LINK_DOWN: LifecycleStage.FAILED,
    DecisionAction.TO_PREEMPT_RESTARTABLE: LifecycleStage.PREEMPTED,
    DecisionAction.TO_FAIL_STUCK_IN_RUNNING: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_RESTART_STALLED: LifecycleStage.DEADLINE_EXCEEDED,
    DecisionAction.TO_FAIL_NUMERIC_NAN: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_LOSS_SPIKE: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_STEP_HANG: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_KV_HANDOFF_ABORT: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST: LifecycleStage.FAILED,
    DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED: LifecycleStage.FAILED,
}

#: decisions that delete the k8s Job (all reference fail paths delete with
#: background propagation; ToRunning and restartable preemption do not)
DELETES_JOB = frozenset(
    {
        DecisionAction.TO_FAIL_STUCK_IN_PENDING,
        DecisionAction.TO_FAIL_DEADLINE_EXCEEDED,
        DecisionAction.TO_FAIL_FATAL_ERROR,
        DecisionAction.TO_FAIL_COMPILE_ABORT,
        DecisionAction.TO_FAIL_HBM_OOM,
        DecisionAction.TO_FAIL_ICI_LINK_DOWN,
        DecisionAction.TO_FAIL_STUCK_IN_RUNNING,
        DecisionAction.TO_FAIL_RESTART_STALLED,
        DecisionAction.TO_FAIL_NUMERIC_NAN,
        DecisionAction.TO_FAIL_LOSS_SPIKE,
        DecisionAction.TO_FAIL_STEP_HANG,
        DecisionAction.TO_FAIL_KV_HANDOFF_ABORT,
        DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST,
        DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED,
    }
)

# Reference-exact human messages (services/supervisor.go:176,187,198)
MSG_STUCK_IN_PENDING = (
    "Unable to launch a container for the algorithm - please review configuration and try again."
)
MSG_DEADLINE_EXCEEDED = "Algorithm exceeded its max allowed run time limit or retry attempt count."
MSG_FATAL_ERROR = "Algorithm encountered a fatal error during execution."
# TPU-class human messages
MSG_COMPILE_ABORT = "Algorithm failed to compile for TPU (XLA compile abort) - review the program and shapes."
MSG_HBM_OOM = "Algorithm exhausted TPU HBM memory - reduce batch/model size or increase sharding."
MSG_ICI_LINK_DOWN = "TPU interconnect (ICI) link failure - the slice is unhealthy; run cannot continue."
MSG_PREEMPTED = "TPU slice was preempted - run will restart from its last tensor checkpoint."
MSG_STUCK_IN_RUNNING = (
    "Algorithm stopped reporting progress (heartbeat stale) - the run appears hung and was terminated."
)
MSG_RESTART_STALLED = (
    "TPU slice was preempted and the controller never restarted it within the deadline - run terminated."
)
# Training-health messages.  Wordings deliberately avoid the existing
# infrastructure signatures (no "collective", "interconnect", "allocate",
# "compile"...) so a round-trip through k8s event text re-classifies to the
# same decision instead of being shadowed by an older pattern.
MSG_NUMERIC_NAN = (
    "Algorithm produced non-finite loss/gradients (NaN/Inf) and could not self-heal - run terminated."
)
MSG_LOSS_SPIKE = (
    "Algorithm loss/gradients spiked past the health policy's budget (divergence) - run terminated."
)
MSG_STEP_HANG = (
    "A training step exceeded its watchdog deadline - the run appeared wedged mid-step and was terminated."
)
# Disaggregated-serving handoff messages.  Wordings deliberately avoid every
# existing classifier signature (no "collective", "interconnect", "allocate",
# "compile", "preempt", "watchdog"...) so a round-trip through k8s event text
# re-classifies to the same decision instead of being shadowed.
MSG_KV_HANDOFF_ABORT = (
    "KV block handoff transfer was dropped or rejected by payload validation past the retry budget."
)
MSG_KV_HANDOFF_REPLICA_LOST = (
    "A serving replica died mid KV-handoff - the request was re-routed to a surviving peer."
)
MSG_KV_HANDOFF_EXHAUSTED = (
    "KV handoff retry and hop budgets were spent - requests are degrading to fused serving."
)

#: decisions that do NOT delete the k8s Job — the explicit complement of
#: ``DELETES_JOB``.  Every DecisionAction constant must appear in exactly one
#: of the two sets (nxlint NX001); a new decision that declares neither is a
#: latent "supervisor never cleans up / deletes a restartable run" bug.
NON_DELETING_ACTIONS = frozenset(
    {
        DecisionAction.TO_RUNNING,
        DecisionAction.TO_PREEMPT_RESTARTABLE,
    }
)

#: TPU decisions whose *wording* is worth a bounded in-process retry when it
#: surfaces as a step fault inside a LIVE serving engine (serving/recovery.py)
#: — distinct from DECISION_STAGE, which is the whole-run verdict AFTER the
#: workload died.  An ICI link flap mid-decode often heals in milliseconds
#: (the slice stays up; one collective timed out), so the engine retries the
#: step with backoff before declaring anything dead; HBM OOM and compile
#: aborts are deterministic program facts — retrying replays the same fault,
#: so the implicated request retires FAILED instead.  Preemption never
#: arrives as a step RuntimeError (it is a SIGTERM, handled by the drain
#: protocol), so it is deliberately absent.
STEP_RETRYABLE_ACTIONS = frozenset({DecisionAction.TO_FAIL_ICI_LINK_DOWN})


class FleetRecovery:
    """What the serving-fleet controller (serving/fleet.py) does
    about a classified SERVING-pod failure.  A serving pod is a stateless
    replica behind a router — unlike a training run, killing one is not a
    run-terminal event, so the whole-run ``DECISION_STAGE`` verdicts do
    not apply; these do."""

    #: delete/replace the pod and revive its engine replica on the newest
    #: verified weights — the default for infrastructure causes
    RECREATE = "recreate"
    #: recreate, but with the replica's ``NEXUS_KV_BLOCKS`` budget halved:
    #: an HBM OOM in a serving pod is a KV-pool-sizing fact, and replaying
    #: the same pool just replays the OOM
    RECREATE_REDUCED_KV = "recreate-reduced-kv"
    #: record the cause and STOP recreating — deterministic program/config
    #: facts (compile abort, stuck-pending scheduling failures) where a
    #: fresh pod replays the identical failure; an operator owns the fix
    ESCALATE = "escalate"
    #: not a failure (ToRunning) — nothing to recover
    NONE = "none"


#: decision -> serving-fleet recovery, TOTAL over DecisionAction (nxlint
#: NX001, same contract as ACTION_MESSAGES): a serving-pod failure class
#: with no declared recovery is the midnight-KeyError bug class all over
#: again, now inside the fleet controller.  The fleet indexes this dict
#: directly — an unmapped action fails loudly, never silently drops a pod.
SERVING_POD_RECOVERY: Dict[str, str] = {
    DecisionAction.TO_RUNNING: FleetRecovery.NONE,
    #: scheduling/config failure — a recreated pod lands Pending again
    DecisionAction.TO_FAIL_STUCK_IN_PENDING: FleetRecovery.ESCALATE,
    DecisionAction.TO_FAIL_DEADLINE_EXCEEDED: FleetRecovery.ESCALATE,
    #: crash-loop (BackOff / generic fatal): the classic recreate case
    DecisionAction.TO_FAIL_FATAL_ERROR: FleetRecovery.RECREATE,
    #: deterministic program fact — recreating replays the compile
    DecisionAction.TO_FAIL_COMPILE_ABORT: FleetRecovery.ESCALATE,
    #: KV-pool sizing fact — recreate with a smaller NEXUS_KV_BLOCKS
    DecisionAction.TO_FAIL_HBM_OOM: FleetRecovery.RECREATE_REDUCED_KV,
    #: slice-local hardware fault — a replacement pod may land on a
    #: healthy slice
    DecisionAction.TO_FAIL_ICI_LINK_DOWN: FleetRecovery.RECREATE,
    DecisionAction.TO_PREEMPT_RESTARTABLE: FleetRecovery.RECREATE,
    DecisionAction.TO_FAIL_STUCK_IN_RUNNING: FleetRecovery.RECREATE,
    DecisionAction.TO_FAIL_RESTART_STALLED: FleetRecovery.ESCALATE,
    #: training-health causes in a SERVING pod are program/weights facts —
    #: a recreated replica replays the same numerics; an operator owns it
    DecisionAction.TO_FAIL_NUMERIC_NAN: FleetRecovery.ESCALATE,
    DecisionAction.TO_FAIL_LOSS_SPIKE: FleetRecovery.ESCALATE,
    #: a hung step is slice-local wedging — a fresh pod may land healthy
    DecisionAction.TO_FAIL_STEP_HANG: FleetRecovery.RECREATE,
    #: a transfer path that keeps aborting is replica-local (NIC/DMA-class
    #: wedging) — a replacement pod gets a fresh transfer path
    DecisionAction.TO_FAIL_KV_HANDOFF_ABORT: FleetRecovery.RECREATE,
    #: the peer died — the classic recreate case, per role (the fleet
    #: controller recreates into the SAME role pool, serving/fleet.py)
    DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST: FleetRecovery.RECREATE,
    #: budgets spent across multiple peers: a topology/config fact —
    #: recreating one pod replays it; an operator owns the pool shape
    DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED: FleetRecovery.ESCALATE,
}

#: decision -> human run-status message, TOTAL over DecisionAction (nxlint
#: NX001).  TO_RUNNING maps to "" because Running results carry the raw
#: event reason, not a canned message (reference services/supervisor.go:166).
ACTION_MESSAGES: Dict[str, str] = {
    DecisionAction.TO_RUNNING: "",
    DecisionAction.TO_FAIL_STUCK_IN_PENDING: MSG_STUCK_IN_PENDING,
    DecisionAction.TO_FAIL_DEADLINE_EXCEEDED: MSG_DEADLINE_EXCEEDED,
    DecisionAction.TO_FAIL_FATAL_ERROR: MSG_FATAL_ERROR,
    DecisionAction.TO_FAIL_COMPILE_ABORT: MSG_COMPILE_ABORT,
    DecisionAction.TO_FAIL_HBM_OOM: MSG_HBM_OOM,
    DecisionAction.TO_FAIL_ICI_LINK_DOWN: MSG_ICI_LINK_DOWN,
    DecisionAction.TO_PREEMPT_RESTARTABLE: MSG_PREEMPTED,
    DecisionAction.TO_FAIL_STUCK_IN_RUNNING: MSG_STUCK_IN_RUNNING,
    DecisionAction.TO_FAIL_RESTART_STALLED: MSG_RESTART_STALLED,
    DecisionAction.TO_FAIL_NUMERIC_NAN: MSG_NUMERIC_NAN,
    DecisionAction.TO_FAIL_LOSS_SPIKE: MSG_LOSS_SPIKE,
    DecisionAction.TO_FAIL_STEP_HANG: MSG_STEP_HANG,
    DecisionAction.TO_FAIL_KV_HANDOFF_ABORT: MSG_KV_HANDOFF_ABORT,
    DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST: MSG_KV_HANDOFF_REPLICA_LOST,
    DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED: MSG_KV_HANDOFF_EXHAUSTED,
}


@dataclass
class RunStatusAnalysisResult:
    """The actor's work element (reference RunStatusAnalysisResult,
    services/supervisor.go:58-66)."""

    action: str
    algorithm_name: str
    request_id: str
    run_status_message: str
    run_status_trace: str = ""
    object_uid: str = ""
    object_kind: str = ""
    #: name of the involved object (pod name for Pod events) — lets the
    #: executor re-read the freshest cached state at commit time
    object_name: str = ""
    #: TPU extension: object-storage ref for an HLO dump / profiler trace
    #: extracted from the failure context (empty when not applicable)
    hlo_trace_ref: str = ""
    #: monotonic timestamp when the triggering event entered classification;
    #: drives the fault-detect -> checkpoint-commit latency metric
    detected_at: float = 0.0
    #: uid of the pod's owning (child-)Job at classification time — the pod
    #: GENERATION.  JobSet Recreate / Job re-creation mint a fresh uid per
    #: restart, so this fences one preemption incident's multi-host fan-out
    #: across supervisor replicas without any wall clock (ledger column
    #: preempted_generation).  Empty when the owner was not cached.
    generation_uid: str = ""


# -- TPU failure signatures ----------------------------------------------------
# Matched (case-insensitive) against event messages and container termination
# messages.  TPU/XLA errors surface messily (SURVEY §7.4 "hard parts"):
# stack traces in logs, exit codes, JobSet conditions, node events.

# The card's wordings close each pattern (module doc): the port's kernel
# build error and ptxas for the compile class, PyTorch's and the CUDA
# runtime's allocation failures for the memory class, NCCL and NVLink for
# the interconnect class.
_COMPILE_ABORT_RE = re.compile(
    r"xla.*(compil|lower)|compil\w+ (error|fail|abort)|INVALID_ARGUMENT.*(hlo|xla)|mosaic.*(error|fail)|"
    r"nvcc failed \(|ptxas\b.*(error|fatal)",
    re.IGNORECASE,
)
_HBM_OOM_RE = re.compile(
    r"hbm.*(oom|exhaust|exceed)|out of mem\w* .*hbm|RESOURCE_EXHAUSTED|"
    r"allocat\w+ .*(hbm|device memory)|OOM.*tpu|"
    r"CUDA out of memory|OutOfMemoryError|CUBLAS_STATUS_ALLOC_FAILED|cudaErrorMemoryAllocation",
    re.IGNORECASE,
)
_ICI_RE = re.compile(
    r"ici.*(link|fail|down|error)|interconnect.*(fail|down|timeout)|"
    r"chip to chip|DATA_LOSS.*collective|collective.*(timeout|deadlock)|"
    r"nccl.*(error|time[sd]? ?out|abort)|nvlink.*(error|fail|down|inactive|timeout)",
    re.IGNORECASE,
)
_PREEMPT_RE = re.compile(
    r"preempt|spot.*(reclaim|terminat)|node.*shutdown|maintenance event",
    re.IGNORECASE,
)
# Training-health signatures (workload/health.py emits these wordings in
# raised causes / ledger rows / exit messages).  Checked AFTER the four
# infrastructure/program signatures above so they can never shadow an
# existing classification — and phrased (sentinel/step-deadline vocabulary)
# so none of the older regexes matches them either; the precedence tests in
# tests/test_trace_capture.py pin both directions.
_STEP_HANG_RE = re.compile(
    r"step[- ]hang|exceeded its \S+ ?step deadline|training step deadline|"
    r"watchdog deadline",
    re.IGNORECASE,
)
_NUMERIC_NAN_RE = re.compile(
    r"non-?finite (loss|grad|training)|numeric(al)? health sentinel.*non-?finite|"
    r"nan/inf",
    re.IGNORECASE,
)
_LOSS_SPIKE_RE = re.compile(
    r"loss spike|grad(ient)?s? (norm )?spike|spiked past the health",
    re.IGNORECASE,
)
# Disaggregated-serving handoff signatures (serving/handoff.py wordings +
# the MSG_KV_HANDOFF_* round-trips).  Checked LAST so they can never shadow
# an infrastructure or training-health classification — and phrased around
# the "kv handoff" vocabulary none of the older regexes contains.
_KV_HANDOFF_REPLICA_LOST_RE = re.compile(
    r"kv[- ]?handoff.*(replica|peer).*(lost|died|gone|unreachable)|"
    r"(died|lost) mid[- ]kv[- ]handoff|mid[- ]handoff.*(replica|peer).*(lost|died)",
    re.IGNORECASE,
)
_KV_HANDOFF_EXHAUSTED_RE = re.compile(
    r"kv[- ]?handoff.*(budget|hop)s?.*(spent|exhaust)|handoff[- ]exhausted",
    re.IGNORECASE,
)
_KV_HANDOFF_ABORT_RE = re.compile(
    r"kv[- ](block )?handoff.*(drop|reject|corrupt|abort|mismatch|crc)|"
    r"kv handoff payload|handoff[- ](drop|corrupt)",
    re.IGNORECASE,
)

# longest alternatives first: with `pb` before `pbtxt`, a `.pbtxt` ref would
# truncate to `.pb` (the regex never backtracks to the longer suffix)
_HLO_REF_RE = re.compile(r"(?:gs|s3|file)://\S+\.(?:xplane\.pb|pbtxt|pb|hlo)")


def classify_tpu_failure(text: str) -> Optional[str]:
    """Map raw failure text to a TPU decision, or None if not TPU-specific.

    Precedence: preemption (infrastructure, restartable) > ICI (infrastructure,
    terminal) > HBM OOM > compile abort — infrastructure causes win over
    program causes when both appear in one trace.  The training-health
    signatures (step hang > numeric NaN > loss spike) rank BELOW all four:
    they are self-reported by the workload, and when a trace carries both a
    hardware cause and the numerical symptom it produced, the hardware
    cause is the story.
    """
    if not text:
        return None
    if _PREEMPT_RE.search(text):
        return DecisionAction.TO_PREEMPT_RESTARTABLE
    if _ICI_RE.search(text):
        return DecisionAction.TO_FAIL_ICI_LINK_DOWN
    if _HBM_OOM_RE.search(text):
        return DecisionAction.TO_FAIL_HBM_OOM
    if _COMPILE_ABORT_RE.search(text):
        return DecisionAction.TO_FAIL_COMPILE_ABORT
    if _STEP_HANG_RE.search(text):
        return DecisionAction.TO_FAIL_STEP_HANG
    if _NUMERIC_NAN_RE.search(text):
        return DecisionAction.TO_FAIL_NUMERIC_NAN
    if _LOSS_SPIKE_RE.search(text):
        return DecisionAction.TO_FAIL_LOSS_SPIKE
    # handoff signatures rank below everything: they are self-reported by
    # the fleet dispatch layer, and a trace carrying both a hardware cause
    # and the handoff symptom it produced names the hardware cause.
    # Within the class: replica-lost > exhausted > abort (most specific
    # verdict first — an exhaustion trace usually quotes the drops too).
    if _KV_HANDOFF_REPLICA_LOST_RE.search(text):
        return DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST
    if _KV_HANDOFF_EXHAUSTED_RE.search(text):
        return DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED
    if _KV_HANDOFF_ABORT_RE.search(text):
        return DecisionAction.TO_FAIL_KV_HANDOFF_ABORT
    return None


def extract_hlo_trace_ref(text: str) -> str:
    m = _HLO_REF_RE.search(text or "")
    return m.group(0) if m else ""


def _tpu_message(action: str) -> str:
    """Human message for a decision, total over ``ACTION_MESSAGES``.

    An unmapped action used to raise a bare ``KeyError`` deep inside event
    classification; now it raises a descriptive error naming the fix, and
    nxlint NX001 keeps the mapping total so it never fires in practice."""
    try:
        return ACTION_MESSAGES[action]
    except KeyError:
        raise ValueError(
            f"no human run-status message mapped for decision action {action!r}; "
            "add it to ACTION_MESSAGES in tpu_nexus_torch/supervisor/taxonomy.py"
        ) from None


def _pod_termination_text(pod: PodObj) -> str:
    """Concatenated container termination reasons/messages — where TPU
    runtime errors usually surface."""
    parts = []
    for cs in pod.container_statuses:
        if cs.terminated is not None:
            parts.append(f"{cs.terminated.reason}: {cs.terminated.message} (exit {cs.terminated.exit_code})")
        if cs.waiting_reason:
            parts.append(cs.waiting_reason)
    return "\n".join(parts)


def _result(
    action: str,
    algorithm: str,
    request_id: str,
    message: str,
    trace: str,
    uid: str,
    kind: str,
    detected_at: float,
    object_name: str = "",
) -> RunStatusAnalysisResult:
    return RunStatusAnalysisResult(
        action=action,
        algorithm_name=algorithm,
        request_id=request_id,
        run_status_message=message,
        run_status_trace=trace,
        object_uid=uid,
        object_kind=kind,
        object_name=object_name or request_id,
        hlo_trace_ref=extract_hlo_trace_ref(trace),
        detected_at=detected_at,
    )


def classify_event(
    event: EventObj,
    namespace: str,
    informers: Dict[str, Informer],
    detected_at: float = 0.0,
) -> Optional[RunStatusAnalysisResult]:
    """The reference's onEvent switch (services/supervisor.go:159-258),
    with a TPU-signature pass layered in front of the generic mapping for
    failure-ish events.  Returns None for drops/no-ops.

    Results with an empty ``request_id`` are dropped: a run-labeled pod
    missing its ``batch.kubernetes.io/job-name`` backlink would otherwise
    flow downstream and turn the missing-checkpoint delete into a
    collection-URL DELETE.  An empty ``algorithm_name`` alone still flows —
    the checkpoint read misses and the orphaned Job is deleted by name,
    matching the reference's missing-checkpoint path
    (services/supervisor.go:265-273).
    """
    result = _classify_event(event, namespace, informers, detected_at)
    if result is not None and not result.request_id:
        return None
    return result


def _classify_event(
    event: EventObj,
    namespace: str,
    informers: Dict[str, Informer],
    detected_at: float,
) -> Optional[RunStatusAnalysisResult]:
    ref = event.involved_object
    obj_ns = ref.namespace or event.meta.namespace

    if ref.kind == "Job":
        job: Optional[JobObj] = get_cached_object(ref.name, obj_ns, informers.get("Job"))
        if job is None:
            return None  # stale event: job no longer cached (reference :161-164)
        # the k8s Job name IS the request id (reference :160,177-181) — except
        # for JobSet child Jobs (`{run}-workers-0`), where the jobset-name
        # backlink carries the run id; the template label carries the
        # algorithm name, falling back to the owning JobSet's labels
        request_id = job.run_id()
        algorithm = job.meta.labels.get(JOB_TEMPLATE_NAME_KEY, "")
        if not algorithm and job.jobset_name():
            owner = get_cached_object(job.jobset_name(), obj_ns, informers.get("JobSet"))
            if owner is not None:
                algorithm = owner.meta.labels.get(JOB_TEMPLATE_NAME_KEY, "")
        uid, kind = job.meta.uid, "Job"
        if event.reason == "FailedCreate":
            return _result(
                DecisionAction.TO_FAIL_STUCK_IN_PENDING,
                algorithm, request_id, MSG_STUCK_IN_PENDING, event.message, uid, kind, detected_at,
            )
        if event.reason in ("DeadlineExceeded", "BackoffLimitExceeded"):
            return _result(
                DecisionAction.TO_FAIL_DEADLINE_EXCEEDED,
                algorithm, request_id, MSG_DEADLINE_EXCEEDED, event.message, uid, kind, detected_at,
            )
        if event.reason == "PodFailurePolicy":
            # mainly covers exit 137 (OOM) and 255 (unknown fatal),
            # reference comments :310-313,336-338; check for TPU signatures
            # in the event message first
            tpu_action = classify_tpu_failure(event.message)
            if tpu_action is not None:
                return _result(
                    tpu_action, algorithm, request_id, _tpu_message(tpu_action),
                    event.message, uid, kind, detected_at,
                )
            return _result(
                DecisionAction.TO_FAIL_FATAL_ERROR,
                algorithm, request_id, MSG_FATAL_ERROR, event.message, uid, kind, detected_at,
            )
        return None  # anything else ignored (reference :205-206)

    if ref.kind == "JobSet":
        # TPU-native extension: multi-host runs are JobSets; failure
        # conditions carry aggregated child-job failure reasons
        jobset: Optional[JobSetObj] = get_cached_object(ref.name, obj_ns, informers.get("JobSet"))
        if jobset is None:
            return None
        request_id = jobset.meta.name
        algorithm = jobset.meta.labels.get(JOB_TEMPLATE_NAME_KEY, "")
        uid, kind = jobset.meta.uid, "JobSet"
        text = event.message or "\n".join(c.message for c in jobset.conditions)
        tpu_action = classify_tpu_failure(f"{event.reason}\n{text}")
        if tpu_action is not None:
            return _result(
                tpu_action, algorithm, request_id, _tpu_message(tpu_action),
                text, uid, kind, detected_at,
            )
        if event.reason in ("FailedCreate", "SuspendedJobs"):
            return _result(
                DecisionAction.TO_FAIL_STUCK_IN_PENDING,
                algorithm, request_id, MSG_STUCK_IN_PENDING, text, uid, kind, detected_at,
            )
        if event.reason in ("DeadlineExceeded", "FailedJobs"):
            action = (
                DecisionAction.TO_FAIL_DEADLINE_EXCEEDED
                if event.reason == "DeadlineExceeded"
                else DecisionAction.TO_FAIL_FATAL_ERROR
            )
            msg = MSG_DEADLINE_EXCEEDED if event.reason == "DeadlineExceeded" else MSG_FATAL_ERROR
            return _result(action, algorithm, request_id, msg, text, uid, kind, detected_at)
        if event.reason == "Started":
            return _result(
                DecisionAction.TO_RUNNING, algorithm, request_id, event.reason, text, uid, kind, detected_at,
            )
        return None

    if ref.kind == "Pod":
        pod: Optional[PodObj] = get_cached_object(ref.name, obj_ns, informers.get("Pod"))
        if pod is None:
            return None  # stale (reference :218-221)
        # pod -> run id: jobset-name backlink first (multi-host runs — the
        # child Job `{run}-workers-0` has no ledger row), then the
        # reference's job-name backlink (:231,241,251)
        request_id = pod.run_id()
        owner = None
        if pod.jobset_name():
            owner = get_cached_object(pod.jobset_name(), obj_ns, informers.get("JobSet"))
        if owner is None and pod.job_name():
            owner = get_cached_object(pod.job_name(), obj_ns, informers.get("Job"))
        algorithm = (
            owner.meta.labels.get(JOB_TEMPLATE_NAME_KEY, "") if owner is not None else ""
        ) or pod.meta.labels.get(JOB_TEMPLATE_NAME_KEY, "")
        uid, kind = pod.meta.uid, "Pod"
        if event.reason == "Started":
            return _result(
                DecisionAction.TO_RUNNING, algorithm, request_id, event.reason,
                event.message, uid, kind, detected_at, pod.meta.name,
            )
        if event.reason in ("Failed", "BackOff"):
            # TPU signature pass over event message + container termination text
            text = f"{event.message}\n{_pod_termination_text(pod)}".strip()
            tpu_action = classify_tpu_failure(text)
            if tpu_action is not None:
                return _result(
                    tpu_action, algorithm, request_id, _tpu_message(tpu_action),
                    text, uid, kind, detected_at, pod.meta.name,
                )
            if event.reason == "Failed":
                # quirk preserved: Pod Failed -> STUCK_IN_PENDING ->
                # SCHEDULING_FAILED, not FAILED (reference :234-243)
                return _result(
                    DecisionAction.TO_FAIL_STUCK_IN_PENDING,
                    algorithm, request_id, event.reason, text, uid, kind, detected_at, pod.meta.name,
                )
            return _result(
                DecisionAction.TO_FAIL_FATAL_ERROR,
                algorithm, request_id, event.reason, text, uid, kind, detected_at, pod.meta.name,
            )
        if event.reason in ("TPUPreempted", "Preempted", "Evicted"):
            text = f"{event.message}\n{_pod_termination_text(pod)}".strip()
            res = _result(
                DecisionAction.TO_PREEMPT_RESTARTABLE,
                algorithm, request_id, MSG_PREEMPTED, text, uid, kind, detected_at, pod.meta.name,
            )
            # incident identity: the owning (child-)Job's uid — every JobSet
            # restart / Job re-creation mints a new one.  The pod's own
            # ownerReferences carry that uid even when the Job informer cache
            # is cold (supervisor just restarted mid-incident), with the
            # cached Job as the cross-check and the pod's own uid as the last
            # resort (still wall-clock-free; fences at least the same pod's
            # event delivered to multiple replicas)
            res.generation_uid = pod.owner_job_uid()
            if not res.generation_uid:
                owning_job = (
                    get_cached_object(pod.job_name(), obj_ns, informers.get("Job"))
                    if pod.job_name()
                    else None
                )
                if owning_job is not None:
                    res.generation_uid = owning_job.meta.uid
            if not res.generation_uid:
                res.generation_uid = pod.meta.uid
            return res
        return None  # logged no-op upstream (reference :254-257)

    return None
