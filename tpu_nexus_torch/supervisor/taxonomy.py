"""Failure classification: the part of ``tpu_nexus/supervisor/taxonomy.py``
the serving engine uses.

A copy, not an import: the port imports nothing of the JAX package.  It
holds the decision constants (:class:`DecisionAction`), the actions a
serving step retries in place (:data:`STEP_RETRYABLE_ACTIONS`) and
:func:`classify_tpu_failure` with its signatures — what
``serving/recovery.py`` and ``serving/handoff.py`` read.  The wordings are
the reference's, so a CUDA out-of-memory error reworded with the HBM-OOM
prefix (``workload/harness.classified_error_text``) classifies as HBM OOM.
The supervisor's event classifier and its tables are not ported.
"""

from __future__ import annotations

import re
from typing import Optional


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


#: the step faults the serving engine retries with backoff.  An ICI link
#: flap mid-decode often heals in milliseconds (the slice stays up; one
#: collective timed out), so the engine retries the
#: step with backoff before declaring anything dead; HBM OOM and compile
#: aborts are deterministic program facts — retrying replays the same fault,
#: so the implicated request retires FAILED instead.  Preemption never
#: arrives as a step RuntimeError (it is a SIGTERM, handled by the drain
#: protocol), so it is deliberately absent.
STEP_RETRYABLE_ACTIONS = frozenset({DecisionAction.TO_FAIL_ICI_LINK_DOWN})


# -- TPU failure signatures ----------------------------------------------------
# Matched (case-insensitive) against event messages and container termination
# messages.  TPU/XLA errors surface messily (SURVEY §7.4 "hard parts"):
# stack traces in logs, exit codes, JobSet conditions, node events.

_COMPILE_ABORT_RE = re.compile(
    r"xla.*(compil|lower)|compil\w+ (error|fail|abort)|INVALID_ARGUMENT.*(hlo|xla)|mosaic.*(error|fail)",
    re.IGNORECASE,
)
_HBM_OOM_RE = re.compile(
    r"hbm.*(oom|exhaust|exceed)|out of mem\w* .*hbm|RESOURCE_EXHAUSTED|"
    r"allocat\w+ .*(hbm|device memory)|OOM.*tpu",
    re.IGNORECASE,
)
_ICI_RE = re.compile(
    r"ici.*(link|fail|down|error)|interconnect.*(fail|down|timeout)|"
    r"chip to chip|DATA_LOSS.*collective|collective.*(timeout|deadlock)",
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
