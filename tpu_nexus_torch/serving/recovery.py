"""Step-fault recovery: classify, retry-or-retire, keep the batch alive.

The supervisor's whole job is setting honest terminal states for runs that
die in ways the workload cannot report (SURVEY §1) — but a fault inside
``ModelExecutor.begin``/``step`` used to unwind the entire engine, which is
the one failure mode worse than any single classification: every in-flight
request stranded with no terminal state and no cause.  This module is the
engine-side mirror of ``supervisor.taxonomy``: the SAME signature regexes
classify the raised text, and the classification decides the recovery:

* **transient** (``taxonomy.STEP_RETRYABLE_ACTIONS`` — ICI link wording):
  bounded retry with exponential backoff + decorrelated jitter.  The jitted
  step is a pure function of ``(params, cache, tokens, cursors)``, so a
  retry that succeeds produces exactly the tokens the faulted attempt would
  have — retries are invisible to every request (asserted by the chaos
  fuzz's token-parity invariant).
* **request-fatal** (HBM OOM, XLA compile abort): deterministic program
  facts; retrying replays the fault.  The engine retires the implicated
  request as ``FAILED`` with the classified cause and keeps serving the
  rest of the batch (vLLM-style per-request failure isolation).
* **unclassified**: re-raised.  An unknown ``RuntimeError`` is an engine
  bug, not a traffic condition — swallowing it would trade a loud crash
  (which the supervisor classifies from the k8s event) for silent
  corruption.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from tpu_nexus_torch.core.util import backoff_jitter_s
from tpu_nexus_torch.supervisor.taxonomy import (
    DecisionAction,
    STEP_RETRYABLE_ACTIONS,
    classify_tpu_failure,
)

#: decision -> short machine cause token recorded on the retired request /
#: the ledger / the ``serving.step_faults`` metric tag.  Only the actions a
#: step RuntimeError can classify to (preemption is a SIGTERM, not a raise).
STEP_FAULT_CAUSES = {
    DecisionAction.TO_FAIL_HBM_OOM: "hbm-oom",
    DecisionAction.TO_FAIL_COMPILE_ABORT: "xla-compile-abort",
    DecisionAction.TO_FAIL_ICI_LINK_DOWN: "ici-link-failure",
}


class StepFault(RuntimeError):
    """A classified, non-recoverable device fault: transient retries were
    exhausted or the cause was never retryable.  Carries what the engine
    needs to retire the implicated request honestly."""

    def __init__(self, cause: str, retries: int, original: BaseException) -> None:
        super().__init__(
            f"step fault [{cause}] after {retries} retries: {original}"
        )
        self.cause = cause
        self.retries = retries
        self.original = original


class DeviceStateLost(Exception):
    """A fault invalidated the executor's device state itself — on TPU the
    cache buffer is DONATED to the jitted step (engine.py), so an error
    raised mid-execution leaves ``self.cache`` consumed and every
    re-dispatch would die on "Array has been deleted".  Deliberately NOT a
    RuntimeError: :meth:`StepFaultPolicy.run` must never retry it (the
    transient wording may still be present in ``original``, but the state
    it would retry against is gone).  The engine's response is batch-wide:
    every in-flight request retires FAILED with the classified cause, the
    executor reinitializes a fresh cache, and serving continues for new
    admissions."""

    def __init__(self, original: BaseException) -> None:
        super().__init__(f"device state lost: {original}")
        self.original = original


@dataclass
class StepFaultPolicy:
    """Bounded-retry policy for transient step faults.

    ``sleep`` and ``rng`` are injectable so tests drive hundreds of fault
    scenarios without wall-clock waits; production defaults are real.
    """

    #: retry attempts for a TRANSIENT cause before giving up (non-retryable
    #: causes never retry); 0 disables retry entirely
    max_retries: int = 3
    #: first backoff in seconds; attempt ``n`` waits up to ``base * 2**n``
    backoff_base_s: float = 0.05
    #: ceiling on any single backoff
    backoff_max_s: float = 2.0
    sleep: Callable[[float], None] = time.sleep
    #: OS-entropy seeded by default — fleet-decorrelated jitter is the
    #: point; tests inject a seeded Random for reproducibility (backoff
    #: timing never affects token outputs, so engine replay stays exact)
    rng: random.Random = field(default_factory=random.Random)
    #: audit counters (the chaos tests and metrics read these)
    retries_used: int = 0
    faults_seen: int = 0

    def classify(self, exc: BaseException) -> Optional[str]:
        """Short cause token for a step exception, or None when the text
        matches no TPU failure signature (caller re-raises)."""
        action = classify_tpu_failure(str(exc))
        return STEP_FAULT_CAUSES.get(action) if action else None

    def backoff_s(self, attempt: int) -> float:
        """Jittered backoff for retry ``attempt`` (0-based) — the shared
        ``core.util.backoff_jitter_s`` shape, decorrelated across engine
        replicas."""
        return backoff_jitter_s(
            attempt, self.backoff_base_s, self.backoff_max_s, self.rng
        )

    def run(self, fn: Callable[[], "object"]) -> "object":
        """Call ``fn``; on RuntimeError classify ONCE and either retry
        (transient, bounded, backoff+jitter), raise :class:`StepFault`
        (classified but unrecoverable), or re-raise (unclassified)."""
        attempt = 0
        while True:
            try:
                return fn()
            except RuntimeError as exc:
                action = classify_tpu_failure(str(exc))
                cause = STEP_FAULT_CAUSES.get(action) if action else None
                if cause is None:
                    raise
                self.faults_seen += 1
                if action in STEP_RETRYABLE_ACTIONS and attempt < self.max_retries:
                    self.sleep(self.backoff_s(attempt))
                    attempt += 1
                    self.retries_used += 1
                    continue
                raise StepFault(cause, attempt, exc) from exc
