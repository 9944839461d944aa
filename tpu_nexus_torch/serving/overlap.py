"""Deferred-dispatch bookkeeping: the host side of overlapped decoding.

The synchronous engine loop sits between every pair of device steps —
schedule, dispatch ONE decode jit, block on the token readback, repeat —
so at small model scale the engine measures host dispatch, not compute
(ROADMAP item 5, bench_serving.py's honest tell).  The overlapped engine
(``ServingEngine(overlap=True)``) never blocks between steps: it
dispatches decode step N+1 while step N's sampled tokens are still in
flight, feeding N's DEVICE outputs straight back as N+1's operands
(token/cursor carries never visit the host), and materializes step N's
results — emissions, stop detection, retirement sweeps — exactly one step
late, inside the engine's ONE sanctioned blocking-readback seam
(``ServingEngine._materialize_one``; nxlint NX014 pins every other
readback out of the dispatch loop).

This module owns the host accounting that makes the deferral auditable:

* :class:`PendingStep` — one dispatched-but-unmaterialized decode scan:
  the re-dispatch thunk (fault retries re-run it bit-identically — the
  jitted scan is a pure function of its captured operands), the device
  result handles, a captured dispatch-time fault, and the host snapshot
  (slot -> request, admission order, cursor base, assumed budgets) the
  materialization later reconciles against.
* :class:`DispatchPipeline` — the pending queue (depth 1 between engine
  steps; 2 transiently inside one step, between dispatching N and
  materializing N-1), the *override* set (slots whose HOST token/cursor
  is authoritative for the next dispatch because admission refilled them
  since the last one), and the per-slot *inflight* budgets (tokens
  covered by unmaterialized dispatches — what keeps a request's total
  emission capped at ``max_new_tokens`` while its tail rides the device).

Scheduling decisions (admission, deadlines, starvation) always act on
MATERIALIZED state — one step conservative, never wrong — and the engine
fences (drains this pipeline) at the drain/quiesce/swap/abandon
boundaries, so a weight swap or a graceful drain can never race an
in-flight step or lose its final tokens.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np


class PipelineError(RuntimeError):
    """Deferred-dispatch accounting went inconsistent — an engine bug
    surfaced loudly (the chaos fuzz calls :meth:`DispatchPipeline
    .verify_consistent` after every step), never silent token loss."""


@dataclass
class PendingStep:
    """One dispatched decode scan awaiting materialization (module doc)."""

    #: re-dispatch closure over the step's CAPTURED operands (device token
    #: carries + host copies) — the fault policy's retry target; a re-run
    #: is token-identical for surviving rows because the jitted scan is a
    #: pure function of its inputs
    thunk: Callable[[], Tuple[Any, Any, Any, Any]]
    #: slot -> Request at dispatch; materialization emits only to slots
    #: still owned by the SAME request (a cancel/deadline retirement
    #: between dispatch and materialize skips its lane)
    snapshot: Dict[int, Any]
    #: snapshot slots in admission order (oldest first) — the fault path's
    #: victim pick is the DISPATCH-time youngest, not whoever was admitted
    #: after the faulted step went out
    order: List[int]
    #: host cursors at dispatch; materialized rows advance from here
    cursor_base: np.ndarray
    #: per-slot emission budget this dispatch assumed (min(remaining, k));
    #: the inflight ledger is credited back at materialization
    assumed: np.ndarray
    #: (tokens [B, k], counts [B], last_token [B], last_pos [B]) DEVICE
    #: arrays — materialization's np.asarray readback is where a deferred
    #: device fault surfaces on async backends
    result: Optional[Tuple[Any, Any, Any, Any]] = None
    #: observability anchors (serving/tracing.py): which engine step
    #: dispatched this scan and when (monotonic clock) — the materialize
    #: span events carry both, which is what makes the one-step-late
    #: deferral VISIBLE on a request timeline instead of inferred from
    #: bench ratios
    step_no: int = 0
    dispatched_at: float = 0.0
    #: dispatch-time fault (sync backends / the chaos wrapper raise at the
    #: call): held here and re-raised through the SAME recovery policy at
    #: materialization — one step late by design, same one-fault-one-
    #: request contract
    error: Optional[BaseException] = None


class DispatchPipeline:
    """Pending-step queue + override/inflight ledgers (module doc)."""

    def __init__(self, num_slots: int) -> None:
        self.num_slots = num_slots
        self._pending: Deque[PendingStep] = deque()
        #: slots whose next-dispatch token/cursor must come from HOST state
        #: (admission wrote them since the last dispatch); cleared per push
        self.overridden: Set[int] = set()
        #: per-slot tokens covered by dispatched-but-unmaterialized steps
        self.inflight = np.zeros(num_slots, np.int64)

    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def latest(self) -> Optional[PendingStep]:
        """The most recent dispatch — its device carries feed the next."""
        return self._pending[-1] if self._pending else None

    @property
    def deferred_slots(self) -> int:
        """Slots with tokens in flight (dispatched, not yet materialized)
        — what the occupancy gauges report distinctly from live slots."""
        return int(np.count_nonzero(self.inflight))

    def override_mask(self) -> np.ndarray:
        """[num_slots] bool: True where the next dispatch takes the HOST
        token/cursor (refilled slots) instead of the device carry."""
        mask = np.zeros(self.num_slots, bool)
        if self.overridden:
            mask[list(self.overridden)] = True
        return mask

    def note_override(self, slot: int) -> None:
        self.overridden.add(slot)

    def note_retired(self, slot: int) -> None:
        """The slot's request retired (any path): nothing of it remains in
        flight for budgeting purposes, and whatever the device still
        carries for the lane is garbage the next admission overrides."""
        self.inflight[slot] = 0
        self.overridden.add(slot)

    def push(self, step: PendingStep) -> None:
        for slot in step.snapshot:
            self.inflight[slot] += int(step.assumed[slot])
        self._pending.append(step)
        # the dispatch consumed every host override; device carries rule
        # again until the next refill
        self.overridden.clear()

    def pop(self) -> PendingStep:
        if not self._pending:
            raise PipelineError("materialize with no pending dispatch")
        return self._pending.popleft()

    def credit(self, step: PendingStep, slot: int) -> None:
        """Return ``step``'s assumed budget for ``slot`` to the ledger
        (its tokens just materialized)."""
        self.inflight[slot] = max(0, self.inflight[slot] - int(step.assumed[slot]))

    def clear(self) -> None:
        """Device state is gone (DeviceStateLost): every pending result
        references dead buffers — drop them all; the next dispatch starts
        from host state wholesale."""
        self._pending.clear()
        self.overridden.clear()
        self.inflight[:] = 0

    def verify_consistent(self) -> None:
        """Audit the ledgers: inflight is non-negative, only slots named
        by some pending snapshot carry inflight budget, and the queue
        never exceeds the depth-1 steady state (2 transiently inside one
        engine step).  O(num_slots + pending); the chaos fuzz runs it
        after every engine step."""
        if len(self._pending) > 2:
            raise PipelineError(
                f"pipeline depth {len(self._pending)} exceeds the "
                "dispatch-ahead bound of 1 (+1 transient)"
            )
        if (self.inflight < 0).any():
            raise PipelineError(f"negative inflight budget: {self.inflight}")
        covered: Set[int] = set()
        for step in self._pending:
            covered.update(step.snapshot)
        stray = {
            int(s) for s in np.nonzero(self.inflight)[0] if int(s) not in covered
        }
        if stray:
            raise PipelineError(
                f"slots {sorted(stray)} carry inflight budget but no "
                "pending dispatch covers them"
            )
