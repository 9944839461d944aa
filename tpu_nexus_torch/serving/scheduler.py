"""Iteration-level scheduling: FIFO admission under a prefill-token budget.

The Orca insight (Yu et al., OSDI'22) applied to this engine: scheduling
decisions happen every STEP, not every batch.  Each engine iteration the
scheduler hands over as many queued requests as there are free slots —
bounded by a *prefill-token budget*, because prefill work is ``O(prompt
tokens)`` and runs interleaved with the decode step, so an unbounded
admission wave would stall every in-flight request's next token (TPOT
spike).  Two liveness guards keep FIFO honest:

* **budget floor** — when a slot is free, at least ONE request is admitted
  per step even if its prompt alone exceeds the budget; a budget smaller
  than the longest prompt can therefore never starve the queue head.
* **starvation guard** — when no slot frees for ``evict_after_steps``
  engine iterations while requests wait, the scheduler asks the engine to
  evict the youngest slot (see ``KVSlotManager.eviction_candidate``); 0
  disables eviction (default: queue waits are unbounded but fair).

Admission order is strictly submission order (FIFO) — asserted by the
randomized invariant tests across hundreds of arrival patterns.

Robustness additions: the queue is *bounded* (``max_queue``; the
engine sheds over-capacity submits with a ``serving.shed`` counter instead
of growing without bound under overload) and *deadline-aware*
(``remove_expired`` pulls queued requests whose per-request ``deadline_s``
elapsed before a slot freed — the serving mirror of the reference's
SCHEDULING_TIMEOUT class; the engine retires them ``EVICTED`` with cause
``deadline exceeded``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional

from tpu_nexus_torch.serving.request import Request, RequestState


@dataclass(frozen=True)
class SchedulerConfig:
    #: max prompt tokens prefilled per engine step (beyond the first
    #: admission, which is always allowed — the budget floor)
    prefill_token_budget: int = 512
    #: engine steps the queue head may wait with ZERO free slots before the
    #: engine evicts the youngest running request; 0 = never evict
    evict_after_steps: int = 0
    #: admission backpressure: queued requests beyond this are SHED at
    #: submit (QueueFull + ``serving.shed`` counter) instead of growing the
    #: queue unboundedly under overload; 0 = unbounded (the default — small
    #: deployments prefer waiting over rejecting)
    max_queue: int = 0

    def __post_init__(self) -> None:
        if self.prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget must be >= 1, got {self.prefill_token_budget}"
            )
        if self.evict_after_steps < 0:
            raise ValueError(
                f"evict_after_steps must be >= 0, got {self.evict_after_steps}"
            )
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")


class QueueFull(RuntimeError):
    """Admission shed: the bounded queue is at capacity (or the engine is
    draining).  A TRAFFIC condition, not a bug — the client owns the retry,
    exactly like EVICTED."""


class FifoScheduler:
    """FIFO request queue + per-step admission (see module docstring)."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None) -> None:
        self.cfg = cfg or SchedulerConfig()
        self._queue: Deque[Request] = deque()
        #: request ids in the order they were handed to the engine —
        #: the FIFO-order invariant the randomized tests assert against
        self.admitted_order: List[str] = []

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def full(self) -> bool:
        """Bounded-queue backpressure check (False when unbounded)."""
        return bool(self.cfg.max_queue) and len(self._queue) >= self.cfg.max_queue

    def submit(self, req: Request) -> None:
        if req.state != RequestState.QUEUED:
            raise ValueError(
                f"request {req.request_id} submitted in state {req.state!r}; "
                "only QUEUED requests enter the queue"
            )
        self._queue.append(req)

    def remove_cancelled(self) -> List[Request]:
        """Pull queued requests whose cancel flag is set (the engine
        transitions and retires them)."""
        cancelled = [r for r in self._queue if r.cancel_requested]
        if cancelled:
            self._queue = deque(r for r in self._queue if not r.cancel_requested)
        return cancelled

    def remove_expired(self, now: float) -> List[Request]:
        """Pull queued requests whose deadline elapsed before a slot freed
        (the engine retires them EVICTED, cause ``deadline exceeded``)."""
        expired = [r for r in self._queue if r.past_deadline(now)]
        if expired:
            self._queue = deque(r for r in self._queue if not r.past_deadline(now))
        return expired

    def head(self) -> Optional[Request]:
        """O(1) peek at the queue head (the paged engine's per-step
        starvation probe reads it; ``queued_requests`` would copy the
        whole queue on the decode hot path)."""
        return self._queue[0] if self._queue else None

    def queued_requests(self) -> List[Request]:
        """Snapshot of the queue, FIFO order — diagnostics only (the
        not-drained failure message names who is stuck where)."""
        return list(self._queue)

    def drain_queue(self) -> List[Request]:
        """Pop EVERY queued request (graceful drain: admission has stopped,
        so nothing left in the queue can ever run — the engine sheds them
        EVICTED immediately rather than leaving them non-terminal)."""
        drained = list(self._queue)
        self._queue.clear()
        return drained

    def admit(
        self,
        free_slots: int,
        gate: Optional[Callable[[Request], bool]] = None,
        cost: Optional[Callable[[Request], int]] = None,
    ) -> List[Request]:
        """Pop up to ``free_slots`` requests FIFO, stopping once the
        prefill-token budget is spent — except the first admission, which
        is unconditional (the budget floor).

        ``gate`` is the paged engine's block-availability check:
        admission stops at the first head the gate rejects — strict FIFO,
        no skip-ahead, so a big request can never be starved by small ones
        slipping past it.  The gate is consulted exactly once per POPPED
        request (a True return means the head is admitted in this call),
        so a resource-reserving gate observes every prior admission of the
        same batch.

        ``cost`` prices a head against the budget (default: its full
        prompt length).  The paged engine charges only the NON-SHARED
        prefill tail — the budget bounds actual prefill work interleaved
        per step, and a prefix hit's shared tokens are served by block
        reference, so a long shared prompt must not serialize a fan-out
        burst to one admission per step.  The speculative engine with a
        PREFILLING drafter charges the draft model's full-prompt prefill
        on top (``ServingEngine._spec_cost``) — two forward passes per
        admission is two forward passes of budget.  ``cost`` runs BEFORE
        ``gate`` for each head."""
        admitted: List[Request] = []
        budget = self.cfg.prefill_token_budget
        while self._queue and len(admitted) < free_slots:
            head = self._queue[0]
            head_cost = cost(head) if cost is not None else head.prompt_len
            if admitted and head_cost > budget:
                break
            if gate is not None and not gate(head):
                break
            self._queue.popleft()
            admitted.append(head)
            budget -= head_cost
        self.admitted_order.extend(r.request_id for r in admitted)
        return admitted

    def tick(self) -> None:
        """One engine iteration elapsed with these requests still queued."""
        for req in self._queue:
            req.queued_steps += 1

    def head_starving(self) -> bool:
        """True when the queue head has outwaited the starvation bound and
        the engine should reclaim a slot by eviction."""
        if not self._queue or not self.cfg.evict_after_steps:
            return False
        return self._queue[0].queued_steps >= self.cfg.evict_after_steps
