"""Request lifecycle for the continuous-batching engine.

One :class:`Request` is one user generation: a prompt, a token budget, and
a per-token streaming callback.  Its life is a TOTAL state machine::

    QUEUED ──────► PREFILLING ──────► DECODING ──────► FINISHED
      │ │              │  │              │ │ │
      │ │              │  └─► FINISHED   │ │ └────────► EVICTED
      │ └─────────────────────────────────────────────► EVICTED
      │   (deadline exceeded in queue / drain shed)    (slot overflow /
      │                │                 │ │            starvation guard /
      │                └───► FAILED ◄────┘ │            deadline / drain)
      │     (non-retryable step fault:     │
      │      HBM OOM, XLA compile abort)   │
      └─► CANCELLED ◄──────────────────────┘
           (user-initiated, any active state)

``FAILED`` is the fault-isolation terminal: a non-retryable device fault
(classified through ``supervisor.taxonomy``) retired THIS request while
the engine kept serving the rest of the batch; ``cause`` carries the
classified failure string.  ``EVICTED`` additionally covers deadline
expiry and graceful-drain shedding — ``cause`` distinguishes them.

Totality is load-bearing, not decorative: the engine's retirement dispatch
(``engine.RETIREMENT_ACTIONS``) must cover every terminal state, every
state must declare its legal successors in :data:`TRANSITIONS`, and every
state must sit in exactly one of :data:`TERMINAL_STATES` /
:data:`ACTIVE_STATES` — all enforced statically by nxlint rule NX005 (the
same pattern NX001 applies to the supervisor's decision taxonomy) and
dynamically by :meth:`Request.transition`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional

import numpy as np


class RequestState:
    """Lifecycle constants (DecisionAction-style string class: nxlint NX005
    reads the members and the tables below as plain AST)."""

    QUEUED = "Queued"
    PREFILLING = "Prefilling"
    DECODING = "Decoding"
    FINISHED = "Finished"
    CANCELLED = "Cancelled"
    EVICTED = "Evicted"
    FAILED = "Failed"


#: state -> legal successor states, TOTAL over RequestState (nxlint NX005).
#: PREFILLING -> FINISHED is the one-token request (max_new_tokens == 1:
#: the prefill logits already produced its only output token).
TRANSITIONS: Dict[str, FrozenSet[str]] = {
    RequestState.QUEUED: frozenset(
        # QUEUED -> EVICTED: deadline expired while waiting for a slot, or
        # the queue was shed by a graceful drain (never got device time)
        {RequestState.PREFILLING, RequestState.CANCELLED, RequestState.EVICTED}
    ),
    RequestState.PREFILLING: frozenset(
        {
            RequestState.DECODING,
            RequestState.FINISHED,
            RequestState.CANCELLED,
            RequestState.EVICTED,
            RequestState.FAILED,
        }
    ),
    RequestState.DECODING: frozenset(
        {
            RequestState.FINISHED,
            RequestState.CANCELLED,
            RequestState.EVICTED,
            RequestState.FAILED,
        }
    ),
    RequestState.FINISHED: frozenset(),
    RequestState.CANCELLED: frozenset(),
    RequestState.EVICTED: frozenset(),
    RequestState.FAILED: frozenset(),
}

#: terminal states never transition again and never hold a slot.  Every
#: RequestState member belongs to exactly one of TERMINAL_STATES /
#: ACTIVE_STATES, and terminal <=> empty TRANSITIONS row (nxlint NX005).
TERMINAL_STATES: FrozenSet[str] = frozenset(
    {
        RequestState.FINISHED,
        RequestState.CANCELLED,
        RequestState.EVICTED,
        RequestState.FAILED,
    }
)

ACTIVE_STATES: FrozenSet[str] = frozenset(
    {RequestState.QUEUED, RequestState.PREFILLING, RequestState.DECODING}
)


class IllegalTransition(ValueError):
    """A state change outside :data:`TRANSITIONS` — an engine bug, never a
    traffic condition; raised loudly instead of corrupting slot accounting."""


@dataclass
class Request:
    """One admitted generation and its mutable lifecycle record.

    ``stream`` is the per-token callback ``(request, token) -> None``,
    invoked synchronously from the engine loop as each token lands
    (including the first token from the prefill logits).  Timestamps are
    engine-clock floats; ``first_token_at - submitted_at`` is TTFT,
    consecutive ``emit`` deltas are TPOT samples."""

    request_id: str
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int
    stream: Optional[Callable[["Request", int], None]] = None
    state: str = RequestState.QUEUED
    slot: Optional[int] = None
    output_tokens: List[int] = field(default_factory=list)
    #: per-request latency budget in engine-clock seconds from submit; the
    #: engine retires the request EVICTED with cause "deadline exceeded"
    #: once ``submitted_at + deadline_s`` passes (queued OR decoding) —
    #: the serving mirror of the supervisor's SCHEDULING_TIMEOUT class.
    #: None = no deadline.
    deadline_s: Optional[float] = None
    #: why the request retired, for non-FINISHED terminals: the classified
    #: step-fault string (FAILED), "deadline exceeded" / drain / guard
    #: wording (EVICTED).  Empty for FINISHED and plain user CANCELLED.
    cause: str = ""
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: engine iterations this request has spent waiting in the queue —
    #: the scheduler's starvation-guard counter
    queued_steps: int = 0
    cancel_requested: bool = False
    #: span timeline (serving/tracing.RequestTrace), installed by the
    #: engine's tracer at submit: bounded monotonic-clock events from
    #: submit through the terminal retirement (with cause), riding the
    #: request through the retirement log and the fleet history so an
    #: incident dump can always include the implicated timeline.  None
    #: when tracing is disabled (NullTracer) or the request never went
    #: through ServingEngine.submit.
    trace: Optional[object] = None

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.request_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.request_id}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}"
            )
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"request {self.request_id}: deadline_s must be > 0, "
                f"got {self.deadline_s}"
            )

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        """Cache rows the request needs: prompt + every generated token."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.output_tokens) >= self.max_new_tokens

    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def past_deadline(self, now: float) -> bool:
        """True when a deadline is set and engine time ``now`` has passed
        it.  Terminal requests are never past-deadline — their outcome is
        already decided."""
        if self.deadline_s is None or self.is_terminal():
            return False
        return now >= self.submitted_at + self.deadline_s

    def transition(self, new_state: str) -> None:
        if new_state not in TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"request {self.request_id}: {self.state} -> {new_state} "
                "is not a legal transition"
            )
        self.state = new_state

    def emit(self, token: int, now: float) -> Optional[float]:
        """Record one generated token at engine time ``now``; returns the
        inter-token interval (a TPOT sample) or None for the first token."""
        dt = None if self.last_token_at is None else now - self.last_token_at
        self.output_tokens.append(int(token))
        if self.first_token_at is None:
            self.first_token_at = now
        self.last_token_at = now
        if self.stream is not None:
            self.stream(self, int(token))
        return dt
