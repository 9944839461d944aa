"""Fault-isolated KV handoff: the transfer protocol between role-typed pools.

Disaggregated serving (ROADMAP item 4) splits the fused engine
into a PREFILL pool (compute-bound: runs the fused prefill+insert jit) and
a DECODE pool (memory-bound: installs the prefilled KV blocks and decodes)
so one long prefill can never stall every decoding slot's TPOT.  The paged
cache makes this possible — KV blocks are position-independent, addressed
only through the block table — and the COW jit already proved the
mechanics: a handoff is a gather of the request's physical blocks on the
prefill replica plus a scatter into freshly-allocated blocks on the decode
replica (engine.py ``extract_blocks``/``install_blocks``).

This module owns everything about the transfer that can go WRONG, in the
supervise-and-keep-alive discipline of the paper (classify the failure,
act, record the cause):

* :class:`KVHandoffPayload` — the wire unit: per-leaf block arrays plus the
  identity needed to install them, sealed with per-leaf CRCs at extract
  time so in-transit corruption is a detected fault, not silent bad tokens.
* :func:`validate_payload` — per-block shape/dtype/count validation against
  the RECEIVER's cache geometry plus the CRC check; every reject is a
  typed :class:`HandoffError` carrying a machine cause token.
* :class:`HandoffPolicy` — bounded retry with backoff+jitter on TRANSIENT
  transfer faults (:class:`TransferDropped`), the exact
  ``serving/recovery.StepFaultPolicy`` idiom (injectable sleep/rng, audit
  counters, classify-once).  Corruption and peer loss are never retried at
  this layer — they are ROLE decisions, owned by the tables below.
* :data:`HANDOFF_DECISIONS` — what the fleet does about a classified
  handoff fault, TOTAL over ``REPLICA_ROLES`` × ``HANDOFF_FAULT_CAUSES``
  (nxlint NX022, the same keep-the-table-total contract as taxonomy NX001):
  a decode replica dying mid-handoff retries the NEXT decode replica (the
  payload is host-held and survives the peer), a prefill replica dying
  mid-handoff RE-PREFILLS elsewhere (its device blocks died with it), and
  exhaustion degrades the request to FUSED serving on a decode-capable
  replica — never a silent shed.
* :data:`HANDOFF_CAUSE_ACTIONS` — handoff cause token -> supervisor
  ``DecisionAction`` (the ``TO_FAIL_KV_HANDOFF_*`` rows, total under NX001
  with ``SERVING_POD_RECOVERY`` entries), so a handoff fault that escalates
  to the pod level flows through the SAME classify->act->record pipeline
  as every other failure class.

Knobs (``NEXUS_DISAGG_*``, docs/ENVIRONMENT.md): transfer-retry budget,
hop budget, backoff shape — parsed once by :meth:`DisaggConfig.from_env`.

The host form of a payload leaf (the port's one change to this module):
a contiguous CPU ``torch.Tensor`` of the pool's own dtype.  numpy has no
bfloat16, so a bf16 leaf cannot be a numpy array without widening it; the
CRC is taken over the tensor's raw bytes (:func:`leaf_bytes`: for bf16 the
2-byte patterns, the same bytes the JAX package's payload of the same KV
carries), and dtypes compare by name (:func:`dtype_name`), so a mismatch
still names the leaf and the field.
"""

from __future__ import annotations

import os
import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_nexus_torch.core.util import backoff_jitter_s
from tpu_nexus_torch.supervisor.taxonomy import DecisionAction

# -- replica roles -------------------------------------------------------------

#: runs the fused prefill+insert jit, then hands the KV blocks off
ROLE_PREFILL = "prefill"
#: installs handed-off KV blocks and decodes (also the fused-fallback host)
ROLE_DECODE = "decode"
#: the fused topology: one engine does both (no handoff)
ROLE_FUSED = "fused"

#: every role a replica can carry — the row axis of HANDOFF_DECISIONS
REPLICA_ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_FUSED)

# -- handoff fault causes (machine tokens: request.cause / metric tags) --------

#: transient transfer fault: the payload never arrived (dropped in transit)
CAUSE_HANDOFF_DROP = "handoff-drop"
#: the payload arrived but failed shape/dtype/count/CRC validation
CAUSE_HANDOFF_CORRUPT = "handoff-corrupt"
#: the peer replica died mid-handoff (killed, DOWN, or device state lost)
CAUSE_HANDOFF_PEER_LOST = "handoff-peer-lost"
#: transfer-retry and hop budgets both spent — degrade to fused serving
CAUSE_HANDOFF_EXHAUSTED = "handoff-exhausted"

#: every cause a handoff can fail with — the column axis of HANDOFF_DECISIONS
HANDOFF_FAULT_CAUSES = (
    CAUSE_HANDOFF_DROP,
    CAUSE_HANDOFF_CORRUPT,
    CAUSE_HANDOFF_PEER_LOST,
    CAUSE_HANDOFF_EXHAUSTED,
)


class HandoffAction:
    """What the fleet does about a classified handoff fault (the VALUES of
    :data:`HANDOFF_DECISIONS`)."""

    #: re-run the device-to-device transfer to the SAME decode replica
    #: (bounded by ``DisaggConfig.transfer_retries``, backoff+jitter)
    RETRY_TRANSFER = "retry-transfer"
    #: host-held payload survives the peer: install on the NEXT decode
    #: replica (bounded by ``DisaggConfig.max_hops``)
    NEXT_DECODE = "next-decode-replica"
    #: the prefill replica's device blocks died with it — re-run the
    #: prefill on another prefill replica, then hand off again
    RE_PREFILL = "re-prefill"
    #: budgets spent: serve the request END-TO-END (prefill locally) on a
    #: decode-capable replica — degraded, recorded, never shed
    FUSED_FALLBACK = "fused-fallback"


#: faulted-role x cause -> action, TOTAL over REPLICA_ROLES x
#: HANDOFF_FAULT_CAUSES (nxlint NX022).  The row names the replica the
#: fault is ATTRIBUTED to: a drop/corrupt verdict on the receive side is a
#: transfer fact (retry), a dead peer is a role fact (who still holds the
#: bytes decides where the request goes next).  ROLE_FUSED rows are the
#: degenerate identity — a fused replica never hands off, so any handoff
#: cause reaching one is already the fallback path.
HANDOFF_DECISIONS: Dict[str, Dict[str, str]] = {
    ROLE_PREFILL: {
        CAUSE_HANDOFF_DROP: HandoffAction.RETRY_TRANSFER,
        #: a corrupt payload indicts the SENDER's extract — re-prefill
        #: elsewhere rather than re-sending the same bytes
        CAUSE_HANDOFF_CORRUPT: HandoffAction.RE_PREFILL,
        CAUSE_HANDOFF_PEER_LOST: HandoffAction.RE_PREFILL,
        CAUSE_HANDOFF_EXHAUSTED: HandoffAction.FUSED_FALLBACK,
    },
    ROLE_DECODE: {
        CAUSE_HANDOFF_DROP: HandoffAction.RETRY_TRANSFER,
        #: corruption detected installing on THIS decode replica: the
        #: payload bytes are host-held and re-sendable — try the next peer
        CAUSE_HANDOFF_CORRUPT: HandoffAction.NEXT_DECODE,
        CAUSE_HANDOFF_PEER_LOST: HandoffAction.NEXT_DECODE,
        CAUSE_HANDOFF_EXHAUSTED: HandoffAction.FUSED_FALLBACK,
    },
    ROLE_FUSED: {
        CAUSE_HANDOFF_DROP: HandoffAction.FUSED_FALLBACK,
        CAUSE_HANDOFF_CORRUPT: HandoffAction.FUSED_FALLBACK,
        CAUSE_HANDOFF_PEER_LOST: HandoffAction.FUSED_FALLBACK,
        CAUSE_HANDOFF_EXHAUSTED: HandoffAction.FUSED_FALLBACK,
    },
}

#: handoff cause token -> supervisor DecisionAction, TOTAL over
#: HANDOFF_FAULT_CAUSES (nxlint NX022; the actions are total under NX001
#: with SERVING_POD_RECOVERY rows).  Drop and corrupt both classify to the
#: ABORT decision — the k8s-visible fact is "a transfer failed", and the
#: finer cause token rides the ledger details / metric tag.
HANDOFF_CAUSE_ACTIONS: Dict[str, str] = {
    CAUSE_HANDOFF_DROP: DecisionAction.TO_FAIL_KV_HANDOFF_ABORT,
    CAUSE_HANDOFF_CORRUPT: DecisionAction.TO_FAIL_KV_HANDOFF_ABORT,
    CAUSE_HANDOFF_PEER_LOST: DecisionAction.TO_FAIL_KV_HANDOFF_REPLICA_LOST,
    CAUSE_HANDOFF_EXHAUSTED: DecisionAction.TO_FAIL_KV_HANDOFF_EXHAUSTED,
}


def handoff_decision(role: str, cause: str) -> str:
    """Action for a classified handoff fault, total over the table.

    An unmapped (role, cause) pair raises a descriptive error naming the
    fix — never a bare KeyError deep inside the dispatch loop — and nxlint
    NX022 keeps the table total so it never fires in practice."""
    try:
        return HANDOFF_DECISIONS[role][cause]
    except KeyError:
        raise ValueError(
            f"no handoff decision mapped for role {role!r} x cause {cause!r}; "
            "add it to HANDOFF_DECISIONS in tpu_nexus_torch/serving/handoff.py"
        ) from None


def handoff_cause_action(cause: str) -> str:
    """Supervisor DecisionAction for a handoff cause token, total over
    ``HANDOFF_CAUSE_ACTIONS`` (same descriptive-error contract)."""
    try:
        return HANDOFF_CAUSE_ACTIONS[cause]
    except KeyError:
        raise ValueError(
            f"no DecisionAction mapped for handoff cause {cause!r}; add it "
            "to HANDOFF_CAUSE_ACTIONS in tpu_nexus_torch/serving/handoff.py"
        ) from None


# -- typed handoff faults ------------------------------------------------------


class HandoffError(RuntimeError):
    """A classified handoff fault; ``cause`` is the machine token the
    decision tables / metric tags / ledger rows key off."""

    cause: str = CAUSE_HANDOFF_DROP

    def __init__(self, message: str, *, cause: Optional[str] = None) -> None:
        super().__init__(message)
        if cause is not None:
            self.cause = cause


class TransferDropped(HandoffError):
    """The payload never arrived — the one TRANSIENT handoff fault;
    :meth:`HandoffPolicy.run` retries it with backoff."""

    cause = CAUSE_HANDOFF_DROP


class PayloadCorrupt(HandoffError):
    """Shape/dtype/count/CRC validation rejected the payload — never
    retried in place (the same bytes re-validate to the same verdict);
    the role table decides re-prefill vs next-peer."""

    cause = CAUSE_HANDOFF_CORRUPT


class PeerLost(HandoffError):
    """The peer replica died mid-handoff (killed / DOWN / device state
    lost) — the role table decides who inherits the request."""

    cause = CAUSE_HANDOFF_PEER_LOST


class HandoffExhausted(HandoffError):
    """Transfer-retry and hop budgets both spent — the dispatch layer
    degrades the request to fused serving (never sheds it)."""

    cause = CAUSE_HANDOFF_EXHAUSTED


# -- the wire unit -------------------------------------------------------------


@dataclass
class KVHandoffPayload:
    """One request's prefilled KV blocks in transit, plus everything the
    decode side needs to install and continue them.  ``blocks`` maps cache
    leaf name (``k``/``v``, plus ``k_s``/``v_s`` scales under int8-KV) to a
    host array shaped ``[layers, n_blocks, page_size, ...]`` — gathered in
    BLOCK-TABLE order, so block ``i`` holds tokens
    ``[i*page_size, (i+1)*page_size)`` of the prompt.  ``checksums`` are
    per-leaf CRC32s sealed at extract time (:meth:`seal`); the install side
    re-computes them so in-transit corruption is a classified fault."""

    request_id: str
    prompt: Tuple[int, ...]
    first_token: int
    page_size: int
    n_blocks: int
    blocks: Dict[str, Any]
    checksums: Dict[str, int] = field(default_factory=dict)
    #: replica that ran the prefill (trace/ledger attribution)
    source_replica: str = ""
    #: ordered ``"stage:replica:cause"`` hop log — every transfer attempt,
    #: fault, and degradation this payload lived through rides with it so
    #: the landing replica's trace timeline shows the whole journey
    hops: List[str] = field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def seal(self) -> "KVHandoffPayload":
        """Compute per-leaf CRC32s over the block bytes (sender side)."""
        self.checksums = {
            name: leaf_checksum(arr) for name, arr in self.blocks.items()
        }
        return self


def leaf_bytes(arr: Any) -> np.ndarray:
    """A leaf's raw bytes in C order as a flat uint8 numpy array: a view
    of a contiguous leaf's own memory (writing it writes the leaf), else
    of a contiguous copy.  The tensor is reinterpreted, never converted,
    so a bf16 leaf gives its 2-byte patterns."""
    return torch.as_tensor(arr).detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def dtype_name(dtype: Any) -> str:
    """A dtype's name (``bfloat16``, ``float32``, ``int8``)."""
    return str(dtype).removeprefix("torch.")


def leaf_checksum(arr: Any) -> int:
    """CRC32 over a block leaf's bytes — cheap enough to run per handoff,
    strong enough that the chaos drill's single-element corruption can
    never slip through as silently-wrong tokens."""
    return zlib.crc32(leaf_bytes(arr))


def validate_payload(
    payload: KVHandoffPayload,
    *,
    page_size: int,
    leaf_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
) -> None:
    """Receiver-side validation: per-block shape/dtype/count against the
    RECEIVER's cache geometry (``leaf_specs`` maps leaf name ->
    ``((layers, page_size, *trailing), dtype)`` — the per-block slice of
    the receiver's cache), then the sealed CRCs.  Raises
    :class:`PayloadCorrupt` on any mismatch; the message carries the exact
    field so the ledger row explains itself."""
    if payload.page_size != page_size:
        raise PayloadCorrupt(
            f"kv handoff payload for {payload.request_id}: page_size "
            f"{payload.page_size} != receiver page_size {page_size}"
        )
    if payload.n_blocks < 1:
        raise PayloadCorrupt(
            f"kv handoff payload for {payload.request_id}: n_blocks "
            f"{payload.n_blocks} < 1"
        )
    need = -(-payload.prompt_len // page_size)
    if payload.n_blocks != need:
        raise PayloadCorrupt(
            f"kv handoff payload for {payload.request_id}: block count "
            f"{payload.n_blocks} != ceil(prompt_len {payload.prompt_len} / "
            f"page_size {page_size}) = {need}"
        )
    if set(payload.blocks) != set(leaf_specs):
        raise PayloadCorrupt(
            f"kv handoff payload for {payload.request_id}: leaf set "
            f"{sorted(payload.blocks)} != receiver leaf set "
            f"{sorted(leaf_specs)}"
        )
    for name, ((layers, leaf_page, *trailing), dtype) in sorted(leaf_specs.items()):
        arr = payload.blocks[name]
        want = (layers, payload.n_blocks, leaf_page, *trailing)
        got = tuple(arr.shape)
        if got != want:
            raise PayloadCorrupt(
                f"kv handoff payload for {payload.request_id}: leaf {name!r} "
                f"shape {got} != expected {want}"
            )
        if dtype_name(arr.dtype) != dtype_name(dtype):
            raise PayloadCorrupt(
                f"kv handoff payload for {payload.request_id}: leaf {name!r} "
                f"dtype {dtype_name(arr.dtype)} != expected {dtype_name(dtype)}"
            )
    if not payload.checksums:
        raise PayloadCorrupt(
            f"kv handoff payload for {payload.request_id}: unsealed payload "
            "(no checksums) — the sender must seal() before transfer"
        )
    for name in sorted(payload.blocks):
        want_crc = payload.checksums.get(name)
        got_crc = leaf_checksum(payload.blocks[name])
        if want_crc != got_crc:
            sealed = "missing" if want_crc is None else f"{want_crc:#010x}"
            raise PayloadCorrupt(
                f"kv handoff payload for {payload.request_id}: leaf {name!r} "
                f"crc32 {got_crc:#010x} != sealed {sealed}"
            )


# -- bounded transfer retry (the StepFaultPolicy idiom) ------------------------


@dataclass
class HandoffPolicy:
    """Bounded-retry policy for TRANSIENT transfer faults.

    Mirrors ``serving/recovery.StepFaultPolicy``: injectable ``sleep`` and
    ``rng`` so the chaos fuzz drives hundreds of fault scenarios without
    wall-clock waits; audit counters the tests and metrics read.  Only
    :class:`TransferDropped` retries — corruption and peer loss are role
    decisions (:data:`HANDOFF_DECISIONS`), and anything unclassified is an
    engine bug that must re-raise loudly."""

    #: retry attempts for a dropped transfer before the fault escalates to
    #: the hop layer; 0 disables in-place retry entirely
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_max_s: float = 0.25
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=random.Random)
    #: audit counters (chaos tests and the handoff metrics read these)
    retries_used: int = 0
    faults_seen: int = 0

    def backoff_s(self, attempt: int) -> float:
        return backoff_jitter_s(
            attempt, self.backoff_base_s, self.backoff_max_s, self.rng
        )

    def run(self, fn: Callable[[], Any]) -> Any:
        """Call ``fn``; retry :class:`TransferDropped` with backoff up to
        ``max_retries`` times, then re-raise the final drop.  Every other
        :class:`HandoffError` (corrupt, peer-lost) propagates immediately
        — retrying a deterministic verdict just replays it."""
        attempt = 0
        while True:
            try:
                return fn()
            except TransferDropped:
                self.faults_seen += 1
                if attempt >= self.max_retries:
                    raise
                self.sleep(self.backoff_s(attempt))
                attempt += 1
                self.retries_used += 1


# -- env-shaped configuration (docs/ENVIRONMENT.md, NX018 parity) --------------

ENV_DISAGG_TRANSFER_RETRIES = "NEXUS_DISAGG_TRANSFER_RETRIES"
ENV_DISAGG_MAX_HOPS = "NEXUS_DISAGG_MAX_HOPS"
ENV_DISAGG_BACKOFF_BASE_S = "NEXUS_DISAGG_BACKOFF_BASE_S"
ENV_DISAGG_BACKOFF_MAX_S = "NEXUS_DISAGG_BACKOFF_MAX_S"


@dataclass(frozen=True)
class DisaggConfig:
    """Parsed ``NEXUS_DISAGG_*`` knobs — the whole env surface of the
    disaggregated dispatch layer, read once at fleet construction."""

    #: in-place retries per dropped transfer (:class:`HandoffPolicy`)
    transfer_retries: int = 2
    #: decode-replica hops (next-peer attempts) before fused fallback
    max_hops: int = 2
    backoff_base_s: float = 0.01
    backoff_max_s: float = 0.25

    def __post_init__(self) -> None:
        if self.transfer_retries < 0:
            raise ValueError(
                f"transfer_retries must be >= 0, got {self.transfer_retries}"
            )
        if self.max_hops < 0:
            raise ValueError(f"max_hops must be >= 0, got {self.max_hops}")
        if self.backoff_base_s <= 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError(
                "backoff must satisfy 0 < base <= max, got "
                f"base={self.backoff_base_s} max={self.backoff_max_s}"
            )

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "DisaggConfig":
        e = os.environ if env is None else env
        return DisaggConfig(
            transfer_retries=int(e.get(ENV_DISAGG_TRANSFER_RETRIES, "2")),
            max_hops=int(e.get(ENV_DISAGG_MAX_HOPS, "2")),
            backoff_base_s=float(e.get(ENV_DISAGG_BACKOFF_BASE_S, "0.01")),
            backoff_max_s=float(e.get(ENV_DISAGG_BACKOFF_MAX_S, "0.25")),
        )

    def policy(self, *, sleep=time.sleep, rng: Optional[random.Random] = None) -> HandoffPolicy:
        return HandoffPolicy(
            max_retries=self.transfer_retries,
            backoff_base_s=self.backoff_base_s,
            backoff_max_s=self.backoff_max_s,
            sleep=sleep,
            rng=rng if rng is not None else random.Random(),
        )
