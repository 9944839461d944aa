"""The serving fleet: engine replicas behind a router, disaggregated
prefill/decode with the KV handoff, and zero-drop rolling weight updates.
The port of ``tpu_nexus/serving/fleet.py``, its imports changed, with
the Kubernetes reconciler that recreates and scales the replicas.

* :class:`ServingFleet` — the host-side replica set: N
  :class:`~tpu_nexus_torch.serving.engine.ServingEngine` replicas behind
  :class:`~tpu_nexus_torch.serving.router.FleetRouter` (prefix affinity,
  least-loaded admission, shed-and-retry elsewhere).  A replica mid-reload
  or down simply stops taking traffic; the others absorb it, which is what
  makes a fleet-wide rollout zero-drop.
* **Disaggregated serving** — role-typed replicas (serving/handoff.py):
  PREFILL replicas prefill and hand their KV blocks, sealed, through the
  host to DECODE replicas; transfer faults retry, hop or degrade to fused
  serving by the handoff decision tables, never drop.
* **Rolling updates** — :meth:`ServingFleet.start_rollout` walks replicas
  ONE AT A TIME through the engine's reload seam: pause admission →
  quiesce in-flight requests on the OLD weights (grace-bounded; stragglers
  evict with an honest cause) → swap params → resume.  The weights come
  from ``restore_params`` on a VERIFIED checkpoint step, so a torn or
  rotten candidate can never be served.
* :class:`CheckpointWatcher` — polls
  :class:`~tpu_nexus_torch.workload.durability.VerifiedStepPoller`
  (commit-marker presence is the trust anchor; a save without its
  manifest is invisible here) and offers the newest verified step to its
  caller: a rollout, or the serve-engine loop's hot reload
  (``NEXUS_RELOAD_CHECK_S``).

* :class:`FleetSupervisor` — the control loop: watches the serving
  JobSet's pods/events through the SAME informer layer as the run
  supervisor, classifies failures with the SAME taxonomy
  (``supervisor.taxonomy.classify_event``), and executes the
  serving-specific consequences (``SERVING_POD_RECOVERY``, total over
  ``DecisionAction``): crash-loop → recreate, HBM OOM → recreate with a
  halved ``NEXUS_KV_BLOCKS`` budget, stuck-pending/compile-abort →
  escalate to an operator.  A missing-pod sweep
  (:class:`~tpu_nexus_torch.supervisor.watchdog.StalenessTracker`, the
  same absence-driven discipline as the ledger watchdog) recreates killed
  pods that never produced a classifiable event — a killed serving pod is
  recreated, never silently lost — and every incident lands an honest
  cause in the ledger row.  It also grades the fleet against its SLO
  targets and scales it between ``AutoscaleConfig``'s bounds.

Division of labor with the run supervisor (``supervisor/service.py``): a
serving fleet's JobSet carries ``NEXUS_COMPONENT_LABEL:
JOB_LABEL_SERVING_FLEET``, the run supervisor delegates those events here
(``events_delegated``), and this controller never touches algorithm-run
resources — one pod, one owner.

Replicas of one process share one device and one stream.  Serving never
writes weights, so replicas may share one params tree; a rollout gives
each replica the tree its source restores.
"""

from __future__ import annotations

import copy
import itertools
import json
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tpu_nexus_torch.serving.engine import CAUSE_RELOAD_GRACE, ServingEngine
from tpu_nexus_torch.serving.handoff import (
    CAUSE_HANDOFF_EXHAUSTED,
    CAUSE_HANDOFF_PEER_LOST,
    ROLE_DECODE,
    ROLE_FUSED,
    ROLE_PREFILL,
    DisaggConfig,
    HandoffAction,
    HandoffError,
    PeerLost,
    handoff_cause_action,
    handoff_decision,
)
from tpu_nexus_torch.serving.loadstats import (
    FleetSnapshot,
    LoadSnapshot,
    SloMonitor,
    emit_fleet_snapshot,
)
from tpu_nexus_torch.serving.recovery import DeviceStateLost, StepFault
from tpu_nexus_torch.serving.request import Request
from tpu_nexus_torch.serving.router import (
    ROUTER_PRESSURE,
    SCALE_DECISIONS,
    SCALE_DOWN_WHEN_IDLE,
    SCALE_UP,
    AutoscaleConfig,
    FleetRouter,
)
from tpu_nexus_torch.serving.scheduler import QueueFull
from tpu_nexus_torch.serving.tracing import EV_DISAGG_FALLBACK, EV_HANDOFF_HOP
from tpu_nexus_torch.workload.durability import CheckpointError, VerifiedStepPoller

logger = logging.getLogger(__name__)

#: replica lifecycle (small and flat on purpose — a replica is stateless
#: compute behind a router, not a run with a ledger row)
REPLICA_SERVING = "serving"
REPLICA_RELOADING = "reloading"
REPLICA_DOWN = "down"

#: ``Request.cause`` prefix for requests that died WITH their replica (pod
#: killed / escalated away): the taxonomy action that took the pod down is
#: appended, so per-request accounting names the same cause the ledger does
CAUSE_REPLICA_LOST = "replica-lost"

#: the watchdog sweep's trace wording (tests match it)
MSG_POD_MISSING = "serving pod missing from cluster (watchdog sweep)"


class FleetError(RuntimeError):
    """Fleet-level misuse (unknown replica, conflicting rollout) — a
    controller bug, never a traffic condition."""


@dataclass
class EngineReplica:
    """One serving replica: an engine bound to a pod name.  ``history``
    accumulates retired requests across engine incarnations (a recreated
    pod gets a fresh engine, but the old one's per-request causes must
    stay auditable — 'never silently lost' includes the accounting).
    Bounded by ``history_limit``, trimmed from the FRONT (same discipline
    as the engine's own ``retired_log_limit``): a replica stuck in a
    recreate cycle must not leak memory linearly with incidents."""

    name: str
    engine: ServingEngine
    deployed_step: Optional[int] = None
    state: str = REPLICA_SERVING
    #: disaggregation role (serving/handoff.py): ``prefill``
    #: replicas run the fused prefill+insert jit and hand their KV blocks
    #: off; ``decode`` replicas install handed-off blocks and decode;
    #: ``fused`` (the default) is the pre-disaggregation engine serving
    #: both phases — and the degradation target when handoff exhausts
    role: str = ROLE_FUSED
    down_cause: str = ""
    history: List[Request] = field(default_factory=list)
    history_limit: int = 10_000
    #: the flight-recorder artifact the dying engine dumped at its
    #: replica-lost seam (path/reason/causes; None when tracing is off) —
    #: survives the engine swap so the recreate incident record can point
    #: the ledger at the drill-down
    last_incident_dump: Optional[Dict[str, Any]] = None

    def fold_history(self) -> None:
        """Fold the current engine's retirement log into ``history`` (the
        engine is about to be replaced), bounded."""
        self.history.extend(self.engine.retired)
        if len(self.history) > self.history_limit:
            del self.history[: len(self.history) - self.history_limit]

    def all_retired(self) -> List[Request]:
        return [*self.history, *self.engine.retired]


@dataclass
class _Rollout:
    """One in-flight rolling update: walk ``order`` one replica at a time.
    ``params`` is loaded lazily on the FIRST swap (one verified restore
    serves the whole fleet) and cached for the remaining replicas.

    Sharded replicas (serving/sharded.py) take ``ref`` instead: the
    verified step's ``params_ref`` (its directory and step), from which
    each rank of each replica reads only its own slice — the fleet's
    process never holds a sharded replica's weights whole."""

    source: Any  # TensorCheckpointer-shaped: restore_params(step), params_ref(step)
    step: int
    grace_s: float
    transform: Optional[Callable[[Any], Any]] = None
    order: List[str] = field(default_factory=list)
    idx: int = 0
    params: Any = None
    ref: Any = None
    loaded: bool = False
    deadline: Optional[float] = None


def _sharded(engine: Any) -> bool:
    return bool(getattr(engine.executor, "swaps_from_checkpoint", False))


class CheckpointWatcher:
    """Interval-gated newest-verified-step watcher over one checkpoint
    directory.  Commit-marker presence is the trust anchor
    (:class:`~tpu_nexus_torch.workload.durability.VerifiedStepPoller`): a
    torn save has no manifest and simply does not exist to this watcher,
    so it can never be offered for a swap.  ``quarantine=True``
    additionally renames steps that fail verification to ``<step>.corrupt``
    — only for deployments where the fleet owns the directory; the default
    keeps the read-only contract (training owns mutation)."""

    def __init__(
        self,
        directory: str,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        quarantine: bool = False,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"watcher interval_s must be > 0, got {interval_s}")
        self.poller = VerifiedStepPoller(directory, quarantine=quarantine)
        self.interval_s = interval_s
        self._clock = clock
        self._next = 0.0  # first check is immediate

    def check(self, now: Optional[float] = None) -> Optional[int]:
        """The newest VERIFIED step, at most once per interval (None
        between checks or when nothing verifies)."""
        now = self._clock() if now is None else now
        if now < self._next:
            return None
        self._next = now + self.interval_s
        return self.poller.latest_verified_step()


class ServingFleet:
    """N engine replicas behind a round-robin router, plus the rolling-
    update state machine.  Pure host-side and clock-injectable: the chaos
    drills run hundreds of scenarios without a device or a wall clock.

    Traffic: :meth:`submit` delegates to :class:`FleetRouter`
    (serving/router.py) — pressure/affinity-ranked candidates with
    shed-and-retry-elsewhere; a per-replica ``QueueFull`` (or a replica
    dying between snapshot and submit) is a recorded hop, never a drop,
    and only fleet-wide exhaustion sheds.  ``policy="round-robin"``
    keeps the plain rotation as the bench baseline.
    Progress: :meth:`tick` pumps every live engine one step and advances
    the rollout state machine."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        policy: str = ROUTER_PRESSURE,
        metrics: Optional[Any] = None,
        disagg: Optional[DisaggConfig] = None,
        handoff_sleep: Callable[[float], None] = time.sleep,
        handoff_rng: Optional[Any] = None,
    ) -> None:
        from tpu_nexus_torch.core.telemetry import NullMetrics

        self.replicas: Dict[str, EngineReplica] = {}
        self._clock = clock
        self.router = FleetRouter(self, policy=policy, metrics=metrics)
        self._counter = itertools.count()
        self._metrics = metrics or NullMetrics()
        #: disaggregated prefill/decode serving: the transfer
        #: retry/hop budgets.  Always present — a fleet with no role-typed
        #: replicas simply never reaches the disagg path
        self.disagg = disagg if disagg is not None else DisaggConfig()
        #: injectable sleep/rng so chaos drills pay no wall-clock backoff
        self._handoff_sleep = handoff_sleep
        self._handoff_rng = handoff_rng
        #: every handoff hop/degradation, bounded front-trimmed (the
        #: replica-history discipline): {request_id, stage, replica,
        #: cause, action} — the fleet-side handoff ledger the drills audit
        self.handoff_log: List[Dict[str, Any]] = []
        self._handoff_log_limit = 10_000
        self.handoffs_completed = 0
        self.disagg_fallbacks = 0
        #: retirement logs of replicas REMOVED from the fleet (autoscale
        #: scale-down): ``all_retired`` must stay total over every request
        #: the fleet ever accepted, bounded like a replica's own history
        self._graveyard: List[Request] = []
        self._graveyard_limit = 10_000
        self._rollout: Optional[_Rollout] = None
        #: (step, error) of the last ABORTED rollout — the candidate failed
        #: its load-time deep verification (rotted between poll and load)
        self.rollout_error: Optional[Tuple[int, str]] = None
        self.rollouts_completed = 0
        self.submitted = 0

    # -- membership ------------------------------------------------------------

    def add_replica(
        self,
        name: str,
        engine: ServingEngine,
        step: Optional[int] = None,
        role: str = ROLE_FUSED,
    ) -> EngineReplica:
        if name in self.replicas:
            raise FleetError(f"duplicate replica {name!r}")
        if role not in (ROLE_PREFILL, ROLE_DECODE, ROLE_FUSED):
            raise FleetError(f"unknown replica role {role!r} for {name!r}")
        rep = EngineReplica(name=name, engine=engine, deployed_step=step, role=role)
        self.replicas[name] = rep
        return rep

    def kill_replica(self, name: str, cause: str) -> int:
        """The replica's pod/process is gone: account every live request
        (decoding → FAILED, queued → EVICTED, all carrying ``cause``) and
        stop routing to it.  Returns how many requests were accounted;
        idempotent (a second kill of a down replica is 0)."""
        rep = self.replicas.get(name)
        if rep is None:
            raise FleetError(f"unknown replica {name!r}")
        if rep.state == REPLICA_DOWN:
            return 0
        # abandon() dumps the flight recorder at the replica-lost seam;
        # keep the artifact pointer past the engine swap for the incident
        # record the controller writes into the ledger — but ONLY if the
        # dump actually landed (same dict identity = no new artifact:
        # budget spent or unwritable dir).  A stale earlier step-fault
        # artifact must not be passed off as THIS incident's drill-down.
        before = getattr(rep.engine, "last_incident_dump", None)
        n = rep.engine.abandon(cause)
        after = getattr(rep.engine, "last_incident_dump", None)
        rep.last_incident_dump = after if after is not before else None
        rep.state = REPLICA_DOWN
        rep.down_cause = cause
        logger.warning(
            "replica %s down (%s): %d live request(s) accounted", name, cause, n
        )
        return n

    def revive_replica(
        self, name: str, engine: ServingEngine, step: Optional[int]
    ) -> EngineReplica:
        """Install a FRESH engine (new pod, weights already at ``step``)
        under an existing replica name; the dead engine's retirement log is
        folded into ``history`` so per-request causes stay auditable."""
        rep = self.replicas.get(name)
        if rep is None:
            raise FleetError(f"unknown replica {name!r}")
        rep.fold_history()
        rep.engine = engine
        rep.deployed_step = step
        rep.state = REPLICA_SERVING
        rep.down_cause = ""
        return rep

    def remove_replica(self, name: str) -> EngineReplica:
        """Take a replica OUT of the fleet (autoscale scale-down — the
        caller already drained it; any stragglers were retired with
        honest causes by ``drain``).  Its full retirement log folds into
        the fleet graveyard so per-request accounting survives the
        membership change, bounded front-trimmed like replica history."""
        rep = self.replicas.pop(name, None)
        if rep is None:
            raise FleetError(f"unknown replica {name!r}")
        rep.fold_history()
        self._graveyard.extend(rep.history)
        if len(self._graveyard) > self._graveyard_limit:
            del self._graveyard[: len(self._graveyard) - self._graveyard_limit]
        return rep

    # -- traffic ---------------------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        request_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> Request:
        """Route one request through :class:`FleetRouter` (serving/
        router.py): candidates ranked by pressure grade, shared-prefix
        affinity, and load; per-replica refusals retry the next-best
        replica with the hop recorded.  Raises ``QueueFull`` only on
        fleet-wide exhaustion — and THAT shed names every replica tried
        and why each refused; the client owns the retry, exactly like a
        single engine's shed."""
        rid = request_id if request_id is not None else f"flt-{next(self._counter)}"
        if not self.replicas:
            raise FleetError("fleet has no replicas")
        if any(rep.role != ROLE_FUSED for rep in self.replicas.values()):
            req = self._submit_disagg(prompt, max_new_tokens, rid, deadline_s)
        else:
            req = self.router.submit(prompt, max_new_tokens, rid, deadline_s=deadline_s)
        self.submitted += 1
        return req

    # -- disaggregated prefill/decode (serving/handoff.py) ---------------------

    def _role_live(self, role: str) -> List[str]:
        return [
            name
            for name, rep in self.replicas.items()
            if rep.state == REPLICA_SERVING and rep.role == role
        ]

    def _log_handoff(self, entry: Dict[str, Any]) -> None:
        self.handoff_log.append(entry)
        if len(self.handoff_log) > self._handoff_log_limit:
            del self.handoff_log[: len(self.handoff_log) - self._handoff_log_limit]

    def _count_retries(self, n: int) -> None:
        if n > 0:
            self._metrics.count("serving.handoff_retry", n)

    def _record_hop(
        self,
        trail: List[Dict[str, Any]],
        rid: str,
        stage: str,
        replica: str,
        exc: BaseException,
        payload: Optional[Any] = None,
    ) -> None:
        """One fault-driven handoff hop: classify through the TOTAL
        ``HANDOFF_DECISIONS`` table, record it on the fleet handoff
        ledger + the payload's hop trail + tagged metrics, and —
        when the peer SIGNALLED death mid-handoff — stop routing to it
        (``revive_replica`` brings it back in its role).  Step faults
        and device loss during a handoff dispatch classify as the
        peer-lost cause: the peer's device state is suspect, the request
        moves on."""
        role = ROLE_PREFILL if stage == "prefill" else ROLE_DECODE
        cause = exc.cause if isinstance(exc, HandoffError) else CAUSE_HANDOFF_PEER_LOST
        action = handoff_cause_action(cause)
        entry = {
            "request_id": rid,
            "stage": stage,
            "replica": replica,
            "cause": cause,
            "action": action,
            "decision": handoff_decision(role, cause),
            "detail": str(exc),
        }
        trail.append(entry)
        self._log_handoff(entry)
        if payload is not None:
            payload.hops.append(f"{stage}:{replica}:{cause}")
        self._metrics.count(
            "serving.handoff_hop",
            tags={"stage": stage, "cause": cause, "decision": entry["decision"]},
        )
        logger.warning(
            "kv handoff hop for %s: %s replica %s faulted (%s) -> %s",
            rid, stage, replica, cause, entry["decision"],
        )
        if isinstance(exc, PeerLost):
            self.kill_replica(replica, f"{CAUSE_REPLICA_LOST}:{action}")

    def _submit_disagg(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        rid: str,
        deadline_s: Optional[float],
    ) -> Request:
        """Disaggregated admission: prefill on the least-loaded PREFILL
        replica (fused prefill+insert jit, KV blocks extracted into a
        sealed :class:`KVHandoffPayload`), install on the DECODE replica
        with the most free blocks, decode there.  Every transfer fault is
        a recorded decision, never a drop:

        * transient transfer drops retry in place (``HandoffPolicy``,
          bounded by ``NEXUS_DISAGG_TRANSFER_RETRIES``);
        * a prefill replica faulting mid-handoff re-prefills on the next
          prefill replica; a decode replica faulting mid-install retries
          the next decode replica — both bounded by
          ``NEXUS_DISAGG_MAX_HOPS``;
        * hop exhaustion, or a whole pool down/full, DEGRADES the request
          to fused serving on a decode replica (prefill locally) rather
          than shedding — ``QueueFull`` only when even that is exhausted.
        """
        submitted_at = self._clock()
        trail: List[Dict[str, Any]] = []
        policy = self.disagg.policy(sleep=self._handoff_sleep, rng=self._handoff_rng)
        hops = 0

        def fallback(cause: str) -> Request:
            return self._fused_fallback(
                prompt, max_new_tokens, rid, deadline_s, submitted_at, trail, cause
            )

        if not self._role_live(ROLE_PREFILL):
            return fallback("prefill-pool-down")
        if not self._role_live(ROLE_DECODE):
            return fallback("decode-pool-down")

        # -- prefill stage: load-ranked candidates; faults hop (re-prefill)
        payload = None
        for name in self.router.plan(prompt, role=ROLE_PREFILL):
            rep = self.replicas.get(name)
            if rep is None or rep.state != REPLICA_SERVING:
                continue
            before = policy.retries_used
            try:
                payload = policy.run(
                    lambda _rep=rep, _name=name: _rep.engine.prefill_remote(
                        prompt, rid, source_replica=_name
                    )
                )
            except QueueFull:  # noqa: BLE001 - capacity refusal, not a fault: the router discipline retries the next prefill candidate; total exhaustion degrades to fused below
                self._count_retries(policy.retries_used - before)
                continue
            except (HandoffError, StepFault, DeviceStateLost) as exc:  # noqa: BLE001 - classified through HANDOFF_DECISIONS via _record_hop (hop recorded on ledger + timeline, PeerLost kills the replica); bounded by max_hops then degrades to fused
                self._count_retries(policy.retries_used - before)
                self._record_hop(trail, rid, "prefill", name, exc)
                hops += 1
                if hops > self.disagg.max_hops:
                    return fallback(CAUSE_HANDOFF_EXHAUSTED)
                continue
            self._count_retries(policy.retries_used - before)
            break
        if payload is None:
            return fallback(
                CAUSE_HANDOFF_EXHAUSTED if trail else "prefill-pool-full"
            )

        # -- decode stage: block-availability-ranked candidates; faults hop
        for name in self.router.plan(prompt, role=ROLE_DECODE, by_blocks=True):
            rep = self.replicas.get(name)
            if rep is None or rep.state != REPLICA_SERVING:
                continue
            before = policy.retries_used
            try:
                req = policy.run(
                    lambda _rep=rep: _rep.engine.admit_prefilled(
                        payload,
                        max_new_tokens,
                        deadline_s=deadline_s,
                        submitted_at=submitted_at,
                    )
                )
            except QueueFull:  # noqa: BLE001 - capacity refusal, not a fault: the next decode candidate is tried; total exhaustion degrades to fused below
                self._count_retries(policy.retries_used - before)
                continue
            except (HandoffError, StepFault, DeviceStateLost) as exc:  # noqa: BLE001 - classified through HANDOFF_DECISIONS via _record_hop (hop recorded on ledger + timeline, PeerLost kills the replica); bounded by max_hops then degrades to fused
                self._count_retries(policy.retries_used - before)
                self._record_hop(trail, rid, "decode", name, exc, payload=payload)
                hops += 1
                if hops > self.disagg.max_hops:
                    return fallback(CAUSE_HANDOFF_EXHAUSTED)
                continue
            self._count_retries(policy.retries_used - before)
            self.handoffs_completed += 1
            self._metrics.count("serving.handoff_complete")
            # the landed request's timeline shows every hop it survived
            for entry in trail:
                rep.engine.tracer.event(req, EV_HANDOFF_HOP, dict(entry))
            return req
        return fallback(CAUSE_HANDOFF_EXHAUSTED if trail else "decode-pool-full")

    def _fused_fallback(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        rid: str,
        deadline_s: Optional[float],
        submitted_at: Optional[float],
        trail: List[Dict[str, Any]],
        cause: str,
    ) -> Request:
        """Degrade a disaggregated request to FUSED serving (the landing
        replica prefills locally) rather than shedding it: decode replicas
        first (they hold the KV capacity), any serving replica as the
        keep-alive last resort.  The degradation is recorded with its
        cause on the request trace timeline, the fleet handoff ledger, and
        the ``serving.disagg_fallback`` counter; ``QueueFull`` only when
        every live replica refused."""
        order = self.router.plan(prompt, role=ROLE_DECODE)
        if not order:
            order = self.router.plan(prompt)
        refusals: List[Tuple[str, str]] = []
        for name in order:
            rep = self.replicas.get(name)
            if rep is None or rep.state != REPLICA_SERVING:
                continue
            try:
                req = rep.engine.submit(
                    prompt, max_new_tokens, request_id=rid, deadline_s=deadline_s
                )
            except QueueFull as exc:  # noqa: BLE001 - refusal recorded and the next replica tried; if ALL refuse the aggregate QueueFull below re-raises with every refusal listed
                refusals.append((name, str(exc)))
                continue
            if submitted_at is not None:
                # TTFT spans the WHOLE disaggregated attempt, hops included
                req.submitted_at = submitted_at
            self.disagg_fallbacks += 1
            self._metrics.count("serving.disagg_fallback", tags={"cause": cause})
            entry = {
                "request_id": rid,
                "stage": "fallback",
                "replica": name,
                "cause": cause,
                "action": handoff_cause_action(CAUSE_HANDOFF_EXHAUSTED),
                "decision": HandoffAction.FUSED_FALLBACK,
            }
            self._log_handoff(entry)
            rep.engine.tracer.event(
                req,
                EV_DISAGG_FALLBACK,
                {
                    "cause": cause,
                    "replica": name,
                    "hops": [
                        f"{e['stage']}:{e['replica']}:{e['cause']}" for e in trail
                    ],
                },
            )
            for e in trail:
                rep.engine.tracer.event(req, EV_HANDOFF_HOP, dict(e))
            logger.warning(
                "request %s degraded to fused serving on %s (%s)", rid, name, cause
            )
            return req
        self.router.fleet_sheds += 1
        self._metrics.count("serving.fleet_shed")
        tried = "; ".join(f"{n}: {c}" for n, c in refusals) or "no live replicas"
        raise QueueFull(
            f"request {rid} exhausted kv handoff AND fused fallback "
            f"({cause}) — refused by: {tried}"
        )

    @property
    def has_work(self) -> bool:
        return any(
            rep.state != REPLICA_DOWN and rep.engine.has_work
            for rep in self.replicas.values()
        )

    def tick(self) -> None:
        """One fleet iteration: pump every live engine, then advance the
        rollout state machine (quiesce progress / swap / next replica)."""
        for rep in self.replicas.values():
            if rep.state != REPLICA_DOWN and rep.engine.has_work:
                rep.engine.step()
        if self._rollout is not None:
            self._advance_rollout()

    def run_until_drained(self, max_steps: int = 1_000_000) -> None:
        steps = 0
        while self.has_work or self._rollout is not None:
            if steps >= max_steps:
                raise RuntimeError(
                    f"fleet not drained after {max_steps} ticks "
                    f"(rollout={'active' if self._rollout else 'none'})"
                )
            self.tick()
            steps += 1

    # -- rolling weight updates ------------------------------------------------

    @property
    def rollout_active(self) -> bool:
        return self._rollout is not None

    def deployed_steps(self) -> Dict[str, Optional[int]]:
        return {name: rep.deployed_step for name, rep in self.replicas.items()}

    def converged(self, step: int) -> bool:
        """Every live replica serves ``step`` and no rollout is in flight —
        the chaos drills' convergence predicate."""
        if self._rollout is not None:
            return False
        live = [r for r in self.replicas.values() if r.state != REPLICA_DOWN]
        return bool(live) and all(r.deployed_step == step for r in live)

    def start_rollout(
        self,
        source: Any,
        step: int,
        grace_s: float,
        transform: Optional[Callable[[Any], Any]] = None,
    ) -> bool:
        """Begin a fleet-wide rolling update to checkpoint ``step``.
        ``source`` is ``TensorCheckpointer``-shaped: ``restore_params(step)``
        must VERIFY the step before returning weights
        (``TensorCheckpointer`` deep-verifies manifest + checksums).
        ``transform`` post-processes the restored params (int8 weight
        quantization for quantized fleets).  False when a rollout is
        already in flight (the watcher re-offers next poll)."""
        if self._rollout is not None:
            return False
        self.rollout_error = None
        self._rollout = _Rollout(
            source=source,
            step=step,
            grace_s=grace_s,
            transform=transform,
            order=list(self.replicas),
        )
        logger.info(
            "rolling update to step %d over %d replica(s) started",
            step, len(self._rollout.order),
        )
        return True

    def _advance_rollout(self) -> None:
        """One rollout step: pick the next replica needing the update,
        drive it through pause → quiesce → swap → resume.  Down replicas
        are SKIPPED (their recreate path revives them on the newest
        verified step); replicas already at/past the target (revived
        mid-rollout) are skipped too — both are what makes a pod kill
        mid-rollout converge instead of wedge."""
        ro = self._rollout
        assert ro is not None
        while ro.idx < len(ro.order):
            rep = self.replicas.get(ro.order[ro.idx])
            if (
                rep is None
                or rep.state == REPLICA_DOWN
                or (rep.deployed_step is not None and rep.deployed_step >= ro.step)
            ):
                ro.idx += 1
                ro.deadline = None
                continue
            break
        else:
            rep = None
        if ro.idx >= len(ro.order) or rep is None:
            self._rollout = None
            self.rollouts_completed += 1
            logger.info("rolling update to step %d complete", ro.step)
            return

        if not ro.loaded:
            # load + verify BEFORE any replica is paused: a rotten or
            # wrong-shaped candidate then costs one failed load, never a
            # quiesce (and never grace-expiry evictions of live requests)
            try:
                # NX008 barrier: restore_params re-verifies the candidate
                # step (manifest + full checksums) at LOAD time — the
                # watcher's marker-based poll is the cheap gate, this is
                # the trust boundary no rotten candidate crosses
                kinds = {_sharded(self.replicas[n].engine) for n in ro.order if n in self.replicas}
                if True in kinds:
                    if ro.transform is not None:
                        raise ValueError(
                            "a rollout transform cannot apply to sharded replicas: each rank "
                            "quantizes its own slice at its swap seam"
                        )
                    ro.ref = ro.source.params_ref(ro.step)
                if False in kinds:
                    restored = ro.source.restore_params(ro.step)
                    ro.params = (
                        ro.transform(restored) if ro.transform is not None else restored
                    )
                ro.loaded = True
            except (CheckpointError, ValueError) as exc:  # noqa: BLE001 - the candidate failed its load-time verification (classified Checkpoint* cause) or its transform (config fact): abort the rollout with the cause recorded; no replica was paused, the fleet keeps serving its OLD verified weights
                self._abort_rollout(exc)
                return

        eng = rep.engine
        if rep.state == REPLICA_SERVING:
            rep.state = REPLICA_RELOADING
            eng.pause_admission()
            ro.deadline = self._clock() + max(0.0, ro.grace_s)
        if eng.in_flight:
            # only PREFILLED requests gate the swap (their KV embeds the
            # old weights); the queue waits through it and serves new ones
            if ro.deadline is not None and self._clock() >= ro.deadline:
                # grace exhausted: stragglers evict with the honest reload
                # cause instead of wedging the fleet behind one generation
                eng.evict_in_flight(CAUSE_RELOAD_GRACE)
            else:
                return  # still quiescing; tick() keeps pumping it
        try:
            eng.swap_params(ro.ref if _sharded(eng) else ro.params)
        except ValueError as exc:  # noqa: BLE001 - pytree spec mismatch (wrong checkpoint / missing quantization transform — a config fact retrying replays): abort the rollout with the cause recorded, resume THIS replica on its OLD weights; a swallowed raise here would wedge the replica in RELOADING with admission paused forever
            eng.resume_admission()
            rep.state = REPLICA_SERVING
            self._abort_rollout(exc)
            return
        rep.deployed_step = ro.step
        eng.resume_admission()
        rep.state = REPLICA_SERVING
        ro.idx += 1
        ro.deadline = None

    def _abort_rollout(self, exc: BaseException) -> None:
        """Abort the in-flight rollout, recording why.  ``rollout_error``
        keeps the failed step so the controller's watcher loop can refuse
        to re-attempt the SAME candidate every poll (the fleet would
        otherwise pay a failed load — or worse, a quiesce — per interval
        until a newer step commits)."""
        ro = self._rollout
        assert ro is not None
        cause = getattr(exc, "cause", type(exc).__name__)
        self.rollout_error = (ro.step, f"{cause}: {exc}")
        self._rollout = None
        logger.error(
            "rolling update to step %d ABORTED: %s (fleet stays on "
            "previous weights)",
            ro.step, exc,
        )

    # -- audit -----------------------------------------------------------------

    def all_retired(self) -> List[Request]:
        """Every retired request across all replicas AND engine
        incarnations — what the zero-drop drills audit for terminal
        totality + honest causes.  Includes the graveyard: a replica
        scaled AWAY takes its accounting into the fleet, not with it."""
        out: List[Request] = list(self._graveyard)
        for rep in self.replicas.values():
            out.extend(rep.all_retired())
        return out

    def snapshot(self) -> FleetSnapshot:
        """The fleet's machine-readable load state
        (serving/loadstats.py): one :class:`LoadSnapshot` per replica —
        live replicas report their engine's materialized host state
        (``ServingEngine.load_snapshot``), RELOADING ones
        included with their true lifecycle state, and DOWN replicas
        REPORTED as down with their cause, never silently dropped — plus
        the fleet aggregates.  This is what the SLO monitor grades and
        what ``summary()``/the controller's ledger details embed."""
        import dataclasses as _dc

        replicas: Dict[str, LoadSnapshot] = {}
        for name, rep in self.replicas.items():
            if rep.state == REPLICA_DOWN:
                replicas[name] = LoadSnapshot.down(name, cause=rep.down_cause)
            else:
                replicas[name] = _dc.replace(
                    rep.engine.load_snapshot(replica=name), state=rep.state
                )
        return FleetSnapshot.aggregate(replicas)

    def summary(self) -> Dict[str, Any]:
        states: Dict[str, int] = {}
        causes: Dict[str, int] = {}
        for req in self.all_retired():
            states[req.state] = states.get(req.state, 0) + 1
            if req.cause:
                causes[req.cause] = causes.get(req.cause, 0) + 1
        return {
            "replicas": {
                name: {
                    "state": rep.state,
                    "role": rep.role,
                    "deployed_step": rep.deployed_step,
                }
                for name, rep in self.replicas.items()
            },
            "submitted": self.submitted,
            "handoffs_completed": self.handoffs_completed,
            "disagg_fallbacks": self.disagg_fallbacks,
            "handoff_log_entries": len(self.handoff_log),
            "retired_states": states,
            "retired_causes": causes,
            "rollouts_completed": self.rollouts_completed,
            "rollout_error": self.rollout_error,
            # per-replica liveness + load folded in:
            # the summary used to expose incident history with no view of
            # what the fleet is DOING — the snapshot is that view, and the
            # serve/controller ledger details inherit it wholesale
            "load": self.snapshot().to_dict(),
        }


@dataclass
class _Incident:
    """One classified serving-pod failure awaiting execution."""

    action: str
    recovery: str
    cause: str
    trace: str
    pod: str


class FleetSupervisor:
    """The serving-fleet control loop (see module doc): informers over the
    serving JobSet's Events/Pods, taxonomy classification, recovery
    execution, the missing-pod watchdog sweep, and the checkpoint-watcher-
    driven rolling update — all test-callable via :meth:`reconcile`.

    ``replica_factory(name, step, kv_blocks)`` builds a fresh, already-
    weighted :class:`ServingEngine` for a recreated pod (``step`` is the
    newest verified checkpoint step, None for init weights; ``kv_blocks``
    the possibly-reduced KV budget, None when not paged)."""

    def __init__(
        self,
        client: Any,
        store: Any,
        namespace: str,
        fleet: ServingFleet,
        jobset_name: str,
        algorithm: str,
        replica_factory: Callable[[str, Optional[int], Optional[int]], ServingEngine],
        source: Any = None,
        watcher: Optional[CheckpointWatcher] = None,
        transform: Optional[Callable[[Any], Any]] = None,
        grace_s: float = 5.0,
        kv_blocks: Optional[int] = None,
        min_kv_blocks: int = 2,
        missing_after_s: float = 0.0,
        resync_period: Optional[timedelta] = None,
        logger_: Optional[Any] = None,
        metrics: Optional[Any] = None,
        slo: Optional[SloMonitor] = None,
        autoscale: Optional[AutoscaleConfig] = None,
    ) -> None:
        from tpu_nexus_torch.core.telemetry import NullMetrics, get_logger
        from tpu_nexus_torch.k8s.informer import SharedInformerFactory
        from tpu_nexus_torch.supervisor.watchdog import StalenessTracker

        self._client = client
        self._store = store
        self.namespace = namespace
        self.fleet = fleet
        self.jobset_name = jobset_name
        self.algorithm = algorithm
        self.replica_factory = replica_factory
        self.source = source
        self.watcher = watcher
        self.transform = transform
        self.grace_s = grace_s
        self.min_kv_blocks = min_kv_blocks
        self.missing_after_s = missing_after_s
        self._log = logger_ or get_logger("tpu_nexus_torch.fleet")
        self._metrics = metrics or NullMetrics()
        self._factory = SharedInformerFactory(
            client, namespace,
            resync_period=resync_period if resync_period is not None else timedelta(seconds=30),
        )
        for kind in ("Event", "Pod", "JobSet"):
            self._factory.informer_for(kind)
        self._factory.informer_for("Event").add_event_handler(self._on_k8s_event)
        self._factory.informer_for("Pod").add_event_handler(self._on_pod)
        self._pending: "deque[_Incident]" = deque()
        self._pod_templates: Dict[str, Dict[str, Any]] = {}
        #: pod deletions WE initiated (crash-loop recreate) — their DELETED
        #: watch events are not incidents
        self._expected_deletions: set = set()
        self._missing = StalenessTracker()
        #: per-replica KV block budget (reduced on HBM OOM recreates)
        self._kv_blocks: Dict[str, Optional[int]] = {}
        self._default_kv_blocks = kv_blocks
        #: per-pod disaggregation role, read from the pod
        #: template's ``NEXUS_REPLICA_ROLE`` env at adoption and PRESERVED
        #: across recreates — a segfaulting prefill pool recreates as
        #: prefill, never silently shrinking to zero while decode idles
        self._roles: Dict[str, str] = {}
        self._uid_counter = itertools.count(1)
        self._row_ensured = False
        self._reconciles = 0
        #: (step, poller scan count) of a shunned rollout candidate — see
        #: :meth:`_check_rollout`
        self._shunned: Optional[Tuple[int, int]] = None
        #: the pressure plane: graded per reconcile when a
        #: monitor is configured; transitions land on the ledger row +
        #: tagged metrics, SATURATED dumps the replica's flight recorder
        self.slo = slo
        if slo is not None:
            # the router grades candidates off the SAME monitor the
            # autoscaler consumes — one pressure truth per fleet
            fleet.router.slo = slo
        #: autoscaling: None disables — a fixed fleet
        self.autoscale = autoscale
        self._scale_up_streak = 0
        self._scale_down_streak = 0
        self._last_scale_t: Optional[float] = None
        self._scale_counter = itertools.count(1)
        # observability (tests + dashboards)
        self.recreated = 0
        self.escalated = 0
        self.scaled_up = 0
        self.scaled_down = 0
        self.scale_events: List[Dict[str, Any]] = []
        self.incidents: List[Dict[str, Any]] = []
        #: bounded transition log (front-trimmed past
        #: _pressure_events_limit, the SloMonitor.transitions discipline):
        #: a replica flapping around its SLO target transitions for the
        #: supervisor's whole lifetime and must not grow this unboundedly
        self.pressure_events: List[Dict[str, Any]] = []
        self._pressure_events_limit = 1024

    # -- k8s handlers (sync, informer-dispatched) ------------------------------

    def _on_k8s_event(self, event_type: str, event: Any) -> None:
        from tpu_nexus_torch.supervisor import resolvers
        from tpu_nexus_torch.supervisor.taxonomy import (
            SERVING_POD_RECOVERY,
            DecisionAction,
            FleetRecovery,
            classify_event,
        )

        if event_type != "ADDED":
            return
        informers = self._factory.informers
        if not resolvers.is_serving_fleet_event(event, self.namespace, informers):
            return
        result = classify_event(event, self.namespace, informers)
        if result is None or result.request_id != self.jobset_name:
            return
        action = result.action
        if result.object_kind != "Pod":
            # JobSet/Job-level conditions (FailedCreate, FailedJobs, ...)
            # name no pod — there is nothing to recreate, and treating the
            # JobSet name as a pod would mint a phantom replica the
            # missing-pod sweep then recreates forever.  Record + escalate.
            recovery = FleetRecovery.ESCALATE
            pod = ""
        else:
            if action == DecisionAction.TO_FAIL_STUCK_IN_PENDING:
                # the reference's Pod-"Failed" quirk maps a DEAD pod to the
                # stuck-in-pending class for whole-run semantics; for a
                # stateless serving replica a dead pod is a crash — recreate.
                # TRUE scheduling failures arrive as Job/JobSet FailedCreate
                # events (the branch above) and still escalate.
                action = DecisionAction.TO_FAIL_FATAL_ERROR
            recovery = SERVING_POD_RECOVERY[action]
            pod = result.object_name
        if recovery == FleetRecovery.NONE:
            return
        self._metrics.count("fleet_decisions", tags={"action": action})
        self._pending.append(
            _Incident(
                action=action,
                recovery=recovery,
                cause=result.run_status_message,
                trace=result.run_status_trace,
                pod=pod,
            )
        )

    def _on_pod(self, event_type: str, pod: Any) -> None:
        from tpu_nexus_torch.supervisor.taxonomy import DecisionAction, FleetRecovery, MSG_PREEMPTED

        if pod.jobset_name() != self.jobset_name:
            return
        name = pod.meta.name
        if event_type in ("ADDED", "MODIFIED"):
            # keep a manifest template per pod so a DELETED pod can be
            # recreated even after the cluster forgot its spec
            self._pod_templates[name] = copy.deepcopy(pod.raw)
            return
        if event_type != "DELETED":
            return
        if name in self._expected_deletions:
            self._expected_deletions.discard(name)
            return
        # a pod deleted out from under the fleet (preemption, node drain,
        # operator kubectl) — restartable by definition; the taxonomy's
        # preemption action names the cause
        self._pending.append(
            _Incident(
                action=DecisionAction.TO_PREEMPT_RESTARTABLE,
                recovery=FleetRecovery.RECREATE,
                cause=MSG_PREEMPTED,
                trace=f"pod {name} deleted from the cluster",
                pod=name,
            )
        )

    # -- bootstrap -------------------------------------------------------------

    async def adopt_pods(self, step: Optional[int] = None) -> List[str]:
        """Bind one fleet replica per existing serving pod of the JobSet
        (startup / controller restart): builds each replica's engine at
        ``step`` via the factory.  Returns the adopted pod names."""
        pods, _ = await self._client.list_objects("Pod", self.namespace)
        adopted = []
        for raw in pods:
            meta = raw.get("metadata") or {}
            labels = meta.get("labels") or {}
            from tpu_nexus_torch.checkpoint.models import JOBSET_NAME_LABEL

            if labels.get(JOBSET_NAME_LABEL) != self.jobset_name:
                continue
            name = meta.get("name", "")
            if not name or name in self.fleet.replicas:
                continue
            self._pod_templates[name] = copy.deepcopy(raw)
            self._kv_blocks[name] = self._default_kv_blocks
            self._roles[name] = self._template_role(raw)
            engine = self.replica_factory(name, step, self._default_kv_blocks)
            self.fleet.add_replica(name, engine, step, role=self._roles[name])
            adopted.append(name)
        return sorted(adopted)

    @staticmethod
    def _template_role(manifest: Dict[str, Any]) -> str:
        """The pod's disaggregation role from its ``NEXUS_REPLICA_ROLE``
        container env (the same manifest seam as ``NEXUS_KV_BLOCKS``);
        absent or unrecognized values serve fused — a typo'd role must
        degrade to the engine that can serve ANY request, not wedge the
        pod out of both pools."""
        for container in (manifest.get("spec") or {}).get("containers", []) or []:
            for entry in container.get("env", []) or []:
                if entry.get("name") == "NEXUS_REPLICA_ROLE":
                    value = str(entry.get("value", "")).strip().lower()
                    if value in (ROLE_PREFILL, ROLE_DECODE, ROLE_FUSED):
                        return value
                    return ROLE_FUSED
        return ROLE_FUSED

    # -- the control loop ------------------------------------------------------

    async def reconcile(self, now: Optional[float] = None) -> None:
        """One control iteration, test-callable: execute pending classified
        incidents, sweep for silently-missing pods, check the checkpoint
        watcher, and advance fleet traffic/rollout one tick."""
        now = time.monotonic() if now is None else now
        await self._ensure_row()
        await self._heartbeat()
        while self._pending:
            await self._apply(self._pending.popleft())
        await self._sweep_missing_pods(now)
        self._check_rollout(now)
        self.fleet.tick()
        snapshot = await self._observe_pressure()
        await self._autoscale(now, snapshot)

    async def _sweep_missing_pods(self, now: float) -> None:
        """Absence-driven backstop (the ledger watchdog's discipline): a
        pod can die without ANY classifiable event reaching us (event
        dropped, controller down).  A replica whose pod has been missing
        from the informer cache past ``missing_after_s`` is recreated with
        the taxonomy's preemption cause."""
        from tpu_nexus_torch.supervisor.taxonomy import DecisionAction, FleetRecovery, MSG_PREEMPTED

        if not self.missing_after_s:
            # 0 disables the sweep (repo convention for interval knobs):
            # a hair-trigger default would recreate a healthy replica —
            # abandoning its live requests — on any informer/watch lag
            # longer than one reconcile, including the window right after
            # our OWN recreate before the ADDED event reaches the cache
            return
        informer = self._factory.informers.get("Pod")
        if informer is None or not informer.has_synced:
            return
        present = set()
        for name in list(self.fleet.replicas):
            if informer.get(name) is not None:
                present.add(name)
                continue
            missing_for = self._missing.observe(name, ("missing",), now)
            if missing_for is None or missing_for < self.missing_after_s:
                continue
            self._missing.forget(name)
            self._metrics.count("fleet_watchdog_recreates")
            await self._apply(
                _Incident(
                    action=DecisionAction.TO_PREEMPT_RESTARTABLE,
                    recovery=FleetRecovery.RECREATE,
                    cause=MSG_PREEMPTED,
                    trace=f"{MSG_POD_MISSING}: {name}",
                    pod=name,
                )
            )
        # keep timers only for replicas STILL missing; a pod that came back
        # (or a replica removed from the fleet) starts a fresh timer next time
        self._missing.retain(set(self.fleet.replicas) - present)

    def _check_rollout(self, now: float) -> None:
        if self.watcher is None or self.source is None:
            return
        step = self.watcher.check(now)
        if step is None or self.fleet.rollout_active:
            return
        scans = self.watcher.poller.scans
        if self.fleet.rollout_error is not None and self.fleet.rollout_error[0] == step:
            # this exact candidate already failed its load-time
            # verification/transform — re-attempting it every poll would
            # pay a failed load per interval forever.  The shun is keyed
            # by (step, poller scan count): any directory change (e.g. the
            # step RE-COMMITTED after a quarantine-and-retrain cycle) bumps
            # the scan count and earns the candidate exactly one more try.
            if self._shunned is None or self._shunned[0] != step:
                self._shunned = (step, scans)
            if self._shunned[1] == scans:
                return
            self._shunned = None
        behind = [
            rep
            for rep in self.fleet.replicas.values()
            if rep.state != REPLICA_DOWN
            and (rep.deployed_step is None or rep.deployed_step < step)
        ]
        if not behind:
            return
        self.fleet.start_rollout(
            self.source, step, self.grace_s, transform=self.transform
        )

    # -- the pressure plane ----------------------------------------------------

    async def _observe_pressure(self) -> Optional[FleetSnapshot]:
        """One pressure observation per reconcile (module doc): snapshot
        the fleet, emit the tagged load gauges, grade through the SLO
        monitor, and dispatch each transition through the TOTAL
        ``PRESSURE_ACTIONS`` table — every transition is recorded
        (cause+details JSON on the fleet's RUNNING ledger row, the
        ``fleet.pressure_transitions`` metric, ``pressure_events``), and
        a replica entering SATURATED additionally dumps its flight
        recorder at the saturation incident seam so the episode gets the
        same drill-down a fault does.  Returns the snapshot it graded
        (the autoscaler's idleness input — one snapshot per reconcile,
        not one per consumer), None when no monitor is wired."""
        if self.slo is None:
            return None
        snapshot = self.fleet.snapshot()
        emit_fleet_snapshot(self._metrics, snapshot)
        for transition in self.slo.observe(snapshot):
            # the monitor already stamped PRESSURE_ACTIONS[to] on the
            # record — one place the consequence semantics live
            record = dict(transition)
            if (
                "dump" in record["action"]
                and transition["scope"] in self.fleet.replicas
            ):
                rep = self.fleet.replicas[transition["scope"]]
                if rep.state != REPLICA_DOWN:
                    dump = rep.engine.dump_pressure(
                        f"slo-{transition['to']}:{transition['scope']}"
                    )
                    if dump is not None:
                        record["flight_recorder"] = dump
            self.pressure_events.append(record)
            if len(self.pressure_events) > self._pressure_events_limit:
                del self.pressure_events[
                    : len(self.pressure_events) - self._pressure_events_limit
                ]
            self._log.warning(
                "fleet pressure transition",
                scope=transition["scope"],
                from_=transition["from"],
                to=transition["to"],
            )
            await self._record_pressure(record, snapshot)
        return snapshot

    # -- autoscaling ------------------------------------------------------------

    async def _autoscale(
        self, now: float, snapshot: Optional[FleetSnapshot]
    ) -> None:
        """One autoscale observation per reconcile: map the SLO monitor's
        FLEET grade through the TOTAL ``SCALE_DECISIONS`` table (NX021 in
        the JAX package), require the verdict to HOLD for a configured streak of
        consecutive reconciles (scale-down additionally requires the
        fleet idle — zero queued AND zero in-flight, which is what makes
        the ``drain`` path zero-drop by construction), gate on the
        cooldown, then act through the same pod create/delete seams as
        failure recovery.  Every decision lands cause+details on the
        ledger row like any other incident."""
        if self.autoscale is None or self.slo is None or snapshot is None:
            return
        from tpu_nexus_torch.serving.loadstats import PRESSURE_HEALTHY

        grade = self.slo.grades.get(SloMonitor.FLEET, PRESSURE_HEALTHY)
        decision = SCALE_DECISIONS[grade]
        idle = snapshot.queue_depth == 0 and snapshot.live_requests == 0
        if decision == SCALE_UP:
            self._scale_up_streak += 1
            self._scale_down_streak = 0
        elif decision == SCALE_DOWN_WHEN_IDLE and idle:
            self._scale_down_streak += 1
            self._scale_up_streak = 0
        else:
            self._scale_up_streak = 0
            self._scale_down_streak = 0
        if (
            self._last_scale_t is not None
            and now - self._last_scale_t < self.autoscale.cooldown_s
        ):
            return
        live = [
            rep for rep in self.fleet.replicas.values()
            if rep.state != REPLICA_DOWN
        ]
        if (
            self._scale_up_streak >= self.autoscale.scale_up_after
            and len(live) < self.autoscale.max_replicas
        ):
            await self._scale_up(now, grade, snapshot)
        elif (
            self._scale_down_streak >= self.autoscale.scale_down_after
            and sum(1 for rep in live if rep.state == REPLICA_SERVING)
            > self.autoscale.min_replicas
        ):
            await self._scale_down(now, grade, snapshot)

    async def _scale_up(
        self, now: float, grade: str, snapshot: FleetSnapshot
    ) -> None:
        """Add one replica: clone an existing pod manifest (fresh name +
        uid, Pending, default KV budget — the recreate path's template
        discipline), create it in the cluster, build its engine at the
        newest verified step, and join it to the fleet."""
        name = f"{self.jobset_name}-scale-{next(self._scale_counter)}"
        role = self._scale_role(snapshot)
        template = self._template_for_role(role)
        if template is None:
            self._log.warning(
                "autoscale: no pod manifest template to clone; skipping scale-up"
            )
            return
        manifest = copy.deepcopy(template)
        meta = manifest.setdefault("metadata", {})
        meta["name"] = name
        meta["uid"] = f"fleet-scale-{next(self._uid_counter)}"
        manifest["status"] = {"phase": "Pending"}
        await self._client.create_object("Pod", self.namespace, manifest)
        self._pod_templates[name] = copy.deepcopy(manifest)
        self._kv_blocks[name] = self._default_kv_blocks
        self._roles[name] = role
        step = self._target_step()
        engine = self.replica_factory(name, step, self._default_kv_blocks)
        self.fleet.add_replica(name, engine, step, role=role)
        self.scaled_up += 1
        self._scale_up_streak = 0
        self._scale_down_streak = 0
        self._last_scale_t = now
        record = {
            "action": "autoscale",
            "decision": SCALE_UP,
            "grade": grade,
            "pod": name,
            "role": role,
            "step": step,
            "replicas": len(self.fleet.replicas),
        }
        self.scale_events.append(record)
        self._metrics.count("fleet_autoscale", tags={"decision": "up"})
        self._log.info(
            "fleet scaled up", pod=name, grade=grade, replicas=record["replicas"]
        )
        await self._record_scale(record, snapshot)

    def _scale_role(self, snapshot: FleetSnapshot) -> str:
        """Which pool should grow: the role whose live replicas carry the
        highest mean queued+live load.  A fleet with no role-typed
        replicas scales fused."""
        loads: Dict[str, List[float]] = {}
        for name, rep in self.fleet.replicas.items():
            if rep.state == REPLICA_DOWN:
                continue
            snap = snapshot.replicas.get(name)
            if snap is None:
                continue
            loads.setdefault(rep.role, []).append(
                float(snap.queue_depth + snap.live_requests)
            )
        if not loads:
            return ROLE_FUSED
        return max(
            sorted(loads), key=lambda role: sum(loads[role]) / len(loads[role])
        )

    def _template_for_role(self, role: str) -> Optional[Dict[str, Any]]:
        """A pod manifest template carrying ``role`` (recorded at adoption
        or readable from the manifest env); any template as the fallback
        so a role with no surviving template still scales SOMETHING."""
        for pod, manifest in self._pod_templates.items():
            if self._roles.get(pod, self._template_role(manifest)) == role:
                return manifest
        return next(iter(self._pod_templates.values()), None)

    async def _scale_down(
        self, now: float, grade: str, snapshot: FleetSnapshot
    ) -> None:
        """Remove one replica, zero-drop: pick the least-loaded SERVING
        replica, ``drain(grace_s)`` it (the fleet is idle by the streak
        precondition, so the drain retires nothing — stragglers past
        grace would carry the drain's honest cause), fold its accounting
        into the fleet graveyard, and delete its pod (an EXPECTED
        deletion — the watch event must not classify as an incident)."""
        from tpu_nexus_torch.k8s.client import NotFoundError

        serving = [
            (name, rep)
            for name, rep in self.fleet.replicas.items()
            if rep.state == REPLICA_SERVING
        ]
        # role-pool floor: in a role-typed fleet, never drain a
        # role's LAST serving replica — scaling the prefill pool to zero
        # would force every admission through the fused fallback while
        # decode replicas idle
        role_counts: Dict[str, int] = {}
        for _, rep in serving:
            role_counts[rep.role] = role_counts.get(rep.role, 0) + 1
        if len(role_counts) > 1:
            serving = [
                (name, rep) for name, rep in serving if role_counts[rep.role] > 1
            ]
        if not serving:
            return
        name, rep = min(
            serving,
            key=lambda item: (
                item[1].engine.scheduler.pending + item[1].engine.in_flight,
                item[0],
            ),
        )
        drain = rep.engine.drain(self.grace_s)
        self.fleet.remove_replica(name)
        self._expected_deletions.add(name)
        try:
            await self._client.delete_object("Pod", self.namespace, name)
        except NotFoundError:  # noqa: BLE001 - pod already gone; membership removal above is the part that matters
            self._expected_deletions.discard(name)
        self._pod_templates.pop(name, None)
        self._kv_blocks.pop(name, None)
        self._roles.pop(name, None)
        self._missing.forget(name)
        self.scaled_down += 1
        self._scale_up_streak = 0
        self._scale_down_streak = 0
        self._last_scale_t = now
        record = {
            "action": "autoscale",
            "decision": "scale-down",
            "grade": grade,
            "pod": name,
            "drain": drain,
            "replicas": len(self.fleet.replicas),
        }
        self.scale_events.append(record)
        self._metrics.count("fleet_autoscale", tags={"decision": "down"})
        self._log.info(
            "fleet scaled down", pod=name, grade=grade, replicas=record["replicas"]
        )
        await self._record_scale(record, snapshot)

    async def _record_scale(
        self, record: Dict[str, Any], snapshot: FleetSnapshot
    ) -> None:
        """Scale decisions on the ledger (the ``_record_cause``
        discipline): the row stays RUNNING, cause names the decision,
        details embed the record + the graded snapshot that justified
        it — an operator reading the row sees WHY capacity changed."""
        if self._store is None:
            return
        import asyncio

        cause = (
            f"fleet autoscale: {record['decision']} -> {record['pod']} "
            f"(grade {record['grade']})"
        )
        details = json.dumps(
            {"autoscale": record, "fleet": snapshot.to_dict()},
            sort_keys=True,
            default=str,
        )

        def _write():
            cp = self._store.read_checkpoint(self.algorithm, self.jobset_name)
            if cp is None or cp.is_finished():
                return
            self._store.update_fields(
                self.algorithm,
                self.jobset_name,
                {
                    "algorithm_failure_cause": cause,
                    "algorithm_failure_details": details,
                    "last_modified": datetime.now(timezone.utc),
                },
            )

        await asyncio.to_thread(_write)

    async def _record_pressure(
        self, record: Dict[str, Any], snapshot: FleetSnapshot
    ) -> None:
        """Pressure transitions on the ledger (the _record_cause
        discipline): the fleet row stays RUNNING — pressure is a
        condition, not a death — but cause/details name the transition
        and embed the graded snapshot, so an operator reading the row
        sees WHAT the fleet looked like when it crossed the line.

        Pressure shares the cause/details columns with fault incidents
        (``_record_cause``) and each write replaces the last, so the
        details carry the RECENT INCIDENTS alongside the transition —
        a pod-loss record overwritten one reconcile later by the
        resulting HEALTHY -> PRESSURED note must not vanish from the
        row (the inventory-merge discipline)."""
        if self._store is None:
            return
        import asyncio

        cause = (
            f"fleet pressure: {record['scope']} "
            f"{record['from']} -> {record['to']}"
        )
        details = json.dumps(
            {
                "pressure": record,
                "grades": dict(self.slo.grades) if self.slo is not None else {},
                "fleet": snapshot.to_dict(),
                **(
                    {"incidents": self.incidents[-3:]}
                    if self.incidents
                    else {}
                ),
            },
            sort_keys=True,
            default=str,
        )

        def _write():
            cp = self._store.read_checkpoint(self.algorithm, self.jobset_name)
            if cp is None or cp.is_finished():
                return
            self._store.update_fields(
                self.algorithm,
                self.jobset_name,
                {
                    "algorithm_failure_cause": cause,
                    "algorithm_failure_details": details,
                    "last_modified": datetime.now(timezone.utc),
                },
            )

        await asyncio.to_thread(_write)

    # -- recovery execution ----------------------------------------------------

    async def _apply(self, incident: _Incident) -> None:
        from tpu_nexus_torch.supervisor.taxonomy import FleetRecovery

        record = {
            "action": incident.action,
            "recovery": incident.recovery,
            "pod": incident.pod,
            "cause": incident.cause,
            "trace": incident.trace,
        }
        if incident.recovery == FleetRecovery.ESCALATE:
            self.escalated += 1
            if incident.pod in self.fleet.replicas:
                self.fleet.kill_replica(
                    incident.pod, f"{CAUSE_REPLICA_LOST}:{incident.action}"
                )
                self._attach_dump(record, incident.pod)
            self.incidents.append(record)
            self._metrics.count("fleet_escalations", tags={"action": incident.action})
            self._log.warning(
                "serving fleet failure escalated to operator",
                pod=incident.pod,
                action=incident.action,
                cause=incident.cause,
            )
            await self._record_cause(incident, record)
            return
        # RECREATE / RECREATE_REDUCED_KV
        if (
            incident.pod not in self.fleet.replicas
            and incident.pod not in self._pod_templates
        ):
            # fail safe: an object name that never was a fleet pod must not
            # mint a phantom replica (which the missing-pod sweep would then
            # recreate forever) — record + escalate to an operator instead
            self.escalated += 1
            record["recovery"] = FleetRecovery.ESCALATE
            record["note"] = "recreate requested for unknown pod; escalated"
            self.incidents.append(record)
            self._log.warning(
                "recreate requested for unknown serving pod; escalating",
                pod=incident.pod,
                action=incident.action,
            )
            await self._record_cause(incident, record)
            return
        reduce_kv = incident.recovery == FleetRecovery.RECREATE_REDUCED_KV
        kv = self._kv_blocks.get(incident.pod, self._default_kv_blocks)
        if reduce_kv:
            if kv is None:
                self._log.warning(
                    "HBM-OOM recovery asked to reduce NEXUS_KV_BLOCKS but the "
                    "fleet is not paged; recreating with unchanged config",
                    pod=incident.pod,
                )
            else:
                kv = max(self.min_kv_blocks, kv // 2)
        self._kv_blocks[incident.pod] = kv
        record["kv_blocks"] = kv
        # recreate PER ROLE: the replacement pod keeps the dead
        # pod's disaggregation role — a crash-looping prefill replica comes
        # back as prefill, so a faulting pool recovers instead of shrinking
        # to zero while the other pool idles
        role = self._roles.get(incident.pod)
        if role is None:
            template = self._pod_templates.get(incident.pod)
            role = self._template_role(template) if template else ROLE_FUSED
        self._roles[incident.pod] = role
        record["role"] = role
        if incident.pod in self.fleet.replicas:
            self.fleet.kill_replica(
                incident.pod, f"{CAUSE_REPLICA_LOST}:{incident.action}"
            )
            self._attach_dump(record, incident.pod)
        step = self._target_step()
        await self._recreate_pod(incident.pod, kv, role=role)
        engine = self.replica_factory(incident.pod, step, kv)
        if incident.pod in self.fleet.replicas:
            rep = self.fleet.revive_replica(incident.pod, engine, step)
            rep.role = role
        else:
            self.fleet.add_replica(incident.pod, engine, step, role=role)
        self.recreated += 1
        record["step"] = step
        self.incidents.append(record)
        self._metrics.count("fleet_recreates", tags={"action": incident.action})
        self._log.info(
            "serving pod recreated",
            pod=incident.pod,
            action=incident.action,
            step=step,
            kv_blocks=kv,
        )
        await self._record_cause(incident, record)

    def _target_step(self) -> Optional[int]:
        """The step a revived replica should serve: the in-flight rollout's
        target, else the newest VERIFIED step (poll bypassing the watcher
        interval — a recreate must not revive stale weights just because
        the next poll is seconds away), else the fleet's newest deployed."""
        if self.fleet._rollout is not None:
            return self.fleet._rollout.step
        if self.watcher is not None:
            step = self.watcher.poller.latest_verified_step()
            if step is not None:
                return step
        deployed = [
            s for s in self.fleet.deployed_steps().values() if s is not None
        ]
        return max(deployed) if deployed else None

    async def _recreate_pod(
        self, name: str, kv_blocks: Optional[int], role: Optional[str] = None
    ) -> None:
        """Replace the pod object in the cluster: delete the dead husk if
        it still exists (expected deletion — not an incident), then create
        a fresh-uid replacement from the remembered template with the
        (possibly reduced) ``NEXUS_KV_BLOCKS`` and the preserved
        ``NEXUS_REPLICA_ROLE`` envs applied."""
        from tpu_nexus_torch.k8s.client import NotFoundError

        template = self._pod_templates.get(name)
        if template is None:
            self._log.warning("no manifest template for pod; skipping k8s recreate", pod=name)
            return
        self._expected_deletions.add(name)
        try:
            await self._client.delete_object("Pod", self.namespace, name)
        except NotFoundError:  # noqa: BLE001 - already gone (the kill WAS the deletion): recreate proceeds
            self._expected_deletions.discard(name)
        manifest = copy.deepcopy(template)
        meta = manifest.setdefault("metadata", {})
        meta["uid"] = f"fleet-recreate-{next(self._uid_counter)}"
        manifest["status"] = {"phase": "Pending"}
        patches = {}
        if kv_blocks is not None:
            patches["NEXUS_KV_BLOCKS"] = str(kv_blocks)
        if role is not None:
            patches["NEXUS_REPLICA_ROLE"] = role
        if patches:
            for container in (manifest.get("spec") or {}).get("containers", []) or []:
                env = container.setdefault("env", [])
                for key, value in patches.items():
                    for entry in env:
                        if entry.get("name") == key:
                            entry["value"] = value
                            break
                    else:
                        env.append({"name": key, "value": value})
        await self._client.create_object("Pod", self.namespace, manifest)
        self._pod_templates[name] = copy.deepcopy(manifest)

    def _attach_dump(self, record: Dict[str, Any], pod: str) -> None:
        """Merge the dead replica's flight-recorder artifact pointer into
        the incident record (``_record_cause`` serializes the record into
        the ledger details wholesale, so the row names its drill-down)."""
        rep = self.fleet.replicas.get(pod)
        if rep is not None and rep.last_incident_dump is not None:
            record["flight_recorder"] = rep.last_incident_dump

    # -- ledger ----------------------------------------------------------------

    async def _heartbeat(self) -> None:
        """Per-reconcile liveness write (the serve loop's heartbeat
        discipline): without it an incident-free fleet's row would look
        frozen to the run supervisor's RUNNING sweep, which would
        'rescue' a perfectly healthy fleet by deleting its JobSet.  With
        it, the sweep covers the fleet CONTROLLER honestly: a hung
        controller stops heartbeating and gets flagged like any hung
        run."""
        if self._store is None:
            return
        import asyncio

        self._reconciles += 1
        n = self._reconciles

        def _beat():
            cp = self._store.read_checkpoint(self.algorithm, self.jobset_name)
            if cp is None or cp.is_finished():
                return
            self._store.merge_chip_steps(
                self.algorithm, self.jobset_name, {"fleet/reconciles": n}
            )

        await asyncio.to_thread(_beat)

    async def _ensure_row(self) -> None:
        """The fleet's ledger row: RUNNING for the controller's lifetime,
        heartbeated per reconcile (:meth:`_heartbeat`), causes recorded
        per incident."""
        if self._row_ensured or self._store is None:
            return
        import asyncio

        from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage

        def _ensure():
            cp = self._store.read_checkpoint(self.algorithm, self.jobset_name)
            if cp is None:
                self._store.upsert_checkpoint(
                    CheckpointedRequest(
                        algorithm=self.algorithm,
                        id=self.jobset_name,
                        lifecycle_stage=LifecycleStage.RUNNING,
                    )
                )

        await asyncio.to_thread(_ensure)
        self._row_ensured = True

    async def _record_cause(self, incident: _Incident, record: Dict[str, Any]) -> None:
        """Honest causes in the ledger: the row keeps RUNNING (the fleet is
        alive — that is the whole point), but cause/details name the most
        recent incident and its recovery, so an operator reading the row
        sees WHAT happened and what the controller did about it."""
        if self._store is None:
            return
        import asyncio

        def _write():
            cp = self._store.read_checkpoint(self.algorithm, self.jobset_name)
            if cp is None or cp.is_finished():
                return
            self._store.update_fields(
                self.algorithm,
                self.jobset_name,
                {
                    "algorithm_failure_cause": incident.cause,
                    "algorithm_failure_details": json.dumps(record, sort_keys=True),
                    "last_modified": datetime.now(timezone.utc),
                },
            )

        await asyncio.to_thread(_write)

    # -- lifecycle -------------------------------------------------------------

    async def run(self, ctx: Any, interval_s: float = 1.0) -> None:
        """Start informers and reconcile every ``interval_s`` until the
        lifecycle context cancels (the watchdog.run shape)."""
        import asyncio

        self._factory.start(ctx)
        await self._factory.wait_for_cache_sync()
        while not ctx.cancelled:
            try:
                await self.reconcile()
            except Exception:  # noqa: BLE001 - the control loop must outlive hiccups (a failed reconcile retries next interval; giving up would orphan the fleet)
                logger.exception("fleet reconcile failed; will retry")
            try:
                await asyncio.wait_for(ctx.wait(), timeout=interval_s)
            except asyncio.TimeoutError:  # noqa: BLE001 - the interval tick: timeout IS the schedule (cancellation exits via ctx.cancelled), identical to watchdog.run
                continue
        await self._factory.shutdown()
