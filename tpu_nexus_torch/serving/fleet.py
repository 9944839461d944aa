"""The serving fleet: engine replicas behind a router, disaggregated
prefill/decode with the KV handoff, and zero-drop rolling weight updates.
The port of ``tpu_nexus/serving/fleet.py`` without its Kubernetes
reconciler.

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

Replicas of one process share one device and one stream.  Serving never
writes weights, so replicas may share one params tree; a rollout gives
each replica the tree its source restores.

Not here: the reference's ``FleetSupervisor``, the control loop that
watches the serving JobSet's pods through the Kubernetes informers and
recreates or scales replicas.  It needs the control plane
(``k8s/``, ``supervisor/watchdog.py``, ``supervisor/resolvers.py``) and is
ROADMAP.md A7b.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
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
from tpu_nexus_torch.serving.loadstats import FleetSnapshot, LoadSnapshot
from tpu_nexus_torch.serving.recovery import DeviceStateLost, StepFault
from tpu_nexus_torch.serving.request import Request
from tpu_nexus_torch.serving.router import ROUTER_PRESSURE, FleetRouter
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
    serves the whole fleet) and cached for the remaining replicas."""

    source: Any  # TensorCheckpointer-shaped: restore_params(step)
    step: int
    grace_s: float
    transform: Optional[Callable[[Any], Any]] = None
    order: List[str] = field(default_factory=list)
    idx: int = 0
    params: Any = None
    deadline: Optional[float] = None


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

        if ro.params is None:
            # load + verify BEFORE any replica is paused: a rotten or
            # wrong-shaped candidate then costs one failed load, never a
            # quiesce (and never grace-expiry evictions of live requests)
            try:
                # NX008 barrier: restore_params re-verifies the candidate
                # step (manifest + full checksums) at LOAD time — the
                # watcher's marker-based poll is the cheap gate, this is
                # the trust boundary no rotten candidate crosses
                restored = ro.source.restore_params(ro.step)
                ro.params = (
                    ro.transform(restored) if ro.transform is not None else restored
                )
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
            eng.swap_params(ro.params)
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

