"""Ledger liveness watchdog: detects runs that are alive in the ledger but
dead in the cluster.

Two sweeps, both driven by *absence* of signals — the taxonomy
(tpu_nexus_torch.supervisor.taxonomy) covers every failure class that emits a k8s
event, but "nothing happened" never emits one:

* RUNNING sweep — a hung workload (deadlocked collective, stuck data
  loader, the ``hang`` fault mode in tpu_nexus_torch.workload.faults) keeps its
  pod Running and its ledger row RUNNING forever.  Workloads heartbeat
  ``per_chip_steps`` (and column writes bump ``last_modified``), so a
  RUNNING row whose progress fingerprint is frozen beyond a window is hung
  → ``ToFailStuckInRunning``.  The reference's nearest analogue is
  stuck-in-pending (services/supervisor.go:172-182).
* PREEMPTED sweep — the restart policy axis deliberately does NOT delete a
  preempted JobSet (restart-from-step, SURVEY §7.4), betting the JobSet
  controller recreates the children.  Nothing watches the other side of
  that bet: if the controller never comes back (CRD controller down, quota
  gone, node pool deleted) the row would sit PREEMPTED forever.  A
  PREEMPTED row whose fingerprint (stage/restart_count/generation) is
  frozen beyond the restart deadline escalates → ``ToFailRestartStalled``
  (terminal, deletes the wedged JobSet).  The reference cannot wedge —
  every failure decision deletes and writes a terminal stage
  (services/supervisor.go:283-360) — and the restart axis must not regress
  that guarantee.

The PREEMPTED sweep additionally polices the *checkpoint* side of the
restart bet: a row whose ``tensor_checkpoint_uri`` fails manifest
verification (torn save at preemption time, bit rot while parked) is
restart-from-PREVIOUS-step material, not a crash loop — the sweep repoints
the URI at the newest step that verifies (``resolve_verified_uri``,
tpu_nexus_torch.workload.durability) so the restarted workload and every operator
dashboard see a pointer that is actually restorable.  The workload's own
restore path would roll back anyway; the rewrite makes the ledger honest
*before* the restart.  A verify is a full re-hash of the step, paid every
sweep per parked row — production wiring passes
``durability.CachingUriResolver`` so a verified URI costs one ``stat`` on
subsequent sweeps.  The rewrite
deliberately does NOT touch the restart fingerprint columns, so it never
re-arms the restart deadline.

Staleness is judged by *fingerprint change observed by this process*
(monotonic clock), not by comparing wall-clock columns — workload hosts and
the supervisor need not share a clock, and ``merge_chip_steps`` deliberately
does not touch ``last_modified``.  A supervisor restarted mid-incident
starts its deadline over (first observation at first sweep), which delays
but never loses the escalation.

Flagged runs flow through the supervisor's normal commit path (stage
partial order, CAS, job delete, trace, latency metric) on the failure lane.

A copy of ``tpu_nexus/supervisor/watchdog.py``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, Optional, Tuple

from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics, VLogger, get_logger
from tpu_nexus_torch.supervisor.taxonomy import (
    DecisionAction,
    MSG_RESTART_STALLED,
    MSG_STUCK_IN_RUNNING,
    RunStatusAnalysisResult,
)


@dataclass
class _Observation:
    fingerprint: Tuple
    since: float  # monotonic timestamp when this fingerprint was first seen


class StalenessTracker:
    """Fingerprint-staleness bookkeeping shared by absence-driven sweeps:
    this watchdog's RUNNING/PREEMPTED sweeps and the serving-fleet
    controller's missing-pod sweep (serving/fleet.py).  The
    contract is the module-doc staleness rule in one reusable piece:
    staleness is *this process's monotonic observation* of an unchanged
    fingerprint — never a wall-clock column comparison — so a restarted
    observer starts its deadlines over (delayed, never lost)."""

    def __init__(self) -> None:
        self.entries: Dict[Any, _Observation] = {}

    def observe(self, key: Any, fingerprint: Tuple, now: float) -> Optional[float]:
        """Record ``key``'s fingerprint at ``now``; returns how long it has
        been UNCHANGED, or None when it just changed (timer restarted)."""
        obs = self.entries.get(key)
        if obs is None or obs.fingerprint != fingerprint:
            self.entries[key] = _Observation(fingerprint=fingerprint, since=now)
            return None
        return now - obs.since

    def forget(self, key: Any) -> None:
        """Drop ``key`` (a decision now owns it, or it left the swept set)
        — the next observation starts a fresh timer."""
        self.entries.pop(key, None)

    def retain(self, live_keys) -> None:
        """Forget every key not in ``live_keys`` so rows/pods that left the
        swept universe cannot pin entries for the process lifetime."""
        live = set(live_keys)
        for key in list(self.entries):
            if key not in live:
                del self.entries[key]


class HeartbeatWatchdog:
    """Periodic sweep over RUNNING and PREEMPTED ledger rows; emits
    stuck-in-running / restart-stalled decisions for rows whose fingerprint
    stalls past the respective window."""

    def __init__(
        self,
        store: CheckpointStore,
        enqueue: Callable[[RunStatusAnalysisResult], None],
        stale_after: Optional[timedelta] = None,
        interval: timedelta = timedelta(seconds=30),
        first_progress_grace: Optional[timedelta] = None,
        restart_deadline: Optional[timedelta] = None,
        kind_resolver: Optional[Callable[[str], str]] = None,
        logger: Optional[VLogger] = None,
        metrics: Optional[Metrics] = None,
        resolve_verified_uri: Optional[Callable[[str], Optional[str]]] = None,
    ) -> None:
        if stale_after is None and restart_deadline is None:
            raise ValueError(
                "watchdog needs stale_after (RUNNING sweep) and/or "
                "restart_deadline (PREEMPTED sweep); omit the watchdog to disable"
            )
        if stale_after is not None and stale_after.total_seconds() <= 0:
            raise ValueError("stale_after must be positive (None disables the RUNNING sweep)")
        if restart_deadline is not None and restart_deadline.total_seconds() <= 0:
            raise ValueError(
                "restart_deadline must be positive (None disables the PREEMPTED sweep)"
            )
        if interval.total_seconds() <= 0:
            raise ValueError("watchdog interval must be positive")
        self._store = store
        self._enqueue = enqueue
        self._stale_after = stale_after.total_seconds() if stale_after is not None else None
        # a run that has never heartbeated may legitimately sit in RUNNING
        # through a long first XLA compile — give it a longer leash before
        # calling it hung (default 3x the steady-state window)
        self._first_progress_grace = (
            first_progress_grace.total_seconds()
            if first_progress_grace is not None
            else 3 * (self._stale_after or 0)
        )
        self._restart_deadline = (
            restart_deadline.total_seconds() if restart_deadline is not None else None
        )
        self._interval = interval.total_seconds()
        self._kind_resolver = kind_resolver or (lambda request_id: "Job")
        self._log = logger or get_logger("tpu_nexus_torch.watchdog")
        self._metrics = metrics or NullMetrics()
        #: checkpoint-pointer verifier for the PREEMPTED sweep: maps a
        #: ``tensor_checkpoint_uri`` to the newest VERIFIED uri under the
        #: same directory (``durability.resolve_verified_uri`` when the
        #: supervisor can reach the checkpoint filesystem; None disables
        #: the rewrite).  The supervisor wires ``durability.
        #: CachingUriResolver`` — the bare function re-checksums the step
        #: on every sweep.
        self._resolve_verified_uri = resolve_verified_uri
        self._tracker = StalenessTracker()
        self.flagged = 0  # observability counter (tests + metrics)
        self.ckpt_rollbacks = 0  # URIs repointed at a previous verified step

    @property
    def _observations(self) -> Dict[Any, _Observation]:
        """The tracker's raw entries (kept under the historical name —
        tests and operators introspect it)."""
        return self._tracker.entries

    @staticmethod
    def _fingerprint(cp) -> Tuple:
        """RUNNING-sweep progress fingerprint: ANY ledger write counts as
        liveness (heartbeats, checkpoint commits, column writes)."""
        steps = tuple(sorted(cp.per_chip_steps.items()))
        return (
            cp.lifecycle_stage,
            steps,
            cp.last_modified,
            cp.tensor_checkpoint_uri,
            cp.restart_count,
            cp.preempted_generation,
        )

    @staticmethod
    def _restart_fingerprint(cp) -> Tuple:
        """PREEMPTED-sweep fingerprint: RESTART signals only.  A draining
        generation's workers keep writing for a while after the preemption
        (late heartbeats flushing, a final checkpoint commit bumping
        last_modified) — none of that means the JobSet controller is
        restarting anything, and folding it in re-armed the restart
        deadline on every stray write, delaying the escalation
        indefinitely on chatty teardowns.  Only a stage change, a counted
        incident (restart_count), or a fresh child generation restarts
        the clock."""
        return (
            cp.lifecycle_stage,
            cp.restart_count,
            cp.preempted_generation,
        )

    def _flag(self, cp, action: str, message: str, trace: str, counter: str) -> None:
        self._metrics.count(counter)
        self.flagged += 1
        self._enqueue(
            RunStatusAnalysisResult(
                action=action,
                algorithm_name=cp.algorithm,
                request_id=cp.id,
                run_status_message=message,
                run_status_trace=trace,
                object_kind=self._kind_resolver(cp.id),
                object_name=cp.id,
                detected_at=time.perf_counter(),
            )
        )

    async def sweep(self, now: Optional[float] = None) -> None:
        """One pass; test-callable without the loop."""
        now = time.monotonic() if now is None else now
        live_keys = set()

        if self._stale_after is not None:
            rows = await asyncio.to_thread(self._store.query_by_stage, LifecycleStage.RUNNING)
            for cp in rows:
                key = (cp.algorithm, cp.id)
                live_keys.add(key)
                stalled_for = self._tracker.observe(key, self._fingerprint(cp), now)
                if stalled_for is None:
                    continue
                window = self._stale_after if cp.per_chip_steps else self._first_progress_grace
                if stalled_for < window:
                    continue
                self._log.info(
                    "run heartbeat stale; flagging stuck-in-running",
                    algorithm=cp.algorithm,
                    request_id=cp.id,
                    stalled_seconds=round(stalled_for, 1),
                )
                self._flag(
                    cp,
                    DecisionAction.TO_FAIL_STUCK_IN_RUNNING,
                    MSG_STUCK_IN_RUNNING,
                    (
                        f"no ledger progress for {stalled_for:.1f}s "
                        f"(window {window:.1f}s); "
                        f"per_chip_steps={dict(cp.per_chip_steps)!r}"
                    ),
                    "watchdog_stale_runs",
                )
                # the decision owns the run now; if its commit fails the actor
                # retries — re-observing from scratch would double-flag
                self._tracker.forget(key)

        if self._restart_deadline is not None:
            rows = await asyncio.to_thread(self._store.query_by_stage, LifecycleStage.PREEMPTED)
            for cp in rows:
                key = (cp.algorithm, cp.id)
                live_keys.add(key)
                await self._repoint_unverifiable_checkpoint(cp)
                stalled_for = self._tracker.observe(
                    key, self._restart_fingerprint(cp), now
                )
                if stalled_for is None:
                    continue
                if stalled_for < self._restart_deadline:
                    continue
                self._log.info(
                    "preempted run never restarted; escalating to terminal",
                    algorithm=cp.algorithm,
                    request_id=cp.id,
                    stalled_seconds=round(stalled_for, 1),
                    restart_count=cp.restart_count,
                )
                self._flag(
                    cp,
                    DecisionAction.TO_FAIL_RESTART_STALLED,
                    MSG_RESTART_STALLED,
                    (
                        f"run preempted (restart_count={cp.restart_count}, "
                        f"generation={cp.preempted_generation or 'unknown'}) but the "
                        f"JobSet controller produced no replacement generation and no "
                        f"RUNNING transition for {stalled_for:.1f}s "
                        f"(restart deadline {self._restart_deadline:.1f}s) — the "
                        "controller never restarted the run"
                    ),
                    "watchdog_restart_stalled_runs",
                )
                self._tracker.forget(key)

        # forget rows that left the swept stages (completed/failed/cancelled,
        # or resumed RUNNING while the RUNNING sweep is disabled)
        self._tracker.retain(live_keys)

    async def _repoint_unverifiable_checkpoint(self, cp) -> None:
        """Restart path, checkpoint side: a PREEMPTED row whose published
        ``tensor_checkpoint_uri`` fails manifest verification gets repointed
        at the newest step that DOES verify (restart-from-previous-step),
        instead of letting the restart land on a pointer we already know is
        garbage.  When nothing verifies the pointer is left alone — the
        restarted workload starts fresh and reports its own rollback.  The
        restart fingerprint (stage/restart_count/generation) is untouched,
        so the rewrite never re-arms the restart deadline."""
        if self._resolve_verified_uri is None or not cp.tensor_checkpoint_uri:
            return
        resolved = await asyncio.to_thread(
            self._resolve_verified_uri, cp.tensor_checkpoint_uri
        )
        if resolved is None or resolved == cp.tensor_checkpoint_uri:
            return
        # compare-and-set, not update_fields: the verify above can take
        # seconds on a large checkpoint, and the restarted workload may have
        # published a NEWER verified uri meanwhile — a blind write would
        # roll the ledger backwards.  Expecting the snapshot's uri AND the
        # PREEMPTED stage makes a lost race a silent no-op (the next sweep
        # re-reads fresh state).
        applied = await asyncio.to_thread(
            self._store.compare_and_set,
            cp.algorithm,
            cp.id,
            {
                "tensor_checkpoint_uri": cp.tensor_checkpoint_uri,
                "lifecycle_stage": LifecycleStage.PREEMPTED,
            },
            {
                "tensor_checkpoint_uri": resolved,
                "last_modified": datetime.now(timezone.utc),
            },
        )
        if not applied:
            return
        self._log.info(
            "preempted run's checkpoint uri failed verification; "
            "repointed at previous verified step",
            algorithm=cp.algorithm,
            request_id=cp.id,
            bad_uri=cp.tensor_checkpoint_uri,
            verified_uri=resolved,
        )
        self._metrics.count("watchdog_ckpt_rollbacks")
        self.ckpt_rollbacks += 1
        cp.tensor_checkpoint_uri = resolved

    async def run(self, ctx: LifecycleContext) -> None:
        """Sweep every interval until the lifecycle context cancels."""
        while not ctx.cancelled:
            try:
                await self.sweep()
            except Exception:  # noqa: BLE001 - the watchdog must outlive hiccups
                self._log.exception("watchdog sweep failed; will retry")
            try:
                await asyncio.wait_for(ctx.wait(), timeout=self._interval)
            except asyncio.TimeoutError:
                continue
