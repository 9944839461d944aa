"""The supervision service (a copy of ``tpu_nexus/supervisor/service.py``).

Equivalent of reference services/supervisor.go (SURVEY.md §2.1 "the core"):
informer setup, event filtering, failure classification, and decision
execution against the k8s API + checkpoint ledger.

Data flow (SURVEY §1): k8s watch -> informer cache -> on_event
classification -> rate-limited actor queue -> supervise_action ->
{Job delete (background propagation), ledger upsert}.

Design deltas from the reference, all TPU-motivated:
  * a JobSet informer joins Event/Pod/Job — multi-host TPU runs are JobSets;
  * two actor lanes: failure decisions ride an unthrottled fast lane so the
    fault-detect -> checkpoint-commit p50 stays <5s under a 16-host event
    storm, while info decisions (ToRunning) take the reference's
    rate-limited lane (SURVEY §7.4 "latency budget");
  * restartable preemption (ToPreemptRestartable) records PREEMPTED +
    restart_count without deleting the JobSet — restart-from-step instead of
    the reference's always-delete (SURVEY §7.4 "JobSet restart vs delete");
  * ledger writes run in a worker thread (asyncio loop stays responsive).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Dict, Optional

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_LABEL_SERVING_FLEET,
    CheckpointedRequest,
    LifecycleStage,
)
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.core.pipeline import PipelineStageActor
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import Metrics, NullMetrics, VLogger, get_logger
from tpu_nexus_torch.core.util import coalesce
from tpu_nexus_torch.k8s.client import KubeClient, NotFoundError
from tpu_nexus_torch.k8s.informer import SharedInformerFactory
from tpu_nexus_torch.k8s.objects import EventObj
from tpu_nexus_torch.supervisor import resolvers
from tpu_nexus_torch.supervisor.taxonomy import (
    DECISION_STAGE,
    DELETES_JOB,
    MSG_DEADLINE_EXCEEDED,
    DecisionAction,
    RunStatusAnalysisResult,
    _pod_termination_text,
    _tpu_message,
    classify_event,
    classify_tpu_failure,
    extract_hlo_trace_ref,
)

DEFAULT_RESYNC = timedelta(seconds=30)  # reference services/supervisor.go:70


class _RunLock:
    """Per-run lock entry with an explicit holder/waiter refcount, so
    eviction never has to introspect private asyncio.Lock attributes."""

    __slots__ = ("lock", "refs")

    def __init__(self) -> None:
        self.lock = asyncio.Lock()
        self.refs = 0


@dataclass
class ProcessingConfig:
    """Actor knobs (reference ProcessingConfig, services/supervisor.go:41-47;
    defaults from .helm/values.yaml:141-161)."""

    failure_rate_base_delay: timedelta = timedelta(milliseconds=100)
    failure_rate_max_delay: timedelta = timedelta(seconds=1)
    rate_limit_elements_per_second: float = 10.0
    rate_limit_elements_burst: int = 100
    workers: int = 2
    #: TPU extension: failure decisions bypass the token bucket (0 = no
    #: limit) so detection latency is not rate-limiter-bound
    failure_lane_rate_per_second: float = 0.0
    failure_lane_workers: int = 4
    #: TPU extension: flag RUNNING rows whose ledger progress fingerprint
    #: (per_chip_steps / last_modified) stalls past this window as hung
    #: (ToFailStuckInRunning).  None/0 disables the RUNNING sweep.
    heartbeat_stale_after: Optional[timedelta] = None
    watchdog_interval: timedelta = timedelta(seconds=30)
    #: TPU extension: a PREEMPTED row with no replacement generation (no
    #: restart_count/generation change, no RUNNING transition) within this
    #: deadline escalates to terminal DEADLINE_EXCEEDED and the wedged
    #: JobSet is deleted (ToFailRestartStalled) — the restart axis must not
    #: be able to wedge a run forever when the JobSet controller never
    #: recreates the children.  None/0 disables the PREEMPTED sweep.
    preempted_restart_deadline: Optional[timedelta] = None
    #: leash for runs that have never heartbeated (long first XLA compile);
    #: None = 3x the stale window
    watchdog_first_progress_grace: Optional[timedelta] = None
    #: preemption events landing on an already-PREEMPTED run within this
    #: window of its last ledger write are the same incident's multi-host
    #: fan-out (suppressed); outside it they count as a NEW preemption (the
    #: replacement pod reclaimed before the workload ever heartbeated)
    preemption_dedup_window: timedelta = timedelta(seconds=30)
    #: TPU extension: the PREEMPTED sweep verifies each row's
    #: ``tensor_checkpoint_uri`` manifest and repoints an unverifiable one
    #: at the newest verified step (workload.durability, docs/CHECKPOINTS.md).
    #: No-op when the supervisor cannot reach the checkpoint filesystem
    #: (verification classifies as missing and leaves the row alone); turn
    #: off only to skip the per-sweep checksum cost on reachable multi-GB
    #: checkpoints.
    watchdog_verify_checkpoints: bool = True


class Supervisor:
    """The janitor/arbiter: watches run resources, classifies failures,
    executes decisions."""

    def __init__(
        self,
        kube_client: KubeClient,
        cql_store: CheckpointStore,
        resource_namespace: str,
        logger: Optional[VLogger] = None,
        metrics: Optional[Metrics] = None,
        resync_period: Optional[timedelta] = None,
        sync_state=None,
        watch_jobsets: bool = True,
    ) -> None:
        self._client = kube_client
        self._store = cql_store
        self.namespace = resource_namespace
        self._log = logger or get_logger("tpu_nexus_torch.supervisor")
        self._metrics = metrics or NullMetrics()
        self._sync_state = sync_state
        # informer factory + informers, not started yet (reference
        # NewSupervisor, services/supervisor.go:69-103)
        self._factory = SharedInformerFactory(
            kube_client,
            resource_namespace,
            resync_period=coalesce(resync_period, DEFAULT_RESYNC),
            logger=self._log,
        )
        kinds = ["Event", "Pod", "Job"] + (["JobSet"] if watch_jobsets else [])
        for kind in kinds:
            self._factory.informer_for(kind)
        self._actor: Optional[PipelineStageActor] = None
        self._fail_actor: Optional[PipelineStageActor] = None
        self.watchdog = None  # built in init() when the stale window is set
        # per-run serialization: a 16-host event storm produces N concurrent
        # decisions for one run; first-writer-wins requires the guard-read and
        # the commit to be atomic per (algorithm, id) (SURVEY §7.4)
        self._run_locks: Dict[tuple, _RunLock] = {}
        # per-run monotonic timestamp of the last COUNTED preemption commit.
        # The dedup decision must not depend on workload-written wall clocks
        # (`last_modified` comes from the run hosts' clocks; a future-skewed
        # host would suppress a genuine second preemption) — same reasoning
        # as the watchdog's monotonic-only staleness rule (watchdog.py).
        self._preempt_seen: Dict[tuple, float] = {}
        # observability counters (tests + metrics)
        self.events_seen = 0
        self.events_filtered = 0
        #: serving-fleet events dropped HERE by design: pod-level
        #: serving failures belong to the fleet controller
        #: (serving/fleet.py), and this supervisor acting on them too would
        #: double-supervise one pod — delete a JobSet the fleet is about to
        #: heal, or write a terminal stage over a row the fleet keeps alive
        self.events_delegated = 0
        self.decisions_enqueued = 0
        self.decisions_executed = 0
        self.commit_latencies: deque = deque(maxlen=2048)

    # -- wiring (reference Init, services/supervisor.go:106-135) -------------

    def init(self, config: ProcessingConfig) -> None:
        self._preempt_dedup_s = config.preemption_dedup_window.total_seconds()
        self._actor = PipelineStageActor(
            "run_status_analysis",
            tags={"namespace": self.namespace},
            failure_base_delay=config.failure_rate_base_delay,
            failure_max_delay=config.failure_rate_max_delay,
            rate_per_second=config.rate_limit_elements_per_second,
            burst=config.rate_limit_elements_burst,
            workers=config.workers,
            process_fn=self._supervise_action,
            metrics=self._metrics,
            logger=self._log,
        )
        self._fail_actor = PipelineStageActor(
            "run_failure_fast_lane",
            tags={"namespace": self.namespace},
            failure_base_delay=config.failure_rate_base_delay,
            failure_max_delay=config.failure_rate_max_delay,
            rate_per_second=config.failure_lane_rate_per_second,
            burst=config.rate_limit_elements_burst,
            workers=config.failure_lane_workers,
            process_fn=self._supervise_action,
            metrics=self._metrics,
            logger=self._log,
        )
        # handler on the Event informer only; pods/jobs/jobsets informers are
        # lookup caches (reference services/supervisor.go:124-128)
        self._factory.informer_for("Event").add_event_handler(self._on_event)
        stale = config.heartbeat_stale_after
        if stale is not None and stale.total_seconds() <= 0:
            stale = None
        deadline = config.preempted_restart_deadline
        if deadline is not None and deadline.total_seconds() <= 0:
            deadline = None
        if stale is not None or deadline is not None:
            from tpu_nexus_torch.supervisor.watchdog import HeartbeatWatchdog

            resolver = None
            if config.watchdog_verify_checkpoints:
                # stdlib-only import (durability's contract; workload/__init__
                # resolves its jax-heavy exports lazily so this stays cheap).
                # Caching wrapper, not the bare function: the sweep re-checks
                # every PREEMPTED row every interval, and an uncached deep
                # verify re-hashes the full checkpoint each time
                from tpu_nexus_torch.workload.durability import CachingUriResolver

                resolver = CachingUriResolver()
            self.watchdog = HeartbeatWatchdog(
                self._store,
                enqueue=self._fail_actor.receive,
                stale_after=stale,
                interval=config.watchdog_interval,
                first_progress_grace=config.watchdog_first_progress_grace,
                restart_deadline=deadline,
                kind_resolver=self._resolve_run_kind,
                logger=self._log,
                metrics=self._metrics,
                resolve_verified_uri=resolver,
            )

    def _is_same_preemption(self, key: tuple) -> bool:
        """Already-PREEMPTED run: is this event the same incident's multi-host
        fan-out, or a new preemption?

        Judged purely from this supervisor's monotonic clock at the moment it
        COUNTED the last preemption for this run (`_preempt_seen`) — never
        from ledger `last_modified`, which workload hosts write from their
        own wall clocks.  No recorded commit (e.g. the row was PREEMPTED by a
        previous supervisor process) => a new incident; it is counted, which
        at worst over-counts one restart across a supervisor restart rather
        than suppressing a real preemption indefinitely."""
        seen = self._preempt_seen.get(key)
        if seen is None:
            return False
        if (time.monotonic() - seen) >= self._preempt_dedup_s:
            # outside the window the record is dead weight — prune on consult
            del self._preempt_seen[key]
            return False
        return True

    def _record_preemption(self, key: tuple) -> None:
        now = time.monotonic()
        # opportunistic sweep: entries older than the window can never
        # suppress anything, so a run abandoned without a terminal decision
        # must not pin its entry for the process lifetime
        if len(self._preempt_seen) > 1024:
            stale = [k for k, t in self._preempt_seen.items() if now - t >= self._preempt_dedup_s]
            for k in stale:
                del self._preempt_seen[k]
        self._preempt_seen[key] = now

    def _resolve_run_kind(self, request_id: str) -> str:
        """JobSet when the run's resource is a cached JobSet, else Job —
        decides which resource a watchdog-initiated delete targets."""
        jobsets = self._factory.informers.get("JobSet")
        if jobsets is not None and jobsets.get(request_id) is not None:
            return "JobSet"
        return "Job"

    def _jobset_max_restarts(self, request_id: str) -> Optional[int]:
        """The run's composed ``failurePolicy.maxRestarts`` from the cached
        JobSet spec, or None for plain-Job runs (no controller restart
        budget).  The ledger must not advertise restarts the controller
        will never perform."""
        informer = self._factory.informers.get("JobSet")
        jobset = informer.get(request_id) if informer is not None else None
        if jobset is None:
            return None
        policy = (jobset.raw.get("spec") or {}).get("failurePolicy") or {}
        try:
            return int(policy["maxRestarts"])
        except (KeyError, TypeError, ValueError):
            return None

    # -- hot loop (reference onEvent, services/supervisor.go:137-258) --------

    def _on_event(self, event_type: str, event: EventObj) -> None:
        if event_type != "ADDED":
            return  # AddFunc-only registration parity
        detected_at = time.perf_counter()
        self.events_seen += 1
        if not event.meta.name:
            return  # sanity check (reference :139)
        informers = self._factory.informers
        # ONE ownership-chain walk decides both questions (hot path: every
        # watch event lands here)
        component = resolvers.event_component(event, self.namespace, informers)
        if component == JOB_LABEL_SERVING_FLEET:
            # division of labor: serving-fleet pods are the fleet
            # controller's to heal (recreate / reduced-KV / escalate), never
            # this supervisor's to terminate — counted separately so a
            # dashboard can tell delegation from noise
            self.events_delegated += 1
            self._metrics.count("events_delegated_to_fleet")
            self._log.v(2).info(
                "delegating serving-fleet event to the fleet controller",
                event=event.meta.name,
                reason=event.reason,
            )
            return
        if component != JOB_LABEL_ALGORITHM_RUN:
            self.events_filtered += 1
            self._log.v(4).info(
                "dropping non-nexus event", event=event.meta.name, reason=event.reason
            )
            return
        result = classify_event(event, self.namespace, informers, detected_at=detected_at)
        if result is None:
            self._log.v(1).info(
                "event classified as no-op",
                reason=event.reason,
                object_kind=event.involved_object.kind,
                object_name=event.involved_object.name,
            )
            return
        self._log.info(
            "decision made",
            decision=result.action,
            algorithm=result.algorithm_name,
            request_id=result.request_id,
            object_kind=result.object_kind,
        )
        self._metrics.count("decisions", tags={"action": result.action})
        self.decisions_enqueued += 1
        lane = self._fail_actor if result.action in DELETES_JOB or result.action == DecisionAction.TO_PREEMPT_RESTARTABLE else self._actor
        lane.receive(result)

    # -- decision execution (reference superviseAction,
    #    services/supervisor.go:261-374) --------------------------------------

    async def _supervise_action(self, result: RunStatusAnalysisResult) -> RunStatusAnalysisResult:
        key = (result.algorithm_name, result.request_id)
        entry = self._run_locks.get(key)
        if entry is None:
            entry = self._run_locks[key] = _RunLock()
        entry.refs += 1  # holder-or-waiter count, maintained by us alone
        try:
            async with entry.lock:
                return await self._supervise_action_locked(result, key)
        finally:
            # evict the entry when the last holder/waiter leaves, so per-run
            # state does not accumulate over the supervisor's lifetime; a
            # later decision simply creates a fresh lock.  Refcount is ours
            # (no private asyncio.Lock attributes), so a stdlib change cannot
            # turn this into a use-after-evict race.
            entry.refs -= 1
            if entry.refs == 0 and self._run_locks.get(key) is entry:
                del self._run_locks[key]

    def _reenrich(self, result: RunStatusAnalysisResult) -> RunStatusAnalysisResult:
        """Upgrade a generic pod-failure decision using the freshest cached
        pod state.  Event delivery races the Pod informer: a `Failed` event
        often arrives before the cache sees the terminated container status
        that carries the TPU failure signature.  By decision-execution time
        (post queue) the cache has usually caught up — re-check it."""
        if result.object_kind != "Pod" or result.action not in (
            DecisionAction.TO_FAIL_STUCK_IN_PENDING,
            DecisionAction.TO_FAIL_FATAL_ERROR,
        ):
            return result
        informer = self._factory.informers.get("Pod")
        pod = informer.get(result.object_name) if informer is not None else None
        if pod is None:
            return result
        term_text = _pod_termination_text(pod)
        if term_text and term_text not in result.run_status_trace:
            text = f"{result.run_status_trace}\n{term_text}".strip()
        else:
            text = result.run_status_trace  # idempotent across re-deliveries
        tpu_action = classify_tpu_failure(text)
        if tpu_action is None:
            if text != result.run_status_trace:
                result.run_status_trace = text  # richer trace, same decision
            return result
        self._log.info(
            "decision upgraded from fresh pod state",
            previous=result.action,
            upgraded=tpu_action,
            request_id=result.request_id,
        )
        result.action = tpu_action
        result.run_status_message = _tpu_message(tpu_action)
        result.run_status_trace = text
        result.hlo_trace_ref = extract_hlo_trace_ref(text) or result.hlo_trace_ref
        return result

    def _is_duplicate_incident(
        self,
        result: RunStatusAnalysisResult,
        observed: CheckpointedRequest,
        key: tuple,
        first_restart_count: int,
    ) -> bool:
        """Is this preemption event a duplicate of an already-counted
        incident?  Three wall-clock-free signals, any of which suffices:

        (a) generation fence: the event's pod belongs to a child-Job
            generation whose preemption is already recorded in the ledger —
            the same incident no matter WHICH replica recorded it or what
            stage the row has since moved to;
        (b) this process's own monotonic record (same-process fan-out when
            no generation uid was resolvable);
        (c) the row's restart_count grew since this decision first read it —
            a concurrent writer (another replica) counted the incident
            between our read and our CAS."""
        if result.generation_uid and observed.preempted_generation == result.generation_uid:
            return True
        if observed.lifecycle_stage == LifecycleStage.PREEMPTED and self._is_same_preemption(key):
            return True
        return observed.restart_count > first_restart_count

    async def _supervise_action_locked(
        self, result: RunStatusAnalysisResult, key: tuple
    ) -> RunStatusAnalysisResult:
        result = self._reenrich(result)
        observed = await asyncio.to_thread(
            self._store.read_checkpoint, result.algorithm_name, result.request_id
        )
        if observed is None:
            # missing metadata: delete the Job anyway (background propagation)
            # and raise — the actor re-delivers with backoff (reference
            # :265-273)
            await self._delete_run_object(result)
            raise LookupError(
                f"no checkpoint for run {result.algorithm_name}/{result.request_id}; "
                "job deleted, no metadata saved"
            )
        first_restart_count = observed.restart_count

        # Commit via compare-and-set on the observed row state (CQL LWT in
        # production): two supervisor replicas observing one storm cannot
        # double-apply a transition — the loser's CAS fails, it re-reads, and
        # the guards re-decide against the fresh row.
        for _attempt in range(4):
            if observed.is_finished():
                # protects cancelled/finished runs from late events
                # (reference :275-279); also the exactly-once terminal seam:
                # the replica that lost the terminal CAS lands here
                self._log.v(1).info(
                    "run already finished; skipping",
                    request_id=result.request_id,
                    stage=observed.lifecycle_stage,
                )
                self._preempt_seen.pop(key, None)
                return result

            if result.action == DecisionAction.TO_PREEMPT_RESTARTABLE and not (
                self._is_duplicate_incident(result, observed, key, first_restart_count)
            ):
                # a NEW preemption incident against a spent JobSet restart
                # budget cannot restart — the controller fails the JobSet at
                # maxRestarts, so recording another PREEMPTED would advertise
                # a restart that will never happen; escalate to the
                # reference's retry-exhausted terminal stage instead.
                # Same-incident duplicates are exempt: the Nth host's event
                # for restart N must not escalate.
                # Budget source of truth: the ledger row (persisted at launch
                # — survives supervisor restarts and JobSet deletion); the
                # informer-cache lookup only covers pre-upgrade rows.
                budget = (
                    observed.max_restarts
                    if observed.max_restarts is not None
                    else self._jobset_max_restarts(result.request_id)
                )
                if budget is not None and observed.restart_count >= budget:
                    self._log.info(
                        "restart budget exhausted; escalating preemption to terminal",
                        request_id=result.request_id,
                        restart_count=observed.restart_count,
                        max_restarts=budget,
                    )
                    result.action = DecisionAction.TO_FAIL_DEADLINE_EXCEEDED
                    result.run_status_message = MSG_DEADLINE_EXCEEDED
                    result.run_status_trace = (
                        f"{result.run_status_trace}\n"
                        f"restart budget exhausted: {observed.restart_count} restarts "
                        f"recorded >= JobSet failurePolicy.maxRestarts={budget}; the "
                        "controller will not restart this run again"
                    ).strip()

            stage = DECISION_STAGE[result.action]
            if not LifecycleStage.can_transition(observed.lifecycle_stage, stage):
                # stage partial order (first-writer-wins generalization of
                # the IsFinished guard, SURVEY §7.4): e.g. a stale queued
                # decision must not regress RUNNING to a pre-run stage
                self._log.v(1).info(
                    "transition refused by stage partial order",
                    request_id=result.request_id,
                    current=observed.lifecycle_stage,
                    requested=stage,
                )
                return result

            fields: Dict[str, object] = {
                "lifecycle_stage": stage,
                "last_modified": datetime.now(timezone.utc),
            }
            expected: Dict[str, object] = {"lifecycle_stage": observed.lifecycle_stage}
            if result.action in DELETES_JOB:
                # delete BEFORE the ledger write (reference order :289→:301);
                # idempotent across CAS retries (NotFound passes)
                await self._delete_run_object(result)
                fields["algorithm_failure_cause"] = result.run_status_message
                fields["algorithm_failure_details"] = result.run_status_trace
            elif result.action == DecisionAction.TO_PREEMPT_RESTARTABLE:
                # TPU policy axis: no delete — record preemption and let the
                # JobSet restart policy / launcher resume from the tensor
                # checkpoint (SURVEY §7.4).
                if self._is_duplicate_incident(result, observed, key, first_restart_count):
                    # one incident fans out to N hosts' events (and to every
                    # replica); counting each would inflate restart_count
                    self._log.v(1).info(
                        "duplicate preemption event; incident already counted",
                        request_id=result.request_id,
                    )
                    return result
                fields["algorithm_failure_cause"] = result.run_status_message
                fields["algorithm_failure_details"] = result.run_status_trace
                fields["restart_count"] = observed.restart_count + 1
                if result.generation_uid:
                    fields["preempted_generation"] = result.generation_uid
                expected["restart_count"] = observed.restart_count
            # else ToRunning: stage only
            if result.hlo_trace_ref:
                fields["hlo_trace_ref"] = result.hlo_trace_ref

            committed = await asyncio.to_thread(
                self._store.compare_and_set,
                result.algorithm_name,
                result.request_id,
                expected,
                fields,
            )
            if committed:
                if LifecycleStage.is_terminal(stage):
                    # run just went terminal: drop its preemption-dedup
                    # record too, or every preempted-then-terminated run
                    # would leak one entry for the supervisor's lifetime
                    self._preempt_seen.pop(key, None)
                if result.action == DecisionAction.TO_PREEMPT_RESTARTABLE:
                    # record the COUNTED preemption only after the commit
                    # landed — a failed commit is re-evaluated and must not
                    # be suppressed as its own duplicate
                    self._record_preemption(key)
                self.decisions_executed += 1
                if result.detected_at:
                    latency = time.perf_counter() - result.detected_at
                    self.commit_latencies.append(latency)
                    self._metrics.timing(
                        "detect_to_commit_seconds", latency, tags={"action": result.action}
                    )
                # durable export of the north-star percentile (SURVEY §6:
                # p50 <5s): gauges every 16th decision so the number lives in
                # the metrics plane, not only in this process's deque.
                # Outside the detected_at gate — watchdog/resync decisions
                # without a detect timestamp must not swallow export slots.
                if self.decisions_executed % 16 == 0 and self.commit_latencies:
                    summary = self.latency_summary()
                    self._metrics.gauge("detect_to_commit_p50_seconds", summary["p50"])
                    self._metrics.gauge("detect_to_commit_p95_seconds", summary["p95"])
                return result

            self._log.v(1).info(
                "ledger CAS conflict; re-reading",
                request_id=result.request_id,
                expected_stage=expected["lifecycle_stage"],
            )
            self._metrics.count("ledger_cas_conflicts", tags={"action": result.action})
            observed = await asyncio.to_thread(
                self._store.read_checkpoint, result.algorithm_name, result.request_id
            )
            if observed is None:
                raise LookupError(
                    f"checkpoint for {result.algorithm_name}/{result.request_id} "
                    "disappeared during CAS retry"
                )
        raise RuntimeError(
            f"ledger CAS conflict persisted after 4 attempts for "
            f"{result.algorithm_name}/{result.request_id}"
        )  # actor re-delivers with backoff

    def latency_summary(self) -> Dict[str, float]:
        """Percentiles of the detect→commit window over the rolling deque."""
        lat = sorted(self.commit_latencies)
        if not lat:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "max": 0.0}
        import math

        return {
            "count": len(lat),
            "p50": lat[len(lat) // 2],
            # nearest-rank: ceil(0.95 n) - 1; int(0.95 n) overshoots by one
            # and reads as max for any window of <= 20 samples
            "p95": lat[max(0, math.ceil(len(lat) * 0.95) - 1)],
            "max": lat[-1],
        }

    async def _delete_run_object(self, result: RunStatusAnalysisResult) -> None:
        """Delete the run's Job or JobSet with background propagation;
        NotFound is fine (already gone).

        The run id always names the TOP-LEVEL resource: for JobSet-launched
        runs, pod/child-job events resolve their run id via the jobset-name
        backlink, so the delete must target the owning JobSet — deleting the
        child Job `{run}-workers-0` would just make the JobSet controller
        recreate it (or worse, count it against the failure policy).
        _resolve_run_kind covers JobSet-kind results too: their JobSet was
        in the informer cache at classification time."""
        kind = self._resolve_run_kind(result.request_id)
        try:
            await self._client.delete_object(kind, self.namespace, result.request_id)
        except NotFoundError:
            pass

    # -- lifecycle (reference Start, services/supervisor.go:376-388) ---------

    async def start(self, ctx: LifecycleContext) -> None:
        """Blocks for the process lifetime: runs the actors; informers start
        in post_start, then cache sync (reference :377-384)."""
        if self._actor is None or self._fail_actor is None:
            raise RuntimeError("Supervisor.init(config) must be called before start")

        async def post_start() -> None:
            # start lookup caches (Pod/Job/JobSet) first and wait for their
            # sync, THEN the Event informer — otherwise initial events race
            # the caches and get dropped via the stale path (a startup race
            # the reference inherits from client-go; fixed by ordering here)
            lookup_kinds = [k for k in self._factory.informers if k != "Event"]
            self._factory.start(ctx, kinds=lookup_kinds)
            synced = await self._factory.wait_for_cache_sync(
                sync_state=self._sync_state, kinds=lookup_kinds
            )
            self._factory.start(ctx, kinds=["Event"])
            synced2 = await self._factory.wait_for_cache_sync(
                sync_state=self._sync_state, kinds=["Event"]
            )
            if not (synced and synced2):
                raise RuntimeError("informer caches failed to sync")
            self._log.info("supervisor started", namespace=self.namespace)

        fail_task = asyncio.create_task(self._fail_actor.start(ctx))
        watchdog_task = (
            asyncio.create_task(self.watchdog.run(ctx)) if self.watchdog is not None else None
        )
        try:
            await self._actor.start(ctx, post_start)
        finally:
            # if we are exiting for any reason (including a post_start
            # failure), cancel the lifecycle context so the fail lane and
            # informers unwind instead of deadlocking on ctx.wait()
            ctx.cancel()
            await fail_task
            if watchdog_task is not None:
                await watchdog_task
            await self._factory.shutdown()

    # -- test support ---------------------------------------------------------

    async def idle(self, timeout: float = 10.0) -> bool:
        ok1 = await self._actor.idle(timeout=timeout)
        ok2 = await self._fail_actor.idle(timeout=timeout)
        return ok1 and ok2
