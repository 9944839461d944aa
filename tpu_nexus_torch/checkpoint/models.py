"""Run-metadata model (equivalent of nexus-core pkg/checkpoint/models,
API reconstructed in SURVEY.md §2.3 from reference call sites
services/supervisor.go:276,281,297-299,324-326,349-351,362).

Extensions over the reference schema (north star, BASELINE.json):
  * `hlo_trace_ref` — object-storage ref to an XLA HLO dump / profiler trace
    captured at failure time;
  * `per_chip_steps` — per-chip training step counters heartbeaten by the
    workload harness (keys like "host0/chip2");
  * `tensor_checkpoint_uri` — last committed Orbax tensor checkpoint, so a
    preempted run can restart-from-step instead of being deleted
    (SURVEY.md §7.4 "JobSet restart vs delete");
  * `restart_count` — how many times the run was restarted after preemption.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Dict, Mapping, Optional


class LifecycleStage:
    """Lifecycle stage string constants.

    Observed in the reference (SURVEY.md §2.2 quirks): BUFFERED (seed),
    RUNNING, CANCELLED, and the written failure stages SCHEDULING_FAILED,
    FAILED, DEADLINE_EXCEEDED.  NEW and COMPLETED round out the receiver->
    scheduler->supervisor lifecycle (the launcher records COMPLETED on
    normal exit, BASELINE.json config #2).
    """

    NEW = "NEW"
    BUFFERED = "BUFFERED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    SCHEDULING_FAILED = "SCHEDULING_FAILED"
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    CANCELLED = "CANCELLED"
    # TPU extension: run was preempted but is restartable from its tensor
    # checkpoint — NOT terminal (the restart policy axis, SURVEY §7.4).
    PREEMPTED = "PREEMPTED"

    #: terminal stages: IsFinished() contract — reference guards late events
    #: on finished runs (services/supervisor.go:275-279)
    TERMINAL = frozenset({COMPLETED, FAILED, SCHEDULING_FAILED, DEADLINE_EXCEEDED, CANCELLED})

    #: partial order rank for first-writer-wins multi-host dedup
    #: (SURVEY §7.4 "multi-host semantics"): a transition may only move to an
    #: equal-or-higher rank; terminal stages are absorbing.  RUNNING and
    #: PREEMPTED share a rank: a preempted run legitimately returns to
    #: RUNNING when its JobSet restarts it (restart-from-step flow).
    _RANK = {
        NEW: 0,
        BUFFERED: 1,
        RUNNING: 2,
        PREEMPTED: 2,
        COMPLETED: 4,
        FAILED: 4,
        SCHEDULING_FAILED: 4,
        DEADLINE_EXCEEDED: 4,
        CANCELLED: 4,
    }

    @classmethod
    def is_terminal(cls, stage: str) -> bool:
        return stage in cls.TERMINAL

    @classmethod
    def can_transition(cls, current: str, new: str) -> bool:
        """First-writer-wins: terminal absorbs; otherwise monotone by rank."""
        if current in cls.TERMINAL:
            return False
        return cls._RANK.get(new, 0) >= cls._RANK.get(current, 0)


# -- label taxonomy (reference: nexus-core models label keys, consumed at
#    services/supervisor.go:147 via IsNexusRunEvent and fixtures
#    services/supervisor_test.go:73-76,246) ------------------------------------

#: marks a k8s object as part of the nexus data plane
NEXUS_COMPONENT_LABEL = "science.sneaksanddata.com/nexus-component"
#: component value for algorithm-run Jobs/Pods
JOB_LABEL_ALGORITHM_RUN = "algorithm-run"
#: component value for SERVING-fleet JobSets/Pods (ISSUE 9): a serving
#: fleet is supervised by the fleet controller (serving/fleet.py —
#: pod-level recreate/rolling-update decisions), NOT by the algorithm-run
#: supervisor (whole-run terminal decisions).  The distinct component
#: value is what keeps the two control loops from double-supervising one
#: pod: ``is_nexus_run_event`` excludes it, ``is_serving_fleet_event``
#: selects it.
JOB_LABEL_SERVING_FLEET = "serving-fleet"
#: carries the algorithm (job template) name on the Job
JOB_TEMPLATE_NAME_KEY = "science.sneaksanddata.com/algorithm-template-name"
#: k8s-standard pod->job backlink; how a pod event maps to its run id
#: (reference services/supervisor_test.go:246)
POD_JOB_NAME_LABEL = "batch.kubernetes.io/job-name"
#: JobSet controller's backlink stamped on child Jobs AND their pods.  For
#: JobSet-launched runs the child Job is named `{run_id}-workers-0`, so the
#: job-name backlink alone resolves a request id with no ledger row — the
#: jobset-name label is the authoritative pod/child-job -> run mapping
#: (generalization of the reference's pod->run backlink,
#: services/supervisor.go:231-251, to the multi-host JobSet shape)
JOBSET_NAME_LABEL = "jobset.sigs.k8s.io/jobset-name"
#: JobSet controller's replicated-job backlink on child Jobs/pods
JOBSET_REPLICATEDJOB_LABEL = "jobset.sigs.k8s.io/replicatedjob-name"


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


@dataclass
class CheckpointedRequest:
    """One run's ledger row; full 19-column record per reference
    test-resources/checkpoints.cql:1-23 plus TPU extension columns."""

    algorithm: str
    id: str
    lifecycle_stage: str = LifecycleStage.NEW
    payload_uri: str = ""
    result_uri: str = ""
    algorithm_failure_cause: str = ""
    algorithm_failure_details: str = ""
    received_by_host: str = ""
    received_at: Optional[datetime] = None
    sent_at: Optional[datetime] = None
    applied_configuration: str = "{}"
    configuration_overrides: str = "{}"
    content_hash: str = ""
    last_modified: Optional[datetime] = None
    tag: str = ""
    api_version: str = "v1"
    job_uid: str = ""
    parent: str = "{}"
    payload_valid_for: str = ""
    # -- TPU-native extensions (north star) --
    hlo_trace_ref: str = ""
    per_chip_steps: Dict[str, int] = field(default_factory=dict)
    tensor_checkpoint_uri: str = ""
    restart_count: int = 0
    #: uid of the child-Job generation whose preemption was last COUNTED —
    #: the JobSet Recreate policy gives every restart a fresh child-Job uid,
    #: so this fences one incident's multi-host event fan-out across
    #: SUPERVISOR REPLICAS without trusting any wall clock: an event whose
    #: pod belongs to an already-recorded generation is the same incident
    preempted_generation: str = ""
    #: the run's JobSet ``failurePolicy.maxRestarts``, persisted at LAUNCH
    #: time — the budget is an immutable spec field, so the supervisor's
    #: budget escalation must not depend on a live informer cache (a
    #: supervisor restarted mid-incident, or a JobSet already deleted,
    #: would otherwise let preemptions count forever).  None for plain-Job
    #: runs (no controller restart budget) and pre-upgrade rows.
    max_restarts: Optional[int] = None

    def is_finished(self) -> bool:
        """True for terminal stages; guards late events on finished runs
        (reference services/supervisor.go:275-279, verified by the CANCELLED
        fixture)."""
        return LifecycleStage.is_terminal(self.lifecycle_stage)

    def deep_copy(self) -> "CheckpointedRequest":
        """Mutation discipline: all writes go through a copy
        (reference services/supervisor.go:281)."""
        return copy.deepcopy(self)

    # -- serialization ------------------------------------------------------

    def to_row(self) -> Dict[str, Any]:
        row = dataclasses.asdict(self)
        for key in ("received_at", "sent_at", "last_modified"):
            if row[key] is not None:
                row[key] = row[key].isoformat()
        row["per_chip_steps"] = json.dumps(row["per_chip_steps"], sort_keys=True)
        return row

    @classmethod
    def from_row(cls, row: Mapping[str, Any]) -> "CheckpointedRequest":
        data = dict(row)
        for key in ("received_at", "sent_at", "last_modified"):
            value = data.get(key)
            if isinstance(value, str) and value:
                data[key] = datetime.fromisoformat(value)
            elif not value:
                data[key] = None
        steps = data.get("per_chip_steps")
        if isinstance(steps, str):
            data["per_chip_steps"] = json.loads(steps) if steps else {}
        elif steps is None:
            data["per_chip_steps"] = {}
        budget = data.get("max_restarts")
        # "" (CQL null → text normalization) and None both mean "no budget";
        # sqlite hands back ints, CQL ints, JSON round-trips may hand strings
        data["max_restarts"] = int(budget) if budget not in (None, "") else None
        count = data.get("restart_count")
        # same string-tolerance for the counter: a TEXT-affinity sqlite
        # column (hand-built ledgers) or JSON round-trip must not leave a
        # str here — restart_count rides CAS `expected` comparisons
        data["restart_count"] = int(count) if count not in (None, "") else 0
        known = {f.name for f in dataclasses.fields(cls)}
        data = {k: v for k, v in data.items() if k in known}
        # SQL NULL (pre-upgrade rows read through a migrated schema) means
        # "column never written": take the field default, except for the
        # genuinely Optional fields where None IS the value
        for key in list(data):
            if data[key] is None and key not in (
                "received_at", "sent_at", "last_modified", "max_restarts",
            ):
                del data[key]
        return cls(**data)

    def touch(self) -> None:
        self.last_modified = _utcnow()
