"""Typed views over Kubernetes API objects: a copy of
``tpu_nexus/k8s/objects.py``.

One conversion point from wire JSON (dicts from the REST client or from the
fake) into small dataclasses the classifier consumes — the analogue of the
k8s typed structs the reference gets from client-go (corev1.Event,
corev1.Pod, batchv1.Job at services/supervisor.go:160,211).

Only the fields the supervision logic reads are modeled; the full raw dict
is retained on each object for anything else (e.g. JobSet conditions).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Meta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "Meta":
        m = obj.get("metadata", {}) or {}
        return cls(
            name=m.get("name", ""),
            namespace=m.get("namespace", ""),
            uid=m.get("uid", ""),
            labels=dict(m.get("labels") or {}),
            annotations=dict(m.get("annotations") or {}),
        )


@dataclass
class ObjectRef:
    """corev1.ObjectReference subset (event.involvedObject)."""

    kind: str = ""
    name: str = ""
    namespace: str = ""
    uid: str = ""

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "ObjectRef":
        return cls(
            kind=obj.get("kind", ""),
            name=obj.get("name", ""),
            namespace=obj.get("namespace", ""),
            uid=obj.get("uid", ""),
        )


@dataclass
class EventObj:
    meta: Meta
    reason: str = ""
    message: str = ""
    type: str = ""
    involved_object: ObjectRef = field(default_factory=ObjectRef)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "EventObj":
        return cls(
            meta=Meta.from_api(obj),
            reason=obj.get("reason", ""),
            message=obj.get("message", ""),
            type=obj.get("type", ""),
            involved_object=ObjectRef.from_api(obj.get("involvedObject", {}) or {}),
            raw=obj,
        )


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    message: str = ""

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "ContainerStateTerminated":
        return cls(
            exit_code=int(obj.get("exitCode", 0) or 0),
            reason=obj.get("reason", ""),
            message=obj.get("message", ""),
        )


@dataclass
class ContainerStatus:
    name: str = ""
    terminated: Optional[ContainerStateTerminated] = None
    waiting_reason: str = ""

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "ContainerStatus":
        state = obj.get("state", {}) or {}
        last_state = obj.get("lastState", {}) or {}
        terminated = state.get("terminated") or last_state.get("terminated")
        waiting = state.get("waiting") or {}
        return cls(
            name=obj.get("name", ""),
            terminated=ContainerStateTerminated.from_api(terminated) if terminated else None,
            waiting_reason=waiting.get("reason", ""),
        )


@dataclass
class PodObj:
    meta: Meta
    phase: str = ""
    reason: str = ""
    message: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "PodObj":
        status = obj.get("status", {}) or {}
        return cls(
            meta=Meta.from_api(obj),
            phase=status.get("phase", ""),
            reason=status.get("reason", ""),
            message=status.get("message", ""),
            container_statuses=[
                ContainerStatus.from_api(cs) for cs in (status.get("containerStatuses") or [])
            ],
            raw=obj,
        )

    def job_name(self) -> str:
        """The pod->run backlink (batch.kubernetes.io/job-name,
        reference services/supervisor_test.go:246)."""
        from tpu_nexus_torch.checkpoint.models import POD_JOB_NAME_LABEL

        return self.meta.labels.get(POD_JOB_NAME_LABEL, "")

    def jobset_name(self) -> str:
        """The owning-JobSet backlink the JobSet controller stamps on child
        pods (jobset.sigs.k8s.io/jobset-name) — empty for plain-Job pods."""
        from tpu_nexus_torch.checkpoint.models import JOBSET_NAME_LABEL

        return self.meta.labels.get(JOBSET_NAME_LABEL, "")

    def run_id(self) -> str:
        """Pod -> run id.  The jobset-name backlink wins: for JobSet-launched
        runs the child Job is named `{run_id}-workers-0`, so the job-name
        backlink names a resource that has no ledger row (the run id IS the
        JobSet name).  Plain-Job pods fall back to the reference's job-name
        semantics (services/supervisor.go:231,241,251)."""
        return self.jobset_name() or self.job_name()

    def owner_job_uid(self) -> str:
        """Uid of the pod's owning Job straight from its ownerReferences —
        the Job controller stamps them on every pod it creates, so the
        preemption generation fence does not depend on the Job informer
        cache being warm (with a cold cache, a replica whose
        first row read landed after another replica's commit saw none of
        the duplicate-incident signals)."""
        refs = (self.raw.get("metadata") or {}).get("ownerReferences") or []
        for ref in refs:
            if ref.get("kind") == "Job":
                return ref.get("uid", "")
        return ""


@dataclass
class Condition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "Condition":
        return cls(
            type=obj.get("type", ""),
            status=obj.get("status", ""),
            reason=obj.get("reason", ""),
            message=obj.get("message", ""),
        )


@dataclass
class JobObj:
    meta: Meta
    conditions: List[Condition] = field(default_factory=list)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "JobObj":
        status = obj.get("status", {}) or {}
        return cls(
            meta=Meta.from_api(obj),
            conditions=[Condition.from_api(c) for c in (status.get("conditions") or [])],
            raw=obj,
        )

    def jobset_name(self) -> str:
        """Owning-JobSet backlink on controller-created child Jobs — empty
        for top-level (plain) Jobs."""
        from tpu_nexus_torch.checkpoint.models import JOBSET_NAME_LABEL

        return self.meta.labels.get(JOBSET_NAME_LABEL, "")

    def run_id(self) -> str:
        """Job -> run id: the k8s Job name IS the request id (reference
        services/supervisor.go:160,177-180) — unless this is a JobSet child
        Job, whose name is `{run_id}-workers-0`; then the jobset-name
        backlink carries the run id."""
        return self.jobset_name() or self.meta.name


@dataclass
class JobSetObj:
    """Cloud TPU multi-host workloads run as JobSets (jobset.x-k8s.io);
    the TPU-native extension of the reference's Job-only watch."""

    meta: Meta
    conditions: List[Condition] = field(default_factory=list)
    raw: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_api(cls, obj: Dict[str, Any]) -> "JobSetObj":
        status = obj.get("status", {}) or {}
        return cls(
            meta=Meta.from_api(obj),
            conditions=[Condition.from_api(c) for c in (status.get("conditions") or [])],
            raw=obj,
        )


#: informer kind name -> typed view (kind-keyed informer map parity,
#: reference services/supervisor.go:119-122)
KIND_TO_TYPE = {
    "Event": EventObj,
    "Pod": PodObj,
    "Job": JobObj,
    "JobSet": JobSetObj,
}
