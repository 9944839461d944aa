"""Label/namespace-based event filtering over informer caches: a copy of
``tpu_nexus/supervisor/resolvers.py``.

Equivalent of nexus-core `resolvers.IsNexusRunEvent` /
`resolvers.GetCachedObject[T]` as consumed at reference
services/supervisor.go:147,160,211 (SURVEY.md §2.3):

  * a "Nexus run" is a Job labeled
    {NEXUS_COMPONENT_LABEL: JOB_LABEL_ALGORITHM_RUN} carrying
    JOB_TEMPLATE_NAME_KEY (the algorithm name); its Pods carry the
    k8s-standard batch.kubernetes.io/job-name backlink
    (fixtures services/supervisor_test.go:73-76,246);
  * lookups return None for cache misses — the stale-event drop path
    (services/supervisor.go:161-164,218-221) — never raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_LABEL_SERVING_FLEET,
    NEXUS_COMPONENT_LABEL,
)
from tpu_nexus_torch.k8s.informer import Informer
from tpu_nexus_torch.k8s.objects import EventObj, JobObj, JobSetObj, PodObj


def get_cached_object(name: str, namespace: str, informer: Optional[Informer]) -> Optional[Any]:
    """Typed cache lookup returning None for missing objects (stale events)."""
    if informer is None:
        return None
    return informer.get(name, namespace)


def event_component(
    event: EventObj,
    namespace: str,
    informers: Dict[str, Informer],
) -> str:
    """The nexus-component label value the event's involved object is (or
    belongs to), resolved via the informer caches — "" when the object is
    uncached (stale event) or nothing in its ownership chain carries the
    label.  The first NON-EMPTY value along the chain (object → owning Job
    → owning JobSet) wins, so one pod can never present as two components
    to two control loops."""
    ref = event.involved_object
    obj_ns = ref.namespace or event.meta.namespace
    if namespace and obj_ns != namespace:
        return ""
    if ref.kind == "Job":
        job: Optional[JobObj] = get_cached_object(ref.name, obj_ns, informers.get("Job"))
        if job is None:
            return ""
        # JobSet child Jobs may carry only controller-stamped labels; fall
        # back to the owning JobSet via the jobset-name backlink
        return job.meta.labels.get(NEXUS_COMPONENT_LABEL, "") or _owning_jobset_component(
            job.jobset_name(), obj_ns, informers
        )
    if ref.kind == "JobSet":
        jobset: Optional[JobSetObj] = get_cached_object(ref.name, obj_ns, informers.get("JobSet"))
        if jobset is None:
            return ""
        return jobset.meta.labels.get(NEXUS_COMPONENT_LABEL, "")
    if ref.kind == "Pod":
        pod: Optional[PodObj] = get_cached_object(ref.name, obj_ns, informers.get("Pod"))
        if pod is None:
            return ""
        component = pod.meta.labels.get(NEXUS_COMPONENT_LABEL, "")
        if component:
            return component
        # fall back to the owning Job's labels via the job-name backlink
        job_name = pod.job_name()
        if job_name:
            job = get_cached_object(job_name, obj_ns, informers.get("Job"))
            if job is not None:
                component = job.meta.labels.get(NEXUS_COMPONENT_LABEL, "")
                if component:
                    return component
        # ... then to the owning JobSet via the jobset-name backlink
        return _owning_jobset_component(pod.jobset_name(), obj_ns, informers)
    return ""


def is_nexus_run_event(
    event: EventObj,
    namespace: str,
    informers: Dict[str, Informer],
) -> bool:
    """True iff the event's involved object is (or belongs to) a Nexus
    algorithm run in `namespace`, resolved via the informer caches."""
    return event_component(event, namespace, informers) == JOB_LABEL_ALGORITHM_RUN


def is_serving_fleet_event(
    event: EventObj,
    namespace: str,
    informers: Dict[str, Informer],
) -> bool:
    """True iff the event belongs to a SERVING-fleet JobSet —
    the fleet controller's selection mirror of :func:`is_nexus_run_event`.
    Exactly one of the two can be true for any event: the component label
    value decides which control loop owns the pod."""
    return event_component(event, namespace, informers) == JOB_LABEL_SERVING_FLEET


def _owning_jobset_component(
    jobset_name: str, namespace: str, informers: Dict[str, Informer]
) -> str:
    if not jobset_name:
        return ""
    jobset = get_cached_object(jobset_name, namespace, informers.get("JobSet"))
    if jobset is None:
        return ""
    return jobset.meta.labels.get(NEXUS_COMPONENT_LABEL, "")
