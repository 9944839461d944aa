"""In-process fake Kubernetes client (a copy of ``tpu_nexus/k8s/fake.py``).

Parity with `k8s.io/client-go/kubernetes/fake.NewClientset(objects...)` as
used by the reference test suite (services/supervisor_test.go:40, SURVEY.md
§3.4): pre-seeded Events/Pods/Jobs are replayed through real informers, so
the "multi-node cluster" is simulated entirely in-process.  Additionally
supports live injection of watch events and records all write actions for
assertions.
"""

from __future__ import annotations

import asyncio
import copy
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from tpu_nexus_torch.k8s.client import (
    KIND_API,
    PROPAGATION_BACKGROUND,
    KubeClient,
    KubeClientError,
    NotFoundError,
)
from tpu_nexus_torch.checkpoint.models import (
    JOBSET_NAME_LABEL,
    JOBSET_REPLICATEDJOB_LABEL,
    POD_JOB_NAME_LABEL,
)


def _key(obj: Dict[str, Any]) -> Tuple[str, str]:
    meta = obj.get("metadata", {}) or {}
    return (meta.get("namespace", ""), meta.get("name", ""))


class FakeKubeClient(KubeClient):
    def __init__(
        self,
        objects: Optional[Dict[str, List[Dict[str, Any]]]] = None,
        jobset_controller: bool = False,
        emit_pod_events: bool = False,
    ) -> None:
        """`objects` maps kind -> list of API dicts (the seeded cluster
        state).  With ``jobset_controller=True`` the fake also plays the
        JobSet + Job controllers: a created JobSet materializes its child
        Jobs (`{js}-{replicatedJob}-{idx}`) and their pods, labeled exactly
        as the real controllers label them (jobset-name/replicatedjob-name
        backlinks, batch.kubernetes.io/job-name, completion-index
        annotation) — the flagship deployment shape.

        With ``emit_pod_events=True`` the fake additionally plays the
        kubelet's EVENT side for pods: a pod DELETED from the
        cluster emits a ``Killing`` Event, a pod MODIFIED into phase
        ``Failed`` emits a ``Failed`` Event carrying the container
        termination text — what real clusters give the serving-fleet
        controller to classify.  Events are NAMESPACE-scoped to the pod
        (same discipline as the namespace-scoped dependents: pod names are only
        unique per namespace, so a bare-name event would cross-classify a
        same-named pod's death in another namespace)."""
        self._objects: Dict[str, Dict[Tuple[str, str], Dict[str, Any]]] = {
            kind: {} for kind in KIND_API
        }
        for kind, items in (objects or {}).items():
            for obj in items:
                self._objects.setdefault(kind, {})[_key(obj)] = obj
        self._watchers: Dict[str, List[asyncio.Queue]] = {kind: [] for kind in KIND_API}
        #: recorded write actions: (verb, kind, namespace, name, extra)
        self.actions: List[Tuple[str, str, str, str, Dict[str, Any]]] = []
        self._rv = 1
        self._jobset_controller = jobset_controller
        self._emit_pod_events = emit_pod_events
        self._materialized_jobsets: set = set()
        self._uid_counter = 0
        self._event_counter = 0

    # -- seeding / injection (test API) -------------------------------------

    def inject(self, event_type: str, kind: str, obj: Dict[str, Any]) -> None:
        """Apply a watch event to the fake cluster state and fan it out to
        watchers (the live-injection seam the Go fake exposes via its
        watch Reactor)."""
        store = self._objects.setdefault(kind, {})
        if event_type == "DELETED":
            store.pop(_key(obj), None)
        else:
            store[_key(obj)] = obj
        self._rv += 1
        for queue in self._watchers.get(kind, []):
            queue.put_nowait((event_type, obj))
        if self._jobset_controller and kind == "JobSet" and event_type == "ADDED":
            # keyed by (namespace, name): jobset names are only unique per
            # namespace, and a bare-name key would skip materializing a
            # same-named jobset in a second namespace
            key = _key(obj)
            if key[1] and key not in self._materialized_jobsets:
                self._materialized_jobsets.add(key)
                self._materialize_jobset_children(obj)
        if self._emit_pod_events and kind == "Pod":
            self._emit_pod_lifecycle_event(event_type, obj)

    def _emit_pod_lifecycle_event(self, event_type: str, pod: Dict[str, Any]) -> None:
        """What the kubelet/event-recorder does when a pod dies: an Event
        object scoped to the POD'S namespace (not the watcher's), so the
        fleet controller's event classification is testable without a
        cluster.  DELETED -> ``Killing``; MODIFIED into phase ``Failed`` ->
        ``Failed`` with the container termination reasons/messages — the
        text ``classify_tpu_failure`` runs its signature pass over."""
        meta = pod.get("metadata") or {}
        status = pod.get("status") or {}
        statuses = status.get("containerStatuses") or []
        crash_looping = any(
            "BackOff" in (((cs.get("state") or {}).get("waiting") or {}).get("reason") or "")
            for cs in statuses
        )
        if event_type == "DELETED":
            reason, message = "Killing", f"Stopping container {meta.get('name', '')}"
        elif event_type in ("ADDED", "MODIFIED") and (
            status.get("phase") == "Failed" or crash_looping
        ):
            # kubelet parity: a crash-looping container emits `BackOff`
            # (pod phase often still Running); a dead pod emits `Failed`
            reason = "BackOff" if crash_looping else "Failed"
            parts = []
            for cs in statuses:
                term = (cs.get("state") or {}).get("terminated") or (
                    cs.get("lastState") or {}
                ).get("terminated") or {}
                if term:
                    parts.append(
                        f"{term.get('reason', '')}: {term.get('message', '')} "
                        f"(exit {term.get('exitCode', '')})"
                    )
            message = "\n".join(parts) or "Pod failed"
        else:
            return
        self._event_counter += 1
        self.inject(
            "ADDED",
            "Event",
            {
                "kind": "Event",
                "metadata": {
                    "name": f"evt-{reason.lower()}-{meta.get('name', '')}-{self._event_counter}",
                    "namespace": meta.get("namespace", ""),
                },
                "reason": reason,
                "message": message,
                "type": "Warning",
                "involvedObject": {
                    "kind": "Pod",
                    "name": meta.get("name", ""),
                    "namespace": meta.get("namespace", ""),
                    "uid": meta.get("uid", ""),
                },
            },
        )

    def fail_pod(
        self,
        namespace: str,
        name: str,
        message: str = "",
        reason: str = "Error",
        exit_code: int = 1,
        crash_loop: bool = False,
    ) -> None:
        """Test API: terminate a pod's container with ``message``/``exit_code``
        and flip its phase to ``Failed`` (a MODIFIED watch event; with
        ``emit_pod_events`` also the matching ``Failed`` Event).  ``message``
        carries the failure wording the classifier's signature pass reads —
        e.g. the HBM RESOURCE_EXHAUSTED text for the reduced-KV drill.
        ``crash_loop=True`` models the restart-loop shape instead: container
        waiting in ``CrashLoopBackOff`` (pod phase stays Running), emitted
        Event reason ``BackOff`` — the kubelet's crash-loop signature."""
        pod = self._objects.get("Pod", {}).get((namespace, name))
        if pod is None:
            raise NotFoundError(f"Pod {namespace}/{name} not found")
        status = pod.setdefault("status", {})
        state: Dict[str, Any] = {
            "terminated": {
                "reason": reason,
                "message": message,
                "exitCode": exit_code,
            }
        }
        if crash_loop:
            status["phase"] = "Running"
            state = {
                "waiting": {"reason": "CrashLoopBackOff"},
                # the last crash's termination rides lastState, where the
                # classifier's signature pass reads it (objects.py parity)
            }
            status["containerStatuses"] = [
                {
                    "name": "main",
                    "state": state,
                    "lastState": {
                        "terminated": {
                            "reason": reason,
                            "message": message,
                            "exitCode": exit_code,
                        }
                    },
                }
            ]
        else:
            status["phase"] = "Failed"
            status["containerStatuses"] = [{"name": "main", "state": state}]
        self.inject("MODIFIED", "Pod", pod)

    def _next_uid(self) -> str:
        self._uid_counter += 1
        return f"fake-uid-{self._uid_counter}"

    def _materialize_jobset_children(self, jobset: Dict[str, Any]) -> None:
        """What the JobSet controller + Job controller do: create the child
        Job per replicatedJob replica, then its pods.  Child Jobs get the
        replicatedJobs template's metadata labels plus the jobset backlinks;
        pods get the pod template's labels plus the job-name backlink and the
        jobset-name label (the real JobSet controller stamps it on pods too)."""
        meta = jobset.get("metadata") or {}
        js_name, ns = meta.get("name", ""), meta.get("namespace", "")
        for rj in (jobset.get("spec") or {}).get("replicatedJobs", []):
            rj_name = rj.get("name", "")
            template = rj.get("template") or {}
            for ridx in range(int(rj.get("replicas", 1) or 1)):
                # fresh copy per replica: sibling Jobs must not share one
                # mutable spec dict (real k8s objects are independent)
                job_spec = copy.deepcopy(template.get("spec") or {})
                job_name = f"{js_name}-{rj_name}-{ridx}"
                job_labels = dict(((template.get("metadata") or {}).get("labels")) or {})
                job_labels[JOBSET_NAME_LABEL] = js_name
                job_labels[JOBSET_REPLICATEDJOB_LABEL] = rj_name
                job_uid = self._next_uid()
                self.inject(
                    "ADDED",
                    "Job",
                    {
                        "apiVersion": "batch/v1",
                        "kind": "Job",
                        "metadata": {
                            "name": job_name,
                            "namespace": ns,
                            "uid": job_uid,
                            "labels": job_labels,
                            "ownerReferences": [
                                {
                                    "apiVersion": "jobset.x-k8s.io/v1alpha2",
                                    "kind": "JobSet",
                                    "name": js_name,
                                    "uid": meta.get("uid", ""),
                                    "controller": True,
                                }
                            ],
                        },
                        "spec": job_spec,
                        "status": {},
                    },
                )
                pod_template = job_spec.get("template") or {}
                pod_labels_base = dict(((pod_template.get("metadata") or {}).get("labels")) or {})
                for i in range(int(job_spec.get("parallelism", 1) or 1)):
                    pod_labels = dict(pod_labels_base)
                    pod_labels[POD_JOB_NAME_LABEL] = job_name
                    pod_labels[JOBSET_NAME_LABEL] = js_name
                    pod_labels[JOBSET_REPLICATEDJOB_LABEL] = rj_name
                    self.inject(
                        "ADDED",
                        "Pod",
                        {
                            "kind": "Pod",
                            "metadata": {
                                "name": f"{job_name}-{i}",
                                "namespace": ns,
                                "uid": self._next_uid(),
                                "labels": pod_labels,
                                "annotations": {
                                    "batch.kubernetes.io/job-completion-index": str(i)
                                },
                                "ownerReferences": [
                                    {
                                        "apiVersion": "batch/v1",
                                        "kind": "Job",
                                        "name": job_name,
                                        "uid": job_uid,
                                        "controller": True,
                                    }
                                ],
                            },
                            "spec": copy.deepcopy(pod_template.get("spec") or {}),
                            "status": {"phase": "Pending"},
                        },
                    )

    def recreate_jobset_children(self, namespace: str, name: str) -> None:
        """What the JobSet ``Recreate`` failure policy does after a slice
        failure/preemption: delete the child Jobs and their pods, then create
        replacements under the SAME names with FRESH uids — a new generation
        (and consistent ownerReferences), which is exactly what makes the
        next preemption a distinct incident for the generation fence."""
        jobset = self._objects.get("JobSet", {}).get((namespace, name))
        if jobset is None:
            raise NotFoundError(f"JobSet {namespace}/{name} not found")
        for kind, obj in self._dependents_of("JobSet", name, namespace):
            self.inject("DELETED", kind, obj)
        self._materialize_jobset_children(jobset)

    # -- KubeClient ----------------------------------------------------------

    async def list_objects(self, kind: str, namespace: str) -> Tuple[List[Dict[str, Any]], str]:
        items = [
            obj
            for (ns, _), obj in self._objects.get(kind, {}).items()
            if not namespace or ns == namespace
        ]
        return list(items), str(self._rv)

    async def watch_objects(
        self, kind: str, namespace: str, resource_version: Optional[str] = None
    ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        queue: asyncio.Queue = asyncio.Queue()
        self._watchers.setdefault(kind, []).append(queue)
        try:
            while True:
                event_type, obj = await queue.get()
                ns = (obj.get("metadata") or {}).get("namespace", "")
                if namespace and ns != namespace:
                    continue
                yield event_type, obj
        finally:
            self._watchers[kind].remove(queue)

    async def create_object(self, kind: str, namespace: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
        manifest.setdefault("metadata", {}).setdefault("namespace", namespace)
        self.actions.append(("create", kind, namespace, manifest["metadata"].get("name", ""), {}))
        self.inject("ADDED", kind, manifest)
        return manifest

    async def delete_object(
        self,
        kind: str,
        namespace: str,
        name: str,
        propagation: str = PROPAGATION_BACKGROUND,
    ) -> None:
        if not name:
            # parity with RestKubeClient: empty name addresses the collection
            raise KubeClientError(f"refusing DELETE with empty name (kind={kind!r}, ns={namespace!r})")
        store = self._objects.get(kind, {})
        obj = store.get((namespace, name))
        self.actions.append(("delete", kind, namespace, name, {"propagation": propagation}))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        self.inject("DELETED", kind, obj)
        if kind in ("Job", "JobSet"):
            # re-creating a same-named JobSet must re-materialize children
            # even before the deferred GC below runs, so clear synchronously
            if kind == "JobSet":
                self._materialized_jobsets.discard((namespace, name))
            # background propagation: dependents are garbage-collected
            # asynchronously (reference relies on DeletePropagationBackground,
            # services/supervisor.go:262).  The victim set is SNAPSHOTTED by
            # uid now — real k8s GC tracks ownerReference uids, so a
            # same-named resource re-created before the GC tick keeps its
            # fresh children
            victims = self._dependents_of(kind, name, namespace)
            asyncio.get_running_loop().call_soon(self._gc_victims, victims)

    def _dependents_of(
        self, kind: str, name: str, namespace: str
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """(kind, object) snapshot of the dependents a controller would GC.
        Filtered by ``metadata.namespace`` as well as the backlink label —
        jobset/job names are only unique PER NAMESPACE, so a label-only
        match would cross-GC a same-named resource's children in another
        namespace (real ownerReference GC is namespace-scoped)."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        if kind == "JobSet":
            for job in self._objects.get("Job", {}).values():
                meta = job.get("metadata") or {}
                labels = meta.get("labels") or {}
                if labels.get(JOBSET_NAME_LABEL) == name and meta.get("namespace", "") == namespace:
                    out.append(("Job", job))
                    out.extend(
                        self._dependents_of("Job", meta.get("name", ""), namespace)
                    )
        else:
            for pod in self._objects.get("Pod", {}).values():
                meta = pod.get("metadata") or {}
                labels = meta.get("labels") or {}
                if labels.get(POD_JOB_NAME_LABEL) == name and meta.get("namespace", "") == namespace:
                    out.append(("Pod", pod))
        return out

    def _gc_victims(self, victims: List[Tuple[str, Dict[str, Any]]]) -> None:
        for kind, obj in victims:
            meta = obj.get("metadata") or {}
            current = self._objects.get(kind, {}).get((meta.get("namespace", ""), meta.get("name", "")))
            # uid fence: only GC the exact generation that was deleted
            if current is not None and (current.get("metadata") or {}).get("uid") == meta.get("uid"):
                self.inject("DELETED", kind, obj)

    # -- assertion helpers ---------------------------------------------------

    def deleted(self, kind: str) -> List[str]:
        return [name for verb, k, _, name, _ in self.actions if verb == "delete" and k == kind]
