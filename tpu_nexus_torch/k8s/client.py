"""KubeClient interface (a copy of ``tpu_nexus/k8s/client.py``).

The surface the supervisor consumes from the Kubernetes API plane
(reference: `kubernetes.Interface` + informer LIST/WATCH, SURVEY.md §2.4):

  * LIST + WATCH per kind, namespaced (Events, Pods, Jobs, JobSets);
  * Job/JobSet deletion with background propagation
    (`metav1.DeletePropagationBackground`, services/supervisor.go:262,268-270);
  * object creation (used by the launcher, not the supervisor).

Implementations: `FakeKubeClient` (fake.py, in-process) and
`RestKubeClient` (rest.py, aiohttp against a real API server).
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

#: kind -> (api path prefix builder data); JobSet is the TPU-native addition
KIND_API = {
    "Event": ("api/v1", "events"),
    "Pod": ("api/v1", "pods"),
    "Service": ("api/v1", "services"),  # launcher's plain-Job headless svc
    "Job": ("apis/batch/v1", "jobs"),
    "JobSet": ("apis/jobset.x-k8s.io/v1alpha2", "jobsets"),
}

PROPAGATION_BACKGROUND = "Background"
PROPAGATION_FOREGROUND = "Foreground"


class KubeClientError(Exception):
    pass


class NotFoundError(KubeClientError):
    pass


class KubeClient:
    async def list_objects(self, kind: str, namespace: str) -> Tuple[List[Dict[str, Any]], str]:
        """Return (items, resourceVersion) for a namespaced LIST."""
        raise NotImplementedError

    def watch_objects(
        self, kind: str, namespace: str, resource_version: Optional[str] = None
    ) -> AsyncIterator[Tuple[str, Dict[str, Any]]]:
        """Async-iterate (event_type, object) watch tuples; event_type in
        ADDED/MODIFIED/DELETED/BOOKMARK.  Runs until cancelled."""
        raise NotImplementedError

    async def create_object(self, kind: str, namespace: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    async def delete_object(
        self,
        kind: str,
        namespace: str,
        name: str,
        propagation: str = PROPAGATION_BACKGROUND,
    ) -> None:
        raise NotImplementedError

    async def delete_job(self, namespace: str, name: str, propagation: str = PROPAGATION_BACKGROUND) -> None:
        """Job deletion always uses background propagation in the decision
        paths (reference services/supervisor.go:289,314,339)."""
        await self.delete_object("Job", namespace, name, propagation)

    async def close(self) -> None:
        pass
