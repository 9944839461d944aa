"""JobSet / Job manifest composition for GPU worker workloads: a copy of
``tpu_nexus/launcher/jobset.py``; for the same :class:`LaunchSpec` both
compose the same manifests.

Multi-host topology: one JobSet with a single replicated job of
``num_hosts`` completions; the headless service JobSet creates per job
gives every worker a stable DNS name, and worker 0's name is the
coordinator address injected via the ``NEXUS_*`` env contract
(tpu_nexus_torch.parallel.distributed brings the process group up from
it).

Labeling contract (what the supervisor filters on, SURVEY.md §2.2):
``NEXUS_COMPONENT_LABEL: algorithm-run`` + ``JOB_TEMPLATE_NAME_KEY:
<algorithm>`` on every object; the run id is the JobSet/Job name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_nexus_torch.checkpoint.models import (
    JOB_LABEL_ALGORITHM_RUN,
    JOB_TEMPLATE_NAME_KEY,
    NEXUS_COMPONENT_LABEL,
)
from tpu_nexus_torch.parallel.distributed import (
    ENV_ALGORITHM,
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_RUN_ID,
)

COORDINATOR_PORT = 8476
#: JobSet's exclusive-topology annotation: one worker pod per node of the
#: pool (the name is the JAX package's)
TPU_TOPOLOGY_ANNOTATION = "alpha.jobset.sigs.k8s.io/exclusive-topology"


@dataclass(frozen=True)
class LaunchSpec:
    """Everything needed to materialize a run's k8s resources."""

    run_id: str
    algorithm: str
    image: str
    command: List[str] = field(default_factory=list)
    num_hosts: int = 1
    #: accelerator resource limits per worker, e.g. {"nvidia.com/gpu": "1"}
    resources: Dict[str, str] = field(default_factory=dict)
    #: nodeSelector of a GPU node pool, e.g.
    #: {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    node_selector: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    backoff_limit: int = 0
    deadline_seconds: Optional[int] = None
    namespace: str = "default"
    #: JobSet failurePolicy.maxRestarts — how many times the controller
    #: recreates the workers after a slice failure/preemption (restart-from-
    #: step, SURVEY §7.4).  Ignored for plain-Job runs.
    max_restarts: int = 3


def run_labels(spec: LaunchSpec) -> Dict[str, str]:
    return {
        NEXUS_COMPONENT_LABEL: JOB_LABEL_ALGORITHM_RUN,
        JOB_TEMPLATE_NAME_KEY: spec.algorithm,
    }


def coordinator_address(spec: LaunchSpec, jobset: bool = True) -> str:
    """Worker 0's stable DNS name.

    JobSet path: under the JobSet-managed headless service, pod 0 of the
    replicated job is ``<js>-workers-0-0.<js>.<ns>.svc``.  Plain indexed-Job
    path: pods get hostname ``<job>-<index>`` when the pod template sets
    ``subdomain`` to a matching headless Service (created by the Launcher),
    giving ``<job>-0.<job>.<ns>.svc``.
    """
    host = f"{spec.run_id}-workers-0-0" if jobset else f"{spec.run_id}-0"
    return f"{host}.{spec.run_id}.{spec.namespace}.svc:{COORDINATOR_PORT}"


def workload_env(spec: LaunchSpec, jobset: bool = True) -> List[Dict[str, Any]]:
    """The NEXUS_* env contract consumed by parallel.distributed.

    Process id comes from the downward API: the Job controller stamps the
    ``batch.kubernetes.io/job-completion-index`` annotation on indexed-job
    pods (a ``$(VAR)`` reference to JOB_COMPLETION_INDEX would NOT expand —
    dependent expansion only sees variables declared earlier in the list,
    and the controller appends its env after user env).
    """
    env: List[Dict[str, Any]] = [
        {"name": ENV_RUN_ID, "value": spec.run_id},
        {"name": ENV_ALGORITHM, "value": spec.algorithm},
        {"name": ENV_NUM_PROCESSES, "value": str(spec.num_hosts)},
        {
            "name": ENV_PROCESS_ID,
            "valueFrom": {
                "fieldRef": {
                    "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"
                }
            },
        },
    ]
    if spec.num_hosts > 1:
        env.append({"name": ENV_COORDINATOR, "value": coordinator_address(spec, jobset=jobset)})
    env.extend({"name": k, "value": v} for k, v in sorted(spec.env.items()))
    return env


def _pod_template(spec: LaunchSpec, jobset: bool) -> Dict[str, Any]:
    container: Dict[str, Any] = {
        "name": "algorithm",
        "image": spec.image,
        "env": workload_env(spec, jobset=jobset),
    }
    if spec.command:
        container["command"] = list(spec.command)
    if spec.resources:
        container["resources"] = {"limits": dict(spec.resources)}
    pod_spec: Dict[str, Any] = {
        "restartPolicy": "Never",
        "containers": [container],
    }
    if not jobset and spec.num_hosts > 1:
        # stable per-index pod DNS for the coordinator: requires the matching
        # headless Service (compose_headless_service) the Launcher creates
        pod_spec["subdomain"] = spec.run_id
        pod_spec["setHostnameAsFQDN"] = False
    if spec.node_selector:
        pod_spec["nodeSelector"] = dict(spec.node_selector)
    return {
        "metadata": {"labels": run_labels(spec)},
        "spec": pod_spec,
    }


def compose_headless_service(spec: LaunchSpec) -> Dict[str, Any]:
    """Headless Service backing the plain-Job multi-host coordinator DNS
    (JobSet creates its own; this is only for the no-CRD fallback path)."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": spec.run_id,
            "namespace": spec.namespace,
            "labels": run_labels(spec),
        },
        "spec": {
            "clusterIP": "None",
            "selector": run_labels(spec),
            "ports": [{"name": "coordinator", "port": COORDINATOR_PORT}],
        },
    }


def compose_job(spec: LaunchSpec, jobset: bool = False) -> Dict[str, Any]:
    """Plain batch/v1 Job — single-host runs and clusters without the
    JobSet CRD.  Indexed completion mode so the env
    contract is identical to the JobSet path."""
    job_spec: Dict[str, Any] = {
        "completionMode": "Indexed",
        "completions": spec.num_hosts,
        "parallelism": spec.num_hosts,
        "backoffLimit": spec.backoff_limit,
        # surface OOM (137) and unknown-fatal (255) as PodFailurePolicy events
        # — the reference's FATAL path (services/supervisor.go:310-313)
        "podFailurePolicy": {
            "rules": [
                {
                    "action": "FailJob",
                    "onExitCodes": {"operator": "In", "values": [137, 255]},
                }
            ]
        },
        "template": _pod_template(spec, jobset),
    }
    if spec.deadline_seconds:
        job_spec["activeDeadlineSeconds"] = spec.deadline_seconds
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": spec.run_id,
            "namespace": spec.namespace,
            "labels": run_labels(spec),
        },
        "spec": job_spec,
    }


def compose_jobset(spec: LaunchSpec) -> Dict[str, Any]:
    """JobSet for multi-host runs: all workers restart together on a worker
    failure (Recreate) — the workers of one run are all-or-nothing, and
    restart-from-step is driven by the tensor checkpoint (SURVEY.md §7.4)."""
    job = compose_job(spec, jobset=True)
    return {
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "kind": "JobSet",
        "metadata": {
            "name": spec.run_id,
            "namespace": spec.namespace,
            "labels": run_labels(spec),
            "annotations": {TPU_TOPOLOGY_ANNOTATION: "cloud.google.com/gke-nodepool"},
        },
        "spec": {
            "failurePolicy": {"maxRestarts": spec.max_restarts},
            "replicatedJobs": [
                {
                    "name": "workers",
                    "replicas": 1,
                    # template metadata labels propagate to the child Job —
                    # the supervisor's event filter must recognize child-Job
                    # events (e.g. BackoffLimitExceeded) as run events
                    "template": {
                        "metadata": {"labels": run_labels(spec)},
                        "spec": job["spec"],
                    },
                }
            ],
        },
    }
