"""Job launcher: composes and submits the k8s resources that run algorithm
workloads (``python -m tpu_nexus_torch.workload``) as GPU worker processes.

A copy of ``tpu_nexus/launcher``: the manifests are the ones the JAX
package composes, field for field.  The supervisor's reference never
creates workloads — its sibling "scheduler" does — so the manifest/labeling
contract is reconstructed from what the supervisor filters on (SURVEY.md
§2.2): the Job/JobSet name IS the run id (a UUID), and the nexus labels
mark it an algorithm run.
"""

from tpu_nexus_torch.launcher.jobset import (
    LaunchSpec,
    compose_job,
    compose_jobset,
    coordinator_address,
    workload_env,
)
from tpu_nexus_torch.launcher.client import Launcher

__all__ = [
    "LaunchSpec",
    "compose_job",
    "compose_jobset",
    "coordinator_address",
    "workload_env",
    "Launcher",
]
