"""Launcher client: submit a run, seed its ledger row, watch for completion
(a copy of ``tpu_nexus/launcher/client.py``).

The flow a receiver/scheduler drives (the supervisor then owns the failure
paths):

1. ``launch`` — upsert the BUFFERED ledger row (seed state the reference
   fixtures start from, test-resources/checkpoints.cql:35), then create the
   Job (single-host / no JobSet CRD) or JobSet (multi-host);
2. the workload harness transitions RUNNING and heartbeats;
3. ``cancel`` — terminal CANCELLED + delete, guarded first-writer-wins.
"""

from __future__ import annotations

import logging
from datetime import datetime, timezone
from typing import Optional

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.k8s.client import KubeClient, NotFoundError
from tpu_nexus_torch.launcher.jobset import (
    LaunchSpec,
    compose_headless_service,
    compose_job,
    compose_jobset,
)

logger = logging.getLogger(__name__)


class Launcher:
    def __init__(self, kube: KubeClient, store: CheckpointStore, use_jobset: bool = True) -> None:
        self.kube = kube
        self.store = store
        self.use_jobset = use_jobset

    async def launch(self, spec: LaunchSpec, payload_uri: str = "") -> CheckpointedRequest:
        """Seed ledger (BUFFERED) then create the workload resource.

        Ledger-first ordering: the supervisor drops events for runs it cannot
        find a checkpoint for (reference services/supervisor.go:265-273), so
        the row must exist before the first pod event can fire.
        """
        now = datetime.now(timezone.utc)
        cp = CheckpointedRequest(
            algorithm=spec.algorithm,
            id=spec.run_id,
            lifecycle_stage=LifecycleStage.BUFFERED,
            payload_uri=payload_uri,
            received_at=now,
            sent_at=now,
            api_version="v1",
        )
        cp.touch()
        if self.use_jobset and spec.num_hosts > 1:
            # persist the restart budget with the row: it is an immutable
            # spec field, and the supervisor's budget escalation must work
            # after its own restart / after the JobSet is gone — a live
            # informer-cache lookup alone cannot promise that
            cp.max_restarts = spec.max_restarts
        self.store.upsert_checkpoint(cp)
        if self.use_jobset and spec.num_hosts > 1:
            manifest = compose_jobset(spec)
        else:
            manifest = compose_job(spec)
            if spec.num_hosts > 1:
                # plain-Job multi-host fallback: the coordinator DNS needs a
                # headless Service (JobSet would create its own)
                await self.kube.create_object(
                    "Service", spec.namespace, compose_headless_service(spec)
                )
        kind = manifest["kind"]
        created = await self.kube.create_object(kind, spec.namespace, manifest)
        logger.info("launched %s %s/%s (algorithm=%s hosts=%d)",
                    kind, spec.namespace, spec.run_id, spec.algorithm, spec.num_hosts)
        cp = cp.deep_copy()
        cp.job_uid = created.get("metadata", {}).get("uid", "")
        cp.touch()
        self.store.upsert_checkpoint(cp)
        return cp

    async def cancel(self, algorithm: str, run_id: str, namespace: str = "default") -> bool:
        """Cancel a run: terminal CANCELLED first (so late Started events are
        guarded), then delete the resource with background propagation."""
        cp = self.store.read_checkpoint(algorithm, run_id)
        if cp is None or cp.is_finished():
            return False
        cp = cp.deep_copy()
        cp.lifecycle_stage = LifecycleStage.CANCELLED
        cp.touch()
        self.store.upsert_checkpoint(cp)
        # only ONE of the kinds exists per run — 404 on the other is expected;
        # any real API error must surface (a run marked CANCELLED while its
        # JobSet keeps burning its GPUs would be invisible otherwise)
        for kind in ("JobSet", "Job", "Service"):
            try:
                await self.kube.delete_object(kind, namespace, run_id)
            except NotFoundError:
                continue
        return True
