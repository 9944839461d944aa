"""Ledger reporting for workloads: the port of
``tpu_nexus/workload/harness.py::LedgerReporter``.

The training loop of that module is a later slice (ROADMAP.md); the
reporter is what the serving loop needs: RUNNING on start, per-chip
heartbeats, a terminal COMPLETED/FAILED/PREEMPTED, all with the
reference's guard-before-write discipline.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from typing import Any, Dict, Optional

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import CheckpointStore
from tpu_nexus_torch.parallel.distributed import ProcessContext


def _rollback_record(events) -> list:
    """Ledger-details shape of restore-time rollback events: bounded detail
    strings (the ledger column is not a log sink)."""
    return [dict(e, detail=str(e.get("detail", ""))[:200]) for e in events]


class LedgerReporter:
    """Writes the run's lifecycle + heartbeats via COLUMN-level writes (N
    hosts may report one run concurrently, so whole-row upserts would
    clobber each other's columns).  ``local_devices`` is the number of
    CUDA devices this process drives: one heartbeat key per device."""

    def __init__(
        self, store: Optional[CheckpointStore], ctx: ProcessContext, local_devices: int = 1
    ) -> None:
        self.store = store
        self.ctx = ctx
        self.local_devices = local_devices

    def _guarded_update(self, fields: Dict[str, Any]) -> None:
        """Update columns unless the run is already terminal (IsFinished
        guard: never resurrect/mutate a cancelled or finished run)."""
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        if cp is None:
            cp = CheckpointedRequest(algorithm=self.ctx.algorithm, id=self.ctx.run_id)
            self.store.upsert_checkpoint(cp)
        elif cp.is_finished():
            return
        fields = dict(fields, last_modified=datetime.now(timezone.utc))
        self.store.update_fields(self.ctx.algorithm, self.ctx.run_id, fields)

    def running(self) -> None:
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        stage = cp.lifecycle_stage if cp else LifecycleStage.NEW
        if cp is not None and cp.is_finished():
            return
        if LifecycleStage.can_transition(stage, LifecycleStage.RUNNING):
            self._guarded_update({"lifecycle_stage": LifecycleStage.RUNNING})

    def _chip_steps(self, step: int) -> Dict[str, int]:
        return {self.ctx.chip_key(i): int(step) for i in range(self.local_devices)}

    def heartbeat(self, step: int) -> None:
        # per-key merge, NOT a row RMW: each host owns only its own chip keys
        if self.store is None:
            return
        cp = self.store.read_checkpoint(self.ctx.algorithm, self.ctx.run_id)
        if cp is None or cp.is_finished():
            return  # IsFinished guard: no heartbeats onto terminal rows
        self.store.merge_chip_steps(self.ctx.algorithm, self.ctx.run_id, self._chip_steps(step))

    def tensor_checkpoint(self, uri: str, step: int) -> None:
        """Publish a checkpoint pointer; callers hold the durability
        barrier (the URI names a committed, verified step)."""
        self._guarded_update({"tensor_checkpoint_uri": uri})
        self.heartbeat(step)

    def checkpoint_rollback(self, uri: str, step: int, events) -> None:
        """Restore-time rollback: repoint the ledger at the step actually
        restored and record why in the details column."""
        details = json.dumps({"ckpt_rollback": _rollback_record(events)})
        self._guarded_update(
            {"tensor_checkpoint_uri": uri, "algorithm_failure_details": details}
        )
        self.heartbeat(step)

    def health_rollback(self, uri: str, step: int, details: str) -> None:
        self._guarded_update(
            {"tensor_checkpoint_uri": uri, "algorithm_failure_details": details}
        )
        self.heartbeat(step)

    def failed(self, cause: str, details: str = "") -> None:
        """Workload-side terminal failure with a classified cause."""
        fields: Dict[str, Any] = {"lifecycle_stage": LifecycleStage.FAILED}
        if cause:
            fields["algorithm_failure_cause"] = cause
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def completed(self, result_uri: str = "", details: str = "") -> None:
        """Terminal COMPLETED; ``details`` (JSON) lands in the details
        column when given."""
        fields: Dict[str, Any] = {
            "lifecycle_stage": LifecycleStage.COMPLETED,
            "result_uri": result_uri,
        }
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def preempted(self, cause: str = "", details: str = "") -> None:
        """Workload-side preemption report (PREEMPTED is non-terminal)."""
        fields: Dict[str, Any] = {"lifecycle_stage": LifecycleStage.PREEMPTED}
        if cause:
            fields["algorithm_failure_cause"] = cause
        if details:
            fields["algorithm_failure_details"] = details
        self._guarded_update(fields)

    def hlo_trace(self, uri: str) -> None:
        """Record the failure-time trace artifact ref."""
        self._guarded_update({"hlo_trace_ref": uri})
