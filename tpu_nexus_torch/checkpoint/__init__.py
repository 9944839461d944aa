"""Run ledger: the row model and the in-memory and sqlite stores (copies of
``tpu_nexus/checkpoint/models.py`` and ``store.py``)."""

from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import (
    CheckpointStore,
    InMemoryCheckpointStore,
    SqliteCheckpointStore,
)

__all__ = [
    "CheckpointedRequest",
    "LifecycleStage",
    "CheckpointStore",
    "InMemoryCheckpointStore",
    "SqliteCheckpointStore",
]
