"""Process identity for launched workloads: the port of
``tpu_nexus/parallel/distributed.py`` for a single process.

Env contract (set by the launcher): ``NEXUS_RUN_ID`` / ``NEXUS_ALGORITHM``
(ledger key), ``NEXUS_PROCESS_ID``, ``NEXUS_NUM_PROCESSES``,
``NEXUS_COORDINATOR_ADDRESS``.  A world size above 1 raises until the
multi-GPU slice brings ``torch.distributed`` bring-up (ROADMAP.md: A6).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

ENV_COORDINATOR = "NEXUS_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "NEXUS_PROCESS_ID"
ENV_NUM_PROCESSES = "NEXUS_NUM_PROCESSES"
ENV_RUN_ID = "NEXUS_RUN_ID"
ENV_ALGORITHM = "NEXUS_ALGORITHM"


@dataclass(frozen=True)
class ProcessContext:
    """Identity of this process within a launched run."""

    run_id: str
    algorithm: str
    process_id: int
    num_processes: int
    coordinator: Optional[str]

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def chip_key(self, local_device_index: int) -> str:
        """Ledger key for per-chip step counters, e.g. ``host0/chip1``."""
        return f"host{self.process_id}/chip{local_device_index}"


def process_context_from_env(env: Optional[dict] = None) -> ProcessContext:
    e = os.environ if env is None else env
    num_processes = int(e.get(ENV_NUM_PROCESSES, "1"))
    if num_processes > 1 and ENV_PROCESS_ID not in e:
        raise ValueError(
            f"{ENV_NUM_PROCESSES}={num_processes} but {ENV_PROCESS_ID} is unset; "
            "the launcher must inject the JobSet completion index"
        )
    return ProcessContext(
        run_id=e.get(ENV_RUN_ID, "local"),
        algorithm=e.get(ENV_ALGORITHM, "local"),
        process_id=int(e.get(ENV_PROCESS_ID, "0")),
        num_processes=num_processes,
        coordinator=e.get(ENV_COORDINATOR),
    )


def initialize_distributed(ctx: Optional[ProcessContext] = None) -> ProcessContext:
    """Single-process runs pass through; multi-process runs raise until
    the multi-GPU slice of the port."""
    ctx = ctx or process_context_from_env()
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"{ENV_NUM_PROCESSES}={ctx.num_processes}: multi-process runs are "
            "not ported yet (ROADMAP.md: A6 multi-GPU)"
        )
    return ctx
