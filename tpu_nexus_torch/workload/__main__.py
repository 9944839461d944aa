"""Workload container entrypoint: ``python -m tpu_nexus_torch.workload``.

Reads the launcher's NEXUS_* env contract, opens the ledger store, and runs
the workload on ``NEXUS_DEVICE`` (default ``cuda``; a CUDA request without
a card fails): ``NEXUS_MODE=train`` (the default, as in the reference)
runs the training loop, ``serve`` the lockstep serving loop and
``serve-engine`` the continuous-batching engine, each under the same ledger
contract.

The ledger store comes from the same keys the supervisor's app config
reads: ``NEXUS__CQL_STORE_TYPE`` = ``memory`` (the default here) or
``sqlite`` (with ``NEXUS__SQLITE_STORE_PATH``); ``scylla`` and ``astra``
are not ported yet.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

from tpu_nexus_torch.checkpoint.store import (
    CheckpointStore,
    InMemoryCheckpointStore,
    SqliteCheckpointStore,
)

def store_from_env(env: Optional[Dict[str, str]] = None) -> CheckpointStore:
    e = os.environ if env is None else env
    kind = e.get("NEXUS__CQL_STORE_TYPE", "memory")
    if kind == "memory":
        return InMemoryCheckpointStore()
    if kind == "sqlite":
        return SqliteCheckpointStore(
            e.get("NEXUS__SQLITE_STORE_PATH", "/var/lib/tpu-nexus/ledger.db")
        )
    if kind in ("scylla", "astra"):
        raise NotImplementedError(
            f"NEXUS__CQL_STORE_TYPE={kind!r}: the CQL ledger backends are not "
            "ported yet (ROADMAP.md: launcher and supervisor copies)"
        )
    raise ValueError(f"unknown NEXUS__CQL_STORE_TYPE {kind!r}; use memory or sqlite")


def main() -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    mode = os.environ.get("NEXUS_MODE", "train")
    if mode == "train":
        from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

        cfg, run = WorkloadConfig.from_env(), run_workload
    elif mode == "serve":
        from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

        cfg, run = ServeConfig.from_env(), run_serving
    elif mode == "serve-engine":
        from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine

        cfg, run = ServeConfig.from_env(), run_serve_engine
    else:
        raise SystemExit(f"unknown NEXUS_MODE {mode!r}; use 'train', 'serve' or 'serve-engine'")
    store = store_from_env()
    try:
        result = run(cfg, store=store)
    finally:
        store.close()
    logging.getLogger(__name__).info("workload done: %s", result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
