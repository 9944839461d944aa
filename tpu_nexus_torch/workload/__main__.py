"""Workload container entrypoint: ``python -m tpu_nexus_torch.workload``.

Reads the launcher's NEXUS_* env contract, connects the ledger store from the
same appconfig/env mechanism the supervisor uses, and runs the workload on
``NEXUS_DEVICE`` (default ``cuda``; a CUDA request without a card fails):
``NEXUS_MODE=train`` (the default) runs the training loop, ``serve`` the
lockstep serving loop and ``serve-engine`` the continuous-batching engine,
each under the same ledger contract.  A training run in a launched world
of processes (``NEXUS_NUM_PROCESSES`` > 1) runs this process's ranks of
the mesh (``workload/harness.py``); the serving loops run in one process.  Exit codes are the failure-taxonomy
contract: 137/255 surface via the Job's PodFailurePolicy (see
launcher.jobset), nonzero generic for uncaught errors.

The ledger store is the supervisor's: ``load_config(SupervisorConfig)``
(``appconfig.yaml``, its ``APPLICATION_ENVIRONMENT`` overlay, every
``NEXUS__*`` key) and ``ApplicationServices().with_store_for``, as in the
reference.  ``NEXUS__CQL_STORE_TYPE`` = ``scylla`` (the default; lazy, no
I/O until the first query), ``astra``, ``sqlite`` (with
``NEXUS__SQLITE_STORE_PATH``) or ``memory``; an unknown type logs and exits
1.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Mapping, Optional

import torch

from tpu_nexus_torch.checkpoint.store import CheckpointStore


def store_from_env(env: Optional[Mapping[str, str]] = None) -> CheckpointStore:
    """The ledger store the supervisor's config names, from ``appconfig``
    files and ``env`` (default: the process environment)."""
    from tpu_nexus_torch.app.config import SupervisorConfig
    from tpu_nexus_torch.app.dependencies import ApplicationServices
    from tpu_nexus_torch.core.config import load_config

    cfg = load_config(SupervisorConfig, environ=env)
    return ApplicationServices().with_store_for(cfg).store


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
    log = logging.getLogger(__name__)
    log.info("workload done: %s", result)
    if torch.cuda.is_initialized():
        log.info("peak device memory: %d bytes", torch.cuda.max_memory_allocated())
    return 0


if __name__ == "__main__":
    sys.exit(main())
