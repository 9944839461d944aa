"""Process entrypoint (reference main.go:12-43): ``python -m
tpu_nexus_torch.main`` runs the port's supervisor (a copy of
``tpu_nexus/main.py``).

Signal-aware context; typed config load; logger + statsd; store backend by
cql-store-type (fatal on unknown); kube client; supervisor; start (blocks).
"""

from __future__ import annotations

import asyncio

from tpu_nexus_torch.app.config import SupervisorConfig
from tpu_nexus_torch.app.dependencies import ApplicationServices
from tpu_nexus_torch.core import buildmeta
from tpu_nexus_torch.core.config import load_config
from tpu_nexus_torch.core.signals import setup_signal_context
from tpu_nexus_torch.core.telemetry import StatsdClient, configure_logger


def run() -> None:
    ctx = setup_signal_context()
    config = load_config(SupervisorConfig)
    logger = configure_logger(
        # statsd context tag: the reference tags "nexus_receiver" by
        # copy-paste accident (main.go:17; SURVEY §2.2 quirks) — fixed here
        tags={"application": "nexus-supervisor", "version": buildmeta.APP_VERSION},
        level=config.log_level,
    )
    metrics = StatsdClient("tpu_nexus_torch.supervisor", address=config.statsd_address or None)
    services = (
        ApplicationServices(logger=logger, metrics=metrics)
        .with_store_for(config)
        .with_kube_client(config)
        .with_supervisor(config)
    )
    logger.info(
        "starting supervisor",
        version=buildmeta.APP_VERSION,
        build=buildmeta.BUILD_NUMBER,
        namespace=config.resource_namespace,
        store=config.cql_store_type,
    )
    asyncio.run(services.start(ctx, config))


if __name__ == "__main__":
    run()
