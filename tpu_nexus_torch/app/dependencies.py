"""Dependency-injection builder (reference app/app_dependencies.go:12-85):
a copy of ``tpu_nexus/app/dependencies.py``.

Idempotent fluent builder: each `with_*` is a nil-guarded singleton — calling
it twice, or after an equivalent store was already built, is a no-op
(reference nil-guards at app_dependencies.go:18-34).  `start` maps config to
ProcessingConfig and runs Init+Start; startup failures exit the process
(klog.FlushAndExit parity, app_dependencies.go:42,48,81-82) unless
`fatal_exit=False` (test seam).
"""

from __future__ import annotations

import sys
from typing import Optional

from tpu_nexus_torch.app.config import (
    CQL_STORE_ASTRA,
    CQL_STORE_MEMORY,
    CQL_STORE_SCYLLA,
    CQL_STORE_SQLITE,
    SupervisorConfig,
)
from tpu_nexus_torch.checkpoint.store import (
    CheckpointStore,
    InMemoryCheckpointStore,
    SqliteCheckpointStore,
)
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.core.telemetry import Metrics, VLogger, get_logger
from tpu_nexus_torch.k8s.client import KubeClient
from tpu_nexus_torch.supervisor.service import ProcessingConfig, Supervisor


class ApplicationServices:
    def __init__(self, logger: Optional[VLogger] = None, metrics: Optional[Metrics] = None,
                 fatal_exit: bool = True) -> None:
        self._log = logger or get_logger("tpu_nexus_torch.app")
        self._metrics = metrics
        self._fatal_exit = fatal_exit
        self._cql_store: Optional[CheckpointStore] = None
        self._kube_client: Optional[KubeClient] = None
        self._supervisor: Optional[Supervisor] = None

    def _fatal(self, message: str, exc: Optional[BaseException] = None) -> None:
        self._log.error(message, error=repr(exc) if exc else "")
        if self._fatal_exit:
            sys.exit(1)
        raise RuntimeError(message) from exc

    # -- stores (reference WithAstraCqlStore/WithScyllaCqlStore) --------------

    def with_scylla_cql_store(self, config: SupervisorConfig) -> "ApplicationServices":
        if self._cql_store is None:
            from tpu_nexus_torch.checkpoint.cql import ScyllaCqlStore

            sc = config.scylla_cql_store
            # lazy store: no network I/O until first query (contract,
            # SURVEY §2.3 pkg/checkpoint/request row)
            self._cql_store = ScyllaCqlStore(
                hosts=sc.hosts, port=sc.port, user=sc.user,
                password=sc.password, local_dc=sc.local_dc, logger=self._log,
            )
        return self

    def with_astra_cql_store(self, config: SupervisorConfig) -> "ApplicationServices":
        if self._cql_store is None:
            from tpu_nexus_torch.checkpoint.cql import AstraCqlStore

            ac = config.astra_cql_store
            self._cql_store = AstraCqlStore(
                secure_connection_bundle_base64=ac.secure_connection_bundle_base64,
                user=ac.gateway_user, password=ac.gateway_password, logger=self._log,
            )
        return self

    def with_sqlite_store(self, config: SupervisorConfig) -> "ApplicationServices":
        if self._cql_store is None:
            self._cql_store = SqliteCheckpointStore(config.sqlite_store_path)
        return self

    def with_memory_store(self) -> "ApplicationServices":
        if self._cql_store is None:
            self._cql_store = InMemoryCheckpointStore()
        return self

    def with_store_for(self, config: SupervisorConfig) -> "ApplicationServices":
        """Select the CQL store backend by cql-store-type; unknown type is a
        fatal exit (reference main.go:28-36)."""
        if config.cql_store_type == CQL_STORE_ASTRA:
            return self.with_astra_cql_store(config)
        if config.cql_store_type == CQL_STORE_SCYLLA:
            return self.with_scylla_cql_store(config)
        if config.cql_store_type == CQL_STORE_SQLITE:
            return self.with_sqlite_store(config)
        if config.cql_store_type == CQL_STORE_MEMORY:
            return self.with_memory_store()
        self._fatal(f"unknown cql-store-type: {config.cql_store_type!r}")
        return self

    # -- kube client (reference WithKubeClient) -------------------------------

    def with_kube_client(self, config: SupervisorConfig) -> "ApplicationServices":
        """Kubeconfig-path or in-cluster client; fatal exit on error
        (reference app_dependencies.go:36-53)."""
        if self._kube_client is None:
            try:
                from tpu_nexus_torch.k8s.rest import RestKubeClient

                self._kube_client = RestKubeClient.from_config(config.kube_config_path)
            except Exception as exc:  # noqa: BLE001 - fatal-exit boundary (reference Fatal(), app_dependencies.go:36-53)
                self._fatal("failed to build kubernetes client", exc)
        return self

    def with_fake_kube_client(self, client: KubeClient) -> "ApplicationServices":
        if self._kube_client is None:
            self._kube_client = client
        return self

    # -- supervisor (reference WithSupervisor) --------------------------------

    def with_supervisor(self, config: SupervisorConfig, **overrides) -> "ApplicationServices":
        if self._supervisor is None:
            self._supervisor = Supervisor(
                self._kube_client,
                self._cql_store,
                config.resource_namespace,
                logger=self._log,
                metrics=self._metrics,
                watch_jobsets=config.watch_jobsets,
                **overrides,
            )
        return self

    @property
    def supervisor(self) -> Optional[Supervisor]:
        return self._supervisor

    @property
    def store(self) -> Optional[CheckpointStore]:
        return self._cql_store

    @property
    def kube_client(self) -> Optional[KubeClient]:
        return self._kube_client

    # -- start (reference Start, app_dependencies.go:68-85) -------------------

    async def start(self, ctx: LifecycleContext, config: SupervisorConfig) -> None:
        processing = ProcessingConfig(
            failure_rate_base_delay=config.failure_rate_base_delay,
            failure_rate_max_delay=config.failure_rate_max_delay,
            rate_limit_elements_per_second=config.rate_limit_elements_per_second,
            rate_limit_elements_burst=config.rate_limit_elements_burst,
            workers=config.workers,
            failure_lane_rate_per_second=config.failure_lane_rate_per_second,
            failure_lane_workers=config.failure_lane_workers,
            heartbeat_stale_after=config.heartbeat_stale_after,
            watchdog_interval=config.watchdog_interval,
            preempted_restart_deadline=config.preempted_restart_deadline,
            watchdog_verify_checkpoints=config.watchdog_verify_checkpoints,
        )
        try:
            self._supervisor.init(processing)
        except Exception as exc:  # noqa: BLE001 - fatal-exit boundary: any init failure must abort startup
            self._fatal("supervisor init failed", exc)
        await self._supervisor.start(ctx)
