"""Typed application config (reference app/app_config.go:8-25): a copy of
``tpu_nexus/app/config.py``.

Field names bind to kebab-case YAML keys / NEXUS__UPPER_SNAKE env vars via
tpu_nexus_torch.core.config (the mapstructure-tag analogue).  The store-type
constants gain `sqlite` and `memory` backends for local/dev runs alongside
the reference's `astra`/`scylla`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import timedelta
from typing import List


@dataclass
class AstraBundleConfig:
    """Reference request.AstraBundleConfig (appconfig.local.yaml:1-4)."""

    secure_connection_bundle_base64: str = ""
    gateway_user: str = ""
    gateway_password: str = ""


@dataclass
class ScyllaCqlStoreConfig:
    """Reference request.ScyllaCqlStoreConfig (appconfig.local.yaml:5-10)."""

    hosts: List[str] = field(default_factory=list)
    port: int = 9042
    user: str = ""
    password: str = ""
    local_dc: str = ""


CQL_STORE_ASTRA = "astra"
CQL_STORE_SCYLLA = "scylla"
CQL_STORE_SQLITE = "sqlite"
CQL_STORE_MEMORY = "memory"


@dataclass
class SupervisorConfig:
    astra_cql_store: AstraBundleConfig = field(default_factory=AstraBundleConfig)
    scylla_cql_store: ScyllaCqlStoreConfig = field(default_factory=ScyllaCqlStoreConfig)
    cql_store_type: str = CQL_STORE_SCYLLA
    sqlite_store_path: str = "/var/lib/tpu-nexus/ledger.db"
    kube_config_path: str = ""
    resource_namespace: str = "default"
    log_level: str = "info"
    failure_rate_base_delay: timedelta = timedelta(milliseconds=100)
    failure_rate_max_delay: timedelta = timedelta(seconds=1)
    rate_limit_elements_per_second: float = 10.0
    rate_limit_elements_burst: int = 100
    workers: int = 2
    #: TPU extensions
    failure_lane_rate_per_second: float = 0.0
    failure_lane_workers: int = 4
    watch_jobsets: bool = True
    statsd_address: str = ""
    #: hung-run watchdog: flag RUNNING rows with a frozen ledger progress
    #: fingerprint after this window (0 disables)
    heartbeat_stale_after: timedelta = timedelta(0)
    watchdog_interval: timedelta = timedelta(seconds=30)
    #: preempted-run liveness: escalate a PREEMPTED row to terminal when the
    #: JobSet controller produces no replacement generation within this
    #: deadline (0 disables; must comfortably exceed node-pool reprovision
    #: time — the 5-minute capacity storm of BASELINE config #5 needs
    #: a deadline well past 5m)
    preempted_restart_deadline: timedelta = timedelta(minutes=15)
    #: PREEMPTED sweep: verify each row's tensor_checkpoint_uri manifest and
    #: repoint an unverifiable one at the newest verified step (no-op when
    #: the checkpoint filesystem is unreachable from the supervisor; see
    #: docs/CHECKPOINTS.md)
    watchdog_verify_checkpoints: bool = True
