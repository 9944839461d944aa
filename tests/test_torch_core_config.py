"""The port's counterpart of ``tests/test_core_config.py`` (``tpu_nexus_torch``).

Unit tests for the config loader (nexus-core LoadConfig parity, SURVEY §2.3)."""

from dataclasses import dataclass, field
from datetime import timedelta
from typing import List

import pytest

from tpu_nexus_torch.core.config import ConfigError, bind, load_config, parse_duration


@dataclass
class ScyllaStoreConfig:
    hosts: List[str] = field(default_factory=list)
    port: int = 9042
    user: str = ""
    password: str = ""
    local_dc: str = ""


@dataclass
class DemoConfig:
    scylla_cql_store: ScyllaStoreConfig = field(default_factory=ScyllaStoreConfig)
    cql_store_type: str = "scylla"
    resource_namespace: str = ""
    workers: int = 2
    failure_rate_base_delay: timedelta = timedelta(milliseconds=100)


def test_parse_duration_go_style():
    assert parse_duration("100ms") == timedelta(milliseconds=100)
    assert parse_duration("1s") == timedelta(seconds=1)
    assert parse_duration("2m30s") == timedelta(seconds=150)
    assert parse_duration("1.5s") == timedelta(seconds=1.5)
    assert parse_duration(5) == timedelta(seconds=5)
    with pytest.raises(ConfigError):
        parse_duration("1 fortnight")


def test_bind_kebab_keys_and_nesting():
    cfg = bind(
        {
            "cql-store-type": "astra",
            "resource-namespace": "nexus",
            "workers": "4",
            "failure-rate-base-delay": "250ms",
            "scylla-cql-store": {"hosts": ["a", "b"], "port": "19042", "local-dc": "dc1"},
        },
        DemoConfig,
    )
    assert cfg.cql_store_type == "astra"
    assert cfg.workers == 4
    assert cfg.failure_rate_base_delay == timedelta(milliseconds=250)
    assert cfg.scylla_cql_store.hosts == ["a", "b"]
    assert cfg.scylla_cql_store.port == 19042
    assert cfg.scylla_cql_store.local_dc == "dc1"


def test_empty_string_is_zero_value():
    # the reference's appconfig.local.yaml uses "" for unset ints (workers: "")
    cfg = bind({"workers": ""}, DemoConfig)
    assert cfg.workers == 0


def test_load_config_file_env_overlay_and_overrides(tmp_path):
    (tmp_path / "appconfig.yaml").write_text(
        "cql-store-type: scylla\nresource-namespace: base\nworkers: 2\n"
        "scylla-cql-store:\n  hosts: [h1]\n  port: 9042\n"
    )
    (tmp_path / "appconfig.units.yaml").write_text("resource-namespace: units-ns\n")
    environ = {
        "APPLICATION_ENVIRONMENT": "units",
        "NEXUS__WORKERS": "8",
        "NEXUS__SCYLLA_CQL_STORE__HOSTS": "h2,h3",
    }
    cfg = load_config(DemoConfig, config_dir=str(tmp_path), environ=environ)
    assert cfg.resource_namespace == "units-ns"  # overlay wins over base
    assert cfg.workers == 8  # env wins over file
    assert cfg.scylla_cql_store.hosts == ["h2", "h3"]  # nested env override
    assert cfg.cql_store_type == "scylla"  # untouched base value


def test_load_config_defaults_when_no_file(tmp_path):
    cfg = load_config(DemoConfig, config_dir=str(tmp_path), environ={})
    assert cfg.workers == 2
    assert cfg.scylla_cql_store.port == 9042
