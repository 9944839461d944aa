"""The port's counterpart of ``tests/test_app.py`` (``tpu_nexus_torch``).

App composition tests (reference app/app_dependencies.go behavior:
nil-guarded singletons, store-type selection, fatal on unknown type,
end-to-end Start)."""

import asyncio
import uuid
from datetime import timedelta

import pytest

from tpu_nexus_torch.app.config import SupervisorConfig
from tpu_nexus_torch.app.dependencies import ApplicationServices
from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.k8s.fake import FakeKubeClient

from test_torch_supervisor import ALGORITHM, NS, event_obj, job_obj, pod_obj


def test_unknown_store_type_fatal():
    cfg = SupervisorConfig(cql_store_type="bogus")
    services = ApplicationServices(fatal_exit=False)
    with pytest.raises(RuntimeError, match="unknown cql-store-type"):
        services.with_store_for(cfg)


def test_builder_is_idempotent_singleton():
    cfg = SupervisorConfig(cql_store_type="memory")
    services = ApplicationServices(fatal_exit=False).with_memory_store()
    first = services.store
    services.with_store_for(cfg)  # second build attempt must be a no-op
    services.with_memory_store()
    assert services.store is first


async def test_end_to_end_start_processes_event():
    rid = str(uuid.uuid4())
    client = FakeKubeClient(
        {
            "Job": [job_obj(rid)],
            "Pod": [pod_obj(rid)],
            "Event": [event_obj("FailedCreate", "no quota", "Job", rid)],
        }
    )
    cfg = SupervisorConfig(
        cql_store_type="memory",
        resource_namespace=NS,
        failure_rate_base_delay=timedelta(milliseconds=5),
        failure_rate_max_delay=timedelta(milliseconds=50),
        rate_limit_elements_per_second=0,
    )
    services = (
        ApplicationServices(fatal_exit=False)
        .with_store_for(cfg)
        .with_fake_kube_client(client)
        .with_supervisor(cfg, resync_period=timedelta(0))
    )
    services.store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.BUFFERED)
    )
    ctx = LifecycleContext()
    task = asyncio.create_task(services.start(ctx, cfg))
    await asyncio.sleep(0.05)
    assert await services.supervisor.idle(timeout=10)
    ctx.cancel()
    await task
    cp = services.store.read_checkpoint(ALGORITHM, rid)
    assert cp.lifecycle_stage == LifecycleStage.SCHEDULING_FAILED
    assert rid in client.deleted("Job")


def test_main_runs_the_supervisor_from_appconfig_and_env(tmp_path, monkeypatch):
    """``python -m tpu_nexus_torch.main``'s ``run()``: the config comes from
    an ``appconfig.yaml`` on the search path plus ``NEXUS__*`` env, the
    store by its cql-store-type (sqlite here), and the supervisor runs over
    the kube client's plane — the test's fake, seeded with a failing run —
    until the signal context is cancelled."""
    import logging
    import threading
    import time

    from tpu_nexus_torch import main as entry
    from tpu_nexus_torch.app import dependencies
    from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore

    (tmp_path / "appconfig.yaml").write_text(
        "cql-store-type: scylla\nresource-namespace: elsewhere\nworkers: 2\n"
        "failure-rate-base-delay: 5ms\nfailure-rate-max-delay: 50ms\nrate-limit-elements-per-second: 0\n"
    )
    ledger = str(tmp_path / "ledger.db")
    monkeypatch.setenv("TPU_NEXUS_CONFIG_DIR", str(tmp_path))
    monkeypatch.setenv("NEXUS__CQL_STORE_TYPE", "sqlite")
    monkeypatch.setenv("NEXUS__SQLITE_STORE_PATH", ledger)
    monkeypatch.setenv("NEXUS__RESOURCE_NAMESPACE", NS)
    monkeypatch.delenv("APPLICATION_ENVIRONMENT", raising=False)
    rid = str(uuid.uuid4())
    store = SqliteCheckpointStore(ledger)
    store.upsert_checkpoint(
        CheckpointedRequest(algorithm=ALGORITHM, id=rid, lifecycle_stage=LifecycleStage.BUFFERED)
    )
    client = FakeKubeClient(
        {"Job": [job_obj(rid)], "Pod": [pod_obj(rid)],
         "Event": [event_obj("FailedCreate", "no quota", "Job", rid)]}
    )
    built = {}

    def fake_plane(self, config):
        built["config"] = config
        return self.with_fake_kube_client(client)

    ctx = LifecycleContext()
    monkeypatch.setattr(dependencies.ApplicationServices, "with_kube_client", fake_plane)
    monkeypatch.setattr(entry, "setup_signal_context", lambda: ctx)
    lg = logging.getLogger("tpu_nexus_torch")
    saved = (lg.propagate, list(lg.handlers), lg.level)
    worker = threading.Thread(target=entry.run, daemon=True)
    worker.start()
    try:
        deadline = time.monotonic() + 30
        stage = None
        while time.monotonic() < deadline:
            cp = store.read_checkpoint(ALGORITHM, rid)
            stage = cp.lifecycle_stage if cp else None
            if stage == LifecycleStage.SCHEDULING_FAILED and rid in client.deleted("Job"):
                break
            time.sleep(0.02)
    finally:
        ctx.cancel()
        worker.join(timeout=30)
        lg.propagate, lg.handlers[:] = saved[0], saved[1]
        lg.setLevel(saved[2])
        store.close()
    assert not worker.is_alive()
    assert stage == LifecycleStage.SCHEDULING_FAILED
    assert rid in client.deleted("Job")
    cfg = built["config"]
    assert (cfg.cql_store_type, cfg.sqlite_store_path, cfg.resource_namespace, cfg.workers) == (
        "sqlite", ledger, NS, 2)
