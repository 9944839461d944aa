"""The port's serving workload: ledger protocol, env contract, isolation.

* ``run_serving`` on ``tiny`` (``device="cpu"``) lands the ledger row
  COMPLETED with heartbeats and returns the JAX package's summary keys;
* ``python -m tpu_nexus_torch.workload`` runs in a subprocess with ``jax``
  and ``tpu_nexus`` blocked from import, against a sqlite ledger;
* ``NEXUS_QUANTIZE``/``NEXUS_QUANT_GROUP``/``NEXUS_QUANTIZE_KV`` parse and
  validate as in the reference (same wording), and a quantized run lands
  COMPLETED in a sqlite ledger;
* ``NEXUS_DEVICE`` defaults to ``cuda`` and raises without a card — the
  workload never carries on on the CPU unasked (lockstep and engine);
* the fleet knobs parse with the reference's values and words (held
  against the JAX package's ``ServeConfig``); ``NEXUS_SERVE_MESH`` (A6)
  raises at parse naming its ROADMAP.md item; the checkpoint knobs parse;
* the entry point's store: memory, sqlite, lazy Scylla and Astra CQL
  stores (the default ``scylla`` included), exit 1 on an unknown type; ``NEXUS_FAULT_MODE`` fires the reference's process modes in the
  lockstep loop;
* no file of the port (nor ``chip_smoke.py``) imports ``jax`` or
  ``tpu_nexus``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxInMemoryStore
from tpu_nexus.models.registry import get_adapter as jax_get_adapter
from tpu_nexus.parallel.distributed import ProcessContext as JaxProcessContext
from tpu_nexus.workload.serve import ServeConfig as JaxServeConfig
from tpu_nexus.workload.serve import run_serving as jax_run_serving
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.cql import AstraCqlStore, ScyllaCqlStore
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore, SqliteCheckpointStore
from tpu_nexus_torch.models.quant import quantized_bytes
from tpu_nexus_torch.models.registry import get_adapter
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.workload import __main__ as entry
from tpu_nexus_torch.workload.serve import ServeConfig, run_serving

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(batch_size=2, prompt_len=8, gen_tokens=4, rounds=3, heartbeat_every=1)


def test_run_serving_lands_completed_with_the_reference_summary():
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="r1", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    summary = run_serving(ServeConfig(device="cpu", **SMALL), store=store, ctx=ctx)
    row = store.read_checkpoint("serve", "r1")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 3}
    assert summary["last_tokens_shape"] == (2, 4)
    assert summary["rounds"] == 3 and summary["decoded_tokens_per_second"] > 0
    jstore = JaxInMemoryStore()
    jctx = JaxProcessContext(run_id="r1", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    ref = jax_run_serving(JaxServeConfig(**dict(SMALL, rounds=1)), store=jstore, ctx=jctx)
    assert set(ref) <= set(summary)


def _serve_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
    env.update(
        NEXUS_MODE="serve", NEXUS_DEVICE="cpu", NEXUS__CQL_STORE_TYPE="sqlite",
        NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"), NEXUS_RUN_ID="sub",
        NEXUS_ALGORITHM="serve", NEXUS_BATCH="2", NEXUS_PROMPT_LEN="8",
        NEXUS_GEN_TOKENS="4", NEXUS_STEPS="2", PYTHONPATH=str(ROOT),
    )
    env.update(extra)
    return env


_BLOCKED_ENTRY = (
    "import runpy, sys; sys.modules['jax'] = None; sys.modules['tpu_nexus'] = None; "
    "sys.argv = ['tpu_nexus_torch.workload']; "
    "runpy.run_module('tpu_nexus_torch.workload', run_name='__main__', alter_sys=True)"
)


def test_entrypoint_serves_with_jax_and_the_reference_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ENTRY], env=_serve_env(tmp_path), cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        row = store.read_checkpoint("serve", "sub")
    finally:
        store.close()
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 2}


def test_entrypoint_trains_on_the_cpu(tmp_path):
    """``NEXUS_MODE=train`` (the entrypoint's default mode) runs the
    training loop on the CPU, with jax and the reference blocked, and
    lands COMPLETED in the sqlite ledger."""
    env = _serve_env(tmp_path, NEXUS_MODE="train", NEXUS_SEQ_LEN="16", NEXUS_STEPS="3",
                     NEXUS_HEARTBEAT_EVERY="1", NEXUS_ALGORITHM="train")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ENTRY], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        row = store.read_checkpoint("train", "sub")
    finally:
        store.close()
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 3}


@pytest.mark.parametrize("mode", ["serve-engines", "bogus"])
def test_entrypoint_refuses_unported_modes(tmp_path, monkeypatch, mode):
    """Every mode of the reference is ported: an unknown mode exits
    non-zero naming the modes there are."""
    for k, v in _serve_env(tmp_path, NEXUS_MODE=mode).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as exc:
        entry.main()
    assert exc.value.code not in (0, None)
    assert "serve-engine" in str(exc.value.code)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny"})
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="NEXUS_DEVICE"):
        run_serving(dataclasses.replace(cfg, **SMALL), store=InMemoryCheckpointStore())


_SLO = {"NEXUS_SLO_SHED_RATE": "0.05"}


@pytest.mark.parametrize(
    "env,field,want",
    [
        ({"NEXUS_ROUTER_POLICY": "round-robin"}, "router_policy", "round-robin"),
        ({"NEXUS_ROUTER_POLICY": "random"}, None, "unknown router_policy"),
        ({"NEXUS_AUTOSCALE_MAX": "4"}, None, "autoscale bounds come as a pair"),
        ({"NEXUS_AUTOSCALE_MIN": "2", "NEXUS_AUTOSCALE_MAX": "4"}, None, "requires NEXUS_SLO_"),
        ({"NEXUS_AUTOSCALE_MIN": "5", "NEXUS_AUTOSCALE_MAX": "4", **_SLO}, None, "max_replicas"),
        ({"NEXUS_SCALE_COOLDOWN_S": "5"}, "scale_cooldown_s", 5.0),
        ({"NEXUS_AUTOSCALE_MIN": "2", "NEXUS_AUTOSCALE_MAX": "4", "NEXUS_SCALE_UP_N": "1",
          "NEXUS_SCALE_DOWN_N": "2", "NEXUS_SCALE_COOLDOWN_S": "5", **_SLO}, "autoscale_config", (2, 4, 1, 2, 5.0)),
        ({"NEXUS_SERVE_MESH": "tp=2", "NEXUS_DEVICE": "cpu", "NEXUS_RANK_DEVICE_MAP": "shared"}, "serve_mesh",
         "tp=2"),
    ],
    ids=["router_policy", "unknown_policy", "autoscale_max_alone", "autoscale_without_slo", "autoscale_min_over_max",
         "scale_cooldown", "autoscale_config", "serve_mesh"],
)
def test_unported_knobs_raise_at_parse(env, field, want):
    """The fleet knobs and ``NEXUS_SERVE_MESH`` parse with the reference's
    checks and words (each case is held against the JAX package's
    ``ServeConfig.from_env`` on the same env; the mesh's two ranks share
    the CPU under the explicit rehearsal map)."""
    if field is None and "A6" in want:
        with pytest.raises(NotImplementedError, match=want):
            ServeConfig.from_env(env)
        return
    if field is None:
        with pytest.raises(ValueError, match=want) as port_exc:
            ServeConfig.from_env(env)
        with pytest.raises(ValueError) as jax_exc:
            JaxServeConfig.from_env(env)
        assert str(port_exc.value) == str(jax_exc.value)
        return
    cfg, ref = ServeConfig.from_env(env), JaxServeConfig.from_env(env)
    if field == "autoscale_config":
        got = cfg.autoscale_config()
        assert (got.min_replicas, got.max_replicas, got.scale_up_after, got.scale_down_after, got.cooldown_s) == want
        assert dataclasses.asdict(got) == dataclasses.asdict(ref.autoscale_config())
        return
    assert getattr(cfg, field) == want == getattr(ref, field)


@pytest.mark.parametrize(
    "env,field,want",
    [
        ({"NEXUS_CHECKPOINT_DIR": "/ckpt"}, "checkpoint_dir", "/ckpt"),
        ({"NEXUS_RELOAD_CHECK_S": "2", "NEXUS_CHECKPOINT_DIR": "/ckpt"}, "reload_check_interval_s", 2.0),
    ],
)
def test_checkpoint_knobs_parse(env, field, want):
    """Serving from checkpoints and hot reload are ported: the knobs parse
    (serving from a directory runs in test_torch_reload)."""
    assert getattr(ServeConfig.from_env(env), field) == want


@pytest.mark.parametrize(
    "env,want",
    [
        ({"NEXUS_QUANTIZE": "int8"}, ("int8", 0, "")),
        ({"NEXUS_QUANTIZE": "int4", "NEXUS_QUANT_GROUP": "32"}, ("int4", 32, "")),
        ({"NEXUS_QUANTIZE_KV": "int8"}, ("", 0, "int8")),
        ({"NEXUS_QUANTIZE": "int4", "NEXUS_QUANT_GROUP": "", "NEXUS_QUANTIZE_KV": "int8"}, ("int4", 0, "int8")),
    ],
)
def test_quantize_knobs_parse(env, want):
    cfg = ServeConfig.from_env(dict(env, NEXUS_MODEL_PRESET="tiny"))
    assert (cfg.quantize, cfg.quant_group, cfg.quantize_kv) == want
    ref = JaxServeConfig.from_env(dict(env, NEXUS_MODEL_PRESET="tiny"))
    assert (ref.quantize, ref.quant_group, ref.quantize_kv) == want


#: what tests/test_quant_serving.py::TestServeConfigQuant pins, wording included
_BAD_QUANT = [
    (dict(quantize="fp4"), "unknown quantize mode 'fp4'"),
    (dict(quantize="int4", quant_group=-8), "NEXUS_QUANT_GROUP.*got -8"),
    (dict(quantize="int8", quant_group=64), "NEXUS_QUANT_GROUP=64.*quantize='int4'.*'int8'"),
    (dict(quant_group=64), "NEXUS_QUANT_GROUP=64"),
    (dict(quantize="int4", quant_group=9), "must be even.*got 9"),
    (dict(quantize="int4", quant_group=48), "NEXUS_QUANT_GROUP=48.*64 hidden"),
    (dict(quantize="int4", quant_group=128), "NEXUS_QUANT_GROUP=128.*64 hidden"),
    (dict(quantize_kv="fp8"), "unknown quantize_kv mode 'fp8'"),
]


@pytest.mark.parametrize("kwargs,match", _BAD_QUANT)
def test_bad_quantize_values_raise_with_the_reference_wording(kwargs, match):
    with pytest.raises(ValueError, match=match) as port_exc:
        ServeConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as ref_exc:
        JaxServeConfig(**kwargs)
    assert str(port_exc.value) == str(ref_exc.value)


def test_bad_quantize_env_values_raise_value_errors_at_parse():
    for env in ({"NEXUS_QUANTIZE": "fp4"}, {"NEXUS_QUANT_GROUP": "32"}, {"NEXUS_QUANTIZE_KV": "int4"},
                {"NEXUS_QUANTIZE": "int4", "NEXUS_QUANT_GROUP": "6"}):
        with pytest.raises(ValueError):
            ServeConfig.from_env(dict(env, NEXUS_MODEL_PRESET="tiny"))
    assert ServeConfig(quantize="int4", quant_group=16).quant_group == 16
    # the group must divide the contraction widths of the model that is served
    with pytest.raises(ValueError, match="14336 intermediate"):
        ServeConfig.from_env({"NEXUS_MODEL_PRESET": "llama3_8b", "NEXUS_QUANTIZE": "int4",
                              "NEXUS_QUANT_GROUP": "4096"})


@pytest.mark.parametrize(
    "quant", [dict(quantize="int8", quantize_kv="int8"), dict(quantize="int4"), dict(quantize="int4", quant_group=16)],
    ids=["int8+int8kv", "int4", "int4-g16"],
)
def test_run_serving_quantized_lands_completed_in_a_sqlite_ledger(tmp_path, caplog, quant):
    caplog.set_level("INFO", logger="tpu_nexus_torch.workload.serve")
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    ctx = ProcessContext(run_id="q1", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    try:
        summary = run_serving(ServeConfig(device="cpu", **SMALL, **quant), store=store, ctx=ctx)
        row = store.read_checkpoint("serve", "q1")
    finally:
        store.close()
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 3}
    assert summary["last_tokens_shape"] == (2, 4)
    # the quantized tree's footprint is logged, and is smaller than the f32 tree's
    (logged,) = [r.args for r in caplog.records if "weight-only quantization" in r.msg]
    dense = get_adapter("tiny").init(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert logged[0] == quant["quantize"] and 0 < logged[1] < quantized_bytes(dense)


def test_run_serving_moe_preset_lands_completed():
    """``run_serving`` on ``moe_tiny`` (decoded with scatter dispatch at a
    dropless capacity) lands COMPLETED with the reference's summary keys."""
    cfg = ServeConfig.from_env({"NEXUS_MODEL_PRESET": "moe_tiny", "NEXUS_DEVICE": "cpu", "NEXUS_BATCH": "2",
                                "NEXUS_PROMPT_LEN": "8", "NEXUS_GEN_TOKENS": "4", "NEXUS_STEPS": "3",
                                "NEXUS_HEARTBEAT_EVERY": "1"})
    assert cfg.model.name == "moe"
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="m1", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    summary = run_serving(cfg, store=store, ctx=ctx)
    row = store.read_checkpoint("serve", "m1")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 3}
    assert summary["last_tokens_shape"] == (2, 4)
    jstore = JaxInMemoryStore()
    jctx = JaxProcessContext(run_id="m1", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    ref = jax_run_serving(JaxServeConfig(model=jax_get_adapter("moe_tiny"), **dict(SMALL, rounds=1)),
                          store=jstore, ctx=jctx)
    assert set(ref) <= set(summary)


def test_entrypoint_serves_quantized_with_jax_and_the_reference_blocked(tmp_path):
    env = _serve_env(tmp_path, NEXUS_QUANTIZE="int4", NEXUS_QUANT_GROUP="16", NEXUS_QUANTIZE_KV="int8")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_ENTRY], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "serving with int4 weight-only quantization" in proc.stderr
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        row = store.read_checkpoint("serve", "sub")
    finally:
        store.close()
    assert row.lifecycle_stage == LifecycleStage.COMPLETED


def test_engine_knobs_at_their_defaults_parse():
    env = {"NEXUS_OVERLAP": "0"}
    cfg = ServeConfig.from_env(dict(env, NEXUS_DECODE_KERNEL="plain", NEXUS_DEVICE="cpu"))
    assert cfg.decode_kernel == "plain" and cfg.device == "cpu"
    with pytest.raises(ValueError, match="decode_kernel"):
        ServeConfig.from_env({"NEXUS_DECODE_KERNEL": "pallas"})


@pytest.mark.parametrize(
    "env,want",
    [
        ({"NEXUS__CQL_STORE_TYPE": "memory"}, InMemoryCheckpointStore),
        ({"NEXUS__CQL_STORE_TYPE": "sqlite", "NEXUS__SQLITE_STORE_PATH": "{tmp}/ledger.db"}, SqliteCheckpointStore),
        ({"NEXUS__CQL_STORE_TYPE": "scylla", "NEXUS__SCYLLA_CQL_STORE__HOSTS": "10.0.0.7",
          "NEXUS__SCYLLA_CQL_STORE__PORT": "19042"}, ScyllaCqlStore),
        ({"NEXUS__CQL_STORE_TYPE": "astra"}, AstraCqlStore),
        ({}, ScyllaCqlStore),  # SupervisorConfig's default, scylla, as in the reference
        ({"NEXUS__CQL_STORE_TYPE": "redis"}, SystemExit),
    ],
    ids=["memory", "sqlite", "scylla", "astra", "default", "unknown"],
)
def test_store_from_env(tmp_path, monkeypatch, env, want):
    """The entry point's ledger store comes from the supervisor's config
    mechanism (``load_config(SupervisorConfig)`` + ``ApplicationServices``):
    memory and sqlite resolve; the CQL kinds, and the dataclass default
    with no appconfig file found, build lazy CQL stores (no I/O until the
    first query: nothing listens on the named host); an unknown kind exits
    1, as the reference's entry point does."""
    monkeypatch.chdir(tmp_path)  # no appconfig.yaml on the search path
    monkeypatch.delenv("TPU_NEXUS_CONFIG_DIR", raising=False)
    env = {k: v.format(tmp=tmp_path) for k, v in env.items()}
    if want is SystemExit:
        with pytest.raises(SystemExit) as exc:
            entry.store_from_env(env)
        assert exc.value.code == 1
        return
    store = entry.store_from_env(env)
    try:
        assert type(store) is want
        if want is SqliteCheckpointStore:
            assert store._path == str(tmp_path / "ledger.db")
        if want is ScyllaCqlStore and env:
            assert (store.hosts, store.port) == (["10.0.0.7"], 19042)
        if want is not SqliteCheckpointStore and want is not InMemoryCheckpointStore:
            assert store._conn is None  # lazy: constructing it opened nothing
    finally:
        store.close()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_the_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "tpu_nexus_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "tpu_nexus")
    ]
    assert bad == []


@pytest.mark.parametrize(
    "mode,exc,match",
    [("hbm-oom", RuntimeError, "RESOURCE_EXHAUSTED"), ("step-ici", ValueError, "NEXUS_MODE=serve-engine")],
)
def test_lockstep_serving_injects_the_reference_fault_modes(monkeypatch, mode, exc, match):
    """``NEXUS_FAULT_MODE`` parses now: the lockstep loop fires a process
    mode at its round with the reference's wording, and refuses an
    executor mode, which only the engine can inject."""
    monkeypatch.setenv("NEXUS_FAULT_MODE", mode)
    monkeypatch.setenv("NEXUS_FAULT_STEP", "1")
    cfg = dataclasses.replace(ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny"}), device="cpu", **SMALL)
    store = InMemoryCheckpointStore()
    with pytest.raises(exc, match=match):
        run_serving(cfg, store=store)


def test_serve_engine_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from tpu_nexus_torch.workload.serve import run_serve_engine

    cfg = ServeConfig.from_env({"NEXUS_MODEL_PRESET": "tiny", "NEXUS_PAGE_SIZE": "4"})
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="NEXUS_DEVICE"):
        run_serve_engine(dataclasses.replace(cfg, **SMALL), store=InMemoryCheckpointStore())
