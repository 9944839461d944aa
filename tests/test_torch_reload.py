"""Serving from the port's tensor checkpoints, and their hot reload, on the
CPU (tiny model, f32, greedy).

* serving from a checkpoint is token-identical across the packages: the
  JAX package's ``_load_serving_params`` reads an Orbax directory, the
  port's reads its own directory of the same weights (carried across with
  ``models/convert.py::params_from_numpy``);
* the restore is read-only (a corrupt newest step is skipped, never
  quarantined), and steps that exist but none verify refuse to serve;
* ``_reload_if_newer(engine, latest, dir, current, quantize, grace_s)``
  swaps on a newer verified step (post-swap tokens are the new params'
  own), and keeps the old weights on a corrupt candidate, on a tree that
  does not fit, and on a quantize mode the engine does not serve;
* ``run_serve_engine`` with ``NEXUS_RELOAD_CHECK_S`` adopts a step
  committed mid-run, and the entry point serves both modes from a
  checkpoint with ``jax`` and ``tpu_nexus`` blocked from import;
* nxlint's NX007 (publish only after commit) and NX008 (swap only
  verified params) scan the port's workload and serving modules clean.

Tolerance: none — tokens are compared exactly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models.generate import generate as jax_generate
from tpu_nexus.parallel.distributed import ProcessContext as JaxContext
from tpu_nexus.workload import serve as jax_serve
from tpu_nexus.workload.tensor_checkpoint import TensorCheckpointer as JaxCheckpointer
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore, SqliteCheckpointStore
from tpu_nexus_torch.core.signals import LifecycleContext
from tpu_nexus_torch.models.generate import generate as port_generate
from tpu_nexus_torch.models.llama import llama_init
from tpu_nexus_torch.models.registry import LlamaAdapter
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.serving import ModelExecutor, RequestState, ServingEngine
from tpu_nexus_torch.serving.fleet import CheckpointWatcher
from tpu_nexus_torch.workload import durability
from tpu_nexus_torch.workload.faults import flip_committed_leaf
from tpu_nexus_torch.workload.serve import (
    ServeConfig,
    _load_serving_params,
    _reload_if_newer,
    run_serve_engine,
    run_serving,
)
from tpu_nexus_torch.workload.tensor_checkpoint import CheckpointError, TensorCheckpointer
from test_torch_llama import carried, tiny_configs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CTX = ProcessContext(run_id="r-serve", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
JCFG, PCFG = tiny_configs()
PROMPT = np.arange(1, 9, dtype=np.int64)


def _params(seed):
    return llama_init(torch.Generator().manual_seed(seed), PCFG, device="cpu")


def _commit(directory, step, params):
    ckpt = TensorCheckpointer(str(directory))
    ckpt.save(step, {"params": params, "step": torch.tensor(step, dtype=torch.int32)})
    return ckpt.commit(step)


def _own_tokens(params, prompt, n):
    out = port_generate(params, torch.as_tensor(prompt)[None], PCFG, max_new_tokens=n)
    return out[0].tolist()


def _engine(params):
    return ServingEngine(ModelExecutor(params, PCFG, num_slots=2, max_len=16))


def _serve_cfg(**over):
    base = dict(model=LlamaAdapter(config=PCFG), batch_size=2, prompt_len=8, gen_tokens=4, rounds=3,
                heartbeat_every=1, device="cpu")
    base.update(over)
    return ServeConfig(**base)


# -- serving from a checkpoint ---------------------------------------------------


def test_serving_from_a_checkpoint_is_token_identical_to_the_jax_package(tmp_path):
    jparams, pparams = carried(JCFG, PCFG, seed=3)
    jckpt = JaxCheckpointer(str(tmp_path / "jax"))
    jckpt.save(7, {"params": jparams})
    jckpt.commit(7)
    jckpt.close()
    _commit(tmp_path / "port", 7, pparams)
    jax_cfg = jax_serve.ServeConfig(model=JCFG, checkpoint_dir=str(tmp_path / "jax"))
    _, _, jrestored, jstep = jax_serve._load_serving_params(
        jax_cfg, JaxContext(run_id="r", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    )
    _, _, prestored, pstep = _load_serving_params(
        _serve_cfg(checkpoint_dir=str(tmp_path / "port")), CTX, torch.device("cpu")
    )
    assert jstep == pstep == 7
    prompt = np.random.default_rng(0).integers(0, JCFG.vocab_size, size=(3, 16)).astype(np.int32)
    ref = jax_generate(jrestored, jnp.asarray(prompt), JCFG, max_new_tokens=12)
    out = port_generate(prestored, torch.from_numpy(prompt), PCFG, max_new_tokens=12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # and the restored weights are the ones that were saved, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(prestored.parameters(), pparams.parameters()))
    assert jax.tree.all(jax.tree.map(lambda a, b: bool((a == b).all()), jrestored, jparams))


def test_run_serving_restores_read_only_past_a_corrupt_step(tmp_path):
    _commit(tmp_path, 2, _params(0))
    _commit(tmp_path, 4, _params(1))
    flip_committed_leaf(str(tmp_path / "4"))
    store = InMemoryCheckpointStore()
    result = run_serving(_serve_cfg(checkpoint_dir=str(tmp_path)), store=store, ctx=CTX)
    assert result["restored_from"] == 2
    assert store.read_checkpoint("serve", "r-serve").lifecycle_stage == LifecycleStage.COMPLETED
    assert sorted(os.listdir(tmp_path)) == ["2", "4"]  # serving never quarantines


def test_serving_refuses_fresh_weights_when_no_step_verifies(tmp_path):
    _commit(tmp_path, 2, _params(0))
    os.remove(tmp_path / "2" / durability.MANIFEST_NAME)
    with pytest.raises(CheckpointError, match="none verify"):
        run_serving(_serve_cfg(checkpoint_dir=str(tmp_path)), store=InMemoryCheckpointStore(), ctx=CTX)
    # an empty directory is a fresh start, not a refusal
    result = run_serving(_serve_cfg(checkpoint_dir=str(tmp_path / "empty")), store=InMemoryCheckpointStore(),
                         ctx=CTX)
    assert result["restored_from"] is None


# -- _reload_if_newer ------------------------------------------------------------


def test_reload_if_newer_swaps_on_a_newer_verified_step(tmp_path):
    old, new = _params(0), _params(1)
    _commit(tmp_path, 1, old)
    poller = durability.VerifiedStepPoller(str(tmp_path))
    eng = _engine(old)
    # no newer step: a no-op that never touches the engine
    assert _reload_if_newer(eng, poller.latest_verified_step(), str(tmp_path), 1, "", 5.0) == 1
    assert eng.weight_swaps == 0
    _commit(tmp_path, 2, new)
    assert _reload_if_newer(eng, poller.latest_verified_step(), str(tmp_path), 1, "", 5.0) == 2
    assert eng.weight_swaps == 1 and not eng.admission_paused
    req = eng.submit(PROMPT, 5)
    eng.run_until_drained(max_steps=500)
    assert req.state == RequestState.FINISHED
    assert list(req.output_tokens) == _own_tokens(new, PROMPT, 5) != _own_tokens(old, PROMPT, 5)


def test_reload_keeps_old_weights_on_a_corrupt_candidate(tmp_path):
    old = _params(0)
    _commit(tmp_path, 1, old)
    _commit(tmp_path, 2, _params(1))
    poller = durability.VerifiedStepPoller(str(tmp_path))
    assert poller.latest_verified_step() == 2  # the marker cached as good ...
    flip_committed_leaf(str(tmp_path / "2"))  # ... then silent rot
    eng = _engine(old)
    assert _reload_if_newer(eng, poller.latest_verified_step(), str(tmp_path), 1, "", 5.0) == 1
    assert eng.weight_swaps == 0 and eng.executor.params is old and not eng.admission_paused
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]


def test_reload_keeps_old_weights_on_a_spec_mismatch(tmp_path):
    old = _params(0)
    wider = llama_init(torch.Generator().manual_seed(1), dataclasses.replace(PCFG, n_layers=3), device="cpu")
    _commit(tmp_path, 2, wider)
    eng = _engine(old)
    req = eng.submit(PROMPT, 3)
    assert _reload_if_newer(eng, 2, str(tmp_path), 1, "", 5.0) == 1
    assert eng.weight_swaps == 0 and eng.executor.params is old and not eng.admission_paused
    eng.run_until_drained(max_steps=500)
    assert req.state == RequestState.FINISHED and list(req.output_tokens) == _own_tokens(old, PROMPT, 3)


def test_reload_refuses_a_quantize_mode_the_engine_does_not_serve(tmp_path):
    old = _params(0)
    _commit(tmp_path, 2, _params(1))
    eng = _engine(old)
    assert _reload_if_newer(eng, 2, str(tmp_path), 1, "int8", 5.0) == 1
    assert eng.weight_swaps == 0 and eng.executor.params is old


def test_run_serve_engine_adopts_a_step_committed_mid_run(tmp_path):
    old, new = _params(0), _params(1)
    _commit(tmp_path, 1, old)
    prompts = np.random.default_rng(1).integers(1, PCFG.vocab_size, size=(4, 2, 8))

    def stream():
        for i, batch in enumerate(prompts):
            if i == 2:  # the warmup and the first round were served on step 1
                _commit(tmp_path, 2, new)
            yield batch

    store = InMemoryCheckpointStore()
    result = run_serve_engine(
        _serve_cfg(checkpoint_dir=str(tmp_path), reload_check_interval_s=1e-3), store=store, ctx=CTX,
        prompts=stream(), lifecycle=LifecycleContext(),
    )
    assert result["restored_from"] == 1 and result["serving_step"] == 2
    assert result["weight_reloads"] == 1
    assert result["requests"] == result["finished"] == 6
    assert store.read_checkpoint("serve", "r-serve").lifecycle_stage == LifecycleStage.COMPLETED


# -- config and watcher ------------------------------------------------------------


def test_reload_knob_parses_and_requires_a_directory():
    cfg = ServeConfig.from_env({"NEXUS_RELOAD_CHECK_S": "7.5", "NEXUS_CHECKPOINT_DIR": "/tmp/x"})
    assert cfg.reload_check_interval_s == 7.5 and cfg.checkpoint_dir == "/tmp/x"
    assert ServeConfig.from_env({}).reload_check_interval_s == 0.0
    with pytest.raises(ValueError, match="NEXUS_CHECKPOINT_DIR"):
        ServeConfig.from_env({"NEXUS_RELOAD_CHECK_S": "5"})
    with pytest.raises(ValueError, match="reload_check_interval_s"):
        ServeConfig(reload_check_interval_s=-1.0, checkpoint_dir="/tmp/x")


def test_checkpoint_watcher_is_interval_gated(tmp_path):
    _commit(tmp_path, 3, _params(0))
    now = [100.0]
    watcher = CheckpointWatcher(str(tmp_path), interval_s=5.0, clock=lambda: now[0])
    assert watcher.check() == 3 and watcher.poller.scans == 1
    _commit(tmp_path, 5, _params(1))
    now[0] += 1.0
    assert watcher.check() is None  # between checks
    now[0] += 5.0
    assert watcher.check() == 5
    with pytest.raises(ValueError, match="interval_s"):
        CheckpointWatcher(str(tmp_path), interval_s=0)


# -- the entry point, with the JAX package blocked ------------------------------------

_BLOCKED_ENTRY = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_nexus"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, _Block())
from tpu_nexus_torch.workload.__main__ import main
sys.exit(main())
"""


@pytest.mark.parametrize(
    "mode,extra",
    [("serve", {}), ("serve-engine", {"NEXUS_RELOAD_CHECK_S": "0.01", "NEXUS_PAGE_SIZE": "4"})],
)
def test_entrypoint_serves_from_a_checkpoint_with_jax_blocked(tmp_path, mode, extra):
    from tpu_nexus_torch.models.registry import get_adapter

    params = get_adapter("tiny").init(torch.Generator().manual_seed(9), "cpu")
    _commit(tmp_path / "ckpt", 4, params)
    env = dict(
        os.environ, PYTHONPATH=str(ROOT), NEXUS_MODE=mode, NEXUS_DEVICE="cpu", NEXUS_MODEL_PRESET="tiny",
        NEXUS_BATCH="2", NEXUS_STEPS="2", NEXUS_PROMPT_LEN="8", NEXUS_GEN_TOKENS="4", NEXUS_RUN_ID="ckpt",
        NEXUS_ALGORITHM="serve", NEXUS__CQL_STORE_TYPE="sqlite", OMP_NUM_THREADS="1",
        NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"), NEXUS_CHECKPOINT_DIR=str(tmp_path / "ckpt"), **extra,
    )
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_ENTRY], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "restored verified tensor checkpoint at step 4" in proc.stderr
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        assert store.read_checkpoint("serve", "ckpt").lifecycle_stage == LifecycleStage.COMPLETED
    finally:
        store.close()


# -- static gates ----------------------------------------------------------------------


def test_publish_and_swap_rules_scan_the_port_clean():
    """NX007 and NX008 run over the port's workload and serving modules
    (a non-zero count of them) and find nothing; the same rules flag a
    publish before the commit and a swap of unverified params written in
    the port's idiom, so the clean verdict is not vacuous."""
    from tools.nxlint.engine import Module, Project, all_rules, collect_modules, lint_project

    rules = [r for r in all_rules() if r.rule_id in ("NX007", "NX008")]
    assert len(rules) == 2
    paths = [str(ROOT / "tpu_nexus_torch" / "workload"), str(ROOT / "tpu_nexus_torch" / "serving")]
    modules = collect_modules(paths, str(ROOT))
    names = {m.rel_path for m in modules}
    assert {"tpu_nexus_torch/workload/harness.py", "tpu_nexus_torch/workload/serve.py",
            "tpu_nexus_torch/serving/engine.py"} <= names
    assert lint_project(Project(str(ROOT), modules), rules=rules) == []
    bad = (
        "def publish(ckpt, reporter, state, step):\n"
        "    uri = ckpt.save(step, state)\n"
        "    reporter.tensor_checkpoint(uri, step)\n"
        "\n"
        "def swap(engine, ckpt):\n"
        "    engine.swap_params(ckpt.latest_step())\n"
    )
    found = lint_project(Project("/virtual", [Module("/virtual/bad.py", "bad.py", bad)]), rules=rules)
    assert sorted(f.rule_id for f in found) == ["NX007", "NX008"]
