"""Serving across launched processes and over every serve-mesh axis, held
against the JAX package.

The JAX package serves wherever ``NEXUS_NUM_PROCESSES`` and
``NEXUS_SERVE_MESH`` point it: every launched process runs the serving
loop, a serve mesh spans the processes' devices, and the mesh's ``pp``,
``dp``, ``fsdp`` and ``sp`` axes replicate (its serving rule table maps
only ``tp`` and ``ep``).  The port's ranks are processes over gloo on the
CPU, all on the one CPU device under the explicit rehearsal map.

* **One pool across two launched processes** (the module's): this pytest
  process is process 0 — the leader and one spawned local rank, global
  ranks 0-1 — and ``python -m tpu_nexus_torch.workload`` with
  ``NEXUS_PROCESS_ID=1`` is process 1, which serves global ranks 2-3 until
  the leader's exit.  A tp-2 replica over ranks (0, 2) spans the two
  processes; over ranks (0, 1) it is the one-process pool's replica.
  f32 greedy tokens equal the JAX package's ``ShardedModelExecutor`` /
  ``ShardedPagedModelExecutor`` at tp 2, paged and contiguous.  A
  disaggregated fleet hands each request's KV from the replica across the
  processes to process 0's replica, with the same tokens.
* **Replicate axes** over all four ranks: dense ``dp=2,tp=2`` and
  ``pp=2,tp=2``, MoE ``fsdp=2,ep=2`` and ``ep=2,sp=2`` (whose ``(ep, tp)``
  regions, ranks (0, 2) and (1, 3), are not contiguous).  Tokens equal the
  JAX package's sharded executors on the same mesh; the two copies launch
  the same kernels and run the same collectives with the same bytes (on
  the CPU the launch counters stay 0: the plain path), and each MoE rank's
  combine sums over its own copy's region.  Meshes and configs the JAX
  package refuses, the port refuses alike, in the same words.
* **Entry points over two launched processes**: serve-engine without a
  mesh (a copy each) and with one (a replica across them) — RUNNING, both
  processes' ``host<p>/chip0`` keys, exactly one terminal write, by the
  coordinator; the lockstep loop, with and without ``NEXUS_SERVE_MESH``
  (which it does not read), each process's tokens equal to the JAX
  package's ``run_serving`` under the same env and weights; SIGTERM to
  both processes lands PREEMPTED with both exiting 0; a killed process
  fails the replica inside ``NEXUS_DIST_TIMEOUT_S``, the row FAILED with
  the lost rank named.

The coordinator's port of every pair of launched processes is held bound
(``distributed.reserved_port``) until process 0 listens on it, so no other
socket of a busy host can take it in between.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_nexus.serving as jax_serving
import tpu_nexus.serving.sharded as jax_sharded
import tpu_nexus.workload.serve as jax_serve
from tpu_nexus.checkpoint.store import InMemoryCheckpointStore as JaxInMemoryStore
from tpu_nexus.models.llama import LlamaConfig as JaxLlamaConfig
from tpu_nexus.models.llama import llama_init as jax_llama_init
from tpu_nexus.models.moe import MoeConfig as JaxMoeConfig
from tpu_nexus.models.moe import moe_init as jax_moe_init
from tpu_nexus.parallel.distributed import ProcessContext as JaxProcessContext
from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.models.convert import params_from_numpy
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext, rank_plan, reserved_port
from tpu_nexus_torch.parallel.mesh import AXIS_ORDER, mesh_coords
from tpu_nexus_torch.serving import RequestState, ServingEngine
from tpu_nexus_torch.serving.sharded import (
    NumpyParams,
    RankPool,
    ShardedModelExecutor,
    ShardedPagedModelExecutor,
    ShardingError,
    validate_serve_mesh,
)
from tpu_nexus_torch.workload.serve import ServeConfig
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 30.0

LLAMA_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16, intermediate=128,
                max_seq_len=256, remat=False)
MOE_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=96,
              n_experts=4, experts_per_token=2, max_seq_len=256, remat=False)
JCFG = JaxLlamaConfig(**LLAMA_KW, dtype=jnp.float32, param_dtype=jnp.float32)
CFG = LlamaConfig(**LLAMA_KW, dtype=torch.float32, param_dtype=torch.float32)
JMCFG = JaxMoeConfig(**MOE_KW, dtype=jnp.float32, param_dtype=jnp.float32)
MCFG = MoeConfig(**MOE_KW, dtype=torch.float32, param_dtype=torch.float32)
JPARAMS = jax_llama_init(jax.random.PRNGKey(0), JCFG)
JMPARAMS = jax_moe_init(jax.random.PRNGKey(3), JMCFG)
TREE = jax.tree.map(np.asarray, JPARAMS)
MTREE = jax.tree.map(np.asarray, JMPARAMS)

S, T, SLOTS = 8, 8, 3
RNG = np.random.default_rng(23)
PROMPTS = [RNG.integers(1, 256, size=int(RNG.integers(4, S + 1))).astype(np.int32) for _ in range(2 * SLOTS)]
#: the module pool's mesh: 4 ranks over 2 launched processes, 2 a process
POOL_MESH = "dp=2,tp=2"


def _sizes(spec):
    axes = dict(part.split("=") for part in spec.split(","))
    return [int(axes.get(a, 1)) for a in AXIS_ORDER]


def _base_env(tmp_path, port, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
    env.update(
        NEXUS_DEVICE="cpu", NEXUS_NUM_PROCESSES="2", NEXUS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        NEXUS_DIST_TIMEOUT_S="20", NEXUS_RUN_ID="multi", NEXUS_ALGORITHM="serve", NEXUS_TRACE="0",
        NEXUS__CQL_STORE_TYPE="sqlite", NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"),
        PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
    )
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool")
    with reserved_port() as port:  # no other socket takes it before this process's pool listens on it
        env = _base_env(tmp, port, NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET="tiny_tp",
                        NEXUS_SERVE_MESH=POOL_MESH, NEXUS_RANK_DEVICE_MAP="shared", NEXUS_PROCESS_ID="1",
                        NEXUS__CQL_STORE_TYPE="memory", NEXUS_DIST_TIMEOUT_S=str(TIMEOUT_S))
        err = tmp / "process1.err"
        with open(err, "w") as fh:
            proc = subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], env=env, cwd=str(tmp),
                                    stdout=subprocess.DEVNULL, stderr=fh)
        try:
            plan = rank_plan(ProcessContext("multi", "serve", 0, 2, f"127.0.0.1:{port}"), _sizes(POOL_MESH), "cpu",
                             "shared")
            assert (plan.local, plan.world) == (2, 4)
            with RankPool(plan=plan, timeout_s=TIMEOUT_S, join_timeout_s=20.0) as p:
                yield p
            proc.wait(timeout=60)
            assert proc.returncode == 0, err.read_text()[-3000:]
            assert "'ranks': [2, 3]" in err.read_text()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _drain(executor, prompts=PROMPTS, n=T):
    engine = ServingEngine(executor)
    reqs = [engine.submit(p, n, request_id=f"r{i}") for i, p in enumerate(prompts)]
    engine.run_until_drained(max_steps=5000)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    return {r.request_id: [int(t) for t in r.output_tokens] for r in reqs}


def _jax_drain(axes, family, paged):
    params, cfg = (JPARAMS, JCFG) if family == "llama" else (JMPARAMS, JMCFG)
    mesh = jax_sharded.build_serve_mesh(axes)
    kw = dict(num_slots=SLOTS, max_len=S + T)
    if paged:
        ex = jax_sharded.ShardedPagedModelExecutor(params, cfg, mesh=mesh, page_size=4, **kw)
    else:
        ex = jax_sharded.ShardedModelExecutor(params, cfg, mesh=mesh, **kw)
    engine = jax_serving.ServingEngine(ex)
    reqs = [engine.submit(p, T, request_id=f"r{i}") for i, p in enumerate(PROMPTS)]
    engine.run_until_drained(max_steps=5000)
    return {r.request_id: [int(t) for t in r.output_tokens] for r in reqs}


def _executor(mesh, family, paged):
    tree, cfg = (TREE, CFG) if family == "llama" else (MTREE, MCFG)
    kw = dict(num_slots=SLOTS, max_len=S + T)
    if paged:
        return ShardedPagedModelExecutor(NumpyParams(tree), cfg, mesh=mesh, page_size=4, **kw)
    return ShardedModelExecutor(NumpyParams(tree), cfg, mesh=mesh, **kw)


# -- one pool across two launched processes ------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tp2_across_two_processes_matches_jax(pool, paged):
    """tp 2 over ranks 0 (process 0) and 2 (process 1), and over ranks 0
    and 1 (both process 0's, the one-process pool's replica): the same
    f32 greedy tokens as the JAX package's sharded executor at tp 2."""
    across_mesh, within_mesh = pool.meshes([({"tp": 2}, (0, 2)), ({"tp": 2}, (0, 1))])
    across, within = _executor(across_mesh, "llama", paged), _executor(within_mesh, "llama", paged)
    try:
        got = _drain(across)
        one_process = _drain(within)
        stats = across.shard_stats()
    finally:
        across.close()
        within.close()
    assert [s["rank"] for s in stats] == [0, 2]
    assert got == one_process == _jax_drain({"tp": 2}, "llama", paged)


def test_kv_handoff_across_two_processes(pool):
    """A disaggregated fleet whose tp-2 prefill replica spans the two
    launched processes (ranks 0 and 2) and whose tp-2 decode replica is
    process 0's (ranks 0 and 1): one handoff a request, no fallback, and
    the fused tokens of the JAX package's sharded executor at tp 2."""
    from tpu_nexus_torch.serving import ROLE_DECODE, ROLE_PREFILL, DisaggConfig, ServingFleet

    across_mesh, within_mesh = pool.meshes([({"tp": 2}, (0, 2)), ({"tp": 2}, (0, 1))])
    prefill, decode = _executor(across_mesh, "llama", True), _executor(within_mesh, "llama", True)
    try:
        fleet = ServingFleet(disagg=DisaggConfig(), handoff_sleep=lambda s: None)
        fleet.add_replica("pf-0", ServingEngine(prefill), step=1, role=ROLE_PREFILL)
        fleet.add_replica("dc-0", ServingEngine(decode), step=1, role=ROLE_DECODE)
        reqs = []
        for wave in (0, SLOTS):  # no more than the decode replica's slots at once
            reqs += [fleet.submit(p, T, request_id=f"r{i}") for i, p in enumerate(PROMPTS[wave:wave + SLOTS], wave)]
            fleet.run_until_drained(max_steps=5000)
    finally:
        prefill.close()
        decode.close()
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert fleet.handoffs_completed == len(PROMPTS) and fleet.disagg_fallbacks == 0
    assert {r.request_id: [int(t) for t in r.output_tokens] for r in reqs} == _jax_drain({"tp": 2}, "llama", True)


def _copies(axes):
    """The replica's ranks (0..3 in mesh order) grouped by their
    coordinates on the replicate axes: one tuple a copy, ordered by
    (ep, tp)."""
    sizes = [axes.get(a, 1) for a in AXIS_ORDER]
    out = {}
    for i in range(4):
        c = dict(zip(AXIS_ORDER, mesh_coords(i, sizes)))
        out.setdefault(tuple(c[a] for a in AXIS_ORDER if a not in ("ep", "tp")), []).append(i)
    return [tuple(v) for v in out.values()]


@pytest.mark.parametrize("axes,family,paged", [
    ({"dp": 2, "tp": 2}, "llama", True),
    ({"pp": 2, "tp": 2}, "llama", True),
    ({"fsdp": 2, "ep": 2}, "moe", False),
    ({"ep": 2, "sp": 2}, "moe", False),
], ids=["dp2xtp2", "pp2xtp2", "moe_fsdp2xep2", "moe_ep2xsp2"])
def test_replicate_axes_match_jax(pool, axes, family, paged):
    """A mesh with a replicate axis over the pool's four ranks (two a
    process): tokens equal the JAX package's sharded executor on the same
    mesh; each copy holds the tp/ep slices, launches the same kernels and
    runs the same collectives with the same bytes as the other; an MoE
    rank's combine group is its own copy's (ep, tp) region."""
    pool.reset_counts()
    ex = _executor(pool.mesh(axes), family, paged)
    try:
        got = _drain(ex)
        stats = ex.shard_stats()
    finally:
        ex.close()
    assert got == _jax_drain(axes, family, paged)
    copies = _copies(axes)
    assert len(copies) == 2 and sorted(sum(copies, ())) == [0, 1, 2, 3]
    for a, b in zip(*copies):
        assert stats[a]["launches"] == stats[b]["launches"]
        assert stats[a]["collectives"]["calls"] == stats[b]["collectives"]["calls"]
        assert stats[a]["collectives"]["bytes"] == stats[b]["collectives"]["bytes"]
    assert any(s["collectives"]["calls"] for s in stats)
    for copy in copies:
        for r in copy:
            assert stats[r]["groups"]["moe"] == copy, (r, stats[r]["groups"])
    assert {s["rank"] for s in stats} == {0, 1, 2, 3}


MOE_SMALL = dict(vocab_size=64, hidden=32, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=8, intermediate=64,
                 max_seq_len=64)


@pytest.mark.parametrize("axes,family", [
    ({"dp": 2, "tp": 2}, "llama"), ({"pp": 2, "tp": 2}, "llama"), ({"dp": 2, "ep": 2}, "llama"),
    ({"fsdp": 2, "ep": 2}, "moe"), ({"ep": 2, "sp": 2}, "moe"), ({"sp": 2, "tp": 4}, "tiny"),
    ({"fsdp": 16}, "llama"), ({"pp": 2, "ep": 3}, "moe"),
])
def test_replicate_meshes_validate_as_the_reference(axes, family):
    """``validate_serve_mesh`` and ``ServeConfig`` accept and refuse the
    same meshes as the JAX package, in the same words (8 devices)."""
    if family == "tiny":
        pcfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    elif family == "moe":
        pcfg, jcfg = MoeConfig(**MOE_SMALL, n_experts=4), JaxMoeConfig(**MOE_SMALL, n_experts=4)
    else:
        pcfg, jcfg = CFG, JCFG
    try:
        jax_sharded.validate_serve_mesh(axes, jcfg, n_devices=8)
    except ValueError as exc:
        with pytest.raises(ShardingError) as got:
            validate_serve_mesh(axes, pcfg, n_devices=8)
        assert str(got.value) == str(exc)
        return
    validate_serve_mesh(axes, pcfg, n_devices=8)
    if np.prod(list(axes.values())) <= 8:
        spec = ",".join(f"{k}={v}" for k, v in axes.items())
        assert jax_serve.ServeConfig(model=jcfg, serve_mesh=spec).serve_mesh == spec
        assert ServeConfig(model=pcfg, serve_mesh=spec, device="cpu", rank_map="shared").serve_mesh == spec


# -- the entry points over two launched processes -------------------------------

_PROCESS_SCRIPT = """
import dataclasses, json, os, sys, time
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.workload import serve

TERMINAL = ("COMPLETED", "PREEMPTED", "FAILED")


class CountingStore(SqliteCheckpointStore):
    # counts this process's terminal writes.  The test holds the
    # coordinator's terminal write until process 1's key is in the row (at
    # most 60 s): two copies end independently, so without the hold process
    # 1's heartbeats could come after the terminal write and be dropped by
    # the IsFinished guard.  The serving loops themselves never wait
    terminal = []

    def update_fields(self, algorithm, id, fields):
        if fields.get("lifecycle_stage") in TERMINAL:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and "host1/chip0" not in (
                    self.read_checkpoint(algorithm, id).per_chip_steps or {}):
                time.sleep(0.05)
            self.terminal.append(fields["lifecycle_stage"])
        return super().update_fields(algorithm, id, fields)


if __name__ == "__main__":
    assert "jax" not in sys.modules and "tpu_nexus" not in sys.modules
    import torch
    store = CountingStore(os.environ["NEXUS__SQLITE_STORE_PATH"])
    cfg = serve.ServeConfig.from_env()
    if os.environ.get("SERVE_MODEL_FIELDS"):
        cfg = dataclasses.replace(cfg, model=LlamaConfig(**json.loads(os.environ["SERVE_MODEL_FIELDS"]),
                                                         dtype=torch.float32, param_dtype=torch.float32))
    seen = []
    generate = serve.generate

    def recording(params, prompts, *args, **kwargs):
        out = generate(params, prompts, *args, **kwargs)
        seen.append({"prompts": prompts.tolist(), "tokens": out.tolist()})
        return out

    serve.generate = recording
    run = serve.run_serving if os.environ["NEXUS_MODE"] == "serve" else serve.run_serve_engine
    summary = run(cfg, store=store)
    store.close()
    print("RESULT " + json.dumps({"terminal": CountingStore.terminal, "calls": seen,
                                  "summary": {k: v for k, v in summary.items() if k in (
                                      "finished", "engine_iterations", "ranks", "drained", "rounds")}}))
"""


def _seed_row(tmp_path):
    # the launcher's order: the run's row first, then its containers (two
    # processes creating one sqlite file at once race on its journal mode)
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    store.upsert_checkpoint(CheckpointedRequest(algorithm="serve", id="multi",
                                                lifecycle_stage=LifecycleStage.BUFFERED))
    store.close()


def _row(tmp_path):
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        return store.read_checkpoint("serve", "multi")
    finally:
        store.close()


def _start(tmp_path, env, argv, names=("p0", "p1")):
    _seed_row(tmp_path)
    procs = []
    for i, name in enumerate(names):
        with open(tmp_path / f"{name}.err", "w") as err, open(tmp_path / f"{name}.out", "w") as out:
            procs.append(subprocess.Popen([sys.executable, *argv], env={**env, "NEXUS_PROCESS_ID": str(i)},
                                          cwd=str(tmp_path), stdout=out, stderr=err, start_new_session=True))
    return procs


def _finish(tmp_path, procs, timeout=90):
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return [((tmp_path / f"p{i}.out").read_text(), (tmp_path / f"p{i}.err").read_text()) for i in range(len(procs))]


def _result_of(out):
    return json.loads([line for line in out.splitlines() if line.startswith("RESULT ")][-1][len("RESULT "):])


def _run_pair(tmp_path, **extra):
    script = tmp_path / "serving_process.py"
    script.write_text(_PROCESS_SCRIPT)
    with reserved_port() as port:
        env = _base_env(tmp_path, port, NEXUS_BATCH="2", NEXUS_PROMPT_LEN="8", NEXUS_GEN_TOKENS="4",
                        NEXUS_STEPS="2", NEXUS_HEARTBEAT_EVERY="1", **extra)
        outs = _finish(tmp_path, _start(tmp_path, env, [str(script)]))
    results = []
    for out, err in outs:
        assert "RESULT " in out, err[-3000:]
        results.append(_result_of(out))
    return results, env


@pytest.mark.parametrize("mesh", ["", "tp=2"], ids=["engine", "engine_meshed"])
def test_serve_engine_across_processes_one_terminal_write(tmp_path, mesh):
    """serve-engine over two launched processes: without a mesh each
    serves its own copy, with ``tp=2`` one replica spans them (process 1
    serves rank 1).  Both write RUNNING and heartbeat their own keys; the
    coordinator alone writes the terminal row, once."""
    extra = dict(NEXUS_SERVE_MESH=mesh, NEXUS_RANK_DEVICE_MAP="shared") if mesh else {}
    (p0, p1), _env = _run_pair(tmp_path, NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET="tiny", **extra)
    row = _row(tmp_path)
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert set(row.per_chip_steps) == {"host0/chip0", "host1/chip0"}
    assert (p0["terminal"], p1["terminal"]) == (["COMPLETED"], [])
    assert p0["summary"]["finished"] == 4
    if mesh:
        assert p1["summary"]["ranks"] == [1]
        # process 1 heartbeats the leader's engine iterations, as the leader does
        assert p1["summary"]["engine_iterations"] >= 2
        assert 1 <= row.per_chip_steps["host1/chip0"] <= row.per_chip_steps["host0/chip0"]
    else:
        assert p1["summary"]["finished"] == 4


def _checkpoint(tmp_path):
    ck = TensorCheckpointer(str(tmp_path / "ckpt"))
    ck.save(1, {"params": params_from_numpy(TREE, CFG, device="cpu")})
    ck.commit(1)
    ck.close()
    return str(tmp_path / "ckpt")


class _RecordingJax:
    """The JAX module as the reference's serve loop sees it, its ``jit``
    recording each call's inputs and greedy tokens."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        jitted = jax.jit(fn, **kwargs)

        def call(params, prompts, **kw):
            out = jitted(params, prompts, **kw)
            self._calls.append({"prompts": np.asarray(prompts).tolist(), "tokens": np.asarray(out).tolist()})
            return out

        return call


@pytest.mark.parametrize("mesh", ["", "tp=2"], ids=["no_mesh", "with_mesh"])
def test_lockstep_across_processes_matches_jax(tmp_path, monkeypatch, mesh):
    """The lockstep loop over two launched processes, each on its own
    device (``NEXUS_SERVE_MESH`` is not read, as the reference's loop never
    reads it): every process serves the same prompt stream with the same
    greedy tokens as the JAX package's ``run_serving`` under the same env
    and weights (f32, seed 0: the port restores the JAX init from a
    checkpoint); the row COMPLETED with both keys, written once."""
    extra = dict(NEXUS_SERVE_MESH=mesh, NEXUS_RANK_DEVICE_MAP="shared") if mesh else {}
    (p0, p1), env = _run_pair(tmp_path, NEXUS_MODE="serve", NEXUS_CHECKPOINT_DIR=_checkpoint(tmp_path),
                                SERVE_MODEL_FIELDS=json.dumps(LLAMA_KW), **extra)
    calls = []
    monkeypatch.setattr(jax_serve, "jax", _RecordingJax(calls))
    jenv = {k: v for k, v in env.items() if k not in ("NEXUS_CHECKPOINT_DIR", "NEXUS_DEVICE", "NEXUS_RANK_DEVICE_MAP")}
    jcfg = dataclasses.replace(jax_serve.ServeConfig.from_env(jenv), model=JCFG)
    jstore = JaxInMemoryStore()
    jax_serve.run_serving(jcfg, store=jstore, ctx=JaxProcessContext("multi", "serve", 0, 1, None))
    assert jstore.read_checkpoint("serve", "multi").lifecycle_stage == "COMPLETED"
    assert len(calls) == 3  # the warmup and 2 rounds
    assert p0["calls"] == p1["calls"] == calls
    row = _row(tmp_path)
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert set(row.per_chip_steps) == {"host0/chip0", "host1/chip0"}
    assert row.per_chip_steps["host0/chip0"] == 2
    assert (p0["terminal"], p1["terminal"]) == (["COMPLETED"], [])


def _container_pair(tmp_path, **extra):
    # the coordinator's port is held until both processes heartbeat: by
    # then process 0 listens on it and process 1 has joined
    with reserved_port() as port:
        env = _base_env(tmp_path, port, NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET="tiny",
                        NEXUS_SERVE_MESH="tp=2", NEXUS_RANK_DEVICE_MAP="shared", NEXUS_BATCH="2",
                        NEXUS_PROMPT_LEN="8", NEXUS_GEN_TOKENS="64", NEXUS_STEPS="400", NEXUS_HEARTBEAT_EVERY="1",
                        **extra)
        procs = _start(tmp_path, env, ["-m", "tpu_nexus_torch.workload"])
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            row = _row(tmp_path)
            if row is not None and len(row.per_chip_steps or {}) == 2:
                return procs
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
    _finish(tmp_path, procs, timeout=1)
    pytest.fail(f"the two containers never both heartbeat: {(tmp_path / 'p0.err').read_text()[-3000:]}")


def test_sigterm_to_both_processes_lands_preempted(tmp_path):
    """A JobSet preemption signals every pod: SIGTERM to both processes of
    a tp-2 replica mid-run.  Process 1 keeps answering through the
    leader's drain; the row lands PREEMPTED with the retirement counts and
    both processes exit 0."""
    procs = _container_pair(tmp_path, NEXUS_DRAIN_GRACE_S="2")
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    outs = _finish(tmp_path, procs, timeout=60)
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:] + outs[1][1][-3000:]
    row = _row(tmp_path)
    assert row.lifecycle_stage == LifecycleStage.PREEMPTED
    assert "serving drain" in row.algorithm_failure_cause
    details = json.loads(row.algorithm_failure_details)
    assert sum(details["retired_causes"].values()) > 0
    assert "served on through the leader's drain" in outs[1][1]


_BEATING = """
import sys, time
from tpu_nexus_torch.serving import sharded
sharded.ALIVE_EVERY_S = 0.0  # the thread is inside the store's add almost always
stop = sharded._beat_alive(sys.argv[1], 1)
time.sleep(0.3)
stop()
"""


def test_a_worker_process_ends_with_no_liveness_bump_in_flight(tmp_path):
    """A rank of another launched process bumps its liveness counter from a
    daemon thread; a bump still in the store's call when the interpreter
    exits aborts the process (SIGABRT: process 1 of the SIGTERM drill
    exited -6 now and then).  Stopped as the workers stop it, the thread
    ends first: the process exits 0 even when it bumps without a pause."""
    import datetime

    import torch.distributed as dist

    with reserved_port() as port:
        store = dist.TCPStore("127.0.0.1", port, 1, True, timeout=datetime.timedelta(seconds=30))
        env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        for _ in range(3):
            proc = subprocess.run([sys.executable, "-c", _BEATING, f"tcp://127.0.0.1:{port}"], env=env,
                                  cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
            assert proc.returncode == 0, proc.stderr[-2000:]
        assert store.add("nexus/alive/1", 0) > 0
        del store


def test_a_killed_process_fails_the_replica_within_the_timeout(tmp_path):
    """Process 1 of a tp-2 replica SIGKILLed mid-run: the leader raises
    ShardLost, the row ends FAILED naming the lost rank, and the leader's
    container exits non-zero well inside NEXUS_DIST_TIMEOUT_S (20 s)."""
    procs = _container_pair(tmp_path)
    os.killpg(procs[1].pid, signal.SIGKILL)
    t0 = time.monotonic()
    outs = _finish(tmp_path, procs, timeout=60)
    elapsed = time.monotonic() - t0
    assert procs[0].returncode not in (0, None)
    assert "ShardLost" in outs[0][1], outs[0][1][-3000:]
    assert elapsed < 20.0
    row = _row(tmp_path)
    assert row.lifecycle_stage == LifecycleStage.FAILED
    assert "lost a rank: rank(s) [1] stopped answering" in row.algorithm_failure_cause


def test_a_serving_jobset_of_two_hosts_gets_the_training_env():
    """The launcher gives a serving JobSet of two hosts the env a training
    one gets (``NEXUS_NUM_PROCESSES``, the completion index as
    ``NEXUS_PROCESS_ID``, the coordinator's address): the serving loops read
    the same contract."""
    from tpu_nexus_torch.launcher.jobset import LaunchSpec, compose_jobset

    def env_of(mode):
        spec = LaunchSpec(run_id="r", algorithm="a", image="i", num_hosts=2, env={"NEXUS_MODE": mode})
        containers = compose_jobset(spec)["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
        return [e for e in containers["containers"][0]["env"] if e["name"] != "NEXUS_MODE"]

    serving = env_of("serve-engine")
    assert serving == env_of("train")
    names = {e["name"] for e in serving}
    assert {"NEXUS_NUM_PROCESSES", "NEXUS_PROCESS_ID", "NEXUS_COORDINATOR_ADDRESS"} <= names
