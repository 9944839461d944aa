"""Quantized-weight serving in the port, Llama and MoE, against the JAX
package: the cases of ``tests/test_quant_serving.py`` that need no mesh.

* ``TestServeConfigQuant`` — parse-time validation, each case on a Llama
  and an MoE config, with the reference's outcome and wording (the JAX
  package's ``ServeConfig`` given the same values says the same); the MoE
  presets parse with ``NEXUS_QUANTIZE``; an int4 group must divide an MoE
  config's expert width too (64 passes Mixtral's 14336, 48 fails
  nexus_moe's 1024 hidden with the reference's message).
* ``TestQuantizedExecutors`` — the executors own the quantize transform
  and report the packed bytes.
* ``TestCrossModeTokenIdentity`` — contiguous, paged, speculative and
  overlap/multi-step engines that quantize the same plain tree emit
  exactly the JAX package's ``generate(quantize(params))`` greedy stream,
  int8 and int4 (group 16), f32.
* ``TestQuantizedRollingUpdate`` — a plain checkpoint onto quantized
  replicas: each swap quantizes at the replica's own width and no request
  is dropped, for the MoE family.
* The mesh cases (``serving/sharded.py``, ranks on the CPU over gloo under
  the rehearsal map, one pool for the module): ``TestValidateServeMeshInt4``
  refuses what the JAX function refuses, with its words;
  ``TestShardedCrossModeTokenIdentity`` — a tp-2 sharded engine, Llama and
  MoE, int8 and int4, emits the JAX package's ``generate(quantize(params))``
  stream (the int8 scales of the row-parallel leaves are reduced over the
  ranks); ``TestShardedQuantizedRollingUpdate`` — a plain checkpoint onto
  sharded quantized replicas, each rank quantizing its own slice, and a
  fleet of an int8 and an int4 sharded replica rolled 1 -> 2.
* ``run_serving`` and ``run_serve_engine`` on a quantized MoE preset land
  COMPLETED.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.models import moe as jax_moe
from tpu_nexus.models import quant as jax_quant
from tpu_nexus.models.generate import generate as jax_generate
from tpu_nexus.workload.serve import ServeConfig as JaxServeConfig
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.models import llama as port_llama
from tpu_nexus_torch.models import moe as port_moe
from tpu_nexus_torch.models.convert import params_from_numpy
from tpu_nexus_torch.models.generate import generate
from tpu_nexus_torch.models.quant import QTensor, QTensor4, quantize_params
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.serving import (
    ModelExecutor,
    NGramDrafter,
    PagedModelExecutor,
    RequestState,
    ServingEngine,
    ServingFleet,
)
from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine, run_serving
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

torch.set_num_threads(1)
GROUP = 16
S, T, SLOTS = 8, 8, 3
RNG = np.random.default_rng(13)
PROMPTS = [RNG.integers(1, 256, size=int(RNG.integers(4, S + 1))).astype(np.int32) for _ in range(SLOTS)]
FAMILIES = ("llama", "moe")


def _configs(family):
    """(JAX config, the port's equal config): the reference test's Llama
    config, and ``MoeConfig.tiny`` (hidden 64, experts of 96), both f32."""
    if family == "llama":
        fields = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
                      intermediate=128, max_seq_len=256, remat=False)
        return (jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **fields),
                port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **fields))
    return (dataclasses.replace(jax_moe.MoeConfig.tiny(), dtype=jnp.float32),
            dataclasses.replace(port_moe.MoeConfig.tiny(), dtype=torch.float32))


_TREES = {}


def _trees(family, seed):
    """(JAX params, the port's params carried from them), memoized."""
    key = (family, seed)
    if key not in _TREES:
        jcfg, pcfg = _configs(family)
        init = jax_llama.llama_init if family == "llama" else jax_moe.moe_init
        jparams = init(jax.random.PRNGKey(seed), jcfg)
        _TREES[key] = (jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, device="cpu"))
    return _TREES[key]


_REFS = {}


def _ref(family, mode, prompt, seed=0, n=T):
    """The JAX package's greedy stream of its own quantized tree (memoized)."""
    key = (family, mode, tuple(int(t) for t in prompt), seed, n)
    if key not in _REFS:
        _REFS[key] = _jax_ref(family, mode, prompt, seed, n)
    return _REFS[key]


def _jax_ref(family, mode, prompt, seed, n):
    jcfg, _ = _configs(family)
    jparams, _ = _trees(family, seed)
    qp = jax_quant.quantize_params(jparams, mode=mode, group=GROUP)
    out = jax_generate(qp, jnp.asarray(prompt[None]), jcfg, max_new_tokens=n, max_len=len(prompt) + n)
    return [int(t) for t in np.asarray(out)[0]]


def _drain(engine, prompts=PROMPTS, n=T):
    reqs = [engine.submit(p, n, request_id=f"r{i}") for i, p in enumerate(prompts)]
    engine.run_until_drained(max_steps=5000)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    return {r.request_id: list(r.output_tokens) for r in reqs}


def _kw(mode):
    return dict(num_slots=SLOTS, max_len=S + T, quantize=mode, quant_group=GROUP if mode == "int4" else 0)


def _both_raise(match, **fields):
    """Both packages' ServeConfig refuse ``fields`` with the same message,
    which matches ``match``; ``fields["model"]`` is a family name."""
    family = fields.pop("model")
    jcfg, pcfg = _configs(family)
    with pytest.raises(ValueError, match=match) as port_exc:
        ServeConfig(model=pcfg, device="cpu", **fields)
    with pytest.raises(ValueError) as ref_exc:
        JaxServeConfig(model=jcfg, **fields)
    assert str(port_exc.value) == str(ref_exc.value)


# -- parse-time validation (ServeConfig) ---------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
class TestServeConfigQuant:
    def test_int8_and_int4_accepted(self, family):
        _, pcfg = _configs(family)
        assert ServeConfig(model=pcfg, quantize="int8").quantize == "int8"
        cfg = ServeConfig(model=pcfg, quantize="int4", quant_group=16)
        assert cfg.quant_group == 16

    def test_unknown_mode_named(self, family):
        _both_raise("unknown quantize mode 'fp4'", model=family, quantize="fp4")

    def test_negative_group_named(self, family):
        _both_raise("NEXUS_QUANT_GROUP.*got -8", model=family, quantize="int4", quant_group=-8)

    def test_group_without_int4_rejected(self, family):
        _both_raise("NEXUS_QUANT_GROUP=64.*quantize='int4'.*'int8'", model=family, quantize="int8", quant_group=64)
        _both_raise("NEXUS_QUANT_GROUP=64", model=family, quant_group=64)

    def test_odd_group_rejected(self, family):
        _both_raise("must be even.*got 9", model=family, quantize="int4", quant_group=9)

    def test_non_dividing_group_names_the_width(self, family):
        # hidden 64 % 48 != 0: the error names the width and the knob
        _both_raise("NEXUS_QUANT_GROUP=48.*64 hidden", model=family, quantize="int4", quant_group=48)

    def test_from_env_parses_group(self, family):
        preset = "tiny" if family == "llama" else "moe_tiny"
        cfg = ServeConfig.from_env({"NEXUS_MODEL_PRESET": preset, "NEXUS_QUANTIZE": "int4",
                                    "NEXUS_QUANT_GROUP": "16"})
        assert (cfg.quantize, cfg.quant_group) == ("int4", 16)


@pytest.mark.parametrize("preset", ["moe_tiny", "nexus_moe"])
@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_moe_presets_parse(preset, quantize):
    env = {"NEXUS_MODEL_PRESET": preset, "NEXUS_QUANTIZE": quantize, "NEXUS_QUANTIZE_KV": "int8"}
    if quantize == "int4" and preset == "moe_tiny":
        env["NEXUS_QUANT_GROUP"] = "32"  # the default 64 does not divide moe_tiny's experts of 96
    cfg = ServeConfig.from_env(env)
    assert (cfg.quantize, cfg.quantize_kv, cfg.model.name) == (quantize, "int8", "moe")


def test_int4_group_covers_the_expert_width():
    """Group 64 divides Mixtral's 4096 hidden, 14336 expert width and 4096
    attention width; 48 does not divide nexus_moe's 1024 hidden, and both
    packages say so in the same words."""
    mixtral = port_moe.MoeConfig.mixtral_8x7b()
    assert ServeConfig(model=mixtral, quantize="int4", quant_group=64).quant_group == 64
    # an expert width that 64 does not divide is named as the w_down contraction
    with pytest.raises(ValueError, match=r"NEXUS_QUANT_GROUP=64.*14300 intermediate \(w_down contraction\)"):
        ServeConfig(model=dataclasses.replace(mixtral, intermediate=14300), quantize="int4", quant_group=64)
    with pytest.raises(ValueError, match="NEXUS_QUANT_GROUP=48.*1024 hidden") as port_exc:
        ServeConfig(model=port_moe.MoeConfig.nexus_moe(), quantize="int4", quant_group=48)
    with pytest.raises(ValueError) as ref_exc:
        JaxServeConfig(model=jax_moe.MoeConfig.nexus_moe(), quantize="int4", quant_group=48)
    assert str(port_exc.value) == str(ref_exc.value)


# -- executor-owned quantize ---------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
class TestQuantizedExecutors:
    def test_executor_applies_transform_and_reports_bytes(self, family):
        _, pcfg = _configs(family)
        params = _trees(family, 0)[1]
        ex8 = ModelExecutor(params, pcfg, **_kw("int8"))
        ex4 = ModelExecutor(params, pcfg, **_kw("int4"))
        for name in ("wq", "wo", "w_gate", "w_down"):
            assert isinstance(ex8.params["layers"][name], QTensor)
            assert isinstance(ex4.params["layers"][name], QTensor4)
        assert 0 < ex4.weight_bytes < ex8.weight_bytes

    def test_unknown_mode_rejected(self, family):
        _, pcfg = _configs(family)
        with pytest.raises(ValueError, match="unknown quantize mode 'fp8'"):
            ModelExecutor(_trees(family, 0)[1], pcfg, num_slots=SLOTS, max_len=S + T, quantize="fp8")

    def test_pre_quantized_tree_passes_idempotently(self, family):
        _, pcfg = _configs(family)
        pre = quantize_params(_trees(family, 0)[1], mode="int4", group=GROUP)
        ex = ModelExecutor(pre, pcfg, **_kw("int4"))
        assert ex.params["layers"]["w_up"] is pre["layers"]["w_up"]
        assert isinstance(ex.params["layers"]["wq"], QTensor4)

    def test_load_snapshot_surfaces_weight_bytes(self, family):
        _, pcfg = _configs(family)
        ex = ModelExecutor(_trees(family, 0)[1], pcfg, **_kw("int4"))
        snap = ServingEngine(ex).load_snapshot()
        assert snap.weight_bytes == ex.weight_bytes > 0


# -- cross-mode token identity, both widths ------------------------------------


class TestCrossModeTokenIdentity:
    """At a fixed width, contiguous, paged, speculative and overlap/
    multi-step engines all emit exactly the JAX package's
    ``generate(quantize(params))`` greedy stream — the executors quantize
    internally from the SAME plain tree."""

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_matrix(self, family, mode):
        _, pcfg = _configs(family)
        params = _trees(family, 0)[1]
        kw = _kw(mode)
        engines = {
            "contig": ServingEngine(ModelExecutor(params, pcfg, **kw)),
            "paged": ServingEngine(PagedModelExecutor(params, pcfg, page_size=4, **kw)),
            "spec": ServingEngine(ModelExecutor(params, pcfg, **kw), spec_k=2, drafter=NGramDrafter(SLOTS)),
            "overlap": ServingEngine(ModelExecutor(params, pcfg, decode_steps=2, **kw), overlap=True),
        }
        expected = {f"r{i}": _ref(family, mode, p) for i, p in enumerate(PROMPTS)}
        own = quantize_params(params, mode=mode, group=GROUP)
        for i, p in enumerate(PROMPTS):
            got = generate(own, torch.from_numpy(p)[None], pcfg, max_new_tokens=T, max_len=len(p) + T)
            assert got[0].tolist() == expected[f"r{i}"], (family, mode, i)
        for name, eng in engines.items():
            assert _drain(eng) == expected, (family, mode, name)


# -- rolling updates: plain checkpoints onto quantized replicas ----------------


def _checkpointed(tmp_path, params, step=2):
    ck = TensorCheckpointer(str(tmp_path / "ckpt"))
    ck.save(step, {"params": params})
    ck.commit(step)
    return ck


class _CpuSource:
    """The rollout's source: ``restore_params`` onto the CPU (its default
    device is the card)."""

    def __init__(self, ckpt):
        self.ckpt = ckpt

    def restore_params(self, step):
        return self.ckpt.restore_params(step, device="cpu")


class TestQuantizedRollingUpdate:
    """The fleet ships ONE plain f32 verified checkpoint; each quantized
    MoE replica quantizes it at its own swap seam."""

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_swap_quantizes_the_plain_tree(self, tmp_path, mode):
        _, pcfg = _configs("moe")
        ck = _checkpointed(tmp_path, _trees("moe", 7)[1])
        try:
            eng = ServingEngine(ModelExecutor(_trees("moe", 0)[1], pcfg, **dict(_kw(mode), num_slots=2)))
            inflight = [eng.submit(PROMPTS[i], T, request_id=f"old{i}") for i in range(2)]
            for _ in range(2):
                eng.step()
            assert any(not r.is_terminal() for r in inflight)
            eng.quiesce(grace_s=60.0)
            eng.swap_params(ck.restore_params(2, device="cpu"))  # the plain f32 tree
            eng.resume_admission()
            width = QTensor if mode == "int8" else QTensor4
            for name in ("wq", "w_gate", "w_up", "w_down"):
                assert isinstance(eng.executor.params["layers"][name], width)
            for i, req in enumerate(inflight):
                assert req.state == RequestState.FINISHED
                assert list(req.output_tokens) == _ref("moe", mode, PROMPTS[i]), i
            post = eng.submit(PROMPTS[0], T, request_id="post")
            eng.run_until_drained(max_steps=2000)
            assert list(post.output_tokens) == _ref("moe", mode, PROMPTS[0], seed=7)
            assert eng.weight_swaps == 1
        finally:
            ck.close()

    def test_fleet_rollout_over_mixed_width_moe_replicas(self, tmp_path):
        """One plain checkpoint rolls onto an int8 AND an int4 MoE replica
        in the same fleet: each lands at its own width, no request dropped,
        and after it each serves the new step's own tokens."""
        _, pcfg = _configs("moe")
        ck = _checkpointed(tmp_path, _trees("moe", 7)[1])
        try:
            fleet = ServingFleet()
            for name, mode in (("rep-int8", "int8"), ("rep-int4", "int4")):
                ex = ModelExecutor(_trees("moe", 0)[1], pcfg, **dict(_kw(mode), num_slots=2))
                fleet.add_replica(name, ServingEngine(ex), step=1)
            assert fleet.start_rollout(_CpuSource(ck), 2, grace_s=60.0)
            reqs = []
            for i in range(4):
                reqs.append(fleet.submit(PROMPTS[i % len(PROMPTS)], T))
                fleet.tick()
            for _ in range(500):
                fleet.tick()
                if not fleet.rollout_active and not fleet.has_work:
                    break
            fleet.run_until_drained()
            assert fleet.converged(2)
            assert all(r.state == RequestState.FINISHED for r in reqs)
            widths = {name: type(rep.engine.executor.params["layers"]["w_gate"])
                      for name, rep in fleet.replicas.items()}
            assert widths == {"rep-int8": QTensor, "rep-int4": QTensor4}
            for name, mode in (("rep-int8", "int8"), ("rep-int4", "int4")):
                eng = fleet.replicas[name].engine
                post = eng.submit(PROMPTS[1], T, request_id=f"post-{name}")
                eng.run_until_drained(max_steps=2000)
                assert list(post.output_tokens) == _ref("moe", mode, PROMPTS[1], seed=7)
        finally:
            ck.close()


# -- the workload entry points ---------------------------------------------------

SMALL = dict(batch_size=2, prompt_len=8, gen_tokens=4, rounds=2, heartbeat_every=1)


@pytest.mark.parametrize("quantize,group,kv", [("int8", "", "int8"), ("int4", "16", "")])
def test_run_serving_quantized_moe_lands_completed(quantize, group, kv):
    env = {"NEXUS_MODEL_PRESET": "moe_tiny", "NEXUS_QUANTIZE": quantize, "NEXUS_QUANTIZE_KV": kv}
    if group:
        env["NEXUS_QUANT_GROUP"] = group
    cfg = dataclasses.replace(ServeConfig.from_env(env), device="cpu", **SMALL)
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="qm", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    summary = run_serving(cfg, store=store, ctx=ctx)
    assert store.read_checkpoint("serve", "qm").lifecycle_stage == LifecycleStage.COMPLETED
    assert summary["last_tokens_shape"] == (2, 4)


@pytest.mark.parametrize("page_size", ["0", "4"])
def test_run_serve_engine_quantized_moe_lands_completed(page_size):
    cfg = dataclasses.replace(
        ServeConfig.from_env({"NEXUS_MODEL_PRESET": "moe_tiny", "NEXUS_QUANTIZE": "int4",
                              "NEXUS_QUANT_GROUP": "16", "NEXUS_PAGE_SIZE": page_size}),
        device="cpu", **SMALL)
    store = InMemoryCheckpointStore()
    ctx = ProcessContext(run_id="qe", algorithm="serve", process_id=0, num_processes=1, coordinator=None)
    summary = run_serve_engine(cfg, store=store, ctx=ctx)
    assert store.read_checkpoint("serve", "qe").lifecycle_stage == LifecycleStage.COMPLETED
    assert summary["finished"] == summary["requests"] == 4
    assert summary["load_snapshot"]["weight_bytes"] > 0


# -- the mesh cases ----------------------------------------------------------------


class TestValidateServeMeshInt4:
    @pytest.mark.parametrize("tp,group", [(2, GROUP), (4, 32), (4, GROUP), (4, 0)])
    @pytest.mark.parametrize("mode", ["int4", ""])
    def test_same_as_the_jax_validation(self, tp, group, mode):
        from tpu_nexus.serving.sharded import validate_serve_mesh as jax_validate
        from tpu_nexus_torch.serving.sharded import ShardingError, validate_serve_mesh

        jcfg, pcfg = _configs("llama")
        try:
            jax_validate({"tp": tp}, jcfg, n_devices=tp, quantize=mode, quant_group=group)
        except ValueError as exc:
            with pytest.raises(ShardingError, match=f"tp={tp}.*int4") as got:
                validate_serve_mesh({"tp": tp}, pcfg, n_devices=tp, quantize=mode, quant_group=group)
            assert str(got.value) == str(exc)
            return
        validate_serve_mesh({"tp": tp}, pcfg, n_devices=tp, quantize=mode, quant_group=group)


@pytest.fixture(scope="module")
def pool():
    from tpu_nexus_torch.serving.sharded import RankPool

    with RankPool(3, device="cpu", rank_map="shared", timeout_s=30.0, join_timeout_s=20.0) as p:
        yield p


def _sharded(mesh, family, mode, seed=0, **over):
    from tpu_nexus_torch.serving.sharded import NumpyParams, ShardedModelExecutor

    jcfg, pcfg = _configs(family)
    tree = jax.tree.map(np.asarray, _trees(family, seed)[0])
    return ShardedModelExecutor(NumpyParams(tree), pcfg, mesh=mesh, **dict(_kw(mode), **over))


class TestShardedCrossModeTokenIdentity:
    """The sharded engine of the reference's ``TestCrossModeTokenIdentity``:
    tp 2, quantizing the same plain tree on every rank."""

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_matrix(self, pool, family, mode):
        ex = _sharded(pool.mesh({"tp": 2}), family, mode)
        try:
            got = _drain(ServingEngine(ex))
            width = QTensor if mode == "int8" else QTensor4
            assert isinstance(ex.params["layers"]["wq"], width)
        finally:
            ex.close()
        assert got == {f"r{i}": _ref(family, mode, p) for i, p in enumerate(PROMPTS)}


class TestShardedQuantizedRollingUpdate:
    """One plain f32 verified checkpoint onto sharded quantized replicas:
    each rank reads its slice and quantizes it at the swap seam."""

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_swap_quantizes_per_shard(self, pool, tmp_path, mode):
        ck = _checkpointed(tmp_path, _trees("llama", 7)[1])
        ex = _sharded(pool.mesh({"tp": 2}), "llama", mode, num_slots=2)
        try:
            eng = ServingEngine(ex)
            inflight = [eng.submit(PROMPTS[i], T, request_id=f"old{i}") for i in range(2)]
            for _ in range(2):
                eng.step()
            assert any(not r.is_terminal() for r in inflight)
            eng.quiesce(grace_s=60.0)
            eng.swap_params(ck.params_ref(2))  # the plain f32 step, by reference
            eng.resume_admission()
            wq = eng.executor.params["layers"]["wq"]
            assert isinstance(wq, QTensor if mode == "int8" else QTensor4)
            for i, req in enumerate(inflight):
                assert req.state == RequestState.FINISHED
                assert list(req.output_tokens) == _ref("llama", mode, PROMPTS[i]), i
            post = eng.submit(PROMPTS[0], T, request_id="post")
            eng.run_until_drained(max_steps=2000)
            assert list(post.output_tokens) == _ref("llama", mode, PROMPTS[0], seed=7)
            assert eng.weight_swaps == 1
        finally:
            ex.close()
            ck.close()

    def test_fleet_rollout_over_mixed_width_sharded_replicas(self, pool, tmp_path):
        ck = _checkpointed(tmp_path, _trees("llama", 7)[1])
        meshes = pool.meshes([({"tp": 2}, (0, 1)), ({"tp": 2}, (0, 2))])
        executors = {name: _sharded(mesh, "llama", mode, num_slots=2)
                     for (name, mode), mesh in zip((("rep-int8", "int8"), ("rep-int4", "int4")), meshes)}
        try:
            fleet = ServingFleet()
            for name, ex in executors.items():
                fleet.add_replica(name, ServingEngine(ex), step=1)
            assert fleet.start_rollout(ck, 2, grace_s=60.0)
            reqs = []
            for i in range(4):
                reqs.append(fleet.submit(PROMPTS[i % len(PROMPTS)], T))
                fleet.tick()
            for _ in range(500):
                fleet.tick()
                if not fleet.rollout_active and not fleet.has_work:
                    break
            fleet.run_until_drained()
            assert fleet.converged(2)
            assert all(r.state == RequestState.FINISHED for r in reqs)
            widths = {name: type(rep.engine.executor.params["layers"]["wq"]) for name, rep in fleet.replicas.items()}
            assert widths == {"rep-int8": QTensor, "rep-int4": QTensor4}
            for name, mode in (("rep-int8", "int8"), ("rep-int4", "int4")):
                eng = fleet.replicas[name].engine
                post = eng.submit(PROMPTS[1], T, request_id=f"post-{name}")
                eng.run_until_drained(max_steps=2000)
                assert list(post.output_tokens) == _ref("llama", mode, PROMPTS[1], seed=7)
        finally:
            for ex in executors.values():
                ex.close()
            ck.close()
