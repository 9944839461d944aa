"""Sharded serving: the port of ``tests/test_sharded_serving.py``, held
against the JAX package.

The port's ranks are processes (``serving/sharded.py::RankPool``, started
with ``spawn``: the children import only ``tpu_nexus_torch``) over gloo on
the CPU, all on the one CPU device under the explicit rehearsal map; this
process is rank 0, the leader.  One pool of four ranks serves the whole
module (every case at tp 2 takes ranks 0-1, at tp 4 ranks 0-3) and every
rank has a process-group timeout, so a hang fails its case instead of the
suite; the pool's close joins the workers with a deadline, then kills
them.  The JAX sharded executors run on the conftest's 8 virtual CPU
devices, on the same numpy weights.

* **Mesh config** — ``parse_serve_mesh``, ``validate_serve_mesh`` and
  ``ServeConfig`` accept and refuse exactly what the JAX functions do, with
  the same words.
* **Partition rules** — the same logical axes and specs as the JAX
  package's for the Llama, untied, MoE and quantized trees; an unmatched
  leaf and a non-divisible dim raise; a rank's slice has its share.
* **Token identity** — f32 greedy tokens of the port's sharded executors at
  tp 2 and 4 equal the JAX package's sharded executors' and one-shot
  ``generate``'s: contiguous and paged, bf16-free and int8 KV, int8
  weights, ngram speculation, overlap with ``decode_steps=4``; teacher-
  forced logits within 1e-5 x max|ref| of the JAX package's prefill and
  decode; the tiny MoE at ``ep=2`` and ``tp=2``.
* **Swaps** — a sharded swap from a committed checkpoint (each rank reads
  its slice), in-flight requests on the old weights, new ones on the new;
  the fleet rolls 1 -> 2 over two sharded replicas; a swap that does not
  fit is refused with the old weights kept on every rank.
* **Serve loop** — ``NEXUS_MODE=serve-engine`` with ``NEXUS_SERVE_MESH``
  starts its own workers and lands COMPLETED; a killed worker fails the
  container (non-zero) with the row FAILED, and a stuck worker (SIGSTOP,
  between calls or mid-call) raises ``ShardLost`` on the leader within
  the replica's finite timeout.
"""

import dataclasses
import importlib
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
from tpu_nexus.models.llama import LlamaConfig as JaxLlamaConfig
from tpu_nexus.models.llama import llama_init as jax_llama_init
from tpu_nexus.models.moe import MoeConfig as JaxMoeConfig
from tpu_nexus.models.moe import moe_init as jax_moe_init
from tpu_nexus.models.quant import quantize_params as jax_quantize_params
from tpu_nexus.workload.serve import ServeConfig as JaxServeConfig
from tpu_nexus_torch.checkpoint.models import LifecycleStage
from tpu_nexus_torch.checkpoint.store import SqliteCheckpointStore
from tpu_nexus_torch.models.convert import params_from_numpy, params_from_numpy_shard
from tpu_nexus_torch.models.generate import generate, teacher_forced_logits
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.serving import (
    ModelExecutor,
    NGramDrafter,
    PagedModelExecutor,
    RequestState,
    ServingEngine,
    ServingFleet,
)
from tpu_nexus_torch.serving.cache_manager import init_cache, init_paged_cache
from tpu_nexus_torch.serving.sharded import (
    NumpyParams,
    RankPool,
    ShardedModelExecutor,
    ShardedPagedModelExecutor,
    ShardingError,
    ShardLost,
    build_serve_mesh,
    kv_cache_sharding,
    match_partition_rules,
    parse_serve_mesh,
    serving_param_shardings,
    shard_serving_params,
    validate_serve_mesh,
)
from tpu_nexus_torch.workload.serve import ServeConfig
from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

jax_generate = importlib.import_module("tpu_nexus.models.generate")
torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent

# f32 compute: the parity matrix is exact (the JAX test's reasoning); the
# kv-head count (4) divides both tested tp widths
JCFG = JaxLlamaConfig(
    vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4,
    head_dim=16, intermediate=128, max_seq_len=256, remat=False,
    dtype=jnp.float32, param_dtype=jnp.float32,
)
CFG = LlamaConfig(
    vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4,
    head_dim=16, intermediate=128, max_seq_len=256, remat=False,
    dtype=torch.float32, param_dtype=torch.float32,
)
JPARAMS = jax_llama_init(jax.random.PRNGKey(0), JCFG)
TREE = jax.tree.map(np.asarray, JPARAMS)
TREE_NEW = jax.tree.map(np.asarray, jax_llama_init(jax.random.PRNGKey(7), JCFG))
PARAMS = params_from_numpy(TREE, CFG, device="cpu")
PARAMS_NEW = params_from_numpy(TREE_NEW, CFG, device="cpu")

S, T, SLOTS = 8, 10, 3
RNG = np.random.default_rng(11)
PROMPTS = [
    RNG.integers(1, CFG.vocab_size, size=int(RNG.integers(4, S + 1))).astype(np.int32)
    for _ in range(2 * SLOTS)
]
TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu", rank_map="shared", timeout_s=TIMEOUT_S, join_timeout_s=20.0) as p:
        yield p


def _ref(params, prompt, n=T, kv_quant=""):
    out = generate(params, torch.from_numpy(prompt[None]).long(), CFG, max_new_tokens=n,
                   max_len=len(prompt) + n, kv_quant=kv_quant)
    return [int(t) for t in out[0]]


def _drain(engine, prompts=PROMPTS, n=T):
    reqs = [engine.submit(p, n, request_id=f"r{i}") for i, p in enumerate(prompts)]
    engine.run_until_drained(max_steps=5000)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    return {r.request_id: [int(t) for t in r.output_tokens] for r in reqs}


def _jax_sharded(tp, paged, **kw):
    mesh = jax_sharded.build_serve_mesh({"tp": tp})
    if paged:
        return jax_sharded.ShardedPagedModelExecutor(JPARAMS, JCFG, mesh=mesh, page_size=4, **kw)
    return jax_sharded.ShardedModelExecutor(JPARAMS, JCFG, mesh=mesh, **kw)


def _sharded(pool, tp, paged=False, tree=TREE, cfg=CFG, axes=None, **kw):
    mesh = pool.mesh(axes or {"tp": tp})
    if paged:
        return ShardedPagedModelExecutor(NumpyParams(tree), cfg, mesh=mesh, page_size=4, **kw)
    return ShardedModelExecutor(NumpyParams(tree), cfg, mesh=mesh, **kw)


# -- mesh config (NEXUS_SERVE_MESH) --------------------------------------------


def _same_outcome(port_fn, jax_fn):
    """Both return the same value, or both raise the same text."""
    try:
        want = jax_fn()
    except ValueError as exc:
        with pytest.raises(ShardingError) as got:
            port_fn()
        assert str(got.value) == str(exc)
        return
    assert port_fn() == want


class TestParseServeMesh:
    @pytest.mark.parametrize("spec", ["tp=4", " ep=2, tp=2 ", "tpx=4", "tp=2,tp=4", "tp", "tp=", "4", "tp:4",
                                      "tp=four", "tp=0", "  ,  ", "pp=2,dp=1"])
    def test_same_as_the_jax_parser(self, spec):
        _same_outcome(lambda: parse_serve_mesh(spec), lambda: jax_sharded.parse_serve_mesh(spec))

    def test_words(self):
        assert parse_serve_mesh(" ep=2, tp=2 ") == {"ep": 2, "tp": 2}
        with pytest.raises(ShardingError, match="unknown mesh axis 'tpx'"):
            parse_serve_mesh("tpx=4")


MOE = dict(vocab_size=64, hidden=32, n_layers=1, n_heads=4, n_kv_heads=4, head_dim=8, intermediate=64,
           max_seq_len=64)


class TestValidateServeMesh:
    @pytest.mark.parametrize("axes,family,over,n", [
        ({"tp": 4}, "llama", {}, 8),
        ({"tp": 16}, "llama", {}, 8),
        ({"tp": 4}, "tiny", {}, 8),
        ({"tp": 4}, "llama", dict(intermediate=130), 8),
        ({"ep": 2}, "llama", {}, 8),
        ({"ep": 2}, "moe", dict(n_experts=3), 8),
        ({"ep": 3}, "moe", dict(n_experts=3), 8),
        ({"tp": 2}, "llama", {}, 1),
    ])
    def test_same_as_the_jax_validation(self, axes, family, over, n):
        if family == "tiny":
            pcfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
        elif family == "moe":
            pcfg, jcfg = MoeConfig(**MOE, **over), JaxMoeConfig(**MOE, **over)
        else:
            pcfg, jcfg = dataclasses.replace(CFG, **over), dataclasses.replace(JCFG, **over)
        _same_outcome(lambda: validate_serve_mesh(axes, pcfg, n_devices=n),
                      lambda: jax_sharded.validate_serve_mesh(axes, jcfg, n_devices=n))

    def test_build_mesh_device_budget(self):
        with pytest.raises(ShardingError, match="devices"):
            build_serve_mesh({"tp": 16}, ranks=range(8))
        mesh = build_serve_mesh({"tp": 4}, ranks=range(8))
        assert dict(zip(mesh.axis_names, (mesh.axis_sizes[a] for a in mesh.axis_names)))["tp"] == 4
        assert mesh.ranks == (0, 1, 2, 3)


SHARED = {"NEXUS_DEVICE": "cpu", "NEXUS_RANK_DEVICE_MAP": "shared"}


class TestServeConfigMesh:
    """NEXUS_SERVE_MESH is parse-validated as in the JAX package: unknown
    axes, non-divisible head counts and over-sized meshes fail at
    ``ServeConfig`` construction, before any device work.  The port counts
    the devices it has: cards one a rank, or the rehearsal map's ranks."""

    def test_valid_mesh_parses(self):
        env = {"NEXUS_MODEL_PRESET": "tiny", "NEXUS_SERVE_MESH": "tp=2"}
        assert ServeConfig.from_env({**env, **SHARED}).serve_mesh == JaxServeConfig.from_env(env).serve_mesh

    def test_unknown_axis_fails_at_parse(self):
        with pytest.raises(ValueError, match="unknown mesh axis"):
            ServeConfig(serve_mesh="tpx=2", device="cpu", rank_map="shared")

    def test_non_divisible_heads_fail_at_parse(self):
        with pytest.raises(ValueError, match="KV heads") as got:
            ServeConfig(serve_mesh="tp=4", device="cpu", rank_map="shared")
        with pytest.raises(ValueError) as want:
            JaxServeConfig(serve_mesh="tp=4")
        assert str(got.value) == str(want.value)

    def test_oversized_mesh_fails_at_parse(self):
        with pytest.raises(ValueError, match="devices"):
            ServeConfig(model=CFG, serve_mesh="tp=64")
        # more ranks than cards, and ranks on the CPU without the map
        with pytest.raises(ValueError, match="wants 2 devices"):
            ServeConfig(model=CFG, serve_mesh="tp=2", device="cpu")

    def test_axes_the_port_does_not_serve_fail_at_parse(self):
        """Every axis of AXIS_ORDER is served since ROADMAP A6b-iii: a
        replicate axis (pp, dp, fsdp, sp) parses and validates as in the
        reference, and a mesh the reference refuses fails alike."""
        for spec in ("dp=2", "pp=2,tp=2", "dp=2,tp=2"):
            want = JaxServeConfig(model=JCFG, serve_mesh=spec).serve_mesh
            assert ServeConfig(model=CFG, serve_mesh=spec, device="cpu", rank_map="shared").serve_mesh == want
        with pytest.raises(ValueError) as want:
            JaxServeConfig(serve_mesh="sp=2,tp=4")
        with pytest.raises(ValueError, match="KV heads") as got:
            ServeConfig(serve_mesh="sp=2,tp=4", device="cpu", rank_map="shared")
        assert str(got.value) == str(want.value)

    def test_rank_map_is_explicit_and_checked(self):
        with pytest.raises(ValueError, match="needs NEXUS_SERVE_MESH"):
            ServeConfig(device="cpu", rank_map="shared")
        with pytest.raises(ValueError, match="unknown rank_map"):
            ServeConfig(serve_mesh="tp=2", device="cpu", rank_map="one")


# -- regex partition rules -----------------------------------------------------


def _jax_axes_flat(tree):
    flat = jax.tree_util.tree_leaves(jax_sharded.match_partition_rules(tree), is_leaf=lambda x: isinstance(x, tuple))
    return flat


def _port_axes_flat(axes):
    out = []

    def walk(node):  # the JAX tree's leaf order: dict keys sorted

        if isinstance(node, tuple):
            out.append(node)
            return
        for k in sorted(node):
            walk(node[k])

    walk(axes)
    return out


def _jax_moe_tree(**over):
    cfg = JaxMoeConfig(vocab_size=64, hidden=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
                       intermediate=64, n_experts=4, max_seq_len=64, remat=False, **over)
    return jax.tree.map(np.asarray, jax_moe_init(jax.random.PRNGKey(0), cfg))


def _numpy_qtree(mode, group=16):
    """The JAX package's quantized tree in models/convert.py's numpy form."""
    from tpu_nexus.models.quant import QTensor as JQ, QTensor4 as JQ4

    qp = jax_quantize_params(JPARAMS, mode=mode, group=group)

    def leaf(x):
        if isinstance(x, JQ4):
            return {"q": np.asarray(x.q), "s": np.asarray(x.s), "contract_shape": tuple(x.contract_shape),
                    "out_shape": tuple(x.out_shape), "group": x.group}
        if isinstance(x, JQ):
            return {"q": np.asarray(x.q), "s": np.asarray(x.s)}
        return np.asarray(x)

    return qp, jax.tree.map(leaf, qp, is_leaf=lambda x: isinstance(x, (JQ, JQ4)))


class TestPartitionRules:
    @pytest.mark.parametrize("tree", ["llama", "untied", "moe", "int8", "int4"])
    def test_same_axes_and_specs_as_the_jax_rules(self, tree):
        if tree == "llama":
            port, ref = TREE, TREE
        elif tree == "untied":
            cfg = dataclasses.replace(JCFG, vocab_size=64, tied_embeddings=False)
            port = ref = jax.tree.map(np.asarray, jax_llama_init(jax.random.PRNGKey(0), cfg))
            assert "lm_head" in port
        elif tree == "moe":
            port = ref = _jax_moe_tree()
        else:
            ref, port = _numpy_qtree(tree)
        assert _port_axes_flat(match_partition_rules(port)) == _jax_axes_flat(ref)
        jspecs = jax_sharded.serving_param_shardings(ref, jax_sharded.build_serve_mesh({"tp": 2}))
        want = [tuple(s.spec) + (None,) * (len(a) - len(s.spec))
                for s, a in zip(jax.tree_util.tree_leaves(jspecs), _jax_axes_flat(ref))]
        assert _port_axes_flat(serving_param_shardings(port, {"tp": 2})) == want

    def test_moe_and_quantized_rows(self):
        axes = match_partition_rules(_jax_moe_tree())
        assert axes["layers"]["w_gate"] == ("layers", "expert", "embed", "mlp")
        assert axes["layers"]["router"] == ("layers", "embed", None)
        sh = serving_param_shardings(_numpy_qtree("int8")[1], {"tp": 4})
        # q [L, F, E] shards mlp on tp; its scale [L, 1, E] replicates the
        # collapsed contraction dim instead of erroring on 1 % 4
        assert sh["layers"]["w_down"]["q"][1] == "tp"
        assert sh["layers"]["w_down"]["s"][1] is None

    def test_unmatched_leaf_raises(self):
        with pytest.raises(ShardingError, match="no serving partition rule"):
            match_partition_rules({"mystery": np.zeros((4, 4))})

    def test_scalar_leaves_replicate(self):
        axes = match_partition_rules({"embed": {"tokens": np.zeros((8, 8))}, "t": np.float32(1.0)})
        assert axes["t"] == ()

    def test_shardings_layout(self):
        sh = serving_param_shardings(TREE, {"tp": 4})
        assert sh["layers"]["wq"] == (None, None, "tp", None)
        assert sh["layers"]["attn_norm"] == (None, None)
        assert kv_cache_sharding(build_serve_mesh({"tp": 4}, ranks=range(4))).spec == (None, None, None, "tp", None)

    def test_non_divisible_dim_raises_naming_the_leaf(self):
        bad = {"embed": {"tokens": np.zeros((250, 64), np.float32)}}  # 250 % 4
        with pytest.raises(ShardingError, match="embed/tokens.*not divisible"):
            serving_param_shardings(bad, {"tp": 4})

    @pytest.mark.parametrize("mode", ["", "int4"])
    def test_a_rank_holds_its_share(self, mode):
        """Each rank's slice of the JAX tree equals the JAX sharded array's
        shard on the matching device (the per-rank form of convert.py)."""
        jtree, tree = (JPARAMS, TREE) if not mode else _numpy_qtree(mode)
        jmesh = jax_sharded.build_serve_mesh({"tp": 4})
        shards = jax_sharded.shard_serving_params(jtree, jmesh)
        for rank in range(4):
            mesh = build_serve_mesh({"tp": 4}, ranks=range(4))
            mesh.rank = rank
            local = shard_serving_params(tree, mesh)
            wq = shards["layers"]["wq"]
            got = local["layers"]["wq"]["q"] if mode else local["layers"]["wq"]
            ref = (wq.q if mode else wq).addressable_shards[rank].data
            np.testing.assert_array_equal(got, np.asarray(ref))
            params = params_from_numpy_shard(tree, CFG, mesh, device="cpu")
            if not mode:
                assert tuple(params["layers"]["wq"].shape) == (2, 64, 1, 16)
                assert tuple(params["embed"]["tokens"].shape) == (64, 64)


# -- shard-aware cache allocation ----------------------------------------------


class TestShardedCacheInit:
    def test_contiguous_allocates_the_ranks_heads(self):
        sh = kv_cache_sharding(build_serve_mesh({"tp": 4}, ranks=range(4)))
        cache = init_cache(CFG, 2, 16, shardings=sh, device="cpu")
        assert cache["k"].shape == (2, 2, 16, 1, 16)

    def test_paged_allocates_the_ranks_heads_int8(self):
        sh = kv_cache_sharding(build_serve_mesh({"tp": 2}, ranks=range(2)))
        cache = init_paged_cache(CFG, 9, 4, kv_quant="int8", shardings=sh, device="cpu")
        assert cache["k"].dtype == torch.int8
        for name in ("k", "v", "k_s", "v_s"):
            assert cache[name].shape[3] == 2, name
        assert cache["k"].shape == (2, 9, 4, 2, 16)

    def test_non_divisible_kv_heads_rejected(self):
        sh = kv_cache_sharding(build_serve_mesh({"tp": 4}, ranks=range(4)))
        with pytest.raises(ValueError, match="not divisible"):
            init_cache(LlamaConfig.tiny(), 2, 16, shardings=sh, device="cpu")  # 2 KV heads


# -- token identity: the gate --------------------------------------------------


def _jax_forced_logits(prompt, forced, kv_quant=""):
    cache, logits = jax_generate.prefill(JPARAMS, jnp.asarray(prompt[None]), JCFG, len(prompt) + len(forced),
                                         kv_quant=kv_quant)
    out = [np.asarray(logits)]
    for j in range(len(forced) - 1):
        logits, cache = jax_generate.decode_step(JPARAMS, cache, jnp.asarray(forced[None, j]),
                                                 jnp.asarray(len(prompt) + j, jnp.int32), JCFG)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


class TestTokenIdentity:
    """Sharded greedy == the JAX sharded executors' == one-shot generate,
    with staggered slot reuse (twice as many requests as slots)."""

    @pytest.mark.parametrize("kv_quant", ["", "int8"])
    @pytest.mark.parametrize("paged", [False, True])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_matrix(self, pool, tp, paged, kv_quant):
        kwargs = dict(num_slots=SLOTS, max_len=S + T, kv_quant=kv_quant)
        sharded = _sharded(pool, tp, paged, **kwargs)
        try:
            multi = _drain(ServingEngine(sharded))
            # teacher-forced along the first request's stream
            forced = np.asarray(multi["r0"], np.int32)[None]
            got = sharded.teacher_forced_logits(PROMPTS[0][None], forced)
        finally:
            sharded.close()
        assert multi == _drain(jax_serving.ServingEngine(_jax_sharded(tp, paged, **kwargs)))
        for i, p in enumerate(PROMPTS):
            assert multi[f"r{i}"] == _ref(PARAMS, p, kv_quant=kv_quant), i
        ref = _jax_forced_logits(PROMPTS[0], forced[0], kv_quant)
        assert got.shape == ref.shape
        scale = float(np.abs(ref).max())
        assert float(np.abs(got[:, 0] - ref[:, 0]).max()) <= 1e-5 * scale  # the prefill's logits
        # int8 KV: a K/V element within 1e-7 of a rounding edge lands one
        # int8 step (1/127 of its row's amax) away when the sharded sums
        # round differently, which moves the decode logits ~1e-3 (tp 4:
        # 5.0e-4 x max|ref|; ROADMAP.md queue C); f32 KV has no such edge
        tol = 1e-5 if not kv_quant else 1e-3
        assert float(np.abs(got - ref).max()) <= tol * scale

    def test_quantized_weights_tp2(self, pool):
        """int8 weights shard through the same rules (scales of the
        row-parallel leaves reduced over tp): the sharded engine matches
        the one-device quantized engine token for token."""
        kw = dict(num_slots=SLOTS, max_len=S + T, quantize="int8")
        single = _drain(ServingEngine(ModelExecutor(params_from_numpy(TREE, CFG, device="cpu"), CFG, **kw)))
        sharded = _sharded(pool, 2, **kw)
        try:
            multi = _drain(ServingEngine(sharded))
            assert sharded.weight_bytes == ModelExecutor(PARAMS, CFG, **kw).weight_bytes
        finally:
            sharded.close()
        assert multi == single

    def test_speculative_ngram_tp4(self, pool):
        sharded = _sharded(pool, 4, num_slots=SLOTS, max_len=S + T)
        try:
            eng = ServingEngine(sharded, spec_k=2, drafter=NGramDrafter(SLOTS))
            multi = _drain(eng)
        finally:
            sharded.close()
        for i, p in enumerate(PROMPTS):
            assert multi[f"r{i}"] == _ref(PARAMS, p), i
        assert eng.metrics.summary()["spec_proposed"] > 0

    def test_overlap_multistep_tp4(self, pool):
        """Overlap + multi-step decode over the sharded step_scan: each
        rank keeps its own device carries, fed back by reference."""
        sharded = _sharded(pool, 4, num_slots=SLOTS, max_len=S + T, decode_steps=4)
        try:
            multi = _drain(ServingEngine(sharded, overlap=True))
        finally:
            sharded.close()
        for i, p in enumerate(PROMPTS):
            assert multi[f"r{i}"] == _ref(PARAMS, p), i


MOE_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=96,
              n_experts=4, experts_per_token=2, max_seq_len=256, remat=False)


@pytest.mark.parametrize("axes", [{"ep": 2}, {"tp": 2}], ids=["ep2", "tp2"])
def test_moe_token_identity(pool, axes):
    """The tiny MoE (4 experts) at ep=2 (2 experts a rank, the combine
    summed) and tp=2 (every expert's mlp split) against the one-device
    engine of the port and the JAX package's sharded executor."""
    jcfg = JaxMoeConfig(**MOE_KW, dtype=jnp.float32, param_dtype=jnp.float32)
    pcfg = MoeConfig(**MOE_KW, dtype=torch.float32, param_dtype=torch.float32)
    jparams = jax_moe_init(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    kw = dict(num_slots=SLOTS, max_len=S + T)
    single = _drain(ServingEngine(ModelExecutor(params_from_numpy(tree, pcfg, device="cpu"), pcfg, **kw)))
    sharded = ShardedModelExecutor(NumpyParams(tree), pcfg, mesh=pool.mesh(axes), **kw)
    try:
        multi = _drain(ServingEngine(sharded))
    finally:
        sharded.close()
    assert multi == single
    jex = jax_sharded.ShardedModelExecutor(jparams, jcfg, mesh=jax_sharded.build_serve_mesh(axes), **kw)
    assert multi == _drain(jax_serving.ServingEngine(jex))


# -- shard-aware weight swaps (rolling updates) --------------------------------


def _checkpointed(tmp_path, params, step=2):
    ck = TensorCheckpointer(str(tmp_path / "ckpt"))
    ck.save(step, {"params": params})
    ck.commit(step)
    return ck


class TestShardedSwap:
    """Rolling update over a SHARDED replica from a committed checkpoint:
    only the directory and step cross to the workers (each rank reads its
    slice); in-flight requests finish on the old weights, post-swap ones
    run on the new."""

    @pytest.mark.parametrize("tp", [2, 4])
    def test_swap_reads_each_ranks_slice(self, pool, tmp_path, tp):
        ck = _checkpointed(tmp_path, PARAMS_NEW)
        sharded = _sharded(pool, tp, num_slots=2, max_len=S + T)
        try:
            eng = ServingEngine(sharded)
            inflight = [eng.submit(PROMPTS[i], T, request_id=f"old{i}") for i in range(2)]
            for _ in range(2):
                eng.step()
            assert any(not r.is_terminal() for r in inflight)
            straddler = eng.submit(PROMPTS[2], T, request_id="straddler")
            eng.quiesce(grace_s=60.0)
            assert straddler.state == RequestState.QUEUED
            ref = ck.params_ref(2)
            assert (ref.directory, ref.step) == (ck.directory, 2)
            eng.swap_params(ref)
            eng.resume_admission()
            assert tuple(sharded.params["layers"]["wq"].shape) == (2, 64, 4 // tp, 16)
            torch.testing.assert_close(sharded.params["layers"]["wq"], PARAMS_NEW["layers"]["wq"][:, :, :4 // tp],
                                       rtol=0, atol=0)
            for i, req in enumerate(inflight):
                assert req.state == RequestState.FINISHED
                assert [int(t) for t in req.output_tokens] == _ref(PARAMS, PROMPTS[i]), i
            post = eng.submit(PROMPTS[0], T, request_id="post")
            eng.run_until_drained(max_steps=2000)
            assert [int(t) for t in post.output_tokens] == _ref(PARAMS_NEW, PROMPTS[0])
            assert [int(t) for t in straddler.output_tokens] == _ref(PARAMS_NEW, PROMPTS[2])
            assert eng.weight_swaps == 1
        finally:
            sharded.close()
            ck.close()

    def test_a_whole_tree_is_refused(self, pool):
        sharded = _sharded(pool, 2, num_slots=1, max_len=16)
        try:
            with pytest.raises(TypeError, match="ParamSource"):
                sharded.swap_params(PARAMS_NEW)
        finally:
            sharded.close()

    def test_fleet_rolling_update_over_sharded_replicas(self, pool, tmp_path):
        """The fleet drives two sharded replicas (ranks 0+1 and 0+2: the
        fleet's process is both leaders): one verified step, each rank of
        each replica reading its slice; zero requests dropped."""
        ck = _checkpointed(tmp_path, PARAMS_NEW)
        meshes = pool.meshes([({"tp": 2}, (0, 1)), ({"tp": 2}, (0, 2))])
        executors = [ShardedModelExecutor(NumpyParams(TREE), CFG, mesh=m, num_slots=2, max_len=S + T)
                     for m in meshes]
        try:
            fleet = ServingFleet()
            for name, executor in zip(("rep-0", "rep-1"), executors):
                fleet.add_replica(name, ServingEngine(executor), step=1)
            assert fleet.start_rollout(ck, 2, grace_s=60.0)
            reqs = []
            for i in range(8):
                reqs.append(fleet.submit(PROMPTS[i % len(PROMPTS)], T))
                fleet.tick()
            for _ in range(500):
                fleet.tick()
                if not fleet.rollout_active and not fleet.has_work:
                    break
            fleet.run_until_drained()
            assert fleet.converged(2)
            assert fleet.rollouts_completed == 1
            assert all(r.state == RequestState.FINISHED for r in reqs)
            for rep in fleet.replicas.values():
                torch.testing.assert_close(rep.engine.executor.params["layers"]["wq"],
                                           PARAMS_NEW["layers"]["wq"][:, :, :2], rtol=0, atol=0)
            post = fleet.submit(PROMPTS[1], T)
            fleet.run_until_drained()
            assert [int(t) for t in post.output_tokens] == _ref(PARAMS_NEW, PROMPTS[1])
        finally:
            for executor in executors:
                executor.close()
            ck.close()

    def test_mismatched_swap_still_refused(self, pool, tmp_path):
        """A checkpoint of another shape is refused on every rank alike: the
        leader raises the one-device wording and every rank serves on."""
        small = params_from_numpy(jax.tree.map(np.asarray, jax_llama_init(
            jax.random.PRNGKey(1), dataclasses.replace(JCFG, intermediate=64))),
            dataclasses.replace(CFG, intermediate=64), device="cpu")
        ck = _checkpointed(tmp_path, small)
        sharded = _sharded(pool, 2, num_slots=1, max_len=16)
        try:
            eng = ServingEngine(sharded)
            with pytest.raises(ValueError, match="shapes"):
                eng.swap_params(ck.params_ref(2))
            out = _drain(eng, prompts=PROMPTS[:1], n=4)
            assert out["r0"] == _ref(PARAMS, PROMPTS[0], n=4)
        finally:
            sharded.close()
            ck.close()


# -- serve loop e2e and lost workers -------------------------------------------


def _container_env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
    env.update(
        NEXUS_MODE="serve-engine", NEXUS_MODEL_PRESET="tiny", NEXUS_DEVICE="cpu", NEXUS_SERVE_MESH="tp=2",
        NEXUS_RANK_DEVICE_MAP="shared", NEXUS_DIST_TIMEOUT_S="20", NEXUS_RUN_ID="sharded",
        NEXUS_ALGORITHM="serve", NEXUS__CQL_STORE_TYPE="sqlite",
        NEXUS__SQLITE_STORE_PATH=str(tmp_path / "ledger.db"), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
        NEXUS_TRACE="0", **extra,
    )
    return env


def _row(tmp_path):
    store = SqliteCheckpointStore(str(tmp_path / "ledger.db"))
    try:
        return store.read_checkpoint("serve", "sharded")
    finally:
        store.close()


_STUCK = """
import json, os, signal, sys, time
import torch
from tpu_nexus_torch.models.llama import LlamaConfig
from tpu_nexus_torch.serving.sharded import RankPool, SeedParams, ShardedModelExecutor, ShardLost


class StallingParams(SeedParams):
    # a worker that stops answering in the middle of the swap, after the header
    def load(self, mesh, cfg, device):
        if not mesh.is_leader:
            os.kill(os.getpid(), signal.SIGSTOP)
        return super().load(mesh, cfg, device)


if __name__ == "__main__":
    torch.set_num_threads(1)
    cfg = LlamaConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
                      intermediate=128, max_seq_len=64, remat=False, dtype=torch.float32,
                      param_dtype=torch.float32)
    pool = RankPool(2, device="cpu", rank_map="shared", timeout_s=5.0, join_timeout_s=5.0)
    ex = ShardedModelExecutor(SeedParams(0), cfg, mesh=pool.mesh({"tp": 2}), num_slots=1, max_len=16)
    before = ex.params["layers"]["wq"].clone()
    if sys.argv[1] == "between calls":
        os.kill(pool.procs[0].pid, signal.SIGSTOP)
    t0 = time.monotonic()
    try:
        ex.swap_params(StallingParams(1))
        lost = None
    except ShardLost as exc:
        lost = str(exc)
    elapsed = time.monotonic() - t0
    kept = torch.equal(ex.params["layers"]["wq"], before)
    pool.procs[0].kill()
    pool.close()
    print(json.dumps({"lost": lost, "elapsed": elapsed, "kept": kept}))
"""


class TestServeLoopSharded:
    def test_serve_engine_container_under_mesh(self, tmp_path):
        """``python -m tpu_nexus_torch.workload`` with NEXUS_SERVE_MESH=tp=2
        starts its shard worker, serves, stops it, lands COMPLETED."""
        env = _container_env(tmp_path, NEXUS_BATCH="2", NEXUS_PROMPT_LEN="8", NEXUS_GEN_TOKENS="3",
                             NEXUS_STEPS="1", NEXUS_PAGE_SIZE="4")
        proc = subprocess.run([sys.executable, "-m", "tpu_nexus_torch.workload"], env=env, cwd=str(tmp_path),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "started shard worker rank 1" in proc.stderr
        assert _row(tmp_path).lifecycle_stage == LifecycleStage.COMPLETED

    def test_killed_worker_fails_the_container(self, tmp_path):
        """A shard worker killed mid-serve: the leader raises ShardLost, the
        row ends FAILED naming the dead rank, the container exits non-zero
        — well inside the process group's 20 s timeout."""
        env = _container_env(tmp_path, NEXUS_BATCH="2", NEXUS_PROMPT_LEN="8", NEXUS_GEN_TOKENS="64",
                             NEXUS_STEPS="400", NEXUS_HEARTBEAT_EVERY="1")
        proc = subprocess.Popen([sys.executable, "-m", "tpu_nexus_torch.workload"], env=env, cwd=str(tmp_path),
                                stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
        try:
            pid = None
            deadline = time.monotonic() + 90
            while pid is None and time.monotonic() < deadline:
                line = proc.stderr.readline()
                if "started shard worker rank 1 pid" in line:
                    pid = int(line.split(" pid ")[1].split()[0])
            assert pid is not None
            while time.monotonic() < deadline:
                row = _row(tmp_path)
                if row is not None and row.per_chip_steps:
                    break
                time.sleep(0.2)
            os.kill(pid, signal.SIGKILL)
            t0 = time.monotonic()
            err = proc.communicate(timeout=60)[1]
            elapsed = time.monotonic() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode != 0
        assert "ShardLost" in err, err[-3000:]
        assert elapsed < 20.0
        row = _row(tmp_path)
        assert row.lifecycle_stage == LifecycleStage.FAILED
        assert "lost a rank: rank(s) [1] stopped answering" in (row.algorithm_failure_cause or "")

    @pytest.mark.parametrize("when,words", [("between calls", "header did not reach"),
                                            ("mid-call", "lost during swap")])
    def test_a_stuck_worker_is_lost_within_the_timeout(self, tmp_path, when, words):
        """A worker that stops answering with its sockets open (SIGSTOP):
        before the leader's next header, or in the middle of a swap, a call
        in which no model collective runs.  The leader's groups and the
        ranks' agreement after each call keep the replica's finite timeout
        (5 s here), so the leader raises ShardLost with its old weights
        kept; only a waiting worker has the idle timeout."""
        script = tmp_path / "stuck.py"
        script.write_text(_STUCK)
        env = {k: v for k, v in os.environ.items() if not k.startswith("NEXUS")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        out = tmp_path / "out.txt"
        with open(out, "w") as fh:  # a file, not a pipe: a stopped worker would hold a pipe open
            proc = subprocess.Popen([sys.executable, str(script), when], env=env, cwd=str(tmp_path),
                                    stdout=fh, stderr=subprocess.STDOUT, start_new_session=True)
            try:
                proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        text = out.read_text()
        assert proc.returncode == 0, text[-3000:]
        got = json.loads(text.strip().splitlines()[-1])
        assert got["lost"] and words in got["lost"], got
        assert got["elapsed"] < 5.0 + 10.0, got
        assert got["kept"]
