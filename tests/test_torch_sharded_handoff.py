"""The KV handoff of a sharded paged pool and the model drafter beside a
sharded executor, held against the JAX package.

The JAX package's ``ShardedPagedModelExecutor`` inherits the one-device
handoff: its payload holds every kv head, gathered to the host, so a
tp-sharded replica is a disaggregated fleet's prefill or decode replica
beside one-device replicas.  The port's ranks are processes over gloo on
the CPU (``serving/sharded.py::RankPool``, all on the one CPU device under
the rehearsal map; one pool of five ranks serves the module, this process
is rank 0); the JAX sharded executors run on the conftest's virtual CPU
devices, on the same numpy weights (``models/convert.py``).

* **Extract** — a tp-2 and a tp-4 replica's payload equals the JAX sharded
  executor's on the same prompt and blocks: the same leaves, shapes and
  dtypes, values within 1e-5 max-abs in f32, int8 bytes exact; its
  geometry (``kv_leaf_specs``) is one device's.  Under ``ep=2`` (the tiny
  MoE: heads whole on every rank) the payload equals one device's.
* **Install** — a one-device payload installed into a tp-2 and a
  dp-2 x tp-2 replica lands on every rank (each rank's CRC32 of its slice
  equals the payload's slice) and reads back byte for byte; a corrupt
  payload raises ``PayloadCorrupt`` on the leader with no rank's pool
  written, and the replica serves on.
* **Fleets** — two prefill and two decode replicas (the topology of
  ``tests/test_torch_disagg.py``): all tp-2, tp-2 prefill beside one-device
  decode, and the reverse; greedy tokens equal one fused engine's and the
  JAX disaggregated fleet's, one handoff a request, no fallback; the fault
  wrapper's ``handoff-corrupt`` on a tp-2 decode replica is refused by
  each decode replica's leader and the request degrades to fused serving,
  as in a one-device fleet.
* **The model drafter** — ``run_serve_engine`` with ``NEXUS_SERVE_MESH=tp=2``,
  ``spec_k`` 2 and a self-draft from a checkpoint: the same f32 tokens and
  acceptance counts as the JAX ``run_serve_engine`` under the same settings
  and weights; a draft preset of another vocab is refused in the JAX
  package's words; each ``ParamSource`` loads the whole tree onto one
  device, a checkpoint only after its step verifies.

Tolerances: tokens, CRCs and int8 bytes exactly; f32 blocks 1e-5 max-abs.
"""

import dataclasses
import os

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
from tpu_nexus.parallel.distributed import ProcessContext as JaxProcessContext
from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
from tpu_nexus_torch.models.convert import params_from_numpy
from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.parallel.distributed import ProcessContext
from tpu_nexus_torch.serving import (
    ROLE_DECODE,
    ROLE_PREFILL,
    DisaggConfig,
    PagedModelExecutor,
    PayloadCorrupt,
    RequestState,
    ServingEngine,
    ServingFleet,
)
from tpu_nexus_torch.serving.handoff import leaf_bytes, leaf_checksum
from tpu_nexus_torch.serving.sharded import (
    CheckpointParams,
    NumpyParams,
    RankPool,
    SeedParams,
    ShardedPagedModelExecutor,
)
from tpu_nexus_torch.workload.faults import FaultyExecutor
from tpu_nexus_torch.workload.serve import ServeConfig, run_serve_engine
from tpu_nexus_torch.workload.tensor_checkpoint import CheckpointCorrupt, TensorCheckpointer

torch.set_num_threads(1)

# f32 compute; 4 kv heads divide tp 2 and 4
LLAMA_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16, intermediate=128,
                max_seq_len=256, remat=False)
JCFG = JaxLlamaConfig(**LLAMA_KW, dtype=jnp.float32, param_dtype=jnp.float32)
CFG = LlamaConfig(**LLAMA_KW, dtype=torch.float32, param_dtype=torch.float32)
JPARAMS = jax_llama_init(jax.random.PRNGKey(0), JCFG)
TREE = jax.tree.map(np.asarray, JPARAMS)
PARAMS = params_from_numpy(TREE, CFG, device="cpu")
MOE_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=96,
              n_experts=4, experts_per_token=2, max_seq_len=256, remat=False)

S, T, PAGE = 12, 5, 4
PROMPT = np.random.default_rng(3).integers(1, 256, size=11).astype(np.int32)
TIMEOUT_S = 30.0


@pytest.fixture(scope="module")
def pool():
    with RankPool(5, device="cpu", rank_map="shared", timeout_s=TIMEOUT_S, join_timeout_s=20.0) as p:
        yield p


def _sharded(mesh, slots=2, kv_quant="", tree=TREE, cfg=CFG):
    return ShardedPagedModelExecutor(NumpyParams(tree), cfg, mesh=mesh, num_slots=slots, max_len=S + T,
                                     page_size=PAGE, kv_quant=kv_quant)


def _one(slots=2, kv_quant="", params=PARAMS, cfg=CFG):
    return PagedModelExecutor(params, cfg, num_slots=slots, max_len=S + T, page_size=PAGE, kv_quant=kv_quant)


def _same_payload(got, want, exact=False):
    assert (got.first_token, got.n_blocks, got.page_size, got.prompt) == (
        want.first_token, want.n_blocks, want.page_size, tuple(int(t) for t in want.prompt))
    assert sorted(got.blocks) == sorted(want.blocks)
    for name, leaf in got.blocks.items():
        ref = np.asarray(want.blocks[name])
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu" and leaf.is_contiguous()
        assert tuple(leaf.shape) == ref.shape, name
        assert str(leaf.dtype).removeprefix("torch.") == str(ref.dtype), name
        if exact or leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=0, atol=1e-5, err_msg=name)
        assert got.checksums[name] == leaf_checksum(leaf)


# -- extract -------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_extract_matches_the_jax_sharded_executor(pool, tp, kv_quant):
    """A sharded replica's payload: every head, in block-table order, as the
    JAX sharded executor's on the same weights and prompt, and with one
    device's geometry."""
    sx = _sharded(pool.mesh({"tp": tp}), kv_quant=kv_quant)
    try:
        got = ServingEngine(sx).prefill_remote(PROMPT, "r0", source_replica="pf")
        specs = sx.kv_leaf_specs()
    finally:
        sx.close()
    jex = jax_sharded.ShardedPagedModelExecutor(JPARAMS, JCFG, mesh=jax_sharded.build_serve_mesh({"tp": tp}),
                                                num_slots=2, max_len=S + T, page_size=PAGE, kv_quant=kv_quant)
    want = jax_serving.ServingEngine(jex).prefill_remote(PROMPT, "r0", source_replica="pf")
    _same_payload(got, want)
    assert specs == _one(kv_quant=kv_quant).kv_leaf_specs()


def test_ep2_payload_equals_one_device(pool):
    """The tiny MoE at ``ep=2``: kv heads are whole on every rank, so the
    leader's own blocks are the payload, equal to one device's."""
    from tpu_nexus.models.moe import MoeConfig as JaxMoeConfig
    from tpu_nexus.models.moe import moe_init as jax_moe_init

    tree = jax.tree.map(np.asarray, jax_moe_init(jax.random.PRNGKey(3), JaxMoeConfig(**MOE_KW)))
    cfg = MoeConfig(**MOE_KW, dtype=torch.float32, param_dtype=torch.float32)
    sx = _sharded(pool.mesh({"ep": 2}), tree=tree, cfg=cfg)
    try:
        got = ServingEngine(sx).prefill_remote(PROMPT, "r0")
    finally:
        sx.close()
    want = ServingEngine(_one(params=params_from_numpy(tree, cfg, device="cpu"), cfg=cfg)).prefill_remote(PROMPT, "r0")
    _same_payload(got, want, exact=True)


# -- install -------------------------------------------------------------------


def _slices(payload, tp, copies):
    """The CRC32 of each rank's slice of the payload's heads, in mesh order
    (tp fastest)."""
    out = []
    for _copy in range(copies):
        for t in range(tp):
            row = {}
            for name, leaf in payload.blocks.items():
                h = leaf.shape[3] // tp
                row[name] = leaf_checksum(leaf[:, :, :, t * h:(t + 1) * h].contiguous())
            out.append(row)
    return out


@pytest.mark.parametrize("axes,kv_quant", [({"tp": 2}, ""), ({"dp": 2, "tp": 2}, "int8")],
                         ids=["tp2_f32", "dp2xtp2_int8"])
def test_install_round_trips_on_every_rank(pool, axes, kv_quant):
    """A one-device payload installed into a sharded pool: each rank holds
    its slice of the heads (every copy of a replicate axis too), and the
    blocks read back byte for byte."""
    payload = ServingEngine(_one(kv_quant=kv_quant)).prefill_remote(PROMPT, "r0")
    ids = np.array([5, 2, 7], np.int64)
    sx = _sharded(pool.mesh(axes), kv_quant=kv_quant)
    try:
        sx.install_blocks(payload, ids)
        per_rank = sx.block_checksums(ids)
        back = sx.extract_blocks(ids)
    finally:
        sx.close()
    assert per_rank == _slices(payload, axes["tp"], axes.get("dp", 1))
    for name, leaf in payload.blocks.items():
        assert leaf_bytes(back[name]).tobytes() == leaf_bytes(leaf).tobytes(), name


def test_a_corrupt_payload_writes_no_rank(pool):
    """A flipped byte, and a payload of one rank's heads: the leader raises
    ``PayloadCorrupt`` before any rank is told, every rank's pool is as it
    was, and the replica installs the good payload next."""
    payload = ServingEngine(_one()).prefill_remote(PROMPT, "r0")
    ids = np.array([3, 4, 6], np.int64)
    sx = _sharded(pool.mesh({"tp": 2}))
    try:
        before = sx.block_checksums(ids)
        bad = dataclasses.replace(payload, blocks={n: b.clone() for n, b in payload.blocks.items()})
        leaf_bytes(bad.blocks["v"])[17] ^= 0xFF
        with pytest.raises(PayloadCorrupt, match="crc32"):
            sx.install_blocks(bad, ids)
        half = dataclasses.replace(payload, blocks={n: b[:, :, :, :2].contiguous() for n, b in payload.blocks.items()})
        half.seal()
        with pytest.raises(PayloadCorrupt, match="shape"):
            sx.install_blocks(half, ids)
        assert sx.block_checksums(ids) == before
        sx.install_blocks(payload, ids)
        assert sx.block_checksums(ids) == _slices(payload, 2, 1)
    finally:
        sx.close()


# -- disaggregated fleets --------------------------------------------------------


def _prompts(seed=7, lens=(5, 8, 3, 11, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def reference_tokens():
    """The JAX disaggregated fleet's tokens (two prefill and two decode
    replicas, ``tests/test_torch_disagg.py``'s topology) and one fused
    engine's of the port, on the same prompts."""
    fleet = jax_serving.ServingFleet(disagg=jax_serving.DisaggConfig(), handoff_sleep=lambda s: None)
    for i in range(2):
        for name, role, slots in ((f"pf-{i}", jax_serving.ROLE_PREFILL, 2), (f"dc-{i}", jax_serving.ROLE_DECODE, 3)):
            fleet.add_replica(name, jax_serving.ServingEngine(jax_serving.PagedModelExecutor(
                JPARAMS, JCFG, num_slots=slots, max_len=S + T, page_size=PAGE, decode_kernel="xla")), step=1, role=role)
    reqs = [fleet.submit(p, T) for p in _prompts()]
    fleet.run_until_drained(max_steps=3000)
    assert fleet.handoffs_completed == len(reqs) and fleet.disagg_fallbacks == 0
    fused = ServingEngine(_one(slots=4))
    freqs = [fused.submit(p, T) for p in _prompts()]
    fused.run_until_drained(max_steps=3000)
    return [[int(t) for t in r.output_tokens] for r in reqs], [[int(t) for t in r.output_tokens] for r in freqs]


@pytest.mark.parametrize("sharded_roles", [("prefill", "decode"), ("prefill",), ("decode",)],
                         ids=["both_tp2", "tp2_prefill_one_device_decode", "one_device_prefill_tp2_decode"])
def test_disagg_fleet_matches_fused_and_jax(pool, reference_tokens, sharded_roles):
    jax_tokens, fused_tokens = reference_tokens
    n_sharded = 2 * len(sharded_roles)
    meshes = iter(pool.meshes([({"tp": 2}, (0, r)) for r in range(1, n_sharded + 1)]))
    fleet = ServingFleet(disagg=DisaggConfig(), handoff_sleep=lambda s: None)
    executors = []
    try:
        for i in range(2):
            for name, role, slots in ((f"pf-{i}", ROLE_PREFILL, 2), (f"dc-{i}", ROLE_DECODE, 3)):
                ex = _sharded(next(meshes), slots) if role in sharded_roles else _one(slots)
                executors.append(ex)
                fleet.add_replica(name, ServingEngine(ex), step=1, role=role)
        reqs = [fleet.submit(p, T) for p in _prompts()]
        fleet.run_until_drained(max_steps=3000)
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert fleet.handoffs_completed == len(reqs) and fleet.disagg_fallbacks == 0
        got = [[int(t) for t in r.output_tokens] for r in reqs]
        for name, rep in fleet.replicas.items():
            if rep.role == ROLE_PREFILL:
                assert not rep.engine.retired, f"{name} decoded"
    finally:
        for ex in executors:
            if isinstance(ex, ShardedPagedModelExecutor):
                ex.close()
    assert got == jax_tokens == fused_tokens


def test_corrupt_handoff_to_a_sharded_decode_replica_hops(pool, reference_tokens):
    """The fault wrapper wraps a sharded executor as it wraps one device's:
    ``handoff-corrupt`` on the first tp-2 decode replica is caught by its
    leader's validation, the corrupted payload is refused by the next
    decode replica's leader too, and the request degrades to fused serving
    (the one-device fleet's outcome); every request finishes with the
    fused engine's tokens."""
    meshes = iter(pool.meshes([({"tp": 2}, (0, 1)), ({"tp": 2}, (0, 2))]))
    fleet = ServingFleet(disagg=DisaggConfig(), handoff_sleep=lambda s: None)
    decoders = [_sharded(next(meshes), 3), _sharded(next(meshes), 3)]
    try:
        fleet.add_replica("pf-0", ServingEngine(_one(2)), step=1, role=ROLE_PREFILL)
        fleet.add_replica("dc-0", ServingEngine(FaultyExecutor(decoders[0], "handoff-corrupt", at_step=0, times=1)),
                          step=1, role=ROLE_DECODE)
        fleet.add_replica("dc-1", ServingEngine(decoders[1]), step=1, role=ROLE_DECODE)
        reqs = [fleet.submit(p, T) for p in _prompts()]
        fleet.run_until_drained(max_steps=3000)
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert [(e["stage"], e["replica"], e["cause"]) for e in fleet.handoff_log] == [
            ("decode", "dc-0", "handoff-corrupt"), ("decode", "dc-1", "handoff-corrupt"),
            ("fallback", "dc-0", "handoff-exhausted")]
        assert fleet.disagg_fallbacks == 1 and fleet.handoffs_completed == len(reqs) - 1
    finally:
        for ex in decoders:
            ex.close()
    assert [[int(t) for t in r.output_tokens] for r in reqs] == reference_tokens[1]


# -- the model drafter beside a sharded executor ----------------------------------


class _Recording:
    """A package's ``ServingEngine`` that keeps every engine it builds."""

    def __init__(self, engine_cls):
        self.built = []
        recorder = self

        class Engine(engine_cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                recorder.built.append(self)

        self.cls = Engine

    def tokens(self):
        (engine,) = self.built
        return {r.request_id: [int(t) for t in r.output_tokens] for r in engine.retired}


SERVE = dict(batch_size=2, prompt_len=8, gen_tokens=6, rounds=2, page_size=PAGE, spec_k=2, spec_drafter="model",
             serve_mesh="tp=2", trace_enabled=False)


def test_model_drafter_beside_tp2_matches_jax(pool, tmp_path, monkeypatch):
    """``run_serve_engine`` over a tp-2 replica with the model drafter
    self-drafting from the checkpoint the replica serves: the same requests,
    greedy tokens and acceptance as the JAX ``run_serve_engine`` (tp 2 on
    the virtual devices, self-draft over its init of the same weights)."""
    import tpu_nexus_torch.serving as port_serving

    ck = TensorCheckpointer(str(tmp_path / "ckpt"))
    ck.save(1, {"params": PARAMS})
    ck.commit(1)
    ck.close()
    port, ref = _Recording(port_serving.ServingEngine), _Recording(jax_serving.ServingEngine)
    monkeypatch.setattr(port_serving, "ServingEngine", port.cls)
    monkeypatch.setattr(jax_serving, "ServingEngine", ref.cls)
    cfg = ServeConfig(model=CFG, device="cpu", rank_map="shared", checkpoint_dir=str(tmp_path / "ckpt"), **SERVE)
    summary = run_serve_engine(cfg, store=InMemoryCheckpointStore(),
                               ctx=ProcessContext("draft", "serve", 0, 1, None), pool=pool)
    summary.pop("replica").close()
    jsummary = jax_serve.run_serve_engine(jax_serve.ServeConfig(model=JCFG, **SERVE), store=JaxInMemoryStore(),
                                          ctx=JaxProcessContext("draft", "serve", 0, 1, None))
    assert summary["restored_from"] == 1 and summary["finished"] == jsummary["finished"] == 4
    assert port.tokens() == ref.tokens()
    for key in ("spec_proposed", "spec_accepted"):
        assert summary[key] == jsummary[key] > 0, key
    assert [s["rank"] for s in summary["shard_stats"]] == [0, 1]


def test_a_draft_preset_of_another_vocab_is_refused_as_in_jax(pool):
    over = dict(SERVE, spec_draft_preset="nexus_1b")
    with pytest.raises(ValueError) as want:
        jax_serve.run_serve_engine(jax_serve.ServeConfig(model=JCFG, **over), store=JaxInMemoryStore(),
                                   ctx=JaxProcessContext("draft", "serve", 0, 1, None))
    with pytest.raises(ValueError) as got:
        run_serve_engine(ServeConfig(model=CFG, device="cpu", rank_map="shared", **over),
                         store=InMemoryCheckpointStore(), ctx=ProcessContext("draft", "serve", 0, 1, None), pool=pool)
    assert str(got.value) == str(want.value)
    assert "vocab 32768 != serving model vocab 256" in str(got.value)


def _equal_trees(a, b):
    flat_a, flat_b = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(flat_a) == sorted(flat_b)
    for name, leaf in flat_a.items():
        assert torch.equal(leaf, flat_b[name]), name


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach())]
    return [item for key in tree.keys() for item in _leaves(tree[key], f"{prefix}/{key}")]


@pytest.mark.parametrize("source", ["numpy", "seed", "checkpoint"])
def test_a_param_source_loads_the_whole_tree(tmp_path, source):
    """What the self-draft beside a sharded executor loads: the one-device
    tree of each source."""
    if source == "numpy":
        src, want = NumpyParams(TREE), PARAMS
    elif source == "seed":
        src, want = SeedParams(4), llama_init(torch.Generator().manual_seed(4), CFG, device="cpu")
    else:
        ck = TensorCheckpointer(str(tmp_path))
        ck.save(3, {"params": PARAMS})
        ck.commit(3)
        src, want = ck.params_ref(3), PARAMS
    _equal_trees(src.whole(CFG, "cpu"), want)


def test_a_checkpoint_self_draft_verifies_its_step_first(tmp_path):
    """A byte flipped inside a tensor file (``torch.load`` alone would read
    it): the whole-tree load refuses the step before reading any tensor."""
    ck = TensorCheckpointer(str(tmp_path))
    ck.save(2, {"params": PARAMS})
    ck.commit(2)
    src = ck.params_ref(2)
    tensors = os.path.join(tmp_path, "2", "tensors")
    path = os.path.join(tensors, max(os.listdir(tensors), key=lambda f: os.path.getsize(os.path.join(tensors, f))))
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(CheckpointCorrupt):
        src.whole(CFG, "cpu")
    assert isinstance(src, CheckpointParams)
