"""The port's pipeline parallelism (``tpu_nexus_torch/parallel/pipeline.py``)
against the JAX package's (``tpu_nexus/parallel/pipeline.py``), case for
case with ``tests/test_pipeline.py``.

Ranks are spawned gloo processes on the CPU, one world of 4 for the module
(``workload/rehearsal.py::RankWorld``); the JAX side runs on the virtual
8-device CPU mesh as its own tests run it.  f32 throughout, numpy inputs
from a seed; outputs and gradients within 1e-5 × max|ref|.

* ``pipeline_apply`` in one process (the stages one after another) against
  the JAX package's on the same stack, forward and gradients, the tuple
  carry, the divisibility errors and ``auto_microbatches`` in its words;
  and over 2 and 4 ranks of ``pp`` (GPipe with hand-offs) against it.
* ``llama_hidden_pp`` against the JAX package's, with and without remat.
* One train step from a carried first step (the JAX package's state after
  a first step on its pp mesh: parameters and Adam's moments) at ``pp 2``,
  ``pp 2 × fsdp 2``, ``pp 2 × tp 2`` and ``pp 2 × sp 2`` Ulysses for the
  dense family and at ``pp 2``, ``pp 2 × fsdp 2`` and ``pp 2 × tp 2`` for
  MoE (scatter, its capacity and aux per microbatch): loss, grad
  norm and every parameter after the update within 1e-5 × max|ref| of the
  JAX package's ``make_train_step`` on the same mesh.
* The stage-sharded state, the explicit microbatches that must cover the
  data-parallel extent, ring under pp and MoE under pp without scatter
  refused, each in the reference's words.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel_train import _close, _flat, _moments
from tpu_nexus.models import llama as jax_llama
from tpu_nexus.models import moe as jax_moe
from tpu_nexus.parallel import LOGICAL_RULES_FSDP_TP_PP, MeshSpec, build_mesh
from tpu_nexus.parallel import pipeline as jax_pipeline
from tpu_nexus.workload import train as jax_train
from tpu_nexus_torch.models import llama as port_llama
from tpu_nexus_torch.models import moe as port_moe
from tpu_nexus_torch.models.convert import params_from_numpy
from tpu_nexus_torch.parallel import pipeline as port_pipeline
from tpu_nexus_torch.parallel.sharding import LOGICAL_RULES_FSDP_TP
from tpu_nexus_torch.parallel.sharding import LOGICAL_RULES_FSDP_TP_PP as PORT_RULES_FSDP_TP_PP
from tpu_nexus_torch.workload import train as port_train
from tpu_nexus_torch.workload.rehearsal import RankWorld

KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=128,
          max_seq_len=64, remat=False, tied_embeddings=True)
MOE_KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=96,
              n_experts=4, experts_per_token=2, max_seq_len=64, remat=False)
TRAIN = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4, ce_chunk=16)
BATCHES = [np.random.default_rng(s).integers(0, 256, (8, 32)).astype(np.int32) for s in (11, 12)]


@pytest.fixture(scope="module")
def world():
    with RankWorld(4, timeout_s=120) as w:
        yield w


def _stack(seed, n_layers=8, dim=16, batch=8):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((n_layers, dim, dim)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((n_layers, dim)) * 0.1).astype(np.float32)
    x = rng.standard_normal((batch, dim)).astype(np.float32)
    g = rng.standard_normal((batch, dim)).astype(np.float32)
    return ws, bs, x, g


def _jax_stack(ws, bs, x, g, n_stages, microbatches):
    def layer_fn(c, layer):
        return jnp.tanh(c @ layer["w"] + layer["b"])

    def loss(layers, x):
        out = jax_pipeline.pipeline_apply(layer_fn, layers, x, n_stages=n_stages, microbatches=microbatches)
        return jnp.sum(out * g), out

    (_, out), (dl, dx) = jax.value_and_grad(loss, (0, 1), has_aux=True)({"w": ws, "b": bs}, x)
    return {"out": np.asarray(out), "dx": np.asarray(dx), "dw": np.asarray(dl["w"]), "db": np.asarray(dl["b"])}


def _within(got, ref, names, what=""):
    for name in names:
        err = float(np.abs(np.asarray(got[name]) - np.asarray(ref[name])).max())
        assert err <= 1e-5 * float(np.abs(ref[name]).max()), (what, name, err)


# -- pipeline_apply ---------------------------------------------------------------


@pytest.mark.parametrize("n_stages,microbatches", [(2, 4), (4, 8), (2, 2), (8, 8), (1, 2)])
def test_pipeline_apply_matches_jax_in_one_process(n_stages, microbatches):
    ws, bs, x, g = _stack(0)
    layers = {"w": torch.from_numpy(ws).requires_grad_(), "b": torch.from_numpy(bs).requires_grad_()}
    xt = torch.from_numpy(x).requires_grad_()
    out = port_pipeline.pipeline_apply(lambda c, layer: torch.tanh(c @ layer["w"] + layer["b"]), layers, xt,
                                       n_stages=n_stages, microbatches=microbatches)
    (out * torch.from_numpy(g)).sum().backward()
    got = {"out": out.detach().numpy(), "dx": xt.grad.numpy(), "dw": layers["w"].grad.numpy(),
           "db": layers["b"].grad.numpy()}
    _within(got, _jax_stack(ws, bs, x, g, n_stages, microbatches), ("out", "dx", "dw", "db"))


@pytest.mark.parametrize("pp,microbatches", [(2, 4), (4, 8), (2, 1)])
def test_pipeline_over_ranks_matches_jax(world, pp, microbatches):
    """GPipe over ``pp`` ranks: forward, and the reverse hand-offs' gradients."""
    ws, bs, x, g = _stack(1)
    got = world.run("tpu_nexus_torch.workload.rehearsal:pipeline_stack", spec={"pp": pp}, ws=ws, bs=bs, x=x, g=g,
                    microbatches=microbatches)[pp - 1]
    _within(got, _jax_stack(ws, bs, x, g, pp, microbatches), ("out", "dx", "dw", "db"))


def test_tuple_carry_rides_the_pipeline():
    """An auxiliary leaf rides each microbatch through the stages."""
    layers = {"w": torch.stack([torch.eye(4) * (i + 1) for i in range(4)])}
    x = torch.ones((4, 4))
    aux = torch.arange(4, dtype=torch.float32)[:, None] * torch.ones((4, 4))

    def layer_fn(carry, layer):
        x, aux = carry
        return x @ layer["w"] + aux, aux

    out, aux_out = port_pipeline.pipeline_apply(layer_fn, layers, (x, aux), n_stages=2, microbatches=4)
    jl = {"w": jnp.stack([jnp.eye(4) * (i + 1) for i in range(4)])}
    ref, ref_aux = jax_pipeline.pipeline_apply(
        lambda c, layer: (c[0] @ layer["w"] + c[1], c[1]), jl, (jnp.ones((4, 4)), jnp.asarray(aux.numpy())),
        n_stages=2, microbatches=4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(aux_out.numpy(), aux.numpy())
    np.testing.assert_array_equal(np.asarray(ref_aux), aux.numpy())


@pytest.mark.parametrize("n_layers,microbatches", [(3, 2), (4, 3)])
def test_divisibility_errors_in_the_reference_words(n_layers, microbatches):
    with pytest.raises(ValueError) as got:
        port_pipeline.pipeline_apply(lambda c, layer: c, {"w": torch.zeros((n_layers, 4, 4))}, torch.zeros((4, 4)),
                                     n_stages=2, microbatches=microbatches)
    with pytest.raises(ValueError) as want:
        jax_pipeline.pipeline_apply(lambda c, layer: c, {"w": jnp.zeros((n_layers, 4, 4))}, jnp.zeros((4, 4)),
                                    n_stages=2, microbatches=microbatches)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch,stages,least", [(16, 2, 1), (8, 2, 1), (4, 2, 1), (2, 2, 1), (16, 2, 4),
                                                 (3, 2, 1), (8, 2, 8)])
def test_auto_microbatches_as_the_reference(batch, stages, least):
    try:
        want = jax_pipeline.auto_microbatches(batch, stages, least)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_pipeline.auto_microbatches(batch, stages, least)
        assert str(got.value) == str(exc)
        return
    assert port_pipeline.auto_microbatches(batch, stages, least) == want


def test_microbatch_rows_are_the_reference_microbatches():
    """Data rank r holds block r of every microbatch, microbatch-major."""
    rows = [port_pipeline.microbatch_rows(16, 2, r, 4) for r in range(2)]
    assert rows[0].tolist() == [0, 1, 4, 5, 8, 9, 12, 13]
    assert rows[1].tolist() == [2, 3, 6, 7, 10, 11, 14, 15]


# -- the dense family -------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_llama_hidden_pp_matches_jax(remat):
    kw = dict(KW, remat=remat)
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, remat_policy="nothing", **kw)
    pcfg = port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, remat_policy="nothing", **kw)
    jparams = jax_llama.llama_init(jax.random.PRNGKey(0), jcfg)
    tokens = BATCHES[0][:4]
    ref = np.asarray(jax_llama.llama_hidden_pp(jparams, jnp.asarray(tokens), jcfg, n_stages=2, microbatches=4))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")
    with torch.enable_grad():
        got = port_llama.llama_hidden_pp(params, torch.from_numpy(tokens).long(), pcfg, n_stages=2, microbatches=4)
    assert float(np.abs(got.detach().numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def _jax_pp_steps(cfg, spec, attn, rules=LOGICAL_RULES_FSDP_TP_PP):
    """Two JAX steps on the pp mesh: the state after the first (what the
    port starts from) and the second step's loss, grad norm and parameters."""
    n = int(np.prod(list(spec.values())))
    mesh = build_mesh(MeshSpec(**{"fsdp": 1, **spec}), devices=jax.devices()[:n])
    tc = jax_train.TrainConfig(**TRAIN, sp_attn=attn)
    state = jax_train.init_train_state(jax.random.PRNGKey(0), cfg, tc, mesh, rules)
    step = jax_train.make_train_step(cfg, tc, mesh, rules)
    with mesh:
        state, _ = step(state, jnp.asarray(BATCHES[0]))
        params = jax.tree.map(np.asarray, state["params"])
        start = (params, _moments(jax.tree.map(np.asarray, state["opt_state"]), "adamw", params))
        state, m = step(state, jnp.asarray(BATCHES[1]))
    return start, (float(m["loss"]), float(m["grad_norm"]), _flat(jax.tree.map(np.asarray, state["params"])))


def _port_step(world, cfg, spec, attn, start, microbatches=0):
    tc = port_train.TrainConfig(**TRAIN, sp_attn=attn, pp_microbatches=microbatches)
    got = world.run("tpu_nexus_torch.workload.rehearsal:train_steps", spec=spec, model=cfg, train_cfg=tc,
                    batches=[BATCHES[1]], params=start[0], opt_state=start[1])[0]
    return got["loss"][0], got["grad_norm"][0], got["params"]


LLAMA_MESHES = [({"pp": 2}, "ring"), ({"pp": 2, "fsdp": 2}, "ring"), ({"pp": 2, "tp": 2}, "ring"),
                ({"pp": 2, "sp": 2}, "ulysses")]


@pytest.mark.parametrize("spec,attn", LLAMA_MESHES, ids=["pp2", "pp2xfsdp2", "pp2xtp2", "pp2xsp2-ulysses"])
def test_pp_train_step_matches_jax(world, spec, attn):
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **KW)
    pcfg = port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **KW)
    start, ref = _jax_pp_steps(jcfg, spec, attn)
    _close(_port_step(world, pcfg, spec, attn, start), ref, ("jax", spec))


def test_moe_pp_train_step_matches_jax(world):
    """Scatter under pp: each microbatch's capacity and aux losses are its
    own in both packages (the tiny config drops assignments)."""
    jcfg = jax_moe.MoeConfig(dtype=jnp.float32, param_dtype=jnp.float32, **MOE_KW)
    pcfg = port_moe.MoeConfig(dtype=torch.float32, param_dtype=torch.float32, **MOE_KW)
    start, ref = _jax_pp_steps(jcfg, {"pp": 2}, "ring")
    _close(_port_step(world, pcfg, {"pp": 2}, "ring", start), ref, ("jax", "pp2"))


@pytest.mark.parametrize("spec", [{"pp": 2, "fsdp": 2}, {"pp": 2, "tp": 2}], ids=["pp2xfsdp2", "pp2xtp2"])
def test_moe_pp_mesh_train_step_matches_jax(world, spec):
    """Scatter under pp on a data or a tensor axis, against the JAX
    package's step on the same mesh.  pp 2 × fsdp 2 (auto: 4 microbatches
    of 2 rows, each split over the two data ranks) gathers the routing over
    the data axes inside the pipeline, so the capacity is still the
    microbatch's; pp 2 × tp 2 computes each expert's mlp slice and sums the
    combine over the (ep, tp) region."""
    jcfg = jax_moe.MoeConfig(dtype=jnp.float32, param_dtype=jnp.float32, **MOE_KW)
    pcfg = port_moe.MoeConfig(dtype=torch.float32, param_dtype=torch.float32, **MOE_KW)
    start, ref = _jax_pp_steps(jcfg, spec, "ring")
    _close(_port_step(world, pcfg, spec, "ring", start), ref, ("jax", spec))


# -- the state and the refusals ----------------------------------------------------


class _Mesh:
    """A mesh that answers the layout's and the refusals' questions."""

    def __init__(self, coords=None, **sizes):
        self.sizes = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1, **sizes}
        self.coords = {a: 0 for a in self.sizes} | (coords or {})
        self.world = int(np.prod(list(self.sizes.values())))
        self.stage = self.coords["pp"]

    def size(self, *axes):
        return int(np.prod([self.sizes[a] for a in axes]))

    def describe(self):
        return {a: s for a, s in self.sizes.items() if s > 1}


def test_pp_state_is_stage_sharded():
    """Under the pp rules each layer leaf's first dim is cut over pp: the
    second stage's shard is the one-device init's second half."""
    pcfg = port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **KW)
    mesh = _Mesh(coords={"pp": 1, "fsdp": 1}, pp=2, fsdp=2, tp=2)
    layout = port_train.Layout(mesh, port_llama.llama_axes(pcfg), port_train.default_rules(2))
    assert layout.specs["layers/wq"][0] == "pp" and layout.specs["embed/tokens"][0] != "pp"
    whole = port_llama.llama_init(torch.Generator().manual_seed(0), pcfg, device="cpu")["layers"]["wq"].detach()
    part = layout.cut(whole, layout.specs["layers/wq"])
    assert torch.equal(part, whole[1:, 32:, :2])
    jmesh = build_mesh(MeshSpec(pp=2, fsdp=2, tp=2), devices=jax.devices()[:8])
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **KW)
    tc = jax_train.TrainConfig(**TRAIN)
    state = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, tc, jmesh, LOGICAL_RULES_FSDP_TP_PP)
    assert state["params"]["layers"]["wq"].sharding.spec[0] == "pp"


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_explicit_microbatches_must_cover_the_dp_extent(family):
    """Microbatch size 1 under fsdp 4: both families refuse, in the
    reference's words (the rank holds 2 of the 8 rows)."""
    tokens = BATCHES[0]
    jmesh = build_mesh(MeshSpec(pp=2, fsdp=4), devices=jax.devices()[:8])
    if family == "llama":
        jcfg, pcfg = jax_llama.LlamaConfig.tiny(), port_llama.LlamaConfig.tiny()
        jfn, pfn, init = jax_llama.llama_hidden_pp, port_llama.llama_hidden_pp, jax_llama.llama_init
    else:
        jcfg, pcfg = jax_moe.MoeConfig.tiny(), port_moe.MoeConfig.tiny()
        jfn, pfn, init = jax_moe.moe_hidden_pp, port_moe.moe_hidden_pp, jax_moe.moe_init
    with pytest.raises(ValueError) as want:
        jfn(init(jax.random.PRNGKey(0), jcfg), jnp.asarray(tokens), jcfg, n_stages=2, microbatches=8, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        pfn({}, torch.from_numpy(tokens[:2]).long(), pcfg, n_stages=2, microbatches=8, mesh=_Mesh(pp=2, fsdp=4))
    assert str(got.value) == str(want.value)


def test_ring_under_pp_is_refused_in_the_reference_words():
    from tpu_nexus.models.registry import LlamaAdapter as JaxLlama
    from tpu_nexus_torch.models.registry import LlamaAdapter

    with pytest.raises(ValueError) as want:
        JaxLlama(config=jax_llama.LlamaConfig.tiny()).make_loss(
            jax_train.TrainConfig(), build_mesh(MeshSpec(pp=2, sp=2, fsdp=2), devices=jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        LlamaAdapter(config=port_llama.LlamaConfig.tiny()).make_loss(port_train.TrainConfig(),
                                                                     _Mesh(pp=2, sp=2, fsdp=2))
    assert str(got.value) == str(want.value)


def test_moe_pp_requires_scatter_in_the_reference_words():
    from tpu_nexus.models.registry import MoeAdapter as JaxMoe
    from tpu_nexus_torch.models.registry import MoeAdapter

    with pytest.raises(ValueError) as want:
        JaxMoe(config=dataclasses.replace(jax_moe.MoeConfig.tiny(), dispatch="gmm")).make_loss(
            jax_train.TrainConfig(), build_mesh(MeshSpec(pp=2, fsdp=4), devices=jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        MoeAdapter(config=dataclasses.replace(port_moe.MoeConfig.tiny(), dispatch="gmm")).make_loss(
            port_train.TrainConfig(), _Mesh(pp=2, fsdp=4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="dispatch='scatter'"):
        port_moe.moe_hidden_pp({}, torch.zeros((2, 8), dtype=torch.long),
                               dataclasses.replace(port_moe.MoeConfig.tiny(), dispatch="gmm"), n_stages=2)


def test_default_rules_cut_the_layers_over_pp_only_on_a_pp_mesh():
    """One place decides it, for the harness and the train state alike: a
    table that leaves the layer stacks replicated is upgraded on a pp mesh,
    a table that places them is kept."""
    assert port_train.default_rules(2)["layers"] == "pp"
    assert port_train.default_rules(1) is LOGICAL_RULES_FSDP_TP
    assert port_train.default_rules(2, LOGICAL_RULES_FSDP_TP) == PORT_RULES_FSDP_TP_PP
    placed = {**LOGICAL_RULES_FSDP_TP, "layers": "fsdp"}
    assert port_train.default_rules(2, placed) is placed
    assert port_train.train_layout(port_llama.LlamaConfig.tiny(), _Mesh(pp=2)).specs["layers/wq"][0] == "pp"


@pytest.mark.parametrize("n_stages,used,raises", [(1, ("layers.router", "out_norm"), True),
                                                  (2, ("layers.router", "out_norm"), False),
                                                  (2, ("embed.tokens", "out_norm"), True)],
                         ids=["embed-unused-off-pp", "embed-unused-on-a-stage", "layer-leaf-unused-on-a-stage"])
def test_only_a_stage_takes_zeros_for_a_leaf_it_does_not_use(n_stages, used, raises):
    """``make_train_step``'s gradients: off the pipeline any unused leaf
    raises (a wiring fault, e.g. a router cut off the graph); on a pipeline
    stage a leaf outside the layer stacks gets zeros, a layer leaf raises."""
    named = [(name, torch.full((3,), 1.0 + i, requires_grad=True))
             for i, name in enumerate(("embed.tokens", "layers.router", "out_norm"))]
    leaves = dict(named)
    loss = (leaves[used[0]] * leaves[used[1]]).sum()
    if raises:
        with pytest.raises(RuntimeError, match="not have been used"):
            port_train.leaf_grads(loss, named, n_stages)
        return
    grads = port_train.leaf_grads(loss, named, n_stages)
    assert torch.equal(grads[0], torch.zeros(3))
    assert torch.equal(grads[1], leaves["out_norm"].detach()) and torch.equal(grads[2], leaves["layers.router"].detach())


@pytest.mark.parametrize("saved_on", ["pp2", "one device"])
def test_checkpoints_cross_between_pp_and_one_device(world, tmp_path, saved_on):
    """A run saved on pp 2 (each stage's layers gathered into the
    one-device layout) or on one device restores onto pp 2 × fsdp 2 and onto
    one device, leaf for leaf equal."""
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.parallel.mesh import MeshSpec as PortMeshSpec
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

    pcfg = port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **KW)
    tc = port_train.TrainConfig(**TRAIN)
    mesh = PortMeshSpec(pp=2, fsdp=1) if saved_on == "pp2" else PortMeshSpec(fsdp=1)
    summary = run_workload(
        WorkloadConfig(model=pcfg, train=tc, mesh=mesh, rank_map="shared", batch_size=4, seq_len=32, steps=2,
                       checkpoint_every=2, checkpoint_dir=str(tmp_path), device="cpu", goodput=False),
        store=InMemoryCheckpointStore(), ctx=ProcessContext("ckpt", "a", 0, 1, None), lifecycle=LifecycleContext(),
        telemetry=NullMetrics())
    assert summary["final_step"] == 2
    got = world.run("tpu_nexus_torch.workload.rehearsal:restore_on_mesh", directory=str(tmp_path), step=2,
                    spec={"pp": 2, "fsdp": 2}, model=pcfg, train_cfg=tc)[0]
    assert got["leaves"] > 20 and got["differ"] == [] and got["mesh"] == {"pp": 2, "fsdp": 2}
