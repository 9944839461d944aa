"""The port's MoE on a training mesh (``tpu_nexus_torch/models/moe.py``:
``_moe_ffn_mesh``, the expert-parallel gmm path over kernels #7/#8, the
scatter under ``ep``) against the JAX package, case for case with
``tests/test_moe.py``'s mesh tests; and MNIST on a data mesh.

Ranks are spawned gloo processes on the CPU, one world of 4 for the module
(``workload/rehearsal.py::RankWorld``); the JAX side runs on the virtual
8-device CPU mesh as its own tests run it (its gmm on the CPU as there).
f32, numpy inputs from a seed, 1e-5 × max|ref|.

* ``_moe_ffn_gmm_ep``: output, aux and the gradients of the tokens and of
  every leaf of the layer for ``sum(out ** 2)`` at ``ep 2 × tp 2`` and
  ``fsdp 2 × ep 2``, and at ``fsdp 2`` with ``NEXUS_MOE_FORCE_EP_PATH``.
* The budget's overflow under adversarial routing: the drop fraction equal
  to the reference's, finite gradients, the load balance seeing the skew.
* One train step from a carried first step at ``ep 2``, ``ep 2 × tp 2``,
  ``fsdp 2 × ep 2`` (gmm) and ``ep 2 × sp 2`` (scatter, the ring): loss,
  grad norm and every parameter within 1e-5 × max|ref| of the JAX
  package's ``make_train_step``; gmm against scatter in one step.
* Indivisible experts and ``sort`` under ep refused in the reference's
  words; an MoE run through the harness on ``fsdp 2 × ep 2``.
* MNIST on ``dp 2`` and ``fsdp 2`` against one device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel_train import _close, _flat, _moments
from tpu_nexus.models import moe as jax_moe
from tpu_nexus.parallel import LOGICAL_RULES_FSDP_TP, MeshSpec, build_mesh
from tpu_nexus.workload import train as jax_train
from tpu_nexus_torch.models import moe as port_moe
from tpu_nexus_torch.models.mnist import MnistConfig
from tpu_nexus_torch.workload import train as port_train
from tpu_nexus_torch.workload.rehearsal import RankWorld

KW = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, intermediate=96,
          n_experts=4, experts_per_token=2, max_seq_len=64, remat=False)
TRAIN = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4, ce_chunk=16)
BATCHES = [np.random.default_rng(s).integers(0, 256, (4, 32)).astype(np.int32) for s in (21, 22)]


def _cfgs(**kw):
    return (jax_moe.MoeConfig(dtype=jnp.float32, param_dtype=jnp.float32, **{**KW, **kw}),
            port_moe.MoeConfig(dtype=torch.float32, param_dtype=torch.float32, **{**KW, **kw}))


def _jmesh(spec):
    n = int(np.prod(list(spec.values())))
    return build_mesh(MeshSpec(**{"fsdp": 1, **spec}), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def world():
    with RankWorld(4, timeout_s=120) as w:
        yield w


def _layer0(params):
    return {k: np.asarray(params["layers"][k][0]) for k in ("router", "w_gate", "w_up", "w_down")}


def _jax_ffn(jcfg, spec, x, layer):
    mesh = _jmesh(spec)

    def f(x, layer):
        out, aux = jax_moe._moe_ffn_gmm_ep(x, layer, jcfg, mesh)
        return jnp.sum(out**2), (out, aux)

    with mesh:
        (_, (out, aux)), (dx, dl) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    return {"out": np.asarray(out), "aux": {k: float(v) for k, v in aux.items()}, "dx": np.asarray(dx),
            "grads": {k: np.asarray(v) for k, v in dl.items()}}


def _within(a, b, what):
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    assert err <= 1e-5 * float(np.abs(b).max()), (what, err, float(np.abs(b).max()))


@pytest.mark.parametrize("spec,force", [({"ep": 2, "tp": 2}, False), ({"fsdp": 2, "ep": 2}, False),
                                        ({"fsdp": 2}, True)], ids=["ep2xtp2", "fsdp2xep2", "fsdp2-forced"])
def test_gmm_ep_matches_jax_fwd_and_grads(world, spec, force):
    jcfg, pcfg = _cfgs(dispatch="gmm")
    layer = _layer0(jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)))
    x = np.random.default_rng(1).standard_normal((4, 32, KW["hidden"])).astype(np.float32)
    ref = _jax_ffn(jcfg, spec, x, layer)
    got = world.run("tpu_nexus_torch.workload.rehearsal:moe_ffn_grads", spec=spec, cfg=pcfg, x=x, layer=layer,
                    force_ep=force)[0]
    assert got["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"] == 0.0
    for k in ("load_balance", "router_z"):
        assert abs(got["aux"][k] - ref["aux"][k]) <= 1e-5 * abs(ref["aux"][k]), k
    _within(got["out"], ref["out"], "out")
    _within(got["dx"], ref["dx"], "dx")
    for name in layer:
        _within(got["grads"][name], ref["grads"][name], name)


def test_gmm_ep_budget_overflow_reports_the_reference_drops(world):
    """Every token routed to experts {0, 1} (ep shard 0) under a squeezed
    budget: the same drop fraction as the reference, finite gradients, the
    load balance seeing the skew."""
    jcfg, pcfg = _cfgs(dispatch="gmm", ep_row_factor=0.25)
    layer = _layer0(jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)))
    router = np.zeros_like(layer["router"])
    router[:, 0], router[:, 1] = 1.0, 0.5
    layer["router"] = router
    x = (np.abs(np.random.default_rng(1).standard_normal((8, 256, KW["hidden"]))) + 0.1).astype(np.float32)
    spec = {"fsdp": 2, "ep": 2}
    ref = _jax_ffn(jcfg, spec, x, layer)
    got = world.run("tpu_nexus_torch.workload.rehearsal:moe_ffn_grads", spec=spec, cfg=pcfg, x=x, layer=layer)[0]
    assert 0.3 < got["aux"]["dropped_frac"] < 1.0
    assert abs(got["aux"]["dropped_frac"] - ref["aux"]["dropped_frac"]) <= 1e-6
    assert got["aux"]["load_balance"] > 1.5
    assert np.isfinite(got["out"]).all() and np.isfinite(got["dx"]).all()
    assert all(np.isfinite(g).all() for g in got["grads"].values())
    _within(got["out"], ref["out"], "out")


def _jax_steps(jcfg, spec, attn):
    mesh = _jmesh(spec)
    tc = jax_train.TrainConfig(**TRAIN, sp_attn=attn)
    state = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, tc, mesh, LOGICAL_RULES_FSDP_TP)
    step = jax_train.make_train_step(jcfg, tc, mesh, LOGICAL_RULES_FSDP_TP)
    with mesh:
        state, _ = step(state, jnp.asarray(BATCHES[0]))
        params = jax.tree.map(np.asarray, state["params"])
        start = (params, _moments(jax.tree.map(np.asarray, state["opt_state"]), "adamw", params))
        state, m = step(state, jnp.asarray(BATCHES[1]))
    return start, (float(m["loss"]), float(m["grad_norm"]), _flat(jax.tree.map(np.asarray, state["params"])))


def _port_step(world, pcfg, spec, attn, start):
    tc = port_train.TrainConfig(**TRAIN, sp_attn=attn)
    got = world.run("tpu_nexus_torch.workload.rehearsal:train_steps", spec=spec, model=pcfg, train_cfg=tc,
                    batches=[BATCHES[1]], params=start[0], opt_state=start[1])[0]
    return got["loss"][0], got["grad_norm"][0], got["params"]


STEP_CASES = [({"ep": 2}, "gmm"), ({"ep": 2, "tp": 2}, "gmm"), ({"fsdp": 2, "ep": 2}, "gmm"),
              ({"ep": 2, "sp": 2}, "scatter")]


@pytest.mark.parametrize("spec,dispatch", STEP_CASES, ids=["ep2-gmm", "ep2xtp2-gmm", "fsdp2xep2-gmm",
                                                           "ep2xsp2-scatter-ring"])
def test_moe_train_step_matches_jax_on_the_mesh(world, spec, dispatch):
    jcfg, pcfg = _cfgs(dispatch=dispatch)
    start, ref = _jax_steps(jcfg, spec, "ring")
    _close(_port_step(world, pcfg, spec, "ring", start), ref, ("jax", spec, dispatch))


def test_gmm_ep_grad_parity_vs_scatter_in_train_step(world):
    """fsdp 2 × ep 2: gmm matches scatter at an ample capacity (nothing
    dropped), as the reference's test holds its own."""
    metrics = {}
    for dispatch in ("scatter", "gmm"):
        _, pcfg = _cfgs(dispatch=dispatch, capacity_factor=float(KW["n_experts"]))
        tc = port_train.TrainConfig(warmup_steps=2, total_steps=50, learning_rate=1e-2)
        got = world.run("tpu_nexus_torch.workload.rehearsal:train_steps", spec={"fsdp": 2, "ep": 2}, model=pcfg,
                        train_cfg=tc, batches=[BATCHES[0]])[0]
        metrics[dispatch] = got
    assert abs(metrics["scatter"]["loss"][0] - metrics["gmm"]["loss"][0]) < 1e-4
    assert abs(metrics["scatter"]["grad_norm"][0] - metrics["gmm"]["grad_norm"][0]) < 1e-4


class _Mesh:
    def __init__(self, **sizes):
        self.sizes = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1, **sizes}
        self.world = int(np.prod(list(self.sizes.values())))

    def size(self, *axes):
        return int(np.prod([self.sizes[a] for a in axes]))

    def describe(self):
        return {a: s for a, s in self.sizes.items() if s > 1}


@pytest.mark.parametrize("case", ["indivisible", "sort"])
def test_ep_refusals_in_the_reference_words(case):
    from tpu_nexus.models.registry import adapter_for as jax_adapter
    from tpu_nexus_torch.models.registry import adapter_for

    kw = dict(n_experts=6, dispatch="gmm") if case == "indivisible" else dict(dispatch="sort")
    spec = dict(fsdp=2, ep=4) if case == "indivisible" else dict(fsdp=2, ep=2, tp=2)
    with pytest.raises(ValueError) as want:
        jax_adapter(dataclasses.replace(jax_moe.MoeConfig.tiny(), **kw)).make_loss(
            jax_train.TrainConfig(), build_mesh(MeshSpec(**spec), devices=jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        adapter_for(dataclasses.replace(port_moe.MoeConfig.tiny(), **kw)).make_loss(port_train.TrainConfig(),
                                                                                    _Mesh(**spec))
    assert str(got.value) == str(want.value)


def test_moe_through_the_harness_on_an_ep_mesh(world, tmp_path):
    """The MoE family runs the harness's ledger contract on fsdp 2 × ep 2
    (four ranks on the CPU, the rehearsal map): COMPLETED at the last step,
    the loss going down; its save (the experts gathered over ep) restores
    onto ep 2 and onto one device, leaf for leaf equal."""
    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.registry import get_adapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.parallel.mesh import MeshSpec as PortMeshSpec
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

    class _Losses(NullMetrics):
        def __init__(self):
            self.losses = []

        def gauge(self, name, value, tags=None):
            if name == "train.loss":
                self.losses.append(value)

    store = InMemoryCheckpointStore()
    store.upsert_checkpoint(CheckpointedRequest(algorithm="moe-ep", id="r1",
                                                lifecycle_stage=LifecycleStage.BUFFERED))
    telemetry = _Losses()
    result = run_workload(
        WorkloadConfig(model=get_adapter("moe_tiny"), train=port_train.TrainConfig(warmup_steps=2, total_steps=50,
                                                                                   learning_rate=1e-2),
                       mesh=PortMeshSpec(fsdp=2, ep=2), rank_map="shared", batch_size=4, seq_len=32, steps=6,
                       heartbeat_every=1, device="cpu", checkpoint_every=6, checkpoint_dir=str(tmp_path)),
        store=store, ctx=ProcessContext(run_id="r1", algorithm="moe-ep", process_id=0, num_processes=1,
                                        coordinator=None),
        lifecycle=LifecycleContext(), telemetry=telemetry)
    assert result["final_step"] == 6
    assert store.read_checkpoint("moe-ep", "r1").lifecycle_stage == LifecycleStage.COMPLETED
    assert result["load_balance"] > 0.0
    assert result["loss"] < telemetry.losses[0]
    got = world.run("tpu_nexus_torch.workload.rehearsal:restore_on_mesh", directory=str(tmp_path), step=6,
                    spec={"ep": 2}, model=get_adapter("moe_tiny"), train_cfg=port_train.TrainConfig())[0]
    assert got["leaves"] > 20 and got["differ"] == [] and got["mesh"] == {"ep": 2}


@pytest.mark.parametrize("spec", [{"dp": 2}, {"fsdp": 2}], ids=["dp2", "fsdp2"])
def test_mnist_on_a_data_mesh_matches_one_device(world, spec):
    """Three steps: every loss and grad norm, and the first step's gradient
    of every leaf (Adam's first moment: an update's rounding is not
    comparable), within 1e-5 of one device's."""
    cfg = MnistConfig(hidden=64, dtype=torch.float32)
    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((8, 784)).astype(np.float32), "y": rng.integers(0, 10, 8).astype(np.int32)}
               for _ in range(3)]
    tc = port_train.TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=4)
    job = "tpu_nexus_torch.workload.rehearsal:train_steps"
    one = world.run(job, spec={}, model=cfg, train_cfg=tc, batches=batches, reference="keep")[0]
    got = world.run(job, spec=spec, model=cfg, train_cfg=tc, batches=batches, reference="compare")[0]
    for a, b in zip(got["loss"] + got["grad_norm"], one["loss"] + one["grad_norm"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert len(got["first_moments"]) == 6
    for path, (err, scale) in got["first_moments"].items():
        assert err <= 1e-5 * scale, (path, err, scale)
