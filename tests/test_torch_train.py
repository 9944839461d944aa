"""The port's training step against the JAX package and optax.

* The three optimizers against optax over 5 steps (warmup, then cosine
  decay, one clipped step), on an f32 and a bf16 parameter tree.
  Tolerances: adamw and adafactor on f32 trees 1e-6 max-abs (f32 rounding
  of the same op sequence); adamw on a bf16 tree bit-exact (every op
  rounds to bf16 in both, JAX's weak-typed scalars mirrored).  Where
  moments or updates are rounded to bf16 between f32 ops (adamw-bf16
  anywhere, adafactor on bf16), an f32 ulp of difference can flip a bf16
  rounding, and XLA may skip intermediate roundings (excess precision):
  there at most 2% of the elements may differ from optax by more than one
  bf16 ulp of the larger of |p| and the step's learning rate, and the mean
  difference stays under 1% of the mean distance the parameters moved.
* The warmup-cosine schedule against optax's, counts 0..15.
* ``chunked_next_token_loss`` value and gradients against JAX's (f32,
  1e-5), and ``next_token_loss``.
* ``sentinel_update``/``gate_update`` against JAX's over a NaN and a spike
  sequence: identical flags and EMA state (f32, 1e-6).
* ``make_train_step`` against JAX's on a one-device CPU mesh, for ``tiny``
  and a head_dim-128 config, with weights carried across by
  ``models/convert.py``: 3 f32 steps, losses and grad norms within 1e-5
  relative, every parameter within 1e-4 max-abs of JAX's (Adam's update
  g/|g| turns 1e-7 relative gradient noise into up to that much on
  near-zero gradient elements at learning rate 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.parallel import LOGICAL_RULES_FSDP_TP, MeshSpec, build_mesh
from tpu_nexus.workload import health as jax_health
from tpu_nexus.workload import train as jax_train
from tpu_nexus_torch.models import llama as port_llama
from tpu_nexus_torch.models.convert import params_from_numpy, params_to_numpy
from tpu_nexus_torch.workload import health as port_health
from tpu_nexus_torch.workload import train as port_train

torch.set_num_threads(1)
SHAPES = {"a": (4, 200, 130), "b": (300,), "c": (16, 256)}


def _opt_run(optimizer, dtype):
    """(optax params, port params, initial params) after 5 updates from the
    same gradients, as f32 numpy."""
    rng = np.random.default_rng(0)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6, optimizer=optimizer)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in init.items()}
    tp = [torch.tensor(init[k]).to(tdt) for k in sorted(SHAPES)]  # a copy: updated in place
    jopt = jax_train.make_optimizer(jax_train.TrainConfig(**kw))
    jstate = jopt.init(jp)
    popt = port_train.make_optimizer(port_train.TrainConfig(**kw))
    pstate = popt.init(tp)
    for step in range(5):
        scale = 10.0 if step == 3 else 0.01  # step 3's global norm is clipped
        g = {k: rng.standard_normal(s).astype(np.float32) * scale for k, s in SHAPES.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v, jdt) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        popt.update([torch.from_numpy(g[k]).to(tdt) for k in sorted(SHAPES)], tp, pstate)
    assert int(pstate["count"]) == 5
    flat = lambda xs: np.concatenate([np.asarray(x, np.float32).ravel() for x in xs])  # noqa: E731
    return (
        flat([jp[k] for k in sorted(SHAPES)]),
        flat([t.float().numpy() for t in tp]),
        flat([np.asarray(jnp.asarray(init[k], jdt), np.float32) for k in sorted(SHAPES)]),
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("optimizer", port_train.OPTIMIZERS)
def test_optimizers_match_optax(optimizer, dtype):
    ref, got, init = _opt_run(optimizer, dtype)
    diff = np.abs(ref - got)
    if optimizer == "adamw" and dtype == "bf16":
        assert diff.max() == 0.0
    elif optimizer in ("adamw", "adafactor") and dtype == "f32":
        assert diff.max() <= 1e-6
    else:
        ulp = np.maximum(np.abs(ref), 1e-2) * 2.0**-8
        assert (diff > ulp).mean() <= 0.02
        assert diff.mean() <= 0.01 * np.abs(ref - init).mean()


def test_optimizer_state_dtypes_follow_optax():
    params = [torch.zeros(130, 200, dtype=torch.bfloat16), torch.zeros(300)]
    adamw = port_train.make_optimizer(port_train.TrainConfig(optimizer="adamw")).init(params)
    assert [leaf["mu"].dtype for leaf in adamw["leaves"]] == [torch.bfloat16, torch.float32]
    bf16 = port_train.make_optimizer(port_train.TrainConfig(optimizer="adamw-bf16")).init(params)
    assert {leaf["nu"].dtype for leaf in bf16["leaves"]} == {torch.bfloat16}
    ada = port_train.make_optimizer(port_train.TrainConfig(optimizer="adafactor")).init(params)
    assert set(ada["leaves"][0]) == {"v_row", "v_col"} and set(ada["leaves"][1]) == {"v"}
    with pytest.raises(ValueError, match="optimizer"):
        port_train.TrainConfig(optimizer="sgd")


@pytest.mark.parametrize("warmup", [0, 4])
def test_schedule_matches_optax(warmup):
    cfg = port_train.TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=12)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(12, warmup + 1), 3e-5)
    schedule = port_train.warmup_cosine_schedule(cfg)
    for count in range(16):
        got = float(schedule(torch.tensor(count, dtype=torch.int32)))
        assert got == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("z_loss,s,chunk", [(1e-4, 64, 16), (0.0, 40, 16)], ids=["chunked", "ragged"])
def test_chunked_loss_and_grads_match_jax(z_loss, s, chunk):
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, s, 32), dtype=np.float32)
    head = rng.standard_normal((32, 96), dtype=np.float32) * 0.3
    tokens = rng.integers(0, 96, (2, s)).astype(np.int32)

    def jloss(h, w):
        return jax_train.chunked_next_token_loss(h, w, jnp.asarray(tokens), z_loss, chunk=chunk)

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(head)
    )
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    pl, pm = port_train.chunked_next_token_loss(th, tw, torch.from_numpy(tokens).long(), z_loss, chunk=chunk)
    pl.backward()
    assert float(pl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(pm["perplexity"].detach()) == pytest.approx(float(jm["perplexity"]), rel=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5, rtol=0)
    logits = hidden @ head
    jl2, _ = jax_train.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens), z_loss)
    pl2, _ = port_train.next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens), z_loss)
    assert float(pl2) == pytest.approx(float(jl2), rel=1e-5)
    assert float(pl.detach()) == pytest.approx(float(pl2), rel=1e-5)


def test_sentinel_and_gate_match_jax_over_nan_and_spike():
    """Loss/grad-norm sequence: warm-up, a NaN, a loss spike, a grad
    spike, recovery — flags and EMA state step for step."""
    seq = [(2.0, 1.0), (1.9, 1.1), (float("nan"), 1.0), (1.8, 0.9), (50.0, 1.0),
           (1.7, 40.0), (1.7, float("inf")), (1.6, 1.0)]
    kw = dict(ema_beta=0.9, spike_factor=4.0, warmup_steps=2)
    jh, ph = jax_health.health_init(), port_health.health_init()
    for loss, gnorm in seq:
        jh, jflags = jax_health.sentinel_update(jh, jnp.float32(loss), jnp.float32(gnorm), **kw)
        ph, pflags = port_health.sentinel_update(ph, torch.tensor(loss), torch.tensor(gnorm), **kw)
        assert {k: float(v) for k, v in pflags.items()} == {k: float(v) for k, v in jflags.items()}
        for key in ("ema_loss", "ema_grad", "count"):
            assert float(ph[key]) == pytest.approx(float(jh[key]), rel=1e-6)
        applied = pflags[port_health.FLAG_APPLIED] > 0
        new, old = torch.tensor([1.0, float("nan")]), torch.tensor([3.0, 4.0])
        gated = port_health.gate_update(applied, new, old)
        ref = jax_health.gate_update(jflags[jax_health.FLAG_APPLIED] > 0, jnp.asarray(new.numpy()),
                                     jnp.asarray(old.numpy()))
        np.testing.assert_array_equal(gated.numpy(), np.asarray(ref))
    assert float(ph["count"]) == 4  # the NaN, the two spikes and the Inf were not applied


def _train_configs(kind):
    if kind == "tiny":
        jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)
        pcfg = dataclasses.replace(port_llama.LlamaConfig.tiny(), dtype=torch.float32)
        return jcfg, pcfg
    kw = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
              intermediate=256, max_seq_len=64, remat=False, tied_embeddings=True)
    return (jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))


@pytest.mark.parametrize("kind", ["tiny", "d128"])
def test_train_step_matches_jax(kind):
    jcfg, pcfg = _train_configs(kind)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3, ce_chunk=16)
    jt, pt = jax_train.TrainConfig(**kw), port_train.TrainConfig(**kw)
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, jt, mesh, LOGICAL_RULES_FSDP_TP)
    jstep = jax_train.make_train_step(jcfg, jt, mesh, LOGICAL_RULES_FSDP_TP)
    pstate = port_train.init_train_state(torch.Generator().manual_seed(0), pcfg, pt, device="cpu")
    pstate["params"] = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), pcfg, device="cpu")
    pstate["opt_state"] = port_train.make_optimizer(pt).init(
        [p for _, p in port_train.param_leaves(pstate["params"])]
    )
    pstep = port_train.make_train_step(pcfg, pt)
    rng = np.random.default_rng(4)
    for _ in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        pstate, pm = pstep(pstate, torch.from_numpy(tokens).long())
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert int(pstate["step"]) == 3
    ref = jax.tree.map(np.asarray, jstate["params"])
    got = params_to_numpy(pstate["params"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# -- the MoE family ----------------------------------------------------------------


def test_moe_train_step_matches_jax():
    """3 adamw steps on tiny MoE with the dropless gmm dispatch, f32, the
    port against the JAX package's ``make_train_step`` on a one-device CPU
    mesh: losses (aux terms included), grad norms and the router metrics
    within 1e-5 relative, every parameter within 1e-4 max-abs (as the
    Llama case above)."""
    from tpu_nexus.models import moe as jax_moe
    from tpu_nexus_torch.models import moe as port_moe

    jcfg = dataclasses.replace(jax_moe.MoeConfig.tiny(), dtype=jnp.float32, dispatch="gmm")
    pcfg = dataclasses.replace(port_moe.MoeConfig.tiny(), dtype=torch.float32, dispatch="gmm")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3, ce_chunk=16, optimizer="adamw")
    jt, pt = jax_train.TrainConfig(**kw), port_train.TrainConfig(**kw)
    mesh = build_mesh(MeshSpec(), devices=jax.devices()[:1])
    jstate = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, jt, mesh, LOGICAL_RULES_FSDP_TP)
    jstep = jax_train.make_train_step(jcfg, jt, mesh, LOGICAL_RULES_FSDP_TP)
    pstate = port_train.init_train_state(torch.Generator().manual_seed(0), pcfg, pt, device="cpu")
    pstate["params"] = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), pcfg, device="cpu")
    pstate["opt_state"] = port_train.make_optimizer(pt).init(
        [p for _, p in port_train.param_leaves(pstate["params"])]
    )
    pstep = port_train.make_train_step(pcfg, pt)
    rng = np.random.default_rng(4)
    for _ in range(3):
        tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        pstate, pm = pstep(pstate, torch.from_numpy(tokens).long())
        for key in ("loss", "grad_norm", "load_balance", "router_z"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
        assert float(pm["dropped_frac"]) == float(jm["dropped_frac"]) == 0.0
    ref = jax.tree.map(np.asarray, jstate["params"])
    got = params_to_numpy(pstate["params"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_moe_preset_runs_through_the_harness():
    """``NEXUS_MODEL_PRESET=moe_tiny NEXUS_DEVICE=cpu`` through
    ``run_workload``: COMPLETED, the router metrics in the summary."""
    from tpu_nexus_torch.checkpoint.models import CheckpointedRequest, LifecycleStage
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

    cfg = WorkloadConfig.from_env({"NEXUS_MODEL_PRESET": "moe_tiny", "NEXUS_DEVICE": "cpu", "NEXUS_STEPS": "3",
                                   "NEXUS_BATCH": "2", "NEXUS_SEQ_LEN": "32", "NEXUS_HEARTBEAT_EVERY": "1"})
    assert cfg.model.name == "moe"
    store = InMemoryCheckpointStore()
    store.upsert_checkpoint(CheckpointedRequest(algorithm="train", id="r-moe", lifecycle_stage=LifecycleStage.BUFFERED))
    ctx = ProcessContext(run_id="r-moe", algorithm="train", process_id=0, num_processes=1, coordinator=None)
    summary = run_workload(cfg, store=store, ctx=ctx, lifecycle=LifecycleContext(), telemetry=NullMetrics())
    row = store.read_checkpoint("train", "r-moe")
    assert row.lifecycle_stage == LifecycleStage.COMPLETED
    assert row.per_chip_steps == {"host0/chip0": 3}
    assert summary["final_step"] == 3 and np.isfinite(summary["loss"])
    assert np.isfinite(summary["load_balance"]) and np.isfinite(summary["router_z"])
    assert summary["dropped_frac"] >= 0.0
