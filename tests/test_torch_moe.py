"""The port's MoE family against the JAX package (``MoeConfig.tiny``
widths, f32 compute, weights carried across by ``models/convert.py``,
inputs from numpy with a fixed seed).

* ``moe_ffn`` for each dispatch (scatter, sort, gmm): the output, the three
  aux values, and the gradients of a loss that reads the output and the
  aux losses with respect to x and every layer leaf, within 1e-5 of the
  reference's largest magnitude (f32 sums in another order).
* The reference's own checks, ported: gmm is dropless under imbalance and
  gives experts that see no token exactly-zero weight grads; capacity
  drops overflow; the gmm and scatter paths agree when scatter drops
  nothing.
* ``moe_hidden`` (with ``return_kv``) and the checkpointed layer stack;
  ``moe_param_count`` equals the JAX function's and the tree's size.
* Registry: the presets resolve as in the JAX package with equal
  ``MoeConfig`` fields; ``model_flops_per_token`` equals the JAX
  function's for all three presets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import moe as jax_moe
from tpu_nexus.models import registry as jax_registry
from tpu_nexus.workload import goodput as jax_goodput
from tpu_nexus_torch.models import moe as port_moe
from tpu_nexus_torch.models import registry as port_registry
from tpu_nexus_torch.models.convert import params_from_numpy, params_to_numpy
from tpu_nexus_torch.workload import goodput as port_goodput

torch.set_num_threads(1)
REL = 1e-5
DISPATCHES = ("scatter", "sort", "gmm")


def moe_configs(**over):
    jcfg = dataclasses.replace(jax_moe.MoeConfig.tiny(), dtype=jnp.float32, **over)
    pcfg = dataclasses.replace(port_moe.MoeConfig.tiny(), dtype=torch.float32, **over)
    return jcfg, pcfg


def carried(jcfg, pcfg, seed=0):
    jparams = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale, (float(np.abs(got - ref).max()), scale)


FFN_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _layer0(jparams):
    """Layer 0's leaves that ``moe_ffn`` reads, as numpy."""
    return {k: np.asarray(jparams["layers"][k][0]) for k in FFN_LEAVES}


def _ffn_both(jcfg, pcfg, layer, x, out_w):
    """(JAX, port) of (out, aux, grads wrt (x, layer)) for the loss
    ``sum(out * out_w) + load_balance + router_z``."""

    def jloss(x, layer):
        out, aux = jax_moe.moe_ffn(x, layer, jcfg)
        return jnp.sum(out * out_w) + aux["load_balance"] + aux["router_z"], (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()}
    )
    px = torch.tensor(x, requires_grad=True)
    pl = {k: torch.tensor(v, requires_grad=True) for k, v in layer.items()}
    pout, paux = port_moe.moe_ffn(px, pl, pcfg)
    loss = (pout * torch.from_numpy(out_w)).sum() + paux["load_balance"] + paux["router_z"]
    names = sorted(pl)
    grads = torch.autograd.grad(loss, [px] + [pl[k] for k in names])
    pgrads = (grads[0].numpy(), {k: g.numpy() for k, g in zip(names, grads[1:])})
    paux = {k: float(v.detach()) for k, v in paux.items()}
    return (jout, jaux, jgrads), (pout.detach().numpy(), paux, pgrads)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_ffn_matches_jax_fwd_aux_and_grads(dispatch):
    jcfg, pcfg = moe_configs(dispatch=dispatch)
    jparams, _ = carried(jcfg, pcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, jcfg.hidden)).astype(np.float32)
    out_w = rng.standard_normal(x.shape).astype(np.float32)
    (jout, jaux, (jgx, jgl)), (pout, paux, (pgx, pgl)) = _ffn_both(jcfg, pcfg, _layer0(jparams), x, out_w)
    _close(pout, jout)
    for key in ("load_balance", "router_z", "dropped_frac"):
        assert paux[key] == pytest.approx(float(jaux[key]), rel=REL, abs=1e-7), key
    _close(pgx, jgx)
    for key, g in pgl.items():
        _close(g, jgl[key])
    if dispatch == "gmm":
        assert paux["dropped_frac"] == 0.0


def test_gmm_dispatch_is_dropless_under_imbalance():
    """Port of tests/test_moe.py's check: every token's top-2 is {0, 1};
    gmm drops nothing and experts that see no row get exactly-zero grads."""
    jcfg, pcfg = moe_configs(dispatch="gmm")
    jparams, _ = carried(jcfg, pcfg)
    layer = {k: torch.tensor(v, requires_grad=True) for k, v in _layer0(jparams).items()}
    router = torch.zeros_like(layer["router"])
    router[:, 0], router[:, 1] = 1.0, 0.5
    layer["router"] = router.requires_grad_()
    x = np.abs(np.random.default_rng(1).standard_normal((2, 32, pcfg.hidden))).astype(np.float32) + 0.1
    x = torch.from_numpy(x)
    out, aux = port_moe.moe_ffn(x, layer, pcfg)
    (gw,) = torch.autograd.grad(out.square().sum(), [layer["w_gate"]])
    assert float(aux["dropped_frac"]) == 0.0
    per_expert = gw.abs().reshape(pcfg.n_experts, -1).sum(dim=1)
    assert float(per_expert[0]) > 0
    assert bool((per_expert[2:] == 0).all()), per_expert


def test_capacity_drops_overflow():
    jcfg, pcfg = moe_configs(capacity_factor=0.25)
    jparams, _ = carried(jcfg, pcfg)
    x = np.random.default_rng(1).standard_normal((2, 16, pcfg.hidden)).astype(np.float32)
    out, aux = port_moe.moe_ffn(torch.from_numpy(x), {k: torch.tensor(v) for k, v in _layer0(jparams).items()},
                                pcfg)
    jout, jaux = jax_moe.moe_ffn(jnp.asarray(x), _layer0(jparams), jcfg)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux["dropped_frac"]) > 0.0
    assert float(aux["dropped_frac"]) == pytest.approx(float(jaux["dropped_frac"]), rel=REL)
    _close(out.numpy(), jout)
    assert port_moe.expert_capacity(64, port_moe.MoeConfig.tiny()) == jax_moe.expert_capacity(
        64, jax_moe.MoeConfig.tiny()) == 40


def test_gmm_matches_scatter_when_nothing_drops():
    """The reference's check within the port: with ample capacity the
    scatter path drops nothing and equals the dropless gmm path."""
    _, base = moe_configs()
    layer = {k: v[0] for k, v in port_moe.moe_init(torch.Generator().manual_seed(0), base, "cpu")["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 32, base.hidden)).astype(np.float32))
    with torch.no_grad():
        out_s, aux_s = port_moe.moe_ffn(x, layer, dataclasses.replace(base, capacity_factor=float(base.n_experts)))
        out_g, aux_g = port_moe.moe_ffn(x, layer, dataclasses.replace(base, dispatch="gmm"))
    assert float(aux_s["dropped_frac"]) == float(aux_g["dropped_frac"]) == 0.0
    _close(out_g.numpy(), out_s.numpy())


def test_unknown_dispatch_and_meshes_raise():
    _, pcfg = moe_configs(dispatch="dense")
    x = torch.zeros((1, 4, pcfg.hidden))
    layer = {k: v[0] for k, v in port_moe.moe_init(torch.Generator().manual_seed(0), pcfg, "cpu")["layers"].items()}
    with pytest.raises(ValueError, match="unknown MoeConfig.dispatch"):
        port_moe.moe_ffn(x, layer, pcfg)
    with pytest.raises(NotImplementedError, match="A6"):
        port_moe.moe_ffn(x, layer, pcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="A6"):
        port_moe.moe_hidden_pp()


@pytest.mark.parametrize("return_kv", [False, True])
def test_moe_hidden_matches_jax(return_kv):
    jcfg, pcfg = moe_configs(dispatch="gmm")
    jparams, pparams = carried(jcfg, pcfg)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jres = jax_moe.moe_hidden(jparams, jnp.asarray(tok), jcfg, return_kv=return_kv)
    with torch.no_grad():
        pres = port_moe.moe_hidden(pparams, torch.from_numpy(tok).long(), pcfg, return_kv=return_kv)
    _close(pres[0].numpy(), jres[0])
    for key in ("load_balance", "router_z", "dropped_frac"):
        assert float(pres[1][key]) == pytest.approx(float(jres[1][key]), rel=REL, abs=1e-7)
    if return_kv:
        for p, j in zip(pres[2], jres[2]):
            assert tuple(p.shape) == (jcfg.n_layers, 2, 24, jcfg.n_kv_heads, jcfg.head_dim)
            _close(p.numpy(), j)


@pytest.mark.parametrize("policy", ["dots", "attn_out", "qkv", "nothing"])
def test_checkpointed_layers_give_the_unchecked_gradients(policy):
    """Every remat policy recomputes the MoE layer (router included) to the
    same gradients as no checkpointing."""
    _, pcfg = moe_configs(dispatch="gmm")
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, pcfg.vocab_size, (2, 16)))
    grads = []
    for cfg in (pcfg, dataclasses.replace(pcfg, remat=True, remat_policy=policy)):
        params = port_moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
        hidden, aux = port_moe.moe_hidden(params, tok, cfg)
        loss = hidden.square().mean() + aux["load_balance"] + aux["router_z"]
        leaves = [p for name, p in params.named_parameters() if name != "lm_head"]  # the head is unused
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_param_count_matches_jax_and_the_tree():
    for preset in ("tiny", "nexus_moe", "mixtral_8x7b"):
        assert port_moe.moe_param_count(getattr(port_moe.MoeConfig, preset)()) == jax_moe.moe_param_count(
            getattr(jax_moe.MoeConfig, preset)())
    jcfg, pcfg = moe_configs()
    jparams, pparams = carried(jcfg, pcfg)
    assert sum(p.numel() for p in pparams.parameters()) == port_moe.moe_param_count(pcfg)
    assert jax.tree.map(np.shape, params_to_numpy(pparams)) == jax.tree.map(np.shape, jparams)
    ours = port_moe.moe_init(torch.Generator().manual_seed(0), pcfg, "cpu")
    assert jax.tree.map(np.shape, params_to_numpy(ours)) == jax.tree.map(np.shape, jparams)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(jax.tree.map(np.asarray, jparams), dataclasses.replace(pcfg, n_experts=8), device="cpu")


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = str(v).split(".")[-1] if f.name in ("dtype", "param_dtype") else v
    return out


@pytest.mark.parametrize("preset", ["moe_tiny", "nexus_moe", "mixtral_8x7b", "moe_mixtral_8x7b", "tiny"])
def test_presets_resolve_as_in_jax(preset):
    j, p = jax_registry.get_adapter(preset), port_registry.get_adapter(preset)
    assert p.name == j.name
    if p.name == "moe":
        jf = _fields(j.config)
        jf.update(dtype=jnp.dtype(j.config.dtype).name, param_dtype=jnp.dtype(j.config.param_dtype).name)
        assert _fields(p.config) == jf
        assert port_registry.adapter_for(p.config).name == "moe"
    with pytest.raises(KeyError):
        port_registry.get_adapter("moe_nonsense")


@pytest.mark.parametrize("preset", ["tiny", "nexus_moe", "mixtral_8x7b"])
def test_model_flops_per_token_matches_jax(preset):
    for seq in (128, 2048):
        assert port_goodput.model_flops_per_token(getattr(port_moe.MoeConfig, preset)(), seq) == (
            jax_goodput.model_flops_per_token(getattr(jax_moe.MoeConfig, preset)(), seq))
