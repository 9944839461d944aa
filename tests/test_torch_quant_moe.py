"""The port's quantized MoE serving against the JAX package
(``MoeConfig.tiny`` widths, f32 compute, weights carried across by
``models/convert.py``, inputs from numpy with a fixed seed).

* ``quantize_params`` over the expert stacks ``[L, E, K, N]`` is bit for
  bit the reference's in int8 and in int4 at groups 16 and 32: each leaf
  slices to ``[E, K, N]`` per layer with its scales kept per expert; the
  router, the norms and the embeddings keep their dtype; ``quantized_bytes``
  is equal.
* ``moe_hidden`` of the quantized tree is within 1e-5 x max|ref| of the
  reference's for each dispatch (scatter, sort, gmm through its plain
  grouped matmul).
* Greedy ``generate`` with int8 weights + an int8 KV cache, and with int4
  weights, is token-identical; ``teacher_forced_decode_ce`` of a
  quantized tree is within 1e-5 relative.
* The reference's own checks (``tests/test_quant.py``), ported:
  ``test_moe_forward_close`` and ``test_moe_decode_path_with_int8_kv``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import moe as jax_moe
from tpu_nexus.models import quant as jq
from tpu_nexus_torch.models import moe as port_moe
from tpu_nexus_torch.models import quant as pq
from tpu_nexus_torch.models.convert import params_from_numpy
from test_torch_moe import carried, moe_configs
from test_torch_quant import numpy_tree

jax_gen = importlib.import_module("tpu_nexus.models.generate")
port_gen = importlib.import_module("tpu_nexus_torch.models.generate")

torch.set_num_threads(1)
REL = 1e-5
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
MODES = [("int8", 0), ("int4", 16), ("int4", 32)]


def _quantized_pair(mode, group, dispatch="scatter", seed=0):
    """(jcfg, pcfg, JAX quantized tree, the port's quantized tree), both
    quantized from the same carried weights."""
    jcfg, pcfg = moe_configs(dispatch=dispatch)
    jparams, pparams = carried(jcfg, pcfg, seed=seed)
    return jcfg, pcfg, jq.quantize_params(jparams, mode=mode, group=group), pq.quantize_params(
        pparams, mode=mode, group=group)


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale, (float(np.abs(got - ref).max()), scale)


@pytest.mark.parametrize("mode,group", MODES)
def test_expert_stacks_quantize_bit_identical(mode, group):
    jcfg, _, jqt, pqt = _quantized_pair(mode, group)
    ne, e, f, nl = jcfg.n_experts, jcfg.hidden, jcfg.intermediate, jcfg.n_layers
    for name in ("wq", "wk", "wv", "wo") + EXPERT_LEAVES:
        pl, jl = pqt["layers"][name], jqt["layers"][name]
        assert type(pl).__name__ == type(jl).__name__
        np.testing.assert_array_equal(pl.q.numpy(), np.asarray(jl.q))
        np.testing.assert_array_equal(pl.s.numpy(), np.asarray(jl.s))
        assert tuple(pl.shape) == tuple(jl.shape)
    for name in EXPERT_LEAVES:
        leaf = pqt["layers"][name]
        k, n = (f, e) if name == "w_down" else (e, f)
        assert leaf.shape == (nl, ne, k, n)
        for li in range(nl):
            one = leaf[li]
            assert one.shape == (ne, k, n)
            if mode == "int8":
                # per expert and output channel: amax over the contraction only
                assert tuple(one.s.shape) == (ne, 1, n)
            else:
                assert tuple(one.q.shape) == (ne, k // 2, n) and tuple(one.s.shape) == (ne, k // group, n)
                assert one.group == group
            # the layer's slice dequantizes to the stack's slice
            torch.testing.assert_close(one.to(torch.float32), leaf.to(torch.float32)[li], rtol=0, atol=0)


@pytest.mark.parametrize("mode,group", MODES)
def test_router_norms_and_embeddings_keep_their_dtype(mode, group):
    _, pcfg = moe_configs()
    _, pparams = carried(*moe_configs())
    pqt = pq.quantize_params(pparams, mode=mode, group=group)
    for name in ("router", "attn_norm", "mlp_norm"):
        leaf = pqt["layers"][name]
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == pparams["layers"][name].dtype
        torch.testing.assert_close(leaf, pparams["layers"][name].detach(), rtol=0, atol=0)
    for key, leaf in pqt["embed"].items():
        assert leaf.dtype == pparams["embed"][key].dtype


@pytest.mark.parametrize("mode,group", MODES)
def test_quantized_bytes_equal_the_reference(mode, group):
    _, _, jqt, pqt = _quantized_pair(mode, group)
    assert pq.quantized_bytes(pqt) == jq.quantized_bytes(jqt)
    assert pq.quantized_bytes(pqt) < pq.quantized_bytes(carried(*moe_configs())[1])


def test_quantized_tree_carries_across_bit_identical():
    """A JAX-quantized MoE tree carried by ``params_from_numpy`` equals the
    port's own quantization of the same weights."""
    jcfg, pcfg, jqt, pqt = _quantized_pair("int4", 16)
    carried_q = params_from_numpy(numpy_tree(jqt), pcfg, device="cpu")
    for name in EXPERT_LEAVES:
        assert torch.equal(carried_q["layers"][name].q, pqt["layers"][name].q)
        assert torch.equal(carried_q["layers"][name].s, pqt["layers"][name].s)


@pytest.mark.parametrize("dispatch", ["scatter", "sort", "gmm"])
@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 16)])
def test_moe_hidden_of_the_quantized_tree_matches_jax(dispatch, mode, group):
    jcfg, pcfg, jqt, pqt = _quantized_pair(mode, group, dispatch=dispatch)
    tok = _tokens(2, 24, jcfg.vocab_size, seed=3)
    jres = jax_moe.moe_hidden(jqt, jnp.asarray(tok), jcfg)
    with torch.no_grad():
        pres = port_moe.moe_hidden(pqt, torch.from_numpy(tok).long(), pcfg)
    _close(pres[0].numpy(), jres[0])
    for key in ("load_balance", "router_z", "dropped_frac"):
        assert float(pres[1][key]) == pytest.approx(float(jres[1][key]), rel=REL, abs=1e-7)


@pytest.mark.parametrize("mode,group,kv_quant", [("int8", 0, "int8"), ("int4", 16, ""), ("int4", 32, "int8")])
def test_greedy_generate_is_token_identical(mode, group, kv_quant):
    jcfg, pcfg, jqt, pqt = _quantized_pair(mode, group, dispatch="gmm")
    prompt = _tokens(3, 10, jcfg.vocab_size, seed=4)
    ref = jax_gen.generate(jqt, jnp.asarray(prompt), jcfg, max_new_tokens=8, kv_quant=kv_quant)
    got = port_gen.generate(pqt, torch.from_numpy(prompt), pcfg, max_new_tokens=8, kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode,group,kv_quant", [("int8", 0, "int8"), ("int4", 16, "")])
def test_teacher_forced_decode_ce_matches_jax(mode, group, kv_quant):
    jcfg, pcfg, jqt, pqt = _quantized_pair(mode, group)
    tok = _tokens(2, 20, jcfg.vocab_size, seed=5)
    ref = float(jax_gen.teacher_forced_decode_ce(jqt, jnp.asarray(tok), jcfg, kv_quant=kv_quant))
    got = float(port_gen.teacher_forced_decode_ce(pqt, torch.from_numpy(tok), pcfg, kv_quant=kv_quant))
    assert got == pytest.approx(ref, rel=REL)


# -- the reference's own checks (tests/test_quant.py), ported ------------------


def _reference_inputs():
    """The reference tests' own inputs, carried across: ``moe_init`` at
    ``PRNGKey(0)`` of ``MoeConfig.tiny(vocab_size=64)`` in f32 and the port's
    equal config.  (Whether int8 weights move the hidden state by 3 % or by
    25 % depends on whether they flip a routing decision, which the weights
    decide: both packages agree on every draw, so the ported checks keep the
    reference's draw.)"""
    jcfg = dataclasses.replace(jax_moe.MoeConfig.tiny(vocab_size=64), dtype=jnp.float32)
    pcfg = dataclasses.replace(port_moe.MoeConfig.tiny(vocab_size=64), dtype=torch.float32)
    jparams = jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)
    return pcfg, params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")


def _jax_tokens(seed, shape, vocab):
    return torch.from_numpy(np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, vocab)))


def test_moe_forward_close():
    cfg, params = _reference_inputs()
    qparams = pq.quantize_params(params)
    tokens = _jax_tokens(1, (2, 16), cfg.vocab_size).long()
    with torch.no_grad():
        hf, _ = port_moe.moe_hidden(params, tokens, cfg)
        hq, _ = port_moe.moe_hidden(qparams, tokens, cfg)
    rel = float((hq - hf).abs().max() / (hf.abs().max() + 1e-9))
    assert rel < 0.1, rel


def test_moe_decode_path_with_int8_kv():
    """The MoE family through the quantized decode path: generate works
    with int8 weights + int8 KV, and the decode-path CE stays close to
    full precision."""
    cfg, params = _reference_inputs()
    prompt = _jax_tokens(1, (2, 8), cfg.vocab_size)
    toks = port_gen.generate(pq.quantize_params(params), prompt, cfg, max_new_tokens=4, kv_quant="int8")
    assert tuple(toks.shape) == (2, 4)
    tokens = _jax_tokens(2, (2, 24), cfg.vocab_size)
    ce_full = float(port_gen.teacher_forced_decode_ce(params, tokens, cfg))
    ce_kv8 = float(port_gen.teacher_forced_decode_ce(params, tokens, cfg, kv_quant="int8"))
    assert abs(ce_kv8 - ce_full) / ce_full < 0.02, (ce_full, ce_kv8)


def test_decode_step_sends_only_the_attention_projections_to_the_kernels(monkeypatch):
    """On a decode step only wq, wk, wv and wo (no lead dim) may reach the
    dequant-matmul kernels; the expert stacks keep their lead dim and are
    dequantized before their einsum, as the reference does."""
    from tpu_nexus_torch.ops import quant_matmul as qm

    cfg, params = _reference_inputs()
    qparams = pq.quantize_params(params, mode="int4", group=16)
    seen = []
    real = qm.quant_matmul_supported

    def spy(x, w):
        # what the test asks on a card: the same activation on a non-CPU device
        seen.append((bool(qm._geometry(w)[0]), real(x.to("meta"), w)))
        return real(x, w)

    monkeypatch.setattr(qm, "quant_matmul_supported", spy)
    prompt = torch.from_numpy(_tokens(2, 8, cfg.vocab_size, seed=1))
    port_gen.generate(qparams, prompt, cfg, max_new_tokens=3)
    stacks = [ok for lead, ok in seen if lead]
    projections = [ok for lead, ok in seen if not lead]
    # per layer and call: wq, wk, wv, wo on the kernels; w_gate, w_up, w_down never
    assert len(stacks) == 3 * len(projections) // 4 > 0
    assert all(projections) and not any(stacks)
