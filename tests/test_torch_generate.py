"""The port's KV-cache decoding against the JAX package.

Same weights (carried with ``models/convert.py``), same numpy prompts.
``prefill`` logits and caches and ``decode_step`` in its scalar, ragged and
per-slot vector-``pos`` modes match to 1e-5 (f32, max-abs); greedy
``generate`` is token-identical; sampled tokens with ``top_k`` fall inside
the top-k set of the JAX model's logits.

Quantized serving: the JAX tree is quantized by the JAX package and
carried across by ``params_from_numpy``.  ``prefill``'s int8 cache has
equal ``k``/``v`` and scales within 1e-6 relative; decode-step logits match
to 1e-4; greedy ``generate`` is token-identical for int8, int4 and int8 +
int8-KV, uniform and ragged; ``teacher_forced_decode_ce`` matches to 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.models import quant as jax_quant
from tpu_nexus_torch.models.convert import params_from_numpy
from test_torch_llama import carried, d128_configs, tiny_configs, tokens
from test_torch_quant import numpy_tree

# the packages' __init__ re-export a function named `generate`, which
# shadows the module of the same name on attribute import
jax_gen = importlib.import_module("tpu_nexus.models.generate")
port_gen = importlib.import_module("tpu_nexus_torch.models.generate")

torch.set_num_threads(1)
TOL = 1e-5


def _lens(b, s, seed=0):
    lens = np.random.default_rng(seed).integers(s // 2, s + 1, size=b).astype(np.int32)
    lens[0] = s  # one full-width row
    return lens


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_and_cache_match(ragged):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    tok = tokens(3, 12, jcfg.vocab_size, seed=1)
    lens = _lens(3, 12) if ragged else None
    jcache, jlogits = jax_gen.prefill(
        jparams, jnp.asarray(tok), jcfg, 20, None if lens is None else jnp.asarray(lens)
    )
    pcache, plogits = port_gen.prefill(
        pparams, torch.from_numpy(tok), pcfg, 20, None if lens is None else torch.from_numpy(lens)
    )
    _close(plogits, jlogits)
    for name in ("k", "v"):
        assert pcache[name].shape == jcache[name].shape
        _close(pcache[name], jcache[name])


@pytest.mark.parametrize("mode", ["scalar", "ragged", "per_slot"])
def test_decode_step_matches(mode):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    b, s, max_len = 3, 10, 24
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jcfg.vocab_size, size=b).astype(np.int32)
    if mode == "per_slot":
        shape = (jcfg.n_layers, b, max_len, jcfg.n_kv_heads, jcfg.head_dim)
        kc = rng.standard_normal(shape, dtype=np.float32)
        vc = rng.standard_normal(shape, dtype=np.float32)
        pos_np = np.array([0, 9, max_len - 1], dtype=np.int32)
        jargs = dict(pos=jnp.asarray(pos_np))
        pargs = dict(pos=torch.from_numpy(pos_np))
        jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
        pcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    else:
        prompt = tokens(b, s, jcfg.vocab_size, seed=2)
        lens = _lens(b, s, seed=3) if mode == "ragged" else None
        jcache, _ = jax_gen.prefill(
            jparams, jnp.asarray(prompt), jcfg, max_len, None if lens is None else jnp.asarray(lens)
        )
        pcache, _ = port_gen.prefill(
            pparams, torch.from_numpy(prompt), pcfg, max_len,
            None if lens is None else torch.from_numpy(lens),
        )
        jargs = dict(pos=jnp.asarray(s, jnp.int32))
        pargs = dict(pos=s)
        if lens is not None:
            jargs.update(prompt_lengths=jnp.asarray(lens), prompt_width=s)
            pargs.update(prompt_lengths=torch.from_numpy(lens), prompt_width=s)
    jlogits, jcache = jax_gen.decode_step(
        jparams, jcache, jnp.asarray(tok), cfg=jcfg, decode_kernel="xla", **jargs
    )
    plogits, pcache = port_gen.decode_step(
        pparams, pcache, torch.from_numpy(tok), cfg=pcfg, decode_kernel="plain", **pargs
    )
    _close(plogits, jlogits)
    _close(pcache["k"], jcache["k"])
    _close(pcache["v"], jcache["v"])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("configs", [tiny_configs, d128_configs], ids=["tiny", "d128"])
def test_greedy_generate_is_token_identical(configs, ragged):
    jcfg, pcfg = configs()
    jparams, pparams = carried(jcfg, pcfg, seed=4)
    prompt = tokens(3, 16, jcfg.vocab_size, seed=5)
    lens = _lens(3, 16, seed=6) if ragged else None
    ref = jax_gen.generate(
        jparams, jnp.asarray(prompt), jcfg, max_new_tokens=12,
        prompt_lengths=None if lens is None else jnp.asarray(lens),
    )
    out = port_gen.generate(
        pparams, torch.from_numpy(prompt), pcfg, max_new_tokens=12,
        prompt_lengths=None if lens is None else torch.from_numpy(lens),
    )
    assert out.shape == (3, 12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_top_k_tokens_lie_in_the_reference_top_k():
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg, seed=8)
    prompt = tokens(4, 8, jcfg.vocab_size, seed=9)
    top_k, n = 3, 10
    out = port_gen.generate(
        pparams, torch.from_numpy(prompt), pcfg, max_new_tokens=n, temperature=0.8,
        top_k=top_k, generator=torch.Generator().manual_seed(0),
    ).numpy()
    context = np.concatenate([prompt, out[:, :-1]], axis=1)
    logits = np.asarray(jax_llama.llama_forward(jparams, jnp.asarray(context), jcfg))
    allowed = np.asarray(jax.lax.top_k(jnp.asarray(logits), top_k)[1])  # [B, S, k]
    for i in range(n):
        for row in range(4):
            assert out[row, i] in allowed[row, prompt.shape[1] - 1 + i]


def test_sample_logits_greedy_and_validation():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, -1.0]])
    assert port_gen.sample_logits(logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    draws = port_gen.sample_logits(logits.repeat(50, 1), g, temperature=1.0, top_p=0.5)
    assert set(draws.tolist()) == {0, 1}  # the nucleus of each row is its argmax
    jcfg, pcfg = tiny_configs()
    _, pparams = carried(jcfg, pcfg)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="temperature"):
        port_gen.generate(pparams, prompt, pcfg, max_new_tokens=2, top_k=2)
    with pytest.raises(ValueError, match="Generator"):
        port_gen.generate(pparams, prompt, pcfg, max_new_tokens=2, temperature=1.0)
    with pytest.raises(ValueError, match="unknown kv_quant mode 'int4'"):
        port_gen.generate(pparams, prompt, pcfg, max_new_tokens=2, kv_quant="int4")
    for fn in (port_gen.decode_scan, port_gen.extend_step, port_gen.verify_step):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn()


# -- quantized weights and the int8 KV cache -------------------------------------


def _carried_quantized(jcfg, pcfg, mode, group=16, seed=0):
    """(JAX quantized tree, the same tree in the port)."""
    jparams = jax_llama.llama_init(jax.random.PRNGKey(seed), jcfg)
    if mode:
        jparams = jax_quant.quantize_params(jparams, mode=mode, group=group)
    return jparams, params_from_numpy(numpy_tree(jparams), pcfg, device="cpu")


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_int8_cache_matches(ragged):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    tok = tokens(3, 12, jcfg.vocab_size, seed=1)
    lens = _lens(3, 12) if ragged else None
    jcache, jlogits = jax_gen.prefill(
        jparams, jnp.asarray(tok), jcfg, 20, None if lens is None else jnp.asarray(lens), kv_quant="int8"
    )
    pcache, plogits = port_gen.prefill(
        pparams, torch.from_numpy(tok), pcfg, 20, None if lens is None else torch.from_numpy(lens),
        kv_quant="int8",
    )
    _close(plogits, jlogits)
    assert set(pcache) == set(jcache) == {"k", "v", "k_s", "v_s"}
    for name in ("k", "v"):
        assert pcache[name].dtype == torch.int8 and pcache[name].shape == jcache[name].shape
        # the K/V behind the cache agree to 1e-5, so a value that sits on a
        # rounding boundary may land one int8 step apart
        diff = np.abs(pcache[name].numpy().astype(np.int32) - np.asarray(jcache[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    for name in ("k_s", "v_s"):
        assert pcache[name].dtype == torch.float32 and pcache[name].shape == jcache[name].shape
        np.testing.assert_allclose(pcache[name].numpy(), np.asarray(jcache[name]), rtol=1e-6, atol=0)
        assert not pcache[name][:, :, 12:].any()  # zero-padded past the prompt


@pytest.mark.parametrize("mode", ["scalar", "ragged", "per_slot"])
@pytest.mark.parametrize("weights,kv", [("int8", ""), ("int4", ""), ("int8", "int8"), ("", "int8")])
def test_quantized_decode_step_matches(weights, kv, mode):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = _carried_quantized(jcfg, pcfg, weights)
    b, s, max_len = 3, 10, 24
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jcfg.vocab_size, size=b).astype(np.int32)
    prompt = tokens(b, s, jcfg.vocab_size, seed=2)
    lens = _lens(b, s, seed=3) if mode == "ragged" else None
    jcache, _ = jax_gen.prefill(
        jparams, jnp.asarray(prompt), jcfg, max_len, None if lens is None else jnp.asarray(lens), kv_quant=kv
    )
    # both sides decode from the SAME cache: the reference's, carried across
    pcache = {name: torch.from_numpy(np.array(x)) for name, x in jcache.items()}
    if mode == "per_slot":
        pos_np = np.array([3, 9, 10], dtype=np.int32)
        jargs, pargs = dict(pos=jnp.asarray(pos_np)), dict(pos=torch.from_numpy(pos_np))
    else:
        jargs, pargs = dict(pos=jnp.asarray(s, jnp.int32)), dict(pos=s)
        if lens is not None:
            jargs.update(prompt_lengths=jnp.asarray(lens), prompt_width=s)
            pargs.update(prompt_lengths=torch.from_numpy(lens), prompt_width=s)
    jlogits, jcache = jax_gen.decode_step(
        jparams, jcache, jnp.asarray(tok), cfg=jcfg, decode_kernel="xla", **jargs
    )
    plogits, pcache = port_gen.decode_step(
        pparams, pcache, torch.from_numpy(tok), cfg=pcfg, decode_kernel="plain", **pargs
    )
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    if kv:
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(pcache[name].numpy(), np.asarray(jcache[name]), rtol=1e-6, atol=0)
        for name in ("k", "v"):
            # as in the prefill test: at most one step, on a rounding boundary only
            diff = np.abs(pcache[name].numpy().astype(np.int32) - np.asarray(jcache[name]).astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    else:
        _close(pcache["k"], jcache["k"])
        _close(pcache["v"], jcache["v"])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("weights,kv", [("int8", ""), ("int4", ""), ("int8", "int8"), ("int4", "int8"), ("", "int8")])
def test_quantized_greedy_generate_is_token_identical(weights, kv, ragged):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = _carried_quantized(jcfg, pcfg, weights, seed=4)
    prompt = tokens(3, 16, jcfg.vocab_size, seed=5)
    lens = _lens(3, 16, seed=6) if ragged else None
    ref = jax_gen.generate(
        jparams, jnp.asarray(prompt), jcfg, max_new_tokens=12, kv_quant=kv,
        prompt_lengths=None if lens is None else jnp.asarray(lens),
    )
    out = port_gen.generate(
        pparams, torch.from_numpy(prompt), pcfg, max_new_tokens=12, kv_quant=kv,
        prompt_lengths=None if lens is None else torch.from_numpy(lens),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("weights,kv", [("", ""), ("int8", ""), ("int4", ""), ("int8", "int8")])
def test_teacher_forced_decode_ce_matches(weights, kv):
    jcfg, pcfg = tiny_configs()
    jparams, pparams = _carried_quantized(jcfg, pcfg, weights, seed=7)
    tok = tokens(2, 12, jcfg.vocab_size, seed=8)
    ref = float(jax_gen.teacher_forced_decode_ce(jparams, jnp.asarray(tok), jcfg, kv_quant=kv, decode_kernel="xla"))
    out = float(port_gen.teacher_forced_decode_ce(pparams, torch.from_numpy(tok), pcfg, kv_quant=kv))
    assert abs(out - ref) <= 1e-4
    assert out > 0


def test_quantized_forward_matches():
    jcfg, pcfg = tiny_configs()
    for mode in ("int8", "int4"):
        jparams, pparams = _carried_quantized(jcfg, pcfg, mode, seed=9)
        tok = tokens(2, 20, jcfg.vocab_size, seed=10)
        ref = jax_llama.llama_forward(jparams, jnp.asarray(tok), jcfg)
        from tpu_nexus_torch.models.llama import llama_forward

        out = llama_forward(pparams, torch.from_numpy(tok), pcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# -- the MoE family ----------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["gmm", "scatter"])
@pytest.mark.parametrize("ragged", [False, True])
def test_moe_greedy_generate_is_token_identical(dispatch, ragged):
    """Tiny MoE in f32: both packages decode MoE with scatter dispatch at a
    dropless capacity (``_decode_cfg``), whatever the config trains with;
    prefill logits agree to 1e-5 and greedy tokens are identical."""
    from test_torch_moe import carried as moe_carried
    from test_torch_moe import moe_configs

    jcfg, pcfg = moe_configs(dispatch=dispatch)
    assert port_gen._decode_cfg(pcfg).capacity_factor == jax_gen._decode_cfg(jcfg).capacity_factor == 2.0
    jparams, pparams = moe_carried(jcfg, pcfg, seed=4)
    prompt = tokens(3, 16, jcfg.vocab_size, seed=5)
    lens = _lens(3, 16, seed=6) if ragged else None
    _, jlogits = jax_gen.prefill(jparams, jnp.asarray(prompt), jcfg, 28,
                                 None if lens is None else jnp.asarray(lens))
    _, plogits = port_gen.prefill(pparams, torch.from_numpy(prompt), pcfg, 28,
                                  None if lens is None else torch.from_numpy(lens))
    _close(plogits.numpy(), jlogits)
    ref = jax_gen.generate(
        jparams, jnp.asarray(prompt), jcfg, max_new_tokens=12,
        prompt_lengths=None if lens is None else jnp.asarray(lens),
    )
    out = port_gen.generate(
        pparams, torch.from_numpy(prompt), pcfg, max_new_tokens=12,
        prompt_lengths=None if lens is None else torch.from_numpy(lens),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
