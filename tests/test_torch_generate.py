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

The serving engine's entry points start both packages from the same cache
state (carried with ``cache_from_numpy``): the paged ``decode_step`` (with
frozen rows), ``extend_step``, ``verify_step`` and ``decode_scan`` give
logits within 1e-5 and pooled caches equal to 1e-5 (f32), and the scan's
tokens, counts and carries are identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus.models import quant as jax_quant
from tpu_nexus_torch.models.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
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
    cache, _ = port_gen.prefill(pparams, prompt, pcfg, 8)
    with pytest.raises(ValueError, match="require per-slot vector pos"):
        port_gen.decode_step(pparams, cache, prompt[:, 0], 4, pcfg, write_mask=torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="num_steps must be >= 1"):
        port_gen.decode_scan(pparams, cache, prompt[:, 0], torch.tensor([4]), torch.tensor([1]), pcfg, num_steps=0)


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


# -- the serving engine's entry points: paged cache, frozen rows, scan, extend, verify --


def _pool_case(jcfg, b, page, n_log, pos, seed):
    """A pooled cache [L, NB, page, Hkv, D] (numpy) with shuffled tables:
    block 0 is the scratch block, each row owns blocks up to its cursor."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_log
    shape = (jcfg.n_layers, nb, page, jcfg.n_kv_heads, jcfg.head_dim)
    pool = {name: rng.standard_normal(shape, dtype=np.float32) for name in ("k", "v")}
    phys = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    live = np.asarray(pos) // page + 1
    tables = np.where(np.arange(n_log)[None, :] < live[:, None], phys, 0).astype(np.int32)
    return pool, tables


def _run_both(jfn, pfn, cache):
    """Run the JAX and the port entry point from the same cache state;
    return (JAX outputs, port outputs, JAX cache, port cache) as numpy."""
    jout, jcache = jfn({n: jnp.asarray(x) for n, x in cache.items()})
    pout, pcache = pfn(cache_from_numpy(cache, "cpu"))
    return jout, pout, {n: np.asarray(x) for n, x in jcache.items()}, cache_to_numpy(pcache)


def _close_caches(jc, pc):
    assert set(jc) == set(pc)
    for name in jc:
        _close(pc[name], jc[name])


@pytest.mark.parametrize("frozen", [False, True])
def test_paged_decode_step_matches(frozen):
    """Per-slot decode through the block tables (``logical_limit`` = the
    engine's max_len), with and without frozen rows: logits to 1e-5 and
    the pooled caches equal to 1e-5 (a frozen row writes nothing live)."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    b, page, n_log = 3, 4, 6
    pos = np.array([3, 13, 0], np.int32)
    pool, tables = _pool_case(jcfg, b, page, n_log, pos, seed=1)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=b).astype(np.int32)
    mask = np.array([True, False, True]) if frozen else None
    jl, pl, jc, pc = _run_both(
        lambda c: jax_gen.decode_step(
            jparams, c, jnp.asarray(tok), jnp.asarray(pos), jcfg, decode_kernel="xla",
            block_tables=jnp.asarray(tables), logical_limit=22,
            write_mask=None if mask is None else jnp.asarray(mask)),
        lambda c: port_gen.decode_step(
            pparams, c, torch.from_numpy(tok), torch.from_numpy(pos), pcfg,
            block_tables=torch.from_numpy(tables), logical_limit=22,
            write_mask=None if mask is None else torch.from_numpy(mask)),
        pool,
    )
    _close(pl, jl)
    _close_caches(jc, pc)


@pytest.mark.parametrize("width", [5, 11])
def test_extend_step_matches(width):
    """Partial prefill of a tail at a shared-prefix start through the
    paged cache: a tail of <= 8 tokens takes the decode kernel's route on
    the card, a wider one the plain gathered path — both equal the JAX
    package's here."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    pool, tables = _pool_case(jcfg, 2, 4, 6, np.array([20, 20]), seed=3)
    tail = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(1, width)).astype(np.int32)
    length = np.array([width - 2], np.int32)
    jl, pl, jc, pc = _run_both(
        lambda c: jax_gen.extend_step(
            jparams, c, jnp.asarray(tail), 8, jnp.asarray(length), jnp.asarray(tables[1:]), jcfg,
            decode_kernel="xla", logical_limit=22),
        lambda c: port_gen.extend_step(
            pparams, c, torch.from_numpy(tail), 8, torch.from_numpy(length),
            torch.from_numpy(tables[1:]), pcfg, logical_limit=22),
        pool,
    )
    _close(pl, jl)
    _close_caches(jc, pc)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_matches(paged):
    """Speculative verify at q_len 4 through the ``q_starts`` mode, per-row
    cursors; the contiguous case has a row whose window runs past the
    cache (those writes are dropped, as in the JAX package)."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    b, w = 3, 4
    rng = np.random.default_rng(5)
    block = rng.integers(0, jcfg.vocab_size, size=(b, w)).astype(np.int32)
    if paged:
        pos = np.array([3, 13, 0], np.int32)
        cache, tables = _pool_case(jcfg, b, 4, 6, pos + w, seed=6)
        jkw = dict(block_tables=jnp.asarray(tables), logical_limit=22)
        pkw = dict(block_tables=torch.from_numpy(tables), logical_limit=22)
    else:
        pos = np.array([3, 14, 0], np.int32)  # 14 + 4 > max_len 16
        shape = (jcfg.n_layers, b, 16, jcfg.n_kv_heads, jcfg.head_dim)
        cache = {n: rng.standard_normal(shape, dtype=np.float32) for n in ("k", "v")}
        jkw, pkw = {}, {}
    jl, pl, jc, pc = _run_both(
        lambda c: jax_gen.verify_step(
            jparams, c, jnp.asarray(block), jnp.asarray(pos), jcfg, decode_kernel="xla", **jkw),
        lambda c: port_gen.verify_step(pparams, c, torch.from_numpy(block), torch.from_numpy(pos), pcfg, **pkw),
        cache,
    )
    _close(pl, jl)
    _close_caches(jc, pc)


@pytest.mark.parametrize("paged,stop", [(False, -1), (True, -1), (True, 57)])
def test_decode_scan_matches(paged, stop):
    """k steps in one call with per-row budgets (a dead lane at limit 0)
    and stop detection: tokens, counts, carries and caches match."""
    jcfg, pcfg = tiny_configs()
    jparams, pparams = carried(jcfg, pcfg)
    b = 3
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jcfg.vocab_size, size=b).astype(np.int32)
    pos = np.array([3, 13, 0], np.int32)
    limit = np.array([4, 2, 0], np.int32)
    if paged:
        cache, tables = _pool_case(jcfg, b, 4, 6, pos + 4, seed=8)
        jkw = dict(block_tables=jnp.asarray(tables), logical_limit=22)
        pkw = dict(block_tables=torch.from_numpy(tables), logical_limit=22)
    else:
        shape = (jcfg.n_layers, b, 24, jcfg.n_kv_heads, jcfg.head_dim)
        cache = {n: rng.standard_normal(shape, dtype=np.float32) for n in ("k", "v")}
        jkw, pkw = {}, {}

    def jfn(c):
        *out, c = jax_gen.decode_scan(
            jparams, c, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(limit), jcfg,
            num_steps=4, stop_token=stop, decode_kernel="xla", **jkw)
        return [np.asarray(x) for x in out], c

    def pfn(c):
        *out, c = port_gen.decode_scan(
            pparams, c, torch.from_numpy(tok), torch.from_numpy(pos), torch.from_numpy(limit), pcfg,
            num_steps=4, stop_token=stop, **pkw)
        return [x.numpy() for x in out], c

    jout, pout, jc, pc = _run_both(jfn, pfn, cache)
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(p, j)
    _close_caches(jc, pc)


def test_caches_cross_both_ways_bit_exact():
    """``cache_from_numpy``/``cache_to_numpy`` carry a contiguous int8-KV
    cache and a pooled bf16 cache across unchanged."""
    jcfg, pcfg = tiny_configs()
    jparams, _ = carried(jcfg, pcfg)
    jcache, _ = jax_gen.prefill(jparams, jnp.asarray(tokens(2, 6, jcfg.vocab_size)), jcfg, 12, kv_quant="int8")
    tree = {n: np.asarray(x) for n, x in jcache.items()}
    back = cache_to_numpy(cache_from_numpy(tree, "cpu"))
    assert set(back) == {"k", "v", "k_s", "v_s"}
    for name in tree:
        assert back[name].dtype == tree[name].dtype
        np.testing.assert_array_equal(back[name], tree[name])
    pool = {n: np.asarray(jnp.ones((2, 5, 4, 2, 16), jnp.bfloat16) * 1.5) for n in ("k", "v")}
    out = cache_from_numpy(pool, "cpu")
    assert out["k"].dtype == torch.bfloat16 and float(out["k"].float().sum()) == 1.5 * 2 * 5 * 4 * 2 * 16
    with pytest.raises(ValueError, match="cache keys"):
        cache_from_numpy({"k": tree["k"]}, "cpu")
