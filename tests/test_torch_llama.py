"""The port's Llama model against the JAX package.

The same weights (made by the JAX package's ``llama_init`` from a seed and
carried across with ``tpu_nexus_torch.models.convert``) and the same
tokens (numpy, seeded) go through both forwards.  Tolerance: f32, 1e-5
max-abs on logits, hidden states and K/V.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import llama as jax_llama
from tpu_nexus_torch.models import llama as port_llama
from tpu_nexus_torch.models.convert import params_from_numpy, params_to_numpy
from tpu_nexus_torch.models.registry import LlamaAdapter, get_adapter

torch.set_num_threads(1)
TOL = 1e-5


def d128_configs():
    """A 2-layer config with head_dim 128 (the kernel's width), both sides."""
    kw = dict(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, remat=False,
    )
    return (
        jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
        port_llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32, **kw),
    )


def tiny_configs():
    return (
        dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32),
        dataclasses.replace(port_llama.LlamaConfig.tiny(), dtype=torch.float32),
    )


def carried(jcfg, pcfg, seed=0):
    """(jax params, port params) holding the same weights."""
    jparams = jax_llama.llama_init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, pcfg, device="cpu")


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("configs", [tiny_configs, d128_configs], ids=["tiny", "d128"])
def test_forward_and_hidden_kv_match(configs):
    jcfg, pcfg = configs()
    jparams, pparams = carried(jcfg, pcfg)
    tok = tokens(2, 40, jcfg.vocab_size)
    ref = jax_llama.llama_forward(jparams, jnp.asarray(tok), jcfg)
    out = port_llama.llama_forward(pparams, torch.from_numpy(tok), pcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=TOL, rtol=0)

    jh, (jk, jv) = jax_llama.llama_hidden(jparams, jnp.asarray(tok), jcfg, return_kv=True)
    ph, (pk, pv) = port_llama.llama_hidden(pparams, torch.from_numpy(tok), pcfg, return_kv=True)
    assert pk.shape == (pcfg.n_layers, 2, 40, pcfg.n_kv_heads, pcfg.head_dim)
    for a, b in ((ph, jh), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=TOL, rtol=0)


def _presets(cls):
    return sorted(n for n, f in vars(cls).items() if isinstance(f, staticmethod))


def _fields(cfg):
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).split(".")[-1]
        if isinstance(v, type) or hasattr(v, "dtype"):
            return jnp.dtype(v).name
        return v

    return {k: norm(v) for k, v in dataclasses.asdict(cfg).items()}


def test_every_preset_matches_the_reference():
    assert _presets(port_llama.LlamaConfig) == _presets(jax_llama.LlamaConfig)
    for name in _presets(jax_llama.LlamaConfig):
        jcfg = getattr(jax_llama.LlamaConfig, name)()
        pcfg = getattr(port_llama.LlamaConfig, name)()
        assert _fields(pcfg) == _fields(jcfg), name
        assert port_llama.param_count(pcfg) == jax_llama.param_count(jcfg), name


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_convert_round_trips_bit_exact(param_dtype, tied):
    jcfg = dataclasses.replace(
        jax_llama.LlamaConfig.tiny(), param_dtype=getattr(jnp, param_dtype), tied_embeddings=tied
    )
    pcfg = dataclasses.replace(
        port_llama.LlamaConfig.tiny(), param_dtype=getattr(torch, param_dtype), tied_embeddings=tied
    )
    tree = jax.tree.map(np.asarray, jax_llama.llama_init(jax.random.PRNGKey(3), jcfg))
    params = params_from_numpy(tree, pcfg, device="cpu")
    assert params["layers"]["wq"].dtype == getattr(torch, param_dtype)
    back = params_to_numpy(params)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_convert_rejects_a_mismatched_tree():
    jcfg, pcfg = tiny_configs()
    tree = jax.tree.map(np.asarray, jax_llama.llama_init(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="tied_embeddings"):
        params_from_numpy(tree, dataclasses.replace(pcfg, tied_embeddings=True), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, dataclasses.replace(pcfg, intermediate=64), device="cpu")


def test_init_is_seeded_and_shaped_like_the_reference():
    _, pcfg = tiny_configs()
    a = port_llama.llama_init(torch.Generator().manual_seed(5), pcfg, device="cpu")
    b = port_llama.llama_init(torch.Generator().manual_seed(5), pcfg, device="cpu")
    jtree = jax_llama.llama_init(jax.random.PRNGKey(0), tiny_configs()[0])
    ptree = params_to_numpy(a)
    assert jax.tree.map(np.shape, ptree) == jax.tree.map(np.shape, jtree)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert all(p.requires_grad for p in a.parameters())  # trainable
    assert sum(p.numel() for p in a.parameters()) == port_llama.param_count(pcfg)


def test_registry_resolves_llama_and_names_the_unported():
    assert isinstance(get_adapter("llama3_8b"), LlamaAdapter)
    assert get_adapter("tiny").config == port_llama.LlamaConfig.tiny()
    assert get_adapter("mnist").name == "mnist"
    # the MoE presets resolve since the MoE slice (tests/test_torch_moe.py
    # holds them against the JAX package's)
    for preset in ("moe_tiny", "nexus_moe", "mixtral_8x7b"):
        assert get_adapter(preset).name == "moe"
    with pytest.raises(KeyError, match="unknown"):
        get_adapter("gpt2")


@pytest.mark.parametrize("shape,dtype", [((4, 256, 128), "f32"), ((512, 64), "bf16")])
def test_rms_norm_plain_matches_the_pallas_kernel(shape, dtype):
    """Kernel #9's plain version (what the CPU runs and the card holds the
    CUDA kernel against) against the JAX package's ``rms_norm_pallas`` in
    interpret mode on the same numpy inputs: f32 to 1e-5 (as
    ``tests/test_ops.py`` holds the Pallas kernel to XLA), bf16 within one
    bf16 ulp of each element.  On the CPU the kernel's wrapper is the plain
    version and launches nothing."""
    from tpu_nexus.ops.rmsnorm import rms_norm_pallas
    from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape, dtype=np.float32) * 3
    w = rng.standard_normal(shape[-1:], dtype=np.float32) + 1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(rms_norm_pallas(jnp.asarray(x).astype(jdt), jnp.asarray(w), interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))).to(tdt)
    out = rms_norm(xt, torch.from_numpy(w)).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(out - ref) <= 2**-7 * np.abs(ref)).all()
    before = rms_norm_kernel.launches
    assert torch.equal(rms_norm_kernel(xt, torch.from_numpy(w)), rms_norm(xt, torch.from_numpy(w)))
    assert rms_norm_kernel.launches == before
    with pytest.raises(ValueError, match="rms_norm kernel unsupported"):
        rms_norm_kernel(torch.empty(2, 9000, device="meta"), torch.empty(9000, device="meta"))
