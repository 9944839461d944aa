"""The port's flash-attention backward against the JAX package.

* :func:`flash_attention_bwd_plain` — the plain version of the dQ and
  dK/dV CUDA kernels — is held against the Pallas backward it replaces,
  run in interpret mode (``_flash_backward(..., interpret=True)``), on the
  same numpy inputs and the same forward residuals (out, lse).
  Tolerance: f32, 1e-5 max-abs (both accumulate in f32; only summation
  order differs).
* :class:`FlashAttention`'s CPU branch (plain forward + plain backward) is
  held against autograd through :func:`dense_attention`: 1e-5 max-abs.
* The remat policies of ``models/llama.py``: the same loss and gradients
  under every policy, and under ``attn_out``/``qkv`` the flash forward
  runs once per layer — never again in the backward — while ``nothing``
  re-runs it.

The CUDA kernels themselves are held against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_nexus.ops.flash_attention as jax_flash
import tpu_nexus_torch.models.llama as port_llama
import tpu_nexus_torch.ops.flash_attention as port_flash
from tpu_nexus_torch.ops.attention import dense_attention
from tpu_nexus_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_differentiable,
    flash_dsum,
)

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    )


def _against_pallas(s, hq, hkv, causal, seed, dtype=np.float32):
    """(port grads, JAX grads) as numpy f32, from the same inputs and the
    same Pallas forward residuals."""
    q, k, v, do = _inputs(1, s, hq, hkv, 128, seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    scale = 128**-0.5
    out, lse = jax_flash._flash_forward(jq, jk, jv, scale, causal, True)
    ref = jax_flash._flash_backward(jq, jk, jv, out, lse, jdo, scale, causal, True)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    t_out = torch.from_numpy(np.swapaxes(np.asarray(out.astype(jnp.float32)), 1, 2).copy()).to(tdt)
    t_lse = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    got = flash_attention_bwd_plain(tq, tk, tv, t_out, t_lse, tdo, causal=causal)
    return [g.float().numpy() for g in got], [np.asarray(r.astype(jnp.float32)) for r in ref]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)], ids=["gqa1", "gqa2"])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_backward_matches_pallas(s, hq, hkv, causal):
    got, ref = _against_pallas(s, hq, hkv, causal, seed=s + 10 * hq + causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_across_tiles(monkeypatch, causal):
    """S 512 with the Pallas tiles cut to 128: four Q and four KV tiles, the
    causal diagonal band, and the dK/dV accumulation across Q tiles."""
    monkeypatch.setattr(jax_flash, "BLOCK_Q", 128)
    monkeypatch.setattr(jax_flash, "BLOCK_K", 128)
    got, ref = _against_pallas(512, 4, 2, causal, seed=7 + causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=0)


def test_bf16_plain_backward_rounds_like_the_kernels():
    """bf16 inputs: the plain version rounds q̃, P and dS to bf16 where the
    Pallas kernels do — it agrees with them at bf16 resolution (2e-2
    max-abs on gradients of magnitude ~1)."""
    got, ref = _against_pallas(128, 4, 2, True, seed=3, dtype="bfloat16")
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(128, 128), (200, 64)])
def test_flash_attention_function_matches_dense_autograd(s, d, causal):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, s, 4, 2, d, seed=s + d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_differentiable(*leaves, causal=causal)
    ref = dense_attention(*ref_leaves, causal=causal)
    out.backward(do)
    ref.backward(do)
    assert torch.allclose(out, ref, atol=TOL, rtol=0)
    for a, r in zip(leaves, ref_leaves):
        assert float((a.grad - r.grad).abs().max()) <= TOL


def test_cpu_wrappers_take_the_plain_parts_and_launch_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 64, 4, 2, 128, seed=5))
    out, lse = port_flash.flash_attention(q, k, v)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dsum = flash_dsum(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do)
    for a, r in zip((dq, dk, dv), ref):
        assert torch.equal(a, r)
    for a, r in zip(flash_attention_bwd(q, k, v, out, lse, do), ref):
        assert torch.equal(a, r)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before


def test_non_cpu_tensors_go_to_the_backward_kernels_or_raise():
    """A tensor on any device but the CPU reaches the kernel wrappers, which
    launch or raise — here ``meta`` tensors, which they do not take."""
    q = torch.empty(1, 64, 4, 128, device="meta")
    k = v = torch.empty(1, 64, 2, 128, device="meta")
    lse = dsum = torch.empty(1, 4, 64, device="meta")
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="backward kernels unsupported"):
        flash_attention_bwd_dq(q, k, v, q, lse, dsum)
    with pytest.raises(ValueError, match="backward kernels unsupported"):
        flash_attention_bwd_dkv(q, k, v, q, lse, dsum)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == before


def test_function_runs_without_grad_for_serving():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 32, 4, 2, 128, seed=9))
    with torch.inference_mode():
        out = FlashAttention.apply(q, k, v, True, 128**-0.5)
    assert torch.equal(out, port_flash.flash_attention_plain(q, k, v)[0])


def test_remat_policies_agree_and_attn_out_never_reruns_the_flash_forward(monkeypatch):
    """The model's attention routed through :class:`FlashAttention` on the
    CPU (the card's route): every policy gives the same loss and
    gradients; the flash forward runs once per layer under dots, attn_out
    and qkv, and twice under nothing (its recompute re-runs it)."""
    calls = {"n": 0}
    plain = port_flash.flash_attention_plain

    def counting(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(port_flash, "flash_attention_plain", counting)
    monkeypatch.setattr(
        port_llama, "attention",
        lambda q, k, v, causal=True, impl="auto": flash_attention_differentiable(q, k, v, causal=causal),
    )
    base = port_llama.LlamaConfig(
        vocab_size=128, hidden=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16,
        intermediate=96, max_seq_len=64, dtype=torch.float32,
    )
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 24)))
    runs = {}
    for policy in port_llama.REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat_policy=policy)
        params = port_llama.llama_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        leaves = [p for n, p in sorted(params.named_parameters()) if n != "lm_head"]
        calls["n"] = 0
        loss = port_llama.llama_hidden(params, tokens, cfg).square().mean()
        grads = torch.autograd.grad(loss, leaves)
        runs[policy] = (calls["n"], loss.detach(), grads)
    assert {p: n for p, (n, _, _) in runs.items()} == {"dots": 3, "attn_out": 3, "qkv": 3, "nothing": 6}
    _, loss0, grads0 = runs["dots"]
    for policy, (_, loss, grads) in runs.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), policy
    with pytest.raises(ValueError, match="remat_policy"):
        cfg = dataclasses.replace(base, remat_policy="everything")
        params = port_llama.llama_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        port_llama.llama_hidden(params, tokens, cfg)
