"""The port's flash-attention forward against the JAX package.

The plain PyTorch version of the CUDA kernel (``tpu_nexus_torch/ops/
flash_attention.py::flash_attention_plain``) is held against the Pallas
kernel it replaces, run in interpret mode (``_flash_forward(...,
interpret=True)``), and against ``dense_attention`` at shapes the Pallas
kernel does not take.  Inputs come from numpy with a seed and travel to
both frameworks as numpy arrays.  Tolerance: f32, 1e-5 max-abs (both sides
accumulate in f32; only summation order differs).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.ops.attention import dense_attention as jax_dense_attention
from tpu_nexus.ops.flash_attention import _flash_forward
from tpu_nexus_torch.ops.attention import attention, dense_attention
from tpu_nexus_torch.ops.flash_attention import flash_attention, flash_attention_plain

torch.set_num_threads(1)
TOL = 1e-5


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, hq, d), dtype=np.float32),
        rng.standard_normal((b, s, hkv, d), dtype=np.float32),
        rng.standard_normal((b, s, hkv, d), dtype=np.float32),
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 2), (16, 2)])
@pytest.mark.parametrize("s", [128, 256, 383])
def test_plain_matches_pallas_forward(s, hq, hkv, causal):
    """GQA groups 1, 2, 4 and 8, and S 383: three of the CUDA kernel's
    128-row tiles with a ragged end (the interpret-mode kernel takes it as
    one 383-row block)."""
    q, k, v = _qkv(1, s, hq, hkv, 128, seed=s + hq * 10 + hkv + causal)
    scale = 128**-0.5
    ref_out, ref_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, True
    )
    out, lse = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    # the JAX kernel returns kernel layout [B, H, S, D] and lse [B, H, S, 1]
    np.testing.assert_allclose(
        out.numpy(), np.swapaxes(np.asarray(ref_out), 1, 2), atol=TOL, rtol=0
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0], atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [200, 64])
def test_plain_matches_dense_at_unaligned_shapes(s, d):
    q, k, v = _qkv(2, s, 4, 2, d, seed=s + d)
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out, lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert lse.shape == (2, 4, s) and torch.isfinite(lse).all()


@pytest.mark.parametrize("causal", [True, False])
def test_port_dense_matches_jax_dense(causal):
    q, k, v = _qkv(2, 96, 4, 2, 32, seed=7)
    ref = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out = dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_bf16_plain_rounds_like_the_kernel():
    """bf16 inputs: the plain version rounds the prescaled q and p to bf16
    as the Pallas kernel does — it agrees with the interpret-mode kernel at
    bf16 resolution."""
    q, k, v = _qkv(1, 128, 4, 2, 128, seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = _flash_forward(jq, jk, jv, 128**-0.5, True, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    ref = np.swapaxes(np.asarray(ref_out.astype(jnp.float32)), 1, 2)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0], atol=1e-3, rtol=0)


def test_wrapper_and_dispatch_on_cpu_take_the_plain_paths():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 4, 2, 128, seed=11))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v)
    ref_out, ref_lse = flash_attention_plain(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.launches == before  # a CPU tensor launches nothing
    assert torch.equal(attention(q, k, v, impl="auto"), dense_attention(q, k, v))
    assert torch.equal(attention(q, k, v, impl="plain"), dense_attention(q, k, v))
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="unknown attention impl"):
            attention(q, k, v, impl=impl)


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """Only a CPU tensor takes the plain path: a tensor on any other device
    reaches the wrapper, which launches the kernel or raises — here a
    ``meta`` tensor, which the kernel does not take."""
    q, k, v = (torch.empty(1, 64, 4 * h, 128, device="meta") for h in (2, 1, 1))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        attention(q, k, v)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
