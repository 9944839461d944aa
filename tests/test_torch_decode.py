"""The port's decode attention against the JAX package.

``tpu_nexus_torch.models.generate.cached_attention`` (its default
dispatch, which runs the plain version on a CPU tensor) against
``tpu_nexus.models.generate.cached_attention`` — with ``impl="pallas"``
(the decode kernel in interpret mode) for a few cases and ``impl="xla"``
for the matrix: uniform, ragged (``prompt_lengths``/``prompt_width``),
per-slot lens/width, q_len 1, 2 and 8, unaligned ``max_len``.  Inputs come
from numpy with a seed.  Tolerance: f32, 2e-5 max-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models.generate import cached_attention as jax_cached_attention
from tpu_nexus_torch.models.generate import cached_attention
from tpu_nexus_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    split_plan,
)

torch.set_num_threads(1)
TOL = 2e-5


def _case(b, sq, max_len, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, hq, d), dtype=np.float32),
        rng.standard_normal((b, max_len, hkv, d), dtype=np.float32),
        rng.standard_normal((b, max_len, hkv, d), dtype=np.float32),
    )


def _modes(mode, b, max_len, kv_len, seed):
    """(prompt_lengths numpy | None, prompt_width | None, kv_len) per mode."""
    rng = np.random.default_rng(seed + 1)
    if mode == "uniform":
        return None, None, kv_len
    if mode == "ragged":
        width = max_len // 2
        return rng.integers(1, width + 1, size=b).astype(np.int32), width, kv_len
    # per-slot: row b attends [0, pos[b]]; the generated-tail window is
    # pushed past the cache end (width = max_len), kv_len = max(pos) + 1
    pos = rng.integers(0, max_len, size=b).astype(np.int32)
    return pos + 1, max_len, int(pos.max()) + 1


def _both(q, k, v, lens, width, kv_len, jax_impl, port_impl="auto"):
    ref = jax_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len, jnp.int32),
        prompt_lengths=None if lens is None else jnp.asarray(lens),
        prompt_width=width, impl=jax_impl,
    )
    out = cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len,
        prompt_lengths=None if lens is None else torch.from_numpy(lens),
        prompt_width=width, impl=port_impl,
    )
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize(
    "mode,sq", [("uniform", 1), ("ragged", 2), ("per_slot", 1), ("uniform", 8)]
)
def test_plain_matches_pallas_interpret(mode, sq):
    b, max_len = 2, 45
    q, k, v = _case(b, sq, max_len, 4, 2, 128, seed=sq * 7)
    lens, width, kv_len = _modes(mode, b, max_len, 40, seed=3)
    ref, out = _both(q, k, v, lens, width, kv_len, "pallas", "plain")
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


#: (mode, q_len): per-slot decode is q_len 1 by contract
_MATRIX = [(m, sq) for m in ("uniform", "ragged") for sq in (1, 2, 8)] + [("per_slot", 1)]


@pytest.mark.parametrize("max_len", [37, 64])
@pytest.mark.parametrize("mode,sq", _MATRIX)
def test_matches_xla_matrix(mode, sq, max_len):
    b = 3
    q, k, v = _case(b, sq, max_len, 8, 2, 16, seed=max_len + sq)
    kv_len = max_len - 5
    lens, width, kv_len = _modes(mode, b, max_len, kv_len, seed=sq)
    if mode == "ragged":
        kv_len = max(kv_len, width + sq)  # the query block sits past the pad
    ref, out = _both(q, k, v, lens, width, kv_len, "xla")
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_cpu_wrapper_launches_nothing_and_unported_modes_raise():
    q, k, v = (torch.from_numpy(x) for x in _case(2, 1, 20, 4, 2, 16, seed=1))
    before = decode_attention.launches
    assert torch.equal(decode_attention(q, k, v, 10), decode_attention_plain(q, k, v, 10))
    assert torch.equal(cached_attention(q, k, v, 10), decode_attention_plain(q, k, v, 10))
    assert torch.equal(cached_attention(q, k, v, 10, impl="plain"), decode_attention_plain(q, k, v, 10))
    assert decode_attention.launches == before
    with pytest.raises(ValueError, match="unknown decode impl"):
        cached_attention(q, k, v, 10, impl="kernel")
    for kw in (
        dict(block_tables=torch.zeros(2, 5, dtype=torch.int32)),
        dict(q_starts=torch.zeros(2, dtype=torch.int32)),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            decode_attention(q, k, v, 10, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            cached_attention(q, k, v, 10, impl="plain", **kw)


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """Only a CPU tensor takes the plain path: a tensor on any other device
    reaches the wrapper, which launches the kernel or raises — here a
    ``meta`` tensor, which the kernel does not take."""
    q = torch.empty(2, 1, 32, 128, device="meta")
    k = v = torch.empty(2, 64, 8, 128, device="meta")
    before = decode_attention.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cached_attention(q, k, v, 10)
    assert decode_attention.launches == before


@pytest.mark.parametrize(
    "b,hkv,live", [(8, 8, 144), (8, 8, 4096), (1, 8, 100), (64, 8, 4), (2, 2, 1)]
)
def test_split_plan_covers_the_live_prefix(b, hkv, live):
    split_len, n_splits = split_plan(b, hkv, live)
    assert split_len % 32 == 0
    assert (n_splits - 1) * split_len < live <= n_splits * split_len
