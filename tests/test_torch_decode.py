"""The port's decode attention against the JAX package.

``tpu_nexus_torch.models.generate.cached_attention`` (its default
dispatch, which runs the plain version on a CPU tensor) against
``tpu_nexus.models.generate.cached_attention`` — with ``impl="pallas"``
(the decode kernel in interpret mode) for a few cases and ``impl="xla"``
for the matrix: uniform, ragged (``prompt_lengths``/``prompt_width``),
per-slot lens/width, q_len 1, 2 and 8, unaligned ``max_len``.  Inputs come
from numpy with a seed.  Tolerance: f32, 2e-5 max-abs.

The paged (``block_tables``) and ragged-q (``q_starts``) modes, alone, together
and with the int8-KV cache, in f32 and bf16: the port's plain version against
the JAX package's ``decode_attention(..., interpret=True)`` and its XLA
``cached_attention`` (pages of 4, 8 and 32, shuffled tables with a scratch
block, staggered per-row lengths, q_len 1-5, ``logical_limit``).  Limits:
f32 1e-5 max-abs (int8-KV: 1e-5 of the largest magnitude, the scores carry
the int8 values' scale), bf16 2e-2 max-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models.generate import _quantize_kv as jax_quantize_kv
from tpu_nexus.models.generate import cached_attention as jax_cached_attention
from tpu_nexus.ops.decode_attention import decode_attention as jax_decode_attention
from tpu_nexus_torch.models.generate import cached_attention
from tpu_nexus_torch.ops.decode_attention import (
    F32_TILE,
    MAX_SPLITS,
    MIN_SPLIT_TILES,
    MODES,
    TILE,
    _workspace,
    decode_attention,
    decode_attention_plain,
    f32_split_plan,
    mode_name,
    split_plan,
    workspace_layout,
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
    """A CPU tensor takes the plain version in every mode (the paged and
    q_starts modes are ported: nothing raises for them any more) and
    launches nothing; malformed tables and starts raise."""
    q, k, v = (torch.from_numpy(x) for x in _case(2, 1, 20, 4, 2, 16, seed=1))
    before = dict(decode_attention.launches_by_mode), decode_attention.launches
    assert torch.equal(decode_attention(q, k, v, 10), decode_attention_plain(q, k, v, 10))
    assert torch.equal(cached_attention(q, k, v, 10), decode_attention_plain(q, k, v, 10))
    assert torch.equal(cached_attention(q, k, v, 10, impl="plain"), decode_attention_plain(q, k, v, 10))
    with pytest.raises(ValueError, match="unknown decode impl"):
        cached_attention(q, k, v, 10, impl="kernel")
    pool_k, pool_v = k.reshape(8, 5, 2, 16), v.reshape(8, 5, 2, 16)
    tables = torch.tensor([[3, 1, 0, 0], [7, 2, 5, 6]], dtype=torch.int32)
    for kw in (dict(block_tables=tables), dict(q_starts=torch.tensor([3, 9], dtype=torch.int32))):
        kk, vv = (pool_k, pool_v) if "block_tables" in kw else (k, v)
        assert torch.equal(decode_attention(q, kk, vv, 10, **kw), decode_attention_plain(q, kk, vv, 10, **kw))
    assert (dict(decode_attention.launches_by_mode), decode_attention.launches) == before
    with pytest.raises(ValueError, match="block_tables"):
        decode_attention(q, pool_k, pool_v, 10, block_tables=tables[0])
    with pytest.raises(ValueError, match="q_starts"):
        decode_attention(q, k, v, 10, q_starts=torch.zeros(3, dtype=torch.int32))
    assert len(MODES) == 8 and mode_name(True, True, True) == "paged+ragged+int8" in MODES


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


@pytest.mark.parametrize("resident", [132, 264, 396])
@pytest.mark.parametrize(
    "b,hkv,live",
    [(8, 8, 144), (8, 8, 4096), (1, 8, 100), (64, 8, 4), (2, 2, 1), (1, 8, 4096), (1, 1, 131072), (64, 8, 4096),
     (8, 8, 448), (8, 8, 511), (8, 8, 512)],
)
def test_split_plan_covers_the_live_prefix(b, hkv, live, resident):
    """The bf16 plan: splits of whole 64-slot tiles that cover every live
    slot exactly once (split i holds [i·split_len, (i+1)·split_len)); one
    split where the b·hkv CTAs fill the card or the prefix is short (the
    serve step, B8 Hkv8 kv 144, among them); never more CTAs than the card
    holds, nor more splits than the launch merges; and a workspace of one
    counter per (b, kv head) and (m, l) and D floats per split and query
    row.  The f32 plan (unchanged) covers the prefix the same way."""
    split_len, n_splits = split_plan(b, hkv, live, resident)
    assert split_len % TILE == 0
    assert (n_splits - 1) * split_len < live <= n_splits * split_len
    assert 1 <= n_splits <= MAX_SPLITS
    if n_splits > 1:
        assert b * hkv * n_splits <= resident and split_len >= MIN_SPLIT_TILES * TILE
    if b * hkv >= resident or -(-live // TILE) < 2 * MIN_SPLIT_TILES:
        assert n_splits == 1
    if (b, hkv, live) == (8, 8, 144):
        assert (split_len, n_splits) == (192, 1)
    if (b, hkv, live, resident) == (8, 8, 4096, 264):
        assert (split_len, n_splits) == (1024, 4)  # 256 CTAs of 16 tiles
    rows, d = 4, 128
    assert workspace_layout(b, hkv, n_splits, rows, d) == dict(
        counters=b * hkv, part_ml=b * hkv * n_splits * rows * 2, part_acc=b * hkv * n_splits * rows * d)
    f32_len, f32_splits = f32_split_plan(b, hkv, live)
    assert f32_len % F32_TILE == 0
    assert (f32_splits - 1) * f32_len < live <= f32_splits * f32_len


def test_merge_workspace_keeps_zeroed_counters_before_part_ml():
    """The wrapper's workspace (one buffer per device and stream): the
    counters a merging launch uses are the words just before ``part_ml``
    and are zero; ``part_acc`` follows the (m, l) words 16-byte aligned; a
    launch that fits reuses the buffer, a larger one regrows it zeroed."""
    from tpu_nexus_torch.ops import decode_attention as mod

    cpu, stream = torch.device("cpu"), 12345
    mod._WORKSPACES.pop((cpu.index, stream), None)
    try:
        layout = workspace_layout(8, 8, 4, 5, 128)
        acc, ml = _workspace(cpu, stream, layout)
        buf, n_counters, n_parts = mod._WORKSPACES[(cpu.index, stream)]
        assert ml - buf.data_ptr() == 4 * n_counters and n_counters >= layout["counters"]
        assert acc % 16 == 0 and acc - ml >= 4 * layout["part_ml"]
        assert acc + 4 * layout["part_acc"] <= buf.data_ptr() + 4 * buf.numel()
        assert not buf[:n_counters].any()
        assert _workspace(cpu, stream, workspace_layout(8, 8, 2, 5, 128))[1] == ml  # fits: reused
        assert mod._WORKSPACES[(cpu.index, stream)][0] is buf
        bigger = workspace_layout(64, 8, 8, 64, 128)
        acc2, ml2 = _workspace(cpu, stream, bigger)
        buf2, n_counters2, _ = mod._WORKSPACES[(cpu.index, stream)]
        assert n_counters2 >= bigger["counters"] and ml2 - buf2.data_ptr() == 4 * n_counters2
        assert acc2 + 4 * bigger["part_acc"] <= buf2.data_ptr() + 4 * buf2.numel()
        assert not buf2.any()
    finally:
        mod._WORKSPACES.pop((cpu.index, stream), None)


def _paged_case(b, sq, hq, hkv, d, page, n_log, live, seed, dtype=np.float32):
    """q, a block pool [NB, page, Hkv, D] with shuffled tables (block 0 is
    the scratch block; entries past a row's live length point at it)."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_log
    phys = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    live_blocks = -(-np.asarray(live) // page)
    tables = np.where(np.arange(n_log)[None, :] < live_blocks[:, None], phys, 0).astype(np.int32)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((nb, page, hkv, d), dtype=np.float32)
    v = rng.standard_normal((nb, page, hkv, d), dtype=np.float32)
    return q, k, v, tables


def _to_torch(x, dtype):
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dtype)


#: (paged, ragged, int8) — every combination with at least one new mode
_NEW_MODES = [(p, r, i) for p in (False, True) for r in (False, True) for i in (False, True) if p or r]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("page,sq", [(4, 1), (8, 5), (32, 3)])
@pytest.mark.parametrize("paged,ragged,int8", _NEW_MODES)
def test_paged_and_ragged_modes_match_the_jax_package(paged, ragged, int8, page, sq, dtype):
    """Every paged x ragged-q x int8-KV combination: the port's plain
    version against the JAX kernel in interpret mode (its paged mode needs
    page % 32 there: smaller pages and the contiguous layout compare with
    the JAX XLA path) on the same numpy inputs."""
    b, hq, hkv, d = 3, 8, 2, 128
    n_log = 48 // page + 2
    logical = n_log * page
    starts = np.array([0, 13, logical - sq - 3], dtype=np.int32)
    q, k, v, tables = _paged_case(b, sq, hq, hkv, d, page, n_log, starts + sq, seed=page * 10 + sq)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    scales = {}
    if int8:
        (jk, jks), (jv, jvs) = jax_quantize_kv(jk), jax_quantize_kv(jv)
        scales = dict(k_scale=jks, v_scale=jvs)
    jtables = jnp.asarray(tables)
    if not paged:  # the same rows as a contiguous cache
        gather = lambda pool: pool[jtables].reshape(b, logical, *pool.shape[2:])  # noqa: E731
        jk, jv = gather(jk), gather(jv)
        scales = {n: gather(x) for n, x in scales.items()}
    kv_len = int(starts.max()) + sq
    if ragged:
        kw = dict(prompt_lengths=np.zeros(b, np.int32), prompt_width=0, q_starts=starts)
    elif sq == 1:  # per-slot decode
        kw = dict(prompt_lengths=starts + 1, prompt_width=logical)
    else:  # a shared-start extend
        kw = {}
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    bt = dict(block_tables=jtables) if paged else {}
    if paged and page % 32 == 0:
        ref = jax_decode_attention(jq, jk, jv, jnp.asarray(kv_len, jnp.int32), **scales, **bt, **jkw, interpret=True)
    else:
        ref = jax_cached_attention(jq, jk, jv, jnp.asarray(kv_len, jnp.int32), **scales, **bt, **jkw, impl="xla")
    conv = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(  # noqa: E731
        torch.int8 if x.dtype == jnp.int8 else (torch.float32 if x.dtype == jnp.float32 else tdt))
    out = cached_attention(
        conv(jq), conv(jk), conv(jv), kv_len, **{n: conv(x) for n, x in scales.items()},
        **({"block_tables": torch.from_numpy(tables)} if paged else {}), **tkw,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    err = float(np.abs(out.float().numpy() - ref).max())
    if dtype == "bf16":
        assert err <= 2e-2
    else:
        assert err <= (1e-5 * float(np.abs(ref).max()) if int8 else 1e-5)


def test_logical_limit_cuts_the_gathered_view_like_the_jax_package():
    """``logical_limit`` shortens the plain path's gathered view to the
    engine's ``max_len``: equal to the JAX XLA path at the same limit."""
    b, sq, page, n_log = 2, 1, 4, 5
    starts = np.array([6, 17], dtype=np.int32)
    q, k, v, tables = _paged_case(b, sq, 8, 2, 16, page, n_log, starts + 1, seed=3)
    kw = dict(prompt_lengths=starts + 1, prompt_width=n_log * page)
    ref = jax_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(18, jnp.int32),
        prompt_lengths=jnp.asarray(kw["prompt_lengths"]), prompt_width=kw["prompt_width"],
        block_tables=jnp.asarray(tables), logical_limit=18, impl="xla",
    )
    out = cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 18,
        prompt_lengths=torch.from_numpy(kw["prompt_lengths"]), prompt_width=kw["prompt_width"],
        block_tables=torch.from_numpy(tables), logical_limit=18,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
