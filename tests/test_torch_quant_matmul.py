"""The port's dequant-matmul and int8-KV decode attention against the JAX package.

* ``quant_matmul_plain`` (the CUDA kernels' plain version, which the
  wrapper runs on a CPU tensor) against ``tpu_nexus.ops.quant_matmul.
  quant_matmul`` in Pallas interpret mode, as ``tests/test_quant_kernels.py``
  runs it: the same ``x``, ``q`` and ``s`` (quantized once by the JAX
  package, carried as numpy), int8 and int4, one K block and several.
  Tolerance: f32 1e-5 x max|ref|, bf16 2e-2 x max|ref| (max-abs).
* ``weight_einsum``: a plain tensor is bit-identical to ``torch.einsum``;
  a quantized weight on the CPU takes dequantize-then-einsum, the
  reference's path outside its kernels; the validation messages.
* ``decode_attention_plain`` with scales against the reference's
  ``decode_attention`` in interpret mode and its XLA path: uniform, ragged
  and q_len 4; f32 1e-5, bf16 2e-2 (max-abs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.models import quant as jq
from tpu_nexus.models.generate import _quantize_kv as jax_quantize_kv
from tpu_nexus.models.generate import cached_attention as jax_cached_attention
from tpu_nexus.ops import quant_matmul as jax_qmm
from tpu_nexus_torch.models.generate import _quantize_kv, cached_attention
from tpu_nexus_torch.models.quant import quantize_tensor, quantize_tensor_int4
from tpu_nexus_torch.ops import quant_matmul as port_qmm
from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tpu_nexus_torch.ops.qtensor import QTensor, QTensor4, _unpack_nibbles

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_to_torch(a):
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _to_torch(a):
    a = np.array(a)
    return _bf16_to_torch(a) if a.dtype.name == "bfloat16" else torch.from_numpy(a)


def _pair(k, n, mode, group, seed):
    """(JAX quantized weight, the same q and s as the port's class)."""
    w = jnp.asarray(_rand((k, n), seed, scale=k**-0.5))
    if mode == "int8":
        jw = jq.quantize_tensor(w, (-2,))
        return jw, QTensor(_to_torch(jw.q), _to_torch(jw.s))
    jw = jq.quantize_tensor_int4(w, (-2,), group, name="w")
    return jw, QTensor4(_to_torch(jw.q), _to_torch(jw.s), jw.contract_shape, jw.out_shape, jw.group)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "mode,group,m,k,n,block_k",
    [
        ("int8", 0, 4, 64, 128, 64),     # one K block
        ("int8", 0, 8, 256, 128, 64),    # four K blocks
        ("int4", 16, 4, 64, 128, 64),
        ("int4", 32, 8, 256, 128, 64),
        ("int4", 2, 3, 128, 64, 32),
        ("int4", 48, 2, 96, 64, 64),     # a block that splits a group clamps to K
    ],
)
def test_plain_matches_pallas_interpret(mode, group, m, k, n, block_k, dtype):
    jw, pw = _pair(k, n, mode, group, seed=k + n + group)
    x = jnp.asarray(_rand((m, k), seed=m)).astype(dtype)
    ref = np.asarray(
        jax_qmm.quant_matmul(x, jw, block_k=block_k, block_n=64, interpret=True).astype(jnp.float32)
    )
    xt = _to_torch(x)
    out = port_qmm.quant_matmul_plain(xt, pw)
    assert out.dtype == xt.dtype and out.shape == (m, n)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype] * np.abs(ref).max(), rtol=0)
    before = (port_qmm.quant_matmul.launches_int8, port_qmm.quant_matmul.launches_int4)
    assert torch.equal(port_qmm.quant_matmul(xt, pw), out)  # the wrapper on a CPU tensor
    assert (port_qmm.quant_matmul.launches_int8, port_qmm.quant_matmul.launches_int4) == before


def test_int4_rounds_the_dequantized_weight_to_the_activation_dtype():
    """bf16: the kernel's order is dequant in f32, ROUND to bf16, then the
    product — an f32 dequant that is never rounded gives other numbers."""
    _, pw = _pair(128, 64, "int4", 32, seed=9)
    x = torch.from_numpy(_rand((4, 128), seed=1)).to(torch.bfloat16)
    rounded = (x.float() @ pw.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(port_qmm.quant_matmul_plain(x, pw), rounded)
    unrounded = (x.float() @ pw.to(torch.float32)).to(torch.bfloat16)
    assert not torch.equal(unrounded, rounded)


def test_weight_einsum_on_a_plain_tensor_is_bit_identical_to_einsum():
    x, w = torch.from_numpy(_rand((2, 8, 64), 0)), torch.from_numpy(_rand((64, 128), 1))
    assert torch.equal(port_qmm.weight_einsum("bse,ef->bsf", x, w, torch.float32), torch.einsum("bse,ef->bsf", x, w))
    w4 = torch.from_numpy(_rand((64, 4, 16), 2))
    xb = x.to(torch.bfloat16)  # the models hand activations over in the compute dtype
    out = port_qmm.weight_einsum("bse,ehd->bshd", xb, w4, torch.bfloat16)
    assert torch.equal(out, torch.einsum("bse,ehd->bshd", xb, w4.to(torch.bfloat16)))


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 16)])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_weight_einsum_on_the_cpu_matches_the_reference_fallback(mode, group, impl):
    jw, pw = _pair(64, 128, mode, group, seed=4)
    x = _rand((2, 4, 64), 5)
    assert not port_qmm.quant_matmul_supported(torch.from_numpy(x), pw)  # a CPU tensor
    ref = np.asarray(jax_qmm.weight_einsum("bse,ef->bsf", jnp.asarray(x), jw, jnp.float32, impl="xla"))
    out = port_qmm.weight_einsum("bse,ef->bsf", torch.from_numpy(x), pw, torch.float32, impl=impl)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    kernel_order = port_qmm.quant_matmul_plain(torch.from_numpy(x).reshape(8, 64), pw).reshape(2, 4, 128)
    np.testing.assert_allclose(kernel_order.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_geometry_reads_stacked_and_multi_dim_weights():
    w = torch.from_numpy(_rand((3, 4, 16, 64), 6))  # [L, H, D, E]: wo
    q8 = quantize_tensor(w, (-3, -2))
    assert port_qmm._geometry(q8) == ((3,), (4, 16), (64,))
    assert port_qmm._geometry(q8[1]) == ((), (4, 16), (64,))
    q4 = quantize_tensor_int4(w, (-3, -2), 16, name="wo")
    assert port_qmm._geometry(q4) == ((3,), (4, 16), (64,))
    assert port_qmm._geometry(q4[0]) == ((), (4, 16), (64,))
    jq8 = jq.quantize_tensor(jnp.asarray(w.numpy()), (-3, -2))
    assert tuple(map(tuple, jax_qmm._geometry(jq8))) == port_qmm._geometry(q8)


def test_validation_names_every_violated_clause():
    _, qt = _pair(64, 128, "int8", 0, seed=1)
    with pytest.raises(ValueError, match="x K 32 != weight contraction width 64"):
        port_qmm.quant_matmul(torch.zeros(4, 32), qt)
    with pytest.raises(ValueError, match="must be 2D"):
        port_qmm.quant_matmul(torch.zeros(2, 4, 64), qt)
    with pytest.raises(ValueError, match=f"MAX_FUSED_M {port_qmm.MAX_FUSED_M}"):
        port_qmm.quant_matmul(torch.zeros(port_qmm.MAX_FUSED_M + 1, 64), qt)
    assert port_qmm.MAX_FUSED_M == jax_qmm.MAX_FUSED_M
    stacked = QTensor(torch.zeros(2, 64, 32, dtype=torch.int8), torch.ones(2, 1, 32))
    with pytest.raises(ValueError, match="lead dims.*x K 32 != weight contraction width 64"):
        port_qmm.quant_matmul(torch.zeros(4, 32), stacked)  # two clauses, both named
    with pytest.raises(TypeError, match="QTensor"):
        port_qmm.quant_matmul(torch.zeros(4, 64), torch.zeros(64, 128))
    # lead dims take the dequantize-then-einsum path in weight_einsum
    x = torch.from_numpy(_rand((2, 5, 64), 3))
    out = port_qmm.weight_einsum("lbk,lkn->lbn", x, stacked, torch.float32)
    assert out.shape == (2, 5, 32)


def test_impl_and_env_are_validated(monkeypatch):
    _, qt = _pair(64, 128, "int8", 0, seed=1)
    x = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="weight_einsum impl"):
        port_qmm.weight_einsum("bse,ef->bsf", x, torch.zeros(64, 128), torch.float32, impl="cuda")
    monkeypatch.setenv("NEXUS_QUANT_KERNEL", "triton")
    with pytest.raises(ValueError, match="NEXUS_QUANT_KERNEL"):
        port_qmm.weight_einsum("bse,ef->bsf", x, qt, torch.float32)
    # an explicit impl wins over the environment; a plain tensor never reads it
    port_qmm.weight_einsum("bse,ef->bsf", x, qt, torch.float32, impl="plain")
    port_qmm.weight_einsum("bse,ef->bsf", x, torch.zeros(64, 128), torch.float32)
    monkeypatch.setenv("NEXUS_QUANT_KERNEL", "plain")
    port_qmm.weight_einsum("bse,ef->bsf", x, qt, torch.float32)


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device reaches the launch path, which raises on what the kernel does
    not take — here ``meta`` tensors."""
    qt = QTensor(torch.zeros(64, 128, dtype=torch.int8, device="meta"), torch.ones(1, 128, device="meta"))
    before = port_qmm.quant_matmul.launches_int8
    with pytest.raises(ValueError, match="needs both on one CUDA device"):
        port_qmm.quant_matmul(torch.zeros(4, 64, device="meta"), qt)
    assert port_qmm.quant_matmul.launches_int8 == before


@pytest.mark.parametrize(
    "rows,n,m", [(4096, 14336, 8), (4096, 1024, 8), (14336, 4096, 8), (2048, 4096, 1), (4096, 4096, 256), (100, 70, 3)]
)
def test_split_plan_covers_every_row_in_whole_tiles(rows, n, m):
    rows_per_split, n_splits = port_qmm.split_plan(rows, n, m)
    assert rows_per_split % port_qmm.TILE_ROWS == 0
    assert (n_splits - 1) * rows_per_split < rows <= n_splits * rows_per_split
    # the grid stays within one wave of resident CTAs where the strips alone do
    strips = -(-n // port_qmm.COLS) * -(-m // port_qmm.ROWS_M)
    assert strips * n_splits <= max(port_qmm.TARGET_CTAS, strips)


# -- the int4 ring kernel's plan (bf16 activations) -------------------------------

RING_SHAPES = [  # (packed rows, N, M): the Llama-3-8B decode step's four launches, M 1/40/256, edges
    (2048, 14336, 8), (7168, 4096, 8), (2048, 4096, 8), (2048, 1024, 8),
    (2048, 14336, 40), (2048, 4096, 256), (2048, 4096, 1), (32, 16, 3), (96, 400, 9),
]


@pytest.mark.parametrize("grid", [264, 132, 7, 1, None])
@pytest.mark.parametrize("rows,n,m", RING_SHAPES)
def test_int4_partition_covers_every_unit_once_in_a_fixed_merge_order(rows, n, m, grid):
    """Every (strip, M chunk, packed row) is in exactly one CTA's run; a
    tile's runs are listed in CTA order with their rows in k order (the
    merge order, the same every launch); a workspace slot holds one partial;
    the runs differ by at most one unit (even bytes per CTA); and each run
    is owned, unit by unit, by the CTA the kernel's ``run_owner`` names."""
    units, planned = port_qmm.int4_plan(rows, n, m, resident=264)
    grid = planned if grid is None else min(grid, units)
    assert 1 <= planned <= min(units, 264)
    tiles = port_qmm.int4_partition(rows, n, m, grid)
    n_tiles = -(-n // port_qmm.COLS) * -(-m // port_qmm.ROWS_M)
    n_kb = -(-rows // port_qmm.RING_ROWS)
    assert sorted(tiles) == list(range(n_tiles)) and n_tiles * n_kb == units
    slots, per_cta = set(), {}
    for tile, runs in tiles.items():
        assert [c for c, _, _, _ in runs] == sorted({c for c, _, _, _ in runs})
        covered = 0
        for c, slot, r0, r1 in runs:
            assert r0 == covered and r1 > r0  # contiguous, in k order, no overlap
            covered = r1
            kb0, kb1 = r0 // port_qmm.RING_ROWS, -(-r1 // port_qmm.RING_ROWS)
            per_cta[c] = per_cta.get(c, 0) + kb1 - kb0
            for u in range(tile * n_kb + kb0, tile * n_kb + kb1):
                assert ((u + 1) * grid - 1) // units == c
            if len(runs) > 1:
                assert (c, slot) not in slots
                slots.add((c, slot))
        assert covered == rows
    assert sorted(per_cta) == list(range(grid))
    assert max(per_cta.values()) - min(per_cta.values()) <= 1
    assert sum(per_cta.values()) == units


@pytest.mark.parametrize("rows,n,m", RING_SHAPES)
def test_int4_plan_keeps_runs_inside_tiles_when_tiles_are_few(rows, n, m):
    """With fewer tiles than resident CTAs, every tile is cut into equal
    runs that divide its stages: no run straddles two tiles, so a CTA
    merges at most one; with more, the runs cover every resident CTA."""
    resident = 132
    tiles = -(-n // port_qmm.COLS) * -(-m // port_qmm.ROWS_M)
    units, grid = port_qmm.int4_plan(rows, n, m, resident)
    parts = port_qmm.int4_partition(rows, n, m, grid)
    runs_per_cta = {}
    for runs in parts.values():
        for c, _, _, _ in runs:
            runs_per_cta[c] = runs_per_cta.get(c, 0) + 1
    if tiles < resident:
        assert grid % tiles == 0 and grid <= resident and units % grid == 0
        assert max(runs_per_cta.values()) == 1
        assert {len(runs) for runs in parts.values()} == {grid // tiles}
    else:
        assert grid == min(resident, units // port_qmm.MIN_RING_UNITS)


@pytest.mark.parametrize("group", [16, 32, 48, 64, 80, 96, 128, 192, 256, 4096, 14336])
def test_int4_scale_rows_cover_every_stage(group):
    """The scale box a stage stages holds every group its 64 packed rows
    touch, and for the groups that divide or are divided by a stage's rows
    not one row more (the box's bytes are read)."""
    hg, rows = group // 2, 40 * group
    touched = max(
        len({r // hg for r in range(kb * port_qmm.RING_ROWS, min((kb + 1) * port_qmm.RING_ROWS, rows))})
        for kb in range(-(-rows // port_qmm.RING_ROWS))
    )
    assert touched <= port_qmm.int4_scale_rows(group) <= port_qmm.RING_SCALE_ROWS
    if port_qmm.RING_ROWS % hg == 0 or hg % port_qmm.RING_ROWS == 0:
        assert port_qmm.int4_scale_rows(group) == touched


def _divide(n, d):
    """The kernel's ``Divider``: n / d by a multiply-high and a shift."""
    shift = (d - 1).bit_length()
    mul = ((((1 << shift) - d) << 32) // d + 1) & 0xFFFFFFFF
    return (((n * mul) >> 32) + n) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 12, 24, 256, 896, 1000, 2**20 + 7, 2**27])
def test_the_kernels_group_divider_is_exact(d):
    rng = np.random.default_rng(d)
    edges = [q * d + e for q in range(0, 2**31 // d, max(1, 2**31 // d // 64)) for e in (-1, 0, 1)]
    ns = np.concatenate([np.arange(0, 1024), rng.integers(0, 2**31 - 1, 2000), [2**31 - 1], edges])
    ns = ns[(ns >= 0) & (ns < 2**31)]
    for n in ns.tolist():
        assert _divide(n, d) == n // d


def test_int4_bit_decode_reproduces_the_plain_values():
    """A numpy model of the ring kernel's decode over all 256 byte values:
    each 32-bit word's nibbles made offset-binary ((w & 0x0F0F0F0F) ^
    0x08080808, the high ones shifted down first), a byte permuted into
    the mantissa of 2^23 (0x4B000000 | u), 2^23 + 8 subtracted in f32, then
    the product with the scale formed exactly in f64 and rounded once to
    f32.  It reproduces ``_unpack_nibbles`` and the f32 ``n * s`` of
    ``quant_matmul_plain`` bit for bit, and so does the FFMA form
    ``u * s - 8 s`` (u = the float minus 2^23) rounded once; bf16
    activations then round that value to bf16."""
    rng = np.random.default_rng(0)
    raw = np.arange(256, dtype=np.uint8)
    words = raw.view(np.uint32)
    u = {}
    for half, shifted in (("lo", words), ("hi", words >> np.uint32(4))):
        nib = (shifted & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
        per_byte = np.stack([(nib >> np.uint32(8 * j)) & np.uint32(0xFF) for j in range(4)], axis=1).reshape(-1)
        u[half] = (np.uint32(0x4B000000) | per_byte).view(np.float32)  # 2^23 + n + 8, exactly
    n_lo, n_hi = (u[h] - np.float32(8388616.0) for h in ("lo", "hi"))
    packed = torch.from_numpy(raw.view(np.int8).reshape(1, 256))
    ref = _unpack_nibbles(packed, 2)  # [2, 256]: row 0 the low nibbles, row 1 the high ones
    np.testing.assert_array_equal(n_lo, ref[0].numpy().astype(np.float32))
    np.testing.assert_array_equal(n_hi, ref[1].numpy().astype(np.float32))

    s = (np.abs(rng.standard_normal(256)) * np.float32(10.0) ** rng.integers(-30, 30, 256)).astype(np.float32)
    w = QTensor4(packed, torch.from_numpy(s.reshape(1, 256)), (2,), (256,), 2)
    for dtype in (torch.float32, torch.bfloat16):
        eye = torch.eye(2, dtype=dtype)  # y rows = the dequantized weight rows, in x's dtype
        plain = port_qmm.quant_matmul_plain(eye, w)
        for row, n in enumerate((n_lo, n_hi)):
            fmul = (n.astype(np.float64) * s.astype(np.float64)).astype(np.float32)
            fma = ((u["lo" if row == 0 else "hi"] - np.float32(2**23)).astype(np.float64) * s
                   - 8.0 * s.astype(np.float64)).astype(np.float32)
            np.testing.assert_array_equal(fmul, fma)
            assert torch.equal(torch.from_numpy(fmul).to(dtype), plain[row])


def test_int4_ring_route_names_the_pitch_branch():
    """bf16 int4 shapes the ring kernel takes (N and the group multiples of
    16, 16-byte-aligned operands) and the ones that go to the first design."""
    x = torch.zeros(8, 4096, dtype=torch.bfloat16)

    def route(n, group, x=x):
        q, s = torch.zeros(2048, n, dtype=torch.int8), torch.zeros(4096 // group, n)
        return port_qmm.int4_ring_route(x, q, s, n, group)

    assert route(14336, 64) and route(1024, 4096) and route(4096, 16)
    assert not route(200, 64) and not route(71, 128)  # the 16-byte row pitch
    assert not route(1024, 2) and not route(1024, 8)  # a k block across groups
    assert not route(1024, 64, x=torch.zeros(8 * 4096 + 1, dtype=torch.bfloat16)[1:].view(8, 4096))


# -- decode attention, int8-KV mode ---------------------------------------------


def _kv_case(b, sq, max_len, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((b, sq, hq, d), dtype=np.float32)).astype(dtype)
    k = jnp.asarray(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32)).astype(dtype)
    v = jnp.asarray(rng.standard_normal((b, max_len, hkv, d), dtype=np.float32)).astype(dtype)
    (k8, ks), (v8, vs) = jax_quantize_kv(k), jax_quantize_kv(v)
    return q, k, v, k8, v8, ks, vs


def test_quantize_kv_is_bit_identical():
    _, k, _, k8, _, ks, _ = _kv_case(2, 1, 12, 4, 2, 16, "float32", seed=0)
    pk8, pks = _quantize_kv(_to_torch(k))
    np.testing.assert_array_equal(pk8.numpy(), np.asarray(k8))
    np.testing.assert_array_equal(pks.numpy(), np.asarray(ks))
    assert pks.shape == (2, 12, 2, 1) and pks.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("mode,sq", [("uniform", 1), ("ragged", 1), ("uniform", 4), ("ragged", 4)])
def test_int8kv_plain_matches_the_reference(mode, sq, jax_impl, dtype):
    b, max_len, kv_len = 2, 45, 40
    q, _, _, k8, v8, ks, vs = _kv_case(b, sq, max_len, 4, 2, 128, dtype, seed=sq * 7 + len(mode))
    lens = width = None
    if mode == "ragged":
        width = 20
        lens = np.array([20, 7], dtype=np.int32)
    ref = jax_cached_attention(
        q, k8, v8, jnp.asarray(kv_len, jnp.int32),
        prompt_lengths=None if lens is None else jnp.asarray(lens), prompt_width=width,
        k_scale=ks, v_scale=vs, impl=jax_impl,
    )
    args = (_to_torch(q), _to_torch(k8), _to_torch(v8), kv_len,
            None if lens is None else torch.from_numpy(lens), width, _to_torch(ks), _to_torch(vs))
    out = decode_attention_plain(*args)
    assert out.dtype == args[0].dtype
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=TOL[dtype], rtol=0
    )
    before = (decode_attention.launches, dict(decode_attention.launches_by_mode))
    assert torch.equal(decode_attention(*args), out)  # the wrapper on CPU tensors
    assert torch.equal(cached_attention(*args), out)
    assert torch.equal(cached_attention(*args, impl="plain"), out)
    assert (decode_attention.launches, dict(decode_attention.launches_by_mode)) == before


def test_int8kv_is_close_to_the_unquantized_cache():
    q, k, v, k8, v8, ks, vs = _kv_case(2, 1, 32, 4, 2, 64, "float32", seed=3)
    exact = decode_attention_plain(_to_torch(q), _to_torch(k), _to_torch(v), 30)
    quant = decode_attention_plain(_to_torch(q), _to_torch(k8), _to_torch(v8), 30, None, None,
                                   _to_torch(ks), _to_torch(vs))
    assert float((exact - quant).abs().max()) < 5e-2


def test_int8kv_needs_both_scales_of_the_cache_shape():
    q, _, _, k8, v8, ks, vs = (_to_torch(a) for a in _kv_case(2, 1, 20, 4, 2, 16, "float32", seed=1))
    for fn in (decode_attention, decode_attention_plain):
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            fn(q, k8, v8, 10, None, None, ks, None)
        with pytest.raises(ValueError, match="must be"):
            fn(q, k8, v8, 10, None, None, ks[:, :5], vs)
