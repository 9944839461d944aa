"""On-card tests of the port's CUDA kernels (``gpu`` marker).

Each kernel against its plain PyTorch version on the same seeded inputs,
at small shapes that still cover the kernels' cases (GQA, ragged tails,
D 64 and 128, ragged decode lens/width, q_len > 1; the forward at every
tiling edge of its 128-row tiles, GQA groups 1-8, bit-identical run to
run), and the backward
kernels at the shapes of ``chip_smoke.py``'s train_parity phase (every
edge of their 64- and 128-row tiles, GQA groups 1-4, D 64 and 128, causal
and full, bit-identical run to run); the int8
and int4 dequant-matmul kernels (f32 1e-4 of the reference's largest
magnitude, bf16 1e-2 on the worst row) and the decode kernel's int8-KV
mode, each bit-identical run to run; the grouped-matmul kernels (#7 gmm,
also on rhsᵀ, and #8 tgmm: f32 1e-5 of the reference's largest magnitude,
bf16 1e-2 on the worst row, bit-identical run to run) and MoE training
through them against the plain versions.  Tensor checkpoints on the card:
a bf16 train state saves and restores bit-identical, and a run resumed
from a checkpoint ends with the uninterrupted run's per-step losses, bit
for bit.  Quantized MoE: the attention projections on the dequant-matmul
kernels, token-identical to the plain path in f32; the device profiler's
trace names the decode kernel.  Sharded serving's per-rank shapes
(llama3_8b at tp 2): #5 and #6 on each rank's slices take their ring
kernels, #1 at the rank's 16/4 heads, #4's paged mode at Hkv 4.
The decode kernel (#4) in every mode runs twice and must be bit-identical:
kv 4096, q_len 8 x GQA 8 (64 query rows), GQA 1 and 8, pages 4, 16, 32 and
64, and one row whose launch merges >= 8 splits; its f32 results are held
against the plain version evaluated in f64 (at 4096 slots the plain f32
einsums are themselves up to 1.3e-4 off).
Tolerances: bf16 out 2e-2 and lse 1e-3 (max-abs) and 1e-2 on the worst
row's relative L2 error, f32 1e-5 (max-abs); bf16 gradients 2e-2 of the
reference's largest magnitude (max-abs) and 1e-2 on the worst row's
relative L2 error, row norms floored at 1e-3 of the largest (a dQ row
that cancels to ~0 has no scale of its own).  Inputs the kernels do not take raise on the card:
nothing there gives way to the plain versions.  This file imports no JAX, so it
also runs where only the port is installed (``--noconftest`` skips the
repository conftest, which sets up JAX):

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

Without a CUDA device every test skips inside the fixture.
"""

import numpy as np
import pytest
import torch

from tpu_nexus_torch.models.generate import _quantize_kv, cached_attention, generate
from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
from tpu_nexus_torch.models.quant import quantize_params, quantize_tensor, quantize_tensor_int4
from tpu_nexus_torch.ops.attention import attention
from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain, resident_ctas, split_plan
from tpu_nexus_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_differentiable,
    flash_attention_plain,
    flash_bwd_qt,
    flash_dsum,
)
from tpu_nexus_torch.ops.grouped_matmul import gmm, gmm_kernel_call, gmm_plain, tgmm_kernel_call, tgmm_plain
from tpu_nexus_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain, weight_einsum
from tpu_nexus_torch.ops.rmsnorm import rms_norm, rms_norm_kernel
from tpu_nexus_torch.workload.train import TrainConfig, init_train_state, make_train_step

torch.set_num_threads(1)
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-5, 1e-5)}
ROW_REL_TOL = 1e-2  # bf16
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device, dtype)


def _check(out, ref, dtype):
    out, ref = out.float(), ref.float()
    assert float((out - ref).abs().max()) <= TOL[dtype][0]
    if dtype == torch.bfloat16:
        rel = (out - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= ROW_REL_TOL


def _check_grad(got, ref, dtype):
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5
        return
    assert err <= 2e-2 * float(ref.abs().max())
    norms = ref.norm(dim=-1)
    rel = (got - ref).norm(dim=-1) / norms.clamp_min(1e-3 * float(norms.max()))
    assert float(rel.max()) <= ROW_REL_TOL


#: (S, D, GQA group, causal): S of one row, under, at and just over one
#: 128-row tile, ragged multi-tile ends and 16 tiles; D 64 and 128; GQA
#: groups 1-8 (Hkv 2); causal and full; and S 256 at D 64, full.
FLASH_CASES = [(256, 64, 4, False)] + [
    (s, d, group, causal)
    for s in (1, 64, 127, 128, 129, 200, 383, 2048)
    for d in (64, 128)
    for group in (1, 2, 4, 8)
    for causal in (True, False)
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,d,group,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, dtype, s, d, group, causal):
    """One launch a call, and a second run is bit-identical (no atomics)."""
    b, hkv = (1, 2) if s == 2048 else (2, 2)
    seed = s * 10 + d + group + causal
    q = _randn((b, s, hkv * group, d), seed, cuda_device, dtype)
    k = _randn((b, s, hkv, d), seed + 1, cuda_device, dtype)
    v = _randn((b, s, hkv, d), seed + 2, cuda_device, dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    again, lse_again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    _check(out, ref_out, dtype)
    assert float((lse - ref_lse).abs().max()) <= TOL[dtype][1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain_at_the_training_shape(cuda_device, dtype):
    """nexus_1b's attention in the train step: B8 S2048 Hq16 Hkv8 D128
    causal, GQA group 2."""
    q = _randn((8, 2048, 16, 128), 7, cuda_device, dtype)
    k = _randn((8, 2048, 8, 128), 8, cuda_device, dtype)
    v = _randn((8, 2048, 8, 128), 9, cuda_device, dtype)
    out, lse = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=True)
    _check(out, ref_out, dtype)
    assert float((lse - ref_lse).abs().max()) <= TOL[dtype][1]


#: (B, q_len, max_len, kv_len, ragged, Hq) against Hkv 8, D 128: the serve
#: step, ragged lens/width, kv 4096, q_len 8 x GQA 8 (64 query rows), GQA 1
#: and 8, and one row whose launch merges >= 8 splits
DECODE_CASES = [
    (4, 1, 160, 144, False, 32), (4, 4, 300, 290, True, 32), (4, 1, 4096, 3000, False, 32), (4, 8, 64, 64, False, 32),
    (4, 1, 4096, 4096, False, 32), (4, 8, 4096, 4096, False, 64), (4, 8, 160, 150, True, 64),
    (4, 1, 4096, 4000, True, 8), (4, 5, 300, 300, False, 8), (4, 1, 4096, 4096, False, 64),
    (1, 1, 4096, 4096, False, 32), (1, 4, 4096, 3001, True, 32),
]


def _decode_case(device, dtype, b, sq, max_len, kv_len, ragged, hq, int8=False):
    q = _randn((b, sq, hq, 128), 4, device, dtype)
    k = _randn((b, max_len, 8, 128), 5, device, dtype)
    v = _randn((b, max_len, 8, 128), 6, device, dtype)
    scales = ()
    if int8:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = (ks, vs)
    lens = width = None
    if ragged:
        width = max_len // 2
        lens = torch.tensor([width, 1, width // 2, width - 3][:b], dtype=torch.int32, device=device)
    return (q, k, v, kv_len, lens, width, *scales)


def _plain(*args, **kw):
    """``decode_attention_plain`` as the reference: bf16 as the kernel rounds,
    f32 evaluated in f64 — at 4096 slots the f32 einsums' own error reaches
    1.3e-4, the f32 kernel's 8.5e-6 (PERF.md)."""
    if args[0].dtype == torch.float32:
        args = [a.double() if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a for a in args]
        return decode_attention_plain(*args, **kw).float()
    return decode_attention_plain(*args, **kw)


def _check_merge(args, dtype, b, max_len, sq, int8=False):
    """One row's 8 kv heads over 4096 slots: the bf16 launch merges >= 8 splits."""
    if dtype == torch.bfloat16 and (b, max_len, sq) == (1, 4096, 1):
        q, d, rows = args[0], 128, sq * (args[0].shape[2] // 8)
        assert split_plan(b, 8, args[3], resident_ctas(q.device, d, rows, int8))[1] >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,max_len,kv_len,ragged,hq", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda_device, dtype, b, sq, max_len, kv_len, ragged, hq):
    args = _decode_case(cuda_device, dtype, b, sq, max_len, kv_len, ragged, hq)
    before = decode_attention.launches
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)
    _check_merge(args, dtype, b, max_len, sq)
    _check(out, _plain(*args), dtype)


@pytest.mark.gpu
def test_kernel_generate_is_token_identical_to_plain_in_f32(cuda_device):
    cfg = LlamaConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, dtype=torch.float32, param_dtype=torch.float32,
    )
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, size=(3, 40)).astype(np.int32)
    ).to(cuda_device)
    lens = torch.tensor([40, 23, 31], dtype=torch.int32, device=cuda_device)
    for prompt_lengths in (None, lens):
        f0, d0 = flash_attention.launches, decode_attention.launches
        out = generate(params, prompt, cfg, max_new_tokens=16, prompt_lengths=prompt_lengths)
        assert flash_attention.launches - f0 == 2 and decode_attention.launches - d0 == 2 * 15
        ref = generate(params, prompt, cfg, max_new_tokens=16, prompt_lengths=prompt_lengths,
                       attn_impl="plain", decode_kernel="plain")
        assert torch.equal(out, ref)



@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(16, torch.float32), (128, torch.float16)])
def test_inputs_the_kernels_do_not_take_raise_on_the_card(cuda_device, d, dtype):
    """head_dim 16 (the ``tiny`` presets) or fp16 on the card raise in both
    dispatchers and in ``generate``: nothing launches, nothing falls back."""
    q = _randn((2, 16, 4, d), 7, cuda_device, dtype)
    k = v = _randn((2, 16, 2, d), 8, cuda_device, dtype)
    f0, d0 = flash_attention.launches, decode_attention.launches
    with pytest.raises(ValueError, match="flash_attention kernel unsupported"):
        attention(q, k, v)
    with pytest.raises(ValueError, match="decode_attention kernel unsupported"):
        cached_attention(q[:, :1], k, v, 10)
    cfg = LlamaConfig(
        vocab_size=64, hidden=64, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=d,
        intermediate=64, max_seq_len=64, dtype=dtype, param_dtype=dtype,
    )
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)
    prompt = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="kernel unsupported"):
        generate(params, prompt, cfg, max_new_tokens=2)
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)


def _bwd_case(device, dtype, b, s, hq, hkv, d, causal, seed):
    q = _randn((b, s, hq, d), seed, device, dtype)
    k = _randn((b, s, hkv, d), seed + 1, device, dtype)
    v = _randn((b, s, hkv, d), seed + 2, device, dtype)
    dout = _randn((b, s, hq, d), seed + 3, device, dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    return q, k, v, out, lse, dout


#: (B, S, Hq, Hkv, D, causal) of the backward: chip_smoke.py's train_parity
#: shapes, and S at the edges of the bf16 kernels' 64-row streamed and
#: 128-row resident tiles at GQA groups 1, 2 and 4 (Hkv 2), D 64 and 128,
#: causal and full.
BWD_CASES = [
    (8, 2048, 16, 8, 128, True), (2, 512, 32, 8, 128, True), (2, 200, 16, 8, 128, True),
    (2, 256, 16, 8, 64, True), (2, 384, 16, 8, 128, False),
] + [
    (2, s, 2 * group, 2, d, causal)
    for s in (64, 65, 127, 129, 200)
    for group in (1, 2, 4)
    for d in (64, 128)
    for causal in (True, False)
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,causal", BWD_CASES)
def test_backward_kernels_match_plain(cuda_device, dtype, b, s, hq, hkv, d, causal):
    case = _bwd_case(cuda_device, dtype, b, s, hq, hkv, d, causal, seed=s + d + causal)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd(*case, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    for a, r in zip(got, flash_attention_bwd_plain(*case, causal=causal)):
        _check_grad(a, r, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_prescale_and_dsum_are_the_f32_expressions_on_the_card(cuda_device, dtype):
    """The backward's one-pass q̃ and dsum equal their f32 expressions bit
    for bit on the card, as on the CPU (the plain backward reads them too,
    so kernel-against-plain parity alone would not show a difference)."""
    q, _, _, out, _, dout = _bwd_case(cuda_device, dtype, 2, 384, 16, 8, 128, True, seed=41)
    for scale in (128**-0.5, 0.3):
        ref = (q.float() * (scale * 1.4426950408889634)).to(dtype)
        assert torch.equal(flash_bwd_qt(q, scale), ref)
    assert torch.equal(flash_dsum(out, dout), (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_is_bit_identical_run_to_run(cuda_device, dtype):
    case = _bwd_case(cuda_device, dtype, 4, 1024, 16, 8, 128, True, seed=21)
    first = flash_attention_bwd(*case)
    second = flash_attention_bwd(*case)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_attention_differentiates_through_the_kernels(cuda_device):
    """``ops.attention.attention`` on the card: one forward launch and one
    launch of each backward kernel, gradients equal to the kernels'
    backward on the same inputs."""
    q, k, v, _, _, dout = _bwd_case(cuda_device, torch.bfloat16, 2, 256, 16, 8, 128, True, seed=31)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (flash_attention.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    out = attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    out2, lse = flash_attention(q, k, v)
    for leaf, ref in zip(leaves, flash_attention_bwd(q, k, v, out2, lse, dout)):
        assert torch.equal(leaf.grad, ref)


@pytest.mark.gpu
def test_tiny_training_raises_on_the_card(cuda_device):
    """head_dim 16 (the default ``tiny`` preset) raises in the kernel
    wrapper on the card: training never falls back to dense attention."""
    cfg = LlamaConfig.tiny()
    tcfg = TrainConfig()
    state = init_train_state(torch.Generator(device=cuda_device).manual_seed(0), cfg, tcfg, device=cuda_device)
    tokens = torch.zeros((2, 16), dtype=torch.long, device=cuda_device)
    with pytest.raises(ValueError, match="flash_attention kernel unsupported"):
        make_train_step(cfg, tcfg)(state, tokens)
    with pytest.raises(ValueError, match="flash_attention kernel unsupported"):
        flash_attention_differentiable(*(torch.zeros((1, 8, 2, 16), device=cuda_device),) * 3)


def _quantized(device, k, n, mode, group, seed):
    w = _randn((k, n), seed, device, torch.float32) * k**-0.5
    return quantize_tensor(w, (-2,)) if mode == "int8" else quantize_tensor_int4(w, (-2,), group, name="w")


#: (mode, group, M, K, N): every mode at small and ragged shapes, and int8 at
#: the Llama-3-8B decode step's four launches (M 8) and at M 1, 40 and 256
QUANT_CASES = [
    (mode, group, m, k, n)
    for m, k, n in [(8, 4096, 1024), (1, 1024, 4096), (256, 512, 384), (5, 640, 200), (3, 384, 71),
                    (40, 4096, 14336), (256, 4096, 14336)]
    for mode, group in [("int8", 0), ("int4", 64), ("int4", 128), ("int4", 2)]
] + [("int8", 0, m, k, n) for m, k, n in [(8, 4096, 14336), (8, 14336, 4096), (8, 4096, 4096), (1, 4096, 4096),
                                          (40, 4096, 4096), (256, 4096, 4096)]] + [
    # nexus_moe's decode-step launches: wq/wo (K 1024, N 1024) and wk/wv (N 512)
    (mode, group, 8, 1024, n) for n in (1024, 512) for mode, group in [("int8", 0), ("int4", 64)]
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,group,m,k,n", QUANT_CASES)
def test_quant_matmul_kernels_match_plain(cuda_device, dtype, mode, group, m, k, n):
    """Each case twice: bit-identical, through the kernel its shape routes to
    (bf16: the ring kernels where N, K and the group are on their pitch,
    else the first design; f32: the first design), two launches counted."""
    w = _quantized(cuda_device, k, n, mode, group, seed=k + n)
    x = _randn((m, k), 11, cuda_device, dtype)
    counter = "launches_int8" if mode == "int8" else "launches_int4"
    ring = dtype == torch.bfloat16 and n % 16 == 0 and (k % 8 == 0 if mode == "int8" else group % 16 == 0)
    route = f"{mode}_{'ring' if ring else 'first_design'}"
    before, by_route = getattr(quant_matmul, counter), dict(quant_matmul.launches_by_route)
    out, again = quant_matmul(x, w), quant_matmul(x, w)
    torch.cuda.synchronize()
    assert getattr(quant_matmul, counter) == before + 2
    assert {r: c - by_route[r] for r, c in quant_matmul.launches_by_route.items() if c != by_route[r]} == {route: 2}
    assert torch.equal(out, again)
    ref = quant_matmul_plain(x, w)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        rel = (out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= ROW_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (8, 14336, 4096), (1, 1024, 4096)])
def test_int8_ring_merge_paths_agree(cuda_device, monkeypatch, m, k, n):
    """The int8 ring kernel's K split merged in a cluster's shared memory
    (clusters of up to 8 and 16 CTAs, where the card holds them) and
    through the workspace (``INT8_MAX_CLUSTER`` 1): each within the bf16
    limit of the plain version and bit-identical run to run."""
    from tpu_nexus_torch.ops import quant_matmul as qmm

    w = _quantized(cuda_device, k, n, "int8", 0, seed=k + n)
    x = _randn((m, k), 12, cuda_device, torch.bfloat16)
    ref = quant_matmul_plain(x, w).float()
    for max_cluster in (1, 8, 16):
        monkeypatch.setattr(qmm, "INT8_MAX_CLUSTER", max_cluster)
        before = quant_matmul.launches_by_route["int8_ring"]
        out, again = quant_matmul(x, w), quant_matmul(x, w)
        torch.cuda.synchronize()
        assert quant_matmul.launches_by_route["int8_ring"] == before + 2
        assert torch.equal(out, again)
        rel = (out.float() - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= ROW_REL_TOL


@pytest.mark.gpu
def test_weight_einsum_dispatch_on_the_card(cuda_device):
    """Decode-sized M launches the kernel; M over the cap, a stacked weight
    and ``impl="plain"`` take dequantize-then-einsum; an activation dtype
    the kernel does not take, or a weight left on the host, raises."""
    w = _randn((2, 256, 4, 64), 3, cuda_device, torch.float32)
    stacked = quantize_tensor(w, (-3,))
    layer = stacked[1]
    before = quant_matmul.launches_int8
    x = _randn((8, 1, 256), 4, cuda_device, torch.bfloat16)
    out = weight_einsum("bse,ehd->bshd", x, layer, torch.bfloat16)
    assert quant_matmul.launches_int8 == before + 1 and out.shape == (8, 1, 4, 64)
    assert torch.equal(out, quant_matmul(x.reshape(8, 256), layer).reshape(8, 1, 4, 64))
    # dequantize-then-einsum rounds q*s to bf16 first: close, not equal
    ref = weight_einsum("bse,ehd->bshd", x, layer, torch.bfloat16, impl="plain")
    assert quant_matmul.launches_int8 == before + 2
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())
    big = _randn((8, 40, 256), 5, cuda_device, torch.bfloat16)  # M = 320 > 256
    assert weight_einsum("bse,ehd->bshd", big, layer, torch.bfloat16).shape == (8, 40, 4, 64)
    assert weight_einsum("lbe,lehd->lbhd", big[:2], stacked, torch.bfloat16).shape == (2, 40, 4, 64)
    assert quant_matmul.launches_int8 == before + 2
    with pytest.raises(ValueError, match="the kernel takes bfloat16 or float32"):
        quant_matmul(x.reshape(8, 256).half(), layer)
    # ... and through the call site too: no quiet dequantize-then-einsum on the card
    with pytest.raises(ValueError, match="the kernel takes bfloat16 or float32"):
        weight_einsum("bse,ehd->bshd", x, layer, torch.float16)
    with pytest.raises(ValueError, match="needs both on one CUDA device"):
        weight_einsum("bse,ehd->bshd", x, quantize_tensor(w[1].cpu(), (-3,)), torch.bfloat16)
    assert quant_matmul.launches_int8 == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,max_len,kv_len,ragged,hq", DECODE_CASES)
def test_int8kv_decode_kernel_matches_plain(cuda_device, dtype, b, sq, max_len, kv_len, ragged, hq):
    args = _decode_case(cuda_device, dtype, b, sq, max_len, kv_len, ragged, hq, int8=True)
    q, k8, v8, kv_len, lens, width, ks, vs = args
    counts = lambda: (decode_attention.launches, decode_attention.launches_by_mode["contiguous+int8"])  # noqa: E731
    before = counts()
    out = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 2)
    assert torch.equal(out, again)
    _check_merge(args, dtype, b, max_len, sq, int8=True)
    ref = _plain(*args)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        _check(out, ref, dtype)
    with pytest.raises(ValueError, match="decode_attention kernel unsupported"):
        decode_attention(q, k8.float(), v8.float(), kv_len, lens, width, ks, vs)  # scales need an int8 cache


@pytest.mark.gpu
@pytest.mark.parametrize("mode,kv_quant", [("int8", "int8"), ("int4", ""), ("int4", "int8")])
def test_quantized_kernel_generate_is_token_identical_to_plain_in_f32(cuda_device, monkeypatch, mode, kv_quant):
    cfg = LlamaConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, dtype=torch.float32, param_dtype=torch.float32,
    )
    params = quantize_params(
        llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device), mode=mode
    )
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, size=(3, 40)).astype(np.int32)
    ).to(cuda_device)
    lens = torch.tensor([40, 23, 31], dtype=torch.int32, device=cuda_device)
    counter = "launches_int8" if mode == "int8" else "launches_int4"
    for prompt_lengths in (None, lens):
        monkeypatch.delenv("NEXUS_QUANT_KERNEL", raising=False)
        m0, d0 = getattr(quant_matmul, counter), decode_attention.launches_by_mode["contiguous+int8"]
        out = generate(params, prompt, cfg, max_new_tokens=16, prompt_lengths=prompt_lengths, kv_quant=kv_quant)
        # the prefill's M = 3 x 40 rows is under the cap, so it launches too: 1 + 15 passes
        assert getattr(quant_matmul, counter) - m0 == 7 * 2 * 16
        assert decode_attention.launches_by_mode["contiguous+int8"] - d0 == (2 * 15 if kv_quant else 0)
        monkeypatch.setenv("NEXUS_QUANT_KERNEL", "plain")
        ref = generate(params, prompt, cfg, max_new_tokens=16, prompt_lengths=prompt_lengths, kv_quant=kv_quant,
                       attn_impl="plain", decode_kernel="plain")
        assert getattr(quant_matmul, counter) - m0 == 7 * 2 * 16
        assert torch.equal(out, ref)



@pytest.mark.gpu
@pytest.mark.parametrize("mode,kv_quant", [("int8", "int8"), ("int4", "")])
def test_quantized_moe_generate_is_token_identical_to_plain_in_f32(cuda_device, monkeypatch, mode, kv_quant):
    """Quantized experts on the card: the attention projections take the
    dequant-matmul kernels (4 a layer a pass), the expert stacks are
    dequantized before their einsum (never a kernel launch), and the
    tokens equal the plain path's."""
    from tpu_nexus_torch.models.moe import MoeConfig, moe_init

    cfg = MoeConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128, intermediate=512,
        n_experts=4, experts_per_token=2, max_seq_len=256, remat=False, dtype=torch.float32,
        param_dtype=torch.float32,
    )
    params = quantize_params(moe_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device),
                             mode=mode)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(3, 40)).astype(np.int32))
    prompt = prompt.to(cuda_device)
    counter = "launches_int8" if mode == "int8" else "launches_int4"
    monkeypatch.delenv("NEXUS_QUANT_KERNEL", raising=False)
    m0, d0 = getattr(quant_matmul, counter), decode_attention.launches_by_mode["contiguous+int8"]
    out = generate(params, prompt, cfg, max_new_tokens=16, kv_quant=kv_quant)
    # wq, wk, wv, wo in the prefill (M 120, under the cap) and 15 decode steps, per layer
    assert getattr(quant_matmul, counter) - m0 == 4 * 2 * 16
    assert decode_attention.launches_by_mode["contiguous+int8"] - d0 == (2 * 15 if kv_quant else 0)
    monkeypatch.setenv("NEXUS_QUANT_KERNEL", "plain")
    ref = generate(params, prompt, cfg, max_new_tokens=16, kv_quant=kv_quant, attn_impl="plain",
                   decode_kernel="plain")
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_device_profiler_trace_names_a_hand_written_kernel(cuda_device, tmp_path):
    import json

    from tpu_nexus_torch.serving.tracing import DeviceProfiler

    b, max_len, hq, hkv, d = 2, 64, 8, 2, 128
    q = _randn((b, 1, hq, d), 1, cuda_device, torch.bfloat16)
    k = _randn((b, max_len, hkv, d), 2, cuda_device, torch.bfloat16)
    v = _randn((b, max_len, hkv, d), 3, cuda_device, torch.bfloat16)
    decode_attention(q, k, v, 40)  # built and warm before the window
    prof = DeviceProfiler(str(tmp_path), start_step=1, num_steps=2, cuda=True)
    for step in range(4):
        prof.tick(step)
        decode_attention(q, k, v, 40)
    prof.stop()
    assert (prof.state, prof.failures) == (DeviceProfiler.DONE, 0)
    (trace,) = tmp_path.glob("*.json")
    with open(trace) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    assert sum("decode_hopper_kernel" in name for name in kernels) == 2, kernels


# -- grouped matmul (kernels #7 and #8) -----------------------------------------

#: (M, K, N, E, block_m, tile_expert): uneven runs; an unaligned K and N; a
#: 512-row layout tile with expert 2 absent; K of one 64-deep slab and
#: under one; M of one tile (fewer work units than SMs); an unsorted map;
#: expert ids outside [0, E) (gmm writes zeros there, tgmm skips them); 300
#: experts (tgmm past its table of ranked experts)
GMM_CASES = [
    (1024, 256, 384, 4, 128, [0, 0, 0, 1, 2, 2, 3, 3]),
    (768, 200, 72, 3, 128, [0, 1, 1, 1, 2, 2]),
    (2048, 128, 256, 4, 512, [0, 1, 1, 3]),
    (1024, 64, 512, 2, 128, [0, 0, 0, 0, 1, 1, 1, 1]),
    (512, 8, 256, 2, 128, [0, 1, 1, 1]),
    (128, 1024, 2048, 1, 128, [0]),
    (1024, 256, 384, 4, 128, [2, 0, 3, 1, 0, 2, 3, 0]),
    (1024, 256, 384, 3, 128, [0, -1, 1, 3, 1, 2, 7, 0]),
    (2048, 128, 256, 300, 128, [0, 299, 5, 5, 150, 299, 0, 7, 8, 9, 10, 11, 12, 13, 14, 15]),
]


def _gmm_close(out, ref, dtype):
    """f32: max-abs within 1e-5 of the reference's largest magnitude (the
    sums differ in order only); bf16: every row's relative L2 within 1e-2."""
    out, ref = out.float(), ref.float()
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        rel = (out - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert float(rel.max()) <= ROW_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", range(len(GMM_CASES)))
def test_gmm_kernel_matches_plain(cuda_device, dtype, transpose, case):
    m, k, n, e, bm, te = GMM_CASES[case]
    lhs = _randn((m, k), case, cuda_device, dtype)
    rhs = _randn((e, n, k) if transpose else (e, k, n), case + 10, cuda_device, dtype)
    te = torch.tensor(te, dtype=torch.int32, device=cuda_device)
    before = gmm_kernel_call.launches
    out = gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose)
    again = gmm_kernel_call(lhs, rhs, te, bm, transpose_rhs=transpose)
    torch.cuda.synchronize()
    assert gmm_kernel_call.launches == before + 2 and torch.equal(out, again)
    outside = torch.tensor([not 0 <= x < e for x in te.tolist()], device=cuda_device).repeat_interleave(bm)
    assert not bool(out[outside].any())
    _gmm_close(out, gmm_plain(lhs, rhs.transpose(1, 2) if transpose else rhs, te, bm), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(len(GMM_CASES)))
def test_tgmm_kernel_matches_plain(cuda_device, dtype, case):
    m, k, n, e, bm, te = GMM_CASES[case]
    lhs = _randn((m, k), case, cuda_device, dtype)
    d_out = _randn((m, n), case + 20, cuda_device, dtype)
    te = torch.tensor(te, dtype=torch.int32, device=cuda_device)
    before = tgmm_kernel_call.launches
    out, again = tgmm_kernel_call(lhs, d_out, te, e, bm), tgmm_kernel_call(lhs, d_out, te, e, bm)
    torch.cuda.synchronize()
    assert tgmm_kernel_call.launches == before + 2 and torch.equal(out, again)
    ref = tgmm_plain(lhs, d_out, te, e, bm)
    assert out.dtype == torch.float32
    absent = [x for x in range(e) if x not in te.tolist()]
    for x in absent:
        assert float(out[x].abs().max()) == 0.0
    _gmm_close(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_gmm_differentiates_through_the_kernels(cuda_device, dtype):
    m, k, n, e, bm, te = GMM_CASES[0]
    lhs = _randn((m, k), 1, cuda_device, dtype).requires_grad_()
    rhs = _randn((e, k, n), 2, cuda_device, dtype).requires_grad_()
    te = torch.tensor(te, dtype=torch.int32, device=cuda_device)
    dout = _randn((m, n), 3, cuda_device, dtype)
    g0, t0 = gmm_kernel_call.launches, tgmm_kernel_call.launches
    d_lhs, d_rhs = torch.autograd.grad(gmm(lhs, rhs, te, bm), (lhs, rhs), dout)
    assert (gmm_kernel_call.launches - g0, tgmm_kernel_call.launches - t0) == (2, 1)
    ref_lhs = gmm_plain(dout, rhs.detach().transpose(1, 2), te, bm)
    ref_rhs = tgmm_plain(lhs.detach(), dout, te, e, bm).to(dtype)
    _gmm_close(d_lhs, ref_lhs, dtype)
    _gmm_close(d_rhs, ref_rhs, dtype)


@pytest.mark.gpu
def test_grouped_matmul_inputs_the_kernels_do_not_take_raise(cuda_device):
    te = torch.zeros((4,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="block_m 64"):
        gmm_kernel_call(torch.zeros((256, 64), device=cuda_device), torch.zeros((1, 64, 64), device=cuda_device),
                        te, 64)
    with pytest.raises(ValueError, match="gmm kernel unsupported"):
        gmm_kernel_call(torch.zeros((256, 64), device=cuda_device, dtype=torch.float16),
                        torch.zeros((1, 64, 64), device=cuda_device, dtype=torch.float16), te[:2], 128)
    with pytest.raises(ValueError, match="K 12"):
        tgmm_kernel_call(torch.zeros((256, 12), device=cuda_device, dtype=torch.bfloat16),
                         torch.zeros((256, 64), device=cuda_device, dtype=torch.bfloat16), te[:2], 1, 128)


@pytest.mark.gpu
def test_moe_train_steps_through_the_grouped_kernels_match_plain(cuda_device, monkeypatch):
    """Two f32 train steps of a small MoE (head_dim 128, dispatch gmm,
    remat attn_out) through kernels #7/#8 against the same steps with the
    wrappers swapped for their plain versions: losses within 1e-5
    relative, 9 gmm and 3 tgmm launches per layer per step."""
    import tpu_nexus_torch.ops.grouped_matmul as gm
    from tpu_nexus_torch.models.moe import MoeConfig

    cfg = MoeConfig(vocab_size=512, hidden=256, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=128,
                    intermediate=256, n_experts=4, max_seq_len=256, dtype=torch.float32,
                    remat_policy="attn_out", dispatch="gmm")
    tcfg = TrainConfig(warmup_steps=1, total_steps=2)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, size=(2, 128))).to(cuda_device)
    losses = {}
    for impl in ("kernels", "plain"):
        if impl == "plain":
            monkeypatch.setattr(gm, "gmm_kernel_call", lambda lhs, rhs, te, bm, transpose_rhs=False: gm.gmm_plain(
                lhs, rhs.transpose(1, 2) if transpose_rhs else rhs, te, bm))
            monkeypatch.setattr(gm, "tgmm_kernel_call", gm.tgmm_plain)
        state = init_train_state(torch.Generator(device=cuda_device).manual_seed(0), cfg, tcfg, device=cuda_device)
        step = make_train_step(cfg, tcfg)
        g0, t0 = gmm_kernel_call.launches, tgmm_kernel_call.launches
        losses[impl] = [float(step(state, tokens)[1]["loss"]) for _ in range(2)]
        if impl == "kernels":
            assert (gmm_kernel_call.launches - g0, tgmm_kernel_call.launches - t0) == (2 * 2 * 9, 2 * 2 * 3)
    np.testing.assert_allclose(losses["kernels"], losses["plain"], rtol=1e-5)


def _paged_case(device, dtype, b, sq, page, n_log, live, seed, int8=False):
    """A pooled cache [NB, page, 8, 128] with shuffled block tables: block 0
    is the scratch block, every row's live logical blocks get distinct
    shuffled physical blocks and the entries past its live length point at
    the scratch block."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_log
    phys = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    live_blocks = -(-np.asarray(live) // page)
    tables = np.where(np.arange(n_log)[None, :] < live_blocks[:, None], phys, 0).astype(np.int32)
    q = _randn((b, sq, 32, 128), seed + 1, device, dtype)
    k = _randn((nb, page, 8, 128), seed + 2, device, dtype)
    v = _randn((nb, page, 8, 128), seed + 3, device, dtype)
    scales = {}
    if int8:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, torch.from_numpy(tables).to(device), scales


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged,ragged", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("page,sq,logical", [(4, 1, 0), (16, 5, 0), (32, 3, 0), (64, 1, 0), (64, 5, 0),
                                             (32, 1, 4096), (32, 5, 4096), (4, 5, 4096)])
def test_paged_and_ragged_decode_kernel_matches_plain(cuda_device, dtype, int8, paged, ragged, page, sq, logical):
    """Kernel #4's paged and q_starts modes, alone and together, with and
    without int8-KV, against the plain version: pages 4, 16, 32 and 64, a
    short cache and 4096 slots, staggered per-row lengths, shuffled tables,
    bit-identical run to run."""
    b, n_log = 4, (logical // page if logical else 40 // page + 3)
    logical = n_log * page
    starts = np.array([0, 7, logical - sq - 2, 19], dtype=np.int32)
    q, k, v, tables, scales = _paged_case(cuda_device, dtype, b, sq, page, n_log, starts + sq, seed=page + sq, int8=int8)
    if not paged:  # the same rows as a contiguous cache [B, logical, Hkv, D]
        gather = lambda pool: pool[tables.long()].reshape(b, logical, *pool.shape[2:])  # noqa: E731
        k, v = gather(k), gather(v)
        scales = {name: gather(s) for name, s in scales.items()}
        tables = None
    if ragged:
        kw = dict(prompt_lengths=torch.zeros(b, dtype=torch.int32, device=cuda_device), prompt_width=0,
                  q_starts=torch.from_numpy(starts).to(cuda_device))
        kv_len = int(starts.max()) + sq
    else:  # per-slot decode (sq 1) or a shared-start extend (sq > 1)
        kv_len = int(starts.max()) + sq
        kw = dict(prompt_lengths=torch.from_numpy(starts + sq).to(cuda_device), prompt_width=logical) if sq == 1 else {}
    mode = f"{'paged' if paged else 'contiguous'}{'+ragged' if ragged else ''}{'+int8' if int8 else ''}"
    before = decode_attention.launches_by_mode[mode]
    out = decode_attention(q, k, v, kv_len, block_tables=tables, **scales, **kw)
    again = decode_attention(q, k, v, kv_len, block_tables=tables, **scales, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches_by_mode[mode] == before + 2
    assert torch.equal(out, again)
    ref = _plain(q, k, v, kv_len, block_tables=tables, **scales, **kw)
    if int8 and dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        _check(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,hidden", [(1024, 4096), (16384, 2048), (3, 100), (1, 8192), (7, 2056)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, rows, hidden):
    """Kernel #9 against the plain version: f32 to 1e-5 of the largest
    magnitude; bf16 within one bf16 ulp of each element; bit-identical run
    to run."""
    x = _randn((rows, hidden), 11, cuda_device, dtype) * 3
    w = _randn((hidden,), 12, cuda_device, torch.float32) + 1
    before = rms_norm_kernel.launches
    out, again = rms_norm_kernel(x, w), rms_norm_kernel(x, w)
    torch.cuda.synchronize()
    assert rms_norm_kernel.launches == before + 2 and out.dtype == dtype
    assert torch.equal(out, again)
    ref = rms_norm(x, w)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:  # both round one f32 result to bf16: at most one bf16 ulp apart
        assert bool(((out.float() - ref.float()).abs() <= 2**-7 * ref.float().abs()).all())
    with pytest.raises(ValueError, match="rms_norm kernel unsupported"):
        rms_norm_kernel(x.half(), w)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    [dict(), dict(page=16), dict(page=16, kv_quant="int8"), dict(page=4, spec=4), dict(steps=4, overlap=True)],
    ids=["contiguous", "paged16", "paged16-int8kv", "paged4-spec4", "multistep-overlap"],
)
def test_engine_through_the_kernels_is_token_identical_to_plain_in_f32(cuda_device, case):
    """The serving engine over the kernels (flash prefill, kernel #4 in its
    contiguous, paged and q_starts modes) against the same engine over the
    plain versions, greedy f32 at head_dim 128, shared-prefix prompts (so
    admissions extend through the paged kernel); the counters show the
    modes each run launched."""
    from tpu_nexus_torch.ops.decode_attention import reset_launches
    from tpu_nexus_torch.serving import ModelExecutor, NGramDrafter, PagedModelExecutor, ServingEngine

    cfg = LlamaConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, dtype=torch.float32, param_dtype=torch.float32,
    )
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, size=37).astype(np.int32)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (40, 9, 23)]
    prompts += [np.concatenate([shared, rng.integers(0, 512, size=k).astype(np.int32)]) for k in (3, 5, 12)]
    out = {}
    for impl in ("auto", "plain"):
        kw = dict(num_slots=3, max_len=80, kv_quant=case.get("kv_quant", ""), decode_kernel=impl, attn_impl=impl,
                  decode_steps=case.get("steps", 1))
        ex = (PagedModelExecutor(params, cfg, page_size=case["page"], **kw) if case.get("page")
              else ModelExecutor(params, cfg, **kw))
        spec = case.get("spec", 0)
        eng = ServingEngine(ex, spec_k=spec, drafter=NGramDrafter(3) if spec else None,
                            overlap=case.get("overlap", False))
        reset_launches()
        for i, p in enumerate(prompts):
            eng.submit(p, 20, request_id=f"r{i}")
        eng.run_until_drained()
        torch.cuda.synchronize()
        out[impl] = [(r.request_id, r.state, list(r.output_tokens)) for r in eng.retired]
        modes = {m: n for m, n in decode_attention.launches_by_mode.items() if n}
        if impl == "plain":
            assert modes == {}
        elif case.get("spec"):
            assert modes.get("paged+ragged", 0) > 0
        elif case.get("page"):
            assert modes.get("paged+int8" if case.get("kv_quant") else "paged", 0) > 0
        else:
            assert modes.get("contiguous", 0) > 0
    assert out["auto"] == out["plain"]


def _d128_train_cfg():
    return LlamaConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, param_dtype=torch.bfloat16, remat_policy="attn_out",
    )


@pytest.mark.gpu
def test_cuda_train_state_saves_and_restores_bit_identical(cuda_device, tmp_path):
    """A bf16 adamw train state on the card, two steps in: save, commit,
    restore into a template from another seed — every leaf lands on the
    card bit-identical, fresh and contiguous; the params also restore
    template-free onto the card."""
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

    adapter = LlamaAdapter(config=_d128_train_cfg())
    tcfg = TrainConfig(warmup_steps=1, total_steps=10)
    state = init_train_state(torch.Generator(device=cuda_device).manual_seed(0), adapter, tcfg, cuda_device)
    step_fn = make_train_step(adapter, tcfg)
    data = adapter.data(2, 128, seed=0)
    for _ in range(2):
        state, _ = step_fn(state, adapter.to_device(next(data), cuda_device))
    ckpt = TensorCheckpointer(str(tmp_path))
    ckpt.save(2, state)
    ckpt.commit(2)
    template = init_train_state(torch.Generator(device=cuda_device).manual_seed(1), adapter, tcfg, cuda_device)
    restored = TensorCheckpointer(str(tmp_path)).restore(template)

    def leaves(s):
        return ([p for _, p in sorted(s["params"].named_parameters())] + [s["step"], s["opt_state"]["count"]]
                + [t for leaf in s["opt_state"]["leaves"] for t in leaf.values()] + list(s["health"].values()))

    for a, b in zip(leaves(state), leaves(restored)):
        assert b.device.type == "cuda" and b.is_contiguous() and a.dtype == b.dtype
        assert torch.equal(a, b)
    params = TensorCheckpointer(str(tmp_path)).restore_params(2)
    assert all(p.device.type == "cuda" and torch.equal(p, q)
               for p, q in zip(params.parameters(), state["params"].parameters()))


@pytest.mark.gpu
def test_cuda_run_resumes_to_the_uninterrupted_losses(cuda_device, tmp_path):
    """run_workload on the card (head_dim 128, bf16, adamw, remat attn_out):
    6 steps uninterrupted against 3 steps, a checkpoint and a restart for
    3 more — the per-step losses are bit-identical."""
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.core.telemetry import NullMetrics
    from tpu_nexus_torch.models.registry import LlamaAdapter
    from tpu_nexus_torch.parallel.distributed import ProcessContext
    from tpu_nexus_torch.workload.harness import WorkloadConfig, run_workload

    class Losses(NullMetrics):
        def __init__(self):
            self.losses = []

        def gauge(self, name, value, tags=None):
            if name == "train.loss":
                self.losses.append(value)

    ctx = ProcessContext(run_id="gpu-ckpt", algorithm="train", process_id=0, num_processes=1, coordinator=None)

    def run(steps, directory, every):
        telemetry = Losses()
        cfg = WorkloadConfig(model=LlamaAdapter(config=_d128_train_cfg()), train=TrainConfig(warmup_steps=1,
                             total_steps=6), batch_size=2, seq_len=128, steps=steps, heartbeat_every=1,
                             checkpoint_every=every, checkpoint_dir=directory, device="cuda")
        summary = run_workload(cfg, store=None, ctx=ctx, lifecycle=LifecycleContext(), telemetry=telemetry)
        return summary, telemetry.losses

    _, whole = run(6, "", 0)
    first, head = run(3, str(tmp_path), 3)
    second, tail = run(6, str(tmp_path), 3)
    assert first["final_step"] == 3 and second["resumed_from"] == 3 and second["final_step"] == 6
    assert head + tail == whole and len(whole) == 6


def _d128_serve_cfg(dtype):
    return LlamaConfig(
        vocab_size=512, hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
        intermediate=512, max_seq_len=256, dtype=dtype, param_dtype=dtype,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8kv"])
def test_kv_handoff_between_cuda_pools_is_bit_identical(cuda_device, kv_quant):
    """A prefill replica's payload (its blocks gathered on the card, copied
    to the host, sealed) installs into another engine's pool at other
    block ids; reading those blocks back gives the payload's bytes, bf16
    KV and int8 KV with its f32 scales alike, and a corrupt copy writes
    nothing."""
    from tpu_nexus_torch.serving import PagedModelExecutor, PayloadCorrupt, ServingEngine
    from tpu_nexus_torch.serving.handoff import leaf_bytes

    cfg = _d128_serve_cfg(torch.bfloat16)
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)

    def engine():
        return ServingEngine(PagedModelExecutor(params, cfg, num_slots=2, max_len=96, page_size=16,
                                                kv_quant=kv_quant))

    prompt = np.random.default_rng(0).integers(0, 512, size=70).astype(np.int32)
    sender, receiver = engine(), engine()
    payload = sender.prefill_remote(prompt, "r0")
    leaves = {"k", "v"} | ({"k_s", "v_s"} if kv_quant else set())
    assert set(payload.blocks) == leaves and payload.n_blocks == 5
    for name, arr in payload.blocks.items():
        assert arr.device.type == "cpu" and arr.dtype == sender.executor.cache[name].dtype
    pool = {k: v.clone() for k, v in receiver.executor.cache.items()}
    bad = {k: v.clone() for k, v in payload.blocks.items()}
    leaf_bytes(bad["k"])[7] ^= 0x01
    from tpu_nexus_torch.serving import KVHandoffPayload

    corrupt = KVHandoffPayload(request_id="r0", prompt=payload.prompt, first_token=payload.first_token,
                               page_size=16, n_blocks=5, blocks=bad, checksums=dict(payload.checksums))
    with pytest.raises(PayloadCorrupt, match="crc32"):
        receiver.executor.install_blocks(corrupt, [9, 3, 4, 1, 2])
    assert all(torch.equal(receiver.executor.cache[k], pool[k]) for k in pool)
    ids = [9, 3, 4, 1, 2]
    receiver.executor.install_blocks(payload, ids)
    again = receiver.executor.extract_blocks(ids)
    for name in leaves:
        assert bytes(leaf_bytes(again[name])) == bytes(leaf_bytes(payload.blocks[name])), name


@pytest.mark.gpu
def test_cuda_disaggregated_fleet_is_token_identical_to_a_fused_engine(cuda_device):
    """One prefill and two decode replicas on the card (bf16, head_dim 128,
    kernel #1 on every prefill, #4's paged mode on every decode step) give
    a fused engine's tokens on the same prompts: every request handed off,
    none degraded."""
    from tpu_nexus_torch.ops.decode_attention import reset_launches
    from tpu_nexus_torch.serving import ROLE_DECODE, ROLE_PREFILL, PagedModelExecutor, ServingEngine, ServingFleet

    cfg = _d128_serve_cfg(torch.bfloat16)
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)

    def engine(slots):
        return ServingEngine(PagedModelExecutor(params, cfg, num_slots=slots, max_len=96, page_size=16))

    rng = np.random.default_rng(1)
    prompts = [np.concatenate([[500 + i], rng.integers(0, 500, size=n)]).astype(np.int32)
               for i, n in enumerate((60, 9, 33, 17, 48, 5))]
    fused = engine(4)
    want = [fused.submit(p, 24) for p in prompts]
    fused.run_until_drained()
    fleet = ServingFleet()
    fleet.add_replica("pf-0", engine(2), step=0, role=ROLE_PREFILL)
    fleet.add_replica("dc-0", engine(4), step=0, role=ROLE_DECODE)
    fleet.add_replica("dc-1", engine(4), step=0, role=ROLE_DECODE)
    flash_attention.launches = 0
    reset_launches()
    reqs = [fleet.submit(p, 24) for p in prompts]
    fleet.run_until_drained()
    torch.cuda.synchronize()
    assert fleet.handoffs_completed == len(prompts) and fleet.disagg_fallbacks == 0
    assert [list(r.output_tokens) for r in reqs] == [list(r.output_tokens) for r in want]
    assert flash_attention.launches >= cfg.n_layers * len(prompts)
    assert decode_attention.launches_by_mode.get("paged", 0) > 0


@pytest.mark.gpu
def test_cuda_out_of_memory_classifies_as_hbm_oom(cuda_device):
    """A real CUDA out-of-memory error raised on the card reaches the
    supervisor's memory class in both forms the chain carries: the harness's
    rewording (``classified_error_text``) and the raw ``torch`` text alone."""
    from tpu_nexus_torch.supervisor.taxonomy import DecisionAction, classify_tpu_failure
    from tpu_nexus_torch.workload.harness import classified_error_text

    total = torch.cuda.get_device_properties(cuda_device).total_memory
    with pytest.raises(torch.OutOfMemoryError) as caught:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)
    raw = f"{type(caught.value).__module__}.{type(caught.value).__name__}: {caught.value}"
    assert "CUDA out of memory" in raw
    assert classify_tpu_failure(classified_error_text(caught.value)) == DecisionAction.TO_FAIL_HBM_OOM
    assert classify_tpu_failure(raw) == DecisionAction.TO_FAIL_HBM_OOM
    assert classify_tpu_failure(str(caught.value)) == DecisionAction.TO_FAIL_HBM_OOM


@pytest.mark.gpu
def test_fleet_supervisor_recreates_a_deleted_pod_on_the_card(cuda_device):
    """``FleetSupervisor`` over two paged replicas on the card (f32, head_dim
    128, kernel #1 on every prefill and #4's paged mode on every decode
    step), watching a fake cluster: a deleted pod is recreated under its
    name, its live requests end FAILED with the replica-lost cause, and the
    replacement's greedy tokens equal those of an engine over the plain
    versions given the same prompts."""
    import asyncio
    from datetime import timedelta

    from tpu_nexus_torch.checkpoint.models import JOB_LABEL_SERVING_FLEET, JOB_TEMPLATE_NAME_KEY, NEXUS_COMPONENT_LABEL
    from tpu_nexus_torch.checkpoint.store import InMemoryCheckpointStore
    from tpu_nexus_torch.core.signals import LifecycleContext
    from tpu_nexus_torch.k8s.fake import FakeKubeClient
    from tpu_nexus_torch.ops.decode_attention import reset_launches
    from tpu_nexus_torch.serving import (
        CAUSE_REPLICA_LOST,
        FleetSupervisor,
        PagedModelExecutor,
        RequestState,
        ServingEngine,
        ServingFleet,
    )
    from tpu_nexus_torch.supervisor.taxonomy import MSG_PREEMPTED, DecisionAction

    cfg = _d128_serve_cfg(torch.float32)
    params = llama_init(torch.Generator(device=cuda_device).manual_seed(0), cfg, device=cuda_device)

    def engine(kv_blocks=None, impl="auto"):
        return ServingEngine(PagedModelExecutor(params, cfg, num_slots=3, max_len=96, page_size=16,
                                                num_blocks=kv_blocks or 0, decode_kernel=impl, attn_impl=impl))

    jobset = {
        "kind": "JobSet", "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "metadata": {"name": "svc", "namespace": "nexus", "uid": "js-svc",
                     "labels": {NEXUS_COMPONENT_LABEL: JOB_LABEL_SERVING_FLEET, JOB_TEMPLATE_NAME_KEY: "svc-algo"}},
        "spec": {"replicatedJobs": [{"name": "replica", "replicas": 2, "template": {"spec": {
            "parallelism": 1, "template": {"spec": {"containers": [{"name": "main", "env": []}]}}}}}]},
        "status": {},
    }
    rng = np.random.default_rng(5)
    burst = [rng.integers(0, 512, size=n).astype(np.int32) for n in (40, 17, 33, 25)]
    after = [rng.integers(0, 512, size=n).astype(np.int32) for n in (29, 50, 12)]

    async def drill():
        client = FakeKubeClient(jobset_controller=True, emit_pod_events=True)
        client.inject("ADDED", "JobSet", jobset)
        store = InMemoryCheckpointStore()
        fleet = ServingFleet()
        sup = FleetSupervisor(client, store, "nexus", fleet, "svc", "svc-algo", lambda n, s, kv: engine(kv),
                              grace_s=30.0, resync_period=timedelta(0))
        ctx = LifecycleContext()
        sup._factory.start(ctx)
        try:
            assert await sup._factory.wait_for_cache_sync(timeout=10.0)
            pods = await sup.adopt_pods(step=0)
            assert len(pods) == 2
            reqs = [fleet.submit(p, 16, request_id=f"b{i}") for i, p in enumerate(burst)]
            fleet.tick()
            victim = max(pods, key=lambda n: len(fleet.replicas[n].engine.requests))
            held = len(fleet.replicas[victim].engine.requests)
            await client.delete_object("Pod", "nexus", victim)
            for _ in range(50):
                if sup._pending:
                    break
                await asyncio.sleep(0.02)
            await sup.reconcile(now=1.0)
            assert sup.recreated == 1 and fleet.replicas[victim].state == "serving"
            assert client._objects["Pod"][("nexus", victim)]["metadata"]["uid"].startswith("fleet-recreate-")
            fleet.run_until_drained()
            lost = f"{CAUSE_REPLICA_LOST}:{DecisionAction.TO_PREEMPT_RESTARTABLE}"
            assert held and sum(r.cause == lost for r in reqs) == held
            assert all(r.state == RequestState.FINISHED or r.cause == lost for r in reqs)
            assert store.read_checkpoint("svc-algo", "svc").algorithm_failure_cause == MSG_PREEMPTED
            flash_attention.launches = 0
            reset_launches()
            replacement = fleet.replicas[victim].engine
            got = [replacement.submit(p, 16, request_id=f"a{i}") for i, p in enumerate(after)]
            replacement.run_until_drained()
            torch.cuda.synchronize()
            assert flash_attention.launches >= cfg.n_layers * len(after)
            assert decode_attention.launches_by_mode.get("paged", 0) > 0
            return [(r.state, list(r.output_tokens)) for r in got]
        finally:
            ctx.cancel()
            await sup._factory.shutdown()

    got = asyncio.run(drill())
    plain = engine(impl="plain")
    want = [plain.submit(p, 16, request_id=f"a{i}") for i, p in enumerate(after)]
    plain.run_until_drained()
    assert got == [(r.state, list(r.output_tokens)) for r in want]
    assert all(state == RequestState.FINISHED for state, _ in got)


# -- the per-rank shapes of sharded serving (llama3_8b at tp 2) ----------------

#: (M, K, N) of one rank's decode-step products at tp 2: wq (N 4096/2),
#: wk/wv (N 1024/2), gate/up (N 14336/2) column-parallel; wo (K 4096/2) and
#: w_down (K 14336/2) row-parallel
TP2_QUANT_SHAPES = [(8, 4096, 2048), (8, 4096, 512), (8, 4096, 7168), (8, 2048, 4096), (8, 7168, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 64)])
@pytest.mark.parametrize("m,k,n", TP2_QUANT_SHAPES)
def test_quant_kernels_take_the_ring_at_the_tp2_rank_shapes(cuda_device, mode, group, m, k, n):
    """#5 and #6 at each rank's shapes, the weight a contiguous copy of its
    column (or row) slice as a rank holds it: the ring kernel, not the
    first design; twice bit-identical; against the plain version."""
    full_n, full_k = (2 * n, k) if k == 4096 else (n, 2 * k)
    w = _randn((full_k, full_n), k + n, cuda_device, torch.float32) * full_k**-0.5
    part = (w[:, :n] if full_n != n else w[:k]).contiguous()
    q = quantize_tensor(part, (-2,)) if mode == "int8" else quantize_tensor_int4(part, (-2,), group, name="w")
    x = _randn((m, k), 7, cuda_device, torch.bfloat16)
    before = dict(quant_matmul.launches_by_route)
    out, again = quant_matmul(x, q), quant_matmul(x, q)
    torch.cuda.synchronize()
    grew = {r: c - before[r] for r, c in quant_matmul.launches_by_route.items() if c != before[r]}
    assert grew == {f"{mode}_ring": 2}
    assert torch.equal(out, again)
    ref = quant_matmul_plain(x, q)
    rel = (out.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
    assert float(rel.max()) <= ROW_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_at_the_tp2_prefill_shape(cuda_device, dtype):
    """#1 on one rank's heads of a llama3_8b prefill at tp 2: Hq 16, Hkv 4,
    D 128, the 128-token bucket, causal; bit-identical run to run."""
    q = _randn((1, 128, 16, 128), 1, cuda_device, dtype)
    k = _randn((1, 128, 4, 128), 2, cuda_device, dtype)
    v = _randn((1, 128, 4, 128), 3, cuda_device, dtype)
    out, lse = flash_attention(q, k, v, causal=True)
    again, lse_again = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=True)
    _check(out, ref_out, dtype)
    assert float((lse - ref_lse).abs().max()) <= TOL[dtype][1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_at_the_tp2_rank_heads(cuda_device, dtype, int8):
    """#4's paged mode on one rank's heads at tp 2 (8 slots, Hq 16, Hkv 4,
    page 32, rows at staggered depths up to 160): bit-identical run to run,
    against the plain version (f32 evaluated in f64)."""
    rng = np.random.default_rng(5)
    b, page, n_log = 8, 32, 5
    nb = 1 + b * n_log
    tables = rng.permutation(np.arange(1, nb)).reshape(b, n_log).astype(np.int32)
    pos = np.array([129, 140, 159, 130, 135, 150, 158, 131], dtype=np.int32)
    q = _randn((b, 1, 16, 128), 1, cuda_device, dtype)
    k = _randn((nb, page, 4, 128), 2, cuda_device, dtype)
    v = _randn((nb, page, 4, 128), 3, cuda_device, dtype)
    scales = {}
    if int8:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    tables = torch.from_numpy(tables).to(cuda_device)
    kw = dict(prompt_lengths=torch.from_numpy(pos + 1).to(cuda_device), prompt_width=n_log * page)
    mode = "paged+int8" if int8 else "paged"
    before = decode_attention.launches_by_mode[mode]
    out = decode_attention(q, k, v, int(pos.max()) + 1, block_tables=tables, **scales, **kw)
    again = decode_attention(q, k, v, int(pos.max()) + 1, block_tables=tables, **scales, **kw)
    torch.cuda.synchronize()
    assert decode_attention.launches_by_mode[mode] == before + 2
    assert torch.equal(out, again)
    ref = _plain(q, k, v, int(pos.max()) + 1, block_tables=tables, **scales, **kw)
    if int8 and dtype == torch.float32:
        assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        _check(out, ref, dtype)
