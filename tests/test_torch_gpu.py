"""On-card tests of the port's CUDA kernels (``gpu`` marker).

Each kernel against its plain PyTorch version on the same seeded inputs,
at small shapes that still cover the kernels' cases (GQA, ragged tails,
D 64 and 128, ragged decode lens/width, q_len > 1), and the backward
kernels at the shapes of ``chip_smoke.py``'s train_parity phase.
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

from tpu_nexus_torch.models.generate import cached_attention, generate
from tpu_nexus_torch.models.llama import LlamaConfig, llama_init
from tpu_nexus_torch.ops.attention import attention
from tpu_nexus_torch.ops.decode_attention import decode_attention, decode_attention_plain
from tpu_nexus_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_differentiable,
    flash_attention_plain,
)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,d,causal", [(128, 128, True), (200, 128, True), (256, 64, False)])
def test_flash_kernel_matches_plain(cuda_device, dtype, s, d, causal):
    q = _randn((2, s, 8, d), 1, cuda_device, dtype)
    k = _randn((2, s, 2, d), 2, cuda_device, dtype)
    v = _randn((2, s, 2, d), 3, cuda_device, dtype)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,max_len,kv_len,ragged", [(1, 160, 144, False), (4, 300, 290, True),
                                                     (1, 4096, 3000, False), (8, 64, 64, False)])
def test_decode_kernel_matches_plain(cuda_device, dtype, sq, max_len, kv_len, ragged):
    q = _randn((4, sq, 32, 128), 4, cuda_device, dtype)
    k = _randn((4, max_len, 8, 128), 5, cuda_device, dtype)
    v = _randn((4, max_len, 8, 128), 6, cuda_device, dtype)
    lens = width = None
    if ragged:
        width = max_len // 2
        lens = torch.tensor([width, 1, width // 2, width - 3], dtype=torch.int32, device=cuda_device)
    before = decode_attention.launches
    out = decode_attention(q, k, v, kv_len, lens, width)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, k, v, kv_len, lens, width)
    _check(out, ref, dtype)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,causal", [
    (8, 2048, 16, 8, 128, True), (2, 512, 32, 8, 128, True), (2, 200, 16, 8, 128, True),
    (2, 256, 16, 8, 64, True), (2, 384, 16, 8, 128, False),
])
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

