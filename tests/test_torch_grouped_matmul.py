"""The port's grouped matmul (``ops/grouped_matmul.py``) against the JAX
package's, on the CPU.

The JAX kernels run as the JAX package's own tests run them: ``gmm(...,
interpret=True)`` and ``_tgmm_raw(..., interpret=True)`` (Pallas interpret
mode).  Inputs are numpy with a fixed seed at 128-multiple widths, f32.

* ``gmm_plain`` and ``tgmm_plain`` against the interpret-mode kernels and
  against ``_gmm_ref`` / ``_tgmm_ref``, within 1e-5 of the reference's
  largest magnitude (f32 sums in another order).
* The autograd ``gmm`` against ``jax.grad`` of the JAX ``gmm`` in
  interpret mode (1e-5 relative); ``gmm_checked`` zeroes the weight
  gradient of an expert absent from ``tile_expert``; ``_check_tiles``
  raises on a short map.
* On CPU tensors the wrappers take the plain versions and count no
  launch; the forward is the dispatcher op ``nexus::gmm``, which
  selective checkpointing sees.
* ``_check_kernel_inputs`` accepts exactly the kernels' contract (bf16 or
  f32, ``block_m`` a multiple of 128, 16-byte K and N rows, 16-byte
  aligned operands) and raises on the rest, naming the clause.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_nexus.ops import grouped_matmul as jax_gmm
from tpu_nexus_torch.ops import grouped_matmul as port_gmm

torch.set_num_threads(1)
REL = 1e-5
#: (M, K, N, E, block_m, tile_expert): uneven runs; one 512-row tile layout
#: with an expert absent; K and N not multiples of 64 (the card's kernels
#: take them through TMA's zero fill, so their oracle is held to JAX there)
CASES = [
    (1024, 256, 384, 4, 128, [0, 0, 0, 1, 2, 2, 3, 3]),
    (512, 128, 128, 4, 128, [0, 1, 2, 3]),
    (1024, 128, 256, 3, 512, [0, 2]),
    (768, 200, 72, 3, 128, [0, 1, 1, 1, 2, 2]),
]


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


def _inputs(case, seed=0):
    m, k, n, e, bm, te = CASES[case]
    rng = np.random.default_rng(seed + case)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((e, k, n)).astype(np.float32)
    d_out = rng.standard_normal((m, n)).astype(np.float32)
    return lhs, rhs, d_out, np.asarray(te, np.int32), e, bm


@pytest.mark.parametrize("case", range(len(CASES)))
def test_gmm_plain_matches_the_interpret_kernel_and_the_reference(case):
    lhs, rhs, _, te, _, bm = _inputs(case)
    got = port_gmm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(te), bm).numpy()
    kern = jax_gmm.gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te), bm, 128, True)
    ref = jax_gmm._gmm_ref(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(te), bm)
    _close(got, kern)
    _close(got, ref)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_tgmm_plain_matches_the_interpret_kernel_and_the_reference(case):
    lhs, rhs, d_out, te, e, bm = _inputs(case)
    got = port_gmm.tgmm_plain(torch.from_numpy(lhs), torch.from_numpy(d_out), torch.from_numpy(te), e, bm)
    assert got.dtype == torch.float32
    ref = jax_gmm._tgmm_ref(jnp.asarray(lhs), jnp.asarray(d_out), jnp.asarray(te), e, bm)
    _close(got.numpy(), ref)
    kern = np.asarray(jax_gmm._tgmm_raw(jnp.asarray(lhs), jnp.asarray(d_out), jnp.asarray(te), e, bm, 128, True))
    present = sorted(set(te.tolist()))  # the TPU kernel leaves an absent expert's block undefined
    _close(got.numpy()[present], kern[present])
    for x in set(range(e)) - set(present):
        assert float(got[x].abs().max()) == 0.0


@pytest.mark.parametrize("case", [0, 1])
def test_gmm_gradients_match_jax_grad_of_the_interpret_kernel(case):
    lhs, rhs, d_out, te, _, bm = _inputs(case)
    jl, jr = jax.grad(
        lambda a, b: jnp.sum(jax_gmm.gmm(a, b, jnp.asarray(te), bm, 128, True) * d_out), argnums=(0, 1)
    )(jnp.asarray(lhs), jnp.asarray(rhs))
    pl, pr = torch.tensor(lhs, requires_grad=True), torch.tensor(rhs, requires_grad=True)
    out = port_gmm.gmm(pl, pr, torch.from_numpy(te), bm)
    gl, gr = torch.autograd.grad(out, (pl, pr), torch.from_numpy(d_out))
    _close(gl.numpy(), jl)
    _close(gr.numpy(), jr)


def test_bf16_gradients_come_back_in_the_operands_dtype():
    lhs, rhs, d_out, te, _, bm = _inputs(0)
    pl = torch.tensor(lhs).to(torch.bfloat16).requires_grad_()
    pr = torch.tensor(rhs).to(torch.bfloat16).requires_grad_()
    out = port_gmm.gmm(pl, pr, torch.from_numpy(te), bm)
    assert out.dtype == torch.bfloat16
    gl, gr = torch.autograd.grad(out, (pl, pr), torch.from_numpy(d_out).to(torch.bfloat16))
    assert gl.dtype == gr.dtype == torch.bfloat16


def test_gmm_checked_zeroes_an_absent_experts_gradient():
    lhs, rhs, d_out, _, _, bm = _inputs(1)
    te = np.asarray([0, 0, 2, 3], np.int32)  # expert 1 owns no tile
    jr = jax.grad(
        lambda b: jnp.sum(jax_gmm.gmm_checked(jnp.asarray(lhs), b, jnp.asarray(te), bm, 128, True) * d_out)
    )(jnp.asarray(rhs))
    pr = torch.tensor(rhs, requires_grad=True)
    (gr,) = torch.autograd.grad(port_gmm.gmm_checked(torch.from_numpy(lhs), pr, torch.from_numpy(te), bm), (pr,),
                                torch.from_numpy(d_out))
    assert float(gr[1].abs().max()) == 0.0 and float(gr[0].abs().sum()) > 0
    _close(gr.numpy(), jr)


def test_check_tiles_raises_on_a_short_map():
    lhs, rhs, d_out, _, e, bm = _inputs(0)
    short = torch.zeros((7,), dtype=torch.int32)
    with pytest.raises(ValueError, match="tile_expert has 7 entries"):
        port_gmm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs), short, bm)
    with pytest.raises(ValueError, match="tile_expert has 7 entries"):
        port_gmm.tgmm_kernel_call(torch.from_numpy(lhs), torch.from_numpy(d_out), short, e, bm)
    with pytest.raises(ValueError, match="tile_expert has 7 entries"):
        port_gmm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), short, bm)
    with pytest.raises(ValueError):  # the reference raises on the same map
        jax_gmm._check_tiles(lhs.shape[0], bm, jnp.zeros((7,), jnp.int32))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    lhs, rhs, d_out, te, e, bm = _inputs(0)
    before = (port_gmm.gmm_kernel_call.launches, port_gmm.tgmm_kernel_call.launches)
    t = torch.from_numpy
    out = port_gmm.gmm_kernel_call(t(lhs), t(rhs).transpose(1, 2).contiguous(), t(te), bm, transpose_rhs=True)
    assert torch.equal(out, port_gmm.gmm_plain(t(lhs), t(rhs), t(te), bm))
    port_gmm.tgmm_kernel_call(t(lhs), t(d_out), t(te), e, bm)
    assert (port_gmm.gmm_kernel_call.launches, port_gmm.tgmm_kernel_call.launches) == before
    assert port_gmm.BLOCK_M == jax_gmm.BLOCK_M


def test_selective_checkpointing_sees_the_gmm_op():
    """The forward is the dispatcher op ``nexus::gmm``: a selective
    checkpoint policy is asked about it, as about ``nexus::flash_fwd``."""
    from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

    lhs, rhs, d_out, te, _, bm = _inputs(1)
    seen = []

    def policy(ctx, op, *args, **kwargs):
        seen.append(op)
        return CheckpointPolicy.PREFER_RECOMPUTE

    pl = torch.tensor(lhs, requires_grad=True)
    pr = torch.tensor(rhs, requires_grad=True)
    out = checkpoint(port_gmm.gmm, pl, pr, torch.from_numpy(te), bm, use_reentrant=False,
                     context_fn=lambda: create_selective_checkpoint_contexts(policy))
    gl, gr = torch.autograd.grad(out, (pl, pr), torch.from_numpy(d_out))
    assert torch.ops.nexus.gmm.default in seen
    ref = torch.autograd.grad(port_gmm.gmm(pl, pr, torch.from_numpy(te), bm), (pl, pr), torch.from_numpy(d_out))
    assert torch.equal(gl, ref[0]) and torch.equal(gr, ref[1])


#: (what, lhs dtype, other dtype, te dtype, block_m, K, N, byte offset of
#: lhs, the clause the message must name or None where the kernels take it)
CONTRACT = [
    ("bf16", torch.bfloat16, torch.bfloat16, torch.int32, 512, 1024, 2048, 0, None),
    ("f32", torch.float32, torch.float32, torch.int32, 128, 256, 384, 0, None),
    ("int64 map", torch.bfloat16, torch.bfloat16, torch.int64, 256, 64, 64, 0, None),
    ("ragged bf16 K and N", torch.bfloat16, torch.bfloat16, torch.int32, 128, 200, 72, 0, None),
    ("one 16-byte row", torch.bfloat16, torch.bfloat16, torch.int32, 128, 8, 8, 0, None),
    ("f32 K 4", torch.float32, torch.float32, torch.int32, 128, 4, 12, 0, None),
    ("fp16", torch.float16, torch.float16, torch.int32, 128, 64, 64, 0, "dtypes torch.float16"),
    ("mixed dtypes", torch.bfloat16, torch.float32, torch.int32, 128, 64, 64, 0, "dtypes torch.bfloat16 / torch.float32"),
    ("float map", torch.bfloat16, torch.bfloat16, torch.float32, 128, 64, 64, 0, "tile_expert dtype"),
    ("block_m 64", torch.bfloat16, torch.bfloat16, torch.int32, 64, 64, 64, 0, "block_m 64"),
    ("block_m 192", torch.bfloat16, torch.bfloat16, torch.int32, 192, 64, 64, 0, "block_m 192"),
    ("bf16 K 12", torch.bfloat16, torch.bfloat16, torch.int32, 128, 12, 64, 0, "K 12"),
    ("bf16 N 4", torch.bfloat16, torch.bfloat16, torch.int32, 128, 64, 4, 0, "N 4"),
    ("f32 N 6", torch.float32, torch.float32, torch.int32, 128, 64, 6, 0, "N 6"),
    ("K 0", torch.bfloat16, torch.bfloat16, torch.int32, 128, 0, 64, 0, "K 0"),
    ("misaligned lhs", torch.bfloat16, torch.bfloat16, torch.int32, 128, 64, 64, 8, "base addresses at 8 / 0"),
]


@pytest.mark.parametrize("case", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_check_kernel_inputs_accepts_exactly_the_kernels_contract(case):
    _, dt, other_dt, te_dt, bm, k, n, offset, clause = case
    item = torch.empty((), dtype=dt).element_size()
    # lhs as a contiguous view starting `offset` bytes into a fresh (aligned) buffer
    lhs = torch.zeros(offset // item + 2 * bm * k, dtype=dt)[offset // item:].view(2 * bm, k)
    other = torch.zeros((2 * bm, n), dtype=other_dt)
    te = torch.zeros((2,), dtype=te_dt)
    if clause is None:
        port_gmm._check_kernel_inputs("gmm", lhs, other, te, bm, k, n)
    else:
        with pytest.raises(ValueError, match="gmm kernel unsupported inputs") as info:
            port_gmm._check_kernel_inputs("gmm", lhs, other, te, bm, k, n)
        assert clause in str(info.value)
