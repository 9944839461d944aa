"""Ring attention: sequence parallelism over the ``sp`` mesh axis, the port
of ``tpu_nexus/parallel/ring.py``.

Each rank keeps its query shard; the key/value shards travel around the
ring one hop a step (:func:`collectives.ring_shift`, point to point, never
an all-gather of the whole K/V).  Step 0 is always the diagonal block
(causal when the attention is); every later step is an unmasked block, or
— for a causal attention, a block from a rank ahead of this one — wholly
masked and skipped (its kernels are not launched, the rotation still
happens, so every rank issues the same collectives).  Blocks merge by the
two-level flash combination on (normalized out, logsumexp), in f32.

Every block is kernel #1 (``ops/flash_attention.py::flash_attention``) on
a card and its plain version on the CPU; the backward passes the GLOBAL
lse and ``rowsum(dO∘O)`` (:func:`flash_dsum`) to kernels #2 and #3
(``flash_attention_bwd_dq`` / ``_dkv``) for each block, and the (dK, dV)
accumulators travel with the K/V block they belong to, so after the last
hop each is home.  Residuals are O(local): q, k, v, out, lse.

The forward is the dispatcher op ``nexus::ring_fwd`` so that the remat
policies that keep the flash forward's outputs (``attn_out``, ``qkv``)
keep the ring's too and never re-run its rotation in the backward.

Layouts: q ``[B, S_local, Hq, D]``, k/v ``[B, S_local, Hkv, D]``; the lse
is the port's ``[B, Hq, S_local]`` (the JAX ring's is ``[B, S, Hq]``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_nexus_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_bwd_qt,
    flash_dsum,
)
from tpu_nexus_torch.parallel import collectives

_NEG_INF = -1e30


@dataclass(frozen=True)
class Ring:
    """The ``sp`` ring of this rank: the global ranks in ring order, this
    rank's position, and the seam's comm (for the stats' error text)."""

    ranks: Tuple[int, ...]
    index: int
    comm: Any = field(default=None, compare=False, hash=False)

    @property
    def size(self) -> int:
        return len(self.ranks)


#: rings by key: the dispatcher op takes an int, not a process group
_RINGS: Dict[int, Ring] = {}
_KEYS: Dict[Ring, int] = {}


def _key(ring: Ring) -> int:
    if ring not in _KEYS:
        _KEYS[ring] = len(_RINGS)
        _RINGS[_KEYS[ring]] = ring
    return _KEYS[ring]


def _combine(acc, big_l, out_b, lse_b):
    """Two-level flash merge of (normalized out ``[B,S,H,D]`` f32, lse
    ``[B,H,S]`` f32) pairs."""
    m_new = torch.maximum(big_l, lse_b)
    alpha = torch.where(big_l == _NEG_INF, torch.zeros_like(m_new), torch.exp(big_l - m_new))
    beta = torch.where(lse_b == _NEG_INF, torch.zeros_like(m_new), torch.exp(lse_b - m_new))
    denom = torch.clamp_min(alpha + beta, 1e-30)
    a, b, d = (t.transpose(1, 2)[..., None] for t in (alpha, beta, denom))
    return (acc * a + out_b * b) / d, m_new + torch.log(denom)


def _visit(ring: Ring, t: int, causal: bool) -> bool:
    """Whether step ``t``'s block (from position ``(index + t) % n``) is
    computed: always without a causal mask; with one, only blocks from
    positions before this one (later positions' keys follow every query)."""
    return not causal or (ring.index + t) % ring.size < ring.index


def ring_forward(q, k, v, ring: Ring, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B,S,Hq,D]`` in q's dtype, lse ``[B,Hq,S]`` f32)."""
    out, lse = flash_attention(q, k, v, causal=causal, scale=scale)
    if ring.size == 1:
        return out, lse
    acc = out.float()
    kc, vc = k, v
    for t in range(1, ring.size):
        kc, vc = collectives.ring_shift([kc, vc], ring.ranks, ring.index, ring.comm)
        if _visit(ring, t, causal):
            out_b, lse_b = flash_attention(q, kc, vc, causal=False, scale=scale)
            acc, lse = _combine(acc, lse, out_b.float(), lse_b)
    return acc.to(q.dtype), lse


def ring_backward(q, k, v, out, lse, dout, ring: Ring, causal: bool, scale: float):
    dout = dout.contiguous()
    dsum = flash_dsum(out, dout)
    qt = flash_bwd_qt(q, scale)

    def block(kc, vc, blk_causal):
        dq = flash_attention_bwd_dq(q, kc, vc, dout, lse, dsum, causal=blk_causal, scale=scale, qt=qt)
        dk, dv = flash_attention_bwd_dkv(q, kc, vc, dout, lse, dsum, causal=blk_causal, scale=scale, qt=qt)
        return dq.float(), dk.float(), dv.float()

    dq, dk, dv = block(k, v, causal)
    if ring.size == 1:
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    kc, vc = k, v
    for t in range(1, ring.size):
        kc, vc = collectives.ring_shift([kc, vc], ring.ranks, ring.index, ring.comm, tag=1)
        dk, dv = collectives.ring_shift([dk, dv], ring.ranks, ring.index, ring.comm, tag=2)
        if _visit(ring, t, causal):
            dqc, dkc, dvc = block(kc, vc, False)
            dq, dk, dv = dq + dqc, dk + dkc, dv + dvc
    # one final hop brings each accumulator home
    dk, dv = collectives.ring_shift([dk, dv], ring.ranks, ring.index, ring.comm, tag=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("nexus::ring_fwd", mutates_args=())
def ring_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float, key: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ring_forward` as one dispatcher op (see the module docstring)."""
    return ring_forward(q, k, v, _RINGS[key], causal, scale)


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key: int, causal: bool, scale: float):
        out, lse = ring_fwd_op(q, k, v, causal, scale, key)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.key, ctx.causal, ctx.scale = key, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, dout, _RINGS[ctx.key], ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, ring: Ring, *, causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence sharded around ``ring``; q/k/v are this
    rank's shards ``[B, S_local, H, D]`` (equal on every rank)."""
    if q.shape[1] != k.shape[1] or k.shape != v.shape or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"ring attention needs equal local shards and Hq % Hkv == 0: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttention.apply(q, k, v, _key(ring), bool(causal), float(scale))


def ring_attention_sharded(q, k, v, mesh: Any, *, causal: bool = True, seq_axis: str = "sp") -> torch.Tensor:
    """The entry point of the train step: this rank's shards of the global
    ``[B, S, H, D]`` arrays (batch over ``(dp, fsdp)``, sequence over
    ``seq_axis``, heads over ``tp``), the ring over ``mesh``'s ``seq_axis``
    group (``parallel/mesh.py::TrainMesh``)."""
    ring = Ring(tuple(mesh.members(seq_axis)), mesh.index(seq_axis), collectives.current())
    return ring_attention(q, k, v, ring, causal=causal)
