"""Attention dispatch: the flash kernels on the card, dense attention on the CPU.

Counterpart of ``tpu_nexus/ops/attention.py``.  On the card attention is
differentiable through the flash forward kernel and the two backward
kernels (``ops/flash_attention.py::FlashAttention``); on the CPU autograd
runs through :func:`dense_attention`, as the reference's CPU path runs
through XLA's dense attention.  Layout throughout:
``[batch, seq, heads, head_dim]``; GQA is first-class (``k``/``v`` may
have fewer heads than ``q`` as long as the count divides evenly).
"""

from __future__ import annotations

from typing import Optional

import torch

IMPLS = ("auto", "plain")


def _gqa_group(q: torch.Tensor, k: torch.Tensor) -> int:
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    return hq // hkv


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention (O(S²) scores), GQA-aware, f32 accumulation —
    the plain path and the ground truth the kernel is held against."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    g = _gqa_group(q, k)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None, impl: str = "auto",
) -> torch.Tensor:
    """Main entry point.  ``impl``: ``"auto"`` runs :func:`dense_attention`
    on a CPU tensor and :class:`FlashAttention` on any other, whose kernel
    wrappers launch the kernels or raise on inputs they do not take
    (head_dim not 64|128, a dtype other than bf16|f32, ...); ``"plain"``
    forces :func:`dense_attention`."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; use auto|plain")
    if impl == "plain" or q.device.type == "cpu":
        return dense_attention(q, k, v, causal=causal, scale=scale)
    from tpu_nexus_torch.ops.flash_attention import flash_attention_differentiable

    return flash_attention_differentiable(q, k, v, causal=causal, scale=scale)
