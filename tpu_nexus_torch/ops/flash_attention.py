"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd function that trains through them.

Replaces ``tpu_nexus/ops/flash_attention.py``: ``_fwd_kernel`` (launched
by ``_flash_forward``; ``csrc/flash_attention.cu``) and the backward's
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (launched by
``_flash_backward``; ``csrc/flash_attention_bwd.cu``).  Each source note
says what bounds its kernel on the H100 and how the design answers that.

* :func:`flash_attention_plain` / :func:`flash_attention_bwd_plain` are
  the same functions in plain PyTorch, step for step the TPU kernels'
  arithmetic without the tiling: q pre-scaled by ``scale·log2(e)`` and
  rounded to the input dtype, scores in the exp2 domain, P (and in the
  backward dS) rounded to the input dtype before their products, f32
  sums, natural-log lse.
* :func:`flash_attention`, :func:`flash_attention_bwd_dq` and
  :func:`flash_attention_bwd_dkv` are the wrappers: a CPU tensor takes
  the plain version, a CUDA tensor launches the kernel (counted in the
  wrapper's ``launches``) or raises.  There is no fallback from one to
  the other.
* :class:`FlashAttention` differentiates through them: the forward as
  the dispatcher op ``nexus::flash_fwd`` (so selective checkpointing can
  keep its outputs), the backward as ``rowsum(dO∘O)`` and the q prescale
  (:func:`flash_bwd_qt`, once for both kernels) in plain torch, then the
  dQ and dK/dV kernels.

Shapes: q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]`` (self-attention, any
S, ``Hq % Hkv == 0``); the kernels take D 64 or 128 in bf16 or f32.  The
forward returns ``(out [B, S, Hq, D], lse [B, Hq, S] f32)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_nexus_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Inputs the CUDA kernel takes."""
    return (
        q.is_cuda
        and k.device == q.device
        and v.device == q.device
        and q.dim() == 4
        and q.shape[-1] in (64, 128)
        and q.dtype in _DTYPES
        and k.dtype == q.dtype
        and v.dtype == q.dtype
        and q.shape[1] == k.shape[1]
        and k.shape == v.shape
        and q.shape[2] % k.shape[2] == 0
    )


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not flash_supported(q, k, v):
        raise ValueError(
            "flash_attention kernel unsupported inputs: q "
            f"{tuple(q.shape)} {q.dtype} on {q.device}, k {tuple(k.shape)} "
            f"{k.dtype}, v {tuple(v.shape)} {v.dtype} (needs CUDA tensors, "
            "head_dim 64|128, bf16|f32, self-attention, Hq % Hkv == 0)"
        )


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel (see module docstring)."""
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if scale is None:
        scale = d**-0.5
    g = hq // hkv
    qt = (q.float() * (scale * _LOG2E)).to(q.dtype).reshape(b, s, hkv, g, d)
    s2 = torch.einsum("bqhgd,bkhd->bhgqk", qt.float(), k.float())  # log2 domain
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + (sk - s)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s2 = s2.masked_fill(q_pos < k_pos, float("-inf"))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = (acc / lsum).permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)
    lse = (m / _LOG2E + torch.log(lsum))[..., 0].reshape(b, hq, s)
    return out, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward, ``(out, lse)``.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel (and
    count the launch in ``flash_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_kernel_inputs(q, k, v)
    b, s, hq, d = q.shape
    if scale is None:
        scale = d**-0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):  # the runtime launches on its current device
        status = lib.nexus_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, hq, k.shape[2], d, _DTYPES[q.dtype], float(scale * _LOG2E),
            int(bool(causal)), _build.stream_ptr(q.device),
        )
    _build.check(status, "nexus_flash_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


# -- backward ------------------------------------------------------------------


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, step for step the TPU
    kernels' arithmetic without the tiling (``_flash_backward``): q
    pre-scaled by ``scale·log2(e)`` and rounded to the input dtype,
    ``P = exp2(q̃·kᵀ − lse·log2 e)`` (0 where masked), ``dS = P∘(dO·vᵀ −
    rowsum(dO∘O))``, P and dS rounded to the input dtype before their
    products, f32 sums, ``dQ·scale`` and ``dK/log2 e`` at flush.  ``out``
    is the forward's output ``[B, S, Hq, D]`` and ``lse`` its ``[B, Hq, S]``
    natural-log logsumexp.  Returns ``(dq, dk, dv)`` in the inputs' layouts
    and dtype."""
    return _bwd_plain_parts(q, k, v, dout, lse, flash_dsum(out, dout), causal, scale)


def _bwd_plain_parts(q, k, v, dout, lse, dsum, causal, scale):
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if scale is None:
        scale = d**-0.5
    g = hq // hkv
    dt = q.dtype
    qg = flash_bwd_qt(q, scale).reshape(b, s, hkv, g, d).float()
    dog = dout.reshape(b, s, hkv, g, d).float()
    s2 = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    lse2 = (lse.float() * _LOG2E).reshape(b, hkv, g, s)[..., None]
    p = torch.exp2(s2 - lse2)
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + (sk - s)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        p = p.masked_fill(q_pos < k_pos, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - dsum.reshape(b, hkv, g, s)[..., None])).to(dt).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * (1.0 / _LOG2E)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dt).float(), dog)
    return dq.reshape(b, s, hq, d).to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_qt(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q̃ = q·scale·log2(e)`` in f32, rounded to q's dtype: the backward's
    one q prescale, which both kernels read (``_flash_backward`` computes
    ``qt`` once in XLA for both Pallas kernels).  One pass: PyTorch
    multiplies a bf16 tensor by a Python scalar in f32 and rounds once, so
    this is ``(q.float() * c).to(q.dtype)`` bit for bit (held so by the
    tests, on the CPU and on the card) without its f32 temporaries."""
    return q * (scale * _LOG2E)


def flash_dsum(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO∘O)`` in f32, ``[B, Hq, S]`` (outside the kernels, as in
    the TPU design); ``out`` is widened to f32 inside the product."""
    return (dout.float() * out).sum(-1).transpose(1, 2).contiguous()


def _bwd_checked(q, k, v, dout, lse, dsum, qt, scale):
    """``(q̃, k, v, dout, lse, dsum)`` contiguous, with q̃ :func:`flash_bwd_qt`
    of q where ``qt`` is None; raise unless the backward kernels take them."""
    b, s, hq, d = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    ok = (
        flash_supported(q, k, v)
        and all(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device
                for t in (dout, q if qt is None else qt))
        and all(
            t.shape == (b, hq, s) and t.dtype == torch.float32 and t.device == q.device
            for t in (lse, dsum)
        )
    )
    if not ok:
        raise ValueError(
            "flash_attention backward kernels unsupported inputs: q "
            f"{tuple(q.shape)} {q.dtype} on {q.device}, k {tuple(k.shape)} {k.dtype}, dout "
            f"{tuple(dout.shape)} {dout.dtype}, lse {tuple(lse.shape)} {lse.dtype}, dsum "
            f"{tuple(dsum.shape)} {dsum.dtype} (needs CUDA tensors, head_dim 64|128, "
            "bf16|f32, self-attention, Hq % Hkv == 0, dout and q̃ like q, lse and dsum "
            "[B, Hq, S] f32)"
        )
    if qt is None:
        qt = flash_bwd_qt(q, scale)
    return tuple(t.contiguous() for t in (qt, k, v, dout, lse, dsum))


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
    dsum: torch.Tensor, *, causal: bool = True, scale: Optional[float] = None,
    qt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dQ kernel's wrapper: CPU tensors take the plain version's dQ;
    CUDA tensors launch the kernel (counted in
    ``flash_attention_bwd_dq.launches``) or raise.  ``dsum`` is
    :func:`flash_dsum`; ``qt`` is :func:`flash_bwd_qt` of q, computed here
    when not given."""
    if q.device.type == "cpu":
        return _bwd_plain_parts(q, k, v, dout, lse, dsum, causal, scale)[0]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt, k, v, dout, lse, dsum = _bwd_checked(q, k, v, dout, lse, dsum, qt, scale)
    b, s, hq, d = qt.shape
    dq = torch.empty_like(qt)
    with torch.cuda.device(q.device):
        status = _build.library().nexus_flash_bwd_dq(
            qt.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), b, s, hq, k.shape[2], d, _DTYPES[q.dtype],
            float(scale), int(bool(causal)), _build.stream_ptr(q.device),
        )
    _build.check(status, "nexus_flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
    dsum: torch.Tensor, *, causal: bool = True, scale: Optional[float] = None,
    qt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's wrapper: CPU tensors take the plain version's
    dK/dV; CUDA tensors launch the kernel (counted in
    ``flash_attention_bwd_dkv.launches``) or raise.  ``qt`` as for
    :func:`flash_attention_bwd_dq`."""
    if q.device.type == "cpu":
        return _bwd_plain_parts(q, k, v, dout, lse, dsum, causal, scale)[1:]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt, k, v, dout, lse, dsum = _bwd_checked(q, k, v, dout, lse, dsum, qt, scale)
    b, s, hq, d = qt.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = _build.library().nexus_flash_bwd_dkv(
            qt.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, hq, k.shape[2], d,
            _DTYPES[q.dtype], int(bool(causal)), _build.stream_ptr(q.device),
        )
    _build.check(status, "nexus_flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, *, causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward, ``(dq, dk, dv)``.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors compute ``dsum`` and q̃
    once, then launch the dQ and dK/dV kernels, or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal, scale=scale)
    if out.shape != dout.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} differ")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dsum = flash_dsum(out, dout)
    qt = flash_bwd_qt(q, scale)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, dsum, causal=causal, scale=scale, qt=qt)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, dsum, causal=causal, scale=scale, qt=qt)
    return dq, dk, dv


# -- autograd ------------------------------------------------------------------


@torch.library.custom_op("nexus::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` as one dispatcher op, so that selective
    activation checkpointing (``models/llama.py``) can keep its outputs and
    never re-run it in the backward."""
    return flash_attention(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel (through
    :func:`flash_fwd_op`), and in the backward ``dsum`` then the dQ and
    dK/dV kernels.  On CPU tensors both halves take their plain versions.
    Saves q, k, v, out and lse; returns out ``[B, S, Hq, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd_op(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention_differentiable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:class:`FlashAttention` with the default scale; out ``[B, S, Hq, D]``.
    Inputs off the CPU that the kernels do not take raise here, before the
    dispatcher sees them."""
    if q.device.type != "cpu":
        _check_kernel_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))
