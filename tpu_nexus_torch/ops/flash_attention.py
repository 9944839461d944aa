"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces ``tpu_nexus/ops/flash_attention.py::_fwd_kernel`` (launched by
``_flash_forward``), the prefill attention of the serving path.  The kernel
lives in ``csrc/flash_attention.cu``; its source note says what bounds it on
the H100 and how the design answers that.

* :func:`flash_attention_plain` is the same function in plain PyTorch,
  step for step the TPU kernel's arithmetic without the tiling: q
  pre-scaled by ``scale·log2(e)`` and rounded to the input dtype, scores in
  the exp2 domain, p rounded to the input dtype before P·V, f32 carry,
  natural-log lse.
* :func:`flash_attention` is the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises.  There is no
  fallback from one to the other.

Shapes: q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]`` (self-attention, any
S, ``Hq % Hkv == 0``); the kernel takes D 64 or 128 in bf16 or f32.
Returns ``(out [B, S, Hq, D], lse [B, Hq, S] f32)``.
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


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (see module docstring)."""
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
    if not flash_supported(q, k, v):
        raise ValueError(
            "flash_attention kernel unsupported inputs: q "
            f"{tuple(q.shape)} {q.dtype} on {q.device}, k {tuple(k.shape)} "
            f"{k.dtype}, v {tuple(v.shape)} {v.dtype} (needs CUDA tensors, "
            "head_dim 64|128, bf16|f32, self-attention, Hq % Hkv == 0)"
        )
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
