"""RMSNorm, plain PyTorch (the JAX package's default is plain XLA too).

Counterpart of ``tpu_nexus/ops/rmsnorm.py::rms_norm``.  The Pallas
``rms_norm_pallas`` kernel is not on the serving path and is queued for a
later slice (ROADMAP.md).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight, reduction in f32 (bf16-safe)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
