"""RMSNorm: the plain version the model runs, and kernel #9's wrapper.

Counterpart of ``tpu_nexus/ops/rmsnorm.py``: :func:`rms_norm` is its plain
``rms_norm`` (the JAX package's default, plain XLA there too, and what
every model of the port calls); :func:`rms_norm_kernel` replaces its Pallas
``_rms_kernel`` (launched by ``rms_norm_pallas``) with the CUDA C++ of
``csrc/rmsnorm.cu``: a memory stream (16-byte accesses, a row held in the
registers of one to eight warps and reduced by shuffles, persistent CTAs
that load the next row before storing the current one; the source note
says why).  As in the JAX package, no path of the model launches the
kernel.
"""

from __future__ import annotations

import torch

from tpu_nexus_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest row the kernel takes (8 warps x 32 lanes x 32 elements in registers)
MAX_HIDDEN = 8192


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight, reduction in f32 (bf16-safe)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim through the CUDA kernel (f32 sums in a fixed
    order, the output in x's dtype), counted in
    ``rms_norm_kernel.launches``.  A CPU tensor takes :func:`rms_norm`; a
    CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return rms_norm(x, weight, eps)
    h = x.shape[-1]
    if (not x.is_cuda or weight.device != x.device or x.dtype not in _DTYPES or weight.dtype not in _DTYPES
            or tuple(weight.shape) != (h,) or not 1 <= h <= MAX_HIDDEN or x.numel() == 0):
        raise ValueError(
            f"rms_norm kernel unsupported inputs: x {tuple(x.shape)} {x.dtype} on {x.device}, "
            f"weight {tuple(weight.shape)} {weight.dtype} (needs CUDA tensors, bf16|f32, "
            f"weight [hidden], hidden <= {MAX_HIDDEN})"
        )
    x2 = x.reshape(-1, h).contiguous()
    w = weight.contiguous()
    out = torch.empty_like(x2)
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.nexus_rms_norm(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0], h,
            _DTYPES[x.dtype], _DTYPES[w.dtype], float(eps), _build.stream_ptr(x.device),
        )
    _build.check(status, "nexus_rms_norm")
    rms_norm_kernel.launches += 1
    return out.reshape(x.shape)


#: launches of the kernel
rms_norm_kernel.launches = 0
