"""The models' weight-matmul call site.

Counterpart of the plain-weight branch of
``tpu_nexus/ops/quant_matmul.py::weight_einsum``: the weight is cast to the
compute dtype and contracted with ``torch.einsum``.  Quantized weights
(the int8/int4 dequant-matmul kernels) are a later slice of the port.
"""

from __future__ import annotations

import torch


def weight_einsum(spec: str, x: torch.Tensor, w, ct: torch.dtype) -> torch.Tensor:
    """``einsum(spec, x, w.to(ct))``; a quantized leaf raises."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized weight leaf {type(w).__name__}: weight quantization is "
            "not ported yet (ROADMAP.md, 'Weight quantization')"
        )
    return torch.einsum(spec, x, w.to(ct))
