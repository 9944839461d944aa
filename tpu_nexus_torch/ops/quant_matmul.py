"""Dequant-inside-matmul for weight-only-quantized decode: the CUDA kernels'
wrapper, their plain version, and the models' weight-matmul call site.

Replaces ``tpu_nexus/ops/quant_matmul.py``: ``_int8_kernel`` and
``_int4_kernel`` (launched by ``quant_matmul``) and ``weight_einsum``.  The
kernels live in ``csrc/quant_matmul.cu``; the source note there says what
bounds them on the H100 (the packed weight's bytes at decode-sized M) and
what the design does about it.

* :func:`quant_matmul_plain` — the kernels' arithmetic in PyTorch, in
  their operation order.  int8: ``x · q8`` accumulated in f32, the
  per-output-channel scale applied once to the sum, cast to x's dtype.
  int4: nibbles unpacked, ``vals · s`` in f32, ROUNDED to x's dtype, then
  the product accumulated in f32.
* :func:`quant_matmul` — the wrapper for a 2D ``x [M, K]``: validation
  that names every violated clause; a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel (counted in ``launches_int8`` /
  ``launches_int4``) or raises.
* :func:`weight_einsum` — ``einsum(spec, x, w)`` with the weight consumed
  at the compute dtype.  Plain tensors take the unchanged ``torch.einsum``.
  Quantized weights go to :func:`quant_matmul` on the card when
  :func:`quant_matmul_supported` holds (decode-sized M, no lead dims) and
  otherwise to ``einsum(spec, x, w.to(ct))``, dequantize-then-matmul — the
  prefill path, expert stacks and the CPU, as in the reference outside its
  kernels.  ``impl="plain"`` (or ``NEXUS_QUANT_KERNEL=plain``, which
  replaces the ``auto`` default) forces the latter everywhere.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from tpu_nexus_torch.ops import _build
from tpu_nexus_torch.ops.qtensor import QTensor, QTensor4, _prod, _unpack_nibbles

IMPLS = ("auto", "plain")
#: cap on the activation rows of the fused path: decode-sized M (batch ·
#: q_len); prefill's M = batch · seq belongs on the dense matmul
MAX_FUSED_M = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: weight columns per CTA (one 4-byte load per lane), activation rows per
#: CTA, and weight rows (packed rows for int4) per staged tile in the kernel
COLS = 128
ROWS_M = 8
TILE_ROWS = 128
#: CTAs the K-split fills (four resident CTAs on each of the H100's 132 SMs)
TARGET_CTAS = 528


def _geometry(w) -> Tuple[tuple, tuple, tuple]:
    """``(lead, contract, out)`` sub-shapes of a quantized weight.
    ``QTensor4`` carries its split beside the data.  ``QTensor`` stores q in
    the ORIGINAL weight shape; its contraction dims are exactly the dims
    its keepdim scale collapsed to 1 — a contiguous run, anything before it
    a batching lead (expert stacks), anything after it the output dims."""
    if isinstance(w, QTensor4):
        nl = w.q.ndim - 2
        return tuple(w.q.shape[:nl]), w.contract_shape, w.out_shape
    dims = [d for d in range(w.q.ndim) if w.s.shape[d] == 1 and w.q.shape[d] != 1]
    first, last = dims[0], dims[-1]
    shape = tuple(w.q.shape)
    return shape[:first], shape[first : last + 1], shape[last + 1 :]


def quant_matmul_supported(x: torch.Tensor, w) -> bool:
    """Inputs :func:`weight_einsum` sends to :func:`quant_matmul` when ``x``
    is on a card: a quantized weight with no batching lead dims; x's
    trailing dims are the weight's contraction dims; decode-sized M
    (:data:`MAX_FUSED_M`).  Any K and N: the kernels mask ragged edges
    themselves.  An activation dtype the kernels do not take, or a weight
    on another device, is NOT a reason to dequantize instead:
    :func:`quant_matmul` raises on it and names the clause."""
    if not isinstance(w, (QTensor, QTensor4)):
        return False
    lead, contract, _ = _geometry(w)
    if lead:
        return False
    nc = len(contract)
    if x.ndim <= nc or tuple(x.shape[x.ndim - nc :]) != tuple(contract):
        return False
    if _prod(x.shape[: x.ndim - nc]) > MAX_FUSED_M:
        return False
    return x.device.type != "cpu"


def quant_matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """Plain PyTorch version of the kernels for ``x [M, K]`` and a
    lead-dim-free quantized weight (see the module docstring)."""
    _, contract, out = _geometry(w)
    k, n = _prod(contract), _prod(out)
    if isinstance(w, QTensor4):
        vals = _unpack_nibbles(w.q.reshape(k // 2, n), w.group).float()
        wd = (vals.reshape(k // w.group, w.group, n) * w.s.reshape(k // w.group, 1, n).float())
        wd = wd.reshape(k, n).to(x.dtype)
        return (x.float() @ wd.float()).to(x.dtype)
    acc = x.float() @ w.q.reshape(k, n).float()
    return (acc * w.s.reshape(1, n).float()).to(x.dtype)


def split_plan(rows: int, n: int, m: int) -> Tuple[int, int]:
    """(rows_per_split, n_splits) over the weight's rows (packed rows for
    int4): as many K-splits as keep column strips · M tiles · splits within
    :data:`TARGET_CTAS` (the CTAs resident at once, so the grid is one even
    wave and not a full wave plus a thin one), each a whole number of
    kernel tiles."""
    strips = -(-n // COLS) * -(-m // ROWS_M)
    n_tiles = -(-rows // TILE_ROWS)
    max_splits = max(1, TARGET_CTAS // strips)
    tiles_per_split = -(-n_tiles // max_splits)
    rows_per_split = tiles_per_split * TILE_ROWS
    return rows_per_split, -(-rows // rows_per_split)


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Fused ``x @ dequant(w)`` for a 2D activation ``x`` [M, K] against a
    lead-dim-free :class:`QTensor` (int8, per-output-channel scales) or
    :class:`QTensor4` (packed int4, group scales).  Returns [M, N] in x's
    dtype with f32 accumulation.  A CPU tensor takes
    :func:`quant_matmul_plain`; a CUDA tensor launches the kernel or
    raises."""
    if not isinstance(w, (QTensor, QTensor4)):
        raise TypeError(f"quant_matmul needs a QTensor or QTensor4 weight, got {type(w).__name__}")
    int4 = isinstance(w, QTensor4)
    lead, contract, out = _geometry(w)
    k, n = _prod(contract), _prod(out)
    problems = []
    if lead:
        problems.append(
            f"weight has batching lead dims {tuple(lead)} (MoE expert stack) — the kernel is 2D"
        )
    if x.ndim != 2:
        problems.append(f"x must be 2D [M, K], got {tuple(x.shape)}")
    elif x.shape[1] != k:
        problems.append(f"x K {x.shape[1]} != weight contraction width {k}")
    if x.ndim == 2 and x.shape[0] > MAX_FUSED_M:
        problems.append(
            f"M {x.shape[0]} > MAX_FUSED_M {MAX_FUSED_M} (prefill-sized "
            "activations belong on the dense matmul path)"
        )
    if x.ndim == 2 and x.shape[0] < 1:
        problems.append("M must be >= 1")
    if x.device.type != "cpu":
        if not x.is_cuda or w.q.device != x.device or w.s.device != x.device:
            problems.append(
                f"x on {x.device}, weight on {w.q.device} (the kernel needs both on one CUDA device)"
            )
        if x.dtype not in _DTYPES:
            problems.append(f"x dtype {x.dtype} (the kernel takes bfloat16 or float32)")
    if problems:
        raise ValueError(
            "quant_matmul unsupported inputs: " + "; ".join(problems)
            + " — use the dequantize-then-einsum path (weight_einsum auto dispatch)"
        )
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w)

    m = x.shape[0]
    x = x.contiguous()
    if int4:
        q2 = w.q.reshape(k // 2, n).contiguous()
        s2 = w.s.reshape(k // w.group, n).float().contiguous()
        rows, half_group = k // 2, w.group // 2
    else:
        q2 = w.q.reshape(k, n).contiguous()
        s2 = w.s.reshape(n).float().contiguous()
        rows, half_group = k, 0
    rows_per_split, n_splits = split_plan(rows, n, m)
    part = torch.empty((n_splits, m, n), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        status = lib.nexus_quant_matmul(
            x.data_ptr(), q2.data_ptr(), s2.data_ptr(), y.data_ptr(), part.data_ptr(),
            m, k, n, half_group, rows_per_split, n_splits, _DTYPES[x.dtype],
            _build.stream_ptr(x.device),
        )
    _build.check(status, "nexus_quant_matmul")
    if int4:
        quant_matmul.launches_int4 += 1
    else:
        quant_matmul.launches_int8 += 1
    return y


quant_matmul.launches_int8 = 0
quant_matmul.launches_int4 = 0


def weight_einsum(spec: str, x: torch.Tensor, w, ct: torch.dtype, *, impl: str = "auto") -> torch.Tensor:
    """The models' weight-matmul call site: ``einsum(spec, x, w)`` with the
    weight consumed at compute dtype ``ct`` (see the module docstring for
    the dispatch).  The fused path assumes the spec's standard
    weight-matmul shape: ``x``'s trailing dims are exactly the weight's
    contraction dims and the output appends the weight's out dims (true of
    every projection/MLP spec of the model zoo)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown weight_einsum impl {impl!r}; use 'auto' or 'plain'")
    if not isinstance(w, (QTensor, QTensor4)):
        return torch.einsum(spec, x, w.to(ct))
    if impl == "auto":
        impl = os.environ.get("NEXUS_QUANT_KERNEL", "") or "auto"
        if impl not in IMPLS:
            raise ValueError(
                f"NEXUS_QUANT_KERNEL={impl!r} is not a weight-matmul impl; "
                "use 'plain' (unset = auto)"
            )
    x = x.to(ct)
    if impl == "plain" or not quant_matmul_supported(x, w):
        return torch.einsum(spec, x, w.to(ct))
    _, contract, out = _geometry(w)
    batch = x.shape[: x.ndim - len(contract)]
    return quant_matmul(x.reshape(_prod(batch), _prod(contract)), w).reshape(*batch, *out)
