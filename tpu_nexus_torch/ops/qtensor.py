"""The quantized weight containers: int8 :class:`QTensor` and packed-int4
:class:`QTensor4`, with the nibble packing they share.

Plain classes holding tensors, counterparts of the pytree classes of
``tpu_nexus/models/quant.py``.  They live under ``ops`` because the
dequant-matmul wrapper (``ops/quant_matmul.py``) dispatches on them;
``models/quant.py`` holds the recipes that make them and re-exports them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


class QTensor:
    """Int8 values + broadcast-ready f32 scales; ``to`` dequantizes."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        self.q = q
        self.s = s

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        return self.q.to(dtype) * self.s.to(dtype)

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.s[idx])

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"QTensor(int8 {tuple(self.q.shape)}, scales {tuple(self.s.shape)})"


def _pack_nibbles(q4: torch.Tensor, group: int) -> torch.Tensor:
    """``[*lead, K, N]`` int4-valued int8 -> ``[*lead, K/2, N]`` packed, in
    the per-group half-split order (see the module docstring)."""
    lead = q4.shape[:-2]
    k, n = q4.shape[-2], q4.shape[-1]
    g = q4.reshape(*lead, k // group, group, n)
    lo, hi = g[..., : group // 2, :], g[..., group // 2 :, :]
    packed = torch.bitwise_or(torch.bitwise_and(lo, 15), torch.bitwise_left_shift(hi, 4))
    return packed.reshape(*lead, k // 2, n)


def _unpack_nibbles(packed: torch.Tensor, group: int) -> torch.Tensor:
    """Inverse of :func:`_pack_nibbles`: sign-extend both nibbles
    (arithmetic shifts on int8) and undo the per-group half-split."""
    lead = packed.shape[:-2]
    kp, n = packed.shape[-2], packed.shape[-1]
    g = packed.reshape(*lead, (2 * kp) // group, group // 2, n)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(g, 4), 4)
    hi = torch.bitwise_right_shift(g, 4)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * kp, n)


class QTensor4:
    """Packed int4 values + group-wise f32 scales; ``to`` dequantizes.

    ``q`` is ``[*lead, K/2, N]`` int8, ``s`` is ``[*lead, K/G, N]`` f32.
    Only the TRAILING logical shape is kept beside them
    (``contract_shape``/``out_shape``/``group``), so ``[li]`` on a stacked
    leaf gives a valid QTensor4 with the lead dim dropped."""

    def __init__(
        self, q: torch.Tensor, s: torch.Tensor, contract_shape: Tuple[int, ...],
        out_shape: Tuple[int, ...], group: int,
    ) -> None:
        self.q = q
        self.s = s
        self.contract_shape = tuple(int(d) for d in contract_shape)
        self.out_shape = tuple(int(d) for d in out_shape)
        self.group = int(group)

    @property
    def shape(self):
        return tuple(self.q.shape[:-2]) + self.contract_shape + self.out_shape

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        lead = self.q.shape[:-2]
        k = 2 * self.q.shape[-2]
        n = self.q.shape[-1]
        vals = _unpack_nibbles(self.q, self.group).float()
        vals = vals.reshape(*lead, k // self.group, self.group, n)
        w = vals * self.s.float()[..., :, None, :]
        return w.reshape(*lead, *self.contract_shape, *self.out_shape).to(dtype)

    def __getitem__(self, idx) -> "QTensor4":
        if self.q.ndim <= 2:
            raise IndexError("QTensor4 without lead dims cannot be sliced")
        return QTensor4(self.q[idx], self.s[idx], self.contract_shape, self.out_shape, self.group)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"QTensor4(packed int4 {tuple(self.q.shape)}, group {self.group} "
            f"scales {tuple(self.s.shape)}, logical {self.shape})"
        )
