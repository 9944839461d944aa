"""Int8/int4 weight-only quantization: the port of ``tpu_nexus/models/quant.py``.

Decode re-reads every weight each step, so storing the matmul weights in
fewer bits is the serving lever; activations and accumulation stay as they
are.  Same recipes and layouts as the reference, bit for bit:

* :class:`QTensor` — int8 values in the weight's ORIGINAL shape +
  per-output-channel f32 scales (amax over the contraction dims / 127).
* :class:`QTensor4` — packed int4 (two signed nibbles per int8 byte) in a
  2D-ified ``[*lead, K/2, N]`` layout + group-wise f32 scales
  ``[*lead, K/G, N]``.  Packing is per-group half-split: within each
  ``G``-row window, packed row ``i`` holds unpacked row ``i`` in its low
  nibble and row ``i + G/2`` in its high nibble.

Both are plain classes holding tensors: ``.to(dtype)`` dequantizes (the
reference's ``.astype``) and ``[li]`` slices ``q`` and ``s`` together, so
the stacked ``[L, ...]`` leaves slice per layer like any other weight.
The classes themselves live in ``ops/qtensor.py`` (the dequant-matmul
wrapper dispatches on them) and are re-exported here; every matmul weight
of the model zoo is consumed through
``ops/quant_matmul.py::weight_einsum``.

Embeddings and norms keep their dtype.  A quantized tree lives in
:class:`QuantizedParams`, a frozen mapping that reads like ``LlamaParams``
and refuses training.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from tpu_nexus_torch.ops.qtensor import (  # noqa: F401 - the classes are part of this module's surface
    QTensor,
    QTensor4,
    _pack_nibbles,
    _prod,
    _unpack_nibbles,
)

#: default int4 group size: divides every contraction width of the model
#: zoo (tiny hidden 64 .. llama3_8b intermediate 14336)
DEFAULT_INT4_GROUP = 64


#: contraction axes per weight name, counted from the END so the same rule
#: covers the Llama stacks [L, ...] and expert stacks [L, E, ...]
_CONTRACT_AXES: Dict[str, tuple] = {
    "wq": (-3,),
    "wk": (-3,),
    "wv": (-3,),
    "wo": (-3, -2),
    "w_gate": (-2,),
    "w_up": (-2,),
    "w_down": (-2,),
}


def quantize_tensor(w: torch.Tensor, axes: tuple, amax_reduce: Any = None) -> QTensor:
    """Symmetric int8: amax over ``axes`` / 127, round half to even.
    ``amax_reduce(amax)`` completes the amax where ``w`` is one rank's
    slice of a contraction dim (a max over the ranks holding the rest)."""
    w32 = w.detach().float()
    amax = torch.amax(torch.abs(w32), dim=axes, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    s = amax / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QTensor(q, s)


def _split_shape(shape: tuple, axes: tuple) -> Tuple[tuple, tuple, tuple]:
    """``(lead, contract, out)`` sub-shapes for one ``_CONTRACT_AXES``
    entry: every quantizable weight is laid out ``[*lead, *contract,
    *out]``, which makes the 2D-ified ``[K, N]`` layout a contiguous
    reshape."""
    shape = tuple(shape)
    n_out = -max(axes) - 1
    n_contract = len(axes)
    lead = shape[: len(shape) - n_contract - n_out]
    contract = shape[len(lead) : len(lead) + n_contract]
    out = shape[len(shape) - n_out :]
    return lead, contract, out


def quantize_tensor_int4(w: torch.Tensor, axes: tuple, group: int, *, name: str = "?") -> QTensor4:
    """Symmetric int4 with group-wise scales: amax over each ``group``-row
    window of the 2D-ified ``[K, N]`` weight / 7 (nibbles stay in
    [-7, 7])."""
    lead, contract, out = _split_shape(w.shape, axes)
    k, n = _prod(contract), _prod(out)
    if group <= 0 or group % 2:
        raise ValueError(f"int4 group size must be a positive even number, got {group}")
    if k % group:
        raise ValueError(
            f"int4 group size {group} does not divide weight {name!r}'s "
            f"contraction width {k} (shape {tuple(w.shape)}) — pick a "
            "group that divides every quantized contraction dim "
            "(NEXUS_QUANT_GROUP)"
        )
    w32 = w.detach().float().reshape(*lead, k // group, group, n)
    s = torch.amax(torch.abs(w32), dim=-2, keepdim=True) / 7.0
    s = torch.clamp_min(s, 1e-12)
    q4 = torch.clamp(torch.round(w32 / s), -7, 7).to(torch.int8)
    packed = _pack_nibbles(q4.reshape(*lead, k, n), group)
    return QTensor4(packed, s[..., 0, :], contract, out, group)


def _by_layer(fn, w: torch.Tensor):
    """``fn`` over each slice of a stacked ``[L, ...]`` leaf, gathered into
    one stacked quantized leaf.  The scales never reduce over the lead dim,
    so the result equals ``fn(w)`` bit for bit, while the f32 temporaries
    are one layer's, not the stack's."""
    first = fn(w[0])
    q = torch.empty((w.shape[0], *first.q.shape), dtype=first.q.dtype, device=w.device)
    s = torch.empty((w.shape[0], *first.s.shape), dtype=first.s.dtype, device=w.device)
    q[0], s[0] = first.q, first.s
    for li in range(1, w.shape[0]):
        one = fn(w[li])
        q[li], s[li] = one.q, one.s
    if isinstance(first, QTensor4):
        return QTensor4(q, s, first.contract_shape, first.out_shape, first.group)
    return QTensor(q, s)


class QuantizedParams:
    """A frozen parameter tree with quantized matmul weights.

    Reads like ``LlamaParams`` — ``params["layers"][name]``, ``"lm_head" in
    params``, ``.keys()`` — over detached tensors and
    :class:`QTensor`/:class:`QTensor4` leaves.  It is for serving: int8
    storage has no gradient, so asking it for trainable parameters
    raises."""

    def __init__(self, tree: Dict[str, Any]) -> None:
        self._tree = dict(tree)

    def __getitem__(self, key: str):
        return self._tree[key]

    def __contains__(self, key: str) -> bool:
        return key in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def keys(self):
        return list(self._tree)

    def named_parameters(self, *args, **kwargs):
        raise TypeError(
            "a quantized parameter tree is frozen (int8 storage has no "
            "gradient): quantize after training, for serving only"
        )

    parameters = named_parameters


def quantize_params(params, mode: str = "int8", group: int = 0, amax_reduce: Any = None) -> QuantizedParams:
    """Quantize every matmul weight stack of a Llama params tree (norms and
    embeddings keep their dtype); the result drops into ``generate`` and
    the forward unchanged.  IDEMPOTENT: already-quantized leaves pass
    through.  ``group`` is the int4 group size (0 =
    :data:`DEFAULT_INT4_GROUP`; ignored for int8).  Stacked leaves are
    quantized a layer at a time (see :func:`_by_layer`).  On one rank of a
    sharded tree, ``amax_reduce(name)`` gives the int8 amax completion of
    weight ``name`` (None where the rank holds whole contraction dims), so
    the scales equal those of the whole tree; int4 groups lie within a
    rank's rows and need none."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantize mode {mode!r}; use 'int8' or 'int4'")
    g = group or DEFAULT_INT4_GROUP
    layers = {
        name: w if isinstance(w, (QTensor, QTensor4)) else w.detach()
        for name, w in params["layers"].items()
    }
    for name, axes in _CONTRACT_AXES.items():
        w = layers.get(name)
        if w is None or isinstance(w, (QTensor, QTensor4)):
            continue
        if mode == "int8":
            red = amax_reduce(name) if amax_reduce is not None else None
            fn = lambda t, axes=axes, red=red: quantize_tensor(t, axes, red)  # noqa: E731
        else:
            fn = lambda t, axes=axes, name=name: quantize_tensor_int4(t, axes, g, name=name)  # noqa: E731
        lead, _, _ = _split_shape(w.shape, axes)
        layers[name] = _by_layer(fn, w) if lead else fn(w)
    tree: Dict[str, Any] = {}
    for key in params.keys():
        if key == "layers":
            tree[key] = layers
        elif key == "embed":
            tree[key] = {k: v.detach() for k, v in params["embed"].items()}
        else:
            tree[key] = params[key].detach()
    return QuantizedParams(tree)


def tree_leaves(params) -> Iterator[torch.Tensor]:
    """Every tensor of a params tree (``LlamaParams``, :class:`QuantizedParams`
    or nested dicts), the ``q`` and ``s`` of quantized leaves included."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, (QTensor, QTensor4)):
        yield params.q
        yield params.s
    else:
        for key in params.keys():
            yield from tree_leaves(params[key])


def quantized_bytes(params) -> int:
    """Weight bytes a decode step reads, leaves counted at their STORED
    width: int8 values 1 byte + scales; packed nibbles at their int8 byte
    count (``q.numel()`` is already ``K*N/2``) + the f32 group scales;
    everything else its itemsize."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(params))
