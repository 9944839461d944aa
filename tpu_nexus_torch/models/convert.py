"""Carry Llama and MoE weights between the JAX package's tree and the port, bit-exact.

The JAX package's parameter tree (``tpu_nexus/models/llama.py::
llama_init`` or ``tpu_nexus/models/moe.py::moe_init``) arrives here as
nested dicts of numpy arrays with the same keys and layouts — stacked
``[L, ...]`` per-layer leaves included — so the conversion is a
leaf-for-leaf copy.  bf16 leaves come out of jax as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects: they
travel as an int16 view of the same bits.

A quantized tree (``models/quant.py``) crosses as well: a ``QTensor`` leaf
is the dict ``{"q": int8, "s": f32}``, a ``QTensor4`` leaf that plus its
``contract_shape``, ``out_shape`` and ``group``; a tree with such a leaf
becomes a frozen ``QuantizedParams``.

KV caches, contiguous and pooled, cross both ways too
(:func:`cache_from_numpy`, :func:`cache_to_numpy`), so the two packages'
decode entry points can start from the same cache state.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from tpu_nexus_torch.models import llama, moe
from tpu_nexus_torch.models.llama import LlamaConfig, LlamaParams
from tpu_nexus_torch.models.moe import MoeConfig
from tpu_nexus_torch.models.quant import QTensor, QTensor4, QuantizedParams


def _to_torch(a: Any, device: Any) -> torch.Tensor:
    # a private, writable, C-ordered copy: jax hands out read-only buffers
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 dtype (no JAX involved)

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaf_to_torch(leaf: Any, device: Any):
    if not isinstance(leaf, dict):
        return _to_torch(leaf, device)
    q, s = _to_torch(leaf["q"], device), _to_torch(leaf["s"], device)
    if "group" in leaf:
        return QTensor4(q, s, leaf["contract_shape"], leaf["out_shape"], leaf["group"])
    return QTensor(q, s)


def _leaf_to_numpy(leaf: Any):
    if isinstance(leaf, QTensor4):
        return {
            "q": _to_numpy(leaf.q), "s": _to_numpy(leaf.s), "contract_shape": leaf.contract_shape,
            "out_shape": leaf.out_shape, "group": leaf.group,
        }
    if isinstance(leaf, QTensor):
        return {"q": _to_numpy(leaf.q), "s": _to_numpy(leaf.s)}
    return _to_numpy(leaf)


def params_from_numpy(
    tree: Dict[str, Any], cfg: Union[LlamaConfig, MoeConfig], device: Any = "cuda", shapes: Any = None,
) -> Union[LlamaParams, QuantizedParams]:
    """The JAX package's Llama or MoE tree (numpy leaves) as the port's
    module state on ``device``; shapes are checked against ``cfg`` (an MoE
    tree's layers add the router and the ``[L, n_experts, ...]`` expert
    stacks).  A tree with quantized leaves (see the module docstring) comes
    back as a ``QuantizedParams``.  ``shapes`` (layer key -> shape)
    replaces the config's for a rank's slice."""
    if shapes is None:
        shapes = (moe if isinstance(cfg, MoeConfig) else llama)._layer_shapes(cfg)
    missing = set(shapes) ^ set(tree["layers"])
    if missing:
        raise ValueError(f"layer keys differ from the config's: {sorted(missing)}")
    out = {
        "embed": {"tokens": _to_torch(tree["embed"]["tokens"], device)},
        "layers": {k: _leaf_to_torch(tree["layers"][k], device) for k in shapes},
        "out_norm": _to_torch(tree["out_norm"], device),
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], device)
    if cfg.tied_embeddings == ("lm_head" in out):
        raise ValueError(
            f"tied_embeddings={cfg.tied_embeddings} but the tree "
            f"{'has' if 'lm_head' in out else 'lacks'} an lm_head"
        )
    for k, shape in shapes.items():
        if tuple(out["layers"][k].shape) != shape:
            raise ValueError(f"layers/{k}: shape {tuple(out['layers'][k].shape)} != {shape}")
    if any(isinstance(w, (QTensor, QTensor4)) for w in out["layers"].values()):
        return QuantizedParams(out)
    return LlamaParams(out)


def params_from_numpy_shard(
    tree: Dict[str, Any], cfg: Union[LlamaConfig, MoeConfig], mesh: Any, device: Any = "cuda",
) -> Union[LlamaParams, QuantizedParams]:
    """The per-rank form of :func:`params_from_numpy`: the JAX package's
    tree (numpy leaves, quantized ones included) cut to the part of the
    rank at ``mesh.coords`` under the serving rules
    (``serving/sharded.py``), on ``device``; shapes are checked against
    the rank's share of ``cfg``.  Only that slice is copied."""
    from tpu_nexus_torch.serving.sharded import local_layer_shapes, shard_serving_params

    return params_from_numpy(shard_serving_params(tree, mesh), cfg, device=device,
                             shapes=local_layer_shapes(cfg, mesh))


def params_to_numpy(params: Union[LlamaParams, QuantizedParams]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: nested dicts of numpy
    arrays in the JAX package's keys and layouts."""
    tree: Dict[str, Any] = {
        "embed": {"tokens": _to_numpy(params["embed"]["tokens"])},
        "layers": {k: _leaf_to_numpy(v) for k, v in params["layers"].items()},
        "out_norm": _to_numpy(params["out_norm"]),
    }
    if "lm_head" in params:
        tree["lm_head"] = _to_numpy(params["lm_head"])
    return tree


#: the leaves a KV cache may hold: values, and per-slot scales in int8-KV mode
CACHE_KEYS = ("k", "v", "k_s", "v_s")


def cache_from_numpy(tree: Dict[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """A KV cache of the JAX package (contiguous ``[L, B, max_len, Hkv, D]``
    or pooled ``[L, num_blocks, page, Hkv, D]``, numpy leaves) as the
    port's cache dict on ``device``, bit-exact."""
    extra = set(tree) - set(CACHE_KEYS)
    if extra or not {"k", "v"} <= set(tree) or ("k_s" in tree) != ("v_s" in tree):
        raise ValueError(f"cache keys {sorted(tree)}: want k, v and optionally both k_s, v_s")
    return {name: _to_torch(tree[name], device) for name in CACHE_KEYS if name in tree}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`cache_from_numpy`."""
    return {name: _to_numpy(x) for name, x in cache.items()}


def train_params_from_numpy(tree: Dict[str, Any], layout: Any = None, device: Any = "cuda") -> LlamaParams:
    """A JAX Llama tree (numpy leaves) as training parameters, whole
    (``layout`` None) or cut to one rank's part of a training mesh
    (``workload/train.py::Layout``): each leaf is converted, cut, and only
    the part copied to ``device``."""

    def leaf(path: str, a: Any) -> torch.Tensor:
        t = _to_torch(a, "cpu")
        if layout is not None:
            t = layout.cut(t, layout.specs[path])
        return t.to(device)

    out = {
        "embed": {"tokens": leaf("embed/tokens", tree["embed"]["tokens"])},
        "layers": {k: leaf(f"layers/{k}", v) for k, v in tree["layers"].items()},
        "out_norm": leaf("out_norm", tree["out_norm"]),
    }
    if "lm_head" in tree:
        out["lm_head"] = leaf("lm_head", tree["lm_head"])
    return LlamaParams(out)


def opt_state_from_numpy(
    count: int, leaves: Any, names: Any, layout: Any = None, device: Any = "cuda",
) -> Dict[str, Any]:
    """An optimizer state of the JAX package (optax's adamw ``mu``/``nu``,
    or adafactor's ``v_row``/``v_col``/``v`` of each parameter, numpy) as
    the port's ``{"count", "leaves"}``: ``leaves[i]`` holds the moments of
    parameter ``names[i]`` (the port's flatten order).  With ``layout``
    each moment shaped like its parameter is cut to the rank's part; the
    factored statistics stay whole (replicated)."""
    out = []
    for name, moments in zip(names, leaves):
        spec = layout.param_spec(name) if layout is not None else ()
        out.append({
            key: (layout.cut(_to_torch(a, "cpu"), spec) if layout is not None and key in ("mu", "nu", "v")
                  else _to_torch(a, "cpu")).to(device)
            for key, a in moments.items()
        })
    return {"count": torch.tensor(int(count), dtype=torch.int32, device=device), "leaves": out}
