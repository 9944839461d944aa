"""Seeded weights in the port's parameter layout, made on the device.

Each stacked leaf (``layers/wq`` is ``[L, E, Hq, D]`` ...) is one draw of a
``torch.Generator`` on the device, seeded from the run's seed and the leaf's
place, straight in the dtype the configuration serves or trains in: a dozen
large calls for the whole model, and any one leaf can be drawn again alone
(the reference and the training check do so).  Normal with fan-in scaling,
norms 1.  This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.roofline import dims


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """``(path, shape, fan_in)`` of every leaf in the port's tree order;
    fan_in 0 marks a norm (ones)."""
    g = dims(cfg)
    e, f, hq, hkv, d, l, v, ne = g["e"], g["f"], g["hq"], g["hkv"], g["d"], g["l"], g["v"], g["ne"]
    layer = [
        ("attn_norm", (l, e), 0),
        ("wq", (l, e, hq, d), e),
        ("wk", (l, e, hkv, d), e),
        ("wv", (l, e, hkv, d), e),
        ("wo", (l, hq, d, e), hq * d),
        ("mlp_norm", (l, e), 0),
    ]
    if ne:
        layer += [
            ("router", (l, e, ne), e),
            ("w_gate", (l, ne, e, f), e),
            ("w_up", (l, ne, e, f), e),
            ("w_down", (l, ne, f, e), f),
        ]
    else:
        layer += [("w_gate", (l, e, f), e), ("w_up", (l, e, f), e), ("w_down", (l, f, e), f)]
    out = [(f"layers/{n}", s, fi) for n, s, fi in layer]
    out.append(("embed/tokens", (v, e), e))
    out.append(("out_norm", (e,), 0))
    if not cfg.get("tie_word_embeddings", False):
        out.append(("lm_head", (e, v), e))
    return out


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a run seeded ``seed``."""
    return (abs(seed) * 1_000_003 + index * 7_919 + (seed < 0)) % (1 << 63)


def make_leaf(cfg: Dict, seed: int, path: str, device, dtype) -> torch.Tensor:
    """One leaf, drawn alone: the same numbers :func:`make_tree` gives it."""
    for index, (p, shape, fan_in) in enumerate(leaves(cfg)):
        if p == path:
            if not fan_in:
                return torch.ones(shape, dtype=dtype, device=device)
            gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            return t.mul_(fan_in ** -0.5)
    raise KeyError(path)


def make_tree(cfg: Dict, seed: int, device, dtype) -> Dict:
    """The whole parameter tree: ``{"embed": {"tokens"}, "layers": {...},
    "out_norm", "lm_head"}``."""
    tree: Dict = {"embed": {}, "layers": {}}
    for path, _, _ in leaves(cfg):
        t = make_leaf(cfg, seed, path, device, dtype)
        head, _, tail = path.partition("/")
        if tail:
            tree[head][tail] = t
        else:
            tree[head] = t
    return tree


def param_name(path: str) -> str:
    """A tree path as the port's module names it (``layers/wq`` ->
    ``layers.wq``)."""
    return path.replace("/", ".")
