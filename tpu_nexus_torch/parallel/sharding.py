"""Logical-axis sharding rules: the port of ``tpu_nexus/parallel/sharding.py``.

Model code names every parameter dimension with a *logical* axis
("embed", "mlp", "heads", "vocab", ...); a rule table maps logical names
to mesh axes.  The tables and :func:`spec_for` are the reference's.  A
spec here is a tuple with one entry per dimension: a mesh axis name, a
tuple of them, or ``None`` (replicated) — what ``PartitionSpec`` holds in
the JAX package.

Where the JAX package hands a spec to GSPMD, the port slices: each rank
holds its own part of every leaf, and :func:`shard_leaf` /
:func:`shard_tree` cut a host tree (numpy arrays or torch tensors) to the
part of one rank's mesh coordinates, reading nothing else.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

#: logical dim name -> mesh axis (or tuple of axes, or None = replicated)
RuleTable = Dict[str, Union[None, str, Tuple[str, ...]]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

#: fully replicated params, batch over (dp, fsdp) — pure data parallelism
LOGICAL_RULES_1D: RuleTable = {
    "batch": ("dp", "fsdp"),
    "seq": None,
    "embed": None,
    "mlp": None,
    "heads": None,
    "kv_heads": None,
    "head_dim": None,
    "vocab": None,
    "expert": None,
    "layers": None,
}

#: params sharded over fsdp and tp, activations batch-sharded over (dp,
#: fsdp) and sequence-sharded over sp
LOGICAL_RULES_FSDP_TP: RuleTable = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "vocab": "tp",
    "expert": "ep",
    "layers": None,
}

#: FSDP_TP plus pipeline parallelism over the stacked layer axis
LOGICAL_RULES_FSDP_TP_PP: RuleTable = {
    **LOGICAL_RULES_FSDP_TP,
    "layers": "pp",
}

#: the SERVING layout (serving/sharded.py): heads/kv-heads/mlp/vocab on
#: ``tp``, experts on ``ep``, everything token-wise replicated
LOGICAL_RULES_SERVE_TP: RuleTable = {
    "batch": None,
    "seq": None,
    "embed": None,
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "vocab": "tp",
    "expert": "ep",
    "layers": None,
}


def spec_for(logical_axes: Sequence[Optional[str]], rules: RuleTable) -> Spec:
    """The spec of one array given its per-dimension logical names.
    Unknown names raise: a typo'd annotation silently replicating a
    parameter would defeat the sharding far from the typo."""
    for name in logical_axes:
        if name is not None and name not in rules:
            raise KeyError(f"unknown logical axis {name!r}; rule table has {sorted(rules)}")
    return tuple(rules[name] if name is not None else None for name in logical_axes)


def _axes_of(entry: Union[None, str, Tuple[str, ...]]) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_index(entry: Union[None, str, Tuple[str, ...]], coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> Tuple[int, int]:
    """``(index, count)`` of one dimension's spec entry for a rank at
    ``coords``: a dim sharded over several axes is cut major-first."""
    index, count = 0, 1
    for axis in _axes_of(entry):
        index = index * sizes.get(axis, 1) + coords.get(axis, 0)
        count *= sizes.get(axis, 1)
    return index, count


def shard_leaf(leaf: Any, spec: Spec, coords: Mapping[str, int], sizes: Mapping[str, int]) -> Any:
    """This rank's contiguous part of one host leaf (numpy or torch) under
    ``spec``.  A sharded dim whose size the shard count does not divide
    raises.  The slice is returned as a view: the caller copies it."""
    if len(spec) != len(leaf.shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a rank-{len(leaf.shape)} leaf")
    index = []
    for dim, entry in enumerate(spec):
        part, count = shard_index(entry, coords, sizes)
        size = int(leaf.shape[dim])
        if count == 1:
            index.append(slice(None))
            continue
        if size % count:
            raise ValueError(f"dim {dim} of a leaf of shape {tuple(leaf.shape)} is not divisible by {count}")
        step = size // count
        index.append(slice(part * step, (part + 1) * step))
    return leaf[tuple(index)]


def shard_tree(tree: Any, spec_tree: Any, coords: Mapping[str, int], sizes: Mapping[str, int]) -> Any:
    """:func:`shard_leaf` over a nested dict whose ``spec_tree`` mirrors it
    (the counterpart of the reference's ``shard_pytree``: the rank reads
    only its own slice of each leaf)."""
    if isinstance(tree, Mapping):
        return {k: shard_tree(tree[k], spec_tree[k], coords, sizes) for k in tree}
    return shard_leaf(tree, spec_tree, coords, sizes)


def effective_spec(spec: Spec, sizes: Mapping[str, int]) -> Spec:
    """``spec`` with the axes of size 1 dropped (a dim cut over nothing is
    replicated): what a rank's slicing and the reductions read."""
    out = []
    for entry in spec:
        axes = tuple(a for a in _axes_of(entry) if sizes.get(a, 1) > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis that cuts some dim of a leaf under ``spec``."""
    return tuple(a for entry in spec for a in _axes_of(entry))


def spec_tree(axes_tree: Any, rules: RuleTable, sizes: Mapping[str, int]) -> Any:
    """The effective spec of every leaf of a logical-axes tree (the port's
    ``sharding_tree``): a nested dict of spec tuples."""
    if isinstance(axes_tree, Mapping):
        return {k: spec_tree(v, rules, sizes) for k, v in axes_tree.items()}
    return effective_spec(spec_for(axes_tree, rules), sizes)
