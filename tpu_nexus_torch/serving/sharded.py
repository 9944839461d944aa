"""Tensor- and expert-parallel SHARDED serving: the port of
``tpu_nexus/serving/sharded.py`` on ``torch.distributed`` ranks.

One serve-engine replica decodes across ``tp x ep`` ranks, each holding its
slice of the weights and of the KV pool and running the port's kernels on
its own heads.  The JAX package is single-controller (one process owns the
slice, GSPMD inserts the collectives); PyTorch runs one process a rank, so
the port splits the replica into a leader and shard workers:

* **Rank 0 is the leader.**  It runs the unchanged ``ServingEngine``
  (scheduler, admission, prefix index, speculation, overlap) over a
  :class:`ShardedModelExecutor` / :class:`ShardedPagedModelExecutor`, and
  holds shard 0.
* **Ranks 1..n-1 are shard workers** (:func:`serve_shard`): they run only
  the executor.  Every executor call on the leader — ``begin`` (prefill +
  insert, the COW copies and ``extend_step`` of the paged executor),
  ``step``, ``step_scan``, ``verify``, the swap, the KV handoff's
  ``extract_blocks``/``install_blocks`` — broadcasts one header
  over the replica's control group: the op, then the call's host inputs
  (token ids, slots, cursors, block tables, ``q_starts`` sources).  Each
  rank then runs the same call on its shard; the model's collectives
  (``parallel/collectives.py``) meet inside it.  A device result that the
  engine feeds back (``step_scan``'s carries) travels as a reference: each
  rank keeps its own copy, identical because every rank takes the same
  argmax over the gathered logits.
* After every call the ranks agree on its outcome (one flag reduced over
  the control group).  An error every rank raised alike (a prompt too
  long) is the leader's to raise, as on one device; any other outcome —
  a rank failed alone, a collective broke, a peer died — raises
  :class:`ShardLost`, which no engine fault policy absorbs: the replica
  never carries on with fewer ranks.

As in the JAX package the ENGINE is untouched: the executor contract is
identical, so paging, speculation, overlap, multi-step decode and rolling
updates run sharded without the engine knowing.

**Replicate axes.**  The reference's serving rule table maps only
``tp`` and ``ep``, so a mesh's ``pp``, ``dp``, ``fsdp`` and ``sp`` axes
replicate every weight, every KV pool and every call.  Here the ranks that
differ only on those axes are COPIES: each holds the tp/ep slice its
coordinates name, every rank runs every broadcast call, the leader reads
its own copy's outputs, and the ranks' agreement still spans the whole
replica.  The MoE combine sums over one copy's ``(ep, tp)`` region only.

The pure logic is the reference's: :func:`parse_serve_mesh`,
:func:`validate_serve_mesh` (its int4 packed checks included),
:data:`SERVING_PARAM_RULES` with :func:`match_partition_rules` (an
unmatched leaf raises), :func:`serving_param_shardings` (a collapsed
scale dim replicates) and :data:`KV_CACHE_AXES`.  Where the JAX package
``device_put``s a host tree under those shardings, each rank here reads
its own slice (:class:`NumpyParams`, :class:`SeedParams`,
:class:`CheckpointParams`); a swap broadcasts only the checkpoint
directory and step, so the leader never holds another rank's slice.  (A
model drafter's self-draft beside the replica loads the whole tree onto
the leader's device, as the JAX package's draft executor holds it:
:meth:`ParamSource.whole`.)  The KV handoff speaks one device's payload:
the leader's ``tp`` group gathers every head for an extract, and each
rank writes its own heads of an install.
int8 scales reduce their amax over ``tp`` where the contraction dim is
sharded (``wo``, ``w_down``), so the sharded quantized tree is the
one-device tree, sliced.

Ranks: :class:`RankPool` starts the workers (``spawn``) and the process
group: ``nccl`` with one card a rank, ``gloo`` on the CPU and under the
one-device rehearsal map (``parallel/distributed.py``).  In a launched
world of processes (``NEXUS_NUM_PROCESSES`` > 1) the pool's world spans
them: process 0's :class:`RankPool` (``plan=``) holds the leader, and every
other process runs its ranks' worker loops (:func:`serve_launched_ranks`)
until the leader's exit.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_nexus_torch.models.quant import QTensor, QTensor4, quantize_params
from tpu_nexus_torch.parallel import collectives
from tpu_nexus_torch.parallel.collectives import CollectiveError, ShardComm
from tpu_nexus_torch.parallel.mesh import AXIS_ORDER, mesh_coords
from tpu_nexus_torch.parallel.sharding import LOGICAL_RULES_SERVE_TP, shard_index, shard_leaf, spec_for
from tpu_nexus_torch.serving.cache_manager import init_cache, init_paged_cache
from tpu_nexus_torch.serving.engine import ModelExecutor, PagedModelExecutor, _DeviceResult, _param_spec

logger = logging.getLogger(__name__)

__all__ = [
    "SERVING_PARAM_RULES",
    "CheckpointParams",
    "NumpyParams",
    "RankPool",
    "SeedParams",
    "ServeMesh",
    "ShardLost",
    "ShardedModelExecutor",
    "ShardedPagedModelExecutor",
    "ShardingError",
    "build_serve_mesh",
    "kv_cache_sharding",
    "match_partition_rules",
    "parse_serve_mesh",
    "serve_launched_ranks",
    "serve_shard",
    "serving_param_shardings",
    "shard_serving_params",
    "validate_serve_mesh",
]


class ShardingError(ValueError):
    """A serving-sharding config fact: unknown mesh axis, non-divisible
    head/width counts, a param leaf no rule matches.  ValueError so
    ``ServeConfig`` parse-time validation reports it like every other bad
    env value."""


class ShardLost(Exception):
    """The replica's ranks no longer move together: a worker died, a
    collective failed or timed out, or a call failed on some ranks only.
    Not a ``RuntimeError``, so no engine fault policy retries or absorbs
    it — the serve loop ends, the container exits non-zero."""


#: regex -> logical-axis tuple over ``/``-joined param-tree paths, FIRST
#: match (with matching rank) wins — the reference's table.  Quantized
#: leaves' parts are ``<name>/q`` (values) and ``<name>/s`` (scales); the
#: int4 children's rank-3 rows follow the rank-4 rows they never shadow.
SERVING_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("embed/tokens", ("vocab", "embed")),
    ("layers/attn_norm$", ("layers", "embed")),
    ("layers/mlp_norm$", ("layers", "embed")),
    ("layers/wq", ("layers", "embed", "heads", "head_dim")),
    ("layers/wk", ("layers", "embed", "kv_heads", "head_dim")),
    ("layers/wv", ("layers", "embed", "kv_heads", "head_dim")),
    ("layers/wo", ("layers", "heads", "head_dim", "embed")),
    ("layers/wq", ("layers", None, "heads")),
    ("layers/wk", ("layers", None, "kv_heads")),
    ("layers/wv", ("layers", None, "kv_heads")),
    ("layers/wo", ("layers", "heads", None)),
    # dense (Llama) MLP: [L, E, F] / [L, F, E]
    ("layers/w_gate", ("layers", "embed", "mlp")),
    ("layers/w_up", ("layers", "embed", "mlp")),
    ("layers/w_down", ("layers", "mlp", "embed")),
    # MoE expert stacks carry a leading expert axis: [L, n_exp, E, F]
    ("layers/w_gate", ("layers", "expert", "embed", "mlp")),
    ("layers/w_up", ("layers", "expert", "embed", "mlp")),
    ("layers/w_down", ("layers", "expert", "mlp", "embed")),
    ("layers/router", ("layers", "embed", None)),  # n_exp is tiny: replicate
    ("out_norm$", ("embed",)),
    ("lm_head", ("embed", "vocab")),
)

#: logical axes of BOTH KV cache layouts (contiguous ``[L, slots, max_len,
#: Hkv, D]`` and paged ``[L, blocks, page, Hkv, D]``; the int8 scales too):
#: heads-sharding keeps every token's prefix with the rank that owns the
#: head, so decode attention needs no collective
KV_CACHE_AXES: Tuple[Optional[str], ...] = ("layers", None, None, "kv_heads", None)

# -- mesh config (NEXUS_SERVE_MESH) --------------------------------------------


def parse_serve_mesh(spec: str) -> Dict[str, int]:
    """Parse ``NEXUS_SERVE_MESH`` (``"tp=4"`` / ``"ep=2,tp=2"``) into an
    axis->size dict, validated against ``parallel/mesh.py`` AXIS_ORDER —
    an unknown or duplicate axis, or a size < 1, raises at parse time."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([a-z]+)\s*=\s*(-?\d+)", part)
        if m is None:
            raise ShardingError(
                f"malformed NEXUS_SERVE_MESH entry {part!r}; expected "
                "comma-separated axis=size pairs, e.g. 'tp=4'"
            )
        name, size = m.group(1), int(m.group(2))
        if name not in AXIS_ORDER:
            raise ShardingError(
                f"unknown mesh axis {name!r} in NEXUS_SERVE_MESH; "
                f"parallel/mesh.py declares {', '.join(AXIS_ORDER)}"
            )
        if name in axes:
            raise ShardingError(f"duplicate mesh axis {name!r} in NEXUS_SERVE_MESH")
        if size < 1:
            raise ShardingError(
                f"mesh axis {name!r} size must be >= 1, got {size}"
            )
        axes[name] = size
    if not axes:
        raise ShardingError("empty NEXUS_SERVE_MESH; expected axis=size pairs")
    return axes


def validate_serve_mesh(
    axes: Dict[str, int],
    model_cfg: Any,
    n_devices: Optional[int] = None,
    *,
    quantize: str = "",
    quant_group: int = 0,
) -> None:
    """Fail-fast checks a serve mesh must pass BEFORE any device work:
    total size fits the available devices (default: the CUDA cards torch
    sees), and the tp/ep factors divide the model's sharded dimensions.
    ``quantize="int4"`` extends the tp checks to the PACKED layout (the
    halved packed row count and the group-scale row count of ``w_down``
    and ``wo``, whose contraction rows tp splits)."""
    size = 1
    for s in axes.values():
        size *= s
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    if size > n_devices:
        raise ShardingError(
            f"NEXUS_SERVE_MESH wants {size} devices "
            f"({', '.join(f'{k}={v}' for k, v in axes.items())}) but only "
            f"{n_devices} are available"
        )
    tp = axes.get("tp", 1)
    if tp > 1:
        for attr, what in (
            ("n_heads", "attention heads"),
            ("n_kv_heads", "KV heads"),
            ("intermediate", "MLP width"),
            ("vocab_size", "vocab"),
        ):
            dim = getattr(model_cfg, attr, None)
            if dim is not None and dim % tp:
                raise ShardingError(
                    f"tp={tp} does not divide the model's {dim} {what} "
                    f"({attr}) — pick a tp that divides every sharded "
                    "dimension"
                )
        if quantize == "int4":
            from tpu_nexus_torch.models.quant import DEFAULT_INT4_GROUP

            g = quant_group or DEFAULT_INT4_GROUP
            packed: List[Tuple[int, str]] = []
            f = getattr(model_cfg, "intermediate", None)
            if f is not None:
                packed.append(
                    (f // 2, f"packed MLP contraction rows (intermediate {f} / 2, w_down)")
                )
                packed.append(
                    (f // g, f"MLP group-scale rows (intermediate {f} / group {g}, w_down)")
                )
            hq = getattr(model_cfg, "n_heads", None)
            d = getattr(model_cfg, "head_dim", None)
            if hq is not None and d is not None:
                packed.append(
                    (
                        hq * d // 2,
                        f"packed output-projection rows (n_heads*head_dim {hq * d} / 2, wo)",
                    )
                )
                packed.append(
                    (
                        hq * d // g,
                        f"output-projection group-scale rows (n_heads*head_dim {hq * d} / group {g}, wo)",
                    )
                )
            for dim, what in packed:
                if dim % tp:
                    raise ShardingError(
                        f"tp={tp} does not divide the int4 model's {dim} "
                        f"{what} — pick a tp/NEXUS_QUANT_GROUP pair that "
                        "divides every sharded packed dimension"
                    )
    ep = axes.get("ep", 1)
    if ep > 1:
        n_exp = getattr(model_cfg, "n_experts", None)
        if n_exp is None:
            raise ShardingError(
                f"ep={ep} requires an MoE model (config has no n_experts)"
            )
        if n_exp % ep:
            raise ShardingError(
                f"ep={ep} does not divide the model's {n_exp} experts"
            )


# -- the mesh: ranks and their groups ------------------------------------------

#: a worker's timeout on the groups that carry the leader's headers (an
#: idle replica waits there between requests, an idle worker between
#: replicas).  The leader, which only sends there, keeps a finite timeout
#: on every group, and every other collective — the ranks' agreement
#: after each call included — uses the replica's finite timeout
IDLE_TIMEOUT = timedelta(days=7)
#: how long the leader waits for its spawned workers to join the pool
STARTUP_TIMEOUT = timedelta(seconds=120)
#: how often a rank of another launched process bumps its liveness counter
#: in the pool's store
ALIVE_EVERY_S = 0.5
#: a client of the pool's store waits this long for an answer
_STORE_TIMEOUT = timedelta(seconds=30)


@dataclasses.dataclass
class ServeMesh:
    """One replica's mesh: its axis sizes (every axis of AXIS_ORDER), its
    global ranks in mesh order (tp fastest; the first is the leader), this
    process's rank, and — once the process group exists — the groups this
    rank belongs to: ``tp``, ``moe`` (its copy's ``(ep, tp)`` region: the
    ranks that share its coordinates on the replicate axes), ``data`` (the
    whole replica, finite timeout: the ranks' agreement after each call)
    and ``control`` (the whole replica, always on the host: the leader's
    headers only, which a worker awaits at the idle timeout).  ``members``
    names the global ranks of its ``tp`` and ``moe`` groups."""

    axis_sizes: Dict[str, int]
    ranks: Tuple[int, ...]
    rank: Optional[int] = None
    device: Any = None
    backend: str = "gloo"
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    members: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)
    stopped: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    @property
    def active_axes(self) -> Dict[str, int]:
        return {k: v for k, v in self.axis_sizes.items() if v > 1}

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def is_leader(self) -> bool:
        return self.rank == self.ranks[0]

    @property
    def coords(self) -> Dict[str, int]:
        index = self.ranks.index(self.rank) if self.is_member else 0
        return dict(zip(AXIS_ORDER, mesh_coords(index, [self.axis_sizes[a] for a in AXIS_ORDER])))

    @property
    def comm(self) -> ShardComm:
        if not self.groups:
            raise RuntimeError("this serve mesh has no process groups (build it with a process group up)")
        c = self.coords
        return ShardComm(
            tp_size=self.axis_sizes["tp"], tp_rank=c["tp"], tp_group=self.groups["tp"],
            ep_size=self.axis_sizes["ep"], ep_rank=c["ep"], moe_group=self.groups["moe"], backend=self.backend,
        )

    # -- the control channel ----------------------------------------------

    def send(self, msg: Any) -> None:
        """The leader's header: one pickled object to every rank."""
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=self.ranks[0], group=self.groups["control"],
                                   device=torch.device("cpu"))

    def stop(self) -> None:
        """The leader's stop op, sent once: the workers leave the replica
        (and go back to their pool)."""
        if self.is_leader and self.groups and not self.stopped:
            self.stopped = True
            self.send((OP_STOP,))

    def recv(self) -> Any:
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.groups["control"],
                                   device=torch.device("cpu"))
        return box[0]

    def gather(self, obj: Any) -> List[Any]:
        import torch.distributed as dist

        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.groups["data"])
        return out

    def any_failed(self, failed: bool) -> bool:
        import torch.distributed as dist

        flag = torch.tensor([int(failed)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.groups["data"])
        return bool(flag.item())


def build_serve_mesh(
    axes: Dict[str, int],
    ranks: Optional[Sequence[int]] = None,
    *,
    device: Any = None,
    timeout_s: float = 300.0,
) -> ServeMesh:
    """A :class:`ServeMesh` over the FIRST ``prod(sizes)`` of ``ranks``
    (default: the process group's ranks), canonical AXIS_ORDER with unnamed
    axes of size 1.  With a process group up, every rank of the world calls
    it (each of the mesh's groups is created by all of them, in one order)
    and gets back its own view; ``device`` is this rank's."""
    for name in axes:
        if name not in AXIS_ORDER:
            raise ShardingError(f"unknown mesh axis {name!r}")
    sizes = {name: int(axes.get(name, 1)) for name in AXIS_ORDER}
    n = 1
    for s in sizes.values():
        n *= s
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size() if live else 1)
    ranks = tuple(int(r) for r in ranks)
    if n > len(ranks):
        raise ShardingError(f"serve mesh wants {n} devices (ranks), have {len(ranks)}")
    ranks = ranks[:n]
    mesh = ServeMesh(axis_sizes=sizes, ranks=ranks)
    if not live:
        return mesh
    mesh.rank = dist.get_rank()
    mesh.device = torch.device(device) if device is not None else None
    mesh.backend = dist.get_backend()
    made: Dict[Tuple[Tuple[int, ...], bool], Any] = {}

    def group(members: Sequence[int], idle: bool) -> Any:
        # a header group waits idle only on the ranks that receive there:
        # its first member, the leader, sends at the finite timeout
        key = (tuple(members), idle)
        if key not in made:
            wait = IDLE_TIMEOUT if idle and mesh.rank != members[0] else timedelta(seconds=timeout_s)
            made[key] = dist.new_group(list(members), timeout=wait, backend="gloo" if idle else None)
        return made[key]

    # each rank's coordinates; a tp group is the ranks that differ only on
    # tp, an (ep, tp) region those that differ only on ep and tp (not a
    # contiguous run of ranks when sp > 1: built from the coordinates).
    # Every rank creates every group, in this order; each keeps its own
    coords = [dict(zip(AXIS_ORDER, mesh_coords(i, [sizes[a] for a in AXIS_ORDER]))) for i in range(n)]

    def runs(free: Tuple[str, ...]) -> List[Tuple[int, ...]]:
        out: Dict[Tuple[int, ...], List[int]] = {}
        for i, c in enumerate(coords):
            out.setdefault(tuple(c[a] for a in AXIS_ORDER if a not in free), []).append(ranks[i])
        return [tuple(v) for v in out.values()]

    for name, free in (("tp", ("tp",)), ("moe", ("ep", "tp"))):
        for members in runs(free):
            g = group(members, False)
            if mesh.rank in members:
                mesh.groups[name], mesh.members[name] = g, members
    data, control = group(ranks, False), group(ranks, True)
    if mesh.is_member:
        mesh.groups.update(data=data, control=control)
    else:
        mesh.groups.clear()
        mesh.members.clear()
    return mesh


# -- regex partition rules over the param tree ---------------------------------


def _is_quant_dict(node: Any) -> bool:
    return isinstance(node, Mapping) and "q" in node and "s" in node


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every array leaf: nested dicts, ``LlamaParams``
    and ``QuantizedParams`` by key; a quantized leaf (a torch
    ``QTensor``/``QTensor4`` or the JAX package's numpy ``{"q", "s", ...}``
    form) by its ``q`` and ``s`` parts."""
    if isinstance(tree, (QTensor, QTensor4)):
        return [(f"{prefix}/q", tree.q), (f"{prefix}/s", tree.s)]
    if _is_quant_dict(tree):
        return [(f"{prefix}/q", tree["q"]), (f"{prefix}/s", tree["s"])]
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)) or not hasattr(tree, "keys"):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key in tree.keys():
        out += _flatten(tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def _nest(pairs: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, value in pairs:
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return root


def _axes_flat(params: Any, rules) -> List[Tuple[str, Any, Tuple[Optional[str], ...]]]:
    compiled = [(re.compile(rx), axes) for rx, axes in rules]
    out = []
    for name, leaf in _flatten(params):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            out.append((name, leaf, tuple(None for _ in shape)))
            continue
        for rx, axes in compiled:
            if rx.search(name) is not None and len(axes) == len(shape):
                out.append((name, leaf, axes))
                break
        else:
            raise ShardingError(
                f"no serving partition rule matches param {name!r} "
                f"(shape {shape}) — add a (regex, logical-axes) row to "
                "SERVING_PARAM_RULES"
            )
    return out


def match_partition_rules(
    params: Any,
    rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = SERVING_PARAM_RULES,
) -> Dict[str, Any]:
    """A nested dict of logical-axis tuples mirroring ``params`` (a
    quantized leaf maps to ``{"q": axes, "s": axes}``): scalars and
    1-element leaves replicate; otherwise the first rule whose regex
    ``search``-matches the leaf's ``/``-joined path AND whose axis tuple
    matches the leaf's rank wins.  An unmatched leaf RAISES."""
    return _nest([(name, axes) for name, _leaf, axes in _axes_flat(params, rules)])


def _axis_sizes(mesh: Any) -> Dict[str, int]:
    sizes = mesh if isinstance(mesh, Mapping) else mesh.axis_sizes
    return {name: int(sizes.get(name, 1)) for name in AXIS_ORDER}


def _leaf_spec(name: str, shape: Tuple[int, ...], logical, table, sizes) -> Tuple[Any, ...]:
    spec = list(spec_for(logical, table))
    for i, assigned in enumerate(spec):
        if assigned is None:
            continue
        shards = 1
        for a in assigned if isinstance(assigned, tuple) else (assigned,):
            shards *= sizes[a]
        if shape[i] == 1:
            spec[i] = None  # collapsed scale/broadcast dim: replicate
        elif shape[i] % shards:
            raise ShardingError(
                f"dim {i} of param {name!r} (shape {shape}, logical "
                f"{logical}) is not divisible by its {shards}-way "
                f"{assigned!r} sharding"
            )
    return tuple(spec)


def serving_param_shardings(
    params: Any,
    mesh: Any,
    rule_table: Optional[Dict[str, Any]] = None,
    rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = SERVING_PARAM_RULES,
) -> Dict[str, Any]:
    """A nested dict of specs (one mesh axis or None per dim) mirroring
    ``params``: regex rules pick each leaf's logical axes, the rule table
    (default ``LOGICAL_RULES_SERVE_TP``) maps them to mesh axes.  A dim of
    size 1 (an int8 scale's collapsed contraction dim) replicates; a dim
    the mesh axis does not divide raises HERE, naming the leaf."""
    table = dict(LOGICAL_RULES_SERVE_TP if rule_table is None else rule_table)
    sizes = _axis_sizes(mesh)
    return _nest([
        (name, _leaf_spec(name, tuple(leaf.shape), logical, table, sizes))
        for name, leaf, logical in _axes_flat(params, rules)
    ])


@dataclasses.dataclass(frozen=True)
class KVCacheSharding:
    """The ONE spec both cache layouts share (dim 3 = kv-heads on ``tp``)
    and the mesh it names: what ``init_cache(shardings=...)`` reads."""

    spec: Tuple[Any, ...]
    mesh: Any


def kv_cache_sharding(mesh: Any, rule_table: Optional[Dict[str, Any]] = None) -> KVCacheSharding:
    table = dict(LOGICAL_RULES_SERVE_TP if rule_table is None else rule_table)
    return KVCacheSharding(spec_for(KV_CACHE_AXES, table), mesh)


def _local_copy(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.contiguous().clone()
    return np.array(x, order="C", copy=True)


def shard_serving_params(
    params: Any,
    mesh: ServeMesh,
    rule_table: Optional[Dict[str, Any]] = None,
    rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = SERVING_PARAM_RULES,
) -> Dict[str, Any]:
    """This rank's part of a HOST tree (numpy or torch) under the serving
    rules, as a nested dict of contiguous copies: each leaf cut to
    ``mesh.coords``.  A quantized numpy leaf keeps its ``{"q", "s", ...}``
    form, an int4 one with its logical ``contract_shape``/``out_shape`` cut
    alike."""
    coords = mesh.coords
    sizes = _axis_sizes(mesh)
    specs = serving_param_shardings(params, sizes, rule_table, rules)
    out: Dict[str, Any] = {}

    def walk(node: Any, spec: Any, into: Dict[str, Any], key: str) -> None:
        if _is_quant_dict(node):
            leaf = {k: v for k, v in node.items() if k not in ("q", "s")}
            leaf["q"] = _local_copy(shard_leaf(node["q"], spec["q"], coords, sizes))
            leaf["s"] = _local_copy(shard_leaf(node["s"], spec["s"], coords, sizes))
            if "group" in node:  # int4: the packed [.., K/2, N] cut in K or N
                k_parts = shard_index(spec["q"][-2], coords, sizes)[1]
                n_parts = shard_index(spec["q"][-1], coords, sizes)[1]
                cs, os_ = list(node["contract_shape"]), list(node["out_shape"])
                cs[0] //= k_parts
                os_[0] //= n_parts
                leaf["contract_shape"], leaf["out_shape"] = tuple(cs), tuple(os_)
            into[key] = leaf
        elif isinstance(node, (torch.Tensor, np.ndarray, np.generic)) or not hasattr(node, "keys"):
            into[key] = _local_copy(shard_leaf(node, spec, coords, sizes))
        else:
            into[key] = {}
            for k in node.keys():
                walk(node[k], spec[k], into[key], k)

    for k in params.keys():
        walk(params[k], specs[k], out, k)
    return out


def local_layer_shapes(cfg: Any, mesh: Any) -> Dict[str, Tuple[int, ...]]:
    """The shape of every stacked layer leaf on one rank: the model's, each
    sharded dim divided by its shard count (the router stays whole)."""
    from tpu_nexus_torch.models import llama, moe

    family = moe if isinstance(cfg, moe.MoeConfig) else llama
    axes = (moe.moe_axes if family is moe else llama.llama_axes)(cfg)["layers"]
    sizes = _axis_sizes(mesh)
    out = {}
    for name, shape in family._layer_shapes(cfg).items():
        spec = spec_for(axes[name], LOGICAL_RULES_SERVE_TP)
        out[name] = tuple(d // shard_index(a, {}, sizes)[1] for d, a in zip(shape, spec))
    return out


def _amax_reducer(params: Any, mesh: ServeMesh, rules) -> Callable[[str], Optional[Callable]]:
    """For int8 quantization on one rank: weight name -> the max over the
    ``tp`` group of its amax, where a contraction dim of the weight is
    sharded over ``tp`` (``wo``'s heads, ``w_down``'s mlp); None where
    the rank holds whole contraction dims."""
    from tpu_nexus_torch.models.quant import _CONTRACT_AXES

    sizes = _axis_sizes(mesh)
    table = LOGICAL_RULES_SERVE_TP
    logical = {name.split("/")[-1]: axes for name, _leaf, axes in _axes_flat(params, rules)
               if name.startswith("layers/")}

    def reducer(name: str) -> Optional[Callable]:
        axes = logical.get(name)
        if axes is None or sizes["tp"] == 1:
            return None
        spec = spec_for(axes, table)
        if not any(spec[d] == "tp" for d in _CONTRACT_AXES[name]):
            return None
        return collectives.max_over_tp

    return reducer


# -- where a rank's weights come from -------------------------------------------


class ParamSource:
    """Where each rank reads its slice of the replica's weights: picklable,
    broadcast to the workers, loaded on every rank onto its own device.
    :meth:`whole` loads the whole tree onto one device instead: the model
    drafter's self-draft beside a sharded executor, on the leader's
    device (the serving slices stay where they are)."""

    def load(self, mesh: ServeMesh, cfg: Any, device: Any) -> Any:
        raise NotImplementedError  # pragma: no cover - subclass contract

    def whole(self, cfg: Any, device: Any) -> Any:
        raise NotImplementedError  # pragma: no cover - subclass contract


@dataclasses.dataclass
class NumpyParams(ParamSource):
    """The JAX package's tree as numpy (``models/convert.py``'s layout,
    quantized leaves included); each rank converts its own slice."""

    tree: Dict[str, Any]

    def load(self, mesh, cfg, device):
        from tpu_nexus_torch.models.convert import params_from_numpy_shard

        return params_from_numpy_shard(self.tree, cfg, mesh, device=device)

    def whole(self, cfg, device):
        from tpu_nexus_torch.models.convert import params_from_numpy

        return params_from_numpy(self.tree, cfg, device=device)


@dataclasses.dataclass
class SeedParams(ParamSource):
    """The random init of ``seed`` (the one-device engine's draws, leaf by
    leaf on the rank's device), each leaf cut to the rank's slice as it is
    drawn."""

    seed: int

    def load(self, mesh, cfg, device):
        return self._init(cfg, device, _slicer(cfg, mesh))

    def whole(self, cfg, device):
        return self._init(cfg, device, None)

    def _init(self, cfg, device, leaf_fn):
        from tpu_nexus_torch.models.llama import llama_init
        from tpu_nexus_torch.models.moe import MoeConfig, moe_init

        generator = torch.Generator(device=device).manual_seed(self.seed)
        init = moe_init if isinstance(cfg, MoeConfig) else llama_init
        return init(generator, cfg, device=device, leaf_fn=leaf_fn)


@dataclasses.dataclass
class CheckpointParams(ParamSource):
    """Step ``step`` of a tensor-checkpoint directory: every rank verifies
    the step and reads only its slice of each tensor file."""

    directory: str
    step: int

    def load(self, mesh, cfg, device):
        return _verified_slice(self, mesh, cfg, device)

    def whole(self, cfg, device):
        """The whole tree, after the same verification (every file
        checksummed, ``restore_params``) before any tensor is read."""
        from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

        ckpt = TensorCheckpointer(self.directory)
        try:
            return ckpt.restore_params(self.step, device=device)
        finally:
            ckpt.close()


def _verified_slice(source: ParamSource, mesh: Any, cfg: Any, device: Any) -> Any:
    """A rank's slice from ``source``; a checkpoint step is verified (every
    file checksummed, ``restore_params``) before any tensor is read."""
    if isinstance(source, CheckpointParams):
        from tpu_nexus_torch.workload.tensor_checkpoint import TensorCheckpointer

        ckpt = TensorCheckpointer(source.directory)
        try:
            return ckpt.restore_params(source.step, device=device, leaf_fn=_slicer(cfg, mesh))
        finally:
            ckpt.close()
    return source.load(mesh, cfg, device)


def _slicer(cfg: Any, mesh: Any) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``(path, full leaf) -> this rank's contiguous slice`` under the
    serving rules and the model's logical axes."""
    from tpu_nexus_torch.models.llama import llama_axes
    from tpu_nexus_torch.models.moe import MoeConfig, moe_axes

    axes = dict(_flatten(moe_axes(cfg) if isinstance(cfg, MoeConfig) else llama_axes(cfg)))
    sizes = _axis_sizes(mesh)
    coords = mesh.coords

    def cut(path: str, leaf: torch.Tensor) -> torch.Tensor:
        if path not in axes:
            raise ShardingError(f"param {path!r} has no logical axes in the model's axes tree")
        spec = _leaf_spec(path, tuple(leaf.shape), axes[path], LOGICAL_RULES_SERVE_TP, sizes)
        return shard_leaf(leaf, spec, coords, sizes).contiguous().clone()

    return cut


# -- the executors -------------------------------------------------------------

OP_INIT, OP_CALL, OP_STOP = "init", "call", "stop"
#: device results a rank keeps for the leader's references (the engine
#: feeds back only the previous dispatch's)
_KEPT_RESULTS = 64


class _ShardResult(_DeviceResult):
    """A device result the leader hands the engine, with the reference the
    workers know their own copy by."""

    __slots__ = ("ref",)

    def __init__(self, tensor: Any, bound: Optional[np.ndarray], ref: int) -> None:
        super().__init__(tensor, bound)
        self.ref = ref


@dataclasses.dataclass(frozen=True)
class _Ref:
    ref: int
    bound: Optional[np.ndarray]


def _encode(obj: Any) -> Any:
    if isinstance(obj, _ShardResult):
        return _Ref(obj.ref, obj.bound)
    if isinstance(obj, _DeviceResult):
        raise ShardLost("a device result of another executor cannot cross to the shard workers")
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def _error_text(exc: Optional[BaseException]) -> Optional[str]:
    return None if exc is None else f"{type(exc).__name__}: {exc}"


class _ShardedExecutorMixin:
    """The sharding layer over either executor (MRO: mixin first).  On the
    leader each public entry point broadcasts its header and inputs, runs
    its own shard and agrees on the outcome; a worker's :func:`serve_shard`
    loop calls :meth:`_serve_op` with the same header.  Every call runs
    with the mesh's :class:`ShardComm` active, so the model's collectives
    meet.  Each call's header carries the leader's :attr:`iteration`
    (its serving loop's engine step), so a worker process heartbeats the
    same steps as the leader."""

    #: the fleet's rollout hands these executors a checkpoint reference
    #: (``CheckpointParams``) instead of a restored tree
    swaps_from_checkpoint = True
    #: the leader's engine iteration, set by its serving loop
    iteration = 0

    def __init__(
        self,
        params: Any,
        cfg: Any,
        *,
        mesh: ServeMesh,
        rules: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = SERVING_PARAM_RULES,
        **kwargs: Any,
    ) -> None:
        if not isinstance(params, ParamSource):
            raise TypeError(
                "a sharded executor reads its weights per rank: pass a ParamSource "
                "(NumpyParams, SeedParams or CheckpointParams), not a whole tree"
            )
        validate_serve_mesh(
            mesh.active_axes, cfg, n_devices=mesh.size,
            quantize=kwargs.get("quantize", ""), quant_group=kwargs.get("quant_group", 0),
        )
        self.mesh = mesh
        self.comm = mesh.comm
        self._rules = rules
        self._kv_sharding = kv_cache_sharding(mesh)
        self._results: Dict[int, torch.Tensor] = {}
        self._next_ref = 0
        if mesh.is_leader:
            self._send((OP_INIT, type(self).__name__, params, cfg, dict(kwargs, rules=rules)))
        err = None
        try:
            with collectives.active(self.comm):
                local = params.load(mesh, cfg, mesh.device)
                self._raw_spec = _param_spec(local)
                quantize = kwargs.get("quantize", "")
                if quantize:
                    local = quantize_params(local, mode=quantize, group=kwargs.get("quant_group", 0),
                                            amax_reduce=_amax_reducer(local, mesh, rules))
                super().__init__(local, cfg, **kwargs)
                del local
                if self.device.type == "cuda":
                    # ranks share a card under the rehearsal map: hand the
                    # init's full-leaf temporaries back to the others
                    torch.cuda.empty_cache()
        except CollectiveError as exc:
            raise ShardLost(f"a collective failed while the shards loaded: {exc}") from exc
        except Exception as exc:  # noqa: BLE001 - every rank's outcome is agreed below, then raised alike
            err = exc
        self._agree(err, "init")
        self._sum_weight_bytes()

    # -- plumbing ------------------------------------------------------------

    def _send(self, msg: Any) -> None:
        try:
            self.mesh.send(msg)
        except Exception as exc:  # noqa: BLE001 - any failure of the control channel loses the replica
            raise ShardLost(f"the leader's header did not reach the shard workers: {exc}") from exc

    def _agree(self, err: Optional[BaseException], name: str) -> None:
        """Every rank's outcome of call ``name``: raise ``err`` where every
        rank failed alike, :class:`ShardLost` where they differ."""
        try:
            if not self.mesh.any_failed(err is not None):
                return
            texts = self.mesh.gather(_error_text(err))
        except Exception as exc:  # noqa: BLE001 - the control channel itself broke: a rank is gone
            raise ShardLost(f"shard ranks lost during {name}: {exc}") from exc
        if err is not None and all(t == texts[0] for t in texts):
            raise err
        raise ShardLost(f"shard ranks disagree after {name}: {texts}")

    def _sum_weight_bytes(self) -> None:
        """The replica's weight bytes, as the one-device tree's: every
        shard once, a replicated leaf once (on the ranks at coordinate 0 of
        the axes it is not cut along)."""
        coords, active = self.mesh.coords, self.mesh.active_axes
        mine = 0
        for name, leaf, logical in _axes_flat(self.params, self._rules):
            cut = {a for dim, a in enumerate(spec_for(logical, LOGICAL_RULES_SERVE_TP))
                   if a is not None and leaf.shape[dim] > 1}
            if all(coords[a] == 0 for a in active if a not in cut):
                mine += leaf.numel() * leaf.element_size()
        try:
            self.weight_bytes = int(sum(self.mesh.gather(mine)))
        except Exception as exc:  # noqa: BLE001 - the control channel broke: a rank is gone
            raise ShardLost(f"shard ranks lost while summing weight bytes: {exc}") from exc

    def _call(self, name: str, args: tuple, kwargs: dict) -> Any:
        """One entry point on every rank (the leader broadcasts first)."""
        if self.mesh.is_leader:
            self._send((OP_CALL, name, _encode(args), _encode(kwargs), self.iteration))
        err, out = None, None
        try:
            with collectives.active(self.comm):
                out = getattr(self, "_local_" + name)(*args, **kwargs)
        except ShardLost:
            raise
        except CollectiveError as exc:
            raise ShardLost(f"a collective failed during {name}: {exc}") from exc
        except Exception as exc:  # noqa: BLE001 - agreed across ranks below: raised alike, or ShardLost
            err = exc
        self._agree(err, name)
        return out

    def _serve_op(self, name: str, args: tuple, kwargs: dict) -> None:
        """A worker's half of one call (its result stays on the worker)."""
        args, kwargs = self._decode(args), self._decode(kwargs)
        self._call(name, args, kwargs)

    def _decode(self, obj: Any) -> Any:
        if isinstance(obj, _Ref):
            if obj.ref not in self._results:
                raise ShardLost(f"shard result {obj.ref} is no longer kept on rank {self.mesh.rank}")
            return _DeviceResult(self._results[obj.ref], obj.bound)
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._decode(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self._decode(v) for k, v in obj.items()}
        return obj

    def _keep(self, results: Tuple[_DeviceResult, ...]) -> Tuple[_ShardResult, ...]:
        out = []
        for r in results:
            ref = self._next_ref
            self._next_ref += 1
            self._results[ref] = r.tensor
            self._results.pop(ref - _KEPT_RESULTS, None)
            out.append(_ShardResult(r.tensor, r.bound, ref))
        return tuple(out)

    def _fresh_cache(self):  # the KV pool of this rank's heads
        raise NotImplementedError  # pragma: no cover - subclass contract

    # -- entry points --------------------------------------------------------

    def begin(self, *args, **kwargs):
        return self._call("begin", args, kwargs)

    def step(self, *args, **kwargs):
        return self._call("step", args, kwargs)

    def step_scan(self, *args, **kwargs):
        return self._call("step_scan", args, kwargs)

    def verify(self, *args, **kwargs):
        return self._call("verify", args, kwargs)

    def teacher_forced_logits(self, prompts: np.ndarray, forced: np.ndarray) -> np.ndarray:
        """Logits ``[B, T, V]`` (f32, host) of ``prompts`` followed by the
        teacher-forced tokens ``forced`` [B, T] (row ``j`` predicts
        ``forced[:, j]``), through prefill and decode on the shards."""
        return self._call("teacher_forced_logits", (prompts, forced), {})

    def shard_stats(self, reset: bool = False) -> List[Dict[str, Any]]:
        """Every rank's kernel launch counts, collective counts and peak
        device memory, in mesh order; ``reset`` zeroes them after reading."""
        return self._call("shard_stats", (reset,), {})

    def swap_params(self, params: Any) -> None:
        """Hot-swap to ``params``, a :class:`ParamSource` (the fleet and the
        serve loop pass ``CheckpointParams``: only the directory and step
        cross to the workers).  Two phases: every rank reads its slice and
        checks it against its serving slice; only when every rank staged
        it does every rank install it.  A swap that does not fit raises
        ``ValueError`` with the old weights kept on every rank."""
        if not isinstance(params, ParamSource):
            raise TypeError(
                "a sharded executor swaps from a ParamSource (CheckpointParams: the "
                "directory and step), never from a tree the leader holds whole"
            )
        self._call("swap", (params,), {})

    def close(self) -> None:
        """Release the shard workers (they return to their pool)."""
        try:
            self.mesh.stop()
        except Exception as exc:  # noqa: BLE001 - any failure of the control channel loses the replica
            raise ShardLost(f"the stop op did not reach the shard workers: {exc}") from exc

    # -- each rank's half ----------------------------------------------------

    def _local_begin(self, *args, **kwargs):
        return super().begin(*args, **kwargs)

    def _local_step(self, *args, **kwargs):
        return super().step(*args, **kwargs)

    def _local_step_scan(self, *args, **kwargs):
        return self._keep(super().step_scan(*args, **kwargs))

    def _local_verify(self, *args, **kwargs):
        return super().verify(*args, **kwargs)

    def _local_teacher_forced_logits(self, prompts, forced):
        from tpu_nexus_torch.models.generate import teacher_forced_logits

        return self._guarded(lambda: teacher_forced_logits(
            self.params, self.cfg, self._tensor(prompts), self._tensor(forced), kv_quant=self.kv_quant,
            decode_kernel=self.decode_kernel, attn_impl=self.attn_impl,
        ).float().cpu().numpy())

    def _local_shard_stats(self, reset: bool):
        mine = {
            "rank": self.mesh.rank,
            "groups": dict(self.mesh.members),
            "launches": launch_counts(),
            "collectives": collectives.STATS.to_dict(),
            "peak_memory": (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0),
        }
        if reset:
            reset_launch_counts()
            collectives.STATS.reset()
        return self.mesh.gather(mine)

    def _local_swap(self, source: ParamSource) -> None:
        # phase 1: every rank reads (a checkpoint: verifies) and checks
        # its slice; phase 2 only if every rank staged it
        err, local = None, None
        try:
            local = _verified_slice(source, self.mesh, self.cfg, self.device)
            if _param_spec(local) != self._raw_spec:
                raise ValueError(
                    "swap_params: new weights' pytree structure/shapes/dtypes "
                    "differ from the serving params — wrong checkpoint or "
                    "missing quantization transform"
                )
        except Exception as exc:  # noqa: BLE001 - agreed across ranks next: every rank keeps its old weights
            err = exc
        self._agree(err, "swap")
        if self.quantize:
            local = quantize_params(local, mode=self.quantize, group=self.quant_group,
                                    amax_reduce=_amax_reducer(local, self.mesh, self._rules))
        super().swap_params(local)
        self._sum_weight_bytes()


class ShardedModelExecutor(_ShardedExecutorMixin, ModelExecutor):
    """:class:`~tpu_nexus_torch.serving.engine.ModelExecutor` across a
    replica's ranks: same contract (see the mixin)."""

    def _fresh_cache(self):
        return init_cache(self.cfg, self.num_slots, self.max_len, self.kv_quant,
                          shardings=self._kv_sharding, device=self.device)


class ShardedPagedModelExecutor(_ShardedExecutorMixin, PagedModelExecutor):
    """:class:`~tpu_nexus_torch.serving.engine.PagedModelExecutor` across a
    replica's ranks: the block pool is heads-sharded (``num_blocks`` stays
    global — block tables, prefix index and COW accounting are the
    leader's, broadcast with each call).

    The KV handoff (``extract_blocks``/``install_blocks``) speaks the
    one-device payload (``serving/handoff.py``): every kv head, in
    block-table order, sealed with the same CRCs, so a payload crosses
    between a sharded and a one-device replica in either direction."""

    def _fresh_cache(self):
        return init_paged_cache(self.cfg, self.num_blocks, self.page_size, self.kv_quant,
                                shardings=self._kv_sharding, device=self.device)

    def kv_leaf_specs(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """The per-block geometry of the REPLICA's pool (every kv head, as
        one device of the same model holds them), not of this rank's
        slice: what a payload is validated against."""
        coords, sizes = self.mesh.coords, _axis_sizes(self.mesh)
        counts = [shard_index(entry, coords, sizes)[1] for entry in self._kv_sharding.spec]
        return {
            name: ((int(arr.shape[0]), int(arr.shape[2]),
                    *(int(d) * n for d, n in zip(arr.shape[3:], counts[3:]))), arr.dtype)
            for name, arr in self.cache.items()
        }

    def extract_blocks(self, block_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The sender half of a KV handoff, one broadcast call: each rank
        gathers the blocks of its own heads, the leader's ``tp`` group
        all-gathers them along the heads dim (``collectives.gather_dim``:
        the seam's own all-gather, counted in its stats, which moves the
        card's tensors as every other collective of the replica does, and
        meets only the ranks that hold the leader's other heads), and the
        leader copies the whole payload to the host.  Under ``ep`` and on
        the replicate axes the heads are whole on every rank, so the
        leader's own blocks are the payload.  Only the leader returns the
        host tensors; the pool is only read."""
        return self._call("extract_blocks", (block_ids,), {})

    def install_blocks(self, payload: Any, block_ids: Sequence[int]) -> None:
        """The receiver half: the leader validates ``payload`` against the
        replica's geometry (:meth:`kv_leaf_specs`), its CRCs and the block
        count before any rank is told, so a corrupt payload raises
        ``PayloadCorrupt`` with no pool written; then the payload and the
        ids go to every rank in the call's header and each rank writes its
        own slice of the heads (every copy writes).  A rank that fails
        alone is :class:`ShardLost`."""
        self._call("install_blocks", (payload, self._checked_ids(payload, block_ids)), {})

    def block_checksums(self, block_ids: Sequence[int]) -> List[Dict[str, int]]:
        """Every rank's CRC32 of its own slice of each leaf over
        ``block_ids`` (in block-table order), in mesh order: what a
        handoff's install wrote on each rank."""
        return self._call("block_checksums", (block_ids,), {})

    def _local_extract_blocks(self, block_ids):
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        if ids.shape[0] < 1:
            raise ValueError("extract_blocks requires at least one block id")
        idx = self._tensor(ids, torch.long)
        comm, dim = self.comm, KV_CACHE_AXES.index("kv_heads")
        gather = comm.tp_size > 1 and self.mesh.ranks[0] in self.mesh.members["tp"]

        def run():
            if not (gather or self.mesh.is_leader):
                return None  # another copy's rank: the leader's copy holds the payload
            blocks = {name: arr[:, idx] for name, arr in self.cache.items()}
            if gather:
                blocks = {name: collectives.gather_dim(b, dim, comm.tp_group, comm.tp_size, comm)
                          for name, b in blocks.items()}
            return {name: b.contiguous().cpu() for name, b in blocks.items()} if self.mesh.is_leader else None

        return self._guarded(run)

    def _local_install_blocks(self, payload, ids):
        coords, sizes = self.mesh.coords, _axis_sizes(self.mesh)
        spec = self._kv_sharding.spec
        self._write_blocks({name: shard_leaf(torch.as_tensor(b), spec, coords, sizes)
                            for name, b in payload.blocks.items()}, ids)

    def _local_block_checksums(self, block_ids):
        from tpu_nexus_torch.serving.handoff import leaf_checksum

        idx = self._tensor(np.asarray(block_ids, np.int64).reshape(-1), torch.long)
        mine = {name: leaf_checksum(arr[:, idx].cpu()) for name, arr in self.cache.items()}
        return self.mesh.gather(mine)


_EXECUTORS = {cls.__name__: cls for cls in (ShardedModelExecutor, ShardedPagedModelExecutor)}


def launch_counts() -> Dict[str, Any]:
    """This process's kernel launch counters: #1 (the flash forward), #4 by
    mode, #5/#6 by route, #9."""
    from tpu_nexus_torch.ops.decode_attention import decode_attention
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    return {
        "flash_attention": flash_attention.launches,
        "decode_attention": decode_attention.launches,
        "decode_attention_by_mode": dict(decode_attention.launches_by_mode),
        "quant_matmul_int8": quant_matmul.launches_int8,
        "quant_matmul_int4": quant_matmul.launches_int4,
        "quant_matmul_by_route": dict(quant_matmul.launches_by_route),
        "rms_norm": rms_norm_kernel.launches,
    }


def reset_launch_counts() -> None:
    from tpu_nexus_torch.ops.decode_attention import reset_launches
    from tpu_nexus_torch.ops.flash_attention import flash_attention
    from tpu_nexus_torch.ops.quant_matmul import quant_matmul
    from tpu_nexus_torch.ops.rmsnorm import rms_norm_kernel

    flash_attention.launches = 0
    reset_launches()
    quant_matmul.launches_int8 = quant_matmul.launches_int4 = 0
    quant_matmul.launches_by_route = dict.fromkeys(quant_matmul.launches_by_route, 0)
    rms_norm_kernel.launches = 0


# -- the shard workers ----------------------------------------------------------


def serve_shard(mesh: ServeMesh, on_call: Optional[Callable[[int], None]] = None) -> None:
    """A shard worker's loop over its replica: build the executor the
    leader's header names, run every call it broadcasts (``on_call`` after
    each, with the leader's engine iteration), return at the stop op.  Errors every rank raised alike were the
    leader's to report; :class:`ShardLost` ends the worker."""
    executor = None
    while True:
        msg = mesh.recv()
        op = msg[0]
        if op == OP_STOP:
            del executor
            if mesh.device is not None and mesh.device.type == "cuda":
                torch.cuda.empty_cache()
            return
        try:
            if op == OP_INIT:
                _op, cls_name, source, cfg, kwargs = msg
                executor = None
                executor = _EXECUTORS[cls_name](source, cfg, mesh=mesh, **kwargs)
            elif op == OP_CALL:
                if executor is None:
                    raise ShardLost(f"rank {mesh.rank} got a call before its executor was built")
                executor._serve_op(msg[1], msg[2], msg[3])
                if on_call is not None:
                    on_call(msg[4])
            else:
                raise ShardLost(f"unknown shard op {op!r}")
        except ShardLost:
            raise
        except Exception as exc:  # noqa: BLE001 - agreed by every rank: the leader raises it, this rank waits for the next call
            logger.debug("shard rank %s: call failed on every rank alike: %s", mesh.rank, exc)


class RankPool:
    """This process as rank 0 (the leader) and shard workers started with
    the ``spawn`` context, joined in one process group: ``nccl`` (CUDA) and
    ``gloo`` (host) with one card a rank, ``gloo`` alone on the CPU and
    under the one-device rehearsal map (``rank_map="shared"``).  With
    ``plan`` (process 0's ``parallel/distributed.py::RankPlan`` of a
    launched world) the pool's world is ``plan.world``: this process spawns
    its ``plan.local - 1`` local workers and the other processes'
    ranks join at the coordinator's address
    (:func:`serve_launched_ranks`); the leader neither joins nor kills
    them, and finds a lost one by the group's timeout and the ranks'
    agreement after each call (:meth:`lost_ranks` names it).  :meth:`meshes` hands the workers replicas
    (each worker serves at most one at a time); :meth:`close` stops them,
    killing a local worker that outlives ``join_timeout_s``."""

    def __init__(
        self,
        world: int = 0,
        device: Any = "cuda",
        rank_map: str = "",
        timeout_s: Optional[float] = None,
        join_timeout_s: float = 60.0,
        plan: Any = None,
    ) -> None:
        import torch.multiprocessing as mp

        from tpu_nexus_torch.parallel import distributed

        if plan is None:
            if world < 1:
                raise ValueError(f"a rank pool needs >= 1 rank, got {world}")
            self.devices = distributed.rank_devices(world, str(device), rank_map)
            backend = distributed.backend_for(self.devices)
            distributed.check_backend(backend, self.devices)
            self.backend = "gloo" if backend == "gloo" else "cpu:gloo,cuda:nccl"
            init, local = f"tcp://127.0.0.1:{distributed.free_port()}", world
        else:
            if not plan.init_method:
                raise ValueError("a launched rank pool needs a plan of more than one rank")
            self.devices, self.backend, rank_map = list(plan.devices), plan.backend, plan.rank_map
            init, local, world = plan.init_method, plan.local, plan.world
        self.world = world
        self.rank_map = rank_map
        self.timeout_s = float(timeout_s or distributed.timeout_from_env())
        self.join_timeout_s = join_timeout_s
        self.device = self.devices[0]
        self._meshes: List[ServeMesh] = []
        ctx = mp.get_context("spawn")
        self.procs = []
        for rank in range(1, local):
            proc = ctx.Process(
                target=_pool_worker,
                args=(rank, world, init, str(self.devices[rank]), self.backend, self.timeout_s,
                      logger.getEffectiveLevel()),
                daemon=True,
            )
            proc.start()
            logger.info("started shard worker rank %d pid %d on %s", rank, proc.pid, self.devices[rank])
            self.procs.append(proc)
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            # the leader never waits idle: its groups keep a finite timeout
            # (a spawned worker imports torch first: it has STARTUP_TIMEOUT
            # to join), so a worker that dies or stops answering raises here
            distributed.start_process_group(
                init, 0, world, self.backend, max(self.timeout_s, STARTUP_TIMEOUT.total_seconds()))
        except BaseException:
            self._kill()
            raise
        self._init, self._local = init, local
        self._closed = False

    def lost_ranks(self, window_s: float = 4 * ALIVE_EVERY_S) -> List[int]:
        """The worker ranks that died or stopped, which the leader names
        when the replica is lost: a local worker by its exit, a rank of
        another launched process by its liveness counter in the pool's
        store standing still over ``window_s``."""
        import time

        lost = [rank for rank, proc in enumerate(self.procs, 1) if not proc.is_alive()]
        remote = range(self._local, self.world)
        if not remote:
            return lost
        try:
            store = _store_client(self._init)
            keys = [f"nexus/alive/{r}" for r in remote]
            before = [store.add(k, 0) for k in keys]
            time.sleep(window_s)
            return lost + [r for r, k, n in zip(remote, keys, before) if store.add(k, 0) == n]
        except Exception as exc:  # noqa: BLE001 - the store itself is unreachable: nothing more to name
            logger.warning("rank pool: liveness counters unreadable (%s)", exc)
            return lost

    def meshes(self, specs: Sequence[Tuple[Dict[str, int], Sequence[int]]]) -> List[ServeMesh]:
        """One :class:`ServeMesh` per ``(axes, ranks)``; rank 0 is every
        replica's leader.  Every rank of the pool builds them."""
        import torch.distributed as dist

        specs = [(dict(axes), tuple(ranks)) for axes, ranks in specs]
        for _axes, ranks in specs:
            if not ranks or ranks[0] != 0:
                raise ValueError(f"a replica's first rank is its leader, rank 0; got {ranks}")
        dist.broadcast_object_list([("meshes", specs)], src=0, device=torch.device("cpu"))
        meshes = [build_serve_mesh(axes, ranks, device=self.device, timeout_s=self.timeout_s)
                  for axes, ranks in specs]
        self._meshes.extend(meshes)
        return meshes

    def reset_counts(self) -> None:
        """Zero every rank's kernel launch counters, collective stats and
        peak device memory."""
        self._world(("reset",))
        _pool_op(("reset",), self.device)

    def gloo_cuda_probe(self) -> Dict[str, str]:
        """Which collectives this torch's gloo takes on the device's
        tensors: every rank tries each (bf16 and f32); ``"ok"`` or the
        error's first line."""
        self._world(("probe",))
        return _pool_op(("probe",), self.device)

    def _world(self, msg: Any) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=0, device=torch.device("cpu"))

    def mesh(self, axes: Dict[str, int]) -> ServeMesh:
        """One replica over the first ``prod(axes)`` ranks."""
        n = 1
        for s in axes.values():
            n *= s
        return self.meshes([(axes, range(n))])[0]

    def close(self) -> None:
        """Stop the workers and leave the process group; a worker that
        outlives the join deadline is killed."""
        import torch.distributed as dist

        if self._closed:
            return
        self._closed = True
        try:
            for mesh in self._meshes:
                mesh.stop()
            dist.broadcast_object_list([("exit",)], src=0, device=torch.device("cpu"))
        except Exception as exc:  # noqa: BLE001 - a lost worker broke the world: the join below reaps the rest
            logger.warning("rank pool: exit broadcast failed (%s); reaping the workers", exc)
        for proc in self.procs:
            proc.join(self.join_timeout_s)
        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _pool_op(msg: Any, device: Any) -> Any:
    """A world-wide op of the pool, on every rank."""
    import torch.distributed as dist

    if msg[0] == "reset":
        reset_launch_counts()
        collectives.STATS.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        return None
    found = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.ones(4, dtype=dtype, device=device)
        out = torch.empty(4 * dist.get_world_size(), dtype=dtype, device=device)
        trials = {
            "all_reduce": lambda: dist.all_reduce(x),
            "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(dist.get_world_size())], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out, x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(x, out),
            "broadcast": lambda: dist.broadcast(x, src=0),
        }
        for name, fn in trials.items():
            try:
                fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                found[f"{name}/{str(dtype).removeprefix('torch.')}"] = "ok"
            except Exception as exc:  # noqa: BLE001 - the probe reports what this transport refuses
                found[f"{name}/{str(dtype).removeprefix('torch.')}"] = str(exc).splitlines()[0][:160]
    return found


def _join_pool(
    rank: int, world: int, init_method: str, device: str, backend: str, alive: bool
) -> Tuple[torch.device, Callable[[], None]]:
    """A worker rank's device and its place in the pool's process group
    (it waits there for the leader at the idle timeout), with the stop of
    its liveness counter (``alive``: a rank of another launched process
    bumps one; the caller stops it before the process ends)."""
    import os

    from tpu_nexus_torch.parallel.distributed import start_process_group

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # ranks sharing the host's cores: a share each, not all of them each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    start_process_group(init_method, rank, world, backend, IDLE_TIMEOUT.total_seconds())
    return dev, (_beat_alive(init_method, rank) if alive else (lambda: None))


def _store_client(init_method: str) -> Any:
    """A client of the pool's rendezvous store (``tcp://host:port``; rank
    0, the leader, serves it)."""
    import torch.distributed as dist

    host, port = init_method.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), is_master=False, timeout=_STORE_TIMEOUT)


def _beat_alive(init_method: str, rank: int) -> Callable[[], None]:
    """Bump ``nexus/alive/<rank>`` in the pool's store every
    :data:`ALIVE_EVERY_S` from a daemon thread, so the leader can name a
    rank of another process that died or stopped
    (:meth:`RankPool.lost_ranks`); the thread ends with the store.  Returns
    the stop: it ends the thread and waits for it, so that no bump is in
    flight when the process exits (a daemon thread inside the store's call
    at interpreter exit aborts the process: SIGABRT, "terminate called
    without an active exception")."""
    import threading

    stopped = threading.Event()

    def beat() -> None:
        try:
            store = _store_client(init_method)
            while not stopped.is_set():
                store.add(f"nexus/alive/{rank}", 1)
                stopped.wait(ALIVE_EVERY_S)
        except Exception:  # noqa: BLE001 - the leader's store is gone: so is the pool
            return

    thread = threading.Thread(target=beat, name=f"alive-{rank}", daemon=True)
    thread.start()

    def stop() -> None:
        stopped.set()
        thread.join(_STORE_TIMEOUT.total_seconds())

    return stop


def _worker_loop(dev: torch.device, timeout_s: float, on_call: Optional[Callable[[int], None]] = None) -> None:
    """Serve each replica the leader assigns until it says exit."""
    import torch.distributed as dist

    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, device=torch.device("cpu"))
        if box[0][0] == "exit":
            break
        if box[0][0] in ("reset", "probe"):
            _pool_op(box[0], dev)
            continue
        # every rank builds every mesh (its groups) before any serves one
        meshes = [build_serve_mesh(axes, ranks, device=dev, timeout_s=timeout_s) for axes, ranks in box[0][1]]
        for mesh in meshes:
            if mesh.is_member:
                serve_shard(mesh, on_call)
    dist.destroy_process_group()


def _pool_worker(
    rank: int, world: int, init_method: str, device: str, backend: str, timeout_s: float, log_level: int,
    alive: bool = False,
) -> None:
    """A spawned shard worker process: join the group, then serve each
    replica the leader assigns until it says exit.  The process imports
    only this package (``spawn``: nothing of the parent's state) and logs at
    the leader's level."""
    import sys

    logging.basicConfig(level=log_level, stream=sys.stderr)
    dev, stop_beat = _join_pool(rank, world, init_method, device, backend, alive)
    try:
        _worker_loop(dev, timeout_s)
    finally:
        stop_beat()


def serve_launched_ranks(
    plan: Any, process_id: int, timeout_s: float, on_call: Optional[Callable[[int], None]] = None
) -> None:
    """Process ``process_id`` > 0 of a launched world: its ``plan.local``
    ranks of the pool that process 0's :class:`RankPool` leads — local ranks
    ``1..local-1`` spawned, the first served here (``on_call`` after each
    executor call it runs, with the leader's engine iteration), each bumping
    its liveness counter — until the leader's exit.  A spawned rank that
    exits non-zero fails the process."""
    import torch.multiprocessing as mp

    if process_id < 1:
        raise ValueError("process 0 leads the pool (RankPool(plan=...)); the others serve its ranks")
    first = process_id * plan.local
    ctx = mp.get_context("spawn")
    procs = []
    for j in range(1, plan.local):
        proc = ctx.Process(
            target=_pool_worker,
            args=(first + j, plan.world, plan.init_method, str(plan.devices[j]), plan.backend, timeout_s,
                  logger.getEffectiveLevel(), True),
            daemon=True,
        )
        proc.start()
        logger.info("started shard worker rank %d pid %d on %s", first + j, proc.pid, plan.devices[j])
        procs.append(proc)
    ok = False
    try:
        dev, stop_beat = _join_pool(first, plan.world, plan.init_method, str(plan.devices[0]), plan.backend, True)
        try:
            _worker_loop(dev, timeout_s, on_call)
        finally:
            stop_beat()
        ok = True
    finally:
        # a failed first rank takes its local ranks down at once
        for proc in procs:
            proc.join(timeout_s if ok else 0.0)
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
    failed = {first + j + 1: p.exitcode for j, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise ShardLost(f"shard worker rank(s) exited non-zero: {failed} (rank: exit code)")
