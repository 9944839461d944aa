"""Device-mesh construction: the port of ``tpu_nexus/parallel/mesh.py``.

The mesh axes keep the JAX package's names and order (``pp``, ``dp``,
``fsdp``, ``ep``, ``sp``, ``tp``; tp innermost, so a tensor-parallel
group is a run of neighbouring ranks).  :class:`MeshSpec` and its
:meth:`~MeshSpec.resolve` are the reference's pure logic, copied.
:func:`build_mesh` lays the spec over the ranks of the process group as a
``torch.distributed.device_mesh.DeviceMesh`` with those axis names.  The
collectives are explicit in the port (``parallel/collectives.py``); the
mesh only names which ranks form each axis.  :class:`TrainMesh` is the
training path's: the sizes, this rank's coordinates and one plain
process group per axis and per run of axes the train step reduces over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: canonical axis order, as in the JAX package
AXIS_ORDER: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape.  Sizes must multiply to the device count; a
    single ``-1`` axis is inferred (numpy-reshape style)."""

    pp: int = 1
    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)

    def resolve(self, n_devices: int) -> Tuple[int, ...]:
        """Concretize the one allowed ``-1`` against ``n_devices``."""
        sizes = list(self.sizes())
        if any(s == 0 or s < -1 for s in sizes):
            raise ValueError(f"axis sizes must be -1 or >= 1, got spec {self}")
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got spec {self}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} wants {fixed} devices, have {n_devices}")
        return tuple(sizes)

    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER


def mesh_coords(index: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of position ``index`` in a mesh of ``sizes``
    (the last axis fastest, as ``numpy.reshape`` lays the JAX mesh)."""
    coords = []
    for size in reversed(tuple(sizes)):
        coords.append(index % size)
        index //= size
    return tuple(reversed(coords))


def build_mesh(spec: Optional[MeshSpec] = None, device_type: str = "cpu", ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over ``ranks`` (default: every rank of the process
    group) shaped by ``spec`` with the axis names of :data:`AXIS_ORDER`.
    Every rank of the group calls it (the mesh creates one sub-group per
    axis).  Size-1 axes are kept, so a rule table can name any axis."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    spec = spec or MeshSpec()
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    sizes = spec.resolve(len(ranks))
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(sizes), mesh_dim_names=AXIS_ORDER)


#: the mesh axes a parameter gradient is summed over when the parameter is
#: not cut along them (the data-bearing axes); ``fsdp`` sums through the
#: gather's reduce-scatter where it cuts the parameter
DATA_AXES: Tuple[str, ...] = ("dp", "fsdp", "sp")


class TrainMesh:
    """One rank's view of the training mesh over a process group: the axis
    sizes (``AXIS_ORDER``, tp innermost), this rank's coordinates, and a
    ``torch.distributed`` group for every set of the axes larger than one
    (the step reduces over runs of them: the data axes, a leaf's shard axes).

    Every rank of the world constructs it with the same arguments (group
    creation is collective); ranks outside ``ranks`` get
    ``is_member == False`` and no groups of their own.  A group's members
    are in rank order, which is the row-major order of their coordinates on
    its axes (major-first), as :func:`sharding.shard_index` cuts a dim
    over several axes.  A world of one (no process group) is the trivial
    mesh: every size 1, no groups."""

    def __init__(self, spec: Optional[MeshSpec] = None, ranks: Optional[Sequence[int]] = None,
                 backend: str = "gloo") -> None:
        import itertools

        import torch.distributed as dist

        spec = spec or MeshSpec()
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.ranks = list(range(world)) if ranks is None else list(ranks)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.backend = backend
        self.sizes: Dict[str, int] = dict(zip(AXIS_ORDER, spec.resolve(len(self.ranks))))
        self.is_member = self.rank in self.ranks
        shape = tuple(self.sizes.values())
        index = self.ranks.index(self.rank) if self.is_member else 0
        self.coords: Dict[str, int] = dict(zip(AXIS_ORDER, mesh_coords(index, shape)))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._members: Dict[Tuple[str, ...], List[int]] = {}
        self._comm = None
        active = [a for a in AXIS_ORDER if self.sizes[a] > 1]
        coords = [dict(zip(AXIS_ORDER, mesh_coords(i, shape))) for i in range(len(self.ranks))]
        for n in range(1, len(active) + 1):
            for axes in itertools.combinations(active, n):
                others = [a for a in AXIS_ORDER if a not in axes]
                parts: Dict[Tuple[int, ...], List[int]] = {}
                for r, c in zip(self.ranks, coords):
                    parts.setdefault(tuple(c[a] for a in others), []).append(r)
                for members in parts.values():
                    group = dist.new_group(members, backend=backend)
                    if self.rank in members:
                        self._groups[axes] = group
                        self._members[axes] = members

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if a in axes and self.sizes[a] > 1)

    def size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def group(self, *axes: str) -> Any:
        """The group of this rank over ``axes`` (None where they span one rank)."""
        key = self._key(axes)
        return self._groups[key] if key else None

    def members(self, *axes: str) -> List[int]:
        key = self._key(axes)
        return self._members[key] if key else [self.rank]

    def index(self, *axes: str) -> int:
        """This rank's position in its group over ``axes`` (major-first)."""
        i = 0
        for a in AXIS_ORDER:
            if a in axes:
                i = i * self.sizes[a] + self.coords[a]
        return i

    @property
    def world(self) -> int:
        return len(self.ranks)

    def comm(self) -> Any:
        """The model's view (``collectives.ShardComm``): its tp group."""
        from tpu_nexus_torch.parallel.collectives import ShardComm

        if self._comm is None:
            self._comm = ShardComm(tp_size=self.sizes["tp"], tp_rank=self.coords["tp"],
                                   tp_group=self.group("tp"), backend=self.backend)
        return self._comm

    def describe(self) -> Dict[str, int]:
        return {a: s for a, s in self.sizes.items() if s > 1}
