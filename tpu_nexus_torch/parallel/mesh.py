"""Device-mesh construction: the port of ``tpu_nexus/parallel/mesh.py``.

The mesh axes keep the JAX package's names and order (``pp``, ``dp``,
``fsdp``, ``ep``, ``sp``, ``tp``; tp innermost, so a tensor-parallel
group is a run of neighbouring ranks).  :class:`MeshSpec` and its
:meth:`~MeshSpec.resolve` are the reference's pure logic, copied.
:func:`build_mesh` lays the spec over the ranks of the process group as a
``torch.distributed.device_mesh.DeviceMesh`` with those axis names.  The
collectives are explicit in the port (``parallel/collectives.py``); the
mesh only names which ranks form each axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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
