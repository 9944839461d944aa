"""The collective seam of sharded serving: every cross-rank exchange of the
model's forward, in one place.

The JAX package has no such file — GSPMD inserts its collectives from the
sharding annotations.  The port makes them explicit, and the model code
calls them at the few points where a sharded forward needs one:

* :func:`reduce_tp` — the sum over ``tp`` of a row-parallel product's
  partial outputs (``wo`` after attention, ``w_down`` after the MLP);
* :func:`embed_rows` — a vocab-sharded embedding lookup: ids outside this
  rank's vocab slice give zero rows, then a sum over ``tp`` (exact: each
  row has one non-zero term);
* :func:`gather_vocab` — the vocab-sharded logits gathered along the vocab
  axis on every rank, so every rank (not only the leader) takes the same
  greedy argmax inside a multi-step decode;
* :func:`reduce_experts` — the sum of the local experts' combined output
  (and, under ``tp``, of their mlp slices) over every rank of the replica.

Each reads the :class:`ShardComm` that the sharded executor makes active
around its entry points (:func:`active`).  With none active (a world of
one) each is the identity — the one-device paths run unchanged.

Transport: NCCL takes the card's tensors directly; so does gloo (the
one-device rehearsal map) on torch 2.11, which moves them through host
memory itself — every collective here, bf16 and f32 (``chip_smoke.py``
serve_sharded's probe, ``RankPool.gloo_cuda_probe``).  The weights, the
cache and every kernel stay on the device.  :data:`STATS` counts calls
and bytes per collective, and their seconds when
:meth:`CollectiveStats.timing` is on (each timed call synchronizes the
device first).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

import torch

class CollectiveError(Exception):
    """A collective of the seam failed (a peer died, a timeout, a refused
    transport).  Not a ``RuntimeError``: the executors' fault guards must
    not mistake it for a device fault of one request."""


@dataclass(frozen=True)
class ShardComm:
    """One rank's view of its replica's mesh: its ``tp`` group and index,
    its index on ``ep``, and ``moe_group``, every rank of the replica (the
    experts' combine sums over all of them)."""

    tp_size: int = 1
    tp_rank: int = 0
    tp_group: Any = None
    ep_size: int = 1
    ep_rank: int = 0
    moe_group: Any = None
    backend: str = "gloo"

    def expert_range(self, n_experts: int) -> range:
        """The experts this rank computes: a contiguous ``n_experts / ep``."""
        per = n_experts // self.ep_size
        return range(self.ep_rank * per, (self.ep_rank + 1) * per)


class CollectiveStats:
    """Calls, bytes and (when timing) seconds per collective."""

    def __init__(self) -> None:
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.seconds: Counter = Counter()

    @contextlib.contextmanager
    def timing(self) -> Iterator[None]:
        self.timed = True
        try:
            yield
        finally:
            self.timed = False

    def to_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes), "seconds": dict(self.seconds)}


STATS = CollectiveStats()
_ACTIVE: List[ShardComm] = []


@contextlib.contextmanager
def active(comm: Optional[ShardComm]) -> Iterator[None]:
    """Make ``comm`` the seam's mesh for the block (None: no mesh)."""
    _ACTIVE.append(comm)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current() -> Optional[ShardComm]:
    return _ACTIVE[-1] if _ACTIVE else None


def _run(name: str, x: torch.Tensor, comm: ShardComm, fn) -> Any:
    """Count, optionally time, and run one collective ``fn(x)``."""
    STATS.calls[name] += 1
    STATS.bytes[name] += x.numel() * x.element_size()
    if STATS.timed and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    try:
        out = fn(x)
    except Exception as exc:  # noqa: BLE001 - whatever the transport raised, the replica's ranks parted
        raise CollectiveError(f"{name} over {comm.backend} failed: {exc}") from exc
    if STATS.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        STATS.seconds[name] += time.perf_counter() - t0
    return out


def _all_reduce(x: torch.Tensor, group: Any, comm: ShardComm, op: str = "sum") -> torch.Tensor:
    import torch.distributed as dist

    def fn(t):
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
        return t

    return _run("all_reduce" if op == "sum" else "all_reduce_max", x, comm, fn)


def reduce_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel product's partial output over ``tp``."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return x
    return _all_reduce(x, comm.tp_group, comm)


def reduce_experts(x: torch.Tensor) -> torch.Tensor:
    """Sum the local experts' (and mlp slices') combined output over every
    rank of the replica."""
    comm = current()
    if comm is None or comm.tp_size * comm.ep_size == 1:
        return x
    return _all_reduce(x, comm.moe_group, comm)


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``tp`` (an int8 scale's amax, where the
    contraction dim is sharded)."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return x
    return _all_reduce(x, comm.tp_group, comm, op="max")


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a table whose rows (the vocab) are sharded over
    ``tp``: this rank's ``[V / tp, E]`` slice answers the ids it holds,
    zeros elsewhere, summed over ``tp``."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return table[ids]
    rows = table.shape[0]
    local = ids - comm.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    picked = table[local.clamp(0, rows - 1)]
    picked = torch.where(inside[..., None], picked, torch.zeros((), dtype=picked.dtype, device=picked.device))
    return _all_reduce(picked, comm.tp_group, comm)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded logits ``[..., V / tp]`` gathered to ``[..., V]`` on
    every rank, in rank order."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return logits
    import torch.distributed as dist

    def fn(t):
        parts = [torch.empty_like(t) for _ in range(comm.tp_size)]
        dist.all_gather(parts, t.contiguous(), group=comm.tp_group)
        return torch.cat(parts, dim=-1)

    return _run("all_gather", logits, comm, fn)
