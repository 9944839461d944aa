"""The collective seam of the sharded paths: every cross-rank exchange of
the model's forward and backward, in one place.

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

Each reads the :class:`ShardComm` that the sharded executor (or the
sharded train step) makes active around its entry points (:func:`active`).
With none active (a world of one) each is the identity — the one-device
paths run unchanged.  :func:`reduce_tp` and :func:`embed_rows` are the
all-reduce-forward, identity-backward half of the tensor-parallel pair
and :func:`copy_to_tp` the other half (identity forward, all-reduce
backward), so the same blocks train under ``tp``.

Training adds, for the parallel train step (``workload/train.py``):

* :class:`FsdpGather` — a parameter shard all-gathered over ``fsdp`` in
  the forward, its gradient reduce-scattered (summed) in the backward;
* :func:`reduce_sum` — the all-reduce-forward half over any group (the
  loss's CE and z sums over the data ranks);
* :func:`all_reduce_grads` — the data-parallel gradient all-reduce,
  coalesced into one buffer a dtype;
* :class:`AllToAll` — Ulysses' sequence <-> heads exchange;
* :func:`ring_shift` — the ring's point-to-point rotation, one hop.

Every rank issues them in the same order: the model visits layers and
leaves in one order, a checkpointed layer's recompute gathers its weights
again in the same order, and the ring rotates on every rank at every step
whether or not the block it brings is skipped.

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

#: collectives this process stages through host memory because its
#: transport (gloo on a card's tensors, under the one-device rehearsal map)
#: refuses them on the device; set by :func:`stage_through_host` from a
#: probe, never under nccl
STAGED: set = set()


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
        raise CollectiveError(f"{name} over {getattr(comm, 'backend', 'the group')} failed: {exc}") from exc
    if STATS.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        STATS.seconds[name] += time.perf_counter() - t0
    return out


def _all_reduce(x: torch.Tensor, group: Any, comm: Any, op: str = "sum", name: str = "") -> torch.Tensor:
    import torch.distributed as dist

    def fn(t):
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
        return t

    return _run(name or ("all_reduce" if op == "sum" else "all_reduce_max"), x, comm, fn)


class _ReduceSum(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the value every rank of
    the group then holds is one quantity, each rank's gradient its own
    term's."""

    @staticmethod
    def forward(ctx, x, group, comm, name):
        return _all_reduce(x, group, comm, name=name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a replicated input that
    each rank of the group uses for its own shard of the work."""

    @staticmethod
    def forward(ctx, x, group, comm, name):
        ctx.group, ctx.comm, ctx.name = group, comm, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.comm, name=ctx.name), None, None, None


def reduce_sum(x: torch.Tensor, group: Any, size: int, comm: Any = None, name: str = "all_reduce") -> torch.Tensor:
    """:class:`_ReduceSum` over ``group`` (identity when ``size`` is 1)."""
    if size == 1:
        return x
    return _ReduceSum.apply(x, group, comm or current(), name)


def reduce_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel product's partial output over ``tp`` (identity
    backward: the sum is replicated over tp)."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return x
    return _ReduceSum.apply(x, comm.tp_group, comm, "all_reduce")


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering tp-sharded products (q/k/v, gate/up,
    the vocabulary-parallel head): identity forward, its gradient summed
    over ``tp`` in the backward."""
    comm = current()
    if comm is None or comm.tp_size == 1:
        return x
    return _CopyTo.apply(x, comm.tp_group, comm, "all_reduce")


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
    return _ReduceSum.apply(picked, comm.tp_group, comm, "all_reduce")


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


# -- training -------------------------------------------------------------------


def stage_through_host(names) -> None:
    """Stage the named collectives (``all_to_all``, ``send_recv``) through
    host memory from now on: the rehearsal map's answer to a gloo that
    refuses a card's tensors.  The caller reports what it staged."""
    STAGED.clear()
    STAGED.update(names)


def _staged(name: str, tensors, fn):
    """Run ``fn`` on ``tensors``, or on host copies of them copied back when
    ``name`` is staged and they live on a card."""
    if name not in STAGED or not tensors[0].is_cuda:
        return fn(tensors)
    host = [t.to("cpu") for t in tensors]
    fn(host)
    for t, h in zip(tensors, host):
        t.copy_(h)
    return tensors


def _gather_dim(x: torch.Tensor, dim: int, group: Any, size: int, comm: Any, name: str = "all_gather") -> torch.Tensor:
    import torch.distributed as dist

    def fn(t):
        t = t.movedim(dim, 0).contiguous()
        out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out.movedim(0, dim)

    return _run(name, x, comm, fn)


def _scatter_dim(g: torch.Tensor, dim: int, group: Any, size: int, comm: Any) -> torch.Tensor:
    import torch.distributed as dist

    def fn(t):
        t = t.movedim(dim, 0).contiguous()
        out = torch.empty((t.shape[0] // size,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim)

    return _run("fsdp_reduce_scatter", g, comm, fn)


class FsdpGather(torch.autograd.Function):
    """A parameter shard gathered along ``dim`` over the ``fsdp`` group in
    the forward; in the backward the full gradient is reduce-scattered:
    each rank gets the sum over the group of its own slice."""

    @staticmethod
    def forward(ctx, x, dim, group, size, comm):
        ctx.dim, ctx.group, ctx.size, ctx.comm = dim, group, size, comm
        return _gather_dim(x, dim, group, size, comm, "fsdp_all_gather")

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group, ctx.size, ctx.comm), None, None, None, None


def gather_dim(x: torch.Tensor, dim: int, group: Any, size: int, comm: Any = None) -> torch.Tensor:
    """``x`` gathered along ``dim`` over ``group`` without autograd (a
    checkpoint's global leaf, a replicated statistic)."""
    if size == 1:
        return x
    return _gather_dim(x, dim, group, size, comm)


def all_reduce_grads(grads, group: Any, comm: Any = None) -> None:
    """Sum gradients over ``group`` in place: one coalesced buffer a dtype,
    one all-reduce each (the data-parallel reduction)."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        flat = _all_reduce(flat, group, comm, name="grad_all_reduce")
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _a2a(x: torch.Tensor, scatter_dim: int, gather_dim: int, group: Any, size: int, comm: Any) -> torch.Tensor:
    """``x`` cut into ``size`` parts along ``scatter_dim``, part ``i`` sent to
    rank ``i`` of the group, the parts received concatenated along
    ``gather_dim`` in rank order."""
    import torch.distributed as dist

    def fn(t):
        parts = t.movedim(scatter_dim, 0)
        shape = parts.shape
        send = parts.reshape((size, shape[0] // size) + tuple(shape[1:])).contiguous()
        recv = torch.empty_like(send)
        _staged("all_to_all", [send, recv], lambda ts: dist.all_to_all_single(ts[1], ts[0], group=group))
        # recv[i] is rank i's part: [size, n/size, ...] with scatter dim first
        recv = recv.movedim(1, scatter_dim + 1)
        return torch.cat(list(recv.unbind(0)), dim=gather_dim)

    return _run("all_to_all", x, comm, fn)


class AllToAll(torch.autograd.Function):
    """:func:`_a2a` whose backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, scatter_dim, gather_dim, group, size, comm):
        ctx.args = (scatter_dim, gather_dim, group, size, comm)
        return _a2a(x, scatter_dim, gather_dim, group, size, comm)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim, group, size, comm = ctx.args
        return _a2a(g, gather_dim, scatter_dim, group, size, comm), None, None, None, None, None


def ring_shift(tensors, ranks, index: int, comm: Any = None, tag: int = 0):
    """One hop of the ring over the global ``ranks`` (in ring order): this
    rank (position ``index``) sends each tensor to the previous position and
    receives the next position's, so after ``t`` hops position ``i`` holds
    what position ``(i + t) % n`` started with.  One message a hop: the
    tensors (one dtype) travel packed in one buffer."""
    import torch.distributed as dist

    n = len(ranks)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dst, src = ranks[(index - 1) % n], ranks[(index + 1) % n]

    def fn(t):
        recv = torch.empty_like(t)

        def exchange(ts):
            ops = [dist.P2POp(dist.isend, ts[0], dst, tag=tag), dist.P2POp(dist.irecv, ts[1], src, tag=tag)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        _staged("send_recv", [t, recv], exchange)
        return recv

    recv = _run("ring_send_recv", flat, comm, fn)
    out, offset = [], 0
    for t in tensors:
        out.append(recv[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


def probe(device: Any, p2p: bool = False) -> dict:
    """Which training collectives the default group's transport takes on
    ``device``'s tensors, bf16 and f32: ``"ok"`` or the error's first line
    (every rank of the world calls it; a refusal raises alike on all).
    ``p2p`` tries the ring's send/recv too: gloo's point-to-point reads the
    tensor's memory from the host, so on a card's tensors it may take the
    ranks down rather than raise — probe it in a world of its own."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    found = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.ones(4 * world, dtype=dtype, device=device)
        trials = {
            "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(torch.empty_like(x[:4]), x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(torch.empty_like(x), x[:4]),
            "all_reduce": lambda: dist.all_reduce(x),
        }
        if p2p:
            trials["send_recv"] = lambda: [w.wait() for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank - 1) % world),
                dist.P2POp(dist.irecv, torch.empty_like(x), (rank + 1) % world)])]
        for name, fn in trials.items():
            key = f"{name}/{str(dtype).removeprefix('torch.')}"
            try:
                fn()
                if x.is_cuda:
                    torch.cuda.synchronize(x.device)
                found[key] = "ok"
            except Exception as exc:  # noqa: BLE001 - the probe reports what this transport refuses
                found[key] = (str(exc).splitlines() or [type(exc).__name__])[0][:160]
        dist.barrier()
    return found
