"""Pipeline parallelism (the ``pp`` mesh axis): the port of
``tpu_nexus/parallel/pipeline.py``.

The JAX package pipelines as a GSPMD program transformation: every stage
is vmapped over a pp-sharded stage axis, the hand-off is a ``jnp.roll``
that XLA lowers to a ``CollectivePermute``, and the backward comes out of
autodiff.  Here a stage is a rank holding ``L / pp`` layers, and the
schedule is written out:

* **GPipe.**  The batch splits into ``M`` microbatches.  Stage ``s`` takes
  microbatch ``t`` at tick ``t + s``: it receives the carry from stage
  ``s - 1`` (stage 0 takes its slice of ``x``), applies its layers, and
  sends the result to stage ``s + 1`` (``collectives.SendNext`` /
  ``RecvPrev``, one packed message a hand-off, host-staged under the
  rehearsal map's gloo).  Each microbatch's graph is kept; the backward
  walks the microbatches in reverse, and the hand-off pair's backward
  sends each carry's cotangent back a stage.  Microbatching reorders only
  f32 sums: the math is the reference's.  (1F1B is not here.)
* The whole schedule is one autograd node on each rank
  (:class:`_Pipeline`): its inputs are ``x`` (used on stage 0) and the
  stage's layer leaves, its output the carry on the last stage and a 0-d
  zero for each carry leaf elsewhere — the caller ties those into its
  loss so the stage's backward runs.
* The carry is a tuple of tensors, as in the reference.

:func:`auto_microbatches` and :func:`resolve_microbatches` are the
reference's, with the same texts.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Sequence, Tuple

import torch


def auto_microbatches(batch: int, n_stages: int, min_microbatch: int = 1) -> int:
    """Pick a microbatch count: the largest of 4·P / 2·P / P that divides the
    batch (bubble fraction (P-1)/(M+P-1): 4·P ⇒ ≤20%) while keeping each
    microbatch divisible by ``min_microbatch`` — the data-parallel extent."""
    for m in (4 * n_stages, 2 * n_stages, n_stages):
        if batch % m == 0 and (batch // m) % min_microbatch == 0:
            return m
    raise ValueError(
        f"batch size {batch} admits none of "
        f"{[4 * n_stages, 2 * n_stages, n_stages]} microbatch counts for "
        f"{n_stages} pipeline stages with microbatches divisible by "
        f"{min_microbatch} (the data-parallel extent); pick pp_microbatches "
        "explicitly or grow the batch"
    )


def resolve_microbatches(
    batch: int,
    n_stages: int,
    microbatches: int = 0,
    mesh: Any = None,
    batch_axes: Any = ("dp", "fsdp"),
) -> int:
    """Auto-pick (``microbatches=0``) or validate an explicit microbatch
    count against the data-parallel extent (``mesh.size(*batch_axes)``).
    ``batch`` is the GLOBAL batch."""
    from tpu_nexus_torch.parallel.sharding import axes_of

    axes = axes_of(batch_axes)
    dp_extent = mesh.size(*axes) if mesh is not None and axes else 1
    if not microbatches:
        return auto_microbatches(batch, n_stages, min_microbatch=dp_extent)
    if batch % microbatches or (batch // microbatches) % dp_extent:
        raise ValueError(
            f"pp_microbatches={microbatches} gives microbatch size "
            f"{batch / microbatches} from batch {batch}, which is not a "
            f"multiple of the data-parallel extent {dp_extent} "
            f"({'×'.join(axes) or '-'})"
        )
    return microbatches


def rank_microbatches(rows: int, n_stages: int, microbatches: int = 0, mesh: Any = None,
                      batch_axes: Any = ("dp", "fsdp")) -> int:
    """:func:`resolve_microbatches` for a rank that holds ``rows`` of the
    global batch (its share over ``batch_axes``)."""
    from tpu_nexus_torch.parallel.sharding import axes_of

    n_data = mesh.size(*axes_of(batch_axes)) if mesh is not None else 1
    return resolve_microbatches(rows * n_data, n_stages, microbatches, mesh=mesh, batch_axes=batch_axes)


def microbatch_rows(batch: int, n_data: int, index: int, microbatches: int) -> Any:
    """The global rows a data rank (``index`` of ``n_data``) holds under the
    pipeline: its contiguous share of every microbatch, microbatch-major —
    the reference's microbatch ``m`` is global rows ``[m·mb, (m+1)·mb)``,
    cut over the data axes."""
    import numpy as np

    mb = batch // microbatches
    share = mb // n_data
    return (np.arange(microbatches)[:, None] * mb + index * share + np.arange(share)[None, :]).reshape(-1)


def _layer(stacked: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    return {name: w[li] for name, w in stacked.items()}


def _check(n_layers: int, n_stages: int, batch: int, microbatches: int) -> None:
    if n_layers % n_stages:
        raise ValueError(f"n_layers {n_layers} not divisible by pp={n_stages}")
    if batch % microbatches:
        raise ValueError(f"batch {batch} not divisible by microbatches {microbatches}")


def pipeline_apply(
    layer_fn: Callable[[Any, Any], Any],
    stacked_layers: Dict[str, torch.Tensor],
    x: Any,
    *,
    n_stages: int,
    microbatches: int,
    mesh: Any = None,
) -> Any:
    """Apply stacked layers to ``x`` as an ``n_stages``-deep pipeline of
    ``microbatches`` microbatches.

    ``layer_fn(carry, layer) -> carry`` is the one-layer body (remat-wrapped
    by the caller if wanted); ``x`` is a tensor or a tuple of ``[B, ...]``
    tensors (the carry); returns the same structure.

    Without a mesh (or with ``pp`` 1) ``stacked_layers`` holds all ``L``
    layers and the stages run one after another in this process: every
    microbatch through every layer.  On a mesh with ``pp > 1`` it holds
    this rank's stage, ``L / pp`` layers, and the ranks of the ``pp`` group
    run the GPipe schedule (module docstring); on every stage but the last
    each returned leaf is a 0-d zero whose backward is the stage's."""
    single = not isinstance(x, tuple)
    carry = (x,) if single else tuple(x)
    batch = carry[0].shape[0]
    n_local = next(iter(stacked_layers.values())).shape[0] if stacked_layers else 0
    distributed = mesh is not None and mesh.size("pp") > 1
    _check(n_local * (n_stages if distributed else 1), n_stages, batch, microbatches)
    if not stacked_layers:
        return x
    if not distributed:
        outs = []
        for part in zip(*(t.chunk(microbatches) for t in carry)):
            for li in range(n_local):
                part = _as_tuple(layer_fn(part[0] if single else part, _layer(stacked_layers, li)))
            outs.append(part)
        out = tuple(torch.cat(leaves) for leaves in zip(*outs))
        return out[0] if single else out
    if mesh.size("pp") != n_stages:
        raise ValueError(f"n_stages {n_stages} != the mesh's pp={mesh.size('pp')}")
    names = list(stacked_layers)
    run = _Schedule(layer_fn, names, n_local, microbatches, mesh, single)
    out = _Pipeline.apply(run, len(carry), *carry, *(stacked_layers[n] for n in names))
    return out[0] if single else tuple(out)


def _as_tuple(c: Any) -> Tuple[torch.Tensor, ...]:
    return c if isinstance(c, tuple) else (c,)


class _Schedule:
    """One rank's GPipe schedule: the forward over the microbatches,
    keeping each one's graph, and the backward in reverse."""

    def __init__(self, layer_fn, names, n_local, microbatches, mesh, single) -> None:
        from tpu_nexus_torch.parallel import collectives

        self.layer_fn, self.names, self.n_local = layer_fn, names, n_local
        self.m, self.mesh, self.single = microbatches, mesh, single
        self.comm = collectives.current()
        self.first = mesh.stage == 0
        self.last = mesh.stage == mesh.n_stages - 1
        #: graphs are kept for the backward only while gradients are taken
        self.grad = torch.is_grad_enabled()

    def stage(self, carry, layers):
        for li in range(self.n_local):
            part = carry[0] if self.single else carry
            carry = _as_tuple(self.layer_fn(part, _layer(layers, li)))
        return carry

    def forward(self, xs, layers):
        """The forward ticks.  Returns (per-microbatch inputs that need a
        gradient, per-microbatch outputs: the carry on the last stage, the
        hand-off's 0-d zero elsewhere)."""
        from tpu_nexus_torch.parallel import collectives

        ins, outs = [], []
        # the receive's input on the graph: the backward asks for its
        # gradient, so the receive's backward (the send back) runs
        self.anchor = anchor = torch.zeros((), device=xs[0].device, requires_grad=True)
        metas = [((t.shape[0] // self.m,) + tuple(t.shape[1:]), t.dtype) for t in xs]
        for part in zip(*(t.chunk(self.m) for t in xs)):
            if self.first:
                carry = tuple(p.detach().requires_grad_(p.requires_grad) for p in part)
                ins.append(carry)
            else:
                carry = collectives.RecvPrev.apply(anchor, self.mesh.prev_stage_rank, self.comm, metas)
            carry = self.stage(carry, layers)
            if self.last:
                outs.append(carry)
            else:
                outs.append((collectives.SendNext.apply(self.mesh.next_stage_rank, self.comm, *carry),))
        return ins, outs


class _Pipeline(torch.autograd.Function):
    """The schedule of :class:`_Schedule` as one autograd node: inputs
    ``(run, n_carry, *carry, *layer leaves)``."""

    @staticmethod
    def forward(ctx, run, n_carry, *inputs):
        xs, ws = inputs[:n_carry], inputs[n_carry:]
        with torch.enable_grad() if run.grad else contextlib.nullcontext():
            layers = {n: w.detach().requires_grad_(w.requires_grad) for n, w in zip(run.names, ws)}
            ins, outs = run.forward(xs, layers)
        ctx.run, ctx.ins, ctx.outs, ctx.layers = run, ins, outs, layers
        ctx.n_carry = n_carry
        if run.last:
            return tuple(torch.cat([o[i].detach() for o in outs]) for i in range(n_carry))
        return tuple(xs[0].new_zeros((), dtype=t.dtype) for t in xs)

    @staticmethod
    def backward(ctx, *grads):
        run, leaves = ctx.run, list(ctx.layers.values())
        need = [w for w in leaves if w.requires_grad]
        if run.last:
            seeds = [g.chunk(run.m) if g is not None else [None] * run.m for g in grads]
        for m in reversed(range(run.m)):
            inputs = need + ([t for t in ctx.ins[m] if t.requires_grad] if run.first else [run.anchor])
            if run.last:
                pairs = [(o, s[m]) for o, s in zip(ctx.outs[m], seeds) if o.requires_grad and s[m] is not None]
                outputs, seed = [p[0] for p in pairs], [p[1] for p in pairs]
            else:
                outputs, seed = [ctx.outs[m][0]], [torch.ones_like(ctx.outs[m][0])]
            if outputs and inputs:
                torch.autograd.backward(outputs, seed, inputs=inputs)
            ctx.outs[m] = None  # the microbatch's graph is done with
        x_grads = [None] * ctx.n_carry
        if run.first:
            x_grads = [torch.cat([p[i].grad if p[i].grad is not None else torch.zeros_like(p[i])
                                  for p in ctx.ins]) if ctx.ins[0][i].requires_grad else None
                       for i in range(ctx.n_carry)]
        w_grads = [w.grad if w.requires_grad else None for w in leaves]
        return (None, None, *x_grads, *w_grads)


def finish_on_last_stage(mesh: Any, carry: Any, keys: Sequence[str],
                         fn: Callable[[Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]):
    """The loss of a pipeline's output: ``fn(carry) -> (loss, metrics)`` runs
    on the last stage, and every stage returns the same loss and metrics
    (``keys``), broadcast from it.  Elsewhere the loss is the broadcast value
    plus the pipeline's 0-d zeros, so the stage's backward runs."""
    from tpu_nexus_torch.parallel import collectives

    leaves = _as_tuple(carry)
    src = mesh.members("pp")[-1]
    last = mesh.rank == src
    if last:
        loss, metrics = fn(carry)
        values = torch.stack([loss.detach().float()] + [metrics[k].detach().float() for k in keys])
    else:
        values = torch.zeros(1 + len(keys), device=leaves[0].device)
    # a sum with zeros: the last stage's values, exactly, on every stage
    values = collectives._all_reduce(values, mesh.group("pp"), collectives.current(), name="pp_broadcast")
    if not last:
        loss = values[0] + sum(t.float().sum() for t in leaves) * 0.0
    return loss, {k: values[1 + i] for i, k in enumerate(keys)}


def stage_layers(layers: Dict[str, torch.Tensor], n_layers: int, mesh: Any) -> Dict[str, torch.Tensor]:
    """This stage's layer leaves: as they are where the rule table cuts
    ``layers`` over ``pp`` (each leaf holds ``L / pp``), else sliced."""
    pp = mesh.size("pp") if mesh is not None else 1
    if n_layers % pp:
        raise ValueError(f"n_layers {n_layers} not divisible by pp={pp}")
    per = n_layers // pp
    return {name: (w if w.shape[0] == per else w[mesh.stage * per:(mesh.stage + 1) * per])
            for name, w in layers.items()}

